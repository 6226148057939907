#!/usr/bin/env python3
"""Run raft_tpu_torch on one NVIDIA GPU and check it, kernel by kernel and
end to end.

    python3 chip_smoke.py              # every phase (needs one CUDA card)
    python3 chip_smoke.py --phases 01  # build and kernel checks only
    python3 chip_smoke.py --phases 012456789abc  # all but phase 3's timings
    python3 chip_smoke.py --phases 02a  # the front door, the mesh, the controller
    python3 chip_smoke.py --phases 02b  # the communicator and the distributed drivers
    python3 chip_smoke.py --phases 0c  # the sparse and graph stack (needs no phase 2)
    python3 chip_smoke.py --phases 0d  # the remaining primitives (needs no phase 2)
    python3 chip_smoke.py --out DIR    # where the profile tables go
                                       # (default build/profiles)

Phases, each printing JSON lines:
  0. the card (name, power limit, count), the kernels' build with nvcc (the
     ptxas report: registers, spills, static shared memory), the
     tensor-core ``fused_knn`` kernel's tile plans at d=128, k in {1, 10,
     64} (queries a block, resident query tile, ring stages, dynamic shared
     memory, resident blocks, splits at the main shape; modes bf16, f32x3,
     s8 and mode f32's batch route, tf32x3) and the row-split route's plans
     at every m of the M_SMALL sweep (query tile, tile rows, stages, splits
     and waves over 1M rows);
  1. each kernel against its plain PyTorch version on the card, at the main
     paths' widths: ``fused_knn`` over 1,000,000 x 128 rows (2,048 queries;
     mode f32 on its batch route (3xTF32 on the tensor cores) and f32x3 /
     bf16 / s8, l2 with and without sqrt, ip, k in {1, 10, 64}, a keep-mask
     that keeps fewer than k rows, a ragged n, d = 126); mode f32's two
     routes, each named, at m of 1, 7, 64, 65 and 300 and d of 64, 128 and
     256 over 100,003 rows (l2 / ip / sqrt, k 1 / 10 / 64, a row bias, a
     keep mask that keeps 5 rows, ties; knn_equiv at 1e-5, one launch on the
     named route each); the 3xTF32 route's gate at 10,000 x 1M at d of 64,
     128 and 256 (knn_equiv at 1e-5) and 1,024 (within
     ``tc_rounding_bound``); ``tf32_split`` bit for bit; the tensor-core modes also
     over d in {64, 70, 100, 128, 256, 1024} at 100,003 rows (m of 1 to
     2,047, ties from a repeated half of the dataset, underfill; s8 bit for
     bit, bf16 / f32x3 at 1e-5 and at d = 1024 within ``tc_rounding_bound``)
     and uint8 inner product and L2 through ``knn``, bit for bit against the
     CPU; ``bf16_split`` (f32x3's operand planes) bit for bit on values at
     the bf16 rounding point, subnormals, ±0, ±inf, NaN and 1M x 128 rows;
     ``topk`` bit for bit, ids and value bits, on a 10,000 x 100,003
     float32 matrix (k in {10, 64, 128, 256}, min and max, int64 payload ids
     at k=10) and on the index paths' narrow rows (10,000 and 128 rows x
     1,024, 10,176 and 16,384 columns, float32 / bfloat16 / float16, k in
     {10, 40, 193}), each with ties, infinities, clamped extremes, -0 and
     NaN planted, one row all NaN and one sorted; ``pq_scan`` bit for bit
     (pq4 at S=64 and S=128 with float32 and bfloat16 LUTs, split pq8 at
     S=32, S of 24 and 96, caps that are not a multiple of the block,
     repeated lists, 1,024 pairs over indexes of real size);
     ``pq_scan_topk`` bit for bit, values' bits and ids (the GPU tests'
     grid of 180 cases: pq4 and split pq8, float32 and bfloat16 LUTs, L2 and
     inner product, k in {1, 7, 40, 256}, 1, 3 and 8 probes, S of 24, 64
     and 128, with ties, holes, short lists and an underfilled query; the
     main tile, 128 queries x 8 probes of a 1,024-list index at cap 1,272,
     S=64, k=40; the CAGRA build's, S=128, k=193, 8 and 32 probes);
     ``cagra_hop`` bit for bit (2,048 queries over the 1M x 128 CAGRA set, itopk 32 and
     64, width 1 and 2, both merges, float32 and int8 rows, d of 100 and
     126, the prime call, -1 ids, invalid lanes and repeated ids; on each
     hop call every ``profile`` carve-out, "noscore", "nodedup", "nomerge"
     and "nogate", also bit for bit against its plain version, one launch
     under its own mode, and "nogate" equal to "full");
  2. the main paths, each with the launch counts set to 0 just before it and
     read just after: ``BruteForce("sqeuclidean").build(x).search(q, k=10)``
     at 1M x 128 float32 (uniform data from seed 0, 10,000 queries from
     seed 1), checked against the plain version, one launch a batch on mode
     f32's batch route; the same index searched at m = 1 and 64, one
     row-split launch each; ``knn`` on the same data
     with ``compute="bfloat16"``, ``compute="float32x3"`` and as int8 codes
     under the default compute, each batch launching the tensor-core kernel
     once (bf16 / f32x3 checked by recall@10 against the float32 answer,
     int8 bit for bit on 1,024 queries); ``select_k`` on a
     10,000 x 100,003 matrix; IVF-PQ at SIFT-1M's shape in the JAX
     package's regression configuration (bench.py:660-668): 1M x 128 float32
     from 1,000 Gaussian blobs, ``build(n_lists=1024, pq_bits=4, pq_dim=64)``,
     ``search(n_probes=8, lut_dtype="bfloat16")`` at k=40 for 10,000 queries,
     ``refine`` to k=10; checked against the plain scan (``scan_impl=
     "onehot"``) and for recall@10 against exact ground truth on 1,000
     queries, and profiled for one batch; the search must launch
     ``pq_scan_topk`` once per 128-query tile and ``topk`` never; the
     unfused kernel route (``pq_scan``, bias, mask, ``topk``) must give its
     ids and values exactly and is timed and profiled beside it, the plain
     select route (``select_impl="xla"``, which launches ``pq_scan``) too,
     and ``_pq_search`` is timed at query tiles of 128 and 1,024; on the same
     index, filtered searches (bitsets keeping 50% and 2% of the ids,
     seeded) launch ``pq_scan_topk`` once a tile and ``topk`` never, equal
     ``pq_scan_topk_plain`` bit for bit on two tiles, return kept ids only
     and answer as the plain-select route, an all-ones bitset gives the
     unfiltered answer exactly, and each is profiled beside an unfiltered
     search; ``scan_order="grouped"`` matches the tiled order except on
     rows that tie within 1e-5; the blob set as int8 and as uint8 rows is
     built, searched and refined (recall@10 against the stored bytes'
     exact neighbours, floor 0.85; the select routes equal); per-cluster,
     scale-normed and OPQ + anisotropic + 4-bit fast-scan builds (the last
     searched through the funnel at ``funnel_widen=4``) print build
     seconds, QPS and recall@10 with the select routes equal; and CAGRA
     in the JAX package's
     ``cagra_1m_itopk32`` row (bench.py:3242-3260, data bench.py:527-552):
     1M x 128 float32 around 2,000 centers uniform in [0, 10) with N(0, 0.5^2)
     noise (seeds 20-22), ``cagra.build(IndexParams())`` and
     ``search(SearchParams(itopk_size=32))`` at k=10 for 10,000 queries;
     checked for graph validity, recall@10 against exact ground truth and
     against the ``hop_impl="xla"`` route on 1,000 queries, and profiled for
     one batch. On both indexes the plain top-k route (``select_impl=
     "xla"``; for CAGRA the wide-select threshold pinned above every row)
     must give the routed search's ids and values exactly, and is timed and
     profiled beside it in the same run; CAGRA's byte build on that set
     scaled into int8 (``search`` running ``cagra_hop`` over int8 rows,
     recall@10 against the stored bytes' exact neighbours, floor 0.95, the
     kernel route against ``hop_impl="xla"`` by overlap and recall);
     IVF-Flat in the JAX package's ``ivf_flat_1m_p8`` row (bench.py:3221-3239,
     the CAGRA set): ``build(IndexParams(n_lists=1024, seed=0))`` and
     ``search(SearchParams(n_probes=8))`` at k=10 for 10,000 queries,
     profiled for one batch; recall@10 against exact ground truth on 1,000
     queries (floor 0.99); the plain top-k route (threshold pinned above
     every row) gives equal ids and values; the search launches ``topk``
     as often as its tile plan says (tiles x chunks, plus the coarse
     select) and ``fused_knn`` never; a filter that drops half the ids on
     both routes; bfloat16 lists (recall floor 0.98 against the exact
     neighbours of the rows they store) and int8 lists (100,000
     rows, both routes equal); then the rest of the slice against float64
     or the port's plain route: every pairwise metric at 2,048 x 16,384 x
     128, ``knn(metric="l1")`` over the 1M set on both select routes,
     ``masked_l2_nn`` and ``gram_matrix`` (four kernel types) at 10,000 x
     100,000 x 128, ``eps_neighbors_l2sq``, and ``kmeans.fit`` at 100,000 x
     128 from ``init="array"`` against the same call on the CPU; the random
     ball cover over 1,000,000 x 3 uniform rows (sqeuclidean) and 1,000,000
     (lat, lon) points (haversine), 10,000 queries, k=10, against exact
     ``knn`` in the same metric; the 16 ``matrix.ops`` functions on the card
     against the CPU;
  3. ``fused_knn``'s bf16, f32x3 and s8 modes timed at the f32 row's shape
     beside their tensor-core bounds, their plain version and one library
     call each (and at k = 1 and 64), with ``knn``'s QPS in each mode and
     the cost of f32x3's bf16 planes (``bf16_split``); mode f32's batch
     route at 10,000 x 1M x 128 beside its 3xTF32 bound, the plain version
     and ``torch.addmm`` + ``torch.topk``, ``tf32_split``'s time, and the
     M_SMALL sweep: both routes and the library at m in {1, 8, 16, 32, 64,
     128, 256, 384, 512} over the 1M set, with the crossover beside
     ``M_SMALL``; the split merge's two kernels, each at the other's
     shapes; kernel
     times (CUDA events) beside their bound, their plain version's
     time and one library call's time (for ``cagra_hop``, which no single
     PyTorch call computes, the ``"xla"`` hop body's time instead, and its
     in-kernel profile: each ``profile`` carve-out timed on both merges,
     scoring = full - noscore, dedup = full - nodedup, merge = full -
     nomerge, the gate's worth = full - nogate; for
     ``pq_scan_topk`` also the unfused kernel route's time and its time
     under the 50% filter, whose bound gains the bitset's bytes); and a
     sweep of ``topk`` against the plain route and ``torch.topk`` over
     10,000 and 128 rows, 1,024 to 100,003 columns and k in {10, 32, 40,
     193}, with the crossover it gives beside ``WIDE_SELECT_COLS_DEFAULT``;
  4. ``raft_tpu_torch.serve`` on phase 2's indexes (run after phase 2, before
     phase 3's timings): the serve path's kernels at its small shapes
     against their plain versions (``fused_knn`` at m = 1 and 64 over the
     1M set, ``pq_scan_topk`` on one query and on 64, the entry-pool
     ``topk`` at m = 1 and 64, ``cagra_hop`` at m = 1); the JAX package's
     serving row (bench.py:733-869): the IVF-PQ + refine hook (4k
     candidates refined to k=10) behind ``SearchService(max_batch=64,
     max_wait_us=2000)``, 8 threads x 400 one-row requests, a second
     IVF-PQ build published at mid-load, with ``pipeline_depth`` 2 and 0,
     against the same hook called one row at a time; then brute force,
     IVF-Flat and CAGRA (itopk 32) published on the running service, 400
     requests each, and 20 full 64-row buckets back to back. Every request
     must be answered, no kernel built in a loaded window, each served
     row equal (``knn_equiv`` at 1e-5) to the serving index's direct
     search at the shape that served it (CAGRA: recall@10 >= 0.95), IVF-PQ
     + refine recall@10 >= 0.85, and the memory ledger's bytes for the
     second build within 10% of its allocation delta. Prints QPS, p50 /
     p99, occupancy, host syncs (``torch.cuda.set_sync_debug_mode``),
     device ms and launches a flush for each index kind (a brute-force
     flush: one row-split launch); ``fused_knn`` at m = 1 and 64 (the
     row-split route, the whole call) is timed beside ``torch.addmm`` +
     ``torch.topk`` with |y|² precomputed;
  5. ``raft_tpu_torch.stream`` behind ``SearchService.upsert`` / ``delete``
     (after phase 4, on phase 2's indexes and data): the IVF-PQ churn row of
     the JAX package (bench.py:1122-1185, ``serve_churn_ivf_pq_100k``'s
     protocol) on the 1M IVF-PQ index: ``MutableIndex(delta_capacity=4096,
     retain_vectors=False)`` published on ``SearchService(max_batch=64,
     max_wait_us=2000)``, ``Compactor(CompactionPolicy(delta_fill=0.75))``,
     8 closed-loop reader threads, one writer of 64 steps x (96 upserts of
     fresh blob rows + 32 deletes of random live ids) folding (extend) at
     the watermark; brute force over the 1M uniform set with the delta
     taken across the 2,048 -> 4,096 bucket and a rebuild, ids against a
     fresh ``knn`` over the live rows; the CAGRA churn row (bench.py:
     1187-1215, 100k x 128 clustered, ``IndexParams(seed=0)``, itopk 32, 48
     steps, rebuild folds); ``pq_scan_topk`` under a ~3% tombstone bitset
     on phase 2's index (two 128-query tiles) and on the churn index as its
     folds extended it, with its own tombstone words, at T = 1, 4 and 64,
     and ``fused_knn`` over the 4,096-row delta with its keep mask (m = 1,
     8, 64, one row-split launch each), against their plain versions; a
     mutable flush's delta scan is one row-split launch. Every window must fail no request
     and build no kernel, each write step's rows must come back at rank 0,
     no read submitted after a delete returned may hold the deleted id, the
     IVF-PQ window must fold at least twice, and recall@10 through the
     service right after the first fold must be within 0.01 of a fresh
     build over the same live rows (IVF-PQ and CAGRA). Prints write rows/s,
     read QPS, p50 / p99, each fold's wall time, bytes uploaded per write
     step, and a mutable flush at 8 and 64 rows (host syncs, launches,
     device ms);
  6. the out-of-core build (after phase 5, on phase 2's corpora), each
     corpus written from a seed into a temporary directory and read back
     through ``core.chunked.ChunkedReader``: phase 2's IVF-PQ set and
     params from a ``.npy`` file in 16 chunks of 65,536 rows (the streamed
     index equals the in-core one and phase 2's bit for bit; its 10k-query
     search equals phase 2's in ids and distances, 79 ``pq_scan_topk``
     launches a batch); IVF-Flat over 10M x 128 uniform uint8 rows
     (big-ann-benchmarks' BIGANN-10M shape, synthetic) from a raw
     ``np.memmap`` in chunks of 262,144, ``IndexParams(n_lists=1024,
     kmeans_n_iters=4, kmeans_trainset_fraction=0.02, seed=0)`` (equal to
     the in-core build bit for bit, its ledger peak at most 1.2 x
     ``obs.mem.plan(streamed=True)``'s build peak, printed as
     ``ledger_over_plan``: its lists split past the bound and the build
     holds the split within 1.2 x plan()'s price; its allocator peak below
     the in-core build's; 1,000 queries at n_probes 8 equal through
     ``topk``).
     CAGRA over phase 5's
     100k churn corpus (dataset and graph equal, the search through
     ``cagra_hop`` equal); brute force over phase
     2's 1M set (searches at m = 1 and 64 equal, one row-split launch
     each); a ``MutableIndex`` over a reader whose
     ``compact("rebuild", ooc_chunk_rows=65536)`` equals the in-core fold;
     and an armed device and host budget refusing the 1M streamed IVF-PQ
     build at ``build_stream`` / ``build_stream/host`` before any chunk
     stages. One ``ooc`` line a build: streamed and in-core seconds, chunks,
     staged bytes and GB/s over the uploads' device time, ledger and
     allocator peaks, ``plan()``'s figures, launches per kernel;
  7. beyond-HBM tiered storage (``stream/tiered.py``, after phase 6, on
     phase 2's IVF-PQ index) and the quality observers, at two shapes. (a)
     1M x 128 float32: phase 2's index (``ivf_pq_1m_lid_pq4x64_r4``,
     refine_ratio 4, k=10) wrapped as ``MutableIndex(storage="hbm")`` and
     ``storage="tiered"`` (host RAM, no budget, so cold): ``search_refined``
     bit for bit on the 10k-query batch and a 64-row flush; 20 batches with
     the slot ring's accounted device bytes constant, m x 40 x 512 B
     uploaded a batch and one host sync (the slot read-back) a batch; a
     refined flush's host syncs (``torch.cuda.set_sync_debug_mode``, each
     printed with its site): the tiered flush reads its slot ids back once
     and syncs no more than one time beyond the all-HBM one; ``exact_search``
     of 1,000 queries through 123 oracle chunks of 8,192 rows (one
     ``fused_knn`` launch on mode f32's batch route a chunk), ids and
     distances bit for bit against the all-HBM scan; both twins served
     through ``SearchService`` (phase 4's 8 threads x 400 one-row requests,
     served rows equal to the direct search at their bucket's shape) with a
     ``RecallCanary`` (every query sampled, drained through the chunked
     oracle at buckets up to 256) whose Wilson interval must hold the
     recall of the served ids against ``exact_search`` and an
     ``SLOTracker`` that must not fail, and a forced failing SLO writing
     one flight-recorder bundle; a spill under an armed
     ``memory_budget_bytes`` (an upsert spills the promoted mirror instead
     of being refused) and a promote back, answers bit for bit, no upload
     while the mirror is resident. (b) BIGANN-10M's shape: 10M x 128 uint8
     rows around 10,000 centers (clustered, from a seed) in a temporary
     ``.npy`` file, IVF-PQ streamed through ``ChunkedReader``
     (``n_lists=1024, pq_dim=64, pq_bits=4, kmeans_trainset_fraction=
     0.02``), wrapped with ``MutableIndex(dataset=reader, storage=
     "tiered")``, which adopts the memmap (residency "disk", 0 host bytes,
     1.28 GB on the disk tier) while an armed device budget (the ledger's
     bytes plus the slots) keeps the mirror off the card: ``search_refined``
     of 10k queries bit for bit against an all-HBM twin, recall@10 (floor
     0.5) against the chunked oracle (1,221 chunks, one s8 launch each,
     equal to the all-HBM scan), and ``plan(storage="tiered",
     tier=TierPolicy(disk_path=...))`` against the ledger within 20%. Each
     prints QPS of both twins, the hit ratio, the host gather and fetch
     walls, and one profiled batch (``tier_*_profile.txt``);
  8. the sharded and replicated mesh (``stream/sharded.py``,
     ``stream/replicated.py``, after phase 7, on phase 2's corpora), every
     shard on ``cuda:0`` (``devices=None``). (a) The scatter-gather ladder:
     ``ShardedMutableIndex`` of IVF-Flat over the ``ivf_flat_1m_p8`` set at
     S = 1, 2 and 4 with the proportional sizing of bench.py's sharded row
     (``n_lists`` 1024/S, ``n_probes`` 32/S; bench.py:1465, :1526-1535),
     ``retain_vectors=True``,
     ``delta_capacity=4096``: S = 1 equal to a plain ``MutableIndex`` over
     the same sealed index bit for bit (the 10k batch and a 64-row flush,
     before and after one write script); at each S recall@10 of the 10k
     batch against the mesh's ``exact_search`` >= 0.95, batch QPS, served
     QPS and p50 / p99 under phase 4's load (8 threads x 400 one-row
     requests, no failure, no kernel built), and one 64-row flush's device
     busy ms and idle share, host syncs with their sites, and launches by
     kernel. (b) Churn at S = 4: phase 5's writer (64 steps of 96 upserts +
     32 deletes) against 8 readers, a ``Compactor`` folding one shard a
     cycle at a delta fill of 0.25 (1,024 of 4,096 rows a shard; the four
     shards share phase 5's writes): at least 2 folds on distinct shards,
     no failure, no kernel built, read-your-writes, no deleted id read
     back, a ``RecallCanary`` over the mesh whose Wilson interval holds the
     recall measured against ``exact_search``, and a tripped
     ``reshard_rows_per_shard`` advising a split to 8. (c) A 2-shard x
     2-replica IVF-Flat mesh served through ``SearchService`` with 2 reader
     threads and a writer: ``replica/search`` injected on twin r0 of shard
     0 for a window (no failed query, strikes on that twin, healed by the
     re-probe once the fault clears, no strike outside the window); then
     ``reshard(4, publisher=svc)`` under the same load with a twin of
     shard 1 killed mid-migration (no failed query, no kernel built, recall
     before and after the flip >= 0.95 against the mesh oracle, every
     acknowledged write there after it). (d) A brute-force 4-shard mesh of
     the same set with a ``wal_dir``: a 10k batch and a 64-row flush equal
     ``BruteForce.search`` (``knn_equiv`` at 1e-5); after a writer burst a
     ``SimulatedCrash`` at ``reshard/flip`` during ``reshard(8)``, and
     ``ShardedMutableIndex.load`` recovers 4 shards id for id (and distance
     for distance) against an uncrashed twin; prints the recovery seconds.
     (e) Tiered shards: phase 2's IVF-PQ parameters
     (``ivf_pq_1m_lid_pq4x64_r4``, refine_ratio 4) as a 4-shard mesh with
     ``storage="tiered"`` (host RAM, cold) beside an all-HBM 4-shard twin
     over the same sealed indexes: ``search_refined`` of the 10k batch and a
     64-row flush bit for bit, H2D exactly m x 4 x 40 x 512 B a batch;
     prints both twins' QPS;
  9. the autotuner and the deploy-time surface (``tune/``, ``publish(
     tuned=)``, ``warmup``, ``config``, ``core.interruptible``; after phase
     8, on phase 2's indexes). (a) ``tune.sweep`` of each kind's default
     grid at 10,000 queries, k=10, ``repeats=3``: IVF-Flat (4 points) and
     CAGRA (4) over the clustered 1M set, IVF-PQ + refine (7, the raw rows
     as ``dataset=``); every trial's recall, QPS and wall, the frontier, the
     chosen point and ``chosen_qps_over_default``; each chosen point meets
     its target, the grid head's recall equals a direct search at its
     params, and the sweep's ground truth (the port's ``knn``) equals phase
     2's. (b) Each decision attached, the index saved and loaded, then
     published on a ``SearchService`` with ``tuned=True`` and with
     ``tuned=log`` (an IVF-PQ refine pin refuses ``tuned=True`` without its
     rows and publishes ``tune.make_searcher(index, log, dataset=rows)``
     and the loaded index's own hook instead): 256 one-row requests each,
     served rows equal to ``tune.make_searcher``'s answers at their own
     shapes, no kernel built in the window, the report's ``"tuned"`` the
     pin; ``apply_global`` of (c)'s decisions applies inside a scope and
     resets to the default, an unmeasured pin moves nothing. (c)
     ``tune.sweep_select_k`` at 10,000 and 128 rows, 256 to 131,072
     columns, k of 10 and 128: the plain route against the ``topk`` kernel,
     the crossover beside ``WIDE_SELECT_COLS_DEFAULT`` (not changed here).
     (d) ``warmup`` of each kind at 1M x 128 (IVF-Flat, IVF-PQ and CAGRA on
     a 100,000-row sample of phase 2's clustered sets), then ``warmup(
     "brute_force", n=100_000, d=128)`` in two fresh processes sharing an
     empty cache directory: the first builds (``programs >= 1``), the second
     loads (``programs == 0``, ``cache_hits >= 1``). (e) A worker's IVF-PQ
     search loop cancelled from the main thread at its next
     ``synchronize`` (within one search; the token resets); ``knn`` and
     each ``search``, a served flush and a mutable-index search under
     ``config.set_output_as("numpy")`` equal to the ``"torch"`` setting
     (the mutable index's answers stay on the card);
  a. the network front door, the process mesh, the controller and the
     exporter (``net/``, ``obs/http.py``, ``control/``; after phase 9, on
     phase 2's indexes). (a) IVF-PQ + refine (``serve``), brute force,
     IVF-Flat and CAGRA on one ``SearchService(max_batch=64,
     max_wait_us=2000)`` behind a ``NetServer``: the JAX package's
     ``net_serve`` ladder (bench.py:3345-3347), 1 / 4 / 8 threads x 150
     one-row requests on ``serve`` in process and over loopback (QPS, p50 /
     p99, the p99 of the wire / queue / flush spans from ``X-Raft-Spans``
     and of the histograms, the wire tax at 8 threads), recall@10 of 1,000
     queries both ways (equal ids required), 100 one-at-a-time wire
     requests to each other name; every served row equal to a direct
     search at its shape, 0 builds in the window. (b) ``ProcessMesh`` of 2
     shards x 2 replicas of brute force over phase 2's exact set, each
     worker on ``cuda:0`` (the router builds the workers' kernels before it
     spawns them): boot walls, ``stats()`` (0 cache misses at boot and
     after), ``net_kill_worker``'s protocol (bench.py:3475-3477: 6 threads
     for 8 s through a ``NetServer``, one worker SIGKILLed at 3 s): 0
     failed queries, ``net_worker_fenced`` and ``net_worker_failover`` in
     the journal, ``/healthz`` 200 ``degraded``, 256 queries' ids equal to
     an exact in-process search; then the twin killed:
     ``ReplicaUnavailableError`` rebuilt across the wire with its fields,
     ``/healthz`` 503 ``failing``; the workers' launches summed. (c) The
     controller: phase 2's clustered IVF-Flat pinned at ``n_probes=1`` in an
     ``IndexRegistry``, a ``retune_advised`` event, the bounded sweep and
     the tuned republish under a reader (recall before and after, 0 failed,
     0 builds, the seq chain); an IVF-Flat ``ShardedMutableIndex`` at S = 2
     over the same set (512 lists, 16 probes) taking an upsert ramp of 8 x
     512 rows past ``reshard_rows_per_shard``, the compactor's advice
     resharding it to 4 under the controller's headroom and burn checks
     with a reader on the mesh (0 failed, recall against the mesh's oracle
     held, the reshard's wall); a hot ``SLOTracker`` degrading the tuned
     name to ``n_probes=1`` and its cooling restoring it (an injected
     clock), the rows served at each point equal to a direct search. (d) A
     ``MetricsExporter`` over (a)'s request log, an ``SLOTracker`` fed by
     (a)'s service, (b)'s mesh and (c)'s controller: ``/metrics`` parsed as
     Prometheus text, ``/healthz`` (503 with the replica and control
     folds), ``/debug/mem`` with its ``tiers`` section, ``/debug/events``,
     ``/debug/control``, ``/debug/requests`` and the 404 listing.
  b. the communicator and the distributed drivers (``comms/``,
     ``parallel/``, ``core/platform.py``; after phase a, on phase 2's
     indexes, saved once as raft_tpu/13 files the ranks load). Three worlds
     of spawned ranks (``RankPool``), all on ``cuda:0``: one rank on NCCL,
     then two and four on gloo (NCCL refuses two ranks on one card). Each
     rank regenerates phase 2's sets from their seeds and takes its own
     rows; every rank runs ``test_utils.run_all`` (all True), then the
     counted path: ``parallel.knn`` over the 1M x 128 set (10,000 queries,
     k=10, three timed batches, and 64 queries on the row split),
     ``parallel.ivf.search`` on the IVF-Flat index (n_probes 8),
     ``search_pq`` + ``refine`` on the IVF-PQ index, ``parallel.cagra.search``
     (at S = 1 over phase 2's CAGRA index as one shard; at S = 2 and 4 over
     ``parallel.cagra.build`` of the CAGRA set). Checks: the knn ids equal
     ``brute_force.knn``'s on all 10,000 rows (bit for bit at S = 1,
     distances within rtol 1e-5 beyond); recall@10 at phase 2's floors
     (IVF-Flat 0.99 and at least the single-card search's at equal n_probes,
     IVF-PQ + refine 0.85, CAGRA 0.95); at S = 1 whether each search equals
     the single-card one, and ``ShardedMutableIndex(comms=)`` equal to
     ``devices=``; at S = 2 ``parallel.ivf.build`` of the IVF-Flat row (its
     wall beside the single-card build's, recall 0.99); ``parallel.kmeans.fit``
     at 1,024 clusters on 100,000 blob rows within 5% of ``cluster.kmeans.fit``'s
     inertia; ``fused_knn`` (rows and 3xTF32), ``topk``, ``pq_scan_topk`` and
     ``cagra_hop`` against their plain versions at each rank's shard shapes.
     Prints each world's boot wall, knn QPS against ``brute_force.knn``,
     collective bytes and host hops a batch, and every rank's launches
     summed (``launches_parallel``).
  c. the sparse and graph stack (``sparse/``, ``solver/``,
     ``cluster/single_linkage.py``, ``spectral/``, ``gram_matrix`` of CSR
     inputs; after phase b, on data of its own from seeds, so ``--phases
     0c`` runs it alone), each part one ``phase="graph"`` line with its
     wall and checks. (1) ``single_linkage`` on the knn route over 100,000
     x 128 float32 blobs around 1,000 centers (``n_neighbors=15``,
     ``n_clusters=1,000``, sqeuclidean): at least one ``fused_knn_tf32x3``
     launch, ``n - 1`` MST edges after the repair rounds, the card's MSTs
     (over the kNN graph and over the last repaired graph) equal to
     ``mst()`` of the same graphs on the CPU edge for edge and weight bit
     for bit, every MST weight within 1e-4 of its endpoints' float64
     squared distance, ``sizes[-1] == n``; the kNN graph, MST, repair and
     host dendrogram / cut walls apart, then the entry point end to end.
     (2) The pairwise route at 10,000 x 32 (euclidean, 10 blobs): sorted
     deltas within rtol 1e-4 of scipy's ``linkage(x64, "single")``, the
     10-cluster partition equal to ``fcluster``'s. (3) Sparse ``knn``
     (k=10, inner product and sqeuclidean) of 10,000 queries in 100,000
     rows of a TF-IDF-shaped CSR (8,192 columns, 64 Zipf(1.1) draws a row,
     idf-weighted, l2-normalised): ``topk`` launches equal to the tile
     count, ids and distances equal to the plain select route, 500 queries
     against float64 (an id outside the float64 top 10 ties the 10th
     within 1e-6); QPS. (4) The 18 sparse metrics at 1,000 x 2,000 rows of
     that CSR (0/1 rows for the set metrics, l1 rows for the distribution
     metrics) against float64 at the dense checks' bounds. (5)
     ``gram_matrix`` of CSR inputs (four kernels) at 2,000 x 2,000 x
     8,192 against the dense call (rtol 1e-5). (6) ``knn_graph(k=15)`` ->
     ``symmetrize`` -> ``partition(n_clusters=16)`` over 100,000 x 32 blobs
     around 16 centers from a fixed ``v0`` (the Laplacian's spmv, its 1-D
     segment sum and the 2-D ``segment_reduce`` path timed beside the
     spmv's bytes): every Ritz pair's residual within 1e-3 of ‖L‖₁, each
     eigenvalue within the sum of the two runs' residuals (at least 1e-4)
     of the CPU's ``eigsh`` from the same ``v0``, ARI >= 0.95 against the
     blobs; then
     ``modularity_maximization`` on the same graph (ARI >= 0.95). (7)
     ``lap_solve`` of 8 x 1,024 x 1,024 integer costs in [0, 1,000): every
     problem converged, its objective equal to scipy's
     ``linear_sum_assignment``'s; rounds and stop-flag reads. Every
     launch of the parts summed: ``launches_graph``.
  d. the remaining primitives (``linalg/``, ``random/``, ``label/``,
     ``stats/``, ``runtime/``; after phase c, on data of its own from
     seeds, so ``--phases 0d`` runs it alone), each part one
     ``phase="prims"`` line with its wall and checks. (1) ``gemm`` at
     8,192^3 float32 within d * 2^-24 of the magnitudes |A| |B| of a float64
     product, its TFLOP/s beside the 67 TFLOP/s FP32 peak; ``rsvd(k=64)``
     of 100,000 x 1,024 (rank 64 plus noise), singular values within 1e-3
     (relative) of float64; ``eigh``, ``qr``, ``svd`` and ``lstsq`` (full
     rank, and rank 64) at 4,096 x 1,024 by reconstruction and against
     float64 (1e-4; lstsq's rank-64 case 1e-3); ``cholesky_r1_update`` at
     n = 1,024 (L'L'^T within 1e-4 of A + xx^T); ``reduce_rows_by_key`` at
     1M x 128 into 1,024 keys against float64 (1e-5 of the summed
     magnitudes), a repeat bit-equal, timed. (2) 10M draws of each of the
     12 distributions, mean and variance within 6 standard errors of the
     closed forms; ``make_blobs`` at 1M x 128 around 1,000 centers (at most
     4 of the 128M coordinates beyond 6 std, 0.25 expected, none beyond
     7); ``rmat`` at scales 20 x 20 with 16M edges (ids below 2^20, each
     level's quadrant shares within 1e-3 of theta); the weighted
     ``sample_without_replacement`` of 256 from 1M with a tenth of the
     weights 0 (no zero-weight id; a ``topk`` launch). (3)
     ``make_monotonic`` on 10M int32 labels with a filter, equal to numpy;
     ``merge_labels`` on 1M labels with 100,000 equivalences, equal to the
     union graph's components (scipy), with its rounds. (4) The moments,
     ``cov`` and ``histogram`` on 1M x 128 against float64 and numpy's
     counts (exact); the label metrics on 1M labels of 1,000 classes
     against float64 numpy of the same formulas (rtol 1e-4);
     ``silhouette_score`` at 20,000 x 128 (1e-4 of float64);
     ``trustworthiness`` of 10,000 x 128 blobs against their 32-d ``rsvd``
     projection, within 1e-5 of float64 (the same formula on the card),
     with its ``topk`` launches. (5) The native runtime built and loaded;
     ``write_bin`` of 1M x 128 float32 (512 MB) and a ``BinDataset``
     streaming it to the card in 100k-row chunks, each equal to the source
     bytes; ``refine_host`` of 10,000 queries x 40 candidates against the
     device ``refine`` (ids equal but at ties within 1e-5);
     ``merge_parts_host`` of 4 shards against ``knn_merge_parts``. Every
     launch of the parts summed: ``launches_prims``.

The line before the last lists the kernels (``launches_stream``: phase 5's
windows; ``launches_stream_folds``: the part of those that the compactions'
folds made on the writer thread, CAGRA's rebuild graph build among them;
``launches_ooc``: phase 6's builds and searches; ``launches_tier``: phase
7's; ``launches_mesh``: phase 8's; ``launches_tune``: phase 9's;
``launches_net``: phase a's, the mesh workers' summed in;
``launches_parallel``: phase b's, every rank's summed;
``launches_graph``: phase c's; ``launches_prims``: phase d's);
the last line is
``{"ok": true, "device": {...}}``. Any failed check raises and the script
exits non-zero without that line; so does a machine without CUDA (exit 2),
and the script alone, in a directory without ``raft_tpu_torch`` beside it
(exit 2).
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import os
import subprocess
import sys
import time

H100_F32_FLOPS = 67e12   # float32 on CUDA cores, H100 SXM data sheet
H100_BYTES_S = 3.35e12   # HBM3, H100 SXM data sheet

N_MAIN, D_MAIN, M_MAIN, K_MAIN = 1_000_000, 128, 10_000, 10
TOPK_SHAPE = (10_000, 100_003)
PQ_LISTS, PQ_CAP = 1024, 1272   # a 1M-row, 1,024-list index bounded at 1.3x the mean list
IVF_BLOBS, IVF_Q, IVF_K0, IVF_CHECK = 1_000, 10_000, 40, 1_000
IVF_RECALL_FLOOR = 0.85         # recall@10 after refine; the card's first run read 0.9153
CAGRA_CENTERS, CAGRA_Q, CAGRA_CHECK, HOP_M = 2_000, 10_000, 1_000, 2_048
CAGRA_ITOPK = 32
SWEEP_ROWS = (10_000, 128)      # a 10k-query batch; the IVF-PQ query tile
SWEEP_COLS = (1_024, 4_096, 10_176, 16_384, 32_768, 65_536, 100_003)
SWEEP_K = (10, 32, 40, 193)     # select_k; the CAGRA pool; IVF-PQ's k0; the CAGRA build
CAGRA_RECALL_FLOOR = 0.95       # recall@10 at itopk 32; the card's first full run read 0.9725
IVF_FLAT_LISTS, IVF_FLAT_PROBES, IVF_FLAT_CHECK = 1024, 8, 1_000
IVF_FLAT_RECALL_FLOOR = 0.99    # recall@10 of ivf_flat_1m_p8; an algorithm's property
IVF_FLAT_BF16_FLOOR = 0.98      # bfloat16 lists, against the stored rows' exact neighbours
INT8_ROWS, INT8_LISTS = 100_000, 256
PAIR_M, PAIR_N = 2_048, 16_384  # the pairwise-metric checks
SLICE_N = 100_000               # masked_l2_nn, gram_matrix, eps_neighbors, kmeans rows
KMEANS_K, KMEANS_ITERS = 256, 20
H100_BF16_FLOPS = 989e12        # dense bf16 tensor cores, H100 SXM data sheet
H100_INT8_OPS = 1979e12         # dense int8 tensor cores, H100 SXM data sheet
H100_TF32_FLOPS = 495e12        # dense tf32 tensor cores, H100 SXM data sheet
F32_SWEEP_M = (1, 8, 16, 32, 64, 128, 256, 384, 512)   # mode f32's route sweep (M_SMALL)
# (d, m, k, metric, extra) of mode f32's route checks at 100,003 rows: every
# route at each m (each route takes any m), l2 / ip / sqrt, k 1 / 10 / 64,
# a row bias, a keep mask that keeps 5 rows (underfill), ties
F32_ROUTE_CASES = [(d, m, k, metric, extra)
                   for d in (64, 128, 256) for m in (1, 7, 64, 65, 300)
                   for k, metric, extra in [(10, "l2", None), (64, "ip", "bias"),
                                            (1, "l2", "sqrt"), (10, "l2", "underfill"),
                                            (10, "ip", "ties")]]
FILTER_KEEP = (0.5, 0.02)       # shares of the ids the filtered IVF-PQ searches keep
BYTE_SCALE = 12.0               # the IVF-PQ blob set as bytes: round(12 x) (+128 for uint8)
SERVE_THREADS, SERVE_PER_THREAD, SERVE_SEQ = 8, 400, 512   # bench.py:733 _row_serve
SERVE_MAX_BATCH, SERVE_WAIT_US = 64, 2000.0
SERVE_OTHER_THREADS, SERVE_OTHER_PER_THREAD = 4, 100       # brute force, IVF-Flat, CAGRA
SERVE_CHECK = 1_000              # served rows held against a direct search
LEDGER_TOL = 0.10                # ledger bytes against the build's allocation delta


def emit(**kw):
    print(json.dumps(kw), flush=True)


def knn_equiv(dv, di, rd, ri, rtol, atol):
    """Distances agree within tolerance; ids agree except where two rows'
    distances tie within that tolerance. Returns the max abs error."""
    import torch

    fin = torch.isfinite(rd)
    assert torch.equal(fin, torch.isfinite(dv)), "underfill slots differ"
    assert torch.equal(dv[~fin], rd[~fin]), "underfill values differ"
    assert torch.allclose(dv[fin], rd[fin], rtol=rtol, atol=atol), (
        f"distances differ: max abs err {float((dv[fin] - rd[fin]).abs().max())}")
    bad = (di != ri).any(dim=1).nonzero().flatten().tolist()
    for r in bad:
        same_set = set(di[r].tolist()) == set(ri[r].tolist())
        assert same_set or torch.allclose(torch.sort(dv[r]).values,
                                          torch.sort(rd[r]).values,
                                          rtol=rtol, atol=atol), f"row {r} ids differ"
    return float((dv[fin] - rd[fin]).abs().max()) if fin.any() else 0.0


def f32_bound(m, n, d, k):
    """The least time of mode f32's function on the card, whatever route
    runs it: the larger of its bytes (queries and dataset read once, the
    (m, k) results written once) and its three TF32 tensor-core products
    (the float32-accurate 3xTF32 split the batch route runs). Beside it,
    ``ffma_bound_ms``: the one float32 product at the FFMA peak, the floor
    of the row-split route's FFMA design."""
    t_bytes = ((n * d + m * d) * 4 + m * k * 8) / H100_BYTES_S
    t_ops = 3 * 2.0 * m * n * d / H100_TF32_FLOPS
    return dict(bound_ms=max(t_ops, t_bytes) * 1e3,
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                ffma_bound_ms=max(2.0 * m * n * d / H100_F32_FLOPS, t_bytes) * 1e3)


def cuda_ms(fn, reps=3, warm=1):
    """Device milliseconds per call of ``fn`` (CUDA events). The timed calls
    are queued behind a ~0.1 s device-side wait, so they run back to back and
    the host's launch cost (tens of microseconds a call, more than a short
    kernel takes) does not show; ``fn`` must not synchronise."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def phase_build(st):
    import torch

    from raft_tpu_torch.ops import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    st["card"] = smi.splitlines()[0]
    emit(phase="card", nvidia_smi=smi, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)
    t0 = time.perf_counter()
    secs = _build.build_all()
    report = {}
    for name in _build.SOURCES:
        lines = [ln.strip() for ln in _build.report(name).splitlines()
                 if "Used" in ln or "spill" in ln or "Compiling entry" in ln]
        report[name] = lines
    emit(phase="build", seconds=round(time.perf_counter() - t0, 2),
         per_source=secs, ptxas=report)
    from raft_tpu_torch.ops.fused_knn import (_INSERT_TILES, _nsplit, fused_knn_config,
                                              row_splits)

    for mode in ("bf16", "f32x3", "s8", "tf32x3"):
        for k in (1, 10, 64):
            c = fused_knn_config(mode, D_MAIN, k)
            emit(phase="plan", kernel="fused_knn_tc", mode=mode, d=D_MAIN, k=k,
                 nsplit_main=_nsplit(M_MAIN, N_MAIN, c["qt"], c["slots"], c["nb"],
                                     _INSERT_TILES * k), **c)
    for m in F32_SWEEP_M:
        c = fused_knn_config("rows", D_MAIN, K_MAIN, m=m)
        splits, waves = row_splits(m, N_MAIN, c, c["slots"])
        emit(phase="plan", kernel="fused_knn", route="rows", m=m, d=D_MAIN, k=K_MAIN,
             splits=splits, waves=waves, **c)


def phase_kernels(st):
    import torch

    from raft_tpu_torch.ops.fused_knn import fused_knn, fused_knn_plain

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand((N_MAIN + 3, D_MAIN), generator=g, device=dev)
    q = torch.rand((2048, D_MAIN), generator=g, device=dev)
    xs8 = torch.randint(-128, 128, (N_MAIN, D_MAIN), generator=g, device=dev,
                        dtype=torch.int8)
    qs8 = torch.randint(-128, 128, (2048, D_MAIN), generator=g, device=dev,
                        dtype=torch.int8)
    few = torch.zeros(N_MAIN, dtype=torch.bool, device=dev)
    few[torch.randperm(N_MAIN, generator=g, device=dev)[:5]] = True
    cases = [
        dict(mode="f32", metric="l2", k=10),
        dict(mode="f32", metric="l2", k=10, sqrt=True),
        dict(mode="f32", metric="ip", k=10),
        dict(mode="f32", metric="l2", k=1),
        dict(mode="f32", metric="l2", k=64),
        dict(mode="f32x3", metric="l2", k=10),
        dict(mode="bf16", metric="l2", k=10),
        dict(mode="bf16", metric="ip", k=64),
        dict(mode="f32", metric="l2", k=10, keep_mask=few),
        dict(mode="f32", metric="l2", k=10, ragged=True),
        dict(mode="f32", metric="l2", k=10, narrow=True),   # d=126: padded to 128
        dict(mode="s8", metric="l2", k=10),
        dict(mode="s8", metric="ip", k=64),
        dict(mode="s8", metric="l2", k=10, sqrt=True, keep_mask=few),
        # the tensor-core modes at the main width: k 1 and 64, sqrt, ip, a
        # filter that keeps 5 rows, a ragged n, d = 126 (padded to 128)
        dict(mode="bf16", metric="l2", k=1),
        dict(mode="bf16", metric="l2", k=10, sqrt=True, keep_mask=few),
        dict(mode="bf16", metric="l2", k=10, ragged=True),
        dict(mode="bf16", metric="l2", k=10, narrow=True),
        dict(mode="f32x3", metric="ip", k=64),
        dict(mode="f32x3", metric="l2", k=1, sqrt=True),
        dict(mode="f32x3", metric="l2", k=10, keep_mask=few),
        dict(mode="f32x3", metric="l2", k=10, ragged=True),
        dict(mode="f32x3", metric="l2", k=10, narrow=True),
        dict(mode="s8", metric="l2", k=1),
    ]
    from raft_tpu_torch.ops.fused_knn import f32_route

    err = {"fused_knn": 0.0, "fused_knn_tc": 0.0}
    for c in cases:
        c = dict(c)
        kernel = "fused_knn" if c["mode"] == "f32" else "fused_knn_tc"
        route = f32_route(2048) if c["mode"] == "f32" else None
        ragged, narrow = c.pop("ragged", False), c.pop("narrow", False)
        k = c.pop("k")
        if c["mode"] == "s8":
            ds, qq = xs8, qs8
            if ragged:
                ds = ds[:N_MAIN - 5]
        elif narrow:
            ds, qq = x[:N_MAIN, :126], q[:, :126]
        else:
            ds, qq = (x if ragged else x[:N_MAIN]), q
        dv, di = fused_knn(ds, qq, k, **c)
        torch.cuda.synchronize()
        rd, ri = fused_knn_plain(ds, qq, k, **c)
        if c["mode"] == "s8":
            assert torch.equal(dv, rd) and torch.equal(di, ri), f"s8 differs: {c}"
            e = 0.0
        else:
            e = knn_equiv(dv, di, rd, ri, rtol=1e-5, atol=1e-5)
        err[kernel] = max(err[kernel], e)
        if "keep_mask" in c:
            assert bool((di[:, 5:] == -1).all()), "underfill ids are not -1"
        emit(phase="check", kernel=kernel, n=ds.shape[0], d=ds.shape[1],
             m=qq.shape[0], k=k, mode=c["mode"], route=route, metric=c["metric"],
             sqrt=c.get("sqrt", False), keep_mask="keep_mask" in c, max_abs_err=e, ok=True)
    st["f32_err"] = {f32_route(2048): err["fused_knn"]}
    st["tc_err"] = err["fused_knn_tc"]
    del x, q, xs8, qs8
    check_f32_routes(st, g)
    check_tc_edges(st, g)
    check_split(g)
    check_tf32_split(g)
    check_tf32x3_gate(st)

    m, n = TOPK_SHAPE
    v = torch.rand(TOPK_SHAPE, generator=g, device=dev)
    plant_topk_rows(v, g)
    ids = torch.randint(0, 1 << 30, TOPK_SHAPE, generator=g, device=dev)
    for k in (10, 64, 128, 256):
        for smin in (True, False):
            check_topk(v, k, smin, ids if k == 10 else None)
            emit(phase="check", kernel="topk", shape=list(TOPK_SHAPE), k=k,
                 select_min=smin, payload=k == 10, nan_rows=True, max_abs_err=0.0,
                 bit_equal=True, ok=True)
    del v, ids
    # the index paths' narrow rows: the IVF-PQ tile (128 rows), the CAGRA
    # entry pool's 16,384 columns, each float type
    for rows, n, dt in [(r, c, t) for r in (10_000, 128) for c in (1_024, 10_176, 16_384)
                        for t in (torch.float32, torch.bfloat16, torch.float16)]:
        v = torch.rand((rows, n), generator=g, device=dev)
        plant_topk_rows(v, g)
        v = v.to(dt)
        for k in (10, 40, 193):
            for smin in (True, False):
                check_topk(v, k, smin)
        emit(phase="check", kernel="topk", shape=[rows, n], dtype=str(dt).split(".")[1],
             k=[10, 40, 193], select_min=[True, False], nan_rows=True, max_abs_err=0.0,
             bit_equal=True, ok=True)
    err = 0.0
    st["topk_err"] = err
    phase_pq_kernel(st)
    phase_pq_topk_kernel(st)
    phase_hop_kernel(st)


def check_split(g):
    """``bf16_split`` (f32x3's operand planes) against its plain version,
    value bits compared: values at and around the bf16 rounding point,
    subnormals, ±0, ±inf, NaN, a length that is not a multiple of four, and
    the main path's 1M x 128 rows."""
    import numpy as np
    import torch

    from raft_tpu_torch.ops.fused_knn import bf16_split, bf16_split_plain

    rng = np.random.default_rng(11)
    base = rng.integers(0x00800000, 0x7F000000, 4096, dtype=np.uint32) & 0xFFFF0000
    lows = np.array([0, 1, 0x7FFF, 0x8000, 0x8001, 0xFFFF], np.uint32)
    bits = (base[:, None] | lows[None, :]).ravel()
    bits |= rng.integers(0, 2, bits.size, dtype=np.uint32) << 31
    special = np.array([0, 0x80000000, 1, 0x80000001, 0x007FFFFF, 0x00008000, 0x00018000,
                        0x807F8000, 0x7F7FFFFF, 0x7F800000, 0xFF800000, 0x7FC00000],
                       np.uint32)
    edge = torch.from_numpy(np.concatenate([bits, special]).view(np.float32)).cuda()
    dev = torch.device("cuda")
    for name, t in (("edge values", edge), ("odd length", edge[:-3]),
                    ("1M x 128 uniform", torch.rand((N_MAIN, D_MAIN), generator=g, device=dev)),
                    ("normal x 1e3", torch.randn((4097, 100), generator=g, device=dev) * 1e3)):
        hi, lo = bf16_split(t)
        torch.cuda.synchronize()
        ph, pl = bf16_split_plain(t)
        same = (torch.equal(hi.view(torch.int16), ph.view(torch.int16))
                and torch.equal(lo.view(torch.int16), pl.view(torch.int16)))
        assert same, f"bf16_split differs on {name}"
        emit(phase="check", kernel="bf16_split", values=name, n=t.numel(),
             bit_equal=True, ok=True)


def check_tf32_split(g):
    """``tf32_split`` (mode f32's 3xTF32 operand planes) against its plain
    version, value bits compared: values at and around the tf32 rounding
    point (ties to even), subnormals, ±0, ±inf, a length that is not a
    multiple of four, and the main path's 1M x 128 rows."""
    import numpy as np
    import torch

    from raft_tpu_torch.ops.fused_knn import tf32_split, tf32_split_plain

    rng = np.random.default_rng(12)
    base = rng.integers(0x00800000, 0x7F000000, 4096, dtype=np.uint32) & 0xFFFFE000
    lows = np.array([0, 1, 0xFFF, 0x1000, 0x1001, 0x1FFF], np.uint32)
    bits = (base[:, None] | lows[None, :]).ravel()
    bits |= rng.integers(0, 2, bits.size, dtype=np.uint32) << 31
    special = np.array([0, 0x80000000, 1, 0x80000001, 0x007FFFFF, 0x00001000, 0x00003000,
                        0x7F7FDFFF, 0x7F800000, 0xFF800000], np.uint32)
    edge = torch.from_numpy(np.concatenate([bits, special]).view(np.float32)).cuda()
    dev = torch.device("cuda")
    for name, t in (("edge values", edge), ("odd length", edge[:-3]),
                    ("1M x 128 uniform", torch.rand((N_MAIN, D_MAIN), generator=g, device=dev)),
                    ("normal x 1e3", torch.randn((4097, 100), generator=g, device=dev) * 1e3)):
        hi, lo = tf32_split(t)
        torch.cuda.synchronize()
        ph, pl = tf32_split_plain(t)
        same = (torch.equal(hi.view(torch.int32), ph.view(torch.int32))
                and torch.equal(lo.view(torch.int32), pl.view(torch.int32)))
        assert same, f"tf32_split differs on {name}"
        emit(phase="check", kernel="tf32_split", values=name, n=t.numel(),
             bit_equal=True, ok=True)


def f32_route_counts():
    from raft_tpu_torch.ops.fused_knn import fused_knn

    return dict(fused_knn.launches_by_route)


def check_f32_routes(st, g):
    """Mode f32's routes, each named (``_fused_knn_f32``) at every m of
    F32_ROUTE_CASES over 100,003 rows, against the plain version by
    knn_equiv at rtol = atol = 1e-5; each call must count one launch on its
    route alone. The
    row-split route's |y|² is summed in the kernel, its bias and mask ride
    as a penalty; ties come from a repeated half of the dataset."""
    import torch

    from raft_tpu_torch.ops import fused_knn as fk

    dev = torch.device("cuda")
    err = {r: 0.0 for r in fk._F32_ROUTES}
    failed = []
    n = 100_003
    for d in (64, 128, 256):
        x = torch.rand((n, d), generator=g, device=dev)
        xt = x.clone()
        xt[n // 2:2 * (n // 2)] = x[:n // 2]
        q = torch.rand((300, d), generator=g, device=dev)
        bias = torch.rand(n, generator=g, device=dev) * 0.5
        keep = torch.zeros(n, dtype=torch.bool, device=dev)
        keep[torch.randperm(n, generator=g, device=dev)[:5]] = True
        for dd, m, k, metric, extra in F32_ROUTE_CASES:
            if dd != d:
                continue
            kw = dict(metric=metric)
            ds = xt if extra == "ties" else x
            if extra == "bias":
                kw["row_bias"] = bias
            if extra == "sqrt":
                kw["sqrt"] = True
            if extra == "underfill":
                kw.update(keep_mask=keep, row_bias=bias)
            rd, ri = fk.fused_knn_plain(ds, q[:m], k, **kw)
            errs = {}
            for route in fk._F32_ROUTES:
                before = f32_route_counts()
                dv, di = fk._fused_knn_f32(route, ds, q[:m], k, **kw)
                torch.cuda.synchronize()
                assert f32_route_counts() == dict(before, **{route: before[route] + 1}), route
                try:
                    e = errs[route] = knn_equiv(dv, di, rd, ri, rtol=1e-5, atol=1e-5)
                except AssertionError as exc:
                    fin = torch.isfinite(rd)
                    rel = ((dv - rd).abs() / rd.abs().clamp_min(1e-30))[fin].max()
                    emit(phase="check", kernel="fused_knn", mode="f32", route=route, n=n, d=d,
                         m=m, k=k, metric=metric, extra=extra, tolerance=1e-5, ok=False,
                         max_rel_err=float(rel), failure=str(exc)[:200])
                    failed.append((route, d, m, k, metric, extra))
                    continue
                if extra == "underfill":
                    assert bool((di[:, 5:] == -1).all()), "underfill ids are not -1"
                if extra == "ties":
                    half = n // 2
                    for r in range(m):
                        ids = di[r].tolist()
                        for j, i in enumerate(ids):
                            if half <= i < 2 * half:
                                assert i - half in ids[:j], (route, r, ids)
                err[route] = max(err[route], e)
            emit(phase="check", kernel="fused_knn", mode="f32", n=n, d=d, m=m, k=k,
                 metric=metric, extra=extra, tolerance=1e-5, max_abs_err_by_route=errs,
                 ok=len(errs) == len(fk._F32_ROUTES))
        del x, xt, q
    for route, e in err.items():
        st["f32_err"][route] = max(st["f32_err"].get(route, 0.0), e)
    emit(phase="check", kernel="fused_knn", mode="f32", max_abs_err_by_route=err,
         failed=failed, ok=not failed, card=st["card"])
    assert not failed, failed


def check_tf32x3_gate(st):
    """The 3xTF32 route's gate at the batch: 10,000 queries x 1M rows, k =
    10, l2, at d = 64, 128 and 256 by knn_equiv at rtol = atol = 1e-5
    against the plain version, and at d = 1,024 within tc_rounding_bound
    (mode "tf32x3") + 1e-5. Every case prints its largest error; a case
    that fails is printed with its shape, seed and error, then raises."""
    import torch

    from raft_tpu_torch.ops import fused_knn as fk

    dev = torch.device("cuda")
    gate = {}
    for d, seed in ((64, 50), (128, 51), (256, 52), (1024, 53)):
        gd = torch.Generator(device=dev).manual_seed(seed)
        x = torch.rand((N_MAIN, d), generator=gd, device=dev)
        q = torch.rand((M_MAIN, d), generator=gd, device=dev)
        dv, di = fk._fused_knn_f32("tf32x3", x, q, K_MAIN)
        torch.cuda.synchronize()
        rd, ri = fk.fused_knn_plain(x, q, K_MAIN)
        case = dict(n=N_MAIN, d=d, m=M_MAIN, k=K_MAIN, metric="l2", seed=seed)
        ad = (dv - rd).abs()
        out = dict(max_abs_err=float(ad.max()),
                   max_rel_err=float((ad / rd.abs().clamp_min(1e-30)).max()))
        try:
            if d <= 256:
                knn_equiv(dv, di, rd, ri, rtol=1e-5, atol=1e-5)
                out["tolerance"] = "knn_equiv 1e-5"
            else:
                bound = fk.tc_rounding_bound(x, q, ri, "l2", "tf32x3")
                out["tolerance"] = f"1e-5 + tc_rounding_bound tf32x3 (max {float(bound.max()):.3g})"
                out["err_over_bound"] = float((ad / bound.clamp_min(1e-30)).max())
                assert bool((ad <= 1e-5 + 1e-5 * rd.abs() + bound).all()), "beyond the bound"
                knn_equiv(dv, di, rd, ri, rtol=1e-5, atol=1e-5 + float(bound.max()))
            out["ok"] = True
        except AssertionError as e:
            out.update(ok=False, failure=str(e)[:300])
        gate[d] = out
        emit(phase="check", kernel="fused_knn", mode="f32", route="tf32x3", gate=True,
             card=st["card"], **case, **out)
        del x, q, dv, di, rd, ri, ad
    st["tf32x3_gate"] = gate
    assert all(v["ok"] for v in gate.values()), gate


# (d, m, n, k, metric, extra) of the tensor-core modes' edge sweep: every d
# of the fused gate's sweep, m not a multiple of the query tile, n ragged
# against the tile and the split, k of 1 / 10 / 64, l2 / ip / sqrt, a filter
# that keeps fewer than k rows, and a dataset whose second half repeats its
# first (ties must go to the lower row)
TC_EDGES = [
    (64, 1, 100_003, 1, "ip", None),
    (70, 300, 100_003, 10, "l2", None),
    (70, 65, 100_003, 64, "l2", "sqrt"),
    (100, 1000, 100_003, 10, "ip", None),
    (100, 300, 100_003, 10, "l2", "underfill"),
    (128, 2047, 100_006, 10, "l2", "ties"),
    (128, 65, 4099, 64, "ip", None),
    (256, 300, 100_003, 64, "ip", None),
    (256, 1000, 100_003, 1, "l2", "sqrt"),
    (1024, 300, 100_003, 10, "l2", None),
]


def check_tc_edges(st, g):
    """``fused_knn``'s tensor-core modes over TC_EDGES against the plain
    version: s8 bit for bit; bf16 and f32x3 by knn_equiv at rtol = atol =
    1e-5, and at d = 1024 within ``tc_rounding_bound`` (wgmma truncates its
    float32 sums; the largest error and its row are printed). Then uint8
    inner products and L2 through ``knn``, bit for bit against the CPU."""
    import numpy as np
    import torch

    from raft_tpu_torch.core import Resources
    from raft_tpu_torch.neighbors.brute_force import knn
    from raft_tpu_torch.ops.fused_knn import fused_knn, fused_knn_plain, tc_rounding_bound

    dev = torch.device("cuda")
    saved = fused_knn.launches, dict(fused_knn.launches_by_mode)
    err = 0.0
    for mode in ("bf16", "f32x3", "s8"):
        for d, m, n, k, metric, extra in TC_EDGES:
            if mode == "s8":
                x = torch.randint(-128, 128, (n, d), generator=g, device=dev, dtype=torch.int8)
                q = torch.randint(-128, 128, (m, d), generator=g, device=dev, dtype=torch.int8)
            else:
                x = torch.rand((n, d), generator=g, device=dev)
                q = torch.rand((m, d), generator=g, device=dev)
            kw = dict(metric=metric, mode=mode)
            if extra == "ties":
                x[n // 2:] = x[:n // 2].clone()
            if extra == "sqrt":
                kw["sqrt"] = True
            if extra == "underfill":
                keep = torch.zeros(n, dtype=torch.bool, device=dev)
                keep[torch.randperm(n, generator=g, device=dev)[:5]] = True
                kw["keep_mask"] = keep
            before = dict(fused_knn.launches_by_mode)
            dv, di = fused_knn(x, q, k, **kw)
            torch.cuda.synchronize()
            assert fused_knn.launches_by_mode == dict(before, **{mode: before[mode] + 1})
            rd, ri = fused_knn_plain(x, q, k, **kw)
            case = dict(mode=mode, d=d, m=m, n=n, k=k, metric=metric, extra=extra)
            tol = "1e-5"
            if mode == "s8":
                assert torch.equal(dv, rd) and torch.equal(di, ri), f"s8 differs: {case}"
                e = 0.0
            elif d > 256:
                bound = tc_rounding_bound(x, q, ri, metric, mode)
                ad = (dv - rd).abs()
                e = float(ad.max())
                row = int(ad.max(dim=1).values.argmax())
                assert bool((ad <= 1e-5 + 1e-5 * rd.abs() + bound).all()), f"beyond bound: {case}"
                knn_equiv(dv, di, rd, ri, rtol=1e-5, atol=1e-5 + float(bound.max()))
                tol = (f"1e-5 + tc_rounding_bound (max {float(bound.max()):.3g}); "
                       f"worst row {row}, err/bound {float((ad / bound.clamp_min(1e-30)).max()):.3g}, "
                       f"err/|d| {float((ad / rd.abs().clamp_min(1e-30)).max()):.3g}")
            else:
                e = knn_equiv(dv, di, rd, ri, rtol=1e-5, atol=1e-5)
            if extra == "underfill":
                assert bool((di[:, 5:] == -1).all()), "underfill ids are not -1"
            if extra == "ties":
                half = n // 2
                # each repeated row ranks right behind its first copy
                for r in range(m):
                    ids = di[r].tolist()
                    for j, i in enumerate(ids):
                        if i >= half:
                            assert i - half in ids[:j], (r, ids)
            err = max(err, e)
            emit(phase="check", kernel="fused_knn_tc", tolerance=tol, max_abs_err=e,
                 ok=True, **case)
            del x, q
    rng = np.random.default_rng(3)
    xu = rng.integers(0, 256, (100_003, 96), dtype=np.uint8)
    qu = rng.integers(0, 256, (1000, 96), dtype=np.uint8)
    for metric in ("inner_product", "sqeuclidean"):
        before = fused_knn.launches_by_mode["s8"]
        kd, ki = knn(xu, qu, 10, metric=metric, res=Resources(device="cuda"))
        torch.cuda.synchronize()
        assert fused_knn.launches_by_mode["s8"] == before + 1
        cd, ci = knn(xu, qu, 10, metric=metric, res=Resources(device="cpu"))
        assert torch.equal(kd.cpu(), cd) and torch.equal(ki.cpu(), ci), metric
        emit(phase="check", kernel="fused_knn_tc", path=f"knn uint8 {metric}", n=100_003,
             d=96, m=1000, k=10, bit_equal_to_cpu=True, ok=True)
    st["tc_err"] = max(st["tc_err"], err)
    fused_knn.launches, fused_knn.launches_by_mode = saved[0], saved[1]


def plant_topk_rows(v, g):
    """Plant ties, infinities, clamped extremes, -0 and NaN in rows of ``v``
    (in place), a tenth of the rows each; one row all NaN, one sorted."""
    import torch

    m, n = v.shape
    rows = torch.arange(m, device=v.device)[:, None]
    cols = torch.randint(0, n, (m, min(n, 300)), generator=g, device=v.device)
    t = max(1, m // 10)
    part = [slice(i * t, (i + 1) * t) for i in range(7)]
    v[rows[part[0]], cols[part[0]]] = 0.0                  # ties among the smallest
    v[rows[part[1]], cols[part[1]]] = 1.0                  # ties among the largest
    v[rows[part[2]], cols[part[2], :40]] = float("inf")
    v[rows[part[2]], cols[part[2], 40:80]] = float("-inf")
    v[rows[part[3]], cols[part[3], :40]] = 3.1e38          # clamps to 2.9e38
    v[rows[part[3]], cols[part[3], 40:80]] = -3.3e38
    v[rows[part[4]], cols[part[4], :40]] = float("nan")
    v[rows[part[4]], cols[part[4], 40:80]] = -float("nan")
    v[rows[part[5]], cols[part[5], :100]] = -0.0
    v[rows[part[6]], cols[part[6], :100]] = float("nan")
    v[rows[part[6]], cols[part[6], 100:]] = -0.0
    v[-1] = float("nan")
    v[-2] = torch.sort(v[-2], descending=True).values


def check_topk(v, k, smin, ids=None):
    """``topk`` (one launch: values, ids) against ``topk_plain`` on the card,
    bit for bit: ids, and the values' bits (NaN included)."""
    import torch

    from raft_tpu_torch.ops.topk import topk, topk_plain

    before = topk.launches
    ov, oi = topk(v, k, select_min=smin, in_idx=ids)
    torch.cuda.synchronize()
    assert topk.launches == before + 1, "topk did not launch once"
    pv, pi = topk_plain(v, k, select_min=smin)
    if ids is not None:
        pi = torch.gather(ids, 1, pi.long()).to(torch.int32)
    as_int = torch.int32 if v.element_size() == 4 else torch.int16
    same_i = torch.equal(oi, pi)
    same_v = torch.equal(ov.view(as_int), pv.view(as_int))
    assert same_i and same_v, (
        f"topk differs from topk_plain: shape {tuple(v.shape)} {v.dtype} k={k} "
        f"min={smin}; rows {(oi != pi).any(1).nonzero().flatten()[:5].tolist()}")


def phase_pq_kernel(st):
    """``pq_scan`` against ``pq_scan_plain`` on the card, bit for bit."""
    import torch

    from raft_tpu_torch.ops.pq_scan import pq_scan, pq_scan_plain

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    n_lists, cap = PQ_LISTS, PQ_CAP
    cases = [   # (S, split, lut dtype, lists, cap, pairs, probes, code range)
        (64, False, torch.float32, n_lists, cap, 1024, "random", 16),
        (64, False, torch.bfloat16, n_lists, cap, 1024, "random", 16),
        (32, True, torch.float32, n_lists, cap, 1024, "random", 256),
        (32, True, torch.bfloat16, n_lists, cap, 1024, "random", 256),
        (24, False, torch.float32, 64, 1000, 256, "random", 16),
        (24, True, torch.bfloat16, 64, 1000, 256, "random", 256),
        (96, False, torch.bfloat16, 64, 777, 300, "random", 16),
        (64, False, torch.bfloat16, n_lists, cap, 1024, "repeated", 16),
        (32, True, torch.float32, n_lists, cap, 1024, "repeated", 256),
        (64, False, torch.float32, 64, 1000, 256, "random", 256),   # stray bytes: & 15
        (128, False, torch.float32, 1000, 1300, 1024, "random", 16),  # the CAGRA build's
    ]
    for s, split, dt, nl, cp, pairs, how, hi in cases:
        codes = torch.randint(0, hi, (nl, cp, s), generator=g, device=dev,
                              dtype=torch.uint8)
        top = 4 if how == "repeated" else nl
        probes = torch.randint(0, top, (pairs,), generator=g, device=dev,
                               dtype=torch.int32)
        if how == "repeated":
            probes[: pairs // 2] = 1
        lut = (torch.randn((pairs, s, 32 if split else 16), generator=g, device=dev)
               * 50.0).to(dt)
        before = pq_scan.launches
        got = pq_scan(codes, probes, lut, split=split)
        torch.cuda.synchronize()
        assert pq_scan.launches == before + 1, "pq_scan did not launch"
        want = pq_scan_plain(codes, probes, lut, split=split)
        assert torch.equal(got, want), (
            f"pq_scan differs from its plain version: S={s} split={split} {dt} "
            f"max abs err {float((got - want).abs().max())}")
        emit(phase="check", kernel="pq_scan", n_lists=nl, cap=cp, S=s, split=split,
             lut_dtype=str(dt).split(".")[1], pairs=pairs, probes=how,
             code_range=hi, max_abs_err=0.0, bit_equal=True, ok=True)
    st["pq_err"] = 0.0


def pq_topk_case(g, n_lists, cap, s, t, pc, split, dt, inner, top):
    """Inputs of ``pq_scan_topk`` on the card: lists with holes and short
    fills, list 0 empty, query 0's probes all on list 0 but one (fewer
    filled slots than k), a duplicated code row probed twice by query 1 with
    equal LUTs and biases (ties across probes and within a list)."""
    import torch

    dev = torch.device("cuda")
    kk = 32 if split else 16
    codes = torch.randint(0, 256 if split else 16, (n_lists, cap, s), generator=g, device=dev,
                          dtype=torch.uint8)
    codes[2, 9] = codes[2, 5]
    codes[3, 0] = codes[2, 5]
    size = cap - (torch.arange(n_lists, device=dev)[:, None] * 37) % (cap // 3 + 1)
    ids = torch.randperm(n_lists * cap, generator=g, device=dev).to(torch.int32)
    ids = torch.where(torch.arange(cap, device=dev)[None, :] < size,
                      ids.reshape(n_lists, cap), -1)
    ids[1::7, ::5] = -1
    ids[0] = -1
    probes = torch.randint(1, top, (t, pc), generator=g, device=dev, dtype=torch.int32)
    lut = torch.randn((t, pc, s, kk), generator=g, device=dev) * 20
    bias = torch.randn((t, pc), generator=g, device=dev) * 100
    probes[0] = 0
    probes[0, -1] = 5
    probes[1, 0] = 2
    if pc > 1:
        probes[1, 1] = 3
        lut[1, 1] = lut[1, 0]
        bias[1, 1] = bias[1, 0]
    consts = None
    if split and not inner:
        consts = torch.randn((n_lists, cap), generator=g, device=dev) * 5
        consts[2, 9] = consts[3, 0] = consts[2, 5]
    return codes, ids, probes.contiguous(), lut.to(dt).contiguous(), bias, consts


def phase_pq_topk_kernel(st):
    """``pq_scan_topk`` against ``pq_scan_topk_plain`` on the card, bit for
    bit (values' bits and ids): the GPU tests' grid (pq4 and split pq8, f32
    and bf16 LUTs, L2 and inner product, k in {1, 7, 40, 256}, pc in {1, 3,
    8}, S of 24, 64 and 128), the main tile (128 queries x 8 probes of a
    1,024-list index, cap 1,272, S=64, bf16, k=40) and the CAGRA build's
    (1,000 lists, cap 1,300, S=128, f32, k=193, pc 8 and 32)."""
    import torch

    from raft_tpu_torch.ops.pq_scan import pq_scan_topk, pq_scan_topk_plain

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(8)
    grid = [dict(n_lists=40, cap=300, s=s, t=16, pc=pc, split=split, dt=dt, inner=inner,
                 top=40, k=k)
            for split, dt, inner in ((False, torch.float32, False),
                                     (False, torch.bfloat16, True),
                                     (True, torch.float32, False),
                                     (True, torch.bfloat16, False),
                                     (True, torch.float32, True))
            for s in (24, 64, 128) for pc in (1, 3, 8) for k in (1, 7, 40, 256)]
    main = [dict(n_lists=PQ_LISTS, cap=PQ_CAP, s=64, t=128, pc=8, split=False,
                 dt=torch.bfloat16, inner=False, top=300, k=40),
            dict(n_lists=1000, cap=1300, s=128, t=128, pc=8, split=False,
                 dt=torch.float32, inner=False, top=1000, k=193),
            dict(n_lists=1000, cap=1300, s=128, t=128, pc=32, split=False,
                 dt=torch.float32, inner=False, top=1000, k=193)]
    for n, c in enumerate(grid + main):
        c = dict(c)
        k, inner = c.pop("k"), c["inner"]
        codes, ids, probes, lut, bias, consts = pq_topk_case(g, **c)
        before = pq_scan_topk.launches
        v, i = pq_scan_topk(codes, ids, probes, lut, bias, k, not inner, split=c["split"],
                            list_consts=consts)
        torch.cuda.synchronize()
        assert pq_scan_topk.launches == before + 1, "pq_scan_topk did not launch"
        pv, pi = pq_scan_topk_plain(codes, ids, probes, lut, bias, k, not inner, c["split"],
                                    consts)
        same_v = torch.equal(v.view(torch.int32), pv.view(torch.int32))
        assert same_v and torch.equal(i, pi), (
            f"pq_scan_topk differs from its plain version: {c} k={k}; rows "
            f"{(i != pi).any(1).nonzero().flatten()[:5].tolist()}")
        if n >= len(grid) or (k == 256 and c["pc"] == 8 and c["s"] == 64):
            emit(phase="check", kernel="pq_scan_topk", n_lists=c["n_lists"], cap=c["cap"],
                 S=c["s"], T=c["t"], pc=c["pc"], k=k, split=c["split"],
                 lut_dtype=str(c["dt"]).split(".")[1], inner_product=inner,
                 underfilled_rows=int((i == -1).any(1).sum()), max_abs_err=0.0,
                 bit_equal=True, ok=True)
    emit(phase="check", kernel="pq_scan_topk", grid_cases=len(grid), main_cases=len(main),
         max_abs_err=0.0, bit_equal=True, ok=True)
    st["pq_topk_err"] = 0.0


def hop_candidates(beam_i, lq, lx, cw, g):
    """(m, cw) candidate ids: half from each query's own cluster (they beat
    a random beam and get merged), half uniform; with a beam id, a repeat
    within the row and a -1 planted."""
    import torch

    m, dev = beam_i.shape[0], beam_i.device
    order = torch.argsort(lx)
    counts = torch.bincount(lx, minlength=CAGRA_CENTERS)
    starts = torch.cumsum(counts, 0) - counts
    pos = starts[lq][:, None] + (torch.rand((m, cw), generator=g, device=dev)
                                 * counts[lq][:, None]).long()
    near = order[pos]
    far = torch.randint(0, lx.shape[0], (m, cw), generator=g, device=dev)
    nbrs = torch.where(torch.rand((m, cw), generator=g, device=dev) < 0.5, near, far)
    nbrs = nbrs.to(torch.int32)
    nbrs[::2, 0] = beam_i[::2, 1]
    nbrs[::3, 1] = nbrs[::3, 2]
    nbrs[::4, 3] = -1
    return nbrs.contiguous()


HOP_CASES = [   # (itopk, width, merge, rows, d)
    (32, 1, "extract", "f32", 128), (32, 1, "arena", "f32", 128),
    (32, 2, "extract", "f32", 128), (32, 2, "arena", "f32", 128),
    (64, 1, "arena", "f32", 128), (64, 2, "extract", "f32", 128),
    (64, 2, "arena", "f32", 128), (32, 1, "arena", "int8", 128),
    (64, 2, "extract", "int8", 128), (32, 1, "extract", "f32", 100),
    (32, 2, "arena", "f32", 126), (32, 1, "arena", "int8", 100),
]


def phase_hop_kernel(st, m=HOP_M, cases=HOP_CASES):
    """``cagra_hop`` against ``cagra_hop_plain`` on the card, bit for bit, on
    ``m`` queries of the CAGRA set (2,048; the serve phase checks m=1). Each
    case starts from a beam of random ids with their true distances (every
    7th row half full), sorted by one plain prime call, then checks the
    kernel's prime call and one hop."""
    import torch

    from raft_tpu_torch.ops.cagra_hop import cagra_hop, cagra_hop_plain

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    x, q, lx, lq = cagra_data()
    q, lq = q[:m].contiguous(), lq[:m]
    sets = {("f32", 128): (x, q),
            ("int8", 128): ((x * 12.7 - 64.0).round().clamp(-128, 127).to(torch.int8),
                            q * 12.7 - 64.0),
            ("f32", 100): (x[:, :100].contiguous(), q[:, :100].contiguous()),
            ("f32", 126): (x[:, :126].contiguous(), q[:, :126].contiguous()),
            ("int8", 100): (x[:, :100].mul(12.7).sub(64.0).round().clamp(-128, 127)
                            .to(torch.int8).contiguous(), q[:, :100] * 12.7 - 64.0)}
    for itopk, width, merge, kind, d in cases:
        data, qq = sets[(kind, d)]
        qq = qq.contiguous()
        cw = 32 * width
        ids = torch.randint(0, N_MAIN, (m, itopk), generator=g, device=dev, dtype=torch.int32)
        bd = torch.full((m, 128), float("inf"), device=dev)
        bi = torch.full((m, 128), -1, dtype=torch.int32, device=dev)
        bv = torch.ones((m, 128), dtype=torch.int32, device=dev)
        bd[:, :itopk] = ((data[ids.long()].float() - qq[:, None]) ** 2).sum(-1)
        bi[:, :itopk] = ids
        bv[:, :itopk] = 0
        bd[::7, itopk // 2:itopk] = float("inf")
        bi[::7, itopk // 2:itopk] = -1
        none = torch.full((m, cw), -1, dtype=torch.int32, device=dev)
        zero = torch.zeros((m, cw), dtype=torch.int32, device=dev)
        prime = (qq, bd, bi, bv, none, data, zero, itopk, width)
        beam = cagra_hop_plain(*prime, merge="extract")[:3]
        nbrs = hop_candidates(beam[1], lq, lx, cw, g)
        valid = (torch.rand((m, cw), generator=g, device=dev) > 0.1).to(torch.int32)
        valid[5::11] = 0
        for what, args in (("prime", prime), ("hop", (qq, *beam, nbrs, data, valid, itopk,
                                                      width))):
            before = cagra_hop.launches
            got = cagra_hop(*args, merge=merge)
            torch.cuda.synchronize()
            assert cagra_hop.launches == before + 1, "cagra_hop did not launch"
            want = cagra_hop_plain(*args, merge=merge)
            for name, a, b in zip(("beam_d", "beam_i", "beam_v", "pick", "no_cand"), got, want):
                assert torch.equal(a, b), (
                    f"cagra_hop differs from its plain version in {name}: {what} itopk={itopk} "
                    f"width={width} {merge} {kind} d={d}; {int((a != b).sum())} entries")
            inserted = int((got[2][:, :itopk] == 0).sum()) if what == "hop" else 0
            carved = check_hop_carve_outs(args, merge, got) if what == "hop" else []
            emit(phase="check", kernel="cagra_hop", call=what, m=m, n=data.shape[0], d=d,
                 rows=kind, itopk=itopk, width=width, cw=cw, merge=merge,
                 unvisited_after=inserted, no_cand_rows=int(got[4][:, 0].sum()),
                 carve_outs_bit_equal=carved, max_abs_err=0.0, bit_equal=True, ok=True)
    st["hop_err"] = 0.0


def check_hop_carve_outs(args, merge, full):
    """Each ``profile`` carve-out of ``cagra_hop`` against its plain version,
    bit for bit, one launch counted under its own mode; "nogate" also
    equals "full" (``full``, the kernel's outputs). Returns the profiles
    checked."""
    import torch

    from raft_tpu_torch.ops.cagra_hop import PROFILES, cagra_hop, cagra_hop_plain

    for prof in PROFILES[1:]:
        before = cagra_hop.launches_by_mode[prof]
        got = cagra_hop(*args, merge=merge, profile=prof)
        torch.cuda.synchronize()
        assert cagra_hop.launches_by_mode[prof] == before + 1, f"cagra_hop {prof} did not launch"
        want = cagra_hop_plain(*args, merge=merge, profile=prof)
        for name, a, b in zip(("beam_d", "beam_i", "beam_v", "pick", "no_cand"), got, want):
            assert torch.equal(a, b), (
                f"cagra_hop profile={prof} differs from its plain version in {name} ({merge}); "
                f"{int((a != b).sum())} entries")
        if prof == "nogate":
            assert all(torch.equal(a, b) for a, b in zip(got, full)), \
                f"cagra_hop profile=nogate differs from full ({merge})"
    return list(PROFILES[1:])


def phase_main(st):
    import torch

    from raft_tpu_torch.core import Resources
    from raft_tpu_torch.matrix import select_k
    from raft_tpu_torch.neighbors.brute_force import BruteForce
    from raft_tpu_torch.ops.fused_knn import fused_knn, fused_knn_plain
    from raft_tpu_torch.ops.topk import topk

    res = Resources(device="cuda")
    dev = torch.device("cuda")
    x = torch.rand((N_MAIN, D_MAIN), generator=torch.Generator(device=dev).manual_seed(0),
                   device=dev)
    q = torch.rand((M_MAIN, D_MAIN), generator=torch.Generator(device=dev).manual_seed(1),
                   device=dev)
    index = BruteForce(metric="sqeuclidean").build(x, res=res)
    index.search(q, K_MAIN)                  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    batches = 3
    reset_all_counts()
    t0 = time.perf_counter()
    for _ in range(batches):
        dist, ids = index.search(q, K_MAIN)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    routes = f32_route_counts()
    launches = {"fused_knn": fused_knn.launches, "topk": topk.launches,
                "fused_knn_tf32x3": routes["tf32x3"],
                "tf32_split": all_counts()["tf32_split"]}
    # one launch a 10k-query batch, on the batch route alone
    assert routes == dict(dict.fromkeys(routes, 0), tf32x3=batches), routes
    assert fused_knn.launches == batches and topk.launches == 0, launches
    peak = torch.cuda.max_memory_allocated()
    assert dist.shape == (M_MAIN, K_MAIN) and ids.shape == (M_MAIN, K_MAIN)
    assert bool(torch.isfinite(dist).all()) and bool((ids >= 0).all())
    rd, ri = fused_knn_plain(x, q[:1024], K_MAIN, metric="l2")
    err = knn_equiv(dist[:1024], ids[:1024], rd, ri, rtol=1e-5, atol=1e-5)
    st["launches"] = launches
    emit(phase="main", path="BruteForce.search", n=N_MAIN, d=D_MAIN, m=M_MAIN,
         k=K_MAIN, batches=batches, qps=batches * M_MAIN / wall,
         seconds_per_batch=wall / batches, peak_device_bytes=peak,
         launches=launches, check_rows=1024, max_abs_err=err, card=st["card"])

    xf = x[:100_000].contiguous()
    flag = BruteForce(metric="sqeuclidean").build(xf, res=res)
    flag.search(q, K_MAIN)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(batches):
        flag.search(q, K_MAIN)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    emit(phase="main", path="BruteForce.search (bench.py flagship shape)",
         n=100_000, d=D_MAIN, m=M_MAIN, k=K_MAIN, qps=batches * M_MAIN / wall,
         card=st["card"])
    st["main"] = (x, q)
    st["main_ids"] = ids

    # the same index at serving shapes: one row-split launch a search
    for m in (1, SERVE_MAX_BATCH):
        index.search(q[:m], K_MAIN)              # warm-up
        torch.cuda.synchronize()
        reset_all_counts()
        t0 = time.perf_counter()
        d1, i1 = index.search(q[:m], K_MAIN)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        routes = f32_route_counts()
        assert routes == dict(dict.fromkeys(routes, 0), rows=1), routes
        launches["fused_knn_rows"] = launches.get("fused_knn_rows", 0) + routes["rows"]
        with uncounted():
            rd, ri = fused_knn_plain(x, q[:m], K_MAIN, metric="l2")
        e = knn_equiv(d1, i1, rd, ri, rtol=1e-5, atol=1e-5)
        emit(phase="main", path="BruteForce.search (serving shape)", n=N_MAIN, d=D_MAIN, m=m,
             k=K_MAIN, ms=wall * 1e3, launches_by_route=routes, max_abs_err=e, card=st["card"])

    vals = torch.rand(TOPK_SHAPE, generator=torch.Generator(device=dev).manual_seed(2),
                      device=dev)
    select_k(vals, K_MAIN, res=res)          # warm-up
    torch.cuda.synchronize()
    fused_knn.launches = topk.launches = 0
    t0 = time.perf_counter()
    out_v, out_i = select_k(vals, K_MAIN, res=res)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    assert topk.launches > 0, "select_k did not launch topk"
    st["launches"]["topk"] = topk.launches
    ref = torch.sort(vals[:64], dim=1, stable=True)
    assert torch.equal(out_v[:64], ref.values[:, :K_MAIN])
    assert torch.equal(out_i[:64].long(), ref.indices[:, :K_MAIN])
    emit(phase="main", path="select_k", shape=list(TOPK_SHAPE), k=K_MAIN,
         ms=wall * 1e3, launches={"topk": topk.launches}, card=st["card"])
    st["select"] = vals


def phase_tc_path(st):
    """``knn`` at 1M x 128, one 10k-query batch, k=10, in each tensor-core
    mode through the public entry point: ``compute="bfloat16"``,
    ``compute="float32x3"`` and int8 data under the default compute. The
    counts are set to 0 just before each batch and read just after; each
    must launch the mode's kernel once and none of mode f32's routes. Each
    batch is held against the plain version on all its queries: int8 bit
    for bit, bf16 and f32x3 by knn_equiv at rtol = atol = 1e-5. bf16's and
    f32x3's recall@10 against the float32 answer of the main path is
    reported beside them."""
    import torch

    from raft_tpu_torch.core import Resources
    from raft_tpu_torch.neighbors.brute_force import knn
    from raft_tpu_torch.ops.fused_knn import bf16_split, fused_knn, fused_knn_plain

    res = Resources(device="cuda")
    x, q = st["main"]
    truth = st["main_ids"]
    xs, qs = (as_bytes(a, 255.0, -128.0) for a in (x, q))
    runs = {"bf16": (x, q, "bfloat16"), "f32x3": (x, q, "float32x3"), "s8": (xs, qs, "float32")}
    st["tc_launches"] = {}
    for mode, (ds, qq, compute) in runs.items():
        fused_knn.launches = bf16_split.launches = 0
        fused_knn.launches_by_mode = dict.fromkeys(fused_knn.launches_by_mode, 0)
        dist, ids = knn(ds, qq, K_MAIN, compute=compute, res=res)
        torch.cuda.synchronize()
        counts = dict(fused_knn.launches_by_mode, bf16_split=bf16_split.launches)
        assert counts[mode] == 1 and fused_knn.launches == 1, counts
        # f32x3 splits the queries and the dataset into bf16 planes
        assert counts["bf16_split"] == (2 if mode == "f32x3" else 0), counts
        if mode == "f32x3":
            st["split_launches"] = counts["bf16_split"]
        assert dist.shape == (M_MAIN, K_MAIN) and bool(torch.isfinite(dist).all())
        st["tc_launches"][mode] = counts[mode]
        out = dict(mode=mode, compute=compute, launches=counts, check_rows=M_MAIN)
        rd, ri = fused_knn_plain(ds, qq, K_MAIN, mode=mode)
        if mode == "s8":
            assert torch.equal(dist, rd) and torch.equal(ids, ri), "int8 knn differs"
            out["max_abs_err"] = 0.0
        else:
            out["max_abs_err"] = knn_equiv(dist, ids, rd, ri, rtol=1e-5, atol=1e-5)
            out["recall_at_10_vs_f32"] = recall(ids, truth)
        st["tc_err"] = max(st.get("tc_err", 0.0), out["max_abs_err"])
        del rd, ri
        emit(phase="main", path="knn (tensor-core mode)", n=N_MAIN, d=D_MAIN, m=M_MAIN,
             k=K_MAIN, card=st["card"], **out)
    fused_knn.launches = bf16_split.launches = 0


def as_bytes(a, scale, shift=0.0, kind="int8"):
    """Float rows as bytes: round(scale·a + shift) clamped into int8, or as
    uint8 with 128 added after the rounding. The byte cells' data: the
    uniform main set at (255, -128), the IVF-PQ blob set at (12, 0), the
    CAGRA set at (12.7, -64)."""
    import torch

    v = (a * scale + shift).round()
    if kind == "uint8":
        return (v + 128.0).clamp(0, 255).to(torch.uint8)
    return v.clamp(-128, 127).to(torch.int8)


def blobs(n, centers, seed, scale=1.0):
    """n rows, each one of ``centers`` plus N(0, scale^2) noise, and their
    center labels."""
    import torch

    g = torch.Generator(device=centers.device).manual_seed(seed)
    lab = torch.randint(0, centers.shape[0], (n,), generator=g, device=centers.device)
    return centers[lab] + scale * torch.randn((n, centers.shape[1]), generator=g,
                                              device=centers.device), lab


def cagra_data():
    """The CAGRA set (bench.py's ``_make_clustered(1_000_000, 128, 10_000,
    2000)`` drawn with torch): dataset, queries and their labels."""
    import torch

    dev = torch.device("cuda")
    centers = 10.0 * torch.rand((CAGRA_CENTERS, D_MAIN), device=dev,
                                generator=torch.Generator(device=dev).manual_seed(20))
    x, lx = blobs(N_MAIN, centers, 21, 0.5)
    q, lq = blobs(CAGRA_Q, centers, 22, 0.5)
    return x, q, lx, lq


def recall(ids, truth):
    return float((ids[:, :, None] == truth[:, None, :]).any(-1).sum()) / truth.numel()


def phase_ivf(st):
    """IVF-PQ build, search and refine at 1M x 128 (the synthetic stand-in for
    SIFT-1M, whose files the repository does not hold)."""
    import dataclasses

    import torch

    from raft_tpu_torch.core import Resources
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.neighbors.brute_force import BruteForce
    from raft_tpu_torch.neighbors.refine import refine
    from raft_tpu_torch.ops.fused_knn import fused_knn
    from raft_tpu_torch.ops.pq_scan import pq_scan, pq_scan_topk
    from raft_tpu_torch.ops.topk import topk

    def reset():
        fused_knn.launches = topk.launches = pq_scan.launches = pq_scan_topk.launches = 0

    def counts():
        return {"fused_knn": fused_knn.launches, "topk": topk.launches,
                "pq_scan": pq_scan.launches, "pq_scan_topk": pq_scan_topk.launches}

    res = Resources(device="cuda")
    dev = torch.device("cuda")
    centers = 2.0 * torch.randn((IVF_BLOBS, D_MAIN), device=dev,
                                generator=torch.Generator(device=dev).manual_seed(10))
    x, _ = blobs(N_MAIN, centers, 11)
    q, _ = blobs(IVF_Q, centers, 12)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ivf_params = ivf_pq.IndexParams(n_lists=1024, pq_bits=4, pq_dim=64, seed=0)
    index = ivf_pq.build(ivf_params, x, res=res)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    st["ivf_params"], st["ivf_build_s"] = ivf_params, build_s
    index_bytes = sum(t.numel() * t.element_size() for t in (
        index.centers, index.centers_rot, index.rotation, index.codebooks,
        index.list_codes, index.list_ids, index.list_sizes, index.list_consts))
    assert index.size == N_MAIN and index.pq_dim == 64 and not index.pq_split
    emit(phase="ivf_build", n=N_MAIN, d=D_MAIN, blobs=IVF_BLOBS, build_seconds=build_s,
         n_lists=index.n_lists, capacity=index.capacity, pq_dim=index.pq_dim,
         pq_bits=index.pq_bits, index_bytes=index_bytes,
         code_bytes=index.list_codes.numel(), card=st["card"])

    sp = ivf_pq.SearchParams(n_probes=8, lut_dtype="bfloat16")
    d, i = ivf_pq.search(sp, index, q, IVF_K0, res=res)      # warm-up
    refine(x, q, i, K_MAIN, res=res)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    live = torch.cuda.memory_allocated()      # data, index and earlier phases' tensors
    batches = 3
    reset()
    t0 = time.perf_counter()
    for _ in range(batches):
        d, i = ivf_pq.search(sp, index, q, IVF_K0, res=res)
    torch.cuda.synchronize()
    search_s = (time.perf_counter() - t0) / batches
    launches = counts()
    tiles = -(-IVF_Q // 128)
    assert launches["pq_scan_topk"] == tiles * batches, (
        f"the IVF-PQ search launched pq_scan_topk {launches['pq_scan_topk']} times, "
        f"not {tiles} a batch")
    assert launches["topk"] == 0 and launches["pq_scan"] == 0, launches
    t0 = time.perf_counter()
    for _ in range(batches):
        d, i = ivf_pq.search(sp, index, q, IVF_K0, res=res)
        rd, ri = refine(x, q, i, K_MAIN, res=res)
    torch.cuda.synchronize()
    both_s = (time.perf_counter() - t0) / batches
    peak = torch.cuda.max_memory_allocated()
    assert d.shape == (IVF_Q, IVF_K0) and rd.shape == (IVF_Q, K_MAIN)
    assert bool(torch.isfinite(rd).all()) and bool((ri >= 0).all())
    assert bool((ri < N_MAIN).all())

    # the plain route (the one-hot contraction) on 1,000 of the queries
    pd, pi = ivf_pq.search(dataclasses.replace(sp, scan_impl="onehot"), index,
                           q[:IVF_CHECK], IVF_K0, res=res)
    err = knn_equiv(d[:IVF_CHECK], i[:IVF_CHECK], pd, pi, rtol=1e-5, atol=1e-5)
    _, truth = BruteForce("sqeuclidean").build(x, res=res).search(q[:IVF_CHECK], K_MAIN)
    rec = recall(ri[:IVF_CHECK], truth)
    rec_pq = recall(i[:IVF_CHECK, :K_MAIN], truth)
    assert rec >= IVF_RECALL_FLOOR, f"recall@10 {rec} below {IVF_RECALL_FLOOR}"
    # the plain top-k route ("xla") answers as the routed one ("auto"); its
    # search time and device profile, in this same run, stand beside them
    sp_x = dataclasses.replace(sp, select_impl="xla")
    reset()
    xd, xi = ivf_pq.search(sp_x, index, q, IVF_K0, res=res)
    torch.cuda.synchronize()
    xla_launches = counts()            # the plain-select route: the unfused scan
    assert xla_launches["pq_scan"] == tiles and xla_launches["pq_scan_topk"] == 0, xla_launches
    xla_same = torch.equal(xi, i) and torch.equal(xd, d)
    assert xla_same, (f"select_impl='xla' and 'auto' differ on "
                      f"{int((xi != i).any(1).sum())} of {IVF_Q} rows")
    t0 = time.perf_counter()
    for _ in range(batches):
        ivf_pq.search(sp_x, index, q, IVF_K0, res=res)
    torch.cuda.synchronize()
    xla_s = (time.perf_counter() - t0) / batches
    # the unfused kernel route (pq_scan, bias, mask, topk, merge), as before
    # the fused kernel: the same answers, timed and profiled in this run
    fuses = ivf_pq._fuses_scan_and_select
    ivf_pq._fuses_scan_and_select = lambda *a: False
    try:
        reset()
        ud, ui = ivf_pq.search(sp, index, q, IVF_K0, res=res)
        torch.cuda.synchronize()
        unfused_launches = counts()
        t0 = time.perf_counter()
        for _ in range(batches):
            ivf_pq.search(sp, index, q, IVF_K0, res=res)
        torch.cuda.synchronize()
        unfused_s = (time.perf_counter() - t0) / batches
        profile_batch(st, "ivf_pq.search + refine, unfused scan and select",
                      "ivf_profile_unfused.txt",
                      lambda: refine(x, q, ivf_pq.search(sp, index, q, IVF_K0, res=res)[1],
                                     K_MAIN, res=res))
    finally:
        ivf_pq._fuses_scan_and_select = fuses
    assert unfused_launches["pq_scan"] == tiles and unfused_launches["topk"] == tiles, (
        unfused_launches)
    unfused_same = torch.equal(ui, i) and torch.equal(ud, d)
    assert unfused_same, (f"the fused and unfused routes differ on "
                          f"{int((ui != i).any(1).sum())} of {IVF_Q} rows")
    # the query tile (the JAX package's cap is 128), for the record
    tile_s = {}
    for qt in (128, 1024):
        ivf_pq._pq_search(index, q, 8, IVF_K0, qt, 8, "bfloat16", "kernel")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(batches):
            ivf_pq._pq_search(index, q, 8, IVF_K0, qt, 8, "bfloat16", "kernel")
        torch.cuda.synchronize()
        tile_s[qt] = (time.perf_counter() - t0) / batches
    emit(phase="query_tile", path="ivf_pq._pq_search", m=IVF_Q,
         seconds_per_batch={str(k): v for k, v in tile_s.items()},
         qps={str(k): IVF_Q / v for k, v in tile_s.items()}, default=128, card=st["card"])
    st["launches"]["pq_scan_topk"] = launches["pq_scan_topk"]
    st["launches"]["pq_scan"] = xla_launches["pq_scan"]
    emit(phase="main", path="ivf_pq.search + refine", n=N_MAIN, d=D_MAIN, m=IVF_Q,
         n_probes=8, lut_dtype="bfloat16", k0=IVF_K0, k=K_MAIN, batches=batches,
         qps_search=IVF_Q / search_s, qps_search_refine=IVF_Q / both_s,
         seconds_per_batch_search=search_s, seconds_per_batch_search_refine=both_s,
         peak_device_bytes=peak, peak_above_live_bytes=peak - live, launches=launches,
         pq_scan_topk_launches_per_batch=launches["pq_scan_topk"] / batches,
         topk_launches_per_batch=launches["topk"] / batches,
         select_xla_equals_auto=xla_same, qps_search_select_xla=IVF_Q / xla_s,
         launches_select_xla=xla_launches, unfused_equals_fused=unfused_same,
         qps_search_unfused=IVF_Q / unfused_s, launches_unfused=unfused_launches,
         onehot_check_rows=IVF_CHECK, max_abs_err=err, recall_at_10=rec,
         recall_at_10_before_refine=rec_pq, recall_floor=IVF_RECALL_FLOOR,
         card=st["card"])
    profile_batch(st, "ivf_pq.search + refine", "ivf_profile.txt",
                  lambda: refine(x, q, ivf_pq.search(sp, index, q, IVF_K0, res=res)[1],
                                 K_MAIN, res=res))
    profile_batch(st, "ivf_pq.search + refine, select_impl xla", "ivf_profile_select_xla.txt",
                  lambda: refine(x, q, ivf_pq.search(sp_x, index, q, IVF_K0, res=res)[1],
                                 K_MAIN, res=res))
    # this slice's paths on the same index and data, each with its own counts
    phase_ivf_filter(st, index, q, sp, (d, i))
    phase_ivf_grouped(st, index, q, sp, (d, i))
    phase_ivf_bytes(st, x, q, IVF_CHECK)
    phase_ivf_codecs(st, x, q, truth)
    st["ivf"] = (index, q)
    st["ivf_centers"] = centers
    st["ivf_x"], st["ivf_truth"] = x, truth


def pq_counts():
    from raft_tpu_torch.ops.pq_scan import pq_scan, pq_scan_topk
    from raft_tpu_torch.ops.topk import topk

    return {"topk": topk.launches, "pq_scan": pq_scan.launches,
            "pq_scan_topk": pq_scan_topk.launches}


def pq_reset():
    from raft_tpu_torch.ops.pq_scan import pq_scan, pq_scan_topk
    from raft_tpu_torch.ops.topk import topk

    topk.launches = pq_scan.launches = pq_scan_topk.launches = 0


def timed_batches(fn, batches):
    """Host seconds per call of ``fn`` over ``batches`` calls, after a
    synchronise; and the last call's result."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(batches):
        out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / batches, out


def phase_ivf_filter(st, index, q, sp, unfiltered):
    """Filtered IVF-PQ on the main index: bitsets keeping 50% and 2% of the
    ids (seeded). Each filtered batch must launch ``pq_scan_topk`` once a
    tile and ``topk`` never; the kernel equals ``pq_scan_topk_plain`` with
    the same bitset bit for bit on two of its tiles; every returned id is
    kept and -1 stands exactly where a distance is +inf; the plain-select
    route (``pq_scan``, the filter, the plain top-k) gives the same answers;
    an all-ones bitset gives the unfiltered answer exactly."""
    import dataclasses

    import torch

    from raft_tpu_torch.core import Resources
    from raft_tpu_torch.distance.pairwise import full_f32
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.ops.pq_scan import pack_keep_words, pq_scan_topk, pq_scan_topk_plain

    res = Resources(device="cuda")
    dev = q.device
    d0, i0 = unfiltered
    tiles, batches = -(-IVF_Q // 128), 3
    ones = torch.ones(N_MAIN, dtype=torch.bool, device=dev)
    od, oi = ivf_pq.search(sp, index, q, IVF_K0, sample_filter=ones, res=res)
    assert torch.equal(od, d0) and torch.equal(oi, i0), "an all-ones filter changes the answer"
    base_s, _ = timed_batches(lambda: ivf_pq.search(sp, index, q, IVF_K0, res=res), batches)
    prof = {"unfiltered": profile_batch(st, "ivf_pq.search (no refine)",
                                        "ivf_profile_search.txt",
                                        lambda: ivf_pq.search(sp, index, q, IVF_K0, res=res))}
    out = {}
    for frac in FILTER_KEEP:
        g = torch.Generator(device=dev).manual_seed(30)
        keep = torch.rand(N_MAIN, generator=g, device=dev) < frac
        ivf_pq.search(sp, index, q, IVF_K0, sample_filter=keep, res=res)      # warm-up
        pq_reset()
        search_s, (d, i) = timed_batches(
            lambda: ivf_pq.search(sp, index, q, IVF_K0, sample_filter=keep, res=res), batches)
        launches = pq_counts()
        assert launches["pq_scan_topk"] == tiles * batches, (
            f"a filtered batch launched pq_scan_topk {launches['pq_scan_topk']} times")
        assert launches["topk"] == 0 and launches["pq_scan"] == 0, launches
        assert bool(keep[i[i >= 0].long()].all()), "a filtered id came back"
        assert torch.equal(i < 0, torch.isinf(d)), "-1 ids and +inf distances disagree"
        words = pack_keep_words(keep)
        tile_bits = []
        for t0 in (0, 128 * 40):
            qt = q[t0:t0 + 128]
            probes = ivf_pq._coarse_probes(index, qt, 8).to(torch.int64)
            with full_f32():
                qrot = qt @ index.rotation.T
            lut, bias = ivf_pq._probe_luts(index, qrot, probes, *ivf_pq._codebooks_f32(index))
            args = (index.list_codes, index.list_ids, probes.to(torch.int32).contiguous(),
                    lut.to(torch.bfloat16).contiguous(), bias.contiguous(), IVF_K0, True)
            before = pq_scan_topk.launches
            kv, ki = pq_scan_topk(*args, keep_words=words)
            pv, pi = pq_scan_topk_plain(*args, keep_words=words)
            pq_scan_topk.launches = before
            same = torch.equal(kv.view(torch.int32), pv.view(torch.int32)) and torch.equal(ki, pi)
            assert same, f"pq_scan_topk and its plain version differ at tile {t0 // 128}"
            tile_bits.append(same)
        xd, xi = ivf_pq.search(dataclasses.replace(sp, select_impl="xla"), index, q, IVF_K0,
                               sample_filter=keep, res=res)
        xla_same = torch.equal(xd, d) and torch.equal(xi, i)
        assert xla_same, (f"the filtered search differs between select routes on "
                          f"{int((xi != i).any(1).sum())} rows")
        prof[str(frac)] = profile_batch(
            st, f"ivf_pq.search, filter keeping {frac:.0%}",
            f"ivf_profile_filtered_{int(frac * 100)}.txt",
            lambda: ivf_pq.search(sp, index, q, IVF_K0, sample_filter=keep, res=res))
        underfilled = int((i < 0).any(1).sum())
        out[str(frac)] = dict(qps=IVF_Q / search_s, seconds_per_batch=search_s,
                              launches=launches, kept_ids_only=True,
                              kernel_tiles_bit_equal_plain=tile_bits, select_xla_equal=xla_same,
                              rows_underfilled=underfilled,
                              device_busy_ms=prof[str(frac)]["device_busy_ms"])
        st["launches"][f"pq_scan_topk_filtered_{frac}"] = launches["pq_scan_topk"]
        if frac == 0.5:
            st["ivf_keep"] = keep
    emit(phase="main", path="ivf_pq.search with a sample filter", n=N_MAIN, d=D_MAIN, m=IVF_Q,
         n_probes=8, lut_dtype="bfloat16", k=IVF_K0, batches=batches, keep_shares=FILTER_KEEP,
         unfiltered=dict(qps=IVF_Q / base_s, seconds_per_batch=base_s,
                         device_busy_ms=prof["unfiltered"]["device_busy_ms"]),
         filtered=out, all_ones_equals_unfiltered=True, card=st["card"])


def phase_ivf_grouped(st, index, q, sp, unfiltered):
    """``scan_order="grouped"`` on the main index against the tiled order:
    ids equal except on rows whose distances tie within 1e-5 (printed as
    ``route_row`` lines)."""
    import dataclasses

    import torch

    from raft_tpu_torch.core import Resources
    from raft_tpu_torch.neighbors import ivf_pq

    res = Resources(device="cuda")
    d0, i0 = unfiltered
    spg = dataclasses.replace(sp, scan_order="grouped")
    pq_reset()
    gd, gi = ivf_pq.search(spg, index, q, IVF_K0, res=res)
    torch.cuda.synchronize()
    launches = pq_counts()
    grouped_s, _ = timed_batches(lambda: ivf_pq.search(spg, index, q, IVF_K0, res=res), 1)
    differ = (torch.sort(gi, 1).values != torch.sort(i0, 1).values).any(1)
    rows = torch.nonzero(differ)[:, 0].tolist()
    ties_ok = True
    for r in rows:
        ok = bool(torch.allclose(torch.sort(gd[r]).values, torch.sort(d0[r]).values,
                                 rtol=1e-5, atol=1e-5))
        ties_ok &= ok
        if len(rows) <= 50:
            emit(phase="route_row", path="ivf_pq grouped vs tiled", row=r,
                 grouped_dists=gd[r].tolist(), tiled_dists=d0[r].tolist(), tie_within_1e5=ok)
    fin = torch.isfinite(d0)
    err = float((gd[fin] - d0[fin]).abs().max())
    emit(phase="main", path="ivf_pq.search, scan_order grouped", n=N_MAIN, m=IVF_Q, k=IVF_K0,
         group_size=spg.group_size, qps=IVF_Q / grouped_s, launches=launches,
         rows_differing=len(rows), max_abs_err=err, card=st["card"])
    assert ties_ok, "the grouped order's ids differ from the tiled order's beyond ties"


def phase_ivf_bytes(st, x, q, truth_rows):
    """Byte IVF-PQ: the blob set as int8 and uint8 rows (``as_bytes``),
    built in the main configuration, searched (k=40) and refined to 10;
    recall@10 against the stored bytes' exact neighbours (``knn``, the s8
    kernel) with the float configuration's floor; the kernel and ``"xla"``
    select routes equal."""
    import dataclasses

    import torch

    from raft_tpu_torch.core import Resources
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.neighbors.brute_force import knn
    from raft_tpu_torch.neighbors.refine import refine

    res = Resources(device="cuda")
    sp = ivf_pq.SearchParams(n_probes=8, lut_dtype="bfloat16")
    tiles, batches = -(-IVF_Q // 128), 2
    for kind in ("int8", "uint8"):
        xb, qb = as_bytes(x, BYTE_SCALE, kind=kind), as_bytes(q, BYTE_SCALE, kind=kind)
        build_s, index = timed_batches(lambda: ivf_pq.build(
            ivf_pq.IndexParams(n_lists=1024, pq_bits=4, pq_dim=64, seed=0), xb, res=res), 1)
        assert index.data_kind == kind and index.size == N_MAIN
        ivf_pq.search(sp, index, qb, IVF_K0, res=res)
        pq_reset()
        search_s, (d, i) = timed_batches(lambda: ivf_pq.search(sp, index, qb, IVF_K0, res=res),
                                         batches)
        launches = pq_counts()
        assert launches["pq_scan_topk"] == tiles * batches and launches["topk"] == 0, launches
        xd, xi = ivf_pq.search(dataclasses.replace(sp, select_impl="xla"), index, qb, IVF_K0,
                               res=res)
        xla_same = torch.equal(xd, d) and torch.equal(xi, i)
        assert xla_same, f"{kind}: the select routes differ"
        _, ri = refine(xb, qb, i, K_MAIN, res=res)
        _, truth = knn(xb, qb[:truth_rows], K_MAIN, res=res)
        rec = recall(ri[:truth_rows], truth)
        emit(phase="main", path=f"ivf_pq {kind} build + search + refine", n=N_MAIN, d=D_MAIN,
             m=IVF_Q, k0=IVF_K0, k=K_MAIN, scale=BYTE_SCALE, build_seconds=build_s,
             qps_search=IVF_Q / search_s, launches=launches, select_xla_equal=xla_same,
             recall_at_10_vs_stored_bytes=rec, recall_floor=IVF_RECALL_FLOOR,
             check_rows=truth_rows, card=st["card"])
        assert rec >= IVF_RECALL_FLOOR, f"{kind}: recall@10 {rec} below {IVF_RECALL_FLOOR}"
        del index, xb, qb


# name -> IndexParams fields beyond the main configuration's
PQ_CODECS = {
    "per_cluster": dict(codebook_kind="per_cluster"),
    "residual_scale_norm": dict(residual_scale_norm=True),
    "opq_anisotropic_4bit": dict(rotation="opq", codebook_loss="anisotropic", fast_scan="4bit"),
}


def codec_tile_check(index, q):
    """One 128-query tile of a codec index through its scan kernel's wrapper
    and the plain version, on the same card inputs, bit for bit: the
    funnel's signature scan (``pq_scan`` over ``list_sig`` with the nibble
    LUT of ``_sig_nibble_lut``, split, S = the signature words) against
    ``pq_scan_plain``; otherwise ``pq_scan_topk`` with the index's own LUTs
    (per-cluster codebooks, per-list scales) against
    ``pq_scan_topk_plain``. The launch is taken back out of the count."""
    import torch

    from raft_tpu_torch.distance.pairwise import full_f32
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.ops.pq_scan import pq_scan, pq_scan_plain, pq_scan_topk, pq_scan_topk_plain

    qt = q[:128]
    probes = ivf_pq._coarse_probes(index, qt, 8).to(torch.int64)
    with full_f32():
        qrot = qt @ index.rotation.T
    if index.has_fast_scan:
        t, p = probes.shape
        sig_w = index.list_sig.shape[2]
        r = qrot[:, None, :] - index.centers_rot[probes]
        slut = ivf_pq._sig_nibble_lut(r, index.fast_scan, sig_w)
        args = (index.list_sig, probes.reshape(-1).to(torch.int32).contiguous(),
                slut.reshape(t * p, sig_w, 32).to(torch.bfloat16).contiguous())
        before = pq_scan.launches
        got = pq_scan(*args, split=True)
        pq_scan.launches = before
        want = pq_scan_plain(*args, split=True)
        same = torch.equal(got.view(torch.int32), want.view(torch.int32))
        return "pq_scan", sig_w, same
    lut, bias = ivf_pq._probe_luts(index, qrot, probes, *ivf_pq._codebooks_f32(index))
    args = (index.list_codes, index.list_ids, probes.to(torch.int32).contiguous(),
            lut.to(torch.bfloat16).contiguous(), bias.contiguous(), IVF_K0, True)
    before = pq_scan_topk.launches
    kv, ki = pq_scan_topk(*args, split=index.pq_split)
    pq_scan_topk.launches = before
    pv, pi = pq_scan_topk_plain(*args, index.pq_split)
    same = torch.equal(kv.view(torch.int32), pv.view(torch.int32)) and torch.equal(ki, pi)
    return "pq_scan_topk", index.pq_dim, same


def phase_ivf_codecs(st, x, q, truth):
    """Per-cluster, scale-normed and codec (OPQ, anisotropic, 4-bit
    fast-scan, searched through the funnel at ``funnel_widen=4``) builds of
    the main configuration: build seconds, QPS and recall@10 after refine,
    held to the main configuration's floor; one tile's kernel against its
    plain version bit for bit (``codec_tile_check``); each batch's launches
    exactly (per-cluster and scale-normed: ``pq_scan_topk`` once a tile, no
    ``topk`` or ``pq_scan``; the funnel: ``pq_scan`` and ``topk`` once a
    tile each, no ``pq_scan_topk``); the kernel and ``"xla"`` select routes
    equal."""
    import dataclasses

    import torch

    from raft_tpu_torch.core import Resources
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.neighbors.refine import refine

    res = Resources(device="cuda")
    tiles, batches = -(-IVF_Q // 128), 2
    for name, kw in PQ_CODECS.items():
        build_s, index = timed_batches(lambda: ivf_pq.build(
            ivf_pq.IndexParams(n_lists=1024, pq_bits=4, pq_dim=64, seed=0, **kw), x, res=res), 1)
        widen = 4 if index.has_fast_scan else 1
        sp = ivf_pq.SearchParams(n_probes=8, lut_dtype="bfloat16", funnel_widen=widen)
        kernel, s_words, tile_same = codec_tile_check(index, q)
        assert tile_same, f"{name}: {kernel} differs from its plain version on a tile"
        ivf_pq.search(sp, index, q, IVF_K0, res=res)
        pq_reset()
        search_s, (d, i) = timed_batches(lambda: ivf_pq.search(sp, index, q, IVF_K0, res=res),
                                         batches)
        launches = pq_counts()
        want = ({"topk": tiles * batches, "pq_scan": tiles * batches, "pq_scan_topk": 0}
                if index.has_fast_scan else
                {"topk": 0, "pq_scan": 0, "pq_scan_topk": tiles * batches})
        assert launches == want, f"{name}: launches {launches}, want {want}"
        xd, xi = ivf_pq.search(dataclasses.replace(sp, select_impl="xla"), index, q, IVF_K0,
                               res=res)
        xla_same = torch.equal(xd, d) and torch.equal(xi, i)
        _, ri = refine(x, q, i, K_MAIN, res=res)
        rec = recall(ri[:truth.shape[0]], truth)
        st["launches"][f"{kernel}_{name}"] = launches[kernel]
        emit(phase="main", path=f"ivf_pq {name} build + search + refine", n=N_MAIN, d=D_MAIN,
             m=IVF_Q, k0=IVF_K0, k=K_MAIN, codebook_kind=index.codebook_kind,
             rotation=index.rotation_kind, codebook_loss=index.codebook_loss,
             fast_scan=index.fast_scan, funnel_widen=widen, build_seconds=build_s,
             qps_search=IVF_Q / search_s, launches=launches, tile_kernel=kernel,
             tile_S=s_words, tile_bit_equal_plain=tile_same, select_xla_equal=xla_same,
             recall_at_10=rec, recall_floor=IVF_RECALL_FLOOR, card=st["card"])
        assert xla_same, f"{name}: the select routes differ"
        assert rec >= IVF_RECALL_FLOOR, f"{name}: recall@10 {rec} below {IVF_RECALL_FLOOR}"
        del index


def plain_hop_search(sp, index, q):
    """``cagra.search`` with every hop on ``cagra_hop_plain`` in place of the
    kernel: the same route, merge and tie rules, in plain PyTorch."""
    import raft_tpu_torch.ops.cagra_hop as hop_mod
    from raft_tpu_torch.core import Resources
    from raft_tpu_torch.neighbors import cagra

    kernel = hop_mod.cagra_hop
    hop_mod.cagra_hop = hop_mod.cagra_hop_plain
    try:
        return cagra.search(sp, index, q, K_MAIN, res=Resources(device="cuda"))
    finally:
        hop_mod.cagra_hop = kernel


def phase_cagra_bytes(st):
    """CAGRA's byte build: the clustered 1M set scaled into int8 as the
    IVF-Flat phase scales it, ``build(IndexParams())``, and
    ``search(itopk_size=32)`` running ``cagra_hop`` over int8 rows; recall@10
    against the stored bytes' exact neighbours (``knn``, the s8 kernel),
    floor 0.95. The routes, on 1,000 queries: the kernel route
    (``fused_arena``) equals the same route with its hops on
    ``cagra_hop_plain``, bit for bit; the extract-merge kernel route
    (``hop_impl="fused"``, lowest-id ties as ``"xla"``) holds the float
    phase's per-row rule against ``"xla"``; the arena route against ``"xla"``:
    ids overlap >= 0.99, equal distances where the id sets agree, recall no
    lower than the "xla" route's less 0.002, and its differing rows
    printed. int8 rows score exact integers, so ties are common; the arena
    merge keeps the incumbent on a tie with its worst entry (the JAX
    kernel's rule, raft_tpu/ops/cagra_hop.py:150-192), where extract and
    "xla" take the lower id, and a beam can part there."""
    import dataclasses

    import torch

    from raft_tpu_torch.core import Resources
    from raft_tpu_torch.neighbors import cagra
    from raft_tpu_torch.neighbors.brute_force import knn
    from raft_tpu_torch.ops.cagra_hop import cagra_hop

    res = Resources(device="cuda")
    x, q, _, _ = cagra_data()
    x8, q8 = as_bytes(x, 12.7, -64.0), as_bytes(q, 12.7, -64.0)
    del x, q
    build_s, index = timed_batches(lambda: cagra.build(cagra.IndexParams(), x8, res=res), 1)
    g = index.graph
    assert index.dataset.dtype == torch.int8 and index.data_kind == "int8"
    assert int(g.min()) >= 0 and int(g.max()) < N_MAIN, "graph ids out of range"
    sp = cagra.SearchParams(itopk_size=CAGRA_ITOPK)
    assert cagra.resolve_hop_impl(sp, index.graph_degree, index.dim) == "fused_arena"
    cagra.search(sp, index, q8, K_MAIN, res=res)
    cagra_hop.launches = 0
    search_s, (d, i) = timed_batches(lambda: cagra.search(sp, index, q8, K_MAIN, res=res), 2)
    hops = cagra_hop.launches
    assert hops > 0, "the byte CAGRA search did not launch cagra_hop"
    qc = q8[:CAGRA_CHECK]
    _, truth = knn(x8, qc, K_MAIN, res=res)
    rec = recall(i[:CAGRA_CHECK], truth)
    kd, ki = cagra.search(sp, index, qc, K_MAIN, res=res)
    pd, pi = plain_hop_search(sp, index, qc)
    plain_same = torch.equal(kd.view(torch.int32), pd.view(torch.int32)) and torch.equal(ki, pi)
    ed, ei = cagra.search(dataclasses.replace(sp, hop_impl="fused"), index, qc, K_MAIN, res=res)
    xd, xi = cagra.search(dataclasses.replace(sp, hop_impl="xla"), index, qc, K_MAIN, res=res)

    def versus_xla(rd, ri):
        """Rows whose id sets differ from the "xla" route's, whether the
        agreeing rows' distances are equal, and whether each differing row's
        k-th distance is no worse than the "xla" route's (the float phase's
        rule)."""
        same = (torch.sort(ri, 1).values == torch.sort(xi, 1).values).all(1)
        equal = torch.equal(torch.sort(rd[same], 1).values, torch.sort(xd[same], 1).values)
        kth = torch.sort(rd[~same], 1).values[:, -1]
        kth_x = torch.sort(xd[~same], 1).values[:, -1]
        return same, equal, bool((kth <= kth_x * (1 + 1e-4) + 3e-3).all())

    e_same, e_equal, e_kth = versus_xla(ed, ei)
    same, route_ok, kth_ok = versus_xla(kd, ki)
    overlap = recall(ki, xi)
    rec_k, rec_x = recall(ki, truth), recall(xi, truth)
    for r in torch.nonzero(~same)[:, 0].tolist():
        emit(phase="route_row", path="cagra int8", row=r,
             kernel_dists=torch.sort(kd[r]).values.tolist(),
             xla_dists=torch.sort(xd[r]).values.tolist(),
             extract_dists=torch.sort(ed[r]).values.tolist(),
             kernel_recall=recall(ki[r:r + 1], truth[r:r + 1]),
             xla_recall=recall(xi[r:r + 1], truth[r:r + 1]))
    st["launches"]["cagra_hop_int8"] = hops
    emit(phase="main", path="cagra int8 build + search", n=N_MAIN, d=D_MAIN, m=CAGRA_Q,
         k=K_MAIN, itopk=CAGRA_ITOPK, build_seconds=build_s, qps=CAGRA_Q / search_s,
         cagra_hop_launches=hops, recall_at_10_vs_stored_bytes=rec,
         recall_floor=CAGRA_RECALL_FLOOR, check_rows=CAGRA_CHECK,
         arena_kernel_bit_equal_plain_hops=plain_same,
         extract_vs_xla=dict(rows_differing=int((~e_same).sum()), equal_where_same=e_equal,
                             kth_no_worse=e_kth),
         arena_vs_xla=dict(overlap=overlap, rows_differing=int((~same).sum()),
                           equal_where_same=route_ok, kth_no_worse=kth_ok),
         kernel_route_recall_at_10=rec_k, xla_route_recall_at_10=rec_x,
         seed_pool_hint=index.seed_pool_hint, card=st["card"])
    assert rec >= CAGRA_RECALL_FLOOR, f"int8 CAGRA recall@10 {rec} below {CAGRA_RECALL_FLOOR}"
    assert plain_same, "the int8 kernel route differs from its plain hops"
    assert e_equal and e_kth, "the int8 extract route breaks the per-row rule against xla"
    assert overlap >= 0.99, f"the int8 kernel route overlaps the xla route at {overlap}"
    assert route_ok, "int8 distances differ between the hop routes on rows of equal ids"
    assert rec_k >= rec_x - 0.002, f"int8 kernel route recall {rec_k} below the xla route's {rec_x}"


def phase_ball_cover(st):
    """Random ball cover at RAPIDS' documented home (low-dimensional and
    geospatial data): 1,000,000 x 3 uniform float32 under sqeuclidean and
    1,000,000 (lat, lon) points in radians under haversine, 10,000 queries
    each, k=10, held against exact ``knn`` in the same metric (sorted
    distances within rtol 1e-4, ids equal except where distances tie)."""
    import math

    import torch

    from raft_tpu_torch.core import Resources
    from raft_tpu_torch.neighbors import ball_cover
    from raft_tpu_torch.neighbors.brute_force import knn
    from raft_tpu_torch.ops.topk import topk

    res = Resources(device="cuda")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(40)

    def points(n, metric):
        if metric == "haversine":
            lat = torch.asin(2.0 * torch.rand(n, generator=g, device=dev) - 1.0)
            lon = (2.0 * torch.rand(n, generator=g, device=dev) - 1.0) * math.pi
            return torch.stack([lat, lon], 1)
        return torch.rand((n, 3), generator=g, device=dev)

    for metric in ("sqeuclidean", "haversine"):
        x, q = points(N_MAIN, metric), points(M_MAIN, metric)
        build_s, index = timed_batches(lambda: ball_cover.build(x, metric=metric, res=res), 1)
        ball_cover.knn_query(index, q[:100], K_MAIN, res=res)
        topk.launches = 0
        search_s, (d, i) = timed_batches(lambda: ball_cover.knn_query(index, q, K_MAIN, res=res),
                                         1)
        launches = topk.launches
        rd, ri = knn(x, q, K_MAIN, metric=metric, res=res)
        err = knn_equiv(d, i, rd, ri, rtol=1e-4, atol=1e-6)
        emit(phase="main", path=f"ball_cover.knn_query {metric}", n=N_MAIN, d=x.shape[1],
             m=M_MAIN, k=K_MAIN, n_landmarks=index.n_landmarks, capacity=index.capacity,
             build_seconds=build_s, qps=M_MAIN / search_s, topk_launches=launches,
             max_abs_err_vs_exact=err, card=st["card"])
        st["launches"][f"topk_ball_cover_{metric}"] = launches
        del index, x, q


def phase_matrix_ops(st):
    """The 16 ``matrix.ops`` functions on the card against the CPU."""
    import torch

    from raft_tpu_torch.matrix import ops

    g = torch.Generator().manual_seed(41)
    m = torch.randn((1000, 777), generator=g)
    m[3, 5] = m[3, 9] = m[3].max() + 1.0
    m[7] = m[7].round()
    rows = torch.randint(0, 1000, (300,), generator=g)
    mask = torch.rand(300, generator=g) > 0.5
    vec = torch.randn(777, generator=g)
    calls = {
        "argmax": lambda a: ops.argmax(a), "argmin": lambda a: ops.argmin(a),
        "gather": lambda a: ops.gather(a, rows.to(a.device)),
        "gather_if": lambda a: ops.gather_if(a, rows.to(a.device), mask.to(a.device), -1.0),
        "slice": lambda a: ops.slice(a, 10, 500, 3, 700), "copy": lambda a: ops.copy(a),
        "fill": lambda a: ops.fill((5, 7), 2.5, device=a.device),
        "eye": lambda a: ops.eye(9, device=a.device),
        "linewise_op": lambda a: ops.linewise_op(a, vec.to(a.device), True,
                                                 lambda u, v: u * v + 1.0),
        "col_wise_sort": lambda a: ops.col_wise_sort(a, ascending=False),
        "reverse": lambda a: ops.reverse(a, along_rows=False),
        "sign_flip": lambda a: ops.sign_flip(a),
        "upper_triangular": lambda a: ops.upper_triangular(a),
        "lower_triangular": lambda a: ops.lower_triangular(a),
        "get_diagonal": lambda a: ops.get_diagonal(a),
        "set_diagonal": lambda a: ops.set_diagonal(a, vec.to(a.device)),
    }
    assert set(calls) == set(ops.__all__)
    for name, fn in calls.items():
        card, cpu = fn(m.cuda()), fn(m)
        for a, b in zip(card if isinstance(card, tuple) else (card,),
                        cpu if isinstance(cpu, tuple) else (cpu,)):
            assert a.device.type == "cuda" and torch.equal(a.cpu(), b), name
    emit(phase="check", what="matrix.ops card vs cpu", functions=len(calls), equal=True,
         shape=list(m.shape), card=st["card"])


def profile_batch(st, path, filename, batch, what="10,000-query batch"):
    """Device time by kernel over one call of ``batch`` (torch.profiler),
    and the device's idle share of the batch's host time. The whole table
    goes to ``filename`` in the ``--out`` directory."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        batch()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((us / 1e3, e.count, e.key, str(e.device_type).endswith("CUDA")))
    if any(r[3] for r in rows):
        rows = [r for r in rows if r[3]]       # kernels only: ops would count twice
    rows = sorted((r[:3] for r in rows), reverse=True)
    busy_ms = sum(r[0] for r in rows)
    os.makedirs(st["out"], exist_ok=True)
    with open(os.path.join(st["out"], filename), "w") as f:
        f.write(f"# {st['card']}; one {what} of {path}; "
                f"host {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms\n")
        for ms, n, key in rows:
            f.write(f"{ms:12.3f} ms {n:8d}  {key}\n")
    rec = dict(phase="profile", path=path, wall_ms=wall_ms,
               device_busy_ms=busy_ms, device_ops=sum(r[1] for r in rows),
               idle_share=1.0 - busy_ms / wall_ms,
               top=[dict(ms=ms, count=n, kernel=key[:100]) for ms, n, key in rows[:15]],
               card=st["card"])
    emit(**rec)
    return rec


def phase_cagra(st):
    """CAGRA build and search at 1M x 128 in the JAX package's
    ``cagra_1m_itopk32`` configuration: ``IndexParams()`` (every default),
    ``SearchParams(itopk_size=32)``, k=10, 10,000-query batches."""
    import dataclasses
    import logging
    import re

    import torch

    from raft_tpu_torch.core import Resources
    from raft_tpu_torch.neighbors import cagra, ivf_pq
    from raft_tpu_torch.neighbors.brute_force import BruteForce
    from raft_tpu_torch.ops.cagra_hop import cagra_hop
    from raft_tpu_torch.ops.fused_knn import fused_knn
    from raft_tpu_torch.ops.pq_scan import pq_scan, pq_scan_topk
    from raft_tpu_torch.ops.topk import topk

    def counts():
        return {"fused_knn": fused_knn.launches, "topk": topk.launches,
                "pq_scan": pq_scan.launches, "pq_scan_topk": pq_scan_topk.launches,
                "cagra_hop": cagra_hop.launches}

    def reset():
        fused_knn.launches = topk.launches = pq_scan.launches = 0
        pq_scan_topk.launches = cagra_hop.launches = 0

    res = Resources(device="cuda")
    dev = torch.device("cuda")
    x, q, _, _ = cagra_data()
    notes = []
    handler = logging.Handler()
    handler.emit = lambda record: notes.append(record.getMessage())
    log = logging.getLogger("raft_tpu_torch")
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    params = cagra.IndexParams()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    live = torch.cuda.memory_allocated()
    reset()
    t0 = time.perf_counter()
    index = cagra.build(params, x, res=res)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    st["cagra_build_s"] = build_s
    build_launches = counts()
    build_peak = torch.cuda.max_memory_allocated() - live
    log.removeHandler(handler)
    tuned = [m for m in notes if "build_n_probes auto" in m]
    probes = int(re.search(r"using (\d+) probes", tuned[0]).group(1)) if (
        tuned and "using" in tuned[0]) else 32
    g = index.graph
    n_self = int((g == torch.arange(N_MAIN, device=dev, dtype=torch.int32)[:, None]).sum())
    assert g.shape == (N_MAIN, params.graph_degree) and g.dtype == torch.int32
    assert int(g.min()) >= 0 and int(g.max()) < N_MAIN, "graph ids out of range"
    assert n_self == 0, f"{n_self} self-edges"
    k, gpu_top_k, n_lists, pq_bits = cagra.knn_build_plan(params, N_MAIN, D_MAIN)
    assert build_launches["pq_scan_topk"] > 0, "the CAGRA build did not launch pq_scan_topk"
    emit(phase="cagra_build", n=N_MAIN, d=D_MAIN, centers=CAGRA_CENTERS,
         build_seconds=build_s, n_lists=n_lists, pq_bits=pq_bits,
         pq_dim=ivf_pq._default_pq_dim(D_MAIN, pq_bits), self_search_k=gpu_top_k + 1, refine_k=k + 1,
         probes_after_chunk_0=probes, autotune_note=tuned, seed_pool_hint=index.seed_pool_hint,
         graph_shape=list(g.shape), self_edges=n_self, graph_ids_in_range=True,
         launches=build_launches, peak_above_live_bytes=build_peak, card=st["card"])

    sp = cagra.SearchParams(itopk_size=CAGRA_ITOPK)
    impl = cagra.resolve_hop_impl(sp, index.graph_degree, index.dim)
    assert impl == "fused_arena", impl
    cagra.search(sp, index, q, K_MAIN, res=res)              # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    live = torch.cuda.memory_allocated()
    batches = 3
    reset()
    t0 = time.perf_counter()
    for _ in range(batches):
        d, i = cagra.search(sp, index, q, K_MAIN, res=res)
    torch.cuda.synchronize()
    search_s = (time.perf_counter() - t0) / batches
    launches = counts()
    assert launches["cagra_hop"] > 0, "the CAGRA search did not launch cagra_hop"
    peak = torch.cuda.max_memory_allocated()
    assert d.shape == (CAGRA_Q, K_MAIN) and i.shape == (CAGRA_Q, K_MAIN)
    assert bool(torch.isfinite(d).all()) and bool((i >= 0).all()) and bool((i < N_MAIN).all())

    qc = q[:CAGRA_CHECK]
    _, truth = BruteForce("sqeuclidean").build(x, res=res).search(qc, K_MAIN)
    rec = recall(i[:CAGRA_CHECK], truth)
    # the kernel route against the "xla" route: ids overlap >= 0.99; where a
    # row's id set agrees, its sorted distances agree within rtol 1e-4. The
    # routes score in different forms (direct against expanded, ~3e-3 apart
    # at distances ~64), so a near-tie can swap an id: on such a row the
    # kernel route's k-th distance is no worse than the "xla" route's
    # (1 + 1e-4) plus 3e-3, and both rows' distances are printed.
    kd, ki = cagra.search(sp, index, qc, K_MAIN, res=res)
    xd, xi = cagra.search(dataclasses.replace(sp, hop_impl="xla"), index, qc, K_MAIN, res=res)
    overlap = recall(ki, xi)
    same = (torch.sort(ki, 1).values == torch.sort(xi, 1).values).all(1)
    ks, xs = torch.sort(kd[same], 1).values, torch.sort(xd[same], 1).values
    route_err = float((ks - xs).abs().max()) if bool(same.any()) else 0.0
    route_ok = bool(torch.allclose(ks, xs, rtol=1e-4, atol=1e-4))
    kth_k = torch.sort(kd[~same], 1).values[:, -1]
    kth_x = torch.sort(xd[~same], 1).values[:, -1]
    kth_ok = bool((kth_k <= kth_x * (1 + 1e-4) + 3e-3).all())
    for r in torch.nonzero(~same)[:, 0].tolist():
        emit(phase="route_row", row=r, kernel_dists=torch.sort(kd[r]).values.tolist(),
             xla_dists=torch.sort(xd[r]).values.tolist(),
             kernel_recall=recall(ki[r:r + 1], truth[r:r + 1]),
             xla_recall=recall(xi[r:r + 1], truth[r:r + 1]))
    # the plain top-k route answers as the routed one: a threshold above
    # every row sends the entry pool's select to the plain route ("xla")
    sk = importlib.import_module("raft_tpu_torch.matrix.select_k")
    sk.set_wide_cols_threshold(1 << 30)
    try:
        pd, pi = cagra.search(sp, index, q, K_MAIN, res=res)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(batches):
            cagra.search(sp, index, q, K_MAIN, res=res)
        torch.cuda.synchronize()
        plain_s = (time.perf_counter() - t0) / batches
        profile_batch(st, "cagra.search, plain top-k", "cagra_profile_plain_topk.txt",
                      lambda: cagra.search(sp, index, q, K_MAIN, res=res))
    finally:
        sk.set_wide_cols_threshold(None)
    select_same = torch.equal(pi, i) and torch.equal(pd, d)
    st["launches"]["cagra_hop"] = launches["cagra_hop"]
    emit(phase="main", path="cagra.search", n=N_MAIN, d=D_MAIN, m=CAGRA_Q, k=K_MAIN,
         itopk=CAGRA_ITOPK, hop_impl=impl, batches=batches, qps=CAGRA_Q / search_s,
         seconds_per_batch=search_s, launches=launches,
         cagra_hop_launches_per_batch=launches["cagra_hop"] / batches,
         hops_per_batch=launches["cagra_hop"] / batches - 1,
         topk_launches_per_batch=launches["topk"] / batches,
         select_xla_equals_auto=select_same, qps_plain_topk=CAGRA_Q / plain_s,
         peak_device_bytes=peak, peak_above_live_bytes=peak - live,
         recall_at_10=rec, recall_floor=CAGRA_RECALL_FLOOR, check_rows=CAGRA_CHECK,
         xla_route_overlap=overlap, xla_route_recall_at_10=recall(xi, truth),
         xla_route_rows_differing=int((~same).sum()),
         xla_route_max_abs_err_same_rows=route_err, card=st["card"])
    assert rec >= CAGRA_RECALL_FLOOR, f"recall@10 {rec} below {CAGRA_RECALL_FLOOR}"
    assert overlap >= 0.99, f"kernel route overlaps the xla route at {overlap}"
    assert route_ok, f"kernel and xla route distances differ by {route_err}"
    assert kth_ok, "where the ids differ, the kernel route's k-th distance is worse"
    assert select_same, (f"the plain and routed entry-pool top-k differ on "
                         f"{int((pi != i).any(1).sum())} of {CAGRA_Q} rows")
    profile_batch(st, "cagra.search", "cagra_profile.txt",
                  lambda: cagra.search(sp, index, q, K_MAIN, res=res))
    st["cagra"] = (index, q)
    st["cagra_truth"] = truth


def phase_ivf_flat(st):
    """IVF-Flat build and search in the JAX package's ``ivf_flat_1m_p8`` row
    (bench.py:3221-3239): the CAGRA set, ``IndexParams(n_lists=1024,
    seed=0)``, ``SearchParams(n_probes=8)``, k=10, 10,000-query batches."""
    import math

    import torch

    from raft_tpu_torch.core import Resources
    from raft_tpu_torch.distance.pairwise import full_f32
    from raft_tpu_torch.matrix.select_k import set_wide_cols_threshold, wide_dispatch_ok
    from raft_tpu_torch.neighbors import ivf_flat
    from raft_tpu_torch.neighbors.brute_force import BruteForce
    from raft_tpu_torch.neighbors.sample_filter import BitsetFilter
    from raft_tpu_torch.ops.fused_knn import fused_knn
    from raft_tpu_torch.ops.topk import topk

    def reset():
        fused_knn.launches = topk.launches = 0

    def counts():
        return {"fused_knn": fused_knn.launches, "topk": topk.launches}

    def plain_route(fn):
        """``fn()`` with the wide-select threshold above every row: every
        select on the plain top-k route; no topk launch."""
        set_wide_cols_threshold(1 << 30)
        try:
            before = topk.launches
            out = fn()
            torch.cuda.synchronize()
            assert topk.launches == before, "the plain route launched topk"
            return out
        finally:
            set_wide_cols_threshold(None)

    def index_bytes(ix):
        return sum(t.numel() * t.element_size() for t in (
            ix.centers, ix.list_data, ix.list_ids, ix.list_norms, ix.list_sizes))

    res = Resources(device="cuda")
    dev = torch.device("cuda")
    x, q, _, _ = cagra_data()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = ivf_flat.build(ivf_flat.IndexParams(n_lists=IVF_FLAT_LISTS, seed=0), x, res=res)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    assert index.size == N_MAIN and index.list_data.dtype == torch.float32
    emit(phase="ivf_flat_build", n=N_MAIN, d=D_MAIN, n_lists_asked=IVF_FLAT_LISTS,
         n_lists=index.n_lists, capacity=index.capacity, build_seconds=build_s,
         index_bytes=index_bytes(index), card=st["card"])
    st["ivf_flat_build_s"] = build_s

    sp = ivf_flat.SearchParams(n_probes=IVF_FLAT_PROBES)
    ivf_flat.search(sp, index, q, K_MAIN, res=res)           # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    live = torch.cuda.memory_allocated()
    batches = 3
    reset()
    t0 = time.perf_counter()
    for _ in range(batches):
        d, i = ivf_flat.search(sp, index, q, K_MAIN, res=res)
    torch.cuda.synchronize()
    search_s = (time.perf_counter() - t0) / batches
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    assert d.shape == (CAGRA_Q, K_MAIN) and i.shape == (CAGRA_Q, K_MAIN)
    assert bool(torch.isfinite(d).all()) and bool((i >= 0).all()) and bool((i < N_MAIN).all())
    # (c) the topk launches the tile plan gives: one a (tile, chunk) select,
    # one for the coarse select and one a tile's merge where those are wide
    qt, pc = ivf_flat.search_plan(index, CAGRA_Q, IVF_FLAT_PROBES, K_MAIN, res)
    tiles, chunks = -(-CAGRA_Q // qt), IVF_FLAT_PROBES // pc
    chunk_wide = wide_dispatch_ok(pc * index.capacity, K_MAIN, torch.float32, dev)
    coarse_wide = wide_dispatch_ok(index.n_lists, IVF_FLAT_PROBES, torch.float32, dev)
    merge_wide = wide_dispatch_ok(chunks * K_MAIN, K_MAIN, torch.float32, dev)
    planned = tiles * chunks * chunk_wide + coarse_wide + tiles * merge_wide
    assert chunk_wide, "the IVF-Flat chunk select does not reach the topk kernel"
    assert launches["topk"] == planned * batches, (
        f"the IVF-Flat search launched topk {launches['topk'] / batches} times a batch, "
        f"not the plan's {planned}")
    assert launches["fused_knn"] == 0, launches

    # (a) recall@10 against exact ground truth (the fused_knn path)
    qc = q[:IVF_FLAT_CHECK]
    _, truth = BruteForce("sqeuclidean").build(x, res=res).search(qc, K_MAIN)
    rec = recall(i[:IVF_FLAT_CHECK], truth)
    # (b) the plain top-k route answers as the routed one
    pd, pi = plain_route(lambda: ivf_flat.search(sp, index, q, K_MAIN, res=res))
    routes_equal = torch.equal(pi, i) and torch.equal(pd, d)
    assert routes_equal, (f"the plain and topk routes differ on "
                          f"{int((pi != i).any(1).sum())} of {CAGRA_Q} rows")
    # (d) a filter that drops half the ids
    keep = torch.rand(N_MAIN, generator=torch.Generator(device=dev).manual_seed(30),
                      device=dev) < 0.5
    fd, fi = ivf_flat.search(sp, index, q, K_MAIN, sample_filter=BitsetFilter(keep), res=res)
    kept = fi[fi >= 0].long()
    assert bool(keep[kept].all()), "a filtered-out id came back"
    fpd, fpi = plain_route(lambda: ivf_flat.search(sp, index, q, K_MAIN,
                                                   sample_filter=BitsetFilter(keep), res=res))
    filter_equal = torch.equal(fpi, fi) and torch.equal(fpd, fd)
    assert filter_equal, "the filtered search differs between the select routes"
    underfilled = int((fi == -1).any(1).sum())
    assert bool(torch.isinf(fd[fi == -1]).all())
    profile_batch(st, "ivf_flat.search", "ivf_flat_profile.txt",
                  lambda: ivf_flat.search(sp, index, q, K_MAIN, res=res))
    # one chunk of the first tile: the gather of its probed lists and the
    # batched product, and the same gather at random probes of that shape
    probes = ivf_flat._coarse_probes(index, q[:qt], IVF_FLAT_PROBES).long()[:, :pc]
    rand = torch.randint(0, index.n_lists, tuple(probes.shape), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(31))
    block = index.list_data[probes].reshape(qt, pc * index.capacity, D_MAIN)
    with full_f32():
        prod_ms = cuda_ms(lambda: torch.bmm(block, q[:qt, :, None]), reps=20)
    chunk = dict(gather_ms=cuda_ms(lambda: index.list_data[probes], reps=20),
                 gather_random_probes_ms=cuda_ms(lambda: index.list_data[rand], reps=20),
                 product_ms=prod_ms, block_bytes=block.numel() * 4,
                 distinct_lists=int(torch.unique(probes).numel()))
    emit(phase="time", what="ivf_flat chunk", T=qt, pc=pc, cap=index.capacity,
         card=st["card"], **chunk)
    del block
    st["launches"]["topk_ivf_flat"] = launches["topk"]
    emit(phase="main", path="ivf_flat.search", n=N_MAIN, d=D_MAIN, m=CAGRA_Q, k=K_MAIN,
         n_probes=IVF_FLAT_PROBES, batches=batches, qps=CAGRA_Q / search_s,
         seconds_per_batch=search_s, query_tile=qt, probe_chunk=pc,
         chunk_select_cols=pc * index.capacity, launches=launches,
         topk_launches_per_batch=launches["topk"] / batches, planned_topk_per_batch=planned,
         fused_knn_launches=launches["fused_knn"], peak_device_bytes=peak,
         peak_above_live_bytes=peak - live, recall_at_10=rec,
         recall_floor=IVF_FLAT_RECALL_FLOOR, check_rows=IVF_FLAT_CHECK,
         plain_route_equal=routes_equal, filter_kept_share=float(keep.float().mean()),
         filter_routes_equal=filter_equal, filter_underfilled_rows=underfilled,
         chunk=chunk, card=st["card"])
    assert rec >= IVF_FLAT_RECALL_FLOOR, f"recall@10 {rec} below {IVF_FLAT_RECALL_FLOOR}"
    st["ivf_flat"] = (index, sp)
    del index, d, i, pd, pi, fd, fi, fpd, fpi

    # (e) bfloat16 lists
    t0 = time.perf_counter()
    bindex = ivf_flat.build(ivf_flat.IndexParams(n_lists=IVF_FLAT_LISTS, seed=0,
                                                 list_dtype="bfloat16"), x, res=res)
    torch.cuda.synchronize()
    b_build = time.perf_counter() - t0
    assert bindex.list_data.dtype == torch.bfloat16 and bindex.data_kind == "bfloat16"
    ivf_flat.search(sp, bindex, q, K_MAIN, res=res)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(batches):
        bd, bi = ivf_flat.search(sp, bindex, q, K_MAIN, res=res)
    torch.cuda.synchronize()
    b_search = (time.perf_counter() - t0) / batches
    # rounding the rows to bfloat16 moves their distances by about the gap
    # between the 10th and 11th neighbours of this set, so even an exact
    # search over the stored rows misses some of the float32 truth: the
    # floor holds the search to the exact neighbours of the rows it stores
    _, truth_b = BruteForce("sqeuclidean").build(x.bfloat16().float(), res=res).search(
        qc, K_MAIN)
    b_rec = recall(bi[:IVF_FLAT_CHECK], truth)
    b_rec_stored = recall(bi[:IVF_FLAT_CHECK], truth_b)
    emit(phase="main", path="ivf_flat.search, list_dtype bfloat16", n=N_MAIN, d=D_MAIN,
         m=CAGRA_Q, k=K_MAIN, n_probes=IVF_FLAT_PROBES, build_seconds=b_build,
         index_bytes=index_bytes(bindex), qps=CAGRA_Q / b_search, recall_at_10=b_rec,
         exact_recall_over_stored_rows=recall(truth_b, truth),
         recall_at_10_vs_stored_rows=b_rec_stored, recall_floor_vs_stored_rows=IVF_FLAT_BF16_FLOOR,
         card=st["card"])
    assert b_rec_stored >= IVF_FLAT_BF16_FLOOR, (
        f"bf16 recall@10 against the stored rows' neighbours {b_rec_stored} below "
        f"{IVF_FLAT_BF16_FLOOR}")
    del bindex, bd, bi

    # (f) int8 lists: the set scaled and rounded into int8; integer scores
    # are exact, so the two select routes agree exactly
    x8, q8 = as_bytes(x[:INT8_ROWS], 12.7, -64.0), as_bytes(q, 12.7, -64.0)
    iindex = ivf_flat.build(ivf_flat.IndexParams(n_lists=INT8_LISTS, seed=0), x8, res=res)
    assert iindex.data_kind == "int8" and iindex.list_data.dtype == torch.int8
    reset()
    idd, iid = ivf_flat.search(sp, iindex, q8, K_MAIN, res=res)
    torch.cuda.synchronize()
    i_launches = counts()
    ipd, ipi = plain_route(lambda: ivf_flat.search(sp, iindex, q8, K_MAIN, res=res))
    int8_equal = torch.equal(ipi, iid) and torch.equal(ipd, idd)
    assert int8_equal, "the int8 search differs between the select routes"
    assert bool((idd == idd.round()).all()), "int8 distances are not integers"
    emit(phase="main", path="ivf_flat.search, int8 lists", n=INT8_ROWS, d=D_MAIN, m=CAGRA_Q,
         k=K_MAIN, n_lists=iindex.n_lists, capacity=iindex.capacity,
         launches=i_launches, plain_route_equal=int8_equal, card=st["card"])
    del iindex, x8, q8


def expanded_bound(xn, yn, d=D_MAIN):
    """Error bound of the float32 expanded L2 form ‖x‖² + ‖y‖² − 2·x·y over d
    terms, d·2⁻²⁴·(‖x‖² + ‖y‖² + 2‖x‖‖y‖), from the squared norms ``xn`` and
    ``yn`` (float64, broadcast against each other)."""
    return d * 2.0 ** -24 * (xn + yn + 2.0 * (xn * yn).sqrt())


def _ref64(metric, xt, y, p):
    """The metric's formula in float64 over one row tile: xt (t, d), y (n, d)."""
    import torch

    def glog(v):
        return torch.where(v > 0, torch.log(torch.where(v > 0, v, 1.0)), 0.0)

    def cos(a, b):
        return 1.0 - (a @ b.T) / (a.norm(dim=1)[:, None] * b.norm(dim=1)[None, :])

    if metric == "inner_product":
        return xt @ y.T
    if metric == "cosine":
        return cos(xt, y)
    if metric == "correlation":
        return cos(xt - xt.mean(1, keepdim=True), y - y.mean(1, keepdim=True))
    if metric == "hellinger":
        return torch.sqrt(torch.clamp_min(1.0 - xt.sqrt() @ y.sqrt().T, 0.0))
    if metric == "russellrao":
        return (xt.shape[1] - xt @ y.T) / xt.shape[1]
    if metric == "kl_divergence":
        return 0.5 * ((xt * glog(xt)).sum(1)[:, None] - xt @ glog(y).T)
    if metric in ("jaccard", "dice"):
        inter = xt @ y.T
        tot = xt.sum(1)[:, None] + y.sum(1)[None, :]
        den = tot - inter if metric == "jaccard" else tot
        num = inter if metric == "jaccard" else 2.0 * inter
        return torch.where(den > 0, 1.0 - num / torch.where(den > 0, den, 1.0), 0.0)
    a, b = xt[:, None, :], y[None, :, :]
    if metric == "haversine":
        s1 = torch.sin(0.5 * (b[..., 0] - a[..., 0]))
        s2 = torch.sin(0.5 * (b[..., 1] - a[..., 1]))
        h = s1 * s1 + torch.cos(a[..., 0]) * torch.cos(b[..., 0]) * s2 * s2
        return 2.0 * torch.asin(torch.sqrt(torch.clamp(h, 0.0, 1.0))), h
    diff = a - b
    if metric in ("sqeuclidean", "euclidean", "l2_expanded", "l2_sqrt_expanded"):
        d2 = (diff * diff).sum(-1)
        return d2 if metric in ("sqeuclidean", "l2_expanded") else d2.sqrt()
    if metric == "l1":
        return diff.abs().sum(-1)
    if metric == "chebyshev":
        return diff.abs().amax(-1)
    if metric == "canberra":
        den = a.abs() + b.abs()
        return torch.where(den > 0, diff.abs() / torch.where(den > 0, den, 1.0), 0.0).sum(-1)
    if metric == "minkowski":
        return diff.abs().pow(p).sum(-1).pow(1.0 / p)
    if metric == "braycurtis":
        den = (a + b).abs().sum(-1)
        return torch.where(den > 0, diff.abs().sum(-1) / torch.where(den > 0, den, 1.0), 0.0)
    if metric == "jensenshannon":
        logm = glog(0.5 * (a + b))
        acc = (-a * (logm - glog(a)) - b * (logm - glog(b))).sum(-1)
        return torch.sqrt(torch.clamp_min(0.5 * acc, 0.0))
    if metric == "hamming":
        return (a != b).double().mean(-1)
    raise ValueError(metric)


# metric -> (inputs, metric_arg, rtol): every pairwise metric, at the rtol the
# CPU parity tests use (atol 1e-5 throughout)
PAIRWISE_METRICS = {
    "l2_expanded": ("uniform", 2.0, 1e-5), "l2_sqrt_expanded": ("uniform", 2.0, 1e-5),
    "sqeuclidean": ("uniform", 2.0, 1e-5), "euclidean": ("uniform", 2.0, 1e-5),
    "cosine": ("uniform", 2.0, 1e-5), "inner_product": ("uniform", 2.0, 1e-5),
    "correlation": ("uniform", 2.0, 1e-5), "hellinger": ("simplex", 2.0, 1e-5),
    "russellrao": ("binary", 2.0, 1e-5), "kl_divergence": ("simplex", 2.0, 1e-4),
    "jaccard": ("binary", 2.0, 1e-5), "dice": ("binary", 2.0, 1e-5),
    "l1": ("uniform", 2.0, 1e-5), "chebyshev": ("uniform", 2.0, 1e-5),
    "canberra": ("uniform", 2.0, 1e-5), "minkowski": ("uniform", 3.0, 1e-5),
    "braycurtis": ("uniform", 2.0, 1e-5), "jensenshannon": ("simplex", 2.0, 1e-4),
    "hamming": ("binary", 2.0, 1e-5), "haversine": ("latlon", 2.0, 1e-5),
}


def phase_slice(st):
    """The rest of this slice on the card, each against float64 or the port's
    own plain route: every pairwise metric at 2,048 x 16,384 x 128 (haversine
    at d = 2); ``knn(metric="l1")`` over the 1M set on both select routes;
    ``masked_l2_nn`` and ``gram_matrix`` at 10,000 x 100,000 x 128;
    ``kmeans.fit`` at 100,000 x 128 from ``init="array"`` against the same
    call on the CPU; ``eps_neighbors_l2sq`` at 10,000 x 100,000."""
    import torch

    from raft_tpu_torch.cluster import kmeans
    from raft_tpu_torch.core import Resources
    from raft_tpu_torch.distance import (DistanceType, KernelParams, KernelType,
                                         gram_matrix, masked_l2_nn, pairwise_distance)
    from raft_tpu_torch.matrix.select_k import set_wide_cols_threshold
    from raft_tpu_torch.neighbors import eps_neighbors_l2sq
    from raft_tpu_torch.neighbors.brute_force import knn
    from raft_tpu_torch.ops.topk import topk

    res = Resources(device="cuda")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(40)
    m, n, d = PAIR_M, PAIR_N, D_MAIN
    names = {"l2_expanded": DistanceType.L2Expanded,
             "l2_sqrt_expanded": DistanceType.L2SqrtExpanded}

    def inputs(kind):
        if kind == "latlon":
            lat = (torch.rand((m + n,), generator=g, device=dev) - 0.5) * 3.14159
            lon = (torch.rand((m + n,), generator=g, device=dev) - 0.5) * 6.28318
            a = torch.stack([lat, lon], 1)
        else:
            a = torch.rand((m + n, d), generator=g, device=dev)
            a[torch.rand((m + n, d), generator=g, device=dev) < 0.1] = 0.0
            if kind == "binary":
                a = (a < 0.3).float()
            elif kind == "simplex":
                a[:, 0] += 1e-3
                a = a / a.sum(1, keepdim=True)
        return a[:m].contiguous(), a[m:].contiguous()

    worst = {}
    t_all = time.perf_counter()
    for name, (kind, arg, rtol) in PAIRWISE_METRICS.items():
        xm, ym = inputs(kind)
        got = pairwise_distance(xm, ym, names.get(name, name), metric_arg=arg, res=res)
        assert got.shape == (m, n) and got.dtype == torch.float32
        y64 = ym.double()
        err, rel = 0.0, 0.0
        for i in range(0, m, 128):
            ref = _ref64(name, xm[i:i + 128].double(), y64, arg)
            tol_extra = 0.0
            if name in ("l2_expanded", "l2_sqrt_expanded"):
                # the float32 expanded form ‖x‖² + ‖y‖² − 2·x·y: its error bound
                b = expanded_bound(xm[i:i + 128].double().square().sum(1)[:, None],
                                   y64.square().sum(1)[None, :])
                tol_extra = b if name == "l2_expanded" else torch.minimum(
                    b.sqrt(), b / ref.clamp_min(1e-30))
            if name == "haversine":
                # asin√h is ill-conditioned near antipodes: h's own float32
                # rounding (8 ulps) through the slope 1/√(h(1-h))
                ref, h = ref
                tol_extra = 8 * h * 2.0 ** -23 / torch.sqrt(torch.clamp_min(h * (1 - h), 1e-30))
            gi = got[i:i + 128].double()
            diff = (gi - ref).abs()
            ok = diff <= rtol * ref.abs() + 1e-5 + tol_extra
            assert bool(ok.all()), (f"pairwise {name} differs from float64: "
                                    f"{int((~ok).sum())} entries, max abs err {float(diff.max())}")
            err = max(err, float(diff.max()))
            rel = max(rel, float((diff / ref.abs().clamp_min(1e-6)).max()))
        worst[name] = (err, rel)
    emit(phase="check", what="pairwise_distance vs float64", m=m, n=n, d=d,
         metrics=len(PAIRWISE_METRICS), max_abs_err={k: v[0] for k, v in worst.items()},
         max_rel_err={k: v[1] for k, v in worst.items()},
         seconds=time.perf_counter() - t_all, ok=True, card=st["card"])

    # knn(metric="l1") over the 1M set: the topk kernel and the plain route
    x, q, _, _ = cagra_data()
    qk = q[:1000]
    before = topk.launches
    t0 = time.perf_counter()
    kd, ki = knn(x, qk, K_MAIN, metric="l1", res=res)
    torch.cuda.synchronize()
    k_s = time.perf_counter() - t0
    k_launches = topk.launches - before
    assert k_launches > 0, "knn(metric='l1') did not launch topk"
    set_wide_cols_threshold(1 << 30)
    try:
        pd, pi = knn(x, qk, K_MAIN, metric="l1", res=res)
        torch.cuda.synchronize()
    finally:
        set_wide_cols_threshold(None)
    l1_equal = torch.equal(pi, ki) and torch.equal(pd, kd)
    assert l1_equal, "knn(metric='l1') differs between the select routes"
    ref = (x[ki[:8].long()] - qk[:8, None]).abs().sum(-1)
    assert bool(torch.allclose(kd[:8], ref, rtol=1e-5)), "l1 distances are not the rows'"
    emit(phase="check", what="knn l1 on both select routes", n=N_MAIN, d=D_MAIN, m=1000,
         k=K_MAIN, seconds=k_s, topk_launches=k_launches, routes_equal=l1_equal, ok=True,
         card=st["card"])
    del x, q, kd, ki, pd, pi

    # masked_l2_nn and gram_matrix: 10,000 x 100,000 x 128 uniform rows
    xu, qu = st["main"]
    y = xu[:SLICE_N]
    y64 = y.double()
    yn64 = y64.square().sum(1)
    ends = torch.linspace(SLICE_N / 64, SLICE_N, 64, device=dev).round().long()
    group = torch.searchsorted(ends, torch.arange(SLICE_N, device=dev), right=True)
    adj = torch.rand((M_MAIN, 64), generator=g, device=dev) < 0.3
    adj[::97] = False
    ref2, refi, qn64 = [], [], []
    for i in range(0, M_MAIN, 1000):
        qb = qu[i:i + 1000].double()
        qn = qb.square().sum(1)
        d2 = (qn[:, None] + yn64[None, :] - 2.0 * qb @ y64.T).clamp_min(0.0)
        v, ix = torch.where(adj[i:i + 1000][:, group], d2, float("inf")).min(1)
        ref2.append(v)
        refi.append(torch.where(torch.isinf(v), -1, ix))
        qn64.append(qn)
    ref2, refi, qn64 = torch.cat(ref2), torch.cat(refi), torch.cat(qn64)
    none = torch.isinf(ref2)
    for sqrt in (False, True):
        md, mi = masked_l2_nn(qu, y, adj, ends.cpu().numpy(), sqrt=sqrt, res=res)
        torch.cuda.synchronize()
        assert torch.equal(mi[none].long(), refi[none]) and bool(torch.isinf(md[none]).all())
        # compared squared, within rtol 1e-5 plus the float32 expanded form's
        # error bound at the float64 pick
        got2 = md[~none].double() ** (2 if sqrt else 1)
        r2 = ref2[~none]
        tol = 1e-5 * r2 + 1e-5 + expanded_bound(qn64[~none], yn64[refi[~none]])
        m_err = float((got2 - r2).abs().max())
        assert bool(((got2 - r2).abs() <= tol).all()), f"masked_l2_nn off by {m_err}"
        # where the ids differ, the port's pick is as near within that tolerance
        diff = (mi.long() != refi) & ~none
        picked = (qu[diff].double() - y64[mi[diff].long()]).square().sum(1)
        assert bool(((picked - ref2[diff]).abs() <= tol[diff[~none]]).all()), "masked ids"
        assert bool(adj[diff][torch.arange(int(diff.sum()), device=dev),
                              group[mi[diff].long()]].all()), "a masked group was picked"
        emit(phase="check", what="masked_l2_nn vs float64", m=M_MAIN, n=SLICE_N, d=D_MAIN,
             groups=64, sqrt=sqrt, rows_without_group=int(none.sum()),
             ids_differing_within_tol=int(diff.sum()), max_abs_err_squared=m_err, ok=True,
             card=st["card"])
    kparams = [KernelParams(KernelType.LINEAR),
               KernelParams(KernelType.POLYNOMIAL, degree=3, gamma=1 / 128, coef0=1.0),
               KernelParams(KernelType.TANH, gamma=1 / 128, coef0=-0.25),
               KernelParams(KernelType.RBF, gamma=0.05)]
    for kp in kparams:
        g_err = 0.0
        for i in range(0, M_MAIN, 2500):
            got = gram_matrix(kp, qu[i:i + 2500], y, res=res).double()
            qb = qu[i:i + 2500].double()
            dot = qb @ y64.T
            if kp.kernel == KernelType.LINEAR:
                ref = dot
            elif kp.kernel == KernelType.POLYNOMIAL:
                ref = (kp.gamma * dot + kp.coef0) ** kp.degree
            elif kp.kernel == KernelType.TANH:
                ref = torch.tanh(kp.gamma * dot + kp.coef0)
            else:
                d2 = (qb.square().sum(1)[:, None] + yn64[None, :] - 2.0 * dot).clamp_min(0.0)
                ref = torch.exp(-kp.gamma * d2)
            tol = 1e-5 * ref.abs() + 1e-5
            if kp.kernel == KernelType.RBF:
                # the expanded distance's error bound through exp's slope
                tol = tol + kp.gamma * ref * expanded_bound(qb.square().sum(1)[:, None],
                                                            yn64[None, :])
            diff = (got - ref).abs()
            assert bool((diff <= tol).all()), (
                f"gram {kp.kernel.value} differs from float64 by {float(diff.max())}")
            g_err = max(g_err, float(diff.max()))
            del got, dot, ref, diff, tol
        emit(phase="check", what="gram_matrix vs float64", kernel=kp.kernel.value, m=M_MAIN,
             n=SLICE_N, d=D_MAIN, max_abs_err=g_err, rtol=1e-5, atol=1e-5, ok=True,
             card=st["card"])

    # eps_neighbors_l2sq: adjacency equal except pairs within the float32
    # expanded form's error of the radius
    eps = 16.0
    adj_e, vd = eps_neighbors_l2sq(qu, y, eps, res=res)
    assert adj_e.shape == (M_MAIN, SLICE_N) and vd.shape == (M_MAIN + 1,)
    assert torch.equal(vd[:-1], adj_e.sum(1, dtype=torch.int32)) and int(vd[-1]) == int(adj_e.sum())
    flips = 0
    for i in range(0, M_MAIN, 1000):
        qb = qu[i:i + 1000].double()
        d2 = (qb.square().sum(1)[:, None] + yn64[None, :] - 2.0 * qb @ y64.T).clamp_min(0.0)
        band = expanded_bound(qb.square().sum(1)[:, None], yn64[None, :])
        wrong = adj_e[i:i + 1000] != (d2 <= eps)
        assert not bool((wrong & ((d2 - eps).abs() > band)).any()), "eps adjacency differs"
        flips += int(wrong.sum())
    emit(phase="check", what="eps_neighbors_l2sq vs float64", m=M_MAIN, n=SLICE_N, d=D_MAIN,
         eps=eps, edges=int(vd[-1]), flips_within_band=flips, ok=True, card=st["card"])

    # kmeans.fit from init="array": the card against the CPU
    xk = cagra_data()[0][:SLICE_N]
    init = xk[:KMEANS_K]
    params = kmeans.KMeansParams(n_clusters=KMEANS_K, init="array", max_iter=KMEANS_ITERS)
    t0 = time.perf_counter()
    gpu = kmeans.fit(params, xk, centroids=init, res=res)
    torch.cuda.synchronize()
    k_gpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = kmeans.fit(params, xk.cpu(), centroids=init.cpu(), res=Resources(device="cpu"))
    k_cpu = time.perf_counter() - t0
    same = float((gpu.labels.cpu() == cpu.labels).float().mean())
    inertia_rel = abs(float(gpu.inertia) - float(cpu.inertia)) / float(cpu.inertia)
    emit(phase="check", what="kmeans.fit card vs cpu", n=SLICE_N, d=D_MAIN, k=KMEANS_K,
         max_iter=KMEANS_ITERS, n_iter_card=gpu.n_iter, n_iter_cpu=cpu.n_iter,
         labels_equal_share=same, inertia_card=float(gpu.inertia),
         inertia_cpu=float(cpu.inertia), inertia_rel_diff=inertia_rel,
         seconds_card=k_gpu, seconds_cpu=k_cpu, card=st["card"])
    assert same >= 0.999, f"k-means labels agree on {same} of the rows"
    assert inertia_rel <= 1e-4, f"k-means inertia differs by {inertia_rel}"
    del xk, init, gpu, cpu


def time_fused_modes(st):
    """``fused_knn``'s tensor-core modes (bf16, f32x3, s8) at the f32 row's
    shape (10,000 x 1M x 128, k=10), each beside its bound, its plain
    version and one library call per 2,500-query chunk; the QPS of
    ``knn`` in each mode through the public entry point (host clock around
    three synchronised batches); and what f32x3's bf16 hi/lo planes cost."""
    import torch

    from raft_tpu_torch.core import Resources
    from raft_tpu_torch.neighbors.brute_force import knn
    from raft_tpu_torch.ops import fused_knn as fk

    fused_knn, fused_knn_plain = fk.fused_knn, fk.fused_knn_plain
    x, q = st["main"]
    m, n, d, k = M_MAIN, N_MAIN, D_MAIN, K_MAIN
    saved = fused_knn.launches, dict(fused_knn.launches_by_mode), fk.bf16_split.launches
    xb, qb = x.bfloat16(), q.bfloat16()
    xh, qh = xb, qb
    xl, ql = (x - xh.float()).bfloat16(), (q - qh.float()).bfloat16()
    xs, qs = as_bytes(x, 255.0, -128.0), as_bytes(q, 255.0, -128.0)
    yn = x.square().sum(1)
    yns = xs.float().square().sum(1)

    def lib_bf16():
        for i in range(0, m, 2500):
            s = torch.mm(qb[i:i + 2500], xb.T, out_dtype=torch.float32)
            torch.topk(yn - 2.0 * s, k, dim=1, largest=False)

    def lib_f32x3():
        for i in range(0, m, 2500):
            s = (torch.mm(qh[i:i + 2500], xh.T, out_dtype=torch.float32)
                 + torch.mm(qh[i:i + 2500], xl.T, out_dtype=torch.float32)
                 + torch.mm(ql[i:i + 2500], xh.T, out_dtype=torch.float32))
            torch.topk(yn - 2.0 * s, k, dim=1, largest=False)

    def lib_s8():
        for i in range(0, m, 2500):
            s = torch._int_mm(qs[i:i + 2500], xs.T)
            torch.topk(yns - 2.0 * s, k, dim=1, largest=False)

    cases = {   # mode: (dataset, queries, library, its calls, bytes/elt, peak op/s, products, compute)
        "bf16": (xb, qb, lib_bf16, "torch.mm (bf16, float32 out) + score + torch.topk",
                 2, H100_BF16_FLOPS, 1, "bfloat16"),
        "f32x3": (x, q, lib_f32x3, "3 x torch.mm (bf16 hi/lo, float32 out) + score + torch.topk",
                  4, H100_BF16_FLOPS, 3, "float32x3"),
        "s8": (xs, qs, lib_s8, "torch._int_mm (int8, int32 out) + score + torch.topk",
               1, H100_INT8_OPS, 1, "float32"),
    }
    res = Resources(device="cuda")
    st["fused_modes_t"] = {}
    for mode, (ds, qq, lib, lib_calls, elt, peak, products, compute) in cases.items():
        ms = cuda_ms(lambda: fused_knn(ds, qq, k, mode=mode), reps=3)
        plain_ms = cuda_ms(lambda: fused_knn_plain(ds, qq, k, mode=mode), reps=1)
        lib_ms = cuda_ms(lib, reps=1)
        ops = products * 2.0 * m * n * d
        nbytes = (n * d + m * d) * elt + n * 4 + m * k * 8
        t_ops, t_bytes = ops / peak, nbytes / H100_BYTES_S
        row = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                   bound_ms=max(t_ops, t_bytes) * 1e3,
                   bound_by="operations" if t_ops >= t_bytes else "bytes")
        # k = 1 and 64 beside k = 10: what the per-query lists' insertions cost
        row["ms_by_k"] = {kk: (ms if kk == k else
                               cuda_ms(lambda: fused_knn(ds, qq, kk, mode=mode), reps=2))
                          for kk in (1, k, 64)}
        row.update(fit_insert_tiles(mode, row["ms_by_k"]))
        knn(ds, qq, k, compute=compute, res=res)          # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            knn(ds, qq, k, compute=compute, res=res)
        torch.cuda.synchronize()
        row["knn_qps"] = 3 * m / (time.perf_counter() - t0)
        if mode == "f32x3":
            # the wrapper's split of both operands into bf16 hi/lo planes
            # (two bf16_split launches): bytes read and written, and time
            row["planes_ms"] = cuda_ms(lambda: fk._operands(q, x, "f32x3"), reps=3)
            row["planes_bytes"] = (n + m) * d * (4 + 2 * 2)
            split_bytes = n * d * (4 + 2 * 2)
            st["split_t"] = dict(
                ms=cuda_ms(lambda: fk.bf16_split(x), reps=5),
                plain_ms=cuda_ms(lambda: fk.bf16_split_plain(x), reps=2),
                library_ms=None, bound_ms=split_bytes / H100_BYTES_S * 1e3, bound_by="bytes")
            emit(phase="time", kernel="bf16_split", shape=[n, d], bytes=split_bytes,
                 card=st["card"], **st["split_t"])
        st["fused_modes_t"][mode] = row
        emit(phase="time", kernel="fused_knn_tc", mode=mode, shape=[m, n, d, k],
             library=lib_calls, ops=ops, bytes=nbytes, knn_compute=compute,
             library_over_kernel=lib_ms / ms, card=st["card"], **row)
    fused_knn.launches, fused_knn.launches_by_mode, fk.bf16_split.launches = saved


def fit_insert_tiles(mode, ms_by_k):
    """The insertion cost of ``_nsplit``'s warm-up term (tile-steps per
    list insertion per query row) that fits this run's kernel times at the
    main shape best: least squares of ms = c x ``_split_steps`` over k =
    1, 10 and 64, each at the splits the launcher took, the cost on a grid
    of 0.1. Printed beside the one in use (``_INSERT_TILES``)."""
    from raft_tpu_torch.ops import fused_knn as fk

    c = fk.fused_knn_config(mode, D_MAIN, K_MAIN)
    qt, nb, slots = c["qt"], c["nb"], c["slots"]
    mt, tiles = -(-M_MAIN // qt), -(-N_MAIN // nb)
    ks = sorted(ms_by_k)
    splits = [fk._nsplit(M_MAIN, N_MAIN, qt, slots, nb, fk._INSERT_TILES * kk) for kk in ks]
    ts = [ms_by_k[kk] for kk in ks]
    best = None
    for i in range(10, 301):
        steps = [fk._split_steps(mt, tiles, s, slots, nb, i / 10 * kk)
                 for s, kk in zip(splits, ks)]
        scale = sum(a * b for a, b in zip(steps, ts)) / sum(a * a for a in steps)
        resid = sum((scale * a - b) ** 2 for a, b in zip(steps, ts))
        if best is None or resid < best[0]:
            best = (resid, i / 10)
    return dict(nsplit_by_k=dict(zip(ks, splits)), insert_tiles=fk._INSERT_TILES,
                insert_tiles_fit=best[1])


def time_cagra_hop(st):
    """``cagra_hop`` at the main path's shape: 10,000 queries, a mid-search
    beam (the best 32 of a 10-hop search, the best 10 visited), cw=32,
    d=128, arena merge."""
    import torch

    from raft_tpu_torch.neighbors import cagra
    from raft_tpu_torch.ops.cagra_hop import cagra_hop, cagra_hop_plain

    index, q = st.pop("cagra")
    x, graph = index.dataset, index.graph
    m, d = q.shape
    it = CAGRA_ITOPK
    dev = q.device
    dist, ids = cagra.search(cagra.SearchParams(itopk_size=it, max_iterations=10), index, q, it)
    bd = torch.full((m, 128), float("inf"), device=dev)
    bi = torch.full((m, 128), -1, dtype=torch.int32, device=dev)
    bv = torch.ones((m, 128), dtype=torch.int32, device=dev)
    bd[:, :it], bi[:, :it], bv[:, 10:it] = dist, ids, 0
    _, _, _, pick, nocand = cagra_hop_plain(
        q, bd, bi, bv, torch.full((m, 32), -1, dtype=torch.int32, device=dev), x,
        torch.zeros((m, 32), dtype=torch.int32, device=dev), it, 1, merge="arena")
    nbrs = graph[pick.long().clamp_max(N_MAIN - 1)].reshape(m, 32).contiguous()
    valid = (1 - nocand).repeat_interleave(32, dim=1).contiguous()
    args = (q, bd, bi, bv, nbrs, x, valid, it, 1)
    saved = cagra_hop.launches
    ms = cuda_ms(lambda: cagra_hop(*args, merge="arena"), reps=20, warm=3)
    extract_ms = cuda_ms(lambda: cagra_hop(*args, merge="extract"), reps=20, warm=3)
    plain_ms = cuda_ms(lambda: cagra_hop_plain(*args, merge="arena"), reps=2)
    for a, b in zip(cagra_hop(*args, merge="arena"), cagra_hop_plain(*args, merge="arena")):
        assert torch.equal(a, b), "cagra_hop differs from its plain version at the timed shape"
    profile = hop_profile(args)
    # the "xla" route's hop body on the same beam: its beam is (m, itopk + cw)
    # and holds distances without |q|^2
    qn = (q * q).sum(1, keepdim=True)
    xb_i = torch.cat([ids, torch.full((m, 32), -1, dtype=torch.int32, device=dev)], 1)
    xb_d = torch.cat([dist - qn, torch.full((m, 32), float("inf"), device=dev)], 1)
    xb_v = torch.zeros((m, it + 32), dtype=torch.bool, device=dev)
    xb_v[:, :10] = True
    dn2 = x.square().sum(1)
    xla_ms = cuda_ms(lambda: cagra._xla_hop(x, dn2, q, graph, xb_i, xb_d, xb_v, it, 1),
                     reps=10)
    # bytes: each distinct candidate row read once (queries share clusters,
    # so their neighbour lists overlap); operations: every valid pair scored
    ok = (nbrs >= 0) & (valid > 0)
    rows = int(ok.sum())
    distinct = int(torch.unique(nbrs[ok]).numel())
    nbytes = distinct * d * 4 + m * d * 4 + 3 * m * 128 * 4 * 2 + 2 * m * 32 * 4 + 2 * m * 4
    ops = 3 * rows * d
    t_bytes, t_ops = nbytes / H100_BYTES_S, ops / H100_F32_FLOPS
    st["hop_t"] = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                       bound_ms=max(t_bytes, t_ops) * 1e3,
                       bound_by="bytes" if t_bytes >= t_ops else "operations",
                       xla_hop_ms=xla_ms, profile=profile)
    emit(phase="time", kernel="cagra_hop", m=m, cw=32, d=d, itopk=it, merge="arena",
         pairs_scored=rows, distinct_rows=distinct, bytes=nbytes, flops=ops, extract_ms=extract_ms,
         library="none: no single PyTorch call computes a hop",
         xla_hop="the port's hop_impl='xla' hop body (gather, bmm, three stable sorts: "
                 "several calls)",
         card=st["card"], **st["hop_t"])
    cagra_hop.launches = saved


def hop_profile(args):
    """The in-kernel profile of ``cagra_hop`` at the timed shape: every
    ``profile`` carve-out timed on both merges (each checked against its
    plain version first; "nogate" also against "full"), and the phases'
    costs: scoring = full - noscore, dedup = full - nodedup, merge = full -
    nomerge, the gate's worth = full - nogate. Under ``merge="arena"``,
    "noscore" and "nodedup" run the extract merge (the JAX kernel's
    rule), so there those two differences also hold the merges' gap."""
    import torch

    from raft_tpu_torch.ops.cagra_hop import PROFILES, cagra_hop, cagra_hop_plain

    saved = dict(cagra_hop.launches_by_mode)
    out = {}
    for merge in ("arena", "extract"):
        full = cagra_hop(*args, merge=merge)
        for prof in PROFILES[1:]:
            got = cagra_hop(*args, merge=merge, profile=prof)
            for a, b in zip(got, cagra_hop_plain(*args, merge=merge, profile=prof)):
                assert torch.equal(a, b), f"cagra_hop {prof} ({merge}) differs at the timed shape"
            if prof == "nogate":
                assert all(torch.equal(a, b) for a, b in zip(got, full)), (prof, merge)
        t = {prof: cuda_ms(lambda prof=prof: cagra_hop(*args, merge=merge, profile=prof),
                           reps=20, warm=3) for prof in PROFILES}
        out[merge] = dict(ms=t, scoring_ms=t["full"] - t["noscore"],
                          dedup_ms=t["full"] - t["nodedup"], merge_ms=t["full"] - t["nomerge"],
                          gate_worth_ms=t["full"] - t["nogate"])
        emit(phase="time", kernel="cagra_hop", part="profile", merge=merge, **out[merge])
    cagra_hop.launches_by_mode = saved
    return out


def time_pq_scan(st):
    """``pq_scan`` and ``pq_scan_topk`` at the main path's shape: one query
    tile of the 1M index (128 queries x 8 probes, 1,024 pairs), bfloat16
    LUT, k=40; beside the fused kernel, the unfused kernel route it replaced
    (``pq_scan``, bias, mask, ``topk``, the one-chunk merge) in this call."""
    import torch

    from raft_tpu_torch.distance.pairwise import full_f32
    from raft_tpu_torch.matrix.select_k import select_k_impl
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.ops.pq_scan import (pack_keep_words, pq_scan, pq_scan_plain,
                                            pq_scan_topk, pq_scan_topk_plain)
    from raft_tpu_torch.ops.topk import topk

    index, q = st.pop("ivf")
    t, pc, k = 128, 8, IVF_K0
    qf = q[:t]
    probes = ivf_pq._coarse_probes(index, qf, pc).to(torch.int64)
    with full_f32():
        qrot = qf @ index.rotation.T
    lut, bias = ivf_pq._probe_luts(index, qrot, probes, *ivf_pq._codebooks_f32(index))
    pairs, s, cap = probes.numel(), index.pq_dim, index.capacity
    lut4 = lut.to(torch.bfloat16).contiguous()                  # (T, pc, S, K)
    lut = lut4.reshape(pairs, s, 16)
    plist = probes.reshape(-1).to(torch.int32).contiguous()
    probes32 = probes.to(torch.int32).contiguous()
    bias = bias.contiguous()
    codes, ids = index.list_codes, index.list_ids
    saved = pq_scan.launches, pq_scan_topk.launches, topk.launches
    ms = cuda_ms(lambda: pq_scan(codes, plist, lut), reps=50, warm=3)
    plain_ms = cuda_ms(lambda: pq_scan_plain(codes, plist, lut), reps=3)
    gathered = codes[plist.to(torch.int64)].to(torch.int64)[..., None]   # (pairs, cap, S, 1)
    lutf = lut.to(torch.float32)[:, None].expand(pairs, cap, s, 16)

    def library():
        # the same sum as two PyTorch calls over the codes gathered beforehand
        return torch.gather(lutf, 3, gathered).sum(dim=(2, 3))

    lib_ms = cuda_ms(library, reps=10)
    assert torch.equal(pq_scan(codes, plist, lut), pq_scan_plain(codes, plist, lut))
    lists = int(torch.unique(plist).numel())
    nbytes = lists * cap * s + pairs * s * 16 * 2 + pairs * 4 + pairs * cap * 4
    ops = pairs * cap * s
    t_bytes, t_ops = nbytes / H100_BYTES_S, ops / H100_F32_FLOPS
    st["pq_t"] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                      bound_ms=max(t_bytes, t_ops) * 1e3,
                      bound_by="bytes" if t_bytes >= t_ops else "operations")
    emit(phase="time", kernel="pq_scan", pairs=pairs, distinct_lists=lists, cap=cap, S=s,
         lut_dtype="bfloat16", bytes=nbytes, adds=ops,
         library="torch.gather + .sum over the gathered codes (two calls)",
         card=st["card"], **st["pq_t"])

    def fused():
        return pq_scan_topk(codes, ids, probes32, lut4, bias, k, True)

    def unfused():
        sc = pq_scan(codes, plist, lut).reshape(t, pc, cap) + bias[:, :, None]
        sid = ids[probes]
        sc = torch.where(sid >= 0, sc, float("inf"))
        v, i = topk(sc.reshape(t, -1), k, True, in_idx=sid.reshape(t, -1))
        return select_k_impl(v, i, k, True)     # the merge the route ran on one chunk

    def library_topk():
        # the scan as above, then torch.topk over the tile's pc x cap scores
        # (three calls; the bias and the mask are left out)
        return torch.topk(library().reshape(t, pc * cap), k, dim=1, largest=False)

    f_ms = cuda_ms(fused, reps=50, warm=3)
    f_plain_ms = cuda_ms(lambda: pq_scan_topk_plain(codes, ids, probes32, lut4, bias, k, True),
                         reps=3)
    unfused_ms = cuda_ms(unfused, reps=20, warm=3)
    f_lib_ms = cuda_ms(library_topk, reps=10)
    fv, fi = fused()
    pv, pi = pq_scan_topk_plain(codes, ids, probes32, lut4, bias, k, True)
    uv, ui = unfused()
    assert torch.equal(fv, pv) and torch.equal(fi, pi), "pq_scan_topk differs at the timed tile"
    assert torch.equal(fv, uv) and torch.equal(fi, ui), "fused and unfused differ at the tile"
    # bytes: each distinct probed list's codes and ids once, the LUTs, the
    # probe ids and biases, the (T, k) values and ids written
    f_bytes = lists * cap * (s + 4) + pairs * s * 16 * 2 + pairs * 8 + t * k * 8
    t_bytes = f_bytes / H100_BYTES_S
    # the same tile under the phase's 50% filter: the kernel against its
    # plain version, and its time; the bound gains the bitset's bytes
    words = pack_keep_words(st.pop("ivf_keep"))
    kv, ki = pq_scan_topk(codes, ids, probes32, lut4, bias, k, True, keep_words=words)
    pv, pi = pq_scan_topk_plain(codes, ids, probes32, lut4, bias, k, True, keep_words=words)
    assert torch.equal(kv.view(torch.int32), pv.view(torch.int32)) and torch.equal(ki, pi), (
        "filtered pq_scan_topk differs at the timed tile")
    ff_ms = cuda_ms(lambda: pq_scan_topk(codes, ids, probes32, lut4, bias, k, True,
                                         keep_words=words), reps=50, warm=3)
    ff_bytes = f_bytes + words.numel() * 4
    st["pq_topk_t"] = dict(ms=f_ms, plain_ms=f_plain_ms, library_ms=f_lib_ms,
                           bound_ms=max(t_bytes, t_ops) * 1e3,
                           bound_by="bytes" if t_bytes >= t_ops else "operations",
                           unfused_route_ms=unfused_ms,
                           filtered=dict(keep_share=FILTER_KEEP[0], ms=ff_ms, bytes=ff_bytes,
                                         bound_ms=max(ff_bytes / H100_BYTES_S, t_ops) * 1e3))
    # by tile size: a block's latency (8 queries) against the card's
    # throughput (1,024 queries, many blocks an SM in turn)
    by_t = {}
    for tt in (8, 128, 1024):
        pt = ivf_pq._coarse_probes(index, q[:tt], pc)
        with full_f32():
            lt, bt = ivf_pq._probe_luts(index, q[:tt] @ index.rotation.T, pt.to(torch.int64),
                                        *ivf_pq._codebooks_f32(index))
        pt, lt = pt.to(torch.int32).contiguous(), lt.to(torch.bfloat16).contiguous()
        by_t[str(tt)] = cuda_ms(lambda: pq_scan_topk(codes, ids, pt, lt, bt.contiguous(), k, True),
                                reps=20, warm=2)
    emit(phase="time", kernel="pq_scan_topk", T=t, pc=pc, k=k, distinct_lists=lists, cap=cap,
         S=s, lut_dtype="bfloat16", bytes=f_bytes, adds=ops,
         library="torch.gather + .sum + torch.topk (three calls, no bias or mask)",
         unfused_route="pq_scan + bias + torch.where + topk + merge (the route before)",
         ms_by_queries=by_t, card=st["card"], **st["pq_topk_t"])
    pq_scan.launches, pq_scan_topk.launches, topk.launches = saved


def time_f32_routes(st):
    """Mode f32's routes timed in one call. The batch (10,000 x 1M x 128,
    k=10) on its route, twice, beside its bound, the plain
    version and ``torch.addmm`` + ``torch.topk`` per 2,500-query chunk with
    |y|² computed once outside the timing; ``tf32_split`` of the 1M x 128
    set beside its bytes bound; then the sweep of m in F32_SWEEP_M over
    the same set with every route and the library timed at each m, and the
    crossover it gives (the largest swept m up to which the row-split route
    beats every other route at every m) beside ``M_SMALL``."""
    import torch

    from raft_tpu_torch.distance.pairwise import full_f32
    from raft_tpu_torch.ops import fused_knn as fk

    x, q = st["main"]
    n, d, k = N_MAIN, D_MAIN, K_MAIN
    yn = x.square().sum(1)

    def library(qq):
        # the same function as two PyTorch calls per chunk of queries:
        # expanded-L2 product (torch.addmm, full float32), then torch.topk
        for i in range(0, qq.shape[0], 2500):
            with full_f32():
                dd = torch.addmm(yn[None, :], qq[i:i + 2500], x.T, alpha=-2.0)
            torch.topk(dd, k, dim=1, largest=False)

    with uncounted():
        m = M_MAIN
        plain_ms = cuda_ms(lambda: fk.fused_knn_plain(x, q, k), reps=1)
        lib_ms = cuda_ms(lambda: library(q), reps=1)
        route = "tf32x3"
        runs = [cuda_ms(lambda: fk._fused_knn_f32(route, x, q, k), reps=3) for _ in range(2)]
        st["f32_t"] = dict(ms_runs=runs, ms=min(runs), plain_ms=plain_ms, library_ms=lib_ms,
                           **f32_bound(m, n, d, k))
        emit(phase="time", kernel="fused_knn", mode="f32", route=route, shape=[m, n, d, k],
             library="torch.addmm + torch.topk (two calls per 2,500-query chunk, |y|^2 "
             "precomputed)", card=st["card"], **st["f32_t"])
        split_bytes = n * d * (4 + 2 * 4)
        st["tf32_split_t"] = dict(
            ms=cuda_ms(lambda: fk.tf32_split(x), reps=5),
            plain_ms=cuda_ms(lambda: fk.tf32_split_plain(x), reps=2),
            library_ms=None, bound_ms=split_bytes / H100_BYTES_S * 1e3, bound_by="bytes")
        emit(phase="time", kernel="tf32_split", shape=[n, d], bytes=split_bytes,
             card=st["card"], **st["tf32_split_t"])

        sweep = {}
        for m in F32_SWEEP_M:
            qm = q[:m]
            row = {r: cuda_ms(lambda: fk._fused_knn_f32(r, x, qm, k), reps=5)
                   for r in fk._F32_ROUTES}
            lib = cuda_ms(lambda: library(qm), reps=5)
            others = min(v for r, v in row.items() if r != "rows")
            sweep[m] = dict(ms_by_route=row, library_ms=lib, rows_wins=row["rows"] < others,
                            **f32_bound(m, n, d, k))
            emit(phase="sweep", kernel="fused_knn", mode="f32", m=m, n=n, d=d, k=k,
                 card=st["card"], **sweep[m])
        crossover = None
        for m in F32_SWEEP_M:
            if not sweep[m]["rows_wins"]:
                break
            crossover = m
        emit(phase="sweep", kernel="fused_knn", mode="f32", crossover_m=crossover,
             m_small=fk.M_SMALL, matches_m_small=crossover == fk.M_SMALL, card=st["card"])
        st["f32_sweep"] = sweep
        plain_small = {m: cuda_ms(lambda: fk.fused_knn_plain(x, q[:m], k), reps=2)
                       for m in (1, SERVE_MAX_BATCH)}
        st["rows_t"] = dict(
            ms=sweep[SERVE_MAX_BATCH]["ms_by_route"]["rows"], plain_ms=plain_small[SERVE_MAX_BATCH],
            library_ms=sweep[SERVE_MAX_BATCH]["library_ms"], **f32_bound(SERVE_MAX_BATCH, n, d, k),
            m=SERVE_MAX_BATCH,
            at_m1=dict(ms=sweep[1]["ms_by_route"]["rows"], plain_ms=plain_small[1],
                       library_ms=sweep[1]["library_ms"], **f32_bound(1, n, d, k)))


def time_merges(st):
    """warp_topk's two split merges, each on its own shapes and the
    other's: (m = 64, 132 splits), the row-split route's at a serving
    flush, and (m = 10,000, 5 splits), the tensor-core route's at the
    batch; k = 10. Both must give the plain merge's lists bit for bit
    (score descending, ties to the lower id) before they are timed."""
    import ctypes

    import torch

    from raft_tpu_torch.ops._build import load

    fn = load("fused_knn").fused_knn_merge_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 3 + \
        [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(60)
    k = K_MAIN
    out = {}
    for m, ns in ((SERVE_MAX_BATCH, 132), (M_MAIN, 5)):
        pv = torch.rand((m, ns, k), generator=g, device=dev).sort(dim=2, descending=True).values
        pi = torch.randint(0, 1 << 29, (m, ns, k), generator=g, device=dev, dtype=torch.int32)
        fv, fi = pv.reshape(m, -1), pi.reshape(m, -1)
        o = fi.argsort(dim=1, stable=True)
        o = o.gather(1, (-fv.gather(1, o)).argsort(dim=1, stable=True))[:, :k]
        rv, ri = fv.gather(1, o), fi.gather(1, o)
        row = {}
        for name, wide in (("merge_kernel", 0), ("merge_wide_kernel", 1)):
            ov = torch.empty((m, k), dtype=torch.float32, device=dev)
            oi = torch.empty((m, k), dtype=torch.int32, device=dev)

            def run(wide=wide, ov=ov, oi=oi):
                err = fn(wide, pv.data_ptr(), pi.data_ptr(), m, ns, k, ov.data_ptr(),
                         oi.data_ptr(), torch.cuda.current_stream().cuda_stream)
                assert err == 0, f"merge launch failed: cudaError {err}"

            run()
            torch.cuda.synchronize()
            assert torch.equal(ov, rv) and torch.equal(oi, ri), (name, m, ns)
            row[name] = cuda_ms(run, reps=20)
        chosen = "merge_wide_kernel" if ns >= 32 else "merge_kernel"
        out[f"{m}x{ns}"] = dict(m=m, nsplit=ns, k=k, ms_by_kernel=row, dispatch=chosen,
                                dispatch_is_faster=row[chosen] <= min(row.values()))
        emit(phase="time", kernel="warp_topk_merge", card=st["card"], **out[f"{m}x{ns}"])
    st["merge_t"] = out


def phase_times(st):
    import torch

    from raft_tpu_torch.ops.fused_knn import fused_knn
    from raft_tpu_torch.ops.topk import topk, topk_plain

    st.pop("main")
    k = K_MAIN
    saved = fused_knn.launches, topk.launches

    vals = st.pop("select")
    mm, nn = TOPK_SHAPE
    ms = cuda_ms(lambda: topk(vals, k), reps=5)
    plain_ms = cuda_ms(lambda: topk_plain(vals, k), reps=1)
    lib_ms = cuda_ms(lambda: torch.topk(vals, k, dim=1, largest=False), reps=5)
    nbytes = mm * nn * 4 + mm * k * 8
    t_bound = nbytes / H100_BYTES_S * 1e3
    st["topk_t"] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                        bound_ms=t_bound, bound_by="bytes")
    emit(phase="time", kernel="topk", shape=[mm, nn, k], ms=ms, plain_ms=plain_ms,
         library_ms=lib_ms, library="torch.topk", bound_ms=t_bound,
         bound_by="bytes", card=st["card"])
    del vals
    topk_sweep(st)
    fused_knn.launches, topk.launches = saved


def topk_sweep(st):
    """``topk`` against the plain route (``_select_k``) and ``torch.topk``
    over the rows of the index paths, and the crossover it gives: the
    smallest swept width at and above which the kernel beats the plain
    route at every swept k and row count (``WIDE_SELECT_COLS_DEFAULT``)."""
    import torch

    from raft_tpu_torch.ops.topk import topk

    sk = importlib.import_module("raft_tpu_torch.matrix.select_k")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    wins = {}
    for n in SWEEP_COLS:
        for rows in SWEEP_ROWS:
            x = torch.rand((rows, n), generator=g, device=dev)
            for k in SWEEP_K:
                ov, oi = topk(x, k)
                pv, pi = sk._select_k(x, None, k, True)
                assert torch.equal(oi, pi) and torch.equal(ov, pv), (
                    f"topk and the plain route differ at {rows} x {n}, k={k}")
                ms = cuda_ms(lambda: topk(x, k), reps=5)
                plain_ms = cuda_ms(lambda: sk._select_k(x, None, k, True), reps=2)
                lib_ms = cuda_ms(lambda: torch.topk(x, k, dim=1, largest=False), reps=3)
                bound = (rows * n * 4 + rows * k * 8) / H100_BYTES_S * 1e3
                wins[(n, rows, k)] = ms < plain_ms
                emit(phase="sweep", kernel="topk", rows=rows, n=n, k=k, ms=ms,
                     plain_ms=plain_ms, torch_topk_ms=lib_ms, bound_ms=bound,
                     kernel_wins=ms < plain_ms, card=st["card"])
            del x
    crossover = None
    for n in reversed(SWEEP_COLS):
        if not all(w for (c, _, _), w in wins.items() if c == n):
            break
        crossover = n
    emit(phase="sweep", kernel="topk", crossover_cols=crossover,
         wide_select_cols_default=sk.WIDE_SELECT_COLS_DEFAULT,
         matches_default=crossover == sk.WIDE_SELECT_COLS_DEFAULT, card=st["card"])


def all_counts():
    """Every kernel wrapper's launch count (``ops.launch_counts``, with mode
    f32's ``fused_knn`` launches also summed over its routes)."""
    from raft_tpu_torch import ops
    from raft_tpu_torch.ops.fused_knn import fused_knn

    return {"fused_knn": fused_knn.launches_by_mode["f32"], **ops.launch_counts()}


def reset_all_counts():
    from raft_tpu_torch.ops.cagra_hop import cagra_hop
    from raft_tpu_torch.ops.fused_knn import bf16_split, fused_knn, tf32_split
    from raft_tpu_torch.ops.pq_scan import pq_scan, pq_scan_topk
    from raft_tpu_torch.ops.topk import topk

    for fn in (fused_knn, bf16_split, tf32_split, topk, pq_scan, pq_scan_topk, cagra_hop):
        fn.launches = 0
    fused_knn.launches_by_mode = dict.fromkeys(fused_knn.launches_by_mode, 0)
    cagra_hop.launches_by_mode = dict.fromkeys(cagra_hop.launches_by_mode, 0)
    fused_knn.launches_by_route = dict.fromkeys(fused_knn.launches_by_route, 0)


def row_equiv(d, i, rd, ri, rtol=1e-5, atol=1e-5):
    """Per-row ``knn_equiv``: True where a row's distances agree within
    tolerance (underfill slots exactly) and its ids agree, or differ only
    where distances tie within that tolerance."""
    import torch

    fin = torch.isfinite(rd)
    close = torch.where(fin, (d - rd).abs() <= atol + rtol * rd.abs(), d == rd)
    dist_ok = close.all(1) & (torch.isfinite(d) == fin).all(1)
    same_ids = (i == ri).all(1)
    same_set = (torch.sort(i, 1).values == torch.sort(ri, 1).values).all(1)
    sd, srd = torch.sort(d, 1).values, torch.sort(rd, 1).values
    ties = torch.where(torch.isfinite(srd), (sd - srd).abs() <= atol + rtol * srd.abs(),
                       sd == srd).all(1)
    return dist_ok & (same_ids | same_set | ties)


def add_serve_launches(st, launches):
    """Add one loaded window's launch counts to the serve phase's total."""
    total = st.setdefault("launches_serve", {})
    for name, n in launches.items():
        total[name] = total.get(name, 0) + n


def serve_kernel_checks(st):
    """The kernels the serve path launches, at its small shapes, against
    their plain versions (phase 1's rules: bit for bit, f32 ``fused_knn`` by
    knn_equiv at 1e-5): ``fused_knn`` at m = 1 and 64 over the 1M set,
    ``pq_scan_topk`` on one query (an underfilled one and one with ties)
    and on 64 at the main tile's shape, the entry-pool ``topk`` at m = 1
    and 64 over 16,384 columns, and ``cagra_hop`` at m = 1."""
    import torch

    from raft_tpu_torch.ops.fused_knn import fused_knn, fused_knn_plain
    from raft_tpu_torch.ops.pq_scan import pq_scan_topk, pq_scan_topk_plain

    from raft_tpu_torch.distance.pairwise import full_f32

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(40)
    x, q = st["main"]
    yn = x.square().sum(1)
    err = 0.0
    for m in (1, 64):
        before = f32_route_counts()
        dv, di = fused_knn(x, q[:m], K_MAIN)
        torch.cuda.synchronize()
        # a serving flush's shape is the row-split route's
        assert f32_route_counts() == dict(before, rows=before["rows"] + 1), before
        rd, ri = fused_knn_plain(x, q[:m], K_MAIN)
        e = knn_equiv(dv, di, rd, ri, rtol=1e-5, atol=1e-5)
        err = max(err, e)

        def library(qm=q[:m]):
            # the same function as two PyTorch calls: the expanded-L2
            # product (full float32) and torch.topk
            with full_f32():
                dd = torch.addmm(yn[None, :], qm, x.T, alpha=-2.0)
            torch.topk(dd, K_MAIN, dim=1, largest=False)

        # the whole call's time at the serving shape (the row-split route:
        # the dataset read once, |y|² summed in the kernel), beside the bound
        # of reading the set and the library calls' time with |y|²
        # precomputed
        with uncounted():
            ms = cuda_ms(lambda: fused_knn(x, q[:m], K_MAIN), reps=5)
            lib_ms = cuda_ms(library, reps=5)
        emit(phase="check", kernel="fused_knn", n=N_MAIN, d=D_MAIN, m=m, k=K_MAIN,
             mode="f32", route="rows", max_abs_err=e, ok=True, serve=True, ms=ms,
             library_ms=lib_ms, library="torch.addmm + torch.topk (|y|^2 precomputed)",
             kernel_at_or_below_library=ms <= lib_ms, **f32_bound(m, N_MAIN, D_MAIN, K_MAIN),
             card=st["card"])
    errs = st.setdefault("f32_err", {})
    errs["rows"] = max(errs.get("rows", 0.0), err)
    codes, ids, probes, lut, bias, _ = pq_topk_case(
        g, n_lists=PQ_LISTS, cap=PQ_CAP, s=64, t=64, pc=8, split=False,
        dt=torch.bfloat16, inner=False, top=300)
    for rows in (slice(0, 1), slice(1, 2), slice(0, 64)):
        args = (codes, ids, probes[rows].contiguous(), lut[rows].contiguous(),
                bias[rows].contiguous(), IVF_K0, True)
        v, i = pq_scan_topk(*args)
        torch.cuda.synchronize()
        pv, pi = pq_scan_topk_plain(*args)
        assert torch.equal(v.view(torch.int32), pv.view(torch.int32)) and torch.equal(i, pi), (
            f"pq_scan_topk differs from its plain version at T={rows}")
        emit(phase="check", kernel="pq_scan_topk", n_lists=PQ_LISTS, cap=PQ_CAP, S=64,
             T=rows.stop - rows.start, pc=8, k=IVF_K0, lut_dtype="bfloat16",
             underfilled_rows=int((i == -1).any(1).sum()), max_abs_err=0.0,
             bit_equal=True, ok=True, serve=True)
    for m in (1, 64):
        v = torch.rand((m, 16_384), generator=g, device=dev)
        if m > 1:
            plant_topk_rows(v, g)
        for k in (K_MAIN, CAGRA_ITOPK, IVF_K0):
            check_topk(v, k, True)
        emit(phase="check", kernel="topk", shape=[m, 16_384], k=[K_MAIN, CAGRA_ITOPK, IVF_K0],
             select_min=True, max_abs_err=0.0, bit_equal=True, ok=True, serve=True)
    phase_hop_kernel(st, m=1, cases=[(32, 1, "arena", "f32", 128),
                                     (32, 1, "extract", "f32", 128),
                                     (64, 2, "arena", "f32", 128)])


COLD_PUBLISH = """
import json, sys
import torch
from raft_tpu_torch.core import Resources
from raft_tpu_torch.neighbors import ivf_pq
from raft_tpu_torch.serve import IndexRegistry

index = ivf_pq.load(sys.argv[1], res=Resources(device="cuda"))
sp = ivf_pq.SearchParams(n_probes=8, lut_dtype="bfloat16")
reg = IndexRegistry()
first = reg.publish("serve", index, search_params=sp, k=10)
again = reg.publish("serve", index, search_params=sp, k=10)
print(json.dumps({"first": first["warm"][10], "again": again["warm"][10]}))
"""


def serve_cold_publish(st, index):
    """First calls in a fresh process: the IVF-PQ index saved to a file,
    loaded by a new Python process that publishes it (the warm ladder: one
    search a bucket) and publishes it again. The first publish pays the
    CUDA context, cuBLAS handles, the allocator's first blocks and the
    cached kernel library's load; the build attribution beside each bucket
    says which were kernel builds (nvcc runs: ``programs``) and which
    cached loads (``cache_hits``)."""
    import shutil

    from raft_tpu_torch.neighbors import ivf_pq

    root = os.path.dirname(os.path.abspath(__file__))
    tmp = os.path.join(root, "build", "serve")
    os.makedirs(tmp, exist_ok=True)
    path = os.path.join(tmp, "ivf_pq.bin")
    try:
        ivf_pq.save(index, path)
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-c", COLD_PUBLISH, path], cwd=root,
                             env=dict(os.environ, PYTHONPATH=root), capture_output=True,
                             text=True, timeout=300)
        proc_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    assert out.returncode == 0, out.stderr[-4000:]
    rep = json.loads(out.stdout.strip().splitlines()[-1])
    emit(phase="serve_first_call", index="ivf_pq (1M, n_probes 8, bf16 LUT)", k=K_MAIN,
         process_seconds=proc_s, first_publish=rep["first"], second_publish=rep["again"],
         card=st["card"])
    assert all(b["programs"] == 0 and b["cache_hits"] == 0 for b in rep["again"].values())


def serve_load(svc, name, pool, threads, per_thread, k, check_rows, swap=None):
    """Closed-loop load (bench.py:733 ``_row_serve``): ``threads`` threads
    each send ``per_thread`` one-row requests to ``name`` and wait for each
    answer; ``swap`` (a zero-argument publish) runs once half the requests
    are answered. Returns the per-request latencies, the answers of rows
    below ``check_rows`` by row (with the request id the service's request
    log holds them under), the failures, the load seconds and the swap's
    report."""
    import threading

    lats, results, failures = [], {}, []
    lock = threading.Lock()
    served = [0]
    half = threading.Event()

    def submitter(tid):
        mine_l, mine_r = [], {}
        for j in range(per_thread):
            qi = (tid + j * threads) % pool.shape[0]
            t0 = time.perf_counter()
            try:
                rid = f"{name}-{tid}-{j}"
                d, i = svc.submit(name, pool[qi:qi + 1], k, rid=rid).result(timeout=120)
            except Exception as e:  # every loss is counted and fails the phase
                with lock:
                    failures.append(f"{type(e).__name__}: {str(e)[:120]}")
                    served[0] += 1
                    if served[0] >= threads * per_thread // 2:
                        half.set()
                continue
            mine_l.append(time.perf_counter() - t0)
            if qi < check_rows:
                mine_r[qi] = (d[0], i[0], rid)
            with lock:
                served[0] += 1
                if served[0] >= threads * per_thread // 2:
                    half.set()
        with lock:
            lats.extend(mine_l)
            results.update(mine_r)

    workers = [threading.Thread(target=submitter, args=(t,)) for t in range(threads)]
    t_load = time.perf_counter()
    for w in workers:
        w.start()
    report = None
    if swap is not None:
        assert half.wait(timeout=600), "the load never reached its midpoint"
        report = swap()
    for w in workers:
        w.join(600)
        assert not w.is_alive(), "a submitter thread did not finish"
    return lats, results, failures, time.perf_counter() - t_load, report


def served_rows_equal(results, log, searchers, pool, k):
    """Each served row against its direct search at the shape that served
    it: the request log gives each request's bucket, and the rows served in
    bucket b are searched b at a time, zero-padded as a flush pads them (a
    GEMM's rounding depends on its shape, not on the other rows). A row
    passes if it equals (``row_equiv``) the answer of any of ``searchers``
    (the versions that may have served it). Returns the rows, the pass mask
    and the served ids."""
    import numpy as np
    import torch

    dev = torch.device("cuda")
    rows = sorted(results)
    got_d = torch.from_numpy(np.stack([results[r][0] for r in rows])).to(dev)
    got_i = torch.from_numpy(np.stack([results[r][1] for r in rows])).to(dev)
    by_bucket = {}
    for n, r in enumerate(rows):
        by_bucket.setdefault(log.get(results[r][2])["bucket"], []).append(n)
    ok = torch.zeros(len(rows), dtype=torch.bool, device=dev)
    for searcher in searchers:
        pos, ref_d, ref_i = [], [], []
        for b, ns in sorted(by_bucket.items()):
            for s in range(0, len(ns), b):
                grp = ns[s:s + b]
                batch = np.zeros((b, pool.shape[1]), pool.dtype)
                batch[:len(grp)] = pool[[rows[n] for n in grp]]
                d, i = searcher(batch, k)
                pos += grp
                ref_d.append(d[:len(grp)])
                ref_i.append(i[:len(grp)])
        order = torch.argsort(torch.tensor(pos, device=dev))
        ok |= row_equiv(got_d, got_i, torch.cat(ref_d)[order], torch.cat(ref_i)[order])
    return rows, ok, got_i


def serve_window(before, after, stream):
    """Flushes, buckets and mean occupancy of one stream between two
    ``obs.to_json()`` snapshots."""
    from raft_tpu_torch.obs import metrics

    dl = metrics.delta(before, after)
    pre = "raft_tpu_serve_flush_total{bucket=\""
    buckets = {int(key[len(pre):].split("\"")[0]): int(v) for key, v in dl.items()
               if key.startswith(pre) and f'stream="{stream}"' in key}
    occ_sum = dl.get('raft_tpu_serve_batch_occupancy_sum{stream="%s"}' % stream, 0.0)
    occ_cnt = dl.get('raft_tpu_serve_batch_occupancy_count{stream="%s"}' % stream, 0)
    return sum(buckets.values()), dict(sorted(buckets.items())), occ_sum / max(occ_cnt, 1)


def flush_profile(st, kind, searcher, qhost, k, buckets=(1, SERVE_MAX_BATCH)):
    """One flush of ``searcher`` as the pipelined service runs it, at
    ``buckets`` (1 and 64 by default) on device-resident queries: the dispatch (search and the start
    of the copy to pinned host memory) under ``torch.cuda.
    set_sync_debug_mode("warn")``, whose warnings count the host syncs the
    dispatch makes; the milliseconds between CUDA events recorded before
    and after it (``event_ms``: the card's busy and idle time of the
    flush); the kernel launches it made; and, at bucket 64, the device's
    busy time and idle share over one flush (torch.profiler, table in
    ``serve_<kind>_flush_profile.txt``)."""
    import warnings

    import torch

    from raft_tpu_torch.serve.service import _start_copy_to_host

    dev = torch.device("cuda")
    out = {}
    for b in buckets:
        qd = torch.as_tensor(qhost[:b]).to(dev)
        searcher(qd, k)                      # first calls of this shape
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        reset_all_counts()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                t0 = time.perf_counter()
                e0.record()
                _, done = _start_copy_to_host(searcher(qd, k))
                e1.record()
                dispatch_ms = (time.perf_counter() - t0) * 1e3
            finally:
                torch.cuda.set_sync_debug_mode(0)
        done.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        syncs = [str(w.message) for w in caught if "synchroniz" in str(w.message)]
        out[b] = dict(host_syncs=len(syncs), event_ms=e0.elapsed_time(e1),
                      dispatch_ms=dispatch_ms, wall_ms=wall_ms,
                      launches={kk: v for kk, v in all_counts().items() if v})
        if kind in ("brute_force", "stream_ivf_pq"):
            # a brute-force flush, and a mutable flush's delta scan at a
            # 4,096-row bucket: one row-split launch, nothing on mode f32's
            # other routes
            assert f32_route_counts() == dict(dict.fromkeys(f32_route_counts(), 0), rows=1), (
                kind, b, out[b]["launches"])
    prof = profile_batch(st, f"{kind} serve flush", f"serve_{kind}_flush_profile.txt",
                         lambda: _start_copy_to_host(searcher(qd, k))[1].synchronize(),
                         what=f"{SERVE_MAX_BATCH}-row flush")
    # the idle share of an unprofiled flush: the profiler slows the host
    out[SERVE_MAX_BATCH].update(
        device_busy_ms=prof["device_busy_ms"],
        idle_share=1.0 - prof["device_busy_ms"] / out[SERVE_MAX_BATCH]["wall_ms"])
    return out


def pq_refine_hook(ix, x, sp):
    """The serving row's searcher (bench.py:785-800): IVF-PQ at ``sp`` for
    4k candidates, refined to k against the rows ``x``, on the card."""
    import torch

    from raft_tpu_torch.core import Resources
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.neighbors.refine import refine

    res = Resources(device="cuda")
    dev = torch.device("cuda")

    def fn(queries, k_):
        qd = torch.as_tensor(queries, device=dev)
        _, cand = ivf_pq.search(sp, ix, qd, 4 * k_, res=res)
        return refine(x, qd, cand, k_, res=res)

    fn.kind, fn.dim, fn.query_dtype, fn.device = "ivf_pq+refine", D_MAIN, "float32", dev
    return fn


def phase_serve(st):
    """Phase 4: ``raft_tpu_torch.serve`` on the card. The serve path's
    kernels at its small shapes (:func:`serve_kernel_checks`); then the JAX
    package's serving row (bench.py:733-869, ``serve_ivf_pq_100k``) at the
    IVF-PQ index of phase 2: the IVF-PQ + refine hook (search 4k candidates,
    refine to k; bench.py:785-800) behind ``SearchService(max_batch=64,
    max_wait_us=2000)``, 8 threads x 400 one-row requests at k=10, a second
    IVF-PQ build (outside the timed window) published at mid-load, once
    with ``pipeline_depth=2`` and once with 0; then brute force, IVF-Flat
    and CAGRA (itopk 32) published on the same service and served 400
    requests each. Every request must be answered, the swap must fail none,
    the loaded window must build no kernel (``obs.compile.attribution``),
    served rows must equal the serving index's direct search of the row
    (CAGRA: recall@10 >= 0.95) and IVF-PQ + refine's recall@10 must reach
    0.85. Prints QPS, the sequential batch-1 QPS, p50 / p99, occupancy,
    host syncs, device ms and launches per flush, and the memory ledger
    beside the second build's allocation delta."""
    import numpy as np
    import torch

    from raft_tpu_torch import obs
    from raft_tpu_torch.core import Resources
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.obs import RequestLog
    from raft_tpu_torch.obs import compile as obs_compile
    from raft_tpu_torch.serve import SearchService

    serve_kernel_checks(st)
    res = Resources(device="cuda")
    index, q = st["ivf"]
    serve_cold_publish(st, index)
    x, truth = st["ivf_x"], st["ivf_truth"]
    sp = ivf_pq.SearchParams(n_probes=8, lut_dtype="bfloat16")
    params = ivf_pq.IndexParams(n_lists=1024, pq_bits=4, pq_dim=64, seed=0)
    k = K_MAIN

    pool = q.cpu().numpy()
    serving = pq_refine_hook(index, x, sp)
    serving(pool[:1], k)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for j in range(SERVE_SEQ):                       # no batcher: one row a call
        serving(pool[j:j + 1], k)[1].cpu()
    seq_qps = SERVE_SEQ / (time.perf_counter() - t0)

    # the swap target, built outside the timed window; its allocation delta
    # against the ledger's bytes for it
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    index2 = ivf_pq.build(params, x, res=res)
    torch.cuda.synchronize()
    delta = torch.cuda.memory_allocated() - before
    ledger_bytes = obs.mem.unaccounted_index_bytes(index2)
    tok = obs.mem.account_index(index2, name="serve_v2")
    emit(phase="serve_ledger", index="ivf_pq (swap target)", ledger_bytes=ledger_bytes,
         allocation_delta_bytes=delta, ratio=ledger_bytes / max(delta, 1), tolerance=LEDGER_TOL,
         hbm=obs.mem.hbm_stats(), card=st["card"])
    assert abs(ledger_bytes - delta) <= LEDGER_TOL * delta, (ledger_bytes, delta)
    obs.mem.release(tok)
    swap_target = pq_refine_hook(index2, x, sp)

    stream = f"serve.k{k}"
    other = None
    for depth in (2, 0):
        log = RequestLog(capacity=8192)
        svc = SearchService(max_batch=SERVE_MAX_BATCH, max_wait_us=SERVE_WAIT_US,
                            max_queue_rows=4 * SERVE_MAX_BATCH * SERVE_THREADS,
                            pipeline_depth=depth, request_log=log)
        first = svc.publish("serve", serving, k=k)
        m_before = obs.to_json()
        reset_all_counts()
        with obs_compile.attribution() as rec:
            lats, results, failures, load_s, swap_rep = serve_load(
                svc, "serve", pool, SERVE_THREADS, SERVE_PER_THREAD, k, SERVE_CHECK,
                swap=lambda: svc.publish("serve", swap_target, k=k))
        torch.cuda.synchronize()
        launches = all_counts()
        flushes, buckets, occupancy = serve_window(m_before, obs.to_json(), stream)
        # the window's searcher calls: its flushes and the swap's warm ladder
        calls = flushes + len(swap_rep["warm"][k])
        n_req = SERVE_THREADS * SERVE_PER_THREAD
        rows, ok, got_i = served_rows_equal(results, log, (serving, swap_target), pool, k)
        rec10 = recall(got_i, truth[rows])
        lat_ms = np.sort(np.array(lats)) * 1e3
        emit(phase="serve", path="ivf_pq + refine (serve_ivf_pq_100k's protocol)",
             n=N_MAIN, d=D_MAIN, n_probes=8, k0=4 * k, k=k, pipeline_depth=depth,
             threads=SERVE_THREADS, requests=n_req, max_batch=SERVE_MAX_BATCH,
             max_wait_us=SERVE_WAIT_US, qps=(n_req - len(failures)) / load_s,
             seq_qps=seq_qps, serve_over_seq=(n_req - len(failures)) / load_s / seq_qps,
             p50_ms=float(lat_ms[len(lat_ms) // 2]),
             p99_ms=float(lat_ms[int(len(lat_ms) * 0.99) - 1]),
             mean_batch_occupancy=occupancy, flushes=flushes, flushes_by_bucket=buckets,
             launches=launches, search_calls=calls,
             launches_per_search_call={kk: v / calls for kk, v in launches.items() if v},
             swap={"failed": len(failures), "version": swap_rep["version"],
                   "warm": swap_rep["warm"][k]},
             builds_in_window=rec.summary(), first_publish_warm=first["warm"][k],
             staging=svc.staging_stats(), checked_rows=len(rows),
             rows_equal_direct_search=int(ok.sum()), recall_at_10=rec10,
             recall_floor=IVF_RECALL_FLOOR, card=st["card"])
        assert not failures, failures[:5]
        assert len(lats) == n_req
        assert rec.programs == 0 and rec.cache_misses == 0 and rec.cache_hits == 0, (
            rec.summary())
        assert bool(ok.all()), (f"{int((~ok).sum())} served rows differ from the direct "
                                f"search: rows {[rows[r] for r in torch.nonzero(~ok)[:5, 0]]}")
        assert rec10 >= IVF_RECALL_FLOOR, f"recall@10 {rec10} below {IVF_RECALL_FLOOR}"
        assert launches["pq_scan_topk"] > 0, "the served path did not launch pq_scan_topk"
        add_serve_launches(st, launches)
        if depth == 2:
            other = serve_other_kinds(st, svc, log)
        svc.shutdown()
        assert svc.registry.live_versions("serve") == (2,)

    profiles = {"ivf_pq+refine": flush_profile(st, "ivf_pq_refine", serving, pool, k),
                **other}
    emit(phase="serve_flush", per_kind=profiles, card=st["card"])
    emit(phase="serve_launches", launches=st["launches_serve"], card=st["card"])


def serve_other_kinds(st, svc, log):
    """Brute force, IVF-Flat and CAGRA on the running service: publish each,
    serve ``SERVE_OTHER_THREADS x SERVE_OTHER_PER_THREAD`` one-row requests,
    hold the answers against the index's direct search of each row at the
    shape that served it (CAGRA, whose entry pool is drawn per batch, by
    recall@10). Returns each kind's flush profile."""
    import numpy as np
    import torch

    from raft_tpu_torch import obs
    from raft_tpu_torch.core import Resources
    from raft_tpu_torch.neighbors import brute_force, cagra
    from raft_tpu_torch.obs import compile as obs_compile

    res = Resources(device="cuda")
    x, qm = st["main"]
    cindex, qc = st["cagra"]
    findex, fsp = st["ivf_flat"]
    csp = cagra.SearchParams(itopk_size=CAGRA_ITOPK)
    kinds = {
        "brute_force": (brute_force.BruteForce("sqeuclidean").build(x, res=res), None, qm,
                        None),
        "ivf_flat": (findex, fsp, qc, None),
        "cagra": (cindex, csp, qc, st["cagra_truth"]),
    }
    n_req = SERVE_OTHER_THREADS * SERVE_OTHER_PER_THREAD
    profiles = {}
    for name, (ix, params, queries, truth) in kinds.items():
        pool = queries[:n_req].cpu().numpy()
        first = svc.publish(name, ix, search_params=params, k=K_MAIN)
        with svc.registry.lease(name) as v:
            searcher = v.searcher
        m_before = obs.to_json()
        reset_all_counts()
        with obs_compile.attribution() as rec:
            lats, results, failures, load_s, _ = serve_load(
                svc, name, pool, SERVE_OTHER_THREADS, SERVE_OTHER_PER_THREAD, K_MAIN, n_req)
        torch.cuda.synchronize()
        launches = {kk: v for kk, v in all_counts().items() if v}
        add_serve_launches(st, launches)
        flushes, buckets, occupancy = serve_window(m_before, obs.to_json(), f"{name}.k{K_MAIN}")
        rows, ok, got_i = served_rows_equal(results, log, (searcher,), pool, K_MAIN)
        lat_ms = np.sort(np.array(lats)) * 1e3
        out = dict(phase="serve", path=name, requests=n_req, threads=SERVE_OTHER_THREADS,
                   qps=(n_req - len(failures)) / load_s,
                   p50_ms=float(lat_ms[len(lat_ms) // 2]),
                   p99_ms=float(lat_ms[int(len(lat_ms) * 0.99) - 1]), flushes=flushes,
                   flushes_by_bucket=buckets, mean_batch_occupancy=occupancy,
                   launches=launches,
                   launches_per_flush={kk: v / flushes for kk, v in launches.items()},
                   builds_in_window=rec.summary(), first_publish_warm=first["warm"][K_MAIN],
                   failed=len(failures), checked_rows=len(rows),
                   rows_equal_direct_search=int(ok.sum()), card=st["card"])
        if truth is not None:
            out.update(recall_at_10=recall(got_i, truth[rows]),
                       recall_floor=CAGRA_RECALL_FLOOR)
        emit(**out)
        assert not failures, failures[:5]
        assert rec.programs == 0 and rec.cache_misses == 0 and rec.cache_hits == 0, (
            rec.summary())
        if truth is None:
            assert bool(ok.all()), f"{name}: {int((~ok).sum())} served rows differ"
        else:
            assert out["recall_at_10"] >= CAGRA_RECALL_FLOOR, out["recall_at_10"]
        if name == "brute_force":
            back_to_back(svc, searcher, qm)
        profiles[name] = flush_profile(st, name, searcher, pool, K_MAIN)
    return profiles


def back_to_back(svc, searcher, queries, blocks=20):
    """Full 64-row buckets submitted back to back, faster than they flush:
    the pipelined path rewrites each bucket's pinned staging buffers
    several times over, and every answer must equal the direct search of
    its block (a buffer rewritten before its upload landed would not)."""
    import torch

    dev = torch.device("cuda")
    pool = queries[:blocks * SERVE_MAX_BATCH].cpu().numpy()
    futs = [svc.submit("brute_force", pool[b * SERVE_MAX_BATCH:(b + 1) * SERVE_MAX_BATCH],
                       K_MAIN) for b in range(blocks)]
    got = [f.result(timeout=120) for f in futs]
    got_d = torch.cat([torch.from_numpy(d) for d, _ in got]).to(dev)
    got_i = torch.cat([torch.from_numpy(i) for _, i in got]).to(dev)
    ref = [searcher(pool[b * SERVE_MAX_BATCH:(b + 1) * SERVE_MAX_BATCH], K_MAIN)
           for b in range(blocks)]
    ok = row_equiv(got_d, got_i, torch.cat([r[0] for r in ref]), torch.cat([r[1] for r in ref]))
    emit(phase="serve_back_to_back", blocks=blocks, rows_per_block=SERVE_MAX_BATCH,
         rows_equal_direct_search=int(ok.sum()), rows=int(ok.numel()),
         staging=svc.staging_stats().get(f"brute_force.k{K_MAIN}"))
    assert bool(ok.all()), f"{int((~ok).sum())} rows of back-to-back buckets differ"


# -- phase 5: the write path (raft_tpu_torch.stream behind the service) ----------

STREAM_CAP, STREAM_FILL = 4096, 0.75                    # bench.py:1122 _row_serve_churn
STREAM_STEPS, STREAM_UPSERTS, STREAM_DELETES = 64, 96, 32
CAGRA_CHURN_N, CAGRA_CHURN_STEPS = 100_000, 48          # bench.py:1187 _row_serve_churn_cagra
STREAM_THREADS = 8
STREAM_EVAL = 1_000             # recall@10 queries through the service after the first fold
STREAM_RYW = 4                  # rows just upserted, searched after each write step
STREAM_RECALL_GAP = 0.01        # the JAX rows' recall_gap bound (bench.py:1135-1138)
STREAM_DELETED = 0.03           # share of ids the pq_scan_topk check tombstones


def churn_window(st, svc, name, m, comp, pool, fresh, n0, steps, eval_q, key="stream"):
    """The churn protocol of bench.py's ``_serve_churn_impl`` (bench.py:1217)
    on a published ``MutableIndex``: ``STREAM_THREADS`` closed-loop reader
    threads send one-row queries from ``pool`` while one writer runs
    ``steps`` steps of ``STREAM_UPSERTS`` upserts (rows ``fresh``, fresh ids
    from ``n0`` on) and ``STREAM_DELETES`` deletes of random live ids, and
    calls ``comp.run_once()`` at the watermark. After each step a search for
    ``STREAM_RYW`` of the rows just upserted must return each one's id at
    rank 0; right after the first fold ``eval_q`` is searched through the
    service and the live ids are recorded. The whole window runs under the
    launch counters (set to 0 just before) and build attribution; the
    launches the folds make on the writer thread (``launch_tally``) are
    reported apart from the window's total, which also holds the reads
    other threads served meanwhile; both add into ``st``'s
    ``launches_<key>`` totals. Returns what the window measured; every read
    is checked afterwards for ids deleted before it was submitted."""
    import threading

    import numpy as np
    import torch

    from raft_tpu_torch.obs import compile as obs_compile
    from raft_tpu_torch.ops._build import launch_tally

    rng = np.random.default_rng(14)
    k = K_MAIN
    alive = np.zeros(n0 + steps * STREAM_UPSERTS, bool)
    alive[:n0] = True
    deleted_at = np.full(alive.shape[0], np.inf)
    done = threading.Event()
    lock = threading.Lock()
    lats, reads, failures, ryw_bad, reports, snap, folds = [], [], [], [], [], {}, []
    uploaded0 = m.uploaded_bytes

    def ask(queries):
        return svc.submit(name, queries, k).result(timeout=120)

    def reader(tid):
        my_l, my_r, j = [], [], 0
        while not done.is_set():
            qi = (tid + j * STREAM_THREADS) % pool.shape[0]
            j += 1
            t0 = time.perf_counter()
            try:
                _, i = ask(pool[qi:qi + 1])
            except Exception as e:  # every loss is counted and fails the phase
                with lock:
                    failures.append(f"{type(e).__name__}: {str(e)[:120]}")
                continue
            my_l.append((t0, time.perf_counter() - t0))
            my_r.append((t0, i[0]))
        with lock:
            lats.extend(my_l)
            reads.extend(my_r)

    reset_all_counts()
    write_calls_s, fold_bytes, fold_launches = 0.0, 0, {}
    with obs_compile.attribution() as rec:
        workers = [threading.Thread(target=reader, args=(t,)) for t in range(STREAM_THREADS)]
        t_load = time.perf_counter()
        for w in workers:
            w.start()
        t_write = time.perf_counter()
        for step in range(steps):
            lo = step * STREAM_UPSERTS
            ids = n0 + np.arange(lo, lo + STREAM_UPSERTS)
            t0 = time.perf_counter()
            svc.upsert(name, fresh[lo:lo + STREAM_UPSERTS], ids=ids)
            cand = np.flatnonzero(alive)
            dels = rng.choice(cand, STREAM_DELETES, replace=False)
            alive[ids] = True
            svc.delete(name, dels)
            t1 = time.perf_counter()
            write_calls_s += t1 - t0
            deleted_at[dels] = t1
            alive[dels] = False
            probe = rng.choice(STREAM_UPSERTS, STREAM_RYW, replace=False)
            t0 = time.perf_counter()
            _, got = ask(fresh[lo + probe])
            reads.extend((t0, r) for r in got)
            if got[:, 0].tolist() != ids[probe].tolist():
                ryw_bad.append((step, got[:, 0].tolist(), ids[probe].tolist()))
            while comp.due():
                u0, f0 = m.uploaded_bytes, time.perf_counter()
                with launch_tally() as tally:
                    reports.append(comp.run_once())
                folds.append((f0, time.perf_counter()))
                add_counts(fold_launches, tally_counts(tally))
                fold_bytes += m.uploaded_bytes - u0
                if len(reports) == 1:
                    snap["ids"] = np.concatenate([ask(eval_q[b:b + SERVE_MAX_BATCH])[1]
                                                  for b in range(0, eval_q.shape[0],
                                                                 SERVE_MAX_BATCH)])
                    snap["live"] = np.flatnonzero(alive)
        write_s = time.perf_counter() - t_write
        done.set()
        for w in workers:
            w.join(600)
            assert not w.is_alive(), "a reader thread did not finish"
        load_s = time.perf_counter() - t_load
    torch.cuda.synchronize()
    launches = all_counts()
    # deletes stay invisible: no read submitted after a delete returned
    # holds its id (ids are never upserted again)
    late = [(t, [int(g) for g in i if g >= 0 and deleted_at[g] < t]) for t, i in reads]
    late = [x for x in late if x[1]]
    lat_ms = np.sort(np.array([dt for _, dt in lats])) * 1e3
    # the reads that overlapped a fold (submitted before it ended, answered
    # after it began) apart from the rest
    during = [dt for t, dt in lats if any(t < f1 and t + dt > f0 for f0, f1 in folds)]
    clear = np.sort(np.array([dt for t, dt in lats
                              if not any(t < f1 and t + dt > f0 for f0, f1 in folds)])) * 1e3
    out = dict(reads=len(lats), qps=len(lats) / load_s, p50_ms=float(lat_ms[len(lat_ms) // 2]),
               p99_ms=float(lat_ms[int(len(lat_ms) * 0.99) - 1]),
               reads_during_folds=len(during),
               max_ms_during_folds=max(during, default=0.0) * 1e3,
               p50_ms_outside_folds=float(clear[len(clear) // 2]),
               p99_ms_outside_folds=float(clear[int(len(clear) * 0.99) - 1]),
               write_rows_per_s=steps * (STREAM_UPSERTS + STREAM_DELETES) / write_s,
               write_call_rows_per_s=steps * (STREAM_UPSERTS + STREAM_DELETES) / write_calls_s,
               compactions=len(reports),
               compaction_wall_s=[r["wall_s"] for r in reports],
               compaction_compile_s=[r["compile_s"] for r in reports],
               folded_rows=[r["folded"] for r in reports], modes=[r["mode"] for r in reports],
               fold_shards=[r.get("shard") for r in reports],
               uploaded_bytes_per_step=(m.uploaded_bytes - uploaded0 - fold_bytes) / steps,
               uploaded_bytes_per_fold=fold_bytes / max(len(reports), 1),
               failed=len(failures), ryw_failures=len(ryw_bad), deleted_ids_seen=len(late),
               checked_reads=len(reads), builds_in_window=rec.summary(),
               launches={kk: v for kk, v in launches.items() if v},
               launches_folds=fold_launches)
    assert not failures, failures[:5]
    assert not ryw_bad, ryw_bad[:3]
    assert not late, late[:3]
    assert rec.programs == 0 and rec.cache_misses == 0 and rec.cache_hits == 0, rec.summary()
    assert reports, "the writer never reached the compaction watermark"
    add_counts(st.setdefault(f"launches_{key}", {}), launches)
    add_counts(st.setdefault(f"launches_{key}_folds", {}), fold_launches)
    return out, snap


def tally_counts(tally):
    """A ``launch_tally`` dict under ``all_counts``' names (mode f32's
    launches also under their route's)."""
    out = {}
    for (name, mode, route), v in tally.items():
        names = [name]
        if name == "fused_knn":
            names = ["fused_knn", f"fused_knn_{route}"] if mode == "f32" else ["fused_knn_tc"]
        for nm in names:
            out[nm] = out.get(nm, 0) + v
    return out


def add_counts(total, counts):
    for kk, v in counts.items():
        if v:
            total[kk] = total.get(kk, 0) + v


def churn_recall(snap, rows_of, eval_q, fresh_search):
    """recall@10 of the service's answers right after the first fold and of
    a fresh build over exactly the live rows of that instant, both against
    the live rows' exact neighbours (bench.py:1395-1412)."""
    import numpy as np
    import torch

    from raft_tpu_torch.core import Resources
    from raft_tpu_torch.neighbors import brute_force

    live = snap["live"]
    rows = rows_of(torch.from_numpy(live).to("cuda"))
    qd = torch.as_tensor(eval_q, device="cuda")
    _, pos = brute_force.knn(rows, qd, K_MAIN, res=Resources(device="cuda"))
    truth = torch.from_numpy(live).to("cuda")[pos.long()]
    got = torch.from_numpy(snap["ids"]).to("cuda").long()
    _, fpos = fresh_search(rows, qd)
    fresh_ids = torch.where(fpos >= 0, torch.from_numpy(live).to("cuda")[fpos.clamp_min(0).long()],
                            -1)
    del rows
    return recall(got, truth), recall(fresh_ids, truth)


@contextlib.contextmanager
def uncounted():
    """Launches made inside (comparisons with plain versions, ground truth)
    leave every kernel's launch count as it was."""
    from raft_tpu_torch.ops.cagra_hop import cagra_hop
    from raft_tpu_torch.ops.fused_knn import bf16_split, fused_knn, tf32_split
    from raft_tpu_torch.ops.pq_scan import pq_scan, pq_scan_topk
    from raft_tpu_torch.ops.topk import topk

    fns = (fused_knn, bf16_split, tf32_split, topk, pq_scan, pq_scan_topk, cagra_hop)
    saved = ([fn.launches for fn in fns], dict(fused_knn.launches_by_mode),
             dict(fused_knn.launches_by_route))
    try:
        yield
    finally:
        for fn, n in zip(fns, saved[0]):
            fn.launches = n
        fused_knn.launches_by_mode, fused_knn.launches_by_route = saved[1], saved[2]


def stream_pq_check(st, index, words, tiles, what):
    """``pq_scan_topk`` under the tombstone bitset ``words`` (packed as the
    mutable index packs it) on ``index``, one call per query tile of
    ``tiles`` (n_probes 8, bf16 LUT, k = 10, the churn's search), against the
    plain version bit for bit; no slot whose bit is clear may come back."""
    import torch

    from raft_tpu_torch.distance.pairwise import full_f32
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.ops.pq_scan import pq_scan_topk, pq_scan_topk_plain

    with uncounted():
        for qt in tiles:
            probes = ivf_pq._coarse_probes(index, qt, 8).to(torch.int64)
            with full_f32():
                qrot = qt @ index.rotation.T
            lut, bias = ivf_pq._probe_luts(index, qrot, probes, *ivf_pq._codebooks_f32(index))
            args = (index.list_codes, index.list_ids, probes.to(torch.int32).contiguous(),
                    lut.to(torch.bfloat16).contiguous(), bias.contiguous(), K_MAIN, True)
            kv, ki = pq_scan_topk(*args, keep_words=words)
            pv, pi = pq_scan_topk_plain(*args, keep_words=words)
            assert torch.equal(kv.view(torch.int32), pv.view(torch.int32)) and torch.equal(
                ki, pi), f"pq_scan_topk differs from its plain version ({what}, T={qt.shape[0]})"
            got = ki[ki >= 0].long()
            assert bool(((words[got >> 5] >> (got & 31)) & 1).bool().all()), \
                f"a tombstoned id came back ({what}, T={qt.shape[0]})"
    n = index.max_stored_id + 1
    bits = ((words[:, None] >> torch.arange(32, device=words.device, dtype=torch.int32)) & 1)
    kept = int(bits.reshape(-1)[:n].sum())
    emit(phase="check", kernel="pq_scan_topk", what=what, n_lists=index.n_lists,
         cap=index.capacity, S=int(index.list_codes.shape[2]), T=[int(t.shape[0]) for t in tiles],
         pc=8, k=K_MAIN, lut_dtype="bfloat16", ids=n, deleted=n - kept,
         deleted_share=(n - kept) / n, max_abs_err=0.0, bit_equal=True, ok=True, stream=True)


def stream_fused_check(st, m, q):
    """``fused_knn`` over the mutable index's 4,096-row delta bucket with its
    keep mask, at m = 1, 8 and 64, against the plain version (knn_equiv at
    1e-5)."""
    import torch

    from raft_tpu_torch.ops.fused_knn import fused_knn, fused_knn_plain

    rows, dkeep, _, b = m._state.delta_view
    assert b == STREAM_CAP, b
    err = 0.0
    with uncounted():
        for mm in (1, 8, 64):
            before = f32_route_counts()
            dv, di = fused_knn(rows, q[:mm], K_MAIN, keep_mask=dkeep)
            torch.cuda.synchronize()
            assert f32_route_counts() == dict(before, rows=before["rows"] + 1), before
            rd, ri = fused_knn_plain(rows, q[:mm], K_MAIN, keep_mask=dkeep)
            err = max(err, knn_equiv(dv, di, rd, ri, rtol=1e-5, atol=1e-5))
    emit(phase="check", kernel="fused_knn", n=b, d=D_MAIN, m=[1, 8, 64], k=K_MAIN, mode="f32",
         route="rows", kept=int(dkeep.sum()), max_abs_err=err, tolerance=1e-5, ok=True,
         stream=True)
    errs = st.setdefault("f32_err", {})
    errs["rows"] = max(errs.get("rows", 0.0), err)


def stream_bf_exact(st):
    """Brute force behind the write path, exact: ``MutableIndex`` over the
    1M x 128 uniform set (phase 2's) with ``delta_capacity=4096``, a fixed
    seeded write script (upserts of fresh rows and of existing ids, deletes
    of sealed and delta ids) that takes the delta across the 2,048 -> 4,096
    bucket (the delta scan moves from the GEMM route to ``fused_knn``), then
    a rebuild compaction; 1,000 queries searched at bucket 2,048, at 4,096
    and after the rebuild must give the ids of a fresh ``knn`` over exactly
    the live rows (rows whose ids differ only at distances tied within 1e-5
    are counted apart, as in ``knn_equiv``). ``fused_knn`` is checked
    against its plain version on the 4,096-row delta before the rebuild."""
    import numpy as np
    import torch

    from raft_tpu_torch import stream
    from raft_tpu_torch.core import Resources
    from raft_tpu_torch.neighbors import brute_force
    from raft_tpu_torch.ops._build import launch_tally

    res = Resources(device="cuda")
    x, q = st["main"]
    q = q[:1000]
    g = torch.Generator(device="cuda").manual_seed(50)
    fresh = torch.rand((3_000, D_MAIN), generator=g, device="cuda")
    fresh_h = fresh.cpu().numpy()
    rng = np.random.default_rng(51)
    m = stream.MutableIndex(brute_force.BruteForce("sqeuclidean").build(x, res=res),
                            delta_capacity=STREAM_CAP, name="bf_exact")
    sealed_alive = np.ones(N_MAIN, bool)
    delta = []                              # (id, fresh row) in upsert order

    def upsert(js, ids):
        m.upsert(fresh_h[js], ids=ids)
        for gid in ids:
            if gid < N_MAIN:
                sealed_alive[gid] = False
        dead = set(int(i) for i in ids)
        delta[:] = [(i, r) for i, r in delta if i not in dead] + list(zip(ids, js))

    def delete(ids):
        m.delete(ids)
        dead = set(int(i) for i in ids)
        sealed_alive[[i for i in dead if i < N_MAIN]] = False
        delta[:] = [(i, r) for i, r in delta if i not in dead]

    def check(label):
        with uncounted():                   # the fresh knn is the reference
            live_ids = np.concatenate([np.flatnonzero(sealed_alive),
                                       np.array([i for i, _ in delta], np.int64)])
            rows = torch.cat([x[torch.from_numpy(np.flatnonzero(sealed_alive)).to("cuda")],
                              fresh[torch.tensor([r for _, r in delta], device="cuda")]])
            rd, rp = brute_force.knn(rows, q, K_MAIN, res=res)
            ri = torch.from_numpy(live_ids).to("cuda")[rp.long()].to(torch.int32)
            del rows
        before = all_counts()["fused_knn"]
        d, i = m.search(q, K_MAIN)
        torch.cuda.synchronize()
        ok = row_equiv(d, i, rd, ri)
        out = dict(delta_bucket=m.stats()["delta_bucket"], live=int(live_ids.size),
                   rows_ids_equal=int((i == ri).all(1).sum()), rows_equiv=int(ok.sum()),
                   fused_knn_launches=all_counts()["fused_knn"] - before)
        assert m.size == live_ids.size
        assert bool(ok.all()), f"{label}: {int((~ok).sum())} rows differ from a fresh knn"
        return out

    n_new = 0
    for step in range(4):                   # 4 x 500 rows: bucket 2,048
        upsert(np.arange(n_new, n_new + 500), N_MAIN + np.arange(n_new, n_new + 500))
        n_new += 500
        delete(rng.choice(N_MAIN, 100, replace=False))
    upsert(np.arange(n_new, n_new + 8), np.array([3, 17, N_MAIN + 5, N_MAIN + 900, 40, 41,
                                                  N_MAIN + 1999, 999_999]))
    n_new += 8
    delete(np.array([N_MAIN + 7, N_MAIN + 100, 12, 10 ** 7]))
    out = {"at_2048": check("bucket 2048")}
    upsert(np.arange(n_new, n_new + 600), N_MAIN + 2000 + np.arange(600))
    n_new += 600
    delete(rng.choice(N_MAIN + 2600, 150, replace=False))
    out["at_4096"] = check("bucket 4096")
    # the delta scan moved onto fused_knn at the 4,096-row bucket
    assert (out["at_4096"]["fused_knn_launches"]
            == out["at_2048"]["fused_knn_launches"] + 1), out
    stream_fused_check(st, m, q)
    t0 = time.perf_counter()
    with launch_tally() as tally:
        rep = m.compact("rebuild")
    out["rebuild"] = dict(wall_s=time.perf_counter() - t0, reclaimed=rep["reclaimed"],
                          folded=rep["folded"], launches=tally_counts(tally))
    out["after_rebuild"] = check("after the rebuild")
    return out


def phase_stream(st):
    """Phase 5: ``raft_tpu_torch.stream`` behind ``SearchService.upsert`` /
    ``delete``, after phase 4 on phase 2's indexes and data. The IVF-PQ
    churn row (``serve_churn_ivf_pq_100k``'s protocol on the 1M IVF-PQ
    index: ``MutableIndex(delta_capacity=4096, retain_vectors=False)`` on a
    ``SearchService(max_batch=64, max_wait_us=2000)`` with a
    ``Compactor(CompactionPolicy(delta_fill=0.75))``, 8 reader threads, 64
    writer steps of 96 upserts (fresh rows of phase 2's blobs) and 32
    deletes of random live ids, extend folds at the watermark); brute force
    over the 1M uniform set, exact across the 4,096 bucket and a rebuild;
    the CAGRA churn row (``serve_churn_cagra_100k``: 100k x 128 clustered,
    ``IndexParams(seed=0)``, itopk 32, 48 writer steps, rebuild folds); and
    the kernels at the churn's shapes. Asserted: no failed request and no
    kernel build in each loaded window, read-your-writes after every write
    step, no deleted id in a read submitted after its delete returned, at
    least 2 folds in the IVF-PQ window, and recall@10 through the service
    right after the first fold within 0.01 of a fresh build over the same
    live rows (IVF-PQ and CAGRA)."""
    import numpy as np
    import torch

    from raft_tpu_torch import stream
    from raft_tpu_torch.core import Resources
    from raft_tpu_torch.neighbors import cagra, ivf_pq
    from raft_tpu_torch.ops.pq_scan import pack_keep_words
    from raft_tpu_torch.serve import SearchService

    t_phase = time.perf_counter()
    res = Resources(device="cuda")
    index, q = st["ivf"]
    x, centers = st["ivf_x"], st["ivf_centers"]
    sp = ivf_pq.SearchParams(n_probes=8, lut_dtype="bfloat16")
    params = ivf_pq.IndexParams(n_lists=1024, pq_bits=4, pq_dim=64, seed=0)
    policy = stream.CompactionPolicy(delta_fill=STREAM_FILL, tombstone_ratio=None,
                                     max_age_s=None)
    n_up = STREAM_STEPS * STREAM_UPSERTS
    fresh, _ = blobs(n_up, centers, 13)
    pool = q[:STREAM_EVAL + 2048].cpu().numpy()
    eval_q = pool[:STREAM_EVAL]

    # ---- IVF-PQ churn on the 1M index -------------------------------------------
    t0 = time.perf_counter()
    m = stream.MutableIndex(index, search_params=sp, delta_capacity=STREAM_CAP,
                            retain_vectors=False, name="churn")
    wrap_s = time.perf_counter() - t0
    svc = SearchService(max_batch=SERVE_MAX_BATCH, max_wait_us=SERVE_WAIT_US,
                        max_queue_rows=4 * SERVE_MAX_BATCH * STREAM_THREADS)
    first = svc.publish("churn", m, k=K_MAIN)
    warm = m.warm(svc.buckets, ks=(K_MAIN,))
    comp = stream.Compactor(m, publisher=svc, name="churn", ks=(K_MAIN,), policy=policy)
    all_rows = torch.cat([x, fresh])
    out, snap = churn_window(st, svc, "churn", m, comp, pool, fresh.cpu().numpy(),
                             N_MAIN, STREAM_STEPS, eval_q)
    # the flush profile at a 4,096-row delta bucket (the window ended on a
    # fold), where the delta scan is a fused_knn launch
    m.upsert(blobs(3_000, centers, 15)[0].cpu().numpy())
    profile = flush_profile(st, "stream_ivf_pq", m.searcher(), pool, K_MAIN,
                            buckets=(8, SERVE_MAX_BATCH))
    svc.shutdown()
    # the filtered kernel at the churn's own shapes: the sealed index as the
    # folds extended it, with its live tombstone words, at T = 1 (a reader),
    # 4 (a read-your-writes probe of the last step's rows) and 64 (a full
    # bucket)
    fst = m._state
    assert fst.epoch == out["compactions"] and fst.sealed.size > N_MAIN, (fst.epoch, out)
    pool_d = torch.as_tensor(pool, device="cuda")
    stream_pq_check(st, fst.sealed, fst.sealed_keep_dev.words,
                    [pool_d[:1], fresh[-STREAM_UPSERTS:][:STREAM_RYW], pool_d[:SERVE_MAX_BATCH]],
                    f"churn index after {fst.epoch} folds")
    del fst, pool_d
    rec_mut, rec_fresh = churn_recall(
        snap, lambda live: all_rows[live], eval_q,
        lambda rows, qd: ivf_pq.search(sp, ivf_pq.build(params, rows, res=res), qd, K_MAIN,
                                       res=res))
    emit(phase="stream", path="ivf_pq churn (serve_churn_ivf_pq_100k's protocol)", n=N_MAIN,
         d=D_MAIN, n_lists=1024, pq_dim=64, pq_bits=4, n_probes=8, lut_dtype="bfloat16",
         k=K_MAIN, delta_capacity=STREAM_CAP, compact_fill=STREAM_FILL,
         threads=STREAM_THREADS, writer_steps=STREAM_STEPS, upserts_per_step=STREAM_UPSERTS,
         deletes_per_step=STREAM_DELETES, wrap_seconds=wrap_s, first_publish=first["warm"],
         delta_warm={b: v for b, v in warm[K_MAIN].items()}, **out,
         recall_at_10=rec_mut, recall_fresh_build=rec_fresh, recall_gap=rec_mut - rec_fresh,
         recall_gap_floor=-STREAM_RECALL_GAP, eval_queries=STREAM_EVAL, card=st["card"])
    emit(phase="stream_flush", index="ivf_pq (MutableIndex), 4,096-row delta bucket",
         delta_rows=m.stats()["delta_rows"], per_bucket=profile, card=st["card"])
    assert out["compactions"] >= 2, out["compactions"]
    assert rec_mut >= rec_fresh - STREAM_RECALL_GAP, (rec_mut, rec_fresh)
    assert out["launches"].get("pq_scan_topk", 0) > 0 and out["launches"].get("fused_knn", 0) > 0
    del all_rows, fresh, snap, comp, svc, m

    # ---- brute force, exact across the 4,096 bucket and a rebuild ---------------
    reset_all_counts()
    bf_out = stream_bf_exact(st)
    bf_launches = all_counts()
    add_counts(st.setdefault("launches_stream", {}), bf_launches)
    add_counts(st.setdefault("launches_stream_folds", {}), bf_out["rebuild"]["launches"])
    emit(phase="stream", path="brute_force exact (MutableIndex over 1M x 128)", n=N_MAIN,
         d=D_MAIN, k=K_MAIN, queries=1000, delta_capacity=STREAM_CAP,
         launches={kk: v for kk, v in bf_launches.items() if v}, **bf_out, card=st["card"])
    g = torch.Generator(device="cuda").manual_seed(31)
    keep = torch.rand(N_MAIN, generator=g, device="cuda") >= STREAM_DELETED
    words = torch.from_numpy(stream.mutable._pack_words(keep.cpu().numpy())).to("cuda")
    assert torch.equal(words, pack_keep_words(keep)), "host packing differs from the kernel's"
    stream_pq_check(st, index, words, [q[:128], q[128 * 40:128 * 41]],
                    f"phase 2's index, {STREAM_DELETED:.0%} deleted")

    # ---- CAGRA churn at 100k ----------------------------------------------------
    dev = torch.device("cuda")
    ccent = 10.0 * torch.rand((CAGRA_CENTERS, D_MAIN), device=dev,
                              generator=torch.Generator(device=dev).manual_seed(23))
    n_cup = CAGRA_CHURN_STEPS * STREAM_UPSERTS
    cx, _ = blobs(CAGRA_CHURN_N + n_cup, ccent, 24, 0.5)
    cq, _ = blobs(STREAM_EVAL + 2048, ccent, 25, 0.5)
    cparams = cagra.IndexParams(seed=0)
    csp = cagra.SearchParams(itopk_size=CAGRA_ITOPK)
    t0 = time.perf_counter()
    cindex = cagra.build(cparams, cx[:CAGRA_CHURN_N], res=res)
    torch.cuda.synchronize()
    cbuild_s = time.perf_counter() - t0
    cm = stream.MutableIndex(cindex, search_params=csp, index_params=cparams,
                             delta_capacity=STREAM_CAP, name="churn_cagra")
    svc = SearchService(max_batch=SERVE_MAX_BATCH, max_wait_us=SERVE_WAIT_US,
                        max_queue_rows=4 * SERVE_MAX_BATCH * STREAM_THREADS)
    svc.publish("churn_cagra", cm, k=K_MAIN)
    cm.warm(svc.buckets, ks=(K_MAIN,))
    comp = stream.Compactor(cm, publisher=svc, name="churn_cagra", ks=(K_MAIN,), policy=policy)
    cpool = cq.cpu().numpy()
    cout, csnap = churn_window(st, svc, "churn_cagra", cm, comp, cpool,
                               cx[CAGRA_CHURN_N:].cpu().numpy(), CAGRA_CHURN_N,
                               CAGRA_CHURN_STEPS, cpool[:STREAM_EVAL])
    svc.shutdown()
    crec_mut, crec_fresh = churn_recall(
        csnap, lambda live: cx[live], cpool[:STREAM_EVAL],
        lambda rows, qd: cagra.search(csp, cagra.build(cparams, rows, res=res), qd, K_MAIN))
    emit(phase="stream", path="cagra churn (serve_churn_cagra_100k's protocol)",
         n=CAGRA_CHURN_N, d=D_MAIN, itopk=CAGRA_ITOPK, k=K_MAIN, build_seconds=cbuild_s,
         delta_capacity=STREAM_CAP, compact_fill=STREAM_FILL, threads=STREAM_THREADS,
         writer_steps=CAGRA_CHURN_STEPS, upserts_per_step=STREAM_UPSERTS,
         deletes_per_step=STREAM_DELETES, **cout, recall_at_10=crec_mut,
         recall_fresh_build=crec_fresh, recall_gap=crec_mut - crec_fresh,
         recall_gap_floor=-STREAM_RECALL_GAP, eval_queries=STREAM_EVAL, card=st["card"])
    assert crec_mut >= crec_fresh - STREAM_RECALL_GAP, (crec_mut, crec_fresh)
    assert cout["launches"].get("cagra_hop", 0) > 0
    emit(phase="stream_launches", launches=st["launches_stream"],
         launches_folds=st["launches_stream_folds"], seconds=time.perf_counter() - t_phase,
         card=st["card"])


# -- phase 6: the out-of-core build (core.chunked, the streamed builds) ----------

OOC_CHUNK = 65_536                  # DEFAULT_CHUNK_ROWS: 16 chunks of the 1M sets
OOC_FLAT_N, OOC_FLAT_CHUNK = 10_000_000, 262_144   # BIGANN-10M's shape, d 128 uint8
OOC_FLAT_Q, OOC_PLAN_SLACK = 1_000, 1.2
OOC_FLAT_PARAMS = dict(n_lists=1024, kmeans_n_iters=4, kmeans_trainset_fraction=0.02, seed=0)


@contextlib.contextmanager
def stager_stats():
    """Collect each ChunkStager's stats as it is released (the builds own
    their stagers)."""
    from raft_tpu_torch.core import chunked

    out = []
    release = chunked.ChunkStager.release

    def hooked(self):
        if self._mem is not None:
            out.append(self.stats())
        release(self)

    chunked.ChunkStager.release = hooked
    try:
        yield out
    finally:
        chunked.ChunkStager.release = release


def ooc_chunks():
    from raft_tpu_torch.obs import metrics

    snap = metrics.snapshot().get("raft_tpu_build_ooc_chunks_total")
    return 0 if snap is None else sum(s["value"] for s in snap["series"])


def measured_build(fn):
    """(result, seconds, ledger peak, allocator peak): the peaks above what
    was live before the call."""
    import gc

    import torch

    from raft_tpu_torch.obs import mem

    gc.collect()
    torch.cuda.synchronize()
    base_ledger = mem.totals()["device_bytes"]
    mem.reset_peak()
    torch.cuda.reset_peak_memory_stats()
    base_alloc = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return (out, secs, mem.totals()["device_peak_bytes"] - base_ledger,
            torch.cuda.max_memory_allocated() - base_alloc)


def assert_same_index(a, b, what):
    import dataclasses

    import torch

    if not dataclasses.is_dataclass(a):
        a, b = {"dataset": a.dataset}, {"dataset": b.dataset}
    else:
        a = {f.name: getattr(a, f.name) for f in dataclasses.fields(a)}
        b = {f.name: getattr(b, f.name) for f in dataclasses.fields(b)}
    bad = [k for k, v in a.items() if isinstance(v, torch.Tensor)
           and not (v.shape == b[k].shape and v.dtype == b[k].dtype and torch.equal(v, b[k]))]
    assert not bad, f"{what}: the streamed and in-core builds differ in {bad}"


def ooc_build(st, kind, streamed_fn, incore_fn, plan, chunks):
    """Build in-core and streamed, each measured; emit the ``ooc`` line.
    Returns (in-core index, streamed index, the line's dict)."""
    incore, in_s, in_ledger, in_alloc = measured_build(incore_fn)
    c0 = ooc_chunks()
    reset_all_counts()
    with stager_stats() as stages:
        streamed, s_s, s_ledger, s_alloc = measured_build(streamed_fn)
    launches = {k: v for k, v in all_counts().items() if v}
    staged = sum(x["staged_bytes"] for x in stages)
    upload_s = sum(x["upload_seconds"] for x in stages)
    line = dict(phase="ooc", kind=kind, build_seconds_streamed=s_s, build_seconds_in_core=in_s,
                chunks=chunks, chunks_counted=ooc_chunks() - c0, stagers=len(stages),
                staged_bytes=staged, upload_seconds=upload_s,
                staged_gb_s=(staged / upload_s / 1e9) if upload_s else None,
                host_copy_seconds=sum(x["host_copy_seconds"] for x in stages),
                ledger_peak_streamed=s_ledger, ledger_peak_in_core=in_ledger,
                alloc_peak_streamed=s_alloc, alloc_peak_in_core=in_alloc,
                plan_build_peak_streamed=plan["streamed"]["build_peak_bytes"],
                plan_build_peak_in_core=plan["in_core"]["build_peak_bytes"],
                plan_host_peak_streamed=plan["streamed"]["host_peak_bytes"],
                plan_index_bytes=plan["streamed"]["index_bytes"],
                build_launches_streamed=launches, card=st["card"])
    assert line["chunks_counted"] >= chunks, line
    return incore, streamed, line


def add_ooc_launches(st, counts):
    for k, v in counts.items():
        st["launches_ooc"][k] = st["launches_ooc"].get(k, 0) + v


def time_segment_sum(st):
    """The build path's label sum (``matrix.ops.segment_sum``: a stable sort,
    a gather, ``segment_reduce``) against the ``index_add_`` it replaced,
    at a k-means step of phase 2's IVF-PQ build: 1M x 128 float32 rows into
    1,024 random lists, and at a codebook step of its encoder (262,144 rows
    x 64 subspaces of 2 dims into 64 x 16 codes). Checks the sums agree to
    float32 rounding and that the sort-based sum gives the same bits twice;
    prints both times (the sort-based sum's include its host syncs)."""
    import torch

    from raft_tpu_torch.matrix.ops import segment_sum

    x = st["ivf_x"]
    g = torch.Generator(device=x.device).manual_seed(41)
    out = {}
    for what, vals, n_seg in (
            ("kmeans_step", x, 1024),
            ("codebook_step", x[:262_144].reshape(-1, 2), 64 * 16)):
        lab = torch.randint(0, n_seg, (vals.shape[0],), generator=g, device=x.device)

        def sort_sum():
            return segment_sum(vals, lab, n_seg)

        def atomic_sum():
            return torch.zeros((n_seg, vals.shape[1]), device=x.device).index_add_(0, lab, vals)

        a, b, c = sort_sum(), sort_sum(), atomic_sum()
        assert torch.equal(a, b), what
        err = float((a - c).abs().max() / c.abs().max().clamp_min(1e-30))
        assert err < 1e-5, (what, err)
        out[what] = dict(rows=int(vals.shape[0]), cols=int(vals.shape[1]), segments=n_seg,
                         segment_sum_ms=cuda_ms(sort_sum), index_add_ms=cuda_ms(atomic_sum),
                         max_rel_diff=err)
    emit(phase="ooc", kind="segment_sum", shapes=out, card=st["card"])


def time_instrument(st):
    """Host microseconds ``@instrument`` adds to a call (the serving hooks'
    searches pay it once a flush): a no-op wrapped by it, called 20,000
    times with observability on and off."""
    from raft_tpu_torch import obs
    from raft_tpu_torch.obs.instrument import instrument

    @instrument("chip_smoke.noop", items=lambda a, kw: 1, labels=lambda a, kw: {"k": "v"})
    def noop():
        return None

    def per_call_us(n=20_000):
        noop()
        t0 = time.perf_counter()
        for _ in range(n):
            noop()
        return (time.perf_counter() - t0) / n * 1e6

    on = per_call_us()
    obs.disable()
    try:
        off = per_call_us()
    finally:
        obs.enable()
    emit(phase="ooc", kind="instrument_overhead", us_per_call_on=on, us_per_call_off=off,
         card=st["card"])


def phase_ooc(st):
    """Phase 6: the streamed builds of all four kinds against their in-core
    builds, their searches through the kernels, the stream fold and the
    budget gates (see the module docstring)."""
    import tempfile

    import numpy as np
    import torch

    from raft_tpu_torch import stream
    from raft_tpu_torch.core import Resources, chunked
    from raft_tpu_torch.neighbors import cagra, ivf_flat, ivf_pq
    from raft_tpu_torch.neighbors.brute_force import BruteForce
    from raft_tpu_torch.obs import mem
    from raft_tpu_torch.serve.errors import MemoryBudgetError

    res = Resources(device="cuda")
    dev = torch.device("cuda")
    st["launches_ooc"] = {}
    t_phase = time.perf_counter()
    reset_all_counts()
    with tempfile.TemporaryDirectory() as tmp:
        # ---- 1. IVF-PQ, 1M x 128 float32, phase 2's corpus and params ----------
        x_pq = st["ivf_x"]
        path = os.path.join(tmp, "ivf_pq.npy")
        np.save(path, x_pq.cpu().numpy())
        reader = chunked.ChunkedReader.from_file(path, chunk_rows=OOC_CHUNK)
        assert reader.n_chunks == 16
        params = st["ivf_params"]
        plan = {m: mem.plan("ivf_pq", params, N_MAIN, D_MAIN, streamed=m == "streamed",
                            chunk_rows=OOC_CHUNK) for m in ("streamed", "in_core")}
        incore, streamed, line = ooc_build(
            st, "ivf_pq", lambda: ivf_pq.build(params, reader, res=res),
            lambda: ivf_pq.build(params, x_pq, res=res), plan, 2 * reader.n_chunks)
        add_ooc_launches(st, line["build_launches_streamed"])
        assert_same_index(streamed, incore, "ivf_pq 1M")
        assert_same_index(streamed, st["ivf"][0], "ivf_pq 1M against phase 2's index")
        del incore
        q = st["ivf"][1]
        sp = ivf_pq.SearchParams(n_probes=8, lut_dtype="bfloat16")
        want = ivf_pq.search(sp, st["ivf"][0], q, IVF_K0, res=res)
        reset_all_counts()
        got = ivf_pq.search(sp, streamed, q, IVF_K0, res=res)
        torch.cuda.synchronize()
        counts = all_counts()
        add_ooc_launches(st, counts)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), \
            "the streamed IVF-PQ index searches differently"
        tiles = -(-IVF_Q // 128)
        assert counts["pq_scan_topk"] == tiles and counts["topk"] == 0, counts
        line.update(search_equal=True, search_launches=counts, m=IVF_Q, n=N_MAIN, d=D_MAIN)
        emit(**line)
        gate_reader = reader
        del streamed, got, want

        # ---- 2. IVF-Flat, 10M x 128 uint8 (BIGANN-10M's shape), raw memmap ----
        path = os.path.join(tmp, "bigann_shape.u8")
        mm = np.memmap(path, dtype=np.uint8, mode="w+", shape=(OOC_FLAT_N, D_MAIN))
        g = torch.Generator(device=dev).manual_seed(40)
        for s0 in range(0, OOC_FLAT_N, 1_000_000):
            n_b = min(1_000_000, OOC_FLAT_N - s0)
            mm[s0:s0 + n_b] = torch.randint(0, 256, (n_b, D_MAIN), generator=g, device=dev,
                                            dtype=torch.uint8).cpu().numpy()
        mm.flush()
        del mm
        reader = chunked.ChunkedReader.from_file(path, dtype=np.uint8,
                                                 shape=(OOC_FLAT_N, D_MAIN),
                                                 chunk_rows=OOC_FLAT_CHUNK)
        fparams = ivf_flat.IndexParams(**OOC_FLAT_PARAMS)
        plan = {m: mem.plan("ivf_flat", fparams, OOC_FLAT_N, D_MAIN, dtype="uint8",
                            streamed=m == "streamed", chunk_rows=OOC_FLAT_CHUNK)
                for m in ("streamed", "in_core")}
        incore, streamed, line = ooc_build(
            st, "ivf_flat", lambda: ivf_flat.build(fparams, reader, res=res),
            lambda: ivf_flat.build(fparams, reader.host_view(), res=res), plan,
            2 * reader.n_chunks)
        add_ooc_launches(st, line["build_launches_streamed"])
        assert_same_index(streamed, incore, "ivf_flat 10M uint8")
        # plan() prices n_lists lists at the capacity bound; the build's split
        # holds within 1.2 x that price (_list_utils.priced_capacity), and
        # the ledger peak is held to 1.2 x plan()
        index_bytes = sum(t.numel() * t.element_size() for t in (
            streamed.centers, streamed.list_data, streamed.list_ids, streamed.list_norms,
            streamed.list_sizes))
        line.update(index_bytes=index_bytes, ledger_over_plan=line["ledger_peak_streamed"]
                    / plan["streamed"]["build_peak_bytes"])
        assert 0 < line["ledger_peak_streamed"] <= OOC_PLAN_SLACK * plan["streamed"][
            "build_peak_bytes"], (
            "the 10M IVF-Flat streamed ledger peak is not within "
            f"{OOC_PLAN_SLACK} x plan()'s", line, streamed.n_lists, streamed.capacity)
        assert line["alloc_peak_streamed"] < line["alloc_peak_in_core"], line
        qf = torch.from_numpy(np.array(reader.take(np.arange(0, OOC_FLAT_N, OOC_FLAT_N
                                                             // OOC_FLAT_Q))))
        fsp = ivf_flat.SearchParams(n_probes=8)
        want = ivf_flat.search(fsp, incore, qf, K_MAIN, res=res)
        reset_all_counts()
        got = ivf_flat.search(fsp, streamed, qf, K_MAIN, res=res)
        torch.cuda.synchronize()
        counts = all_counts()
        add_ooc_launches(st, counts)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), \
            "the streamed IVF-Flat index searches differently"
        assert counts["topk"] > 0, counts
        line.update(search_equal=True, search_launches=counts, m=OOC_FLAT_Q, n=OOC_FLAT_N,
                    d=D_MAIN, dtype="uint8", n_lists=streamed.n_lists,
                    capacity=streamed.capacity)
        emit(**line)
        del incore, streamed, got, want, reader

        # ---- 3. CAGRA, 100k x 128: phase 5's churn corpus ------------------------
        ccent = 10.0 * torch.rand((CAGRA_CENTERS, D_MAIN), device=dev,
                                  generator=torch.Generator(device=dev).manual_seed(23))
        cx, _ = blobs(CAGRA_CHURN_N, ccent, 24, 0.5)
        cq, _ = blobs(STREAM_EVAL, ccent, 25, 0.5)
        path = os.path.join(tmp, "cagra.npy")
        np.save(path, cx.cpu().numpy())
        reader = chunked.ChunkedReader.from_file(path, chunk_rows=OOC_CHUNK)
        cparams = cagra.IndexParams(seed=0)
        plan = {m: mem.plan("cagra", cparams, CAGRA_CHURN_N, D_MAIN, streamed=m == "streamed",
                            chunk_rows=OOC_CHUNK) for m in ("streamed", "in_core")}
        incore, streamed, line = ooc_build(
            st, "cagra", lambda: cagra.build(cparams, reader, res=res),
            lambda: cagra.build(cparams, cx, res=res), plan, reader.n_chunks)
        add_ooc_launches(st, line["build_launches_streamed"])
        assert_same_index(streamed, incore, "cagra 100k")
        csp = cagra.SearchParams(itopk_size=CAGRA_ITOPK)
        want = cagra.search(csp, incore, cq, K_MAIN)
        reset_all_counts()
        got = cagra.search(csp, streamed, cq, K_MAIN)
        torch.cuda.synchronize()
        counts = all_counts()
        add_ooc_launches(st, counts)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), \
            "the streamed CAGRA index searches differently"
        assert counts["cagra_hop"] > 0, counts
        line.update(search_equal=True, search_launches=counts, m=STREAM_EVAL,
                    n=CAGRA_CHURN_N, d=D_MAIN)
        emit(**line)
        fold_reader, fold_x = reader, cx
        del incore, streamed

        # ---- 4. brute force, 1M x 128: phase 2's set, searched at m = 1 and 64 ---
        x_bf, qb = st["main"]
        path = os.path.join(tmp, "bf.npy")
        np.save(path, x_bf.cpu().numpy())
        reader = chunked.ChunkedReader.from_file(path, chunk_rows=OOC_CHUNK)
        plan = {m: mem.plan("brute_force", None, N_MAIN, D_MAIN, streamed=m == "streamed",
                            chunk_rows=OOC_CHUNK) for m in ("streamed", "in_core")}
        incore, streamed, line = ooc_build(
            st, "brute_force", lambda: BruteForce("sqeuclidean").build(reader, res),
            lambda: BruteForce("sqeuclidean").build(x_bf, res), plan, reader.n_chunks)
        assert_same_index(streamed, incore, "brute_force 1M")
        searches = {}
        for m in (1, SERVE_MAX_BATCH):
            want = incore.search(qb[:m], K_MAIN)
            reset_all_counts()
            got = streamed.search(qb[:m], K_MAIN)
            torch.cuda.synchronize()
            counts = all_counts()
            add_ooc_launches(st, counts)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), m
            assert counts["fused_knn_rows"] == 1, counts
            searches[str(m)] = counts
        line.update(search_equal=True, search_launches=searches, n=N_MAIN, d=D_MAIN)
        emit(**line)
        del incore, streamed

        # ---- 5. the fold: a MutableIndex over a reader, rebuilt out of core ------
        fp = ivf_flat.IndexParams(n_lists=256, seed=0)
        sealed = ivf_flat.build(fp, fold_reader, res=res)
        extra = blobs(2_000, ccent, 26, 0.5)[0].cpu().numpy()

        def mutable(name, dataset):
            m = stream.MutableIndex(sealed, dataset=dataset, index_params=fp, name=name,
                                    delta_capacity=STREAM_CAP)
            m.upsert(extra)
            m.delete(np.arange(0, CAGRA_CHURN_N, 97))
            return m

        m_ooc = mutable("ooc_fold", fold_reader)
        m_in = mutable("in_core_fold", fold_x.cpu().numpy())
        assert isinstance(m_ooc._state.store, np.memmap)
        c0 = ooc_chunks()
        reset_all_counts()
        t0 = time.perf_counter()
        rep_ooc = m_ooc.compact("rebuild", ooc_chunk_rows=OOC_CHUNK)
        ooc_s = time.perf_counter() - t0
        fold_counts = all_counts()
        add_ooc_launches(st, fold_counts)
        fold_chunks = ooc_chunks() - c0
        t0 = time.perf_counter()
        rep_in = m_in.compact("rebuild")
        in_s = time.perf_counter() - t0
        assert fold_chunks > 0
        assert_same_index(m_ooc._state.sealed, m_in._state.sealed, "the rebuild fold")
        fq = torch.from_numpy(extra[:256]).to(dev)
        a, b = m_ooc.search(fq, K_MAIN), m_in.search(fq, K_MAIN)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        emit(phase="ooc", kind="stream_fold", n=int(m_ooc._state.sealed.size),
             report_ooc=rep_ooc, report_in_core=rep_in,
             fold_seconds_streamed=ooc_s, fold_seconds_in_core=in_s, chunks=fold_chunks,
             search_equal=True, launches=fold_counts, card=st["card"])
        del m_ooc, m_in, sealed

        # ---- 6. the gates: both budgets refuse before any chunk stages ----------
        refusals = {}
        for key, site in (("memory_budget_bytes", "build_stream"),
                          ("host_budget_bytes", "build_stream/host")):
            used = mem.totals()["device_bytes" if key == "memory_budget_bytes"
                                else "host_bytes"]
            budget = Resources(device="cuda", **{key: used + 1024})
            c0, t_dev = ooc_chunks(), mem.totals()["device_bytes"]
            try:
                ivf_pq.build(params, gate_reader, res=budget)
            except MemoryBudgetError as e:
                refusals[site] = dict(need_bytes=e.need_bytes, budget_bytes=e.budget_bytes)
                assert e.site == site, e.site
                pl = mem.plan("ivf_pq", params, N_MAIN, D_MAIN, streamed=True,
                              chunk_rows=OOC_CHUNK)
                assert e.need_bytes == pl["build_peak_bytes" if site == "build_stream"
                                          else "host_peak_bytes"], (e.need_bytes, pl)
            else:
                raise AssertionError(f"an armed {key} admitted the 1M streamed build")
            assert ooc_chunks() == c0 and mem.totals()["device_bytes"] == t_dev
        emit(phase="ooc", kind="gates", refusals=refusals, n=N_MAIN, d=D_MAIN,
             card=st["card"])
    for name in ("fused_knn_rows", "topk", "pq_scan_topk", "cagra_hop"):
        assert st["launches_ooc"].get(name, 0) > 0, (name, st["launches_ooc"])
    time_segment_sum(st)
    time_instrument(st)
    emit(phase="ooc_launches", launches=st["launches_ooc"],
         seconds=time.perf_counter() - t_phase, card=st["card"])


# -- phase 7: beyond-HBM tiered storage and the quality observers -----------------

TIER_M_ORACLE = 1_000            # exact_search queries: the oracle's chunked walk
TIER_FLUSH = 64                  # the refined flush whose host syncs are counted
TIER_BATCHES = 20                # 10k-query batches over which the slot bytes hold
TIER_HBM_BATCHES = 5
TIER_CHUNK = 8_192               # TierPolicy's default oracle chunk
BIG_N, BIG_CHUNK, BIG_CENTERS, BIG_SIGMA = 10_000_000, 262_144, 10_000, 12.0
BIG_LO, BIG_HI = 86.0, 170.0     # centers uniform in [86, 170): 2x sigma of spread a dim
BIG_PARAMS = dict(n_lists=1024, pq_dim=64, pq_bits=4, kmeans_trainset_fraction=0.02, seed=0)
BIG_RECALL_FLOOR = 0.5           # recall@10 after refine against the chunked oracle
TIER_PLAN_SLACK = 0.2            # plan()'s tiers against the ledger


def count_syncs(fn):
    """(fn's result, the host syncs torch.cuda.set_sync_debug_mode("warn")
    reported while it ran, each as the ``file:line`` that made it)."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, [f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught
                 if "synchroniz" in str(w.message)]


def tier_reset(st):
    """Add the launches since the last reset to phase 7's total, then reset:
    every launch of the phase counts once, whatever the per-step counts in
    between."""
    total = st.setdefault("launches_tier", {})
    for kk, v in all_counts().items():
        total[kk] = total.get(kk, 0) + v
    reset_all_counts()


def bit_equal(a, b):
    import torch

    return bool(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]))


def timed(fn, reps):
    """Seconds a call of ``fn`` over ``reps`` synchronised calls."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps


def tier_serve(st, svc, name, hook, pool, truth_fn, log):
    """Publish ``hook`` under ``name`` and serve phase 4's load (8 threads x
    400 one-row requests); served rows are held against the hook's direct
    search at their bucket's shape. Returns the line's numbers."""
    import numpy as np
    import torch

    from raft_tpu_torch.obs import compile as obs_compile

    svc.publish(name, hook, k=K_MAIN)
    with obs_compile.attribution() as rec:
        lats, results, failures, load_s, _ = serve_load(
            svc, name, pool, SERVE_THREADS, SERVE_PER_THREAD, K_MAIN, SERVE_CHECK)
    torch.cuda.synchronize()
    n_req = SERVE_THREADS * SERVE_PER_THREAD
    rows, ok, got_i = served_rows_equal(results, log, (hook,), pool, K_MAIN)
    assert not failures, failures[:5]
    assert rec.programs == 0 and rec.cache_misses == 0, rec.summary()
    assert bool(ok.all()), f"{int((~ok).sum())} served rows of {name} differ"
    lat = np.sort(np.array(lats)) * 1e3
    return dict(qps=n_req / load_s, p50_ms=float(lat[len(lat) // 2]),
                p99_ms=float(lat[int(len(lat) * 0.99) - 1]), requests=n_req,
                checked_rows=len(rows), rows_equal_direct_search=int(ok.sum()),
                recall_at_10=recall(got_i, truth_fn(rows)))


def tier_quality(st, tiered, canary, sampled, tracker, log, tmp):
    """The canary over the tiered index's chunked oracle, fed by the served
    flushes; its Wilson interval must hold the recall of the sampled
    queries' served ids measured against ``exact_search``; then a forced
    failing SLO writes one flight-recorder bundle."""
    import numpy as np
    import torch

    from raft_tpu_torch.obs import events, slo

    t0 = time.perf_counter()
    drained = canary.drain()
    drain_s = time.perf_counter() - t0
    est = canary.estimate()
    # the recall of every sampled query's served ids against exact_search,
    # measured apart from the canary (one batch: another route than the
    # drains' buckets, the same answers up to ties)
    qs = np.stack([row for row, _ in sampled])
    ids = torch.from_numpy(np.stack([got for _, got in sampled])).cuda()
    truth = tiered.exact_search(qs, K_MAIN)[1]
    measured = recall(ids, truth)
    status = tracker.status()
    code, body = tracker.healthz()
    # a forced failing verdict: one bundle, written by the armed recorder
    rec_dir = os.path.join(tmp, "incidents")
    events.arm_flight_recorder(rec_dir, request_log=log, min_interval_s=300.0)
    forced = slo.SLOTracker(slo.SLOPolicy(failing_burn=5.0), name="tier_forced")
    for _ in range(50):
        forced.record_admission(False)
    forced_status = forced.status()
    bundles = sorted(os.listdir(rec_dir))
    files = sorted(os.listdir(os.path.join(rec_dir, bundles[0]))) if bundles else []
    events.disarm_flight_recorder()
    line = dict(phase="tier_quality", canary=est, drained=drained, drain_seconds=drain_s,
                measured_recall=measured, in_interval=canary.in_interval(measured),
                slo_status=status, healthz_code=code,
                slo_burn=body["objectives"], forced_status=forced_status,
                flight_recorder_bundles=bundles, bundle_files=files, card=st["card"])
    emit(**line)
    assert drained == len(sampled) > 0 and est["reranked"] == drained, est
    assert canary.in_interval(measured), (measured, est)
    assert status != "failing" and code == 200, body
    assert forced_status == "failing" and len(bundles) == 1, bundles
    assert files == ["events.json", "mem.json", "meta.json", "metrics.json",
                     "requests.json"], files


def phase_tier_1m(st, tmp):
    """Phase 7 (a): phase 2's 1M x 128 IVF-PQ index wrapped twice, all-HBM and
    tiered (host RAM, no budget, so cold)."""
    import numpy as np
    import torch

    from raft_tpu_torch import stream
    from raft_tpu_torch.core import Resources
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.obs import RequestLog, SLOPolicy, SLOTracker, mem, quality
    from raft_tpu_torch.ops.fused_knn import fused_knn
    from raft_tpu_torch.serve import SearchService

    index, q = st["ivf"]
    xh = st["ivf_x"].cpu().numpy()
    sp = ivf_pq.SearchParams(n_probes=8, lut_dtype="bfloat16")
    hbm = stream.MutableIndex(index, search_params=sp, dataset=xh, name="tier_hbm")
    tiered = stream.MutableIndex(index, search_params=sp, dataset=xh, storage="tiered",
                                 name="tier_1m")
    ts = tiered.tiered_store
    assert ts.residency == "host" and not ts.mirror_resident
    assert ts.tier_bytes() == {"device": 0, "host": xh.nbytes, "disk": 0}
    r = 4
    kr = K_MAIN * r

    # ---- search_refined bit for bit: a 10k batch and a 64-row flush --------------
    ha, ta = hbm.search_refined(q, K_MAIN, r), tiered.search_refined(q, K_MAIN, r)
    hf, tf = (hbm.search_refined(q[:TIER_FLUSH], K_MAIN, r),
              tiered.search_refined(q[:TIER_FLUSH], K_MAIN, r))
    torch.cuda.synchronize()
    refined_equal = bit_equal(ha, ta) and bit_equal(hf, tf)
    ref_rec = recall(ta[1][:IVF_CHECK], st["ivf_truth"])

    # ---- the slot ring: 20 batches, constant accounted bytes; H2D a batch --------
    tiered.search_refined(q, K_MAIN, r)           # the ring's second slot
    torch.cuda.synchronize()
    ring0, dev0 = ts.tier_bytes()["device"], mem.totals()["device_bytes"]
    s0 = ts.stats()
    tier_reset(st)
    tier_s = timed(lambda: tiered.search_refined(q, K_MAIN, r), TIER_BATCHES)
    counts = all_counts()
    s1 = ts.stats()
    ring_const = (ts.tier_bytes()["device"] == ring0
                  and mem.totals()["device_bytes"] == dev0)
    h2d_batch = (s1["h2d_bytes"] - s0["h2d_bytes"]) / TIER_BATCHES
    syncs_batch = (s1["host_syncs"] - s0["host_syncs"]) / TIER_BATCHES
    fetch_ms = (s1["fetch_wall_s"] - s0["fetch_wall_s"]) / TIER_BATCHES * 1e3
    gather_ms = (s1["gather_wall_s"] - s0["gather_wall_s"]) / TIER_BATCHES * 1e3
    hbm.search_refined(q, K_MAIN, r)
    hbm_s = timed(lambda: hbm.search_refined(q, K_MAIN, r), TIER_HBM_BATCHES)
    prof = profile_batch(st, "MutableIndex.search_refined (tiered, cold)",
                         "tier_refined_profile.txt",
                         lambda: tiered.search_refined(q, K_MAIN, r))
    prof_hbm = profile_batch(st, "MutableIndex.search_refined (all-HBM)",
                             "tier_refined_hbm_profile.txt",
                             lambda: hbm.search_refined(q, K_MAIN, r))

    # ---- the host syncs of one refined flush ----------------------------------------
    qd = q[:TIER_FLUSH].contiguous()
    hooks = {"hbm": hbm.refined_searcher(r), "tiered": tiered.refined_searcher(r)}
    syncs, sync_sites = {}, {}
    for key, hook in hooks.items():
        hook(qd, K_MAIN)
        hook(qd, K_MAIN)
        torch.cuda.synchronize()
        c0 = ts.stats()["host_syncs"]
        sync_sites[key] = count_syncs(lambda: hook(qd, K_MAIN))[1]
        syncs[key] = len(sync_sites[key])
        torch.cuda.synchronize()
        if key == "tiered":
            store_reads = ts.stats()["host_syncs"] - c0

    # ---- the chunked oracle: 1,000 queries, 123 chunks ---------------------------------
    qo = q[:TIER_M_ORACLE]
    ho = hbm.exact_search(qo, K_MAIN)
    tiered.exact_search(qo[:8], K_MAIN)           # the oracle ring's slots
    torch.cuda.synchronize()
    tier_reset(st)
    t0 = time.perf_counter()
    to = tiered.exact_search(qo, K_MAIN)
    torch.cuda.synchronize()
    oracle_s = time.perf_counter() - t0
    oracle_counts = all_counts()
    n_chunks = ts.n_oracle_chunks()
    t0 = time.perf_counter()
    hbm.exact_search(qo, K_MAIN)
    torch.cuda.synchronize()
    oracle_hbm_s = time.perf_counter() - t0
    oracle_ids = bool(torch.equal(ho[1], to[1]))
    oracle_dist = bool(torch.equal(ho[0], to[0]))
    oracle_err = float((ho[0] - to[0]).abs().max())

    line = dict(phase="tier", shape="1M x 128 f32 (phase 2's IVF-PQ, ivf_pq_1m_lid_pq4x64_r4)",
                n=N_MAIN, d=D_MAIN, m=IVF_Q, k=K_MAIN, refine_ratio=r, kr=kr,
                residency=ts.residency, refined_bit_equal=refined_equal,
                recall_at_10=ref_rec,
                qps_batch_tiered=IVF_Q / tier_s, qps_batch_hbm=IVF_Q / hbm_s,
                seconds_per_batch_tiered=tier_s, seconds_per_batch_hbm=hbm_s,
                h2d_bytes_per_batch=h2d_batch, h2d_expected=IVF_Q * kr * D_MAIN * 4,
                host_syncs_per_batch=syncs_batch, fetch_wall_ms_per_batch=fetch_ms,
                host_gather_ms_per_batch=gather_ms,
                slot_ring_device_bytes=ring0, slot_ring_constant=ring_const,
                batches=TIER_BATCHES, launches_per_batch={
                    kk: v / TIER_BATCHES for kk, v in counts.items() if v},
                flush_host_syncs=syncs, flush_sync_sites=sync_sites,
                flush_slot_reads=store_reads,
                device_busy_ms_tiered=prof["device_busy_ms"],
                idle_share_tiered=prof["idle_share"],
                device_busy_ms_hbm=prof_hbm["device_busy_ms"],
                idle_share_hbm=prof_hbm["idle_share"],
                oracle_m=TIER_M_ORACLE, oracle_chunks=n_chunks, oracle_seconds=oracle_s,
                oracle_seconds_hbm=oracle_hbm_s, oracle_ids_equal=oracle_ids,
                oracle_distances_bit_equal=oracle_dist, oracle_max_abs_diff=oracle_err,
                oracle_launches={kk: v for kk, v in oracle_counts.items() if v},
                stats=ts.stats(), card=st["card"])
    emit(**line)
    assert refined_equal, "tiered search_refined differs from the all-HBM twin"
    assert ring_const, "the slot ring's accounted bytes moved over 20 batches"
    assert h2d_batch == IVF_Q * kr * D_MAIN * 4, h2d_batch
    assert syncs_batch == 1, syncs_batch
    # the cold fetch reads the slot ids back once a flush and adds no other
    # sync (where the all-HBM flush syncs, the read may stand in for it)
    assert store_reads == 1 and syncs["tiered"] <= syncs["hbm"] + 1, sync_sites
    assert counts["pq_scan_topk"] == TIER_BATCHES * -(-IVF_Q // 128), counts
    assert n_chunks == -(-N_MAIN // TIER_CHUNK) == 123
    # a 1,000-query chunk is mode f32's batch route: one launch a chunk
    assert oracle_counts["fused_knn_tf32x3"] == n_chunks, oracle_counts
    assert oracle_ids and oracle_dist, (oracle_ids, oracle_err)
    assert fused_knn.launches_by_route["tf32x3"] >= n_chunks

    # ---- served through SearchService with a RecallCanary and an SLOTracker ----------
    pool = q.cpu().numpy()
    log = RequestLog(capacity=8192)
    tracker = SLOTracker(SLOPolicy(), name="tier_1m")
    canary = quality.RecallCanary(quality.exact_oracle(tiered), k=K_MAIN, sample_rate=1.0,
                                  reservoir=SERVE_THREADS * SERVE_PER_THREAD,
                                  buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256),
                                  name="tier_tiered", seed=0, slo=tracker)
    svc = SearchService(max_batch=SERVE_MAX_BATCH, max_wait_us=SERVE_WAIT_US,
                        max_queue_rows=4 * SERVE_MAX_BATCH * SERVE_THREADS,
                        request_log=log, canary=canary, slo=tracker)
    sampled = []
    offer = canary.offer

    def keep(queries, ids):
        # every offered (query, served ids) pair (sample_rate 1.0: each is
        # sampled), for the recall measured apart from the canary
        sampled.extend(zip(np.array(queries), np.array(ids)))
        return offer(queries, ids)

    canary.offer = keep

    def truth_fn(rows):
        return st["ivf_truth"][torch.tensor(rows, device=st["ivf_truth"].device)]

    h0 = ts.stats()
    tier_reset(st)
    serve = {"tiered": tier_serve(st, svc, "tier_tiered", hooks["tiered"], pool, truth_fn,
                                  log),
             "hbm": tier_serve(st, svc, "tier_hbm", hooks["hbm"], pool, truth_fn, log)}
    serve_counts = {kk: v for kk, v in all_counts().items() if v}
    h1 = ts.stats()
    serve["tiered"].update(hit_ratio=h1["hit_ratio"],
                           fetch_wall_ms=(h1["fetch_wall_s"] - h0["fetch_wall_s"]) * 1e3,
                           h2d_bytes=h1["h2d_bytes"] - h0["h2d_bytes"])
    emit(phase="tier_serve", shape="1M x 128 f32", per_twin=serve, launches=serve_counts,
         card=st["card"])
    tier_quality(st, tiered, canary, sampled, tracker, log, tmp)
    svc.shutdown()

    # ---- spill / promote under an armed budget -------------------------------------------
    rows = np.asarray(st["ivf_x"][:16].cpu().numpy()) + 0.25
    ids = np.arange(2_000_000, 2_000_016)
    assert ts.promote(force=True) and ts.mirror_resident
    torch.cuda.synchronize()
    with_mirror = mem.totals()["device_bytes"]
    tiered.upsert(rows, ids=ids, res=Resources(device="cuda", memory_budget_bytes=with_mirror + 1))
    hbm.upsert(rows, ids=ids)
    spilled = not ts.mirror_resident
    after_spill = mem.totals()["device_bytes"]
    cold_equal = bit_equal(hbm.search_refined(q, K_MAIN, r), tiered.search_refined(q, K_MAIN, r))
    refused = not ts.promote(res=Resources(device="cuda", memory_budget_bytes=(
        mem.totals()["device_bytes"] + ts.row_bytes // 2)))
    promoted = ts.promote(res=Resources(device="cuda", memory_budget_bytes=(
        mem.totals()["device_bytes"] + 2 * ts.row_bytes)))
    s0 = ts.stats()
    hot_s = timed(lambda: tiered.search_refined(q, K_MAIN, r), TIER_HBM_BATCHES)
    hot_equal = bit_equal(hbm.search_refined(q, K_MAIN, r), tiered.search_refined(q, K_MAIN, r))
    s1 = ts.stats()
    events = [(e["event"], e["reason"]) for e in s1["events"]]
    emit(phase="tier_residency", shape="1M x 128 f32", spilled_by_pressure=spilled,
         device_bytes_with_mirror=with_mirror, device_bytes_after_spill=after_spill,
         cold_equal=cold_equal, promote_refused_tight=refused, promoted=promoted,
         qps_batch_promoted=IVF_Q / hot_s, hot_equal=hot_equal,
         h2d_bytes_while_resident=s1["h2d_bytes"] - s0["h2d_bytes"],
         hit_ratio=s1["hit_ratio"], events=events, spills=s1["spills"],
         promotes=s1["promotes"], card=st["card"])
    assert spilled and events[-2] == ("spill", "pressure"), events
    assert after_spill <= with_mirror - ts.row_bytes + (1 << 24), (with_mirror, after_spill)
    assert cold_equal and hot_equal and refused and promoted
    assert s1["h2d_bytes"] == s0["h2d_bytes"]
    ts.spill()
    del hbm, tiered, ts, hooks
    torch.cuda.synchronize()


def big_corpus(path):
    """BIGANN-10M's shape: 10M x 128 uint8 rows around BIG_CENTERS centers
    (uniform in [BIG_LO, BIG_HI) a dimension, so the centers' spread is twice
    the noise's, as in phase 2's blobs) with N(0, BIG_SIGMA^2) noise,
    rounded and clipped into [0, 255], written to a ``.npy`` file from a
    seed; and 10k queries of the same law. Returns the queries (uint8,
    host)."""
    import numpy as np
    import torch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(70)
    centers = BIG_LO + (BIG_HI - BIG_LO) * torch.rand((BIG_CENTERS, D_MAIN), generator=g,
                                                      device=dev)

    def draw(n):
        lab = torch.randint(0, BIG_CENTERS, (n,), generator=g, device=dev)
        x = centers[lab] + BIG_SIGMA * torch.randn((n, D_MAIN), generator=g, device=dev)
        return x.round().clamp(0, 255).to(torch.uint8)

    mm = np.lib.format.open_memmap(path, mode="w+", dtype=np.uint8, shape=(BIG_N, D_MAIN))
    for s0 in range(0, BIG_N, 1_000_000):
        mm[s0:s0 + 1_000_000] = draw(min(1_000_000, BIG_N - s0)).cpu().numpy()
    mm.flush()
    del mm
    return draw(IVF_Q).cpu().numpy()


def phase_tier_10m(st, tmp):
    """Phase 7 (b): BIGANN-10M's shape streamed into IVF-PQ and wrapped
    tiered over the reader's memmap (adopted: residency "disk", 0 host
    bytes), an armed device budget keeping the mirror off the card."""
    import numpy as np
    import torch

    from raft_tpu_torch import stream
    from raft_tpu_torch.core import Resources, chunked, default_resources, set_default_resources
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.obs import mem
    from raft_tpu_torch.stream import TierPolicy

    res = Resources(device="cuda")
    path = os.path.join(tmp, "bigann_shape.npy")
    t0 = time.perf_counter()
    qb = big_corpus(path)
    gen_s = time.perf_counter() - t0
    reader = chunked.ChunkedReader.from_file(path, chunk_rows=BIG_CHUNK)
    params = ivf_pq.IndexParams(**BIG_PARAMS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = ivf_pq.build(params, reader, res=res)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    sp = ivf_pq.SearchParams(n_probes=8, lut_dtype="bfloat16")
    plan = mem.plan("ivf_pq", params, BIG_N, D_MAIN, dtype="uint8", storage="tiered",
                    tier=TierPolicy(disk_path=os.path.join(tmp, "cold")))
    index_bytes = sum(t.numel() * t.element_size() for t in (
        index.centers, index.centers_rot, index.rotation, index.codebooks,
        index.list_codes, index.list_ids, index.list_sizes, index.list_consts,
        index.list_scales, index.list_sig, index.sig_scales) if t is not None)

    # the budget: what the ledger holds now (this index included) plus the
    # slots of a 10k refine batch and of the oracle, short of the mirror
    slots = 2 * (IVF_Q * K_MAIN * 4 * D_MAIN + TIER_CHUNK * D_MAIN)
    prev = default_resources()
    budget = mem.totals()["device_bytes"] + mem.unaccounted_index_bytes(index) + slots
    set_default_resources(Resources(device="cuda", memory_budget_bytes=budget))
    try:
        tiered = stream.MutableIndex(index, search_params=sp, dataset=reader,
                                     storage="tiered", name="tier_10m")
        ts = tiered.tiered_store
        tb0 = ts.tier_bytes()
        tier_entry = [e for e in mem.breakdown() if e["component"] == "tier"
                      and e["name"] == "tier_10m"][0]
        index_entry = [e for e in mem.breakdown() if e["component"] == "index/ivf_pq"
                       and e["name"] == "tier_10m"][0]
        adopted = ts.host_view() is reader.host_view()
        hbm = stream.MutableIndex(index, search_params=sp, dataset=reader, name="tier_10m_hbm")
        r = 4
        ta = tiered.search_refined(qb, K_MAIN, r)
        ha = hbm.search_refined(qb, K_MAIN, r)
        torch.cuda.synchronize()
        refined_equal = bit_equal(ha, ta)
        s0 = ts.stats()
        tier_reset(st)
        tier_s = timed(lambda: tiered.search_refined(qb, K_MAIN, r), 3)
        counts = all_counts()
        s1 = ts.stats()
        hbm_s = timed(lambda: hbm.search_refined(qb, K_MAIN, r), 3)
        prof = profile_batch(st, "MutableIndex.search_refined (tiered 10M u8, disk tier)",
                             "tier_10m_refined_profile.txt",
                             lambda: tiered.search_refined(qb, K_MAIN, r))
        mirror_kept_off = not ts.mirror_resident
        # the chunked oracle over the 10M rows: recall@10 of the refined search
        qo = qb[:TIER_M_ORACLE]
        tiered.exact_search(qo[:8], K_MAIN)
        torch.cuda.synchronize()
        tier_reset(st)
        t0 = time.perf_counter()
        to = tiered.exact_search(qo, K_MAIN)
        torch.cuda.synchronize()
        oracle_s = time.perf_counter() - t0
        oracle_counts = all_counts()
        ho = hbm.exact_search(qo, K_MAIN)
        torch.cuda.synchronize()
        rec = recall(ta[1][:TIER_M_ORACLE], to[1])
        oracle_equal = bit_equal(ho, to)
        stats = ts.stats()
        still_off = not ts.mirror_resident
    finally:
        set_default_resources(prev)
    ledger_index = index_entry["device_bytes"]
    line = dict(phase="tier", shape="BIGANN-10M's shape, 10M x 128 uint8, clustered",
                n=BIG_N, d=D_MAIN, centers=BIG_CENTERS, sigma=BIG_SIGMA, m=IVF_Q, k=K_MAIN,
                refine_ratio=r, params=BIG_PARAMS, corpus_seconds=gen_s,
                build_seconds_streamed=build_s, n_lists=index.n_lists,
                capacity=index.capacity, index_bytes=index_bytes,
                residency=stats["residency"], adopted_memmap=adopted, tier_bytes=tb0,
                tier_ledger_host_bytes=tier_entry["host_bytes"],
                tier_ledger_device_bytes=tier_entry["device_bytes"],
                device_budget_bytes=budget, mirror_kept_off=mirror_kept_off and still_off,
                plan_tiers=plan["tiers"], ledger_index_bytes=ledger_index,
                plan_over_ledger=plan["tiers"]["device"] / ledger_index,
                refined_bit_equal=refined_equal,
                qps_batch_tiered=IVF_Q / tier_s, qps_batch_hbm=IVF_Q / hbm_s,
                h2d_bytes_per_batch=(s1["h2d_bytes"] - s0["h2d_bytes"]) / 3,
                fetch_wall_ms_per_batch=(s1["fetch_wall_s"] - s0["fetch_wall_s"]) / 3 * 1e3,
                host_gather_ms_per_batch=(s1["gather_wall_s"] - s0["gather_wall_s"]) / 3 * 1e3,
                launches_per_batch={kk: v / 3 for kk, v in counts.items() if v},
                device_busy_ms_tiered=prof["device_busy_ms"],
                idle_share_tiered=prof["idle_share"],
                oracle_m=TIER_M_ORACLE, oracle_chunks=ts.n_oracle_chunks(),
                oracle_seconds=oracle_s, oracle_equal_hbm=oracle_equal,
                oracle_launches={kk: v for kk, v in oracle_counts.items() if v},
                recall_at_10=rec, recall_floor=BIG_RECALL_FLOOR, stats=stats,
                card=st["card"])
    emit(**line)
    assert adopted and stats["residency"] == "disk", stats
    assert tb0 == {"device": 0, "host": 0, "disk": BIG_N * D_MAIN}, tb0
    assert tier_entry["host_bytes"] == 0
    assert mirror_kept_off and still_off
    assert refined_equal, "10M tiered search_refined differs from the all-HBM twin"
    assert ts.n_oracle_chunks() == -(-BIG_N // TIER_CHUNK) == 1221
    assert oracle_counts["fused_knn_tc"] == 1221, oracle_counts
    assert oracle_equal
    assert rec >= BIG_RECALL_FLOOR, rec
    assert abs(plan["tiers"]["device"] / ledger_index - 1) <= TIER_PLAN_SLACK, line
    assert plan["tiers"]["disk"] == tb0["disk"] and plan["tiers"]["host"] == 0
    del tiered, hbm, ts, index, reader
    torch.cuda.synchronize()


def phase_tier(st):
    """Phase 7: ``MutableIndex(storage="tiered")`` against its all-HBM twin at
    1M x 128 f32 and at BIGANN-10M's shape, the quality observers on the
    served tiered index (see the module docstring)."""
    import tempfile

    t_phase = time.perf_counter()
    reset_all_counts()
    st["launches_tier"] = {}
    with tempfile.TemporaryDirectory() as tmp:
        phase_tier_1m(st, tmp)
        tier_reset(st)
        phase_tier_10m(st, tmp)
        tier_reset(st)
    total = st["launches_tier"]
    for name in ("fused_knn_rows", "fused_knn_tf32x3", "fused_knn_tc", "tf32_split",
                 "pq_scan_topk"):
        assert total.get(name, 0) > 0, (name, total)
    emit(phase="tier_launches", launches=total, seconds=time.perf_counter() - t_phase,
         card=st["card"])


# -- phase 8: the sharded and replicated mesh (stream/sharded.py, replicated.py) --

MESH_SHARDS = (1, 2, 4)
# the sharded row's base operating point, divided by S (bench.py:1465,
# :1526-1535): 8 / S probes kept recall@10 at 0.853 at S = 4 (2 of 256 lists
# a shard) on an H100 80GB HBM3 at 700 W, below the mesh's 0.95 floor
MESH_PROBES = 32
MESH_CAP = 4096                  # delta_capacity a shard (bench.py's sharded row)
MESH_FILL = 0.25                 # 1,024 of 4,096 rows a shard: 4 shards share phase 5's writes
MESH_RECALL_FLOOR = 0.95         # recall@10 against the mesh's own exact oracle
MESH_ADVICE_ROWS = 200_000       # reshard_rows_per_shard: 1M / 4 = 250k trips it
MESH_CANARY_PER_THREAD = 125     # 8 threads: 1,000 served queries sampled by the canary
MESH_FAULT_S, MESH_HEAL_S = 1.5, 1.0
# the replicated mesh's writer: 32 upserts + 8 deletes every ~50 ms, 6,144
# rows at most (3,072 a shard of 4,096), so it still writes as the reshard runs
MESH_WRITER_ROWS, MESH_WRITER_DELETES, MESH_WRITER_FRESH = 32, 8, 6_144
MESH_BURST_STEPS = 16            # the exact mesh's writer burst before the crash
MESH_CHECK = 1_000               # queries the recovered mesh is held id for id on


def mesh_reset(st):
    """Add the launches since the last reset to phase 8's total, then reset."""
    total = st.setdefault("launches_mesh", {})
    add_counts(total, all_counts())
    reset_all_counts()


def mesh_strikes(mesh):
    """{replica name: strikes so far} over every twin of a replicated mesh."""
    return {r["replica"]: r["strikes_total"] for g in mesh.health()["shards"]
            for r in g["replicas"]}


def mesh_flush(st, hook, qd, label):
    """One 64-row flush of a mesh hook as the service runs it: its host
    syncs with their sites, its launches by kernel, and (torch.profiler) the
    device's busy ms and idle share."""
    import torch

    from raft_tpu_torch.serve.service import _start_copy_to_host

    hook(qd, K_MAIN)
    torch.cuda.synchronize()
    mesh_reset(st)
    (_, done), sites = count_syncs(lambda: _start_copy_to_host(hook(qd, K_MAIN)))
    done.synchronize()
    launches = {kk: v for kk, v in all_counts().items() if v}
    mesh_reset(st)
    prof = profile_batch(st, f"{label} flush", f"mesh_{label}_flush_profile.txt",
                         lambda: _start_copy_to_host(hook(qd, K_MAIN))[1].synchronize(),
                         what=f"{qd.shape[0]}-row flush")
    mesh_reset(st)
    return dict(host_syncs=len(sites), sync_sites=sites, launches=launches,
                device_busy_ms=prof["device_busy_ms"], idle_share=prof["idle_share"],
                wall_ms=prof["wall_ms"])


def mesh_serve(svc, name, pool, threads, per_thread):
    """phase 4's closed-loop load on a published mesh; returns QPS, p50 /
    p99, the failures and the kernel builds in the window."""
    import numpy as np
    import torch

    from raft_tpu_torch.obs import compile as obs_compile

    with obs_compile.attribution() as rec:
        lats, _, failures, load_s, _ = serve_load(svc, name, pool, threads, per_thread,
                                                  K_MAIN, 0)
    torch.cuda.synchronize()
    lat = np.sort(np.array(lats)) * 1e3
    return dict(qps=len(lats) / load_s, p50_ms=float(lat[len(lat) // 2]),
                p99_ms=float(lat[int(len(lat) * 0.99) - 1]), requests=threads * per_thread,
                failed=len(failures), failures=failures[:3], builds=rec.summary())


def mesh_ladder(st, xh, q, pool, centers):
    """Phase 8 (a): the scatter-gather ladder at S = 1, 2, 4. Returns the
    S = 4 mesh for (b)."""
    import numpy as np
    import torch

    from raft_tpu_torch import stream
    from raft_tpu_torch.core import Resources
    from raft_tpu_torch.neighbors import ivf_flat
    from raft_tpu_torch.serve import SearchService

    res = Resources(device="cuda")
    dev = torch.device("cuda")
    qf = q[:TIER_FLUSH].contiguous()
    keep = None
    for S in MESH_SHARDS:
        params = ivf_flat.IndexParams(n_lists=IVF_FLAT_LISTS // S, seed=0)
        sp = ivf_flat.SearchParams(n_probes=max(MESH_PROBES // S, 1))

        def build(rows, params=params):
            return ivf_flat.build(params, torch.from_numpy(rows).to(dev), res=res)

        mesh_reset(st)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mesh = stream.ShardedMutableIndex(xh, n_shards=S, build=build, search_params=sp,
                                          delta_capacity=MESH_CAP, retain_vectors=True,
                                          name=f"mesh_s{S}")
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        line = dict(phase="mesh", part="a", shards=S, n=N_MAIN, d=D_MAIN, k=K_MAIN,
                    n_lists=params.n_lists, n_probes=sp.n_probes, delta_capacity=MESH_CAP,
                    build_seconds=build_s,
                    shard_rows=[sh.stats()["sealed_rows"] for sh in mesh.shards])
        d, i = mesh.search(q, K_MAIN)
        if S == 1:
            # the plain index over the same sealed index: the composition
            # (scan halves, pads, one merge) must change nothing
            plain = stream.MutableIndex(mesh.shards[0]._state.sealed, search_params=sp,
                                        delta_capacity=MESH_CAP, name="mesh_plain")
            rows = blobs(STREAM_UPSERTS, centers, 41, 0.5)[0].cpu().numpy()
            ids = N_MAIN + np.arange(STREAM_UPSERTS)
            parity = []
            for step in range(2):
                with uncounted():
                    want = (plain.search(q, K_MAIN), plain.search(qf, K_MAIN))
                got = (mesh.search(q, K_MAIN), mesh.search(qf, K_MAIN))
                parity.append(bit_equal(want[0], got[0]) and bit_equal(want[1], got[1]))
                if step == 0:
                    for m in (mesh, plain):
                        m.upsert(rows, ids=ids)
                        m.delete(np.arange(0, 100 * STREAM_DELETES, 100))
            line["plain_parity_before_after_writes"] = parity
            assert all(parity), f"the 1-shard mesh differs from a plain MutableIndex: {parity}"
            d, i = mesh.search(q, K_MAIN)
            del plain
        _, ex = mesh.exact_search(q, K_MAIN)
        rec10 = recall(i, ex)
        batch_s = timed(lambda: mesh.search(q, K_MAIN), 3)
        svc = SearchService(max_batch=SERVE_MAX_BATCH, max_wait_us=SERVE_WAIT_US,
                            max_queue_rows=4 * SERVE_MAX_BATCH * SERVE_THREADS)
        svc.publish(f"mesh_s{S}", mesh, k=K_MAIN)
        warm = mesh.warm(svc.buckets, ks=(K_MAIN,))
        mesh_reset(st)
        served = mesh_serve(svc, f"mesh_s{S}", pool, SERVE_THREADS, SERVE_PER_THREAD)
        svc.shutdown()
        flush = mesh_flush(st, mesh.searcher(), qf, f"s{S}")
        line.update(recall_at_10=rec10, recall_floor=MESH_RECALL_FLOOR,
                    qps_batch=CAGRA_Q / batch_s, seconds_per_batch=batch_s, served=served,
                    warm_builds=sum(v["programs"] for v in warm[K_MAIN].values()),
                    flush=flush, card=st["card"])
        emit(**line)
        assert rec10 >= MESH_RECALL_FLOOR, (S, rec10)
        assert served["failed"] == 0, served["failures"]
        assert served["builds"]["programs"] == 0, served["builds"]
        assert flush["launches"].get("topk", 0) > 0, flush["launches"]
        if S == MESH_SHARDS[-1]:
            keep = mesh
        else:
            del mesh
        del d, i, ex
        torch.cuda.synchronize()
    return keep


def mesh_churn(st, mesh, pool, centers):
    """Phase 8 (b): phase 5's writer against the S = 4 mesh, one shard folded
    a Compactor cycle, then a RecallCanary over the quiet mesh."""
    import numpy as np
    import torch

    from raft_tpu_torch import stream
    from raft_tpu_torch.obs import quality
    from raft_tpu_torch.serve import SearchService

    S = mesh.n_shards
    n_up = STREAM_STEPS * STREAM_UPSERTS
    fresh = blobs(n_up, centers, 42, 0.5)[0].cpu().numpy()
    svc = SearchService(max_batch=SERVE_MAX_BATCH, max_wait_us=SERVE_WAIT_US,
                        max_queue_rows=4 * SERVE_MAX_BATCH * STREAM_THREADS)
    svc.publish("mesh_churn", mesh, k=K_MAIN)
    mesh.warm(svc.buckets, ks=(K_MAIN,))
    policy = stream.CompactionPolicy(delta_fill=MESH_FILL, tombstone_ratio=None,
                                     reshard_rows_per_shard=MESH_ADVICE_ROWS)
    comp = stream.Compactor(mesh, publisher=svc, name="mesh_churn", ks=(K_MAIN,),
                            policy=policy)
    mesh_reset(st)
    out, _ = churn_window(st, svc, "mesh_churn", mesh, comp, pool, fresh, N_MAIN,
                          STREAM_STEPS, pool[:STREAM_EVAL], key="mesh")
    reset_all_counts()               # churn_window added its window to launches_mesh
    svc.shutdown()
    advice = comp.last_advice
    shards_folded = out["fold_shards"]

    # the canary over the quiet mesh: every served query sampled, drained
    # through the mesh's exact oracle
    canary = quality.RecallCanary(quality.exact_oracle(mesh), k=K_MAIN, sample_rate=1.0,
                                  reservoir=SERVE_THREADS * MESH_CANARY_PER_THREAD,
                                  buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256),
                                  name="mesh_canary", seed=0)
    sampled = []
    offer = canary.offer

    def keep(queries, ids):
        sampled.extend(zip(np.array(queries), np.array(ids)))
        return offer(queries, ids)

    canary.offer = keep
    svc = SearchService(max_batch=SERVE_MAX_BATCH, max_wait_us=SERVE_WAIT_US,
                        max_queue_rows=4 * SERVE_MAX_BATCH * SERVE_THREADS, canary=canary)
    svc.publish("mesh_canary", mesh, k=K_MAIN)
    served = mesh_serve(svc, "mesh_canary", pool, SERVE_THREADS, MESH_CANARY_PER_THREAD)
    svc.shutdown()
    t0 = time.perf_counter()
    drained = canary.drain()
    drain_s = time.perf_counter() - t0
    est = canary.estimate()
    qs = np.stack([row for row, _ in sampled])
    ids = torch.from_numpy(np.stack([got for _, got in sampled])).cuda()
    measured = recall(ids, mesh.exact_search(qs, K_MAIN)[1])
    mesh_reset(st)
    emit(phase="mesh", part="b", shards=S, threads=STREAM_THREADS, writer_steps=STREAM_STEPS,
         upserts_per_step=STREAM_UPSERTS, deletes_per_step=STREAM_DELETES,
         delta_capacity=MESH_CAP, compact_fill=MESH_FILL, **out, advice=advice,
         canary=est, canary_drained=drained, canary_drain_seconds=drain_s,
         measured_recall=measured, in_interval=canary.in_interval(measured),
         canary_served=served, stats={kk: v for kk, v in mesh.stats().items()
                                      if kk != "per_shard"}, card=st["card"])
    assert out["compactions"] >= 2, out["compactions"]
    assert len(set(shards_folded)) >= 2 and len(set(shards_folded)) == len(shards_folded), (
        shards_folded)
    assert advice is not None and advice["action"] == "split" and advice["target"] == 2 * S, (
        advice)
    assert served["failed"] == 0, served["failures"]
    assert drained == len(sampled) > 0 and canary.in_interval(measured), (measured, est)


def mesh_replicas(st, xh, q, pool, centers):
    """Phase 8 (c): a 2-shard x 2-replica IVF-Flat mesh under 2 readers and
    a writer: a fault window on shard 0's preferred twin, then a reshard to
    4 with a twin of shard 1 killed mid-migration."""
    import threading

    import numpy as np
    import torch

    from raft_tpu_torch import stream
    from raft_tpu_torch.core import Resources
    from raft_tpu_torch.neighbors import ivf_flat
    from raft_tpu_torch.obs import compile as obs_compile
    from raft_tpu_torch.serve import SearchService
    from raft_tpu_torch.testing import faults

    res = Resources(device="cuda")
    dev = torch.device("cuda")
    S = 2
    params = ivf_flat.IndexParams(n_lists=IVF_FLAT_LISTS // S, seed=0)
    sp = ivf_flat.SearchParams(n_probes=MESH_PROBES // S)

    def build(rows):
        return ivf_flat.build(params, torch.from_numpy(rows).to(dev), res=res)

    t0 = time.perf_counter()
    mesh = stream.ShardedMutableIndex(
        xh, n_shards=S, replicas=2, build=build, search_params=sp, delta_capacity=MESH_CAP,
        retain_vectors=True, name="mesh_r",
        fencing=stream.FencingPolicy(max_consecutive=1, backoff_s=0.05, backoff_max_s=0.2))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    svc = SearchService(max_batch=SERVE_MAX_BATCH, max_wait_us=SERVE_WAIT_US,
                        max_queue_rows=4 * SERVE_MAX_BATCH * SERVE_THREADS)
    svc.publish("mesh_r", mesh, k=K_MAIN)
    mesh.warm(svc.buckets, ks=(K_MAIN,))
    fresh = blobs(MESH_WRITER_FRESH, centers, 43, 0.5)[0].cpu().numpy()
    stop = threading.Event()
    lock = threading.Lock()
    failures, reads = [], [0]
    written = {"up": 0, "del": 0, "ids": []}
    rng = np.random.default_rng(44)

    def reader(tid):
        j = 0
        while not stop.is_set():
            qi = (tid + 2 * j) % pool.shape[0]
            j += 1
            try:
                svc.search("mesh_r", pool[qi:qi + 1], K_MAIN)
            except Exception as e:  # every loss fails the phase
                with lock:
                    failures.append(f"{type(e).__name__}: {str(e)[:120]}")
                continue
            with lock:
                reads[0] += 1

    def writer():
        step = 0
        while not stop.is_set() and (step + 1) * MESH_WRITER_ROWS <= fresh.shape[0]:
            lo = step * MESH_WRITER_ROWS
            ids = 3_000_000 + np.arange(lo, lo + MESH_WRITER_ROWS)
            try:
                svc.upsert("mesh_r", fresh[lo:lo + MESH_WRITER_ROWS], ids=ids)
                dels = rng.choice(N_MAIN, MESH_WRITER_DELETES, replace=False)
                killed = svc.delete("mesh_r", dels)
            except Exception as e:
                with lock:
                    failures.append(f"write {type(e).__name__}: {str(e)[:120]}")
                return
            with lock:
                written["up"] += MESH_WRITER_ROWS
                written["del"] += killed
                written["ids"].append(ids)
            step += 1
            time.sleep(0.05)

    workers = [threading.Thread(target=reader, args=(t,)) for t in range(2)]
    workers.append(threading.Thread(target=writer))
    mesh_reset(st)
    for w in workers:
        w.start()
    try:
        time.sleep(0.5)
        s0 = mesh_strikes(mesh)
        # the preferred twin of shard 0: the read pick's lowest scan-wall EWMA
        twins = mesh.health()["shards"][0]["replicas"]
        target = min(twins, key=lambda r: r["ewma_ms"] or 0.0)["replica"]
        with faults.scope():
            faults.inject("replica/search", exc=faults.FaultError("injected"),
                          match=lambda c: c["replica"] == target)
            time.sleep(MESH_FAULT_S)
            fired = faults.fired("replica/search")
        time.sleep(0.2)              # scans in flight when the fault cleared end
        s_end = mesh_strikes(mesh)
        reads_window = reads[0]
        time.sleep(MESH_HEAL_S)      # the backoff expires and a re-probe heals r0
        s_after = mesh_strikes(mesh)
        health = mesh.health()["shards"][0]
        healed = all(not r["fenced"] and r["consecutive_strikes"] == 0
                     for r in health["replicas"])
        fault = dict(target=target, fired=fired, strikes_before=s0, strikes_at_window_end=s_end,
                     strikes_after_heal=s_after, healed=healed, reads_to_window_end=reads_window,
                     failed=len(failures))

        # ---- reshard(4) under the same load, a twin of shard 1 killed -------------
        qc = q[:MESH_CHECK]
        rec_before = recall(mesh.search(qc, K_MAIN)[1], mesh.exact_search(qc, K_MAIN)[1])

        def kill(ctx):
            # shard 1's preferred twin dies as the first donor folds
            twins = mesh.health()["shards"][1]["replicas"]
            dead = min(twins, key=lambda r: r["ewma_ms"] or 0.0)["replica"]
            killed.append(dead)
            faults.inject("replica/search", exc=faults.FaultError("killed mid-migration"),
                          match=lambda c: c["replica"] == dead)

        killed = []

        with faults.scope():
            faults.inject("reshard/split", callback=kill, times=1)
            with obs_compile.attribution() as rec:
                rep = mesh.reshard(2 * S, publisher=svc, name="mesh_r", ks=(K_MAIN,))
            killed_fired = faults.fired("replica/search")
        time.sleep(0.3)
    finally:
        stop.set()
        for w in workers:
            w.join(120)
    assert not any(w.is_alive() for w in workers), "a mesh reader or writer did not finish"
    svc.shutdown()
    rec_after = recall(mesh.search(qc, K_MAIN)[1], mesh.exact_search(qc, K_MAIN)[1])
    expect = N_MAIN + written["up"] - written["del"]
    last = written["ids"][-1] if written["ids"] else None
    ryw = None
    if last is not None:
        lo, n = int(last[0]) - 3_000_000, min(STREAM_RYW, len(last))
        _, got = mesh.search(fresh[lo:lo + n], K_MAIN)
        ryw = got[:, 0].cpu().tolist() == last[:n].tolist()
    mesh_reset(st)
    emit(phase="mesh", part="c", shards=S, replicas=2, build_seconds=build_s, fault=fault,
         reshard=dict(to=mesh.n_shards, wall_s=rep["wall_s"], rows_moved=rep["rows_moved"],
                      steps=[{kk: v for kk, v in stp.items() if kk != "publish"}
                             for stp in rep["steps"]],
                      builds=rec.summary(), killed=killed, killed_fired=killed_fired),
         recall_before=rec_before, recall_after=rec_after, recall_floor=MESH_RECALL_FLOOR,
         reads=reads[0], failed=len(failures), failures=failures[:3],
         writes=dict(upserted=written["up"], deleted=written["del"],
                     writer_done=len(written["ids"]) * MESH_WRITER_ROWS >= fresh.shape[0]),
         size=mesh.size,
         size_expected=expect, last_write_read_back=ryw, stats={
             kk: v for kk, v in mesh.stats().items() if kk != "per_shard"}, card=st["card"])
    assert not failures, failures[:5]
    assert fired > 0 and s_end[target] > 0, fault
    assert all(v == 0 for v in s0.values()), s0
    assert all(v == 0 for kk, v in s_end.items() if kk != target), s_end
    assert s_after == s_end, (s_end, s_after)
    assert healed, health
    assert mesh.n_shards == 2 * S and killed_fired > 0, (mesh.n_shards, killed_fired)
    assert rec.programs == 0, rec.summary()
    assert rec_before >= MESH_RECALL_FLOOR and rec_after >= MESH_RECALL_FLOOR, (
        rec_before, rec_after)
    assert mesh.size == expect and ryw in (True, None), (mesh.size, expect, ryw)
    del mesh
    torch.cuda.synchronize()


def mesh_exact(st, x, xh, q, centers, tmp):
    """Phase 8 (d): a brute-force 4-shard mesh with a wal_dir, held against
    BruteForce.search, crashed at reshard/flip and recovered."""
    import numpy as np
    import torch

    from raft_tpu_torch import stream
    from raft_tpu_torch.core import Resources
    from raft_tpu_torch.neighbors.brute_force import BruteForce
    from raft_tpu_torch.testing import faults

    res = Resources(device="cuda")
    dev = torch.device("cuda")
    S = 4

    def build(rows):
        return BruteForce("sqeuclidean").build(torch.from_numpy(rows).to(dev), res=res)

    wal_dir = os.path.join(tmp, "mesh_exact")
    mesh_reset(st)
    t0 = time.perf_counter()
    mesh = stream.ShardedMutableIndex(xh, n_shards=S, build=build, delta_capacity=MESH_CAP,
                                      wal_dir=wal_dir, name="mesh_exact")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    qf = q[:TIER_FLUSH].contiguous()
    bd, bi = mesh.search(q, K_MAIN)
    fd, fi = mesh.search(qf, K_MAIN)
    torch.cuda.synchronize()
    with uncounted():
        ref = BruteForce("sqeuclidean").build(x, res=res)
        rd, ri = ref.search(q, K_MAIN)
        rfd, rfi = ref.search(qf, K_MAIN)
    err = max(knn_equiv(bd, bi, rd, ri, 1e-5, 1e-5), knn_equiv(fd, fi, rfd, rfi, 1e-5, 1e-5))
    ids_equal = (int((bi == ri).all(1).sum()), int((fi == rfi).all(1).sum()))
    del ref, rd, ri, rfd, rfi, bd, bi, fd, fi
    batch_s = timed(lambda: mesh.search(q, K_MAIN), 3)

    # the writer's burst, on the durable mesh and an uncrashed twin
    twin = stream.ShardedMutableIndex(xh, n_shards=S, build=build, delta_capacity=MESH_CAP,
                                      name="mesh_exact_twin")
    rows = blobs(MESH_BURST_STEPS * STREAM_UPSERTS, centers, 45, 0.5)[0].cpu().numpy()
    rng = np.random.default_rng(46)
    t0 = time.perf_counter()
    for step in range(MESH_BURST_STEPS):
        lo = step * STREAM_UPSERTS
        ids = 4_000_000 + np.arange(lo, lo + STREAM_UPSERTS)
        dels = rng.choice(N_MAIN, STREAM_DELETES, replace=False)
        for m in (mesh, twin):
            m.upsert(rows[lo:lo + STREAM_UPSERTS], ids=ids)
            m.delete(dels)
    burst_s = time.perf_counter() - t0
    with faults.scope():
        faults.inject("reshard/flip", faults.SimulatedCrash("kill -9"))
        t0 = time.perf_counter()
        try:
            mesh.reshard(2 * S)
            crashed = False
        except faults.SimulatedCrash:
            crashed = True
        crash_s = time.perf_counter() - t0
    assert crashed, "the injected crash at reshard/flip did not fire"
    del mesh                         # the process is gone; the directory stays
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec = stream.ShardedMutableIndex.load(wal_dir, build=build, res=res)
    torch.cuda.synchronize()
    recovery_s = time.perf_counter() - t0
    qc = q[:MESH_CHECK]
    got, want = rec.search(qc, K_MAIN), twin.search(qc, K_MAIN)
    torch.cuda.synchronize()
    same = bit_equal(got, want)
    mesh_reset(st)
    emit(phase="mesh", part="d", kind="brute_force", shards=S, build_seconds=build_s,
         wal_dir_files=sorted(os.listdir(wal_dir)), max_abs_err=err,
         rows_with_equal_ids={"batch": ids_equal[0], "flush": ids_equal[1]},
         qps_batch=CAGRA_Q / batch_s, burst_steps=MESH_BURST_STEPS, burst_seconds=burst_s,
         crash_at="reshard/flip", reshard_to=2 * S, crash_seconds=crash_s,
         recovered_shards=rec.n_shards, recovery_seconds=recovery_s,
         replayed=rec.last_recovery["replayed"], torn=rec.last_recovery["torn"],
         recovered_equal_twin=same, size=rec.size, twin_size=twin.size, card=st["card"])
    assert rec.n_shards == S and rec.last_recovery["replayed"] > 0, rec.last_recovery
    assert same and rec.size == twin.size, (same, rec.size, twin.size)
    del rec, twin
    torch.cuda.synchronize()


def mesh_tiered(st):
    """Phase 8 (e): phase 2's IVF-PQ parameters as a 4-shard tiered mesh
    beside an all-HBM twin over the same sealed indexes."""
    import torch

    from raft_tpu_torch import stream
    from raft_tpu_torch.core import Resources
    from raft_tpu_torch.neighbors import ivf_pq

    res = Resources(device="cuda")
    dev = torch.device("cuda")
    S, r = 4, 4
    _, q = st["ivf"]
    xh = st["ivf_x"].cpu().numpy()
    params = ivf_pq.IndexParams(n_lists=1024, pq_bits=4, pq_dim=64, seed=0)
    sp = ivf_pq.SearchParams(n_probes=8, lut_dtype="bfloat16")
    built = []

    def build(rows):
        built.append(ivf_pq.build(params, torch.from_numpy(rows).to(dev), res=res))
        return built[-1]

    mesh_reset(st)
    t0 = time.perf_counter()
    tiered = stream.ShardedMutableIndex(xh, n_shards=S, build=build, search_params=sp,
                                        delta_capacity=MESH_CAP, storage="tiered",
                                        name="mesh_tier")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    prebuilt = iter(built)
    hbm = stream.ShardedMutableIndex(xh, n_shards=S, build=lambda rows: next(prebuilt),
                                     search_params=sp, delta_capacity=MESH_CAP,
                                     name="mesh_tier_hbm")
    stores = [sh.tiered_store for sh in tiered.shards]
    assert all(ts.residency == "host" and not ts.mirror_resident for ts in stores)
    qf = q[:TIER_FLUSH].contiguous()
    equal = (bit_equal(hbm.search_refined(q, K_MAIN, r), tiered.search_refined(q, K_MAIN, r))
             and bit_equal(hbm.search_refined(qf, K_MAIN, r),
                           tiered.search_refined(qf, K_MAIN, r)))
    torch.cuda.synchronize()
    h0 = sum(ts.stats()["h2d_bytes"] for ts in stores)
    tiered.search_refined(q, K_MAIN, r)
    torch.cuda.synchronize()
    h2d = sum(ts.stats()["h2d_bytes"] for ts in stores) - h0
    expect = IVF_Q * S * K_MAIN * r * D_MAIN * 4
    mesh_reset(st)
    tier_s = timed(lambda: tiered.search_refined(q, K_MAIN, r), 3)
    counts = all_counts()
    hbm_s = timed(lambda: hbm.search_refined(q, K_MAIN, r), 3)
    mesh_reset(st)
    emit(phase="mesh", part="e", shards=S, n=N_MAIN, d=D_MAIN, m=IVF_Q, k=K_MAIN,
         refine_ratio=r, params="n_lists=1024, pq_dim=64, pq_bits=4 a shard",
         build_seconds=build_s, refined_bit_equal=equal, h2d_bytes_per_batch=h2d,
         h2d_expected=expect, qps_batch_tiered=IVF_Q / tier_s, qps_batch_hbm=IVF_Q / hbm_s,
         launches_per_tiered_batch={kk: v / 3 for kk, v in counts.items() if v},
         residency=[ts.residency for ts in stores], card=st["card"])
    assert equal, "the tiered mesh's search_refined differs from its all-HBM twin"
    assert h2d == expect, (h2d, expect)
    assert counts["pq_scan_topk"] > 0, counts
    del tiered, hbm, built, stores
    torch.cuda.synchronize()


def phase_mesh(st):
    """Phase 8: the sharded and replicated mesh on one card (see the module
    docstring)."""
    import tempfile

    import torch

    t_phase = time.perf_counter()
    reset_all_counts()
    st["launches_mesh"] = {}
    dev = torch.device("cuda")
    x, q, _, _ = cagra_data()
    xh = x.cpu().numpy()
    pool = q.cpu().numpy()
    centers = 10.0 * torch.rand((CAGRA_CENTERS, D_MAIN), device=dev,
                                generator=torch.Generator(device=dev).manual_seed(20))
    mesh = mesh_ladder(st, xh, q, pool, centers)
    mesh_churn(st, mesh, pool, centers)
    del mesh
    torch.cuda.synchronize()
    mesh_replicas(st, xh, q, pool, centers)
    with tempfile.TemporaryDirectory() as tmp:
        mesh_exact(st, x, xh, q, centers, tmp)
    del x, xh
    mesh_tiered(st)
    mesh_reset(st)
    total = st["launches_mesh"]
    for name in ("fused_knn", "topk", "pq_scan_topk"):
        assert total.get(name, 0) > 0, (name, total)
    emit(phase="mesh_launches", launches=total, launches_folds=st.get("launches_mesh_folds"),
         seconds=time.perf_counter() - t_phase, card=st["card"])


TUNE_K, TUNE_REPEATS = 10, 3
TUNE_SERVE_THREADS, TUNE_SERVE_PER_THREAD = 4, 64   # served rows held against make_searcher
TUNE_SELECT_ROWS = (10_000, 128)
TUNE_SELECT_COLS = (256, 512, 1_024, 2_048, 4_096, 16_384, 65_536, 131_072)
TUNE_SELECT_KS = (10, 128)
TUNE_SAMPLE = 100_000            # warmup's data sample: rows of phase 2's clustered sets
WARM_CACHE = """
import json, sys
sys.path.insert(0, {root!r})
import raft_tpu_torch
out = raft_tpu_torch.warmup("brute_force", n=100_000, d=128, cache_dir={cache!r})
print(json.dumps(out))
"""


def tune_sweeps(st):
    """Phase 9 (a): each kind's default grid over phase 2's 1M index,
    10,000 queries, k = 10, ``repeats=3``; ground truth through the
    sweep's own ``knn`` held against phase 2's, the grid head's recall
    against a direct search at its params. Returns {kind: (index, dataset,
    queries, decision)} and the decision log."""
    import torch

    from raft_tpu_torch import tune
    from raft_tpu_torch.core import Resources
    from raft_tpu_torch.neighbors import cagra, ivf_flat, ivf_pq
    from raft_tpu_torch.neighbors.refine import refine

    sweep_mod = importlib.import_module("raft_tpu_torch.tune.sweep")  # tune.sweep: the function
    res = Resources(device="cuda")
    cx, _, _, _ = cagra_data()
    pq_index, pq_q = st["ivf"]
    cindex, cq = st["cagra"]
    findex, _ = st["ivf_flat"]
    cases = {
        "ivf_flat": (findex, cx, cq, st["cagra_truth"],
                     lambda q: ivf_flat.search(ivf_flat.SearchParams(n_probes=8), findex, q,
                                               TUNE_K, res=res)),
        "ivf_pq": (pq_index, st["ivf_x"], pq_q, st["ivf_truth"],
                   lambda q: refine(st["ivf_x"], q, ivf_pq.search(
                       ivf_pq.SearchParams(n_probes=8), pq_index, q, 4 * TUNE_K,
                       res=res)[1], TUNE_K, res=res)),
        "cagra": (cindex, cx, cq, st["cagra_truth"],
                  lambda q: cagra.search(cagra.SearchParams(itopk_size=32), cindex, q,
                                         TUNE_K, res=res)),
    }
    log = tune.DecisionLog(meta={"round": tune.reference.ROUND, "card": st["card"]})
    out = {}
    for kind, (index, x, q, truth, direct) in cases.items():
        gt_t0 = time.perf_counter()
        gt = sweep_mod._ground_truth(x, q, TUNE_K, metric=index.metric, res=res)
        gt_s = time.perf_counter() - gt_t0
        gt_dev = torch.from_numpy(gt).to(q.device)
        gt_match = recall(gt_dev[:truth.shape[0]], truth)
        grid = tune.default_grid(kind)
        t0 = time.perf_counter()
        dec = tune.sweep(index, q, k=TUNE_K, dataset=x, gt=gt, grid=grid,
                         repeats=TUNE_REPEATS, log=log)
        sweep_s = time.perf_counter() - t0
        ev = dec.evidence
        head = round(sweep_mod._recall(direct(q)[1], gt), 4)
        emit(phase="tune_sweep", kind=kind, family=dec.family, n=ev["n"], queries=ev["queries"],
             k=TUNE_K, repeats=TUNE_REPEATS, grid_points=len(grid),
             trials=[dict(params=t["params"], recall=t.get("recall"), qps=t.get("qps"),
                          wall_s=t["wall_s"], error=t.get("error")) for t in ev["trials"]],
             frontier=ev["frontier"], chosen=dec.params, chosen_recall=ev["chosen_recall"],
             chosen_qps=ev["chosen_qps"], default_recall=ev["default_recall"],
             default_qps=ev["default_qps"],
             chosen_qps_over_default=ev["chosen_qps_over_default"],
             recall_target=ev["recall_target"], target_met=ev["target_met"],
             head_direct_recall=head, ground_truth_s=gt_s,
             ground_truth_equals_phase2=gt_match, sweep_s=sweep_s, card=st["card"])
        assert len(ev["trials"]) == len(grid) and all("error" not in t for t in ev["trials"]), (
            kind, ev["trials"])
        assert ev["target_met"] and ev["chosen_recall"] >= ev["recall_target"], (kind, ev)
        assert head == ev["trials"][0]["recall"], (kind, head, ev["trials"][0])
        assert gt_match == 1.0, (kind, gt_match)
        out[kind] = (index, x, q, dec)
    return out, log


def tune_serve(st, swept, log):
    """Phase 9 (b): attach, save, load; ``publish(tuned=True)`` and
    ``publish(tuned=log)`` for each kind (an IVF-PQ refine pin publishes
    ``make_searcher(index, log, dataset=rows)`` instead, as the JAX
    package's publish says); served rows against ``make_searcher`` at their
    own shapes, 0 builds in the window, the report's ``"tuned"``."""
    import tempfile

    import torch

    from raft_tpu_torch import tune
    from raft_tpu_torch.core import RaftError, Resources
    from raft_tpu_torch.neighbors import cagra, ivf_flat, ivf_pq
    from raft_tpu_torch.obs import RequestLog
    from raft_tpu_torch.obs import compile as obs_compile
    from raft_tpu_torch.serve import SearchService

    res = Resources(device="cuda")
    mods = {"ivf_flat": ivf_flat, "ivf_pq": ivf_pq, "cagra": cagra}
    log_r = RequestLog(capacity=8192)
    svc = SearchService(max_batch=SERVE_MAX_BATCH, max_wait_us=SERVE_WAIT_US,
                        request_log=log_r)
    n_req = TUNE_SERVE_THREADS * TUNE_SERVE_PER_THREAD
    try:
        for kind, (index, x, q, dec) in swept.items():
            mod = mods[kind]
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, f"{kind}.bin")
                tune.attach(index, dec)
                try:
                    t0 = time.perf_counter()
                    mod.save(index, path)
                    loaded = mod.load(path, res=res)
                    io_s = time.perf_counter() - t0
                finally:
                    index.tuned = None
            assert loaded.tuned == dec.to_dict(), kind
            refine_pin = int(dec.params.get("refine_ratio", 1)) > 1
            publishes = {}
            if refine_pin:
                try:
                    svc.publish(f"{kind}-pin", loaded, tuned=True, k=TUNE_K)
                    raise AssertionError("a refine pin published without its rows")
                except RaftError as e:
                    assert "raw rows" in str(e), e
                publishes["log"] = lambda: svc.publish(
                    f"{kind}-log", tune.make_searcher(loaded, log, dataset=x), k=TUNE_K)
                # the loaded index's own hook: the pin without its refine epilogue
                publishes["pin"] = lambda: svc.publish(f"{kind}-pin", loaded, k=TUNE_K)
            else:
                publishes["pin"] = lambda: svc.publish(f"{kind}-pin", loaded, tuned=True,
                                                       k=TUNE_K)
                publishes["log"] = lambda: svc.publish(f"{kind}-log", loaded, tuned=log,
                                                       k=TUNE_K)
            pool = q[:n_req].cpu().numpy()
            for how, publish in publishes.items():
                name = f"{kind}-{how}"
                report = publish()
                assert report["tuned"] == dec.key, (name, report["tuned"], dec.key)
                with svc.registry.lease(name) as v:
                    searcher = v.searcher
                direct = tune.make_searcher(
                    loaded, dec, dataset=x if (refine_pin and how == "log") else None,
                    degrade_without_rows=True)
                with obs_compile.attribution() as rec:
                    lats, results, failures, load_s, _ = serve_load(
                        svc, name, pool, TUNE_SERVE_THREADS, TUNE_SERVE_PER_THREAD, TUNE_K,
                        n_req)
                torch.cuda.synchronize()
                rows, ok, _ = served_rows_equal(results, log_r, (direct,), pool, TUNE_K)
                emit(phase="tune_serve", kind=kind, publish=how, hook_kind=searcher.kind,
                     tuned=report["tuned"], refine_pin=refine_pin, save_load_s=io_s,
                     requests=n_req, failed=len(failures), qps=(n_req - len(failures)) / load_s,
                     checked_rows=len(rows), rows_equal_make_searcher=int(ok.sum()),
                     builds_in_window=rec.summary(),
                     warm_builds=sum(b["programs"] for b in report["warm"][TUNE_K].values()),
                     card=st["card"])
                assert not failures, failures[:5]
                assert rec.programs == 0 and rec.cache_misses == 0, rec.summary()
                assert bool(ok.all()), f"{name}: {int((~ok).sum())} served rows differ"
    finally:
        svc.shutdown()


def tune_select_k(st):
    """Phase 9 (c): ``sweep_select_k`` at 10,000 and 128 rows; returns the
    decisions by rows."""
    from raft_tpu_torch import tune
    from raft_tpu_torch.core import Resources
    from raft_tpu_torch.matrix.select_k import WIDE_SELECT_COLS_DEFAULT, wide_cols_threshold

    res = Resources(device="cuda")
    out = {}
    for rows in TUNE_SELECT_ROWS:
        t0 = time.perf_counter()
        dec = tune.sweep_select_k(rows=rows, cols=TUNE_SELECT_COLS, ks=TUNE_SELECT_KS,
                                  repeats=TUNE_REPEATS, res=res)
        ev = dec.evidence
        by = {}
        for t in ev["trials"]:
            p = t["params"]
            by.setdefault((p["cols"], p["k"]), {})[p["impl"]] = t.get("qps")
        emit(phase="tune_select_k", rows=rows, cols=list(TUNE_SELECT_COLS),
             ks=list(TUNE_SELECT_KS), repeats=TUNE_REPEATS,
             ms={f"{c}x{k}": {impl: (rows / qps * 1e3 if qps else None)
                              for impl, qps in arms.items()}
                 for (c, k), arms in sorted(by.items())},
             kernel_wins={f"{c}x{k}": (arms.get("kernel") or 0) > (arms.get("torch") or 0)
                          for (c, k), arms in sorted(by.items())},
             crossover_cols=dec.params["wide_cols_min"],
             default_cols=WIDE_SELECT_COLS_DEFAULT, kernel_measured=ev["kernel_measured"],
             backend=ev["backend"], seconds=time.perf_counter() - t0, card=st["card"])
        assert ev["kernel_measured"] and ev["backend"] == "cuda", ev
        assert all("error" not in t for t in ev["trials"]), ev["trials"]
        assert wide_cols_threshold() == WIDE_SELECT_COLS_DEFAULT
        out[rows] = dec
    return out


def tune_apply_global(st, decisions):
    """Phase 9 (b), the process-wide pin: each row count's select_k decision
    applies inside a scope and resets to the default after it; a log whose
    kernel arm was not measured moves nothing."""
    from raft_tpu_torch import tune
    from raft_tpu_torch.matrix.select_k import (WIDE_SELECT_COLS_DEFAULT,
                                                set_wide_cols_threshold, wide_cols_threshold)

    applied = {}
    for rows, dec in decisions.items():
        log = tune.DecisionLog()
        log.add(dec)
        try:
            got = tune.apply_global(log)
            assert got == {"select_k.wide_cols_min": dec.params["wide_cols_min"]}, got
            assert wide_cols_threshold() == dec.params["wide_cols_min"]
            applied[rows] = got
        finally:
            set_wide_cols_threshold(None)
        assert wide_cols_threshold() == WIDE_SELECT_COLS_DEFAULT
    unmeasured = tune.DecisionLog()
    unmeasured.add(tune.Decision(kind="select_k", dtype="float32", family="wide",
                                 params={"wide_cols_min": 65536},
                                 evidence={"pallas_measured": False, "trials": []}))
    assert tune.apply_global(unmeasured) == {}
    assert wide_cols_threshold() == WIDE_SELECT_COLS_DEFAULT
    emit(phase="tune_apply_global", applied={str(r): a for r, a in applied.items()},
         reset_to=WIDE_SELECT_COLS_DEFAULT, unmeasured_applied=False, card=st["card"])


def tune_warmup(st):
    """Phase 9 (d): ``warmup`` of each kind at 1M x 128 in this process
    (IVF-Flat, IVF-PQ and CAGRA on a 100,000-row sample of phase 2's
    clustered sets), then ``warmup("brute_force", n=100_000)`` in two fresh
    processes sharing an empty cache directory: the first builds, the
    second loads."""
    import tempfile

    import raft_tpu_torch
    from raft_tpu_torch.core import Resources

    res = Resources(device="cuda")
    cx, _, _, _ = cagra_data()
    samples = {"brute_force": None, "ivf_flat": cx[:TUNE_SAMPLE],
               "ivf_pq": st["ivf_x"][:TUNE_SAMPLE], "cagra": cx[:TUNE_SAMPLE]}
    for kind, sample in samples.items():
        t0 = time.perf_counter()
        out = raft_tpu_torch.warmup(kind, n=N_MAIN, d=D_MAIN, k=TUNE_K, data=sample, res=res)
        emit(phase="tune_warmup", kind=kind, n=N_MAIN, d=D_MAIN, queries=10_000,
             sample_rows=None if sample is None else TUNE_SAMPLE,
             wall_s=time.perf_counter() - t0, **out, card=st["card"])
        assert out["attribution"] == "obs.compile" and out["build"]["programs"] == 0, out
    del cx, samples
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as cache:
        runs = []
        for attempt in ("cold", "warm"):
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-c", WARM_CACHE.format(root=root, cache=cache)],
                                  capture_output=True, text=True, timeout=600)
            assert proc.returncode == 0, proc.stderr[-2000:]
            out = json.loads(proc.stdout.strip().splitlines()[-1])
            programs = out["build"]["programs"] + out["search"]["programs"]
            hits = out["build"]["cache_hits"] + out["search"]["cache_hits"]
            emit(phase="tune_warmup_cache", attempt=attempt, kind="brute_force", n=100_000,
                 d=D_MAIN, programs=programs, cache_hits=hits,
                 process_s=time.perf_counter() - t0, **out, card=st["card"])
            runs.append((programs, hits))
        assert runs[0][0] >= 1, runs
        assert runs[1][0] == 0 and runs[1][1] >= 1, runs


def tune_cancel_and_output(st):
    """Phase 9 (e): a worker's IVF-PQ search loop cancelled from the main
    thread at its next ``core.interruptible.synchronize`` (within one
    search), the token reset; then every decorated entry point, a served
    flush and a mutable-index search under ``config.set_output_as("numpy")``
    against the ``"torch"`` setting."""
    import threading

    import numpy as np
    import torch

    from raft_tpu_torch import config
    from raft_tpu_torch.core import Resources
    from raft_tpu_torch.neighbors import brute_force, cagra, ivf_flat, ivf_pq
    from raft_tpu_torch.serve import SearchService
    from raft_tpu_torch.stream import MutableIndex

    # core.interruptible: the module (the name alone is its context manager)
    interruptible = importlib.import_module("raft_tpu_torch.core.interruptible")
    res = Resources(device="cuda")
    pq_index, pq_q = st["ivf"]
    sp = ivf_pq.SearchParams(n_probes=8, lut_dtype="bfloat16")
    state = {"done": 0, "at_cancel": None, "error": None, "reset": None}
    started = threading.Event()

    def worker():
        state["ident"] = threading.get_ident()
        try:
            while True:
                d, i = ivf_pq.search(sp, pq_index, pq_q, IVF_K0, res=res)
                interruptible.synchronize(d, i)
                state["done"] += 1
                if state["done"] == 2:
                    started.set()
                if state["done"] > 1000:
                    break
        except interruptible.InterruptedException as e:
            state["error"] = str(e)
            interruptible.synchronize()          # the token reset on the throw
            state["reset"] = not interruptible.get_token().cancelled()

    t = threading.Thread(target=worker)
    t0 = time.perf_counter()
    t.start()
    assert started.wait(120), "the worker never finished two searches"
    state["at_cancel"] = state["done"]
    tc = time.perf_counter()
    interruptible.cancel(state["ident"])
    t.join(120)
    stop_s = time.perf_counter() - tc
    after = state["done"] - state["at_cancel"]
    emit(phase="tune_cancel", searches_before_cancel=state["at_cancel"],
         searches_after_cancel=after, stop_s=stop_s, error=state["error"],
         token_reset=state["reset"], loop_s=tc - t0, card=st["card"])
    assert not t.is_alive() and state["error"] == "raft_tpu task cancelled", state
    assert after <= 1 and state["reset"], state

    cx, _, _, _ = cagra_data()
    cindex, cq = st["cagra"]
    findex, fsp = st["ivf_flat"]
    m = IVF_CHECK
    calls = {
        "knn": lambda: brute_force.knn(cx, cq[:m], TUNE_K, res=res),
        "ivf_flat.search": lambda: ivf_flat.search(fsp, findex, cq[:m], TUNE_K, res=res),
        "ivf_pq.search": lambda: ivf_pq.search(sp, pq_index, pq_q[:m], TUNE_K, res=res),
        "cagra.search": lambda: cagra.search(cagra.SearchParams(itopk_size=32), cindex,
                                             cq[:m], TUNE_K, res=res),
    }
    mut = MutableIndex(pq_index, search_params=sp, delta_capacity=4096,
                       retain_vectors=False)
    mut.upsert(pq_q[:64].cpu().numpy())
    svc = SearchService(max_batch=SERVE_MAX_BATCH, max_wait_us=SERVE_WAIT_US)
    try:
        svc.publish("flat", findex, search_params=fsp, k=TUNE_K)
        pool = cq[:256].cpu().numpy()

        def served():
            futs = [svc.submit("flat", pool[j:j + 1], TUNE_K) for j in range(pool.shape[0])]
            return [f.result(timeout=120) for f in futs]

        torch_out = {name: fn() for name, fn in calls.items()}
        torch_mut = mut.search(pq_q[:m], TUNE_K)
        torch_served = served()
        config.set_output_as("numpy")
        try:
            numpy_out = {name: fn() for name, fn in calls.items()}
            numpy_mut = mut.search(pq_q[:m], TUNE_K)
            numpy_served = served()
        finally:
            config.set_output_as("torch")
    finally:
        svc.shutdown()
    same = {}
    for name in calls:
        a, b = torch_out[name], numpy_out[name]
        assert all(isinstance(v, np.ndarray) for v in b), (name, [type(v) for v in b])
        same[name] = all(np.array_equal(x.cpu().numpy(), y) for x, y in zip(a, b))
    mut_on_card = all(isinstance(v, torch.Tensor) and v.is_cuda for v in numpy_mut)
    same["mutable.search"] = mut_on_card and all(torch.equal(x, y)
                                                 for x, y in zip(torch_mut, numpy_mut))
    same["served_flush"] = all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
                               for a, b in zip(torch_served, numpy_served))
    emit(phase="tune_output_as", rows=m, equal=same, mutable_on_card=mut_on_card,
         card=st["card"])
    assert all(same.values()), same


def phase_tune(st):
    """Phase 9: the autotuner and the deploy-time surface on one card (see
    the module docstring)."""
    import torch

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    reset_all_counts()
    swept, log = tune_sweeps(st)
    tune_serve(st, swept, log)
    del swept
    decisions = tune_select_k(st)
    tune_apply_global(st, decisions)
    tune_warmup(st)
    tune_cancel_and_output(st)
    torch.cuda.synchronize()
    total = st["launches_tune"] = {kk: v for kk, v in all_counts().items() if v}
    for name in ("fused_knn", "topk", "pq_scan_topk", "cagra_hop"):
        assert total.get(name, 0) > 0, (name, total)
    emit(phase="tune_launches", launches=total, seconds=time.perf_counter() - t_phase,
         card=st["card"])


# -- phase a: the network front door, the process mesh, the controller, the exporter --

NET_THREADS, NET_PER_THREAD = (1, 4, 8), 150     # bench.py:3345 _row_net_serve
NET_OTHER = 100                  # wire requests to each of the other three names, one at a time
NET_EVAL = 1_000                 # recall@10 queries, in 64-row batches, in process and over the wire
NET_KILL_THREADS, NET_KILL_S, NET_KILL_AT_S = 6, 8.0, 3.0   # bench.py:3475 _row_net_kill_worker
NET_KILL_CHECK = 256             # queries held id for id against an exact search after the kill
CTL_GRID = [{"n_probes": 8}, {"n_probes": 16}, {"n_probes": 32}]   # the retune's bounded sweep
CTL_CANARY = 128                 # the sweep's queries (bench.py:2560)
CTL_RAMP_STEPS, CTL_RAMP_ROWS = 8, 512   # bench.py:2643 _row_controller_ramp
CTL_DELTA = 8_192


class FakeClock:
    """An injected clock: the degrade / restore hysteresis without sleeping."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def net_reset(st):
    """Add the launches since the last reset to phase a's total, then reset."""
    add_counts(st.setdefault("launches_net", {}), all_counts())
    reset_all_counts()


def net_rung(call, pool, threads, per_thread, tag):
    """One rung of a closed loop: ``threads`` threads each make
    ``per_thread`` one-row calls ``call(row, rid) -> (d, i, spans)`` and
    wait for each. Returns QPS, p50 / p99 and the per-request spans' p99s,
    the answers by row (with their request ids) and the failures."""
    import threading

    import numpy as np

    lats, results, spans, failures = [], {}, [], []
    lock = threading.Lock()

    def worker(tid):
        for j in range(per_thread):
            qi = (tid + j * threads) % pool.shape[0]
            rid = f"{tag}-{threads}-{tid}-{j}"
            t0 = time.perf_counter()
            try:
                d, i, sp = call(pool[qi:qi + 1], rid)
            except Exception as e:  # every loss is counted and fails the phase
                with lock:
                    failures.append(f"{type(e).__name__}: {str(e)[:120]}")
                continue
            lat = time.perf_counter() - t0
            with lock:
                lats.append(lat)
                results[qi] = (d[0], i[0], rid)
                if sp:
                    spans.append(sp)

    ws = [threading.Thread(target=worker, args=(t,)) for t in range(threads)]
    t0 = time.perf_counter()
    for w in ws:
        w.start()
    for w in ws:
        w.join(600)
        assert not w.is_alive(), "a closed-loop thread did not finish"
    wall = time.perf_counter() - t0
    lat = np.sort(np.array(lats)) * 1e3
    out = dict(threads=threads, requests=threads * per_thread, qps=len(lats) / wall,
               p50_ms=float(lat[len(lat) // 2]), p99_ms=float(lat[int(len(lat) * 0.99) - 1]),
               failed=len(failures))
    if spans:
        out["spans_p99_ms"] = {key: float(np.quantile([s[key] for s in spans if key in s], 0.99)
                                          * 1e3)
                               for key in ("wire", "queue", "flush")
                               if any(key in s for s in spans)}
        out["requests_with_spans"] = len(spans)
    return out, results, failures


def net_front_door(st, tracker):
    """Phase a (a): the four indexes of phase 2 on one ``SearchService``
    (phase 4's settings) behind a ``NetServer``; the closed-loop ladder on
    ``serve`` in process and over loopback, recall both ways, 100 wire
    requests to each other name. Returns the service, its request log, the
    front door and the brute-force index."""
    import numpy as np
    import torch

    from raft_tpu_torch import obs
    from raft_tpu_torch.core import Resources
    from raft_tpu_torch.neighbors import brute_force, cagra, ivf_pq
    from raft_tpu_torch.net import NetClient, NetServer
    from raft_tpu_torch.obs import RequestLog
    from raft_tpu_torch.obs import compile as obs_compile
    from raft_tpu_torch.serve import SearchService

    res = Resources(device="cuda")
    index, q = st["ivf"]
    x, truth = st["ivf_x"], st["ivf_truth"]
    serving = pq_refine_hook(index, x, ivf_pq.SearchParams(n_probes=8, lut_dtype="bfloat16"))
    xm, qm = st["main"]
    cindex, qc = st["cagra"]
    findex, fsp = st["ivf_flat"]
    bf = brute_force.BruteForce("sqeuclidean").build(xm, res=res)
    log = RequestLog(capacity=16_384)
    svc = SearchService(max_batch=SERVE_MAX_BATCH, max_wait_us=SERVE_WAIT_US,
                        max_queue_rows=4 * SERVE_MAX_BATCH * SERVE_THREADS, request_log=log,
                        slo=tracker)
    svc.publish("serve", serving, k=K_MAIN)
    svc.publish("brute_force", bf, k=K_MAIN)
    svc.publish("ivf_flat", findex, search_params=fsp, k=K_MAIN)
    svc.publish("cagra", cindex, search_params=cagra.SearchParams(itopk_size=CAGRA_ITOPK),
                k=K_MAIN)
    srv = NetServer(svc, request_log=log)
    cli = NetClient(f"http://127.0.0.1:{srv.port}")
    pool = q.cpu().numpy()
    # first calls of both paths outside the window (publish warmed the ladder)
    svc.search("serve", pool[:1], K_MAIN)
    cli.search("serve", pool[:1], K_MAIN)
    torch.cuda.synchronize()

    def in_process(row, rid):
        d, i = svc.submit("serve", row, K_MAIN, rid=rid).result(timeout=120)
        return d, i, None

    def over_wire(row, rid):
        d, i, meta = cli.request("serve", row, K_MAIN, rid=rid)
        return d, i, meta["spans"]

    net_reset(st)                 # the publishes' warm ladders count in phase a's total
    before = dict(st["launches_net"])
    rungs, checks, failures = {"inproc": [], "wire": []}, {}, []
    with obs_compile.attribution() as rec:
        for path, call in (("inproc", in_process), ("wire", over_wire)):
            for threads in NET_THREADS:
                rung, results, lost = net_rung(call, pool, threads, NET_PER_THREAD, path)
                rungs[path].append(rung)
                failures += lost
                if threads == NET_THREADS[-1]:
                    checks[path] = results

        def batches(search):
            return np.concatenate([search(pool[b:min(b + SERVE_MAX_BATCH, NET_EVAL)])
                                   for b in range(0, NET_EVAL, SERVE_MAX_BATCH)])

        ids_in = batches(lambda qb: svc.search("serve", qb, K_MAIN)[1])
        ids_wire = batches(lambda qb: cli.search("serve", qb, K_MAIN)[1])
        others = {}
        for name, qsrc in (("brute_force", qm), ("ivf_flat", qc), ("cagra", qc)):
            opool = qsrc[:NET_OTHER].cpu().numpy()
            got = {}
            t0 = time.perf_counter()
            for r in range(NET_OTHER):
                rid = f"wire-{name}-{r}"
                d, i, _ = cli.request(name, opool[r:r + 1], K_MAIN, rid=rid)
                got[r] = (d[0], i[0], rid)
            others[name] = (opool, got, NET_OTHER / (time.perf_counter() - t0))
    torch.cuda.synchronize()
    net_reset(st)
    window = {kk: v - before.get(kk, 0) for kk, v in st["launches_net"].items()
              if v > before.get(kk, 0)}
    dev = torch.device("cuda")
    with uncounted():
        rows_ok = {}
        for path, results in checks.items():
            rows, ok, _ = served_rows_equal(results, log, (serving,), pool, K_MAIN)
            rows_ok[path] = (len(rows), int(ok.sum()))
        for name, (opool, got, _) in others.items():
            with svc.registry.lease(name) as v:
                searcher = v.searcher
            rows, ok, _ = served_rows_equal(got, log, (searcher,), opool, K_MAIN)
            rows_ok[name] = (len(rows), int(ok.sum()))
    rec_in = recall(torch.from_numpy(ids_in).to(dev), truth[:NET_EVAL])
    rec_wire = recall(torch.from_numpy(ids_wire).to(dev), truth[:NET_EVAL])
    top_in, top_wire = rungs["inproc"][-1]["qps"], rungs["wire"][-1]["qps"]
    hist = {"wire_total_ms": obs.metrics.quantile("raft_tpu_net_wire_seconds", 0.99,
                                                  route="/v1/search") * 1e3,
            "queue_ms": obs.metrics.quantile("raft_tpu_serve_queue_wait_seconds", 0.99,
                                             stream=f"serve.k{K_MAIN}") * 1e3,
            "flush_ms": obs.metrics.quantile("raft_tpu_serve_flush_seconds", 0.99,
                                             stream=f"serve.k{K_MAIN}") * 1e3}
    emit(phase="net", part="a", path="ivf_pq + refine behind NetServer (net_serve's protocol)",
         n=N_MAIN, d=D_MAIN, k=K_MAIN, max_batch=SERVE_MAX_BATCH, max_wait_us=SERVE_WAIT_US,
         per_thread=NET_PER_THREAD, ladder=rungs,
         wire_tax=top_in / top_wire, wire_tax_at_threads=NET_THREADS[-1],
         p99_split_histograms_ms=hist, recall_inproc=rec_in, recall_wire=rec_wire,
         eval_queries=NET_EVAL, ids_equal_inproc_wire=bool(np.array_equal(ids_in, ids_wire)),
         rows_equal_direct_search=rows_ok,
         other_names={n: dict(requests=NET_OTHER, qps_one_at_a_time=o[2])
                      for n, o in others.items()},
         builds_in_window=rec.summary(), launches=window, card=st["card"])
    assert not failures, failures[:5]
    assert rec.cache_misses == 0 and rec.programs == 0, rec.summary()
    assert rec_wire == rec_in and np.array_equal(ids_in, ids_wire), (rec_in, rec_wire)
    assert all(n == ok for n, ok in rows_ok.values()), rows_ok
    for name in ("pq_scan_topk", "fused_knn_rows", "topk", "cagra_hop"):
        assert window.get(name, 0) > 0, (name, window)
    return svc, log, srv, bf


def net_mesh(st, bf):
    """Phase a (b): a 2 x 2 ``ProcessMesh`` of brute force on the card over
    phase 2's exact set, behind a ``NetServer``: a 6-thread closed loop for
    8 s with one worker SIGKILLed at 3 s, the ids of 256 queries against
    an exact in-process search, then the twin killed too. Returns the mesh,
    its front door and the workers' launches."""
    import threading

    import numpy as np
    import torch

    from raft_tpu_torch.net import MeshSpec, NetClient, NetServer, ProcessMesh
    from raft_tpu_torch.obs import compile as obs_compile
    from raft_tpu_torch.obs import events as obs_events
    from raft_tpu_torch.serve import ReplicaUnavailableError

    x, qm = st["main"]
    xh = x.cpu().numpy()
    pool = qm[:2_000].cpu().numpy()
    seq0 = obs_events.last_seq()
    meminfo = dict(line.split(":", 1) for line in open("/proc/meminfo").read().splitlines())
    rss = [line for line in open("/proc/self/status").read().splitlines()
           if line.startswith("VmRSS")]
    free, total = torch.cuda.mem_get_info()
    before_boot = dict(host_available=meminfo["MemAvailable"].strip(),
                       router_rss=rss[0].split(":", 1)[1].strip(), device_free_bytes=free,
                       device_total_bytes=total, device_reserved_bytes=torch.cuda.memory_reserved(),
                       load_avg=os.getloadavg(), router_threads=threading.active_count())
    with obs_compile.attribution() as router:
        t0 = time.perf_counter()
        mesh = ProcessMesh(xh, spec=MeshSpec(n_shards=2, n_replicas=2, name="corpus",
                                             ks=(K_MAIN,), max_batch=SERVE_MAX_BATCH))
        boot_s = time.perf_counter() - t0
    del xh
    booted = mesh.stats()
    srv = NetServer(mesh, stats=mesh.stats)
    cli = NetClient(f"http://127.0.0.1:{srv.port}")
    failures, served, lats = [], [0], []
    lock = threading.Lock()
    done = threading.Event()

    def reader(tid):
        cnt, j, mine = 0, 0, []
        while not done.is_set():
            qi = (tid + j * NET_KILL_THREADS) % pool.shape[0]
            j += 1
            t = time.perf_counter()
            try:
                cli.search("corpus", pool[qi:qi + 1], K_MAIN)
            except Exception as e:  # every loss is counted and fails the phase
                with lock:
                    failures.append(f"{type(e).__name__}: {str(e)[:120]}")
                continue
            mine.append(time.perf_counter() - t)
            cnt += 1
        with lock:
            served[0] += cnt
            lats.extend(mine)

    ws = [threading.Thread(target=reader, args=(t,)) for t in range(NET_KILL_THREADS)]
    t_load = time.perf_counter()
    for w in ws:
        w.start()
    time.sleep(NET_KILL_AT_S)
    before_kill = mesh.stats()["per_worker"]
    killed = mesh.kill_worker(0, 0)
    kill_at = time.perf_counter() - t_load
    time.sleep(NET_KILL_S - NET_KILL_AT_S)
    done.set()
    for w in ws:
        w.join(60)
        assert not w.is_alive(), "a reader did not finish"
    load_s = time.perf_counter() - t_load
    kinds = [e["kind"] for e in obs_events.query(since_seq=seq0)]
    code_1, body_1 = cli.healthz()
    eval_q = pool[:NET_KILL_CHECK]
    got = [cli.search("corpus", eval_q[b:b + SERVE_MAX_BATCH], K_MAIN)
           for b in range(0, NET_KILL_CHECK, SERVE_MAX_BATCH)]
    dev = torch.device("cuda")
    got_d = torch.from_numpy(np.concatenate([g[0] for g in got])).to(dev)
    got_i = torch.from_numpy(np.concatenate([g[1] for g in got])).to(dev)
    with uncounted():
        ref_d, ref_i = bf.search(torch.from_numpy(eval_q).to(dev), k=K_MAIN)
    ok = row_equiv(got_d, got_i, ref_d, ref_i.long())
    after = mesh.stats()
    per_worker = {label: after["per_worker"].get(label, w)["launches"]
                  for label, w in before_kill.items()}
    launches = {}
    for counts in per_worker.values():
        add_counts(launches, counts)
    launches["fused_knn"] = launches.get("fused_knn_rows", 0) + launches.get(
        "fused_knn_tf32x3", 0)
    mesh.kill_worker(0, 1)
    try:
        cli.search("corpus", eval_q[:1], K_MAIN)
        outage = None
    except ReplicaUnavailableError as e:
        outage = dict(type=type(e).__name__, name=e.name, replicas=e.replicas,
                      fenced=e.fenced)
    code_2, body_2 = cli.healthz()
    lat = np.sort(np.array(lats)) * 1e3
    emit(phase="net", part="b", path="ProcessMesh 2 shards x 2 replicas of brute force "
                                     "(net_kill_worker's protocol)",
         n=N_MAIN, d=D_MAIN, k=K_MAIN, boot_wall_s=boot_s, worker_boot_s=mesh.boot_s,
         worker_boot_steps=mesh.boot_steps, before_boot=before_boot,
         router_builds=router.summary(),
         stats_at_boot={key: booted[key] for key in ("workers", "compile_s", "cache_misses",
                                                     "boot_compile_s", "boot_cache_misses",
                                                     "boot_cache_hits")},
         threads=NET_KILL_THREADS, load_s=load_s, served=served[0], qps=served[0] / load_s,
         p50_ms=float(lat[len(lat) // 2]), p99_ms=float(lat[int(len(lat) * 0.99) - 1]),
         failed=len(failures), killed_pid=killed, killed_at_s=kill_at,
         journal={kk: kinds.count(kk) for kk in ("net_worker_fenced", "net_worker_failover",
                                                 "net_worker_unfenced")},
         healthz_after_kill=(code_1, body_1["status"]),
         rows_equal_exact_search=(int(ok.sum()), NET_KILL_CHECK),
         stats_after=dict(workers=after["workers"], unreachable=after["unreachable"],
                          cache_misses=after["cache_misses"], compile_s=after["compile_s"]),
         twin_killed=dict(error=outage, healthz=(code_2, body_2["status"])),
         worker_launches=per_worker, card=st["card"])
    assert not failures, failures[:5]
    assert booted["workers"] == 4 and booted["cache_misses"] == 0 and booted["compile_s"] == 0
    assert booted["boot_cache_misses"] == 0 and router.cache_misses == 0, (booted, router)
    assert after["cache_misses"] == 0 and after["compile_s"] == 0, after
    assert "net_worker_fenced" in kinds and "net_worker_failover" in kinds, kinds
    assert (code_1, body_1["status"]) == (200, "degraded"), (code_1, body_1)
    assert bool(ok.all()), f"{int((~ok).sum())} of {NET_KILL_CHECK} rows differ after the kill"
    assert outage is not None and outage["replicas"] == 2 and outage["name"].endswith("/s0"), (
        outage)
    assert (code_2, body_2["status"]) == (503, "failing"), (code_2, body_2)
    assert launches.get("fused_knn_rows", 0) > 0, launches
    return mesh, srv, launches


def net_retune(st, reg, ctl, family, cx, cq):
    """Phase a (c) 1: the collapsed IVF-Flat pin retuned by the controller
    under a reader on the registry. Returns the tuned decision."""
    import threading

    import torch

    from raft_tpu_torch.obs import compile as obs_compile
    from raft_tpu_torch.obs import events as obs_events

    truth = st["cagra_truth"]
    eval_q = cq[:truth.shape[0]]

    def measure():
        ids = []
        for b in range(0, eval_q.shape[0], SERVE_MAX_BATCH):
            with reg.lease("drift") as v:
                ids.append(torch.as_tensor(v.searcher(eval_q[b:b + SERVE_MAX_BATCH], K_MAIN)[1]))
        return recall(torch.cat(ids).to(truth.device), truth)

    stop, out = threading.Event(), {"failed": 0, "served": 0}

    def reader():
        b = 0
        while not stop.is_set():
            try:
                with reg.lease("drift") as v:
                    v.searcher(cq[b:b + SERVE_MAX_BATCH], K_MAIN)
                out["served"] += 1
            except Exception:  # every loss is counted and fails the phase
                out["failed"] += 1
            b = (b + SERVE_MAX_BATCH) % (cq.shape[0] - SERVE_MAX_BATCH)

    with obs_compile.attribution() as rec:
        pre = measure()
        th = threading.Thread(target=reader)
        th.start()
        t0 = time.perf_counter()
        try:
            sensor = obs_events.emit("retune_advised", subject=("quality", "drift"),
                                     evidence={"drifted": True, "observed": family,
                                               "note": "emitted as the controller tests do"})
            handled = ctl.step()
        finally:
            step_s = time.perf_counter() - t0
            stop.set()
            th.join(60)
        post = measure()
        torch.cuda.synchronize()
    dec = obs_events.query(kind="control/decision", name="drift")[-1]
    done = obs_events.query(kind="control/action_completed", name="drift")[-1]
    pub = obs_events.query(kind="serve_published", name="drift")[-1]
    emit(phase="net", part="c1", path="controller retune: ivf_flat_1m pinned at n_probes=1",
         n=N_MAIN, d=D_MAIN, k=K_MAIN, grid=CTL_GRID, canary_queries=CTL_CANARY,
         recall_before=pre, recall_after=post, chosen=done["evidence"]["params"],
         version=reg.active("drift").version, step_s=step_s, reader_batches=out["served"],
         failed=out["failed"], builds_in_window=rec.summary(),
         chain=dict(sensor=sensor["seq"], decision=dec["seq"], completed=done["seq"],
                    published=pub["seq"]), card=st["card"])
    assert handled == 1 and out["failed"] == 0, (handled, out)
    assert post > pre, (pre, post)
    assert rec.cache_misses == 0 and rec.programs == 0, rec.summary()
    assert sensor["seq"] < dec["seq"] < done["seq"], (sensor["seq"], dec["seq"], done["seq"])
    assert dec["evidence"]["trigger_seq"] == sensor["seq"]
    assert done["evidence"]["decision_seq"] == dec["seq"]
    assert pub["evidence"]["cause"]["decision_seq"] == dec["seq"]
    return done["evidence"]["params"]


def net_reshard(st, ctl, cx, cq, centers):
    """Phase a (c) 2: an upsert ramp past ``reshard_rows_per_shard`` on a
    2-shard IVF-Flat mesh; the compactor's advice reaches the controller,
    which reshards to 4 under its headroom and burn checks while a reader
    searches the mesh."""
    import threading

    import torch

    from raft_tpu_torch import stream
    from raft_tpu_torch.core import Resources
    from raft_tpu_torch.neighbors import ivf_flat
    from raft_tpu_torch.obs import compile as obs_compile
    from raft_tpu_torch.obs import events as obs_events

    res = Resources(device="cuda")
    dev = torch.device("cuda")
    shards = 2
    params = ivf_flat.IndexParams(n_lists=IVF_FLAT_LISTS // shards, seed=0)
    sp = ivf_flat.SearchParams(n_probes=MESH_PROBES // shards)
    ramp = blobs(CTL_RAMP_STEPS * CTL_RAMP_ROWS, centers, 43, 0.5)[0].cpu().numpy()
    threshold = (N_MAIN + CTL_RAMP_STEPS * CTL_RAMP_ROWS // 2) // shards
    eval_q = cq[:SERVE_CHECK]

    def build(rows):
        return ivf_flat.build(params, torch.from_numpy(rows).to(dev), res=res)

    t0 = time.perf_counter()
    mesh = stream.ShardedMutableIndex(cx.cpu().numpy(), n_shards=shards, build=build,
                                      search_params=sp, delta_capacity=CTL_DELTA,
                                      retain_vectors=True, name="ramp")
    mesh.warm((SERVE_MAX_BATCH,), ks=(K_MAIN,))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    comp = stream.Compactor(mesh, policy=stream.CompactionPolicy(
        delta_fill=None, tombstone_ratio=None, reshard_rows_per_shard=threshold))
    ctl.attach_mesh(mesh, warm_buckets=(SERVE_MAX_BATCH,), ks=(K_MAIN,))
    ctl.attach_compactor(comp)

    def oracle_recall():
        return recall(mesh.search(eval_q, K_MAIN)[1], mesh.exact_search(eval_q, K_MAIN)[1])

    stop, out = threading.Event(), {"failed": 0, "served": 0}

    def reader():
        b = 0
        while not stop.is_set():
            try:
                mesh.search(cq[b:b + SERVE_MAX_BATCH], K_MAIN)
                out["served"] += 1
            except Exception:  # every loss is counted and fails the phase
                out["failed"] += 1
            b = (b + SERVE_MAX_BATCH) % (cq.shape[0] - SERVE_MAX_BATCH)

    seq0 = obs_events.last_seq()
    with obs_compile.attribution() as rec:
        pre = oracle_recall()
        th = threading.Thread(target=reader)
        th.start()
        try:
            for step in range(CTL_RAMP_STEPS):
                lo = step * CTL_RAMP_ROWS
                mesh.upsert(ramp[lo:lo + CTL_RAMP_ROWS], ids=N_MAIN + lo + torch.arange(
                    CTL_RAMP_ROWS).numpy())
                comp.run_once()       # the advisory rides every poll
                ctl.step()            # ... and the controller acts on it
        finally:
            stop.set()
            th.join(120)
        post = oracle_recall()
        torch.cuda.synchronize()
    evs = obs_events.query(since_seq=seq0)
    advised = [e for e in evs if e["kind"] == "reshard_advised" and e["name"] == "ramp"]
    dec = [e for e in evs if e["kind"] == "control/decision" and e["name"] == "ramp"]
    done = [e for e in evs if e["kind"] == "control/action_completed" and e["name"] == "ramp"]
    emit(phase="net", part="c2", path="controller reshard: IVF-Flat mesh 2 -> 4 on an upsert "
                                      "ramp (controller_ramp's protocol)",
         n=N_MAIN, d=D_MAIN, k=K_MAIN, n_lists=params.n_lists, n_probes=sp.n_probes,
         build_seconds=build_s, ramp=dict(steps=CTL_RAMP_STEPS, rows=CTL_RAMP_ROWS),
         reshard_rows_per_shard=threshold, shards=mesh.n_shards, recall_before=pre,
         recall_after=post, reader_batches=out["served"], failed=out["failed"],
         admission=dec[-1]["evidence"] if dec else None,
         reshard=done[-1]["evidence"] if done else None, builds_in_window=rec.summary(),
         card=st["card"])
    assert out["failed"] == 0, out
    assert advised and dec and done, ([e["kind"] for e in evs])
    assert mesh.n_shards == 2 * shards, mesh.n_shards
    assert dec[-1]["evidence"]["headroom"] is not None and dec[-1]["evidence"]["burn"] is not None
    assert post >= MESH_RECALL_FLOOR and post >= pre - 0.02, (pre, post)
    assert rec.cache_misses == 0 and rec.programs == 0, rec.summary()
    assert advised[-1]["seq"] < dec[-1]["seq"] < done[-1]["seq"]
    return mesh


def net_degrade(st, reg, findex, family, tuned, cx, cq):
    """Phase a (c) 3: a hot ``SLOTracker`` degrades the tuned name to the
    cheap point, cooling restores it (an injected clock); the rows served at
    each point equal a direct search at its params."""
    import torch

    from raft_tpu_torch import tune
    from raft_tpu_torch.control import ControlPolicy, Controller
    from raft_tpu_torch.neighbors import ivf_flat
    from raft_tpu_torch.obs import compile as obs_compile
    from raft_tpu_torch.obs import events as obs_events
    from raft_tpu_torch.obs.slo import SLOPolicy, SLOTracker

    clk = FakeClock()
    hot = SLOTracker(SLOPolicy(windows_s=(60.0,), slot_s=30.0, latency_bound_s=0.1), clock=clk)
    pin = tune.Decision(kind="ivf_flat", dtype="float32", family=family, params=tuned)
    cheap = {"n_probes": 1}
    ctl = Controller(publisher=reg, clock=clk, slo=hot, name="chip-burn",
                     policy=ControlPolicy(degrade_cooldown_s=5.0, restore_clear_s=120.0))
    ctl.watch("drift", findex, cq[:CTL_CANARY], dataset=cx, k=K_MAIN, ks=(K_MAIN,),
              grid=CTL_GRID, repeats=1, warm_data=cx[:1024], decision=pin,
              degrade_params=cheap)
    qb = cq[:SERVE_MAX_BATCH]

    def served_equals(params):
        with reg.lease("drift") as v:
            d, i = v.searcher(qb, K_MAIN)
        with uncounted():
            rd, ri = ivf_flat.search(ivf_flat.SearchParams(**params), findex, qb, K_MAIN)
        return int(row_equiv(torch.as_tensor(d), torch.as_tensor(i), rd, ri).sum())

    ctl.arm()
    try:
        with obs_compile.attribution() as rec:
            for _ in range(4):
                hot.record_request(1.0, 1.0)
            ctl.step()
            degraded = (reg.active("drift").version, served_equals(cheap))
            clk.advance(100.0)
            ctl.step()                  # the clear observed: the hysteresis clock starts
            clk.advance(130.0)
            ctl.step()                  # held past restore_clear_s: restore
            restored = (reg.active("drift").version, served_equals(tuned))
    finally:
        ctl.disarm()
    kinds = [e["kind"] for e in obs_events.query(component="control", name="drift")][-4:]
    emit(phase="net", part="c3", path="controller degrade / restore on the tuned IVF-Flat name",
         pinned=tuned, cheap=cheap, degraded_version=degraded[0],
         degraded_rows_equal_direct=(degraded[1], SERVE_MAX_BATCH),
         restored_version=restored[0],
         restored_rows_equal_direct=(restored[1], SERVE_MAX_BATCH), journal=kinds,
         builds_in_window=rec.summary(), card=st["card"])
    assert kinds == ["control/decision", "control/degraded", "control/decision",
                     "control/restored"], kinds
    assert degraded[1] == restored[1] == SERVE_MAX_BATCH, (degraded, restored)
    assert rec.cache_misses == 0 and rec.programs == 0, rec.summary()


def prom_samples(text):
    """The sample count of a Prometheus text exposition; raises on a line
    that is neither a ``# HELP`` / ``# TYPE`` comment nor a sample whose
    value parses as a float."""
    import re

    sample = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{.*\})?\s+(\S+)(\s+-?\d+)?$")
    n = 0
    for line in text.splitlines():
        if not line.strip():
            continue
        if line.startswith("#"):
            assert line.startswith(("# HELP ", "# TYPE ")), line
            continue
        m = sample.match(line)
        assert m is not None, line
        float(m.group(3))
        n += 1
    return n


def net_exporter(st, tracker, log, mesh, ctl):
    """Phase a (d): one ``MetricsExporter`` over (a)'s request log, an
    ``SLOTracker`` fed by (a)'s service, (b)'s mesh and (c)'s controller:
    each route's status and the keys of its body."""
    import urllib.error
    import urllib.request

    import torch

    from raft_tpu_torch.core import Resources
    from raft_tpu_torch.neighbors import brute_force
    from raft_tpu_torch.obs import MetricsExporter
    from raft_tpu_torch.stream import MutableIndex

    x, _ = st["main"]
    # a live tiered store registers /debug/mem's tiers section
    tiered = MutableIndex(brute_force.BruteForce().build(x[:4_096], res=Resources(device="cuda")),
                          retain_vectors=True, storage="tiered", name="net_tiered")

    def get(url):
        try:
            with urllib.request.urlopen(url, timeout=30) as r:
                return r.status, r.read().decode()
        except urllib.error.HTTPError as e:
            return e.code, e.read().decode()

    routes = {}
    with MetricsExporter(port=0, slo=tracker, request_log=log, replicas=mesh,
                         controller=ctl) as exp:
        base = f"http://127.0.0.1:{exp.port}"
        for path in ("/metrics", "/healthz", "/debug/mem", "/debug/events", "/debug/control",
                     "/debug/requests", "/nope"):
            routes[path] = get(base + path)
    samples = prom_samples(routes["/metrics"][1])
    bodies = {p: json.loads(b) for p, (c, b) in routes.items() if p not in ("/metrics", "/nope")}
    emit(phase="net", part="d", path="MetricsExporter over the front door, the mesh and the "
                                     "controller",
         status={p: c for p, (c, _) in routes.items()}, metrics_samples=samples,
         keys={p: sorted(b) for p, b in bodies.items()},
         healthz=dict(status=bodies["/healthz"]["status"],
                      control=bodies["/healthz"]["control"],
                      replicas_healthy=[g["healthy"] for g in
                                        bodies["/healthz"]["replicas"]["shards"]]),
         tiers=bodies["/debug/mem"].get("tiers"), card=st["card"])
    assert routes["/metrics"][0] == 200 and samples > 0
    assert "replicas" in bodies["/healthz"] and "control" in bodies["/healthz"], bodies["/healthz"]
    assert routes["/healthz"][0] == 503 and bodies["/healthz"]["status"] == "failing"
    assert "tiers" in bodies["/debug/mem"], sorted(bodies["/debug/mem"])
    for path in ("/debug/mem", "/debug/events", "/debug/control", "/debug/requests"):
        assert routes[path][0] == 200, (path, routes[path][0])
    assert routes["/nope"][0] == 404 and "/debug/control" in routes["/nope"][1]
    assert bodies["/debug/control"]["controller"]["actions"].get("reshard"), bodies[
        "/debug/control"]
    del tiered
    torch.cuda.synchronize()


def phase_net(st):
    """Phase a: the network front door, the process mesh, the controller and
    the exporter on the card (see the module docstring)."""
    import torch

    from raft_tpu_torch import tune
    from raft_tpu_torch.control import ControlPolicy, Controller
    from raft_tpu_torch.core import Resources
    from raft_tpu_torch.obs.slo import SLOTracker
    from raft_tpu_torch.serve import IndexRegistry

    t_phase = time.perf_counter()
    st["launches_net"] = {}
    reset_all_counts()
    tracker = SLOTracker()
    svc, log, srv, bf = net_front_door(st, tracker)
    mesh, mesh_srv, worker_launches = net_mesh(st, bf)
    ctl = None
    try:
        cx, cq, _, _ = cagra_data()
        centers = 10.0 * torch.rand((CAGRA_CENTERS, D_MAIN), device="cuda",
                                    generator=torch.Generator(device="cuda").manual_seed(20))
        findex, _ = st["ivf_flat"]
        family = tune.family_of(findex, cx)
        pin = tune.Decision(kind="ivf_flat", dtype="float32", family=family,
                            params={"n_probes": 1})
        reg = IndexRegistry(buckets=(SERVE_MAX_BATCH,))
        net_reset(st)
        reg.publish("drift", findex, tuned=pin, k=(K_MAIN,), warm_data=cx[:1024])
        budget = Resources(device="cuda",
                           memory_budget_bytes=torch.cuda.get_device_properties(0).total_memory)
        cool = SLOTracker()
        for _ in range(16):
            cool.record_request(0.001, 0.002)
        ctl = Controller(publisher=reg, res=budget, slo=cool, name="chip",
                         policy=ControlPolicy(retune_cooldown_s=0.0))
        ctl.watch("drift", findex, cq[:CTL_CANARY], dataset=cx, k=K_MAIN, ks=(K_MAIN,),
                  grid=CTL_GRID, repeats=1, warm_data=cx[:1024], decision=pin)
        ctl.arm()
        tuned = net_retune(st, reg, ctl, family, cx, cq)
        ramp_mesh = net_reshard(st, ctl, cx, cq, centers)
        net_degrade(st, reg, findex, family, tuned, cx, cq)
        del ramp_mesh
        net_exporter(st, tracker, log, mesh, ctl)
    finally:
        if ctl is not None:
            ctl.disarm()
        mesh_srv.stop()
        mesh.close()
        srv.stop()
        svc.shutdown()
    net_reset(st)
    total = st["launches_net"]
    add_counts(total, worker_launches)
    for name in ("fused_knn_rows", "topk", "pq_scan_topk", "cagra_hop"):
        assert total.get(name, 0) > 0, (name, total)
    emit(phase="net_launches", launches=total, worker_launches=worker_launches,
         seconds=time.perf_counter() - t_phase, card=st["card"])

# -- phase b: the communicator and the distributed drivers -------------------------

PAR_WORLDS = ((1, "nccl"), (2, "gloo"), (4, "gloo"))   # (ranks, backend), all on cuda:0
PAR_BATCHES = 3
PAR_SMALL_M = 64                 # a small parallel.knn batch: mode f32's row-split route
PAR_TF32_M = 2_048               # the 3xTF32 check's queries
PAR_BUILD_S = 2                  # the world that also builds IVF-Flat distributed
PAR_KMEANS_N, PAR_KMEANS_K, PAR_KMEANS_ITERS = 100_000, 1_024, 20
PAR_KMEANS_RTOL = 0.05           # distributed inertia against cluster.kmeans.fit's
PAR_TIMEOUT_S = 600.0            # a world's collective and task timeout


def par_world_rank(S, tmp, ref):
    """Phase b on one rank of a world of S ranks on ``cuda:0`` (a spawned
    process of ``RankPool``): the counted main path, then the checks, each
    stage's data freed before the next; returns what the parent prints."""
    import torch

    from raft_tpu_torch import parallel
    from raft_tpu_torch.cluster import kmeans
    from raft_tpu_torch.comms import bootstrap, test_utils
    from raft_tpu_torch.core import Resources
    from raft_tpu_torch.neighbors import brute_force, cagra, ivf_flat, ivf_pq
    from raft_tpu_torch.neighbors.refine import refine
    from raft_tpu_torch.ops.fused_knn import fused_knn, fused_knn_plain
    from raft_tpu_torch.parallel import cagra as pcagra
    from raft_tpu_torch.parallel import ivf as pivf
    from raft_tpu_torch.stream import ShardedMutableIndex

    c = bootstrap.local_mesh("data")
    r, dev = c.rank(), c.device
    res = Resources(device=dev)
    out = dict(rank=r, size=c.size(), backend=c.backend, device=str(dev),
               run_all=test_utils.run_all(c))
    assert all(out["run_all"].values()), out["run_all"]

    def timed(fn):
        """``fn()`` of every rank, from a barrier before to one after."""
        c.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        c.barrier()
        return got, time.perf_counter() - t0

    x = torch.rand((N_MAIN, D_MAIN), generator=torch.Generator(device=dev).manual_seed(0),
                   device=dev)
    q = torch.rand((M_MAIN, D_MAIN), generator=torch.Generator(device=dev).manual_seed(1),
                   device=dev)
    cx, cq, _, _ = cagra_data()
    centers = 2.0 * torch.randn((IVF_BLOBS, D_MAIN), device=dev,
                                generator=torch.Generator(device=dev).manual_seed(10))
    xb, _ = blobs(N_MAIN, centers, 11)
    pq_q, _ = blobs(IVF_Q, centers, 12)
    findex = ivf_flat.load(f"{tmp}/ivf_flat.bin", res=res)
    pindex = ivf_pq.load(f"{tmp}/ivf_pq.bin", res=res)
    fsp = ivf_flat.SearchParams(n_probes=IVF_FLAT_PROBES)
    psp = ivf_pq.SearchParams(n_probes=8, lut_dtype="bfloat16")
    csp = cagra.SearchParams(itopk_size=CAGRA_ITOPK)
    if S == 1:
        one = cagra.load(f"{tmp}/cagra.bin", res=res)
        sharded = pcagra.ShardedCagraIndex(dataset=one.dataset[None], graph=one.graph[None],
                                           metric=one.metric, data_kind=one.data_kind)
    torch.cuda.synchronize()

    # -- the main path, counted: every driver through the kernels --------------
    reset_all_counts()
    parallel.knn.knn(c, x, q, K_MAIN)                      # warm-up
    s0 = c.stats()
    walls = []
    for _ in range(PAR_BATCHES):
        (kd, ki), w = timed(lambda: parallel.knn.knn(c, x, q, K_MAIN))
        walls.append(w)
    s1 = c.stats()
    out["knn"] = dict(walls=walls, qps=M_MAIN / (sum(walls) / PAR_BATCHES),
                      collective_bytes_per_batch=(s1["bytes"] - s0["bytes"]) / PAR_BATCHES,
                      collectives_per_batch=(s1["calls"] - s0["calls"]) / PAR_BATCHES,
                      host_hops_per_batch=(s1["host_hops"] - s0["host_hops"]) / PAR_BATCHES)
    sd, si = parallel.knn.knn(c, x, q[:PAR_SMALL_M], K_MAIN)
    parallel.ivf.search(c, fsp, findex, cq, K_MAIN)        # warm-up (and the memo)
    (fd, fi), fw = timed(lambda: parallel.ivf.search(c, fsp, findex, cq, K_MAIN))
    parallel.ivf.search_pq(c, psp, pindex, pq_q, IVF_K0, res=res)
    (pd, pi), pw = timed(lambda: parallel.ivf.search_pq(c, psp, pindex, pq_q, IVF_K0, res=res))
    rd, ri = refine(xb, pq_q, pi, K_MAIN, res=res)
    if S > 1:
        sharded, bw = timed(lambda: parallel.cagra.build(c, cagra.IndexParams(), cx, res=res))
        out["cagra_build_s"] = bw
    parallel.cagra.search(c, csp, sharded, cq, K_MAIN)
    (cd, ci), cw = timed(lambda: parallel.cagra.search(c, csp, sharded, cq, K_MAIN))
    torch.cuda.synchronize()
    out["launches"] = all_counts()
    out["walls"] = dict(ivf_flat=fw, ivf_pq=pw, cagra=cw)
    out["stats"] = c.stats()

    # -- the checks (launches past here are not counted) -----------------------
    err = {}
    with uncounted():
        bd, bi = brute_force.knn(x, q, K_MAIN, res=res)
        sbd, sbi = brute_force.knn(x, q[:PAR_SMALL_M], K_MAIN, res=res)
        if S == 1:
            # S = 1 computes what the single-card search computes, bit for bit
            assert torch.equal(ki, bi) and torch.equal(kd, bd), "knn at S = 1 differs"
            assert torch.equal(si, sbi) and torch.equal(sd, sbd), "small knn differs"
            bws = []
            for _ in range(PAR_BATCHES):
                _, w = timed(lambda: brute_force.knn(x, q, K_MAIN, res=res))
                bws.append(w)
            out["brute_force_qps"] = M_MAIN / (sum(bws) / PAR_BATCHES)
        out["knn_ids_equal_rows"] = int((ki == bi).all(1).sum())
        assert torch.equal(ki, bi) and torch.equal(si, sbi), (
            f"parallel.knn ids differ from brute_force.knn on "
            f"{int((ki != bi).any(1).sum())} of {M_MAIN} rows")
        torch.testing.assert_close(kd, bd, rtol=1e-5, atol=0)
        torch.testing.assert_close(sd, sbd, rtol=1e-5, atol=0)
        out["knn_max_abs_err"] = float((kd - bd).abs().max())

        # fused_knn (both routes) against its plain version at this rank's shard
        rows_n = N_MAIN // S
        shard = x[r * rows_n:(r + 1) * rows_n]
        ov, oi = fused_knn(shard, q[:PAR_SMALL_M], K_MAIN)
        pv, pi2 = fused_knn_plain(shard, q[:PAR_SMALL_M], K_MAIN)
        err["fused_knn_rows"] = knn_equiv(ov, oi, pv, pi2, rtol=1e-5, atol=1e-5)
        ov, oi = fused_knn(shard, q[:PAR_TF32_M], K_MAIN)
        pv, pi2 = fused_knn_plain(shard, q[:PAR_TF32_M], K_MAIN)
        err["fused_knn_tf32x3"] = knn_equiv(ov, oi, pv, pi2, rtol=1e-5, atol=1e-5)
        if S == 1:
            # the mesh's comms=: shard s on comms.devices[s % 1]
            def bf(rows_):
                return brute_force.BruteForce().build(rows_, res=res)

            rows = x[:PAR_KMEANS_N]
            gd, gi = ShardedMutableIndex(rows, n_shards=2, build=bf, comms=c).search(
                q[:PAR_SMALL_M], K_MAIN)
            wd, wi = ShardedMutableIndex(rows, n_shards=2, build=bf, devices=[dev, dev]).search(
                q[:PAR_SMALL_M], K_MAIN)
            assert torch.equal(torch.as_tensor(gi), torch.as_tensor(wi))
            assert torch.equal(torch.as_tensor(gd), torch.as_tensor(wd))
            out["mesh_comms_equals_devices"] = True
            del rows, gd, gi, wd, wi
        del x, q, shard, bd, bi, kd, ki, ov, oi, pv, pi2

        ftruth, ptruth = ref["cagra_truth"].to(dev), ref["ivf_truth"].to(dev)
        out["ivf_flat_recall"] = recall(fi[:IVF_FLAT_CHECK], ftruth)
        out["ivf_pq_refined_recall"] = recall(ri[:IVF_CHECK], ptruth)
        out["cagra_recall"] = recall(ci[:CAGRA_CHECK], ftruth)
        if S == 1:
            _, sfi = ivf_flat.search(fsp, findex, cq, K_MAIN, res=res)
            _, spi = ivf_pq.search(psp, pindex, pq_q, IVF_K0, res=res)
            _, sci = cagra.search(csp, one, cq, K_MAIN, res=res)
            out["same_as_single_card"] = dict(
                ivf_flat=torch.equal(fi, sfi), ivf_pq=torch.equal(pi, spi),
                cagra=torch.equal(ci, sci))
            del one
        # the drivers' floors (phase 2's), and the JAX docstring's property:
        # S x n_probes lists probed can only raise recall at equal n_probes
        assert out["ivf_flat_recall"] >= IVF_FLAT_RECALL_FLOOR, out["ivf_flat_recall"]
        assert out["ivf_flat_recall"] >= ref["ivf_flat_recall"], (
            out["ivf_flat_recall"], ref["ivf_flat_recall"])
        assert out["ivf_pq_refined_recall"] >= IVF_RECALL_FLOOR, out["ivf_pq_refined_recall"]
        assert out["cagra_recall"] >= CAGRA_RECALL_FLOOR, out["cagra_recall"]

        # topk, pq_scan_topk and cagra_hop against their plain versions at
        # this rank's shard shapes (the local IVF-Flat chunk select, the local
        # IVF-PQ tile, the local CAGRA shard)
        fshard = pivf._flat_shard(c, findex)
        v = torch.randn((min(256, M_MAIN), IVF_FLAT_PROBES * fshard.capacity), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(40 + r))
        plant_topk_rows(v, torch.Generator(device=dev).manual_seed(41 + r))
        check_topk(v, K_MAIN, True)
        err["topk"] = 0.0
        _, pq_s, same = codec_tile_check(pivf._pq_shard(c, pindex), pq_q)
        assert same, "pq_scan_topk differs from its plain version on the rank's shard"
        err["pq_scan_topk"] = 0.0
        cshard = pcagra._local_shard(c, sharded)
        hd, hi = cagra.search(csp, cshard, cq[:CAGRA_CHECK], K_MAIN, res=res)
        phd, phi = plain_hop_search(csp, cshard, cq[:CAGRA_CHECK])
        assert torch.equal(hi, phi) and torch.equal(hd, phd), \
            "cagra_hop differs from its plain version on the rank's shard"
        err["cagra_hop"] = 0.0
        out["kernel_checks"] = dict(err=err, shard_rows=rows_n, topk_shape=list(v.shape),
                                    pq_tile_s=pq_s, cagra_shard_rows=cshard.size)
        del fshard, v, cshard, sharded, findex, pindex, pq_q
        parallel.release_programs(c)

        kx = xb[:PAR_KMEANS_N].contiguous()
        del xb
        km, w = timed(lambda: parallel.kmeans.fit(
            c, kmeans.KMeansParams(n_clusters=PAR_KMEANS_K, max_iter=PAR_KMEANS_ITERS, seed=0),
            kx))
        out["kmeans"] = dict(inertia=float(km.inertia), single_inertia=ref["kmeans_inertia"],
                             n_iter=km.n_iter, seconds=w)
        assert abs(float(km.inertia) - ref["kmeans_inertia"]) <= (
            PAR_KMEANS_RTOL * ref["kmeans_inertia"]), out["kmeans"]
        del kx, km
        torch.cuda.empty_cache()

        if S == PAR_BUILD_S:
            built, w = timed(lambda: parallel.ivf.build(
                c, ivf_flat.IndexParams(n_lists=IVF_FLAT_LISTS, seed=0), cx, res=res))
            assert built.size == N_MAIN and built.n_lists == IVF_FLAT_LISTS
            # the recall rows alone: its lists are not split, so its
            # capacity (and a probe's gather) runs to several times phase 2's
            _, bfi = parallel.ivf.search(c, fsp, built, cq[:IVF_FLAT_CHECK], K_MAIN)
            out["ivf_build"] = dict(seconds=w, single_card_seconds=ref["ivf_flat_build_s"],
                                    recall=recall(bfi, ftruth),
                                    capacity=built.capacity,
                                    mean_list=N_MAIN / IVF_FLAT_LISTS)
            assert out["ivf_build"]["recall"] >= IVF_FLAT_RECALL_FLOOR, out["ivf_build"]
    return out


def phase_parallel(st):
    """Phase b: the communicator and the distributed drivers (see the module
    docstring)."""
    import tempfile

    import torch

    from raft_tpu_torch.cluster import kmeans
    from raft_tpu_torch.core import Resources
    from raft_tpu_torch.core.platform import RankPool
    from raft_tpu_torch.neighbors import cagra, ivf_flat, ivf_pq

    t_phase = time.perf_counter()
    res = Resources(device="cuda")
    findex, fsp = st["ivf_flat"]
    cindex, cq = st["cagra"]
    pindex, _ = st["ivf"]
    _, fi = ivf_flat.search(fsp, findex, cq[:IVF_FLAT_CHECK], K_MAIN, res=res)
    ref = dict(cagra_truth=st["cagra_truth"].cpu(), ivf_truth=st["ivf_truth"].cpu(),
               ivf_flat_recall=recall(fi, st["cagra_truth"]),
               ivf_flat_build_s=st["ivf_flat_build_s"])
    km = kmeans.fit(kmeans.KMeansParams(n_clusters=PAR_KMEANS_K, max_iter=PAR_KMEANS_ITERS,
                                        seed=0), st["ivf_x"][:PAR_KMEANS_N], res=res)
    ref["kmeans_inertia"] = float(km.inertia)
    total = {}
    worlds = {}
    with tempfile.TemporaryDirectory() as tmp:
        ivf_flat.save(findex, f"{tmp}/ivf_flat.bin")
        ivf_pq.save(pindex, f"{tmp}/ivf_pq.bin")
        cagra.save(cindex, f"{tmp}/cagra.bin")
        torch.cuda.synchronize()
        # the ranks share the card with this process: hand back its cached,
        # unused blocks
        torch.cuda.empty_cache()
        free, total_mem = torch.cuda.mem_get_info()
        emit(phase="parallel_memory", free_bytes=free, total_bytes=total_mem,
             allocated_bytes=torch.cuda.memory_allocated(), card=st["card"])
        for S, backend in PAR_WORLDS:
            t0 = time.perf_counter()
            with RankPool(S, device="cuda:0", backend=backend, timeout_s=PAR_TIMEOUT_S,
                          threads=0) as pool:
                boot = pool.boot_s
                outs = pool.run(par_world_rank, S, tmp, ref)
            wall = time.perf_counter() - t0
            o = outs[0]
            launches = {}
            for ro in outs:
                add_counts(launches, ro["launches"])
            add_counts(total, launches)
            worlds[S] = o["knn"]["qps"]
            emit(phase="parallel", ranks=S, backend=backend, device=o["device"],
                 boot_seconds=boot, world_seconds=wall, run_all=o["run_all"],
                 knn_qps=o["knn"]["qps"], knn_walls=o["knn"]["walls"],
                 brute_force_qps=o.get("brute_force_qps"),
                 collective_bytes_per_batch=o["knn"]["collective_bytes_per_batch"],
                 collectives_per_batch=o["knn"]["collectives_per_batch"],
                 host_hops_per_batch=o["knn"]["host_hops_per_batch"],
                 knn_ids_equal_rows=o["knn_ids_equal_rows"],
                 knn_max_abs_err=o["knn_max_abs_err"],
                 ivf_flat_recall=o["ivf_flat_recall"],
                 ivf_flat_single_card_recall=ref["ivf_flat_recall"],
                 ivf_pq_refined_recall=o["ivf_pq_refined_recall"],
                 cagra_recall=o["cagra_recall"], cagra_build_seconds=o.get("cagra_build_s"),
                 single_card_cagra_build_seconds=st.get("cagra_build_s"),
                 same_as_single_card=o.get("same_as_single_card"),
                 mesh_comms_equals_devices=o.get("mesh_comms_equals_devices"),
                 ivf_build=o.get("ivf_build"), kmeans=o["kmeans"],
                 walls=o["walls"], stats=o["stats"], kernel_checks=o["kernel_checks"],
                 launches=launches, card=st["card"])
    for name in ("fused_knn_rows", "fused_knn_tf32x3", "topk", "pq_scan_topk", "cagra_hop"):
        assert total.get(name, 0) > 0, (name, total)
    st["launches_parallel"] = total
    emit(phase="parallel_launches", launches=total, knn_qps_by_ranks=worlds,
         seconds=time.perf_counter() - t_phase, card=st["card"])


GRAPH_N, GRAPH_CENTERS = 100_000, 1_000      # single linkage, knn route: 100k x 128 blobs
GRAPH_NEIGHBORS, GRAPH_CLUSTERS = 15, 1_000
SL_PAIR_N, SL_PAIR_D, SL_PAIR_CENTERS = 10_000, 32, 10   # the pairwise route
SPARSE_N, SPARSE_Q, SPARSE_COLS = 100_000, 10_000, 8_192  # the TF-IDF-shaped CSR
SPARSE_ROW_NNZ, SPARSE_ZIPF_S = 64, 1.1
SPARSE_CHECK = 500                   # queries held against float64
SPARSE_PAIR = (1_000, 2_000)         # sparse pairwise rows
SPEC_N, SPEC_D, SPEC_CENTERS = 100_000, 32, 16
SPEC_NEIGHBORS = 15
SPEC_ARI_FLOOR = 0.95
LAP_B, LAP_N, LAP_COST = 8, 1_024, 1_000
GRAM_ROWS = 2_000


def graph_emit(part, wall, st, **kw):
    emit(phase="graph", part=part, wall_s=wall, card=st["card"], **kw)


def counted(total, fn):
    """``fn()`` with every launch count set to 0 just before and read just
    after; the counts are added to ``total``. Returns (result, counts, wall)."""
    import torch

    reset_all_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {kk: v for kk, v in all_counts().items() if v}
    add_counts(total, counts)
    return out, counts, wall


def ari(a, b):
    """Adjusted Rand index of two labelings (numpy), from their contingency
    table (the card's machine has no scikit-learn)."""
    import numpy as np

    _, ai = np.unique(np.asarray(a), return_inverse=True)
    _, bi = np.unique(np.asarray(b), return_inverse=True)
    table = np.zeros((ai.max() + 1, bi.max() + 1))
    np.add.at(table, (ai, bi), 1)

    def pairs(v):
        return float((v * (v - 1) / 2).sum())

    s, sa, sb = pairs(table), pairs(table.sum(1)), pairs(table.sum(0))
    expected = sa * sb / pairs(np.array([len(ai)]))
    return (s - expected) / (0.5 * (sa + sb) - expected)


def same_mst(a, b, what):
    """Two MstOutputs equal field for field, weights bit for bit."""
    import torch

    for f in a._fields:
        x, y = getattr(a, f).cpu(), getattr(b, f).cpu()
        assert x.dtype == y.dtype and torch.equal(x, y), f"{what}: MST field {f} differs"


def graph_single_linkage_knn(st, total, res):
    """(1) single linkage, knn route, at 100,000 x 128 float32 blobs."""
    import torch

    from raft_tpu_torch.cluster.single_linkage import (_connectivities, _repair,
                                                       build_dendrogram_host, cut_tree_host,
                                                       single_linkage)
    from raft_tpu_torch.distance.types import resolve_metric
    from raft_tpu_torch.solver.mst import _mst

    dev = torch.device("cuda")
    centers = 10.0 * torch.rand((GRAPH_CENTERS, D_MAIN), device=dev,
                                generator=torch.Generator(device=dev).manual_seed(50))
    x, _ = blobs(GRAPH_N, centers, 51, 1.0)
    mt = resolve_metric("sqeuclidean")
    n = GRAPH_N
    graph, c_knn, t_knn = counted(total, lambda: _connectivities(x, mt, "knn", GRAPH_NEIGHBORS,
                                                                  res))
    assert c_knn.get("fused_knn_tf32x3", 0) >= 1, c_knn
    (out, mst_rounds), c_mst, t_mst = counted(total, lambda: _mst(graph))
    (fixed, rgraph, repairs), c_rep, t_rep = counted(total, lambda: _repair(x, out, mt, res))
    ne = int(fixed.n_edges)
    assert ne == n - 1, f"single linkage left {n - 1 - ne} edges out after {repairs} repairs"
    # the card's MSTs equal mst() of the same graphs on the CPU
    same_mst(out, _mst(graph.to("cpu"))[0], "kNN graph")
    if rgraph is not None:
        same_mst(fixed, _mst(rgraph.to("cpu"))[0], "repaired graph")
    s, d = fixed.src[:ne].long(), fixed.dst[:ne].long()
    ref = (x[s].double() - x[d].double()).square().sum(1)
    rel = float(((fixed.weights[:ne].double() - ref).abs() / ref.clamp_min(1e-30)).max())
    assert rel <= 1e-4, f"an MST weight is {rel} from its float64 distance"
    t0 = time.perf_counter()
    children, deltas, sizes = build_dendrogram_host(
        fixed.src[:ne].cpu().numpy(), fixed.dst[:ne].cpu().numpy(),
        fixed.weights[:ne].cpu().numpy(), n)
    labels = cut_tree_host(children, n, GRAPH_CLUSTERS)
    t_host = time.perf_counter() - t0
    assert int(sizes[-1]) == n
    # the entry point, end to end
    so, c_e2e, t_e2e = counted(total, lambda: single_linkage(
        x, GRAPH_CLUSTERS, connectivity="knn", n_neighbors=GRAPH_NEIGHBORS,
        metric="sqeuclidean", res=res))
    assert c_e2e.get("fused_knn_tf32x3", 0) >= 1, c_e2e
    assert int(so.sizes[-1]) == n and (so.deltas == deltas).all()
    assert (so.labels.cpu().numpy() == labels).all()
    graph_emit("single_linkage_knn", t_e2e, st, n=n, d=D_MAIN, centers=GRAPH_CENTERS,
               n_neighbors=GRAPH_NEIGHBORS, n_clusters=GRAPH_CLUSTERS,
               knn_graph_s=t_knn, mst_s=t_mst, repair_s=t_rep, host_dendrogram_cut_s=t_host,
               graph_edges=int(graph.nnz), mst_rounds=mst_rounds, repair_rounds=repairs,
               forest_edges=int(out.n_edges), n_edges=ne, mst_equals_cpu=True,
               max_weight_rel_err_vs_f64=rel, clusters_found=int(labels.max()) + 1,
               launches=c_e2e, launches_steps={"knn": c_knn, "mst": c_mst, "repair": c_rep})


def graph_single_linkage_pairwise(st, total, res):
    """(2) single linkage, pairwise route, at 10,000 x 32 against scipy."""
    import numpy as np
    import torch
    from scipy.cluster.hierarchy import fcluster, linkage

    from raft_tpu_torch.cluster.single_linkage import single_linkage

    dev = torch.device("cuda")
    centers = 10.0 * torch.rand((SL_PAIR_CENTERS, SL_PAIR_D), device=dev,
                                generator=torch.Generator(device=dev).manual_seed(52))
    x, _ = blobs(SL_PAIR_N, centers, 53, 1.0)
    out, counts, wall = counted(total, lambda: single_linkage(
        x, SL_PAIR_CENTERS, connectivity="pairwise", metric="euclidean", res=res))
    x64 = x.double().cpu().numpy()
    t0 = time.perf_counter()
    z = linkage(x64, method="single", metric="euclidean")
    t_scipy = time.perf_counter() - t0
    ref = np.sort(z[:, 2])
    got = np.sort(out.deltas)
    rel = float((np.abs(got - ref) / np.maximum(ref, 1e-30)).max())
    assert rel <= 1e-4, f"single-linkage deltas differ from scipy's by {rel}"
    expect = fcluster(z, SL_PAIR_CENTERS, criterion="maxclust")
    lab = out.labels.cpu().numpy()
    pairs = set(zip(lab.tolist(), expect.tolist()))
    assert len(pairs) == len(set(lab.tolist())) == len(set(expect.tolist())), \
        "the 10-cluster partition differs from fcluster's"
    graph_emit("single_linkage_pairwise", wall, st, n=SL_PAIR_N, d=SL_PAIR_D,
               edges=SL_PAIR_N * (SL_PAIR_N - 1) // 2, max_delta_rel_err_vs_scipy=rel,
               partition_equals_fcluster=True, scipy_s=t_scipy, launches=counts)


def tfidf_csr(res):
    """A TF-IDF-shaped CSR from a seed: SPARSE_N + SPARSE_Q rows of 8,192
    columns, 64 draws a row of Zipf(1.1)-ranked column ids (repeats summed),
    each entry's count weight times its column's idf, rows l2-normalised."""
    import torch

    from raft_tpu_torch import sparse

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(54)
    n = SPARSE_N + SPARSE_Q
    p = 1.0 / torch.arange(1, SPARSE_COLS + 1, device=dev, dtype=torch.float64) ** SPARSE_ZIPF_S
    cols = torch.multinomial(p.float(), n * SPARSE_ROW_NNZ, replacement=True, generator=g)
    # ranks to column ids by a fixed permutation, so frequent terms spread
    perm = torch.randperm(SPARSE_COLS, generator=g, device=dev)
    cols = perm[cols].to(torch.int32)
    rows = torch.arange(n, device=dev, dtype=torch.int32).repeat_interleave(SPARSE_ROW_NNZ)
    vals = torch.rand((n * SPARSE_ROW_NNZ,), generator=g, device=dev) + 0.5
    coo = sparse.CooMatrix(rows, cols, vals, torch.tensor(rows.numel(), dtype=torch.int32,
                                                          device=dev), (n, SPARSE_COLS))
    tf = sparse.coo_to_csr(sparse.sum_duplicates(sparse.sort_coo(coo)), assume_sorted=True)
    df = sparse.degree(sparse.transpose(tf)).double()
    idf = (torch.log(n / (1.0 + df)) + 1.0).float()
    cols_of = torch.clamp_max(tf.indices, SPARSE_COLS - 1).long()
    weighted = sparse.CsrMatrix(tf.indptr, tf.indices, tf.data * idf[cols_of], tf.shape)
    return sparse.normalize_rows(weighted, "l2")


def csr_rows(a, start, stop):
    """Rows [start, stop) of a CSR matrix, as a CSR matrix of their entries."""
    from raft_tpu_torch import sparse

    lo, hi = int(a.indptr[start]), int(a.indptr[stop])
    return sparse.CsrMatrix((a.indptr[start:stop + 1] - lo).contiguous(),
                            a.indices[lo:hi].contiguous(), a.data[lo:hi].contiguous(),
                            (stop - start, a.shape[1]))


def graph_sparse_knn(st, total, res, data):
    """(3) sparse kNN: 10,000 queries in 100,000 TF-IDF rows, k=10."""
    import torch

    from raft_tpu_torch import sparse
    from raft_tpu_torch.distance.types import resolve_metric
    from raft_tpu_torch.sparse.distance import _tile_for
    from raft_tpu_torch.sparse.neighbors import _EXPANDED_L2

    ds, qs = csr_rows(data, 0, SPARSE_N), csr_rows(data, SPARSE_N, SPARSE_N + SPARSE_Q)
    yd = ds.todense()
    for metric in ("inner_product", "sqeuclidean"):
        mt = resolve_metric(metric)
        tile = _tile_for(_EXPANDED_L2.get(mt, mt), SPARSE_Q, SPARSE_N, SPARSE_COLS, res)
        tiles = -(-SPARSE_Q // tile)
        (dv, di), counts, wall = counted(total, lambda: sparse.knn(ds, qs, K_MAIN, metric=metric,
                                                                   res=res))
        assert counts.get("topk", 0) == tiles, (counts, tiles)
        with uncounted():
            pv, pi = sparse.knn(ds, qs, K_MAIN, metric=metric, select_impl="torch", res=res)
        assert torch.equal(pi, di) and torch.equal(pv, dv), f"{metric}: the select routes differ"
        # float64 on SPARSE_CHECK queries
        q64 = csr_rows(qs, 0, SPARSE_CHECK).todense().double()
        ip = torch.cat([q64 @ yd[i:i + 20_000].double().T for i in range(0, SPARSE_N, 20_000)],
                       dim=1)
        if metric == "inner_product":
            ref, best_first = ip, True
        else:
            yn = torch.cat([yd[i:i + 20_000].double().square().sum(1)
                            for i in range(0, SPARSE_N, 20_000)])
            ref, best_first = q64.square().sum(1)[:, None] + yn[None, :] - 2.0 * ip, False
        kth = torch.topk(ref, K_MAIN, dim=1, largest=best_first).values[:, -1]
        got = torch.gather(ref, 1, di[:SPARSE_CHECK].long())
        assert bool(torch.allclose(dv[:SPARSE_CHECK].double(), got, rtol=1e-5, atol=1e-6)), \
            f"{metric}: distances differ from float64"
        # an id the float64 order leaves out must tie the k-th within 1e-6
        slack = (kth[:, None] - got) if best_first else (got - kth[:, None])
        worst = float(slack.max())
        assert worst <= 1e-6, f"{metric}: an id is {worst} beyond the float64 k-th"
        exact_rows = int(sum(
            set(di[r].tolist()) == set(torch.topk(ref[r], K_MAIN, largest=best_first)
                                       .indices.tolist()) for r in range(SPARSE_CHECK)))
        graph_emit("sparse_knn", wall, st, metric=metric, n=SPARSE_N, m=SPARSE_Q,
                   d=SPARSE_COLS, nnz=int(ds.nnz), k=K_MAIN, tile=tile, tiles=tiles,
                   qps=SPARSE_Q / wall, routes_equal=True, f64_rows=SPARSE_CHECK,
                   f64_rows_same_set=exact_rows, worst_tie_slack=worst, launches=counts)


def graph_sparse_pairwise(st, total, res, data):
    """(4) the 18 sparse metrics at 1,000 x 2,000 rows against float64."""
    import torch

    from raft_tpu_torch import sparse

    m, n = SPARSE_PAIR
    x, y = csr_rows(data, 0, m), csr_rows(data, m, m + n)

    def variant(a, kind):
        # the set metrics on 0/1 rows, the distribution metrics on l1 rows
        if kind == "binary":
            return sparse.CsrMatrix(a.indptr, a.indices, (a.data != 0).float(), a.shape)
        if kind == "simplex":
            return sparse.normalize_rows(a, "l1")
        return a

    # each sparse metric by its PAIRWISE_METRICS / _ref64 name
    names = {"L2Expanded": "l2_expanded", "L2SqrtExpanded": "l2_sqrt_expanded",
             "L2Unexpanded": "sqeuclidean", "L2SqrtUnexpanded": "euclidean",
             "LpUnexpanded": "minkowski", "CosineExpanded": "cosine",
             "InnerProduct": "inner_product", "L1": "l1", "Canberra": "canberra",
             "Linf": "chebyshev", "JaccardExpanded": "jaccard",
             "HellingerExpanded": "hellinger", "DiceExpanded": "dice",
             "CorrelationExpanded": "correlation", "RusselRaoExpanded": "russellrao",
             "HammingUnexpanded": "hamming", "JensenShannon": "jensenshannon",
             "KLDivergence": "kl_divergence"}
    worst = {}
    t_all = time.perf_counter()
    for mt in sorted(sparse.SPARSE_SUPPORTED):
        name = names[mt.name]
        kind, arg, rtol = PAIRWISE_METRICS[name]
        xm, ym = variant(x, kind), variant(y, kind)
        got = sparse.pairwise_distance(xm, ym, metric=mt, metric_arg=arg, res=res)
        assert got.shape == (m, n) and got.dtype == torch.float32
        xd, y64 = xm.todense().double(), ym.todense().double()
        # _ref64 broadcasts (step, n, d) for these: 1 GB of float64 at 8 rows
        step = 8 if name in ("l2_expanded", "l2_sqrt_expanded", "sqeuclidean", "euclidean",
                             "l1", "chebyshev", "canberra", "minkowski", "hamming",
                             "jensenshannon") else 250
        err = 0.0
        for i in range(0, m, step):
            ref = _ref64(name, xd[i:i + step], y64, arg)
            extra = 0.0
            if name in ("l2_expanded", "l2_sqrt_expanded"):
                # the expanded form's float32 bound over the rows' nonzeros
                b = expanded_bound(xd[i:i + step].square().sum(1)[:, None],
                                   y64.square().sum(1)[None, :], d=2 * SPARSE_ROW_NNZ)
                extra = b if name == "l2_expanded" else torch.minimum(
                    b.sqrt(), b / ref.clamp_min(1e-30))
            if name == "correlation":
                # centring makes the rows dense: a float32 product over all
                # 8,192 terms of unit vectors, whose bound is d·2⁻²⁴
                extra = SPARSE_COLS * 2.0 ** -24
            diff = (got[i:i + step].double() - ref).abs()
            ok = diff <= rtol * ref.abs() + 1e-5 + extra
            assert bool(ok.all()), (f"sparse {name} differs from float64: "
                                    f"{int((~ok).sum())} entries, max abs err {float(diff.max())}")
            err = max(err, float(diff.max()))
        worst[name] = err
    graph_emit("sparse_pairwise", time.perf_counter() - t_all, st, m=m, n=n, d=SPARSE_COLS,
               metrics=len(worst), max_abs_err=worst)


def graph_spectral(st, total, res):
    """(5) knn_graph -> symmetrize -> partition and modularity_maximization
    over 100,000 x 32 blobs around 16 centers."""
    import torch

    from raft_tpu_torch import sparse, spectral
    from raft_tpu_torch.solver import eigsh
    from raft_tpu_torch.sparse.linalg import _row_runs, row_reduce

    dev = torch.device("cuda")
    # centers N(0, 1) a coordinate, unit noise: a few per cent of kNN edges
    # cross blobs (the line prints the share), so the graph is connected
    # and its 16 smallest eigenvalues are distinct: a single-vector Lanczos
    # cannot resolve the 16-fold zero eigenvalue of 16 disconnected blobs
    centers = torch.randn((SPEC_CENTERS, SPEC_D), device=dev,
                          generator=torch.Generator(device=dev).manual_seed(55))
    x, lab = blobs(SPEC_N, centers, 56, 1.0)
    t0 = time.perf_counter()
    a, c_graph, t_graph = counted(total, lambda: sparse.symmetrize(sparse.coo_to_csr(
        sparse.knn_graph(sparse.dense_to_csr(x), SPEC_NEIGHBORS, res=res))))
    assert c_graph.get("topk", 0) > 0, c_graph
    v0 = torch.randn((SPEC_N,), device=dev, generator=torch.Generator(device=dev).manual_seed(57))
    cfg = spectral.EigenSolverConfig(n_eig_vecs=SPEC_CENTERS)
    out, c_part, t_part = counted(total, lambda: spectral.partition(a, SPEC_CENTERS, eigen_cfg=cfg,
                                                                    v0=v0, res=res))
    lap = sparse.laplacian(a)
    lap64 = sparse.CsrMatrix(lap.indptr, lap.indices, lap.data.double(), lap.shape)
    # a Lanczos step's matvec and the segment sum inside it (1-D), against
    # the bytes the spmv must move (entries and indices read, x and y once),
    # and the same sum over a (cap, 1) block, the 2-D path spmv leaves
    contrib = lap.data * v0[torch.clamp_max(lap.indices, SPEC_N - 1).long()]
    spmv_ms = cuda_ms(lambda: sparse.spmv(lap, v0), reps=20)
    segsum_ms = cuda_ms(lambda: row_reduce(lap, contrib), reps=20)
    runs = _row_runs(lap)
    segsum_2d_ms = cuda_ms(lambda: torch.segment_reduce(contrib[:, None], "sum", lengths=runs,
                                                        axis=0, unsafe=True), reps=10)
    spmv_bound_ms = (int(lap.cap) * 8 + 2 * SPEC_N * 4) / H100_BYTES_S * 1e3

    def residuals(w, v):
        # ‖Lv - λv‖ of each Ritz pair, in float64
        v = v.to(dev).double()
        return torch.linalg.vector_norm(sparse.spmm(lap64, v) - v * w.to(dev).double()[None, :],
                                        dim=0)

    w, v = out.eigenvalues, out.eigenvectors
    resid = residuals(w, v)
    l1 = float(sparse.row_norm(lap, "l1").max())        # ‖L‖₁ of a symmetric L
    assert float(resid.max()) <= 1e-3 * l1, (float(resid.max()), l1)
    # the eigensolver alone on the card (the partition's share of it), then
    # on the CPU from the same v0
    (gw, _, _), _, t_eig = counted(total, lambda: eigsh(
        lap, k=SPEC_CENTERS, which="SA", max_iter=cfg.max_iter, tol=cfg.tol, seed=cfg.seed,
        v0=v0))
    t0c = time.perf_counter()
    cw, cv, c_restarts = eigsh(lap.to("cpu"), k=SPEC_CENTERS, which="SA", max_iter=cfg.max_iter,
                               tol=cfg.tol, seed=cfg.seed, v0=v0.cpu())
    t_cpu = time.perf_counter() - t0c
    # each Ritz value lies within its residual of an eigenvalue of L, so two
    # runs that reach the same eigenvalues differ by at most the sum of their
    # residuals; 1e-4 where that is smaller (float32 Lanczos on an L this
    # large leaves residuals near 1e-3, printed as max_residual)
    ediff = (w.cpu() - cw).abs().double()
    bound = torch.clamp_min(resid.cpu() + residuals(cw, cv).cpu(), 1e-4)
    assert bool((ediff <= bound).all()), (
        f"eigenvalues differ from the CPU's by {ediff.tolist()} against {bound.tolist()}")
    ediff = float(ediff.max())
    score = ari(out.labels.cpu().numpy(), lab.cpu().numpy())
    assert score >= SPEC_ARI_FLOOR, f"partition ARI {score}"
    mod, c_mod, t_mod = counted(total, lambda: spectral.modularity_maximization(
        a, SPEC_CENTERS, eigen_cfg=cfg, v0=v0, res=res))
    mscore = ari(mod.labels.cpu().numpy(), lab.cpu().numpy())
    assert mscore >= SPEC_ARI_FLOOR, f"modularity ARI {mscore}"
    q = float(spectral.analyze_modularity(a, SPEC_CENTERS, mod.labels))
    cut, cost = spectral.analyze_partition(a, SPEC_CENTERS, out.labels)
    rows, cols = a.row_ids()[:int(a.nnz)].long(), a.indices[:int(a.nnz)].long()
    cross = float((lab[rows] != lab[cols]).float().mean())
    graph_emit("spectral", time.perf_counter() - t0, st, n=SPEC_N, d=SPEC_D,
               centers=SPEC_CENTERS, n_neighbors=SPEC_NEIGHBORS, graph_nnz=int(a.nnz),
               cross_blob_edge_share=cross, graph_s=t_graph, partition_s=t_part,
               restarts=out.n_eigen_restarts, eigsh_s=t_eig, spmv_ms=spmv_ms,
               spmv_segment_sum_ms=segsum_ms, segment_reduce_2d_ms=segsum_2d_ms,
               spmv_bound_ms=spmv_bound_ms,
               eigsh_repeat_bit_equal=bool(torch.equal(gw, w)), cpu_eigsh_s=t_cpu,
               cpu_restarts=c_restarts,
               eigenvalues=w.tolist(), max_eig_diff_vs_cpu=ediff,
               max_eig_diff_bound=float(bound.max()), max_residual=float(resid.max()),
               l1_norm=l1, ari=score,
               modularity_s=t_mod, modularity_restarts=mod.n_eigen_restarts,
               modularity_ari=mscore, modularity=q, edge_cut=float(cut), cost=float(cost),
               launches={"graph": c_graph, "partition": c_part, "modularity": c_mod})


def graph_lap(st, total, res):
    """(6) lap_solve of 8 x 1,024 x 1,024 integer costs against scipy."""
    import numpy as np
    import torch
    from scipy.optimize import linear_sum_assignment

    from raft_tpu_torch.solver import lap as lap_mod

    dev = torch.device("cuda")
    cost = torch.randint(0, LAP_COST, (LAP_B, LAP_N, LAP_N), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(58)).float()
    (out, stats), counts, wall = counted(total, lambda: lap_mod._lap(cost, None, False, None, res))
    assert bool(out.converged.all()), "a LAP problem did not converge"
    ch = cost.cpu().numpy()
    objs = []
    for i in range(LAP_B):
        ri, ci = linear_sum_assignment(ch[i])
        ref = float(ch[i][ri, ci].sum())
        assert float(out.objective[i]) == ref, (i, float(out.objective[i]), ref)
        ra = out.row_assignment[i].cpu().numpy()
        assert (np.sort(ra) == np.arange(LAP_N)).all()
        objs.append(ref)
    graph_emit("lap", wall, st, batch=LAP_B, n=LAP_N, rounds=stats["rounds"],
               reads=stats["reads"], rounds_per_read=lap_mod.ROUNDS_PER_READ,
               objectives=objs, equal_to_scipy=True, launches=counts)


def graph_gram(st, total, res, data):
    """(7) gram_matrix of CSR inputs against the dense call."""
    import torch

    from raft_tpu_torch.distance import KernelParams, KernelType, gram_matrix

    x, y = csr_rows(data, 0, GRAM_ROWS), csr_rows(data, GRAM_ROWS, 2 * GRAM_ROWS)
    xd, yd = x.todense(), y.todense()
    t0 = time.perf_counter()
    err = {}
    for kind in KernelType:
        p = KernelParams(kernel=kind, degree=3, gamma=0.5, coef0=1.0)
        got = gram_matrix(p, x, y, res=res)
        ref = gram_matrix(p, xd, yd, res=res)
        assert bool(torch.allclose(got, ref, rtol=1e-5, atol=1e-7)), kind
        err[kind.value] = float((got - ref).abs().max())
    torch.cuda.synchronize()
    graph_emit("gram_matrix_csr", time.perf_counter() - t0, st, m=GRAM_ROWS, n=GRAM_ROWS,
               d=SPARSE_COLS, max_abs_err_vs_dense=err)


def phase_graph(st):
    """Phase c: the sparse and graph stack (see the module docstring)."""
    from raft_tpu_torch.core import Resources

    t_phase = time.perf_counter()
    res = Resources(device="cuda")
    total = {}
    graph_single_linkage_knn(st, total, res)
    graph_single_linkage_pairwise(st, total, res)
    t0 = time.perf_counter()
    data = tfidf_csr(res)
    emit(phase="graph", part="tfidf_data", wall_s=time.perf_counter() - t0,
         rows=data.shape[0], cols=data.shape[1], nnz=int(data.nnz), card=st["card"])
    graph_sparse_knn(st, total, res, data)
    graph_sparse_pairwise(st, total, res, data)
    graph_gram(st, total, res, data)
    del data
    graph_spectral(st, total, res)
    graph_lap(st, total, res)
    for name in ("fused_knn_tf32x3", "topk"):
        assert total.get(name, 0) > 0, (name, total)
    st["launches_graph"] = total
    emit(phase="graph_launches", launches=total, seconds=time.perf_counter() - t_phase,
         card=st["card"])


PRIM_DEV = "cuda"                    # phase d's device (a CPU rehearsal sets "cpu")
PRIM_GEMM = 8_192                    # gemm's m = n = k
PRIM_RSVD = (100_000, 1_024, 64)     # rows, cols, rank (and rsvd's k)
PRIM_DECOMP = (4_096, 1_024)         # eigh / qr / svd / lstsq
PRIM_RANK = 64                       # lstsq's rank-deficient case
PRIM_CHOL = 1_024
PRIM_KEYS = (1_000_000, 128, 1_024)  # reduce_rows_by_key: rows, cols, keys
PRIM_DRAWS = 10_000_000
PRIM_BLOBS = (1_000_000, 128, 1_000)
PRIM_RMAT = (20, 16 * 1024 * 1024)   # r_scale = c_scale, edges
PRIM_SAMPLE = (1_000_000, 256)       # population, samples
PRIM_LABELS = 10_000_000             # make_monotonic
PRIM_MERGE = (1_000_000, 100_000)    # merge_labels: points, equivalences
PRIM_STATS = (1_000_000, 128)
PRIM_METRIC = (1_000_000, 1_000)     # label metrics: labels, classes
PRIM_SIL = (20_000, 128, 20)         # silhouette: rows, dims, blobs
PRIM_TRUST = (10_000, 128, 32, 10)   # trustworthiness: rows, dims, embedding dims, k
PRIM_BIN = (1_000_000, 128, 100_000)  # write_bin rows, dims; BinDataset chunk rows
PRIM_REFINE = (10_000, 40, 10)       # refine_host: queries, candidates, k
PRIM_SHARDS = 4
PRIM_METRIC_RTOL = 1e-4              # label metrics against float64 numpy


def prims_emit(part, wall, st, **kw):
    emit(phase="prims", part=part, wall_s=wall, card=st["card"], **kw)


def _gen(seed):
    import torch

    return torch.Generator(device=PRIM_DEV).manual_seed(seed)


def prims_linalg(st, total, res):
    """(1) linalg: gemm at 8,192^3, rsvd, the decompositions, the rank-1
    Cholesky update and the sums by key."""
    import torch

    from raft_tpu_torch import linalg

    dev = torch.device(PRIM_DEV)
    n = PRIM_GEMM
    a = torch.randn((n, n), generator=_gen(70), device=dev)
    b = torch.randn((n, n), generator=_gen(71), device=dev)
    c, counts, wall = counted(total, lambda: linalg.gemm(a, b, res=res))
    ref = a.double() @ b.double()
    mag = a.abs().double() @ b.abs().double()
    excess = float(((c.double() - ref).abs() - n * 2.0 ** -24 * mag).max())
    assert excess <= 0.0, f"gemm beyond d*2^-24 of the magnitudes by {excess}"
    del ref, mag
    ms = cuda_ms(lambda: linalg.gemm(a, b, res=res), reps=3)
    tflops = 2.0 * n ** 3 / (ms * 1e-3) / 1e12
    prims_emit("gemm", wall, st, n=n, ms=ms, tflops=tflops, peak_fp32_tflops=H100_F32_FLOPS / 1e12,
               within_d_eps_of_magnitudes=True, launches=counts)
    del a, b, c

    m, nc, r = PRIM_RSVD
    u0 = torch.randn((m, r), generator=_gen(72), device=dev) / m ** 0.5
    v0 = torch.randn((nc, r), generator=_gen(73), device=dev) / nc ** 0.5
    s0 = 10.0 * 0.95 ** torch.arange(r, device=dev, dtype=torch.float32)
    x = (u0 * s0) @ v0.T + 1e-5 * torch.randn((m, nc), generator=_gen(74), device=dev)
    (u, s, vt), counts, wall = counted(total, lambda: linalg.rsvd(x, r, seed=5, res=res))
    s64 = torch.linalg.svdvals(torch.linalg.qr(x.double(), mode="r")[1])[:r]
    rsvd_err = float(((s.double() - s64).abs() / s64).max())
    assert rsvd_err <= 1e-3, f"rsvd singular values off by {rsvd_err} (relative)"
    assert tuple(u.shape) == (m, r) and tuple(vt.shape) == (r, nc)
    prims_emit("rsvd", wall, st, rows=m, cols=nc, k=r, max_rel_err=rsvd_err, launches=counts)
    del x, u0, v0, u, vt

    m, nc = PRIM_DECOMP
    x = torch.randn((m, nc), generator=_gen(75), device=dev)
    x64 = x.double()
    eye = torch.eye(nc, device=dev)
    t0 = time.perf_counter()
    sym = linalg.gemm(x, x, trans_a=True, res=res) / m
    w, v = linalg.eigh(sym, res=res)
    w64 = torch.linalg.eigvalsh(sym.double())
    eig_err = float((w.double() - w64).abs().max() / w64.abs().max())
    eig_rec = float(((v * w) @ v.T - sym).abs().max() / sym.abs().max())
    eig_orth = float((v.T @ v - eye).abs().max())
    assert max(eig_err, eig_rec, eig_orth) <= 1e-4, (eig_err, eig_rec, eig_orth)
    q, rr = linalg.qr(x, res=res)
    r64 = torch.linalg.qr(x64, mode="r")[1]
    qr_err = float((rr.diagonal().abs().double() - r64.diagonal().abs()).abs().max()
                   / r64.diagonal().abs().max())
    qr_rec = float((q @ rr - x).abs().max() / x.abs().max())
    qr_orth = float((q.T @ q - eye).abs().max())
    assert max(qr_err, qr_rec, qr_orth) <= 1e-4, (qr_err, qr_rec, qr_orth)
    su, ss, svt = linalg.svd(x, res=res)
    svd_err = float((ss.double() - torch.linalg.svdvals(r64)).abs().max() / ss.max())
    svd_rec = float(((su * ss) @ svt - x).abs().max() / x.abs().max())
    assert max(svd_err, svd_rec) <= 1e-4, (svd_err, svd_rec)
    rhs = torch.randn((m, 2), generator=_gen(76), device=dev)
    sol = linalg.lstsq(x, rhs, res=res)
    sol64 = torch.linalg.lstsq(x64, rhs.double()).solution
    ls_full = float((sol.double() - sol64).norm() / sol64.norm())
    fa = torch.randn((m, PRIM_RANK), generator=_gen(77), device=dev)
    fb = torch.randn((PRIM_RANK, nc), generator=_gen(78), device=dev)
    low = fa @ fb
    sol_low = linalg.lstsq(low, rhs, res=res)
    # the float64 minimum-norm solution of fa @ fb, pinv(fb) @ pinv(fa)
    # (JAX's cutoff, eps_f32 * max(m, n) * s_max, drops the spectrum that
    # the float32 product's rounding adds past rank 64)
    fa64, fb64 = fa.double(), fb.double()
    inner = torch.linalg.solve(fa64.T @ fa64, fa64.T @ rhs.double())
    sol_low64 = fb64.T @ torch.linalg.solve(fb64 @ fb64.T, inner)
    ls_low = float((sol_low.double() - sol_low64).norm() / sol_low64.norm())
    assert ls_full <= 1e-4 and ls_low <= 1e-3, (ls_full, ls_low)
    torch.cuda.synchronize()
    prims_emit("decompositions", time.perf_counter() - t0, st, rows=m, cols=nc,
               eigh_value_err=eig_err, eigh_reconstruction=eig_rec, eigh_orthogonality=eig_orth,
               qr_diag_err=qr_err, qr_reconstruction=qr_rec, qr_orthogonality=qr_orth,
               svd_value_err=svd_err, svd_reconstruction=svd_rec, lstsq_full_rank_rel=ls_full,
               lstsq_rank_deficient_rel=ls_low, rank=PRIM_RANK)
    del x, x64, low, fa, fb, q, rr, su, svt, v

    n = PRIM_CHOL
    g = torch.randn((n, n), generator=_gen(79), device=dev)
    amat = g @ g.T / n + torch.eye(n, device=dev)
    lmat = torch.linalg.cholesky(amat)
    xv = torch.randn(n, generator=_gen(80), device=dev)
    l2, counts, wall = counted(total, lambda: linalg.cholesky_r1_update(lmat, xv, res=res))
    target = amat + torch.outer(xv, xv)
    chol_err = float((l2.double() @ l2.double().T - target.double()).abs().max()
                     / target.abs().max())
    assert chol_err <= 1e-4, f"cholesky_r1_update: L'L'^T off by {chol_err} (relative)"
    prims_emit("cholesky_r1_update", wall, st, n=n, rel_err=chol_err, launches=counts)

    rows, cols, nk = PRIM_KEYS
    mat = torch.randn((rows, cols), generator=_gen(81), device=dev)
    keys = torch.randint(0, nk, (rows,), generator=_gen(82), device=dev, dtype=torch.int32)
    sums, counts, wall = counted(total, lambda: linalg.reduce_rows_by_key(mat, keys, nk, res=res))
    ref = torch.zeros((nk, cols), dtype=torch.float64, device=dev).index_add_(
        0, keys.long(), mat.double())
    mass = torch.zeros((nk, cols), dtype=torch.float64, device=dev).index_add_(
        0, keys.long(), mat.abs().double())
    key_err = float(((sums.double() - ref).abs() / mass).max())
    assert key_err <= 1e-5, f"reduce_rows_by_key off by {key_err} of the summed magnitudes"
    again = linalg.reduce_rows_by_key(mat, keys, nk, res=res)
    assert torch.equal(sums, again), "reduce_rows_by_key differs from itself on a repeat"
    key_ms = cuda_ms(lambda: linalg.reduce_rows_by_key(mat, keys, nk, res=res))
    prims_emit("reduce_rows_by_key", wall, st, rows=rows, cols=cols, keys=nk, ms=key_ms,
               rel_err=key_err, repeat_bit_equal=True, launches=counts)


def _moments_ok(x, mean, var, what):
    """Mean and variance of ``x`` within 6 standard errors of the closed
    forms (the variance's from the sample's own fourth moment)."""
    import torch

    x = x.double().reshape(-1)
    n = x.numel()
    mu = float(x.mean())
    dev2 = (x - mu) ** 2
    s2 = float(dev2.mean())
    se_mean, se_var = (var / n) ** 0.5, float(dev2.std()) / n ** 0.5
    assert abs(mu - mean) <= 6 * se_mean, (what, "mean", mu, mean, se_mean)
    assert abs(s2 - var) <= 6 * se_var, (what, "variance", s2, var, se_var)
    return dict(mean=mu, var=s2, mean_z=(mu - mean) / se_mean, var_z=(s2 - var) / se_var)


def prims_random(st, total, res):
    """(2) random: every distribution at 10M draws, make_blobs, R-MAT, the
    weighted sample."""
    import math

    import torch

    from raft_tpu_torch import random as rr

    n = PRIM_DRAWS
    gamma = 0.5772156649015329
    dists = {   # name: (kwargs, mean, variance)
        "uniform": (dict(low=2.0, high=4.0), 3.0, 4.0 / 12),
        "uniform_int": (dict(low=-3, high=7), 1.5, 99.0 / 12),
        "normal": (dict(mu=1.0, sigma=2.0), 1.0, 4.0),
        "lognormal": (dict(mu=0.2, sigma=0.5), math.exp(0.325),
                      (math.exp(0.25) - 1) * math.exp(0.65)),
        "gumbel": (dict(mu=1.0, beta=2.0), 1.0 + 2.0 * gamma, math.pi ** 2 * 4.0 / 6),
        "logistic": (dict(mu=1.0, scale=2.0), 1.0, 4.0 * math.pi ** 2 / 3),
        "exponential": (dict(lam=2.0), 0.5, 0.25),
        "rayleigh": (dict(sigma=2.0), 2.0 * math.sqrt(math.pi / 2), (4 - math.pi) / 2 * 4.0),
        "laplace": (dict(mu=1.0, scale=2.0), 1.0, 8.0),
        "bernoulli": (dict(prob=0.3), 0.3, 0.21),
        "scaled_bernoulli": (dict(prob=0.3, scale=2.0), -0.8, 4.0 * 4 * 0.3 * 0.7),
        "discrete": (dict(weights=[0.0, 1.0, 3.0, 4.0]), 19 / 8, 31 / 64),
    }
    t0 = time.perf_counter()
    out = {}
    state = rr.RngState(90)
    for name, (kw, mean, var) in dists.items():
        draws = getattr(rr, name)(state, (n,), res=res, **kw)
        assert draws.shape[0] == n and draws.device.type == PRIM_DEV, name
        out[name] = _moments_ok(draws, mean, var, name)
        if name == "discrete":
            assert int((draws == 0).sum()) == 0, "discrete drew a zero-weight index"
    torch.cuda.synchronize()
    prims_emit("distributions", time.perf_counter() - t0, st, draws=n, moments=out)

    rows, cols, centers = PRIM_BLOBS
    c = torch.rand((centers, cols), generator=_gen(91), device=torch.device(PRIM_DEV)) * 20 - 10
    (x, lab), counts, wall = counted(total, lambda: rr.make_blobs(rows, cols, centers=c, seed=91,
                                                                  res=res))
    assert lab.dtype == torch.int32 and int(lab.min()) >= 0 and int(lab.max()) < centers
    z = (x - c[lab.long()]).abs()
    beyond6 = int((z > 6.0).sum())
    zmax = float(z.max())
    # 128M N(0, 1) coordinates: 0.25 beyond 6 sigma expected, none beyond 7
    assert beyond6 <= 4 and zmax <= 7.0, (beyond6, zmax)
    prims_emit("make_blobs", wall, st, rows=rows, cols=cols, centers=centers,
               coords_beyond_6_std=beyond6, max_abs_z=zmax, launches=counts)
    del x, z, lab

    scale, edges = PRIM_RMAT
    theta = [0.57, 0.19, 0.19, 0.05]
    (src, dst), counts, wall = counted(total, lambda: rr.rmat(92, theta, scale, scale, edges,
                                                              res=res))
    assert int(src.max()) < 2 ** scale and int(dst.max()) < 2 ** scale
    assert int(src.min()) >= 0 and int(dst.min()) >= 0
    th = torch.tensor(theta, dtype=torch.float64)
    th = th / th.sum()
    worst = 0.0
    for lv in range(scale):
        q = ((src >> (scale - 1 - lv)) & 1) * 2 + ((dst >> (scale - 1 - lv)) & 1)
        share = torch.bincount(q.long(), minlength=4).double().cpu() / edges
        worst = max(worst, float((share - th).abs().max()))
    assert worst <= 1e-3, f"an R-MAT level's quadrant shares are {worst} from theta"
    prims_emit("rmat", wall, st, scale=scale, edges=edges, max_share_err=worst, launches=counts)
    del src, dst

    pop, k = PRIM_SAMPLE
    w = torch.rand(pop, generator=_gen(93), device=torch.device(PRIM_DEV)) + 0.1
    zero = torch.arange(pop, device=w.device) % 10 == 3
    w[zero] = 0.0
    idx, counts, wall = counted(
        total, lambda: rr.sample_without_replacement(94, pop, k, weights=w, res=res))
    assert idx.numel() == k and torch.unique(idx).numel() == k
    assert not bool(zero[idx.long()].any()), "a zero-weight id was drawn"
    if PRIM_DEV == "cuda":
        assert counts.get("topk", 0) >= 1, counts
    prims_emit("weighted_sample", wall, st, population=pop, samples=k, zero_weight_share=0.1,
               launches=counts)


def _canonical(comp):
    """1 + the smallest vertex of each vertex's component (numpy)."""
    import numpy as np

    first = np.full(comp.max() + 1, len(comp), np.int64)
    np.minimum.at(first, comp, np.arange(len(comp)))
    return (first[comp] + 1).astype(np.int32)


def prims_label(st, total, res):
    """(3) label: make_monotonic on 10M labels, merge_labels on 1M."""
    import numpy as np
    import scipy.sparse as sps
    from scipy.sparse.csgraph import connected_components

    from raft_tpu_torch import label

    y = np.random.default_rng(95).integers(-1, 100_000, PRIM_LABELS).astype(np.int32)
    got, counts, wall = counted(
        total, lambda: label.make_monotonic(y, filter_op=lambda t: t >= 0, res=res))
    keep = y >= 0
    uniq = np.unique(y[keep])
    want = np.where(keep, np.searchsorted(uniq, y) + 1, y)
    assert np.array_equal(got.cpu().numpy(), want), "make_monotonic differs from numpy"
    prims_emit("make_monotonic", wall, st, labels=PRIM_LABELS, classes=len(uniq),
               filtered=int((~keep).sum()), equal_to_numpy=True, launches=counts)

    n, eq = PRIM_MERGE
    rng = np.random.default_rng(96)

    def comps(e):
        ends = rng.integers(0, n, (2, e))
        g = sps.coo_matrix((np.ones(e), (ends[0], ends[1])), shape=(n, n))
        return g, connected_components(g, directed=False)[1]

    ga, ca = comps(eq // 2)
    gb, cb = comps(eq // 2)
    cu = connected_components(ga + gb, directed=False)[1]
    la, lb, lu = _canonical(ca), _canonical(cb), _canonical(cu)
    merge_mod = importlib.import_module("raft_tpu_torch.label.merge_labels")
    (out, rounds), counts, wall = counted(
        total, lambda: merge_mod._merge(res.put(la), res.put(lb),
                                        res.put(np.ones(n, bool)), int(np.iinfo(np.int32).max)))
    assert np.array_equal(out.cpu().numpy(), lu), "merge_labels differs from the union-find"
    public = label.merge_labels(la, lb, np.ones(n, bool), res=res)
    assert np.array_equal(public.cpu().numpy(), lu)
    prims_emit("merge_labels", wall, st, points=n, equivalences=eq, rounds=rounds,
               components=len(np.unique(lu)), equal_to_union_find=True,
               launches=counts)


def _label_metrics64(a, b, nc):
    """The JAX module's label-metric formulas in float64 numpy."""
    import numpy as np

    c = np.bincount(a.astype(np.int64) * nc + b, minlength=nc * nc).reshape(nc, nc)
    c = c.astype(np.float64)
    n = c.sum()

    def ent(lbl):
        p = np.bincount(lbl, minlength=nc) / len(lbl)
        return -np.sum(np.where(p > 0, p * np.log(np.where(p > 0, p, 1.0)), 0.0))

    def cond(cm):
        ratio = cm / np.maximum(cm.sum(0)[None, :], 1e-30)
        return -np.sum(np.where(cm > 0, (cm / n) * np.log(np.where(ratio > 0, ratio, 1.0)), 0.0))

    pij = c / n
    pi, pj = pij.sum(1, keepdims=True), pij.sum(0, keepdims=True)
    mi = np.sum(pij * np.where(pij > 0, np.log(np.where(pij > 0, pij, 1.0))
                               - np.log(pi * pj + 1e-30), 0.0))
    comb = lambda x: x * (x - 1.0) / 2.0   # noqa: E731
    sc, sr, sl = comb(c).sum(), comb(c.sum(1)).sum(), comb(c.sum(0)).sum()
    ri = (comb(n) + 2 * sc - sr - sl) / comb(n)
    expected = sr * sl / comb(n)
    ari = (sc - expected) / (0.5 * (sr + sl) - expected + 1e-30)
    h_a, h_b = ent(a), ent(b)
    hom = 1.0 - cond(c) / h_a if h_a > 0 else 1.0
    com = 1.0 - cond(c.T) / h_b if h_b > 0 else 1.0
    v = 2 * hom * com / (hom + com + 1e-30)
    return dict(entropy=ent(a), mutual_info_score=mi, rand_index=ri, adjusted_rand_index=ari,
                homogeneity_score=hom, completeness_score=com, v_measure=v), c


def prims_stats(st, total, res):
    """(4) stats: moments, cov and histogram on 1M x 128; the label metrics
    on 1M labels; silhouette; trustworthiness."""
    import numpy as np
    import torch

    from raft_tpu_torch import linalg, random as rr, stats

    rows, cols = PRIM_STATS
    dev = torch.device(PRIM_DEV)
    x = torch.randn((rows, cols), generator=_gen(97), device=dev) * 3.0 + 1.0
    x64 = x.double()
    scale = float(x64.abs().mean())
    t0 = time.perf_counter()
    errs = {}

    def rel(name, got, want, tol):
        err = float((got.double() - want).abs().max()) / tol
        errs[name] = err * tol
        assert err <= 1.0, (name, err * tol, tol)

    mu64, var64 = x64.mean(0), x64.var(0)
    rel("mean", stats.mean(x, res=res), mu64, 1e-5 * scale)
    rel("vars_", stats.vars_(x, res=res), var64, 1e-5 * float(var64.max()))
    rel("stddev", stats.stddev(x, res=res), var64.sqrt(), 1e-5 * float(var64.sqrt().max()))
    mv = stats.meanvar(x, res=res)
    rel("meanvar", torch.stack(mv), torch.stack([mu64, var64]), 1e-5 * float(var64.max()))
    rel("sum_", stats.sum_(x, res=res), x64.sum(0), 1e-5 * scale * rows)
    lo, hi = stats.minmax(x, res=res)
    assert torch.equal(lo, x.amin(0)) and torch.equal(hi, x.amax(0))
    w = torch.rand(rows, generator=_gen(98), device=dev)
    rel("weighted_mean", stats.weighted_mean(x, w, res=res),
        (x64 * w.double()[:, None]).sum(0) / w.double().sum(), 1e-5 * scale)
    rel("mean_center", stats.mean_center(x, res=res)[:1000], x64[:1000] - mu64, 1e-5 * scale)
    cov64 = torch.cov(x64.T)
    rel("cov", stats.cov(x, res=res), cov64, 1e-4 * float(cov64.diagonal().max()))
    hist = stats.histogram(x, 64, -8.0, 10.0, res=res)
    xh = x.cpu().numpy()
    width = (10.0 - -8.0) / 64
    idx = np.clip(np.floor((xh - -8.0) / width), 0, 63).astype(np.int64)
    want = np.bincount((idx + np.arange(cols)[None, :] * 64).ravel(),
                       minlength=64 * cols).reshape(cols, 64).T
    assert hist.dtype == torch.int32 and np.array_equal(hist.cpu().numpy(), want), \
        "histogram counts differ from numpy's"
    torch.cuda.synchronize()
    prims_emit("moments", time.perf_counter() - t0, st, rows=rows, cols=cols, abs_err=errs,
               histogram_bins=64, histogram_equal_to_numpy=True)
    del x, x64, xh, idx

    n, nc = PRIM_METRIC
    rng = np.random.default_rng(99)
    a = rng.integers(0, nc, n).astype(np.int32)
    b = np.where(rng.random(n) < 0.7, a, rng.integers(0, nc, n)).astype(np.int32)
    t0 = time.perf_counter()
    want, c64 = _label_metrics64(a, b, nc)
    ad, bd = res.put(a), res.put(b)
    got = dict(entropy=stats.entropy(ad, nc, res=res),
               mutual_info_score=stats.mutual_info_score(ad, bd, nc, res=res),
               rand_index=stats.rand_index(ad, bd, res=res),
               adjusted_rand_index=stats.adjusted_rand_index(ad, bd, res=res),
               homogeneity_score=stats.homogeneity_score(ad, bd, nc, res=res),
               completeness_score=stats.completeness_score(ad, bd, nc, res=res),
               v_measure=stats.v_measure(ad, bd, nc, res=res))
    cm = stats.contingency_matrix(ad, bd, res=res)
    assert np.array_equal(cm.cpu().numpy(), c64.astype(np.int64)), "contingency counts differ"
    yv = rng.standard_normal(n).astype(np.float32)
    yh = (yv + 0.3 * rng.standard_normal(n)).astype(np.float32)
    y64, yh64 = yv.astype(np.float64), yh.astype(np.float64)
    err = np.abs(yh64 - y64)
    want.update(accuracy=float((a == b).mean()),
                r2_score=1 - np.sum((y64 - yh64) ** 2) / np.sum((y64 - y64.mean()) ** 2),
                mean_abs_error=err.mean(), mean_squared_error=(err ** 2).mean(),
                median_abs_error=float(np.median(err)))
    mae, mse, med = stats.regression_metrics(yh, yv, res=res)
    got.update(accuracy=stats.accuracy(ad, bd, res=res), r2_score=stats.r2_score(yv, yh, res=res),
               mean_abs_error=mae, mean_squared_error=mse, median_abs_error=med)
    errs = {}
    for name, g in got.items():
        errs[name] = abs(float(g) - want[name]) / max(abs(want[name]), 1e-30)
        assert errs[name] <= PRIM_METRIC_RTOL, (name, float(g), want[name])
    torch.cuda.synchronize()
    prims_emit("label_metrics", time.perf_counter() - t0, st, labels=n, classes=nc,
               rtol=PRIM_METRIC_RTOL, rel_err=errs, values={k: want[k] for k in want},
               contingency_equal=True)

    rows, cols, blobs = PRIM_SIL
    xs, ls = rr.make_blobs(rows, cols, n_clusters=blobs, cluster_std=4.0, seed=100, res=res)
    sil, counts, wall = counted(total, lambda: stats.silhouette_score(xs, ls, blobs, res=res))
    xs64 = xs.double()
    d64 = torch.cdist(xs64, xs64)
    oh = torch.nn.functional.one_hot(ls.long(), blobs).double()
    sums, cnt = d64 @ oh, oh.sum(0)
    own = cnt[ls.long()]
    a64 = sums.gather(1, ls.long()[:, None])[:, 0] / (own - 1).clamp_min(1)
    b64 = torch.where(oh == 0, sums / cnt.clamp_min(1), torch.inf).amin(1)
    s64 = float(torch.where(own > 1, (b64 - a64) / torch.maximum(a64, b64), 0.0).mean())
    assert abs(float(sil) - s64) <= 1e-4, (float(sil), s64)
    prims_emit("silhouette_score", wall, st, rows=rows, cols=cols, clusters=blobs,
               score=float(sil), float64=s64, abs_err=abs(float(sil) - s64), launches=counts)
    del d64, sums, oh

    rows, cols, emb, k = PRIM_TRUST
    xt, _ = rr.make_blobs(rows, cols, n_clusters=20, cluster_std=3.0, seed=101, res=res)
    _, _, vt = linalg.rsvd(xt - xt.mean(0), emb, seed=6, res=res)
    et = linalg.gemm(xt, vt, trans_b=True, res=res)
    tw, counts, wall = counted(total, lambda: stats.trustworthiness(xt, et, k, res=res))
    t64 = _trustworthiness64(xt.double(), et.double(), k)
    assert abs(float(tw) - t64) <= 1e-5, (float(tw), t64)
    if PRIM_DEV == "cuda":
        assert counts.get("topk", 0) >= 1, counts
    prims_emit("trustworthiness", wall, st, rows=rows, cols=cols, embedding=emb, k=k,
               score=float(tw), float64=t64, abs_err=abs(float(tw) - t64), launches=counts)


def _trustworthiness64(x, e, k):
    """The JAX module's trustworthiness in float64 on the card: a stable
    argsort for both spaces."""
    import torch

    n = x.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=x.device)
    big = torch.finfo(torch.float32).max
    d_o = torch.cdist(x, x).masked_fill_(eye, big)
    order = torch.argsort(d_o, dim=1, stable=True)
    del d_o
    ranks = torch.empty((n, n), dtype=torch.int64, device=x.device)
    ranks.scatter_(1, order, torch.arange(n, device=x.device).expand(n, n).contiguous())
    del order
    d_e = torch.cdist(e, e).masked_fill_(eye, big)
    knn = torch.argsort(d_e, dim=1, stable=True)[:, :k]
    r = torch.gather(ranks, 1, knn).double()
    penalty = float(torch.clamp_min(r - (k - 1), 0.0).sum())
    return 1.0 - 2.0 / (n * k * (2.0 * n - 3.0 * k - 1.0)) * penalty


def prims_runtime(st, total, res):
    """(5) runtime: the native library, a 512 MB .fbin streamed to the card
    in chunks, host refine against the device refine, the host merge
    against knn_merge_parts."""
    import tempfile

    import numpy as np
    import torch

    from raft_tpu_torch import runtime
    from raft_tpu_torch.neighbors.brute_force import knn_merge_parts
    from raft_tpu_torch.neighbors.refine import refine
    from raft_tpu_torch.runtime import native

    assert runtime.available(), "the native runtime did not build (g++ -O3 -shared)"
    before = native.native_calls
    rows, cols, chunk = PRIM_BIN
    x = np.random.default_rng(102).standard_normal((rows, cols)).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "base.fbin")
        t0 = time.perf_counter()
        runtime.write_bin(path, x)
        write_s = time.perf_counter() - t0
        assert os.path.getsize(path) == 8 + x.nbytes
        ds = runtime.BinDataset(path)
        assert (len(ds), ds.dim, ds.dtype) == (rows, cols, np.float32)
        t0 = time.perf_counter()
        n_chunks = 0
        for start, part in ds.chunks(chunk):
            dev_part = torch.from_numpy(part).to(PRIM_DEV)
            src = x[start:start + chunk]
            assert part.tobytes() == src.tobytes(), f"chunk at row {start} differs from the source"
            assert torch.equal(dev_part.cpu(), torch.from_numpy(src))
            n_chunks += 1
        stream_s = time.perf_counter() - t0
    assert n_chunks == -(-rows // chunk)
    prims_emit("bin_dataset", write_s + stream_s, st, rows=rows, cols=cols, bytes=x.nbytes,
               write_s=write_s, stream_s=stream_s, chunk_rows=chunk, chunks=n_chunks,
               chunks_equal=True)

    m, kin, k = PRIM_REFINE
    rng = np.random.default_rng(103)
    q = rng.standard_normal((m, cols)).astype(np.float32)
    cand = rng.integers(0, rows, (m, kin)).astype(np.int32)
    cand[::9, :5] = -1
    t0 = time.perf_counter()
    hd, hi = runtime.refine_host(x, q, cand, k)
    host_s = time.perf_counter() - t0
    xd = res.put(x)
    (dd, di), counts, wall = counted(total, lambda: refine(xd, q, cand, k, res=res))
    # the host sums each distance in dim order, the card in its own: ids
    # equal except where two distances tie within that rounding
    err = knn_equiv(torch.from_numpy(hd), torch.from_numpy(hi), dd.cpu(), di.cpu(),
                    rtol=1e-5, atol=1e-5)
    prims_emit("refine_host", host_s, st, queries=m, candidates=kin, k=k, device_s=wall,
               max_abs_err=err, launches=counts)

    s = PRIM_SHARDS
    pd = np.sort(rng.random((s, m, k)).astype(np.float32), axis=2)
    pi = rng.permutation(s * m * k).reshape(s, m, k).astype(np.int32)
    t0 = time.perf_counter()
    md, mi = runtime.merge_parts_host(pd, pi, k)
    host_s = time.perf_counter() - t0
    (rd, ri), counts, wall = counted(total, lambda: knn_merge_parts(pd, pi, k, res=res))
    knn_equiv(torch.from_numpy(md), torch.from_numpy(mi), rd.cpu(), ri.cpu(), rtol=0.0, atol=0.0)
    calls = native.native_calls - before
    assert calls > 0, "no call took the native route"
    prims_emit("merge_parts_host", host_s, st, shards=s, queries=m, k=k, device_s=wall,
               native_calls=calls, launches=counts)


def phase_prims(st):
    """Phase d: the remaining primitives (see the module docstring)."""
    from raft_tpu_torch.core import Resources

    t_phase = time.perf_counter()
    res = Resources(device=PRIM_DEV)
    total = {}
    prims_linalg(st, total, res)
    prims_random(st, total, res)
    prims_label(st, total, res)
    prims_stats(st, total, res)
    prims_runtime(st, total, res)
    if PRIM_DEV == "cuda":
        assert total.get("topk", 0) > 0, total
    st["launches_prims"] = total
    emit(phase="prims_launches", launches=total, seconds=time.perf_counter() - t_phase,
         card=st["card"])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="0123456789abcd",
                    help="phases to run, e.g. 01 (default: all); 4 to 9, a and b need 2")
    ap.add_argument("--out", default=os.path.join("build", "profiles"),
                    help="directory for the IVF-PQ, CAGRA and IVF-Flat profile tables")
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import raft_tpu_torch  # noqa: F401
    except ImportError as e:
        # the script alone, outside a checkout: nothing to run
        print(f"chip_smoke: raft_tpu_torch is not beside this script ({e})", file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    st = {"card": "not read", "out": args.out}
    phase_build(st)
    if "1" in args.phases:
        phase_kernels(st)
    if any(p in args.phases for p in "456789ab") and "2" not in args.phases:
        print("chip_smoke: phases 4 to 9, a and b use phase 2's indexes; run them with 2",
              file=sys.stderr)
        return 2
    if "2" in args.phases:
        phase_main(st)
        phase_tc_path(st)
        phase_ivf(st)
        phase_cagra(st)
        phase_cagra_bytes(st)
        phase_ivf_flat(st)
        phase_slice(st)
        phase_ball_cover(st)
        phase_matrix_ops(st)
    if "4" in args.phases:
        phase_serve(st)
    if "5" in args.phases:
        phase_stream(st)
    if "6" in args.phases:
        phase_ooc(st)
    if "7" in args.phases:
        phase_tier(st)
    if "8" in args.phases:
        phase_mesh(st)
    if "9" in args.phases:
        phase_tune(st)
    if "a" in args.phases:
        phase_net(st)
    if "b" in args.phases:
        phase_parallel(st)
    if "c" in args.phases:
        phase_graph(st)
    if "d" in args.phases:
        phase_prims(st)
    if "3" in args.phases and "2" in args.phases:
        time_fused_modes(st)
        time_f32_routes(st)
        time_merges(st)
        phase_times(st)
        time_pq_scan(st)
        time_cagra_hop(st)
    if all(p in args.phases for p in "123"):
        from raft_tpu_torch.ops import fused_knn as fk

        launches = st["launches"]
        serve = st.get("launches_serve", {})
        strm = st.get("launches_stream", {})
        folds = st.get("launches_stream_folds")
        ooc = st.get("launches_ooc")
        tier = st.get("launches_tier")
        mesh = st.get("launches_mesh")
        tune = st.get("launches_tune")
        net = st.get("launches_net")
        par = st.get("launches_parallel")
        graph = st.get("launches_graph")
        prims = st.get("launches_prims")

        def in_prims(name):
            # phase d's launches, 0 where it made none (None: phase d not run)
            return None if prims is None else prims.get(name, 0)

        def in_graph(name):
            # phase c's launches, 0 where it made none (None: phase c not run)
            return None if graph is None else graph.get(name, 0)

        def in_par(name):
            # phase b's launches, every rank's summed, 0 where it made none
            # (None: phase b not run)
            return None if par is None else par.get(name, 0)

        def in_net(name):
            # phase a's launches, the mesh workers' summed in, 0 where it made
            # none (None: phase a not run)
            return None if net is None else net.get(name, 0)

        def in_tune(name):
            # phase 9's launches, 0 where it made none (None: phase 9 not run)
            return None if tune is None else tune.get(name, 0)

        def in_mesh(name):
            # phase 8's launches, 0 where it made none (None: phase 8 not run)
            return None if mesh is None else mesh.get(name, 0)

        def in_tier(name):
            # phase 7's launches, 0 where it made none (None: phase 7 not run)
            return None if tier is None else tier.get(name, 0)

        def in_ooc(name):
            # phase 6's launches, 0 where it made none (None: phase 6 not run)
            return None if ooc is None else ooc.get(name, 0)

        def fold(name):
            # the folds' launches of phase 5, 0 where they made none
            return None if folds is None else folds.get(name, 0)

        emit(kernels=[
            dict(name="fused_knn_rows", route="cuda",
                 source="raft_tpu_torch/ops/csrc/fused_knn.cu",
                 replaces="raft_tpu/ops/fused_knn.py:150", mode="f32", f32_route="rows",
                 launches=launches["fused_knn_rows"],
                 launches_on="BruteForce.search at m = 1 and 64",
                 launches_serve=serve.get("fused_knn_rows"),
                 launches_stream=strm.get("fused_knn_rows"),
                 launches_stream_folds=fold("fused_knn_rows"),
                 launches_ooc=in_ooc("fused_knn_rows"), launches_tier=in_tier("fused_knn_rows"), launches_mesh=in_mesh("fused_knn_rows"), launches_tune=in_tune("fused_knn_rows"), launches_net=in_net("fused_knn_rows"), launches_parallel=in_par("fused_knn_rows"), launches_graph=in_graph("fused_knn_rows"), launches_prims=in_prims("fused_knn_rows"),
                 max_abs_err=st["f32_err"]["rows"], m_small=fk.M_SMALL, merge=st["merge_t"],
                 **st["rows_t"]),
            dict(name="fused_knn_tf32x3", route="cuda",
                 source="raft_tpu_torch/ops/csrc/fused_knn_tc.cu",
                 replaces="raft_tpu/ops/fused_knn.py:150", mode="f32", f32_route="tf32x3",
                 launches=launches["fused_knn_tf32x3"],
                 launches_serve=serve.get("fused_knn_tf32x3"),
                 launches_stream=strm.get("fused_knn_tf32x3"),
                 launches_stream_folds=fold("fused_knn_tf32x3"),
                 launches_ooc=in_ooc("fused_knn_tf32x3"), launches_tier=in_tier("fused_knn_tf32x3"), launches_mesh=in_mesh("fused_knn_tf32x3"), launches_tune=in_tune("fused_knn_tf32x3"), launches_net=in_net("fused_knn_tf32x3"), launches_parallel=in_par("fused_knn_tf32x3"), launches_graph=in_graph("fused_knn_tf32x3"), launches_prims=in_prims("fused_knn_tf32x3"),
                 max_abs_err=st["f32_err"]["tf32x3"], tf32x3_gate=st["tf32x3_gate"],
                 **st["f32_t"]),
            dict(name="fused_knn_tc", route="cuda",
                 source="raft_tpu_torch/ops/csrc/fused_knn_tc.cu",
                 replaces="raft_tpu/ops/fused_knn.py:150", mode="bf16",
                 launches=sum(st["tc_launches"].values()),
                 launches_by_mode=st["tc_launches"],
                 launches_stream=strm.get("fused_knn_tc"),
                 launches_stream_folds=fold("fused_knn_tc"),
                 launches_ooc=in_ooc("fused_knn_tc"), launches_tier=in_tier("fused_knn_tc"), launches_mesh=in_mesh("fused_knn_tc"), launches_tune=in_tune("fused_knn_tc"), launches_net=in_net("fused_knn_tc"), launches_parallel=in_par("fused_knn_tc"), launches_graph=in_graph("fused_knn_tc"), launches_prims=in_prims("fused_knn_tc"),
                 max_abs_err=st["tc_err"],
                 **{key: st["fused_modes_t"]["bf16"][key]
                    for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
                 modes=st["fused_modes_t"]),
            dict(name="bf16_split", route="cuda",
                 source="raft_tpu_torch/ops/csrc/fused_knn_tc.cu",
                 replaces="raft_tpu/ops/fused_knn.py:139", launches=st["split_launches"],
                 launches_stream=strm.get("bf16_split"),
                 launches_stream_folds=fold("bf16_split"),
                 launches_ooc=in_ooc("bf16_split"), launches_tier=in_tier("bf16_split"), launches_mesh=in_mesh("bf16_split"), launches_tune=in_tune("bf16_split"), launches_net=in_net("bf16_split"), launches_parallel=in_par("bf16_split"), launches_graph=in_graph("bf16_split"), launches_prims=in_prims("bf16_split"),
                 launches_on="knn(compute='float32x3')", max_abs_err=0.0, **st["split_t"]),
            dict(name="tf32_split", route="cuda",
                 source="raft_tpu_torch/ops/csrc/fused_knn_tc.cu",
                 replaces="raft_tpu/ops/fused_knn.py:146", launches=launches["tf32_split"],
                 launches_serve=serve.get("tf32_split"),
                 launches_stream=strm.get("tf32_split"),
                 launches_stream_folds=fold("tf32_split"),
                 launches_ooc=in_ooc("tf32_split"), launches_tier=in_tier("tf32_split"), launches_mesh=in_mesh("tf32_split"), launches_tune=in_tune("tf32_split"), launches_net=in_net("tf32_split"), launches_parallel=in_par("tf32_split"), launches_graph=in_graph("tf32_split"), launches_prims=in_prims("tf32_split"),
                 launches_on="BruteForce.search, 10,000 queries (mode f32's batch route)",
                 max_abs_err=0.0, **st["tf32_split_t"]),
            dict(name="topk", route="cuda", source="raft_tpu_torch/ops/csrc/topk.cu",
                 replaces="raft_tpu/ops/topk.py:91", launches=launches["topk"],
                 launches_ivf_flat=launches["topk_ivf_flat"],
                 launches_serve=serve.get("topk"), launches_stream=strm.get("topk"),
                 launches_stream_folds=fold("topk"),
                 launches_ooc=in_ooc("topk"), launches_tier=in_tier("topk"), launches_mesh=in_mesh("topk"), launches_tune=in_tune("topk"), launches_net=in_net("topk"), launches_parallel=in_par("topk"), launches_graph=in_graph("topk"), launches_prims=in_prims("topk"),
                 launches_ball_cover={m: launches[f"topk_ball_cover_{m}"]
                                      for m in ("sqeuclidean", "haversine")},
                 max_abs_err=st["topk_err"], **st["topk_t"]),
            dict(name="pq_scan", route="cuda", source="raft_tpu_torch/ops/csrc/pq_scan.cu",
                 replaces="raft_tpu/ops/pq_scan.py:61", launches=launches["pq_scan"],
                 launches_on="ivf_pq.search, select_impl='xla'",
                 launches_stream=strm.get("pq_scan"),
                 launches_stream_folds=fold("pq_scan"),
                 launches_ooc=in_ooc("pq_scan"), launches_tier=in_tier("pq_scan"), launches_mesh=in_mesh("pq_scan"), launches_tune=in_tune("pq_scan"), launches_net=in_net("pq_scan"), launches_parallel=in_par("pq_scan"), launches_graph=in_graph("pq_scan"), launches_prims=in_prims("pq_scan"),
                 launches_funnel=launches["pq_scan_opq_anisotropic_4bit"],
                 max_abs_err=st["pq_err"], **st["pq_t"]),
            dict(name="pq_scan_topk", route="cuda", source="raft_tpu_torch/ops/csrc/pq_scan.cu",
                 replaces="raft_tpu/ops/pq_scan.py:61", launches=launches["pq_scan_topk"],
                 launches_serve=serve.get("pq_scan_topk"),
                 launches_stream=strm.get("pq_scan_topk"),
                 launches_stream_folds=fold("pq_scan_topk"),
                 launches_ooc=in_ooc("pq_scan_topk"), launches_tier=in_tier("pq_scan_topk"), launches_mesh=in_mesh("pq_scan_topk"), launches_tune=in_tune("pq_scan_topk"), launches_net=in_net("pq_scan_topk"), launches_parallel=in_par("pq_scan_topk"), launches_graph=in_graph("pq_scan_topk"), launches_prims=in_prims("pq_scan_topk"),
                 launches_filtered={str(f): launches[f"pq_scan_topk_filtered_{f}"]
                                    for f in FILTER_KEEP},
                 launches_codecs={n: launches[f"pq_scan_topk_{n}"]
                                  for n in ("per_cluster", "residual_scale_norm")},
                 max_abs_err=st["pq_topk_err"], **st["pq_topk_t"]),
            dict(name="cagra_hop", route="cuda",
                 source="raft_tpu_torch/ops/csrc/cagra_hop.cu",
                 replaces="raft_tpu/ops/cagra_hop.py:88", launches=launches["cagra_hop"],
                 launches_serve=serve.get("cagra_hop"), launches_stream=strm.get("cagra_hop"),
                 launches_stream_folds=fold("cagra_hop"),
                 launches_ooc=in_ooc("cagra_hop"), launches_tier=in_tier("cagra_hop"), launches_mesh=in_mesh("cagra_hop"), launches_tune=in_tune("cagra_hop"), launches_net=in_net("cagra_hop"), launches_parallel=in_par("cagra_hop"), launches_graph=in_graph("cagra_hop"), launches_prims=in_prims("cagra_hop"),
                 launches_int8_rows=launches["cagra_hop_int8"],
                 max_abs_err=st["hop_err"], **st["hop_t"]),
        ])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
