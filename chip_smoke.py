#!/usr/bin/env python3
"""Drive the PyTorch/H100 port's main paths on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout: it imports ``predictionio_tpu_torch``
from beside this file (never JAX, never ``predictionio_tpu``).  Phases,
each of which fails the run (exit code != 0, no final ``ok`` line):

1. print the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel from the checkout's sources (K1, K2, K3: one
   ``nvcc`` each, started together) and, beside them, the native event-log
   scanner and the scan core's header parse (``native/data_plane.cpp``;
   ``g++``, each on a thread; phase 11b fails rather than read without
   them), and print the build seconds and ptxas reports;
3. hold K1 (masked score) against its plain PyTorch version at every
   ``K1_CASES`` shape: the serving shapes with packed masks and with the
   row-strided mask ALS serving hands it (``exclusion_mask``, stride I + 1)
   at B in {1, 17, 64} and K in {12, 32}, K = 33, and I no multiple of 4;
   uint8, bool and f32 masks (-inf positions exact, finite values within
   rtol/atol 1e-5);
4. hold K2 (LLR + masking) against its plain version, bit for bit, at
   [100,000 x 4,096], [8,192 x 8,192] and [37 x 190] with ~30% nonzero
   counts, and at [100,000 x 4,096] and [37 x 190] at the training tiles'
   sparsity (>99% zeros, all-zero rows), packed and as a row-strided view
   whose stride is no multiple of 4; thresholds 0 and 2;
5. hold K3 (exact row top-b) against its plain version, values and ids
   equal: [100,000 x 4,096] and [8,192 x 8,192] with b = 64, one row of
   300,000, [37 x 300] with b = 8, with planted ties and -inf runs; rows
   that are -inf but a few finite scores (and one all -inf), ascending rows
   (the pre-filter's worst case), b in {8, 64, 1024}; and the carry form
   against ``merge_desc(carry, tile_topk_desc(...))`` from the tiled loop's
   (-inf, 0) initial carry and from a random sorted carry, at the UR
   train's tile ([100,000 x 4,096], b = 64), the basket-rules tile
   ([100,000 x 1,664], b = 32) and two edge shapes;
ALS serving (slice 1):
6. build the full-width ALS model — 5,000 users x 100,000 items x rank 32,
   random factors from a seed — through ``als_model_from_state``;
7. serve it with ``deploy_models`` (the event-loop front end; models on
   the card turn the micro-batcher on) and POST ``/queries.json`` over HTTP;
8. score 256 queries through ``batch_predictor``;
   every answer of 7 and 8 is checked against the same query scored by the
   plain version on the card and ranked on the host;
9. show from K1's launch counter that 7 and 8 went through it;
UR training and serving, the store and the CLI (slices 2-8):
10. train CCO at ``bench_ur``'s full shape (100,000 users x 8,192 items,
    1M buy + 3M view events from ``synth_commerce(seed=0)``, top_k 50):
    the dense strategy through ``cco_train_indicators``, and the resident
    tiled strategy (item tile 1,024) called directly, whose indicator
    tables must be bit-identical, and both are timed; 64 sampled count
    rows against numpy;
11. train the UR from the memory store at a cut depth (MEMORY_UR: 2,000
    users x 10,000 items, 40k purchase + 80k view events, top_k 50, tile
    4,096): the events and 10,000 ``$set`` item events (category, tags,
    releaseDate, availableDate, expireDate, from the seed) go into a memory
    ``Storage``; ``read_training``'s ``URTrainingData`` must equal
    ``ur_training_data_from_arrays`` on the same arrays; ``URAlgorithm.train``
    and ``run_train`` of an engine.json's params take the dense strategy at
    this size, so K2 and K3 each launch once an event type in each
    (counters set to 0 just before each run and read just after), and
    ``merge_desc`` never runs on the card; the model
    comes back through ``load_latest_models`` and its indicator tables must
    equal, bit for bit, tables rebuilt here from the port's pieces with K3
    unfused (a tile loop of K3 without a carry, then ``merge_desc``);
11b. the deployed width (20,000 users x 100,000 items, 400k purchase + 800k
    view events and 100,000 ``$set`` item events, top_k 50, tile 4,096)
    through a localfs store in a temporary directory and the ``pio`` entry
    points, called in this process (``cli.main.main``) so the counters can
    be read: the events are written as a JSON-lines file in bulk (no
    ``Event`` objects), then ``pio app new`` and ``pio import``;
    ``read_training`` through ``PEventStore.native_batch`` (one native
    scan, counted) must equal ``ur_training_data_from_arrays``, interactions
    and item properties; ``URAlgorithm.train`` is timed on it (the wall
    earlier runs timed); ``pio build`` of two engine variants (LLR weights
    off and on) and ``pio train --engine-json`` of the first (the second
    trains from the snapshot below: cut for the time limit) launch K2 and K3
    50 times (25 tiles x 2 event types) and ``merge_desc`` never on the
    card; the stored model's tables must equal the unfused rebuild bit for
    bit; the
    JSON-lines write, import, read_training, train, save and load are timed,
    the segments' bytes, the blob's size and the train's peak device memory
    printed.  Then the columnar snapshot and the staged cache on the same
    store: ``pio snapshot smoke`` and ``pio snapshot smoke --status`` (build
    seconds, events, file bytes; coverage 1.0, no tail); ``read_training``
    cold (``_STAGED.invalidate()``), served by the snapshot (the staged
    ``snapshot`` count rises by the event count, ``scanner.scans_served``
    does not move, one native header parse), equal to the arrays path, and
    the snapshot read alone timed; ``pio import`` of a SNAP_TAIL tail from
    another seed, then ``read_training`` in this process served as a delta
    of exactly the tail, and cold as the snapshot plus the tail, each equal
    to the arrays path on the events and the tail; SNAP_DELETES view events
    tombstoned through ``l_events.delete`` (events whose user and item
    appeared earlier in the log), then ``read_training`` served by the
    snapshot without them, equal to the arrays path on what remains;
    ``pio train`` of both variants, each read cold from the snapshot and its
    tail (50 K2 and 50 K3 launches each, ``merge_desc`` never on the card),
    both stored models bit-identical to the unfused rebuild on the data read,
    their walls printed beside the native-scan ``pio train``'s;
12. serve each variant (the models trained from the snapshot) from
    ``pio deploy`` run as a subprocess on the card
    (``python -m predictionio_tpu_torch.cli.main deploy``, the store's
    ``PIO_STORAGE_*`` environment), its start to its first answer timed:
    nine listed queries of every kind, 300 timed plain ones drawn from 100
    users with history, the items and item sets, one rule query touching
    every property (it builds the model's property indexes and date
    offsets; timed on its own), and 200 timed rule queries over the same
    users (hard filters on one and several values, boosts, a filter on the
    multi-valued tags, an unknown field and value, dateRange after, before
    and both, currentDate against availableDate/expireDate); the listed
    answers and every tenth timed one of each kind are checked against the
    port's own predict on a CPU copy of the model (the plain path, reading
    the histories from the same store), every rule answer against a numpy
    oracle of the item properties, and a malformed currentDate must answer
    400; the first variant then takes UR_LOAD's round: 500 queries from 32
    closed-loop keep-alive clients (a process of their own), micro-batched
    through the UR's ``serve_batch_predict``, every answer checked against
    the CPU predict, the mean batch size read from ``/metrics`` and no
    serial re-run; then ``pio undeploy`` stops the server, which must exit
    0; the rule mask's build is timed on the card in this process, first
    and LRU-warm;
the UR's host scorer and tails, candidate pruning, the caches and
checkpointed UR training (run right after 12, on its store):
17. ``deploy`` of 12's stored model (LLR weights off) on a thread of this
    process, on the card (the micro-batcher on): (a) 400 queries drawn zipf
    from 100 distinct (user, rules, num) bodies, from 1 client and from 32
    keep-alive clients, first with ``PIO_SERVE_CACHE_AUDIT_N=1`` (every hit
    recomputed on the card and compared; no audit mismatch) and then
    without, the cache emptied before each round: hits > 0 in every round,
    every answer held against the CPU predict, the distinct answers
    byte-equal to ``PIO_SERVE_CACHE=off``, ``pio_serve_cache_total`` by
    outcome and the hits' and misses' p50/p99 printed; (b) 5 rule sets x 10
    users with the response cache off: each set's first query against the
    rest, ``pio_ur_rule_mask_cache_total``, and each set's device mask bit
    for bit ``_mask_from_key(..., host=True)``; (d) 100 plain and rule
    queries through the device halves and then the host scorer and the
    candidate-pruned host tail (``PIO_UR_SERVE_SCORER``/``_TAIL=host``):
    items equal to the device tail's (swaps only at ties within rtol/atol
    1e-5; bit-equal answers counted), native serve-core calls > 0 with no
    fallback, ``pio_ur_serve_candidate_total``, the postings inversion's
    build seconds and bytes, p50/p99 of both; (e) ``pio train`` of the
    engine with ``checkpoint: true``, ``PIO_TRAIN_RETRIES=1`` and
    ``PIO_FAULT_INJECT=ur.indicators:2``: the fault fires, the retry trains
    only the second event type (25 K2 and 25 K3 launches a call), the
    snapshots are gone and the tables bit-identical to 11b's; (c) 3
    ``purchase`` events for each of 20 users through ``run_event_server`` in
    this process: ``pio_history_cache_total{outcome="stale"}`` rises by >=
    20, their answers equal the CPU predict on the new histories and the
    answers under ``PIO_HISTORY_CACHE=off``;
the streaming fold and the follow-trainer (slice 14; right after 17):
19. ``deploy(follow=0.2)`` of 12's stored model (LLR weights off) in this
    process: the follower bootstraps from the app's log (snapshot, tail,
    tombstones), every row of both event types re-selected through K2/K3
    on the card (150 launches each: row chunks of 1 GiB); 2 rounds (of
    the reference's 8, a depth cut) of ``bench_freshness``'s protocol (bench.py:4080-4097): a probe user buys
    a brand-new seed item and, once that folds, 6 new users buy the seed
    and a brand-new item, and ``/queries.json`` is polled until the
    probe's answer holds the new item (30 s a round at most); the
    append -> reflected p50/p99 against the reference's 10 s gate, ticks
    by outcome (no retrain, no restage), rows certified and selected,
    K2/K3 launches during the folds (> 0), device memory after the
    bootstrap and after the last fold (growth within one generation's
    model plus the re-selection slice budget), K2 gathered at the nonzero
    cells of a row slice of each type bit for bit ``_score_llr_cells`` on
    the card, and after the drain the live tables, item dictionaries and
    popularity bit-identical to a from-scratch card ``engine.train``, 200
    probe answers byte-equal to it; 19b: ``pio train --follow`` as a
    subprocess on a 500 x 300 app of 5,000 purchases (the CLI wiring at a
    small size): its bootstrap and one delta each publish a COMPLETED
    instance, the second equal to a card train, and SIGINT ends it with
    exit 0;
the model plane and its replication (slice 15; right after 19):
20. ``deploy(follow=0.2, plane_publish=...)`` of the same stored model in
    this process, its own node-local plane directory: the stored instance
    seeds the plane, the follower's bootstrap and folds (K2/K3 on the card)
    publish keyframes and delta arenas, and the process serves each
    composed generation; ``pio deploy --plane-from`` as a subprocess on the
    card (another plane directory, the history read uncached) subscribes
    over PRP1 on loopback.  A duplicate-only delta (write amplification <=
    5%); the 2 rounds of 19, each timed at the SUBSCRIBER (p99 <= 10 s,
    a round > 30 s fails), both planeGenerations converging after each,
    every fold delta's write amplification printed beside the JAX
    package's 10% bar; the subscriber SIGKILLed while the stream moves on
    and restarted (no cold or lag re-sync); file frames torn in flight
    (sha256 mismatch) until two torn re-syncs, quarantined on the
    subscriber while its old generation answers byte-equal, then healed;
    200 answers byte-equal between the two; a ``ModelPlane`` in this
    process composing the subscriber's newest generation bit-equal to the
    publisher's live model and its fold's; K2/K3 launches during the folds
    (> 0), publish bytes by path, the full arena's bytes, map/compose
    seconds and each process's card memory (``nvidia-smi``) after the
    first and the last generation;
21. the store backends streaming runs on: SHARDED_UR's events (11b's
    catalog and item properties, 150k purchases and 300k views: a depth cut
    for the time limit) into EVENTDATA
    on ``sharded`` (2 shards x 2 replicas, strict acknowledgement),
    METADATA on ``sql`` (a SQLite file) and MODELDATA on ``sharedfs``;
    ``pio import`` (events/s), the cold merged scan on 2 workers (events/s,
    per-shard seconds, ``pio_store_scan_workers`` 2), ``pio train`` (50 K2
    + 50 K3; tables equal ``URAlgorithm.train``'s on the same events from
    the arrays, through the item strings: LLR bits row for row, ids equal
    but among ties), ``deploy(follow=0.2)`` in this process
    with an event server on the same store: 19's 2 rounds posted as HTTP
    batches, shard 0's primary node directory taken away after round 1
    (``pio_store_promotions_total`` +1, the next acknowledged write timed,
    every event answered 201 on its shard's primary, the follower folding
    on, p99 <= 10 s); after the drain the follower covers exactly the
    import and the events answered 201, the rows of a cold read of the
    store, a card retrain of the follower's read (staged through the
    retrain cache) has the live tables bit for bit, and 200 answers are
    byte-equal; the replica lag 0 at the end;
ALS training and the e-commerce template (slice 9):
12b. the deployed ALS width (bench.py:151: 5,000 users x 100,000 items,
    270k ``rate`` events covering the catalog + 30k ``buy``, rank 32, 4
    sweeps) in a ``shop`` app of the same localfs store, which also holds
    270k ``view`` events covering the catalog and a ``$set`` of 1-2 of 50
    ``categories`` on every item: ``pio app new``, ``pio import``, ``pio
    build`` and ``pio train`` in this process (the train's wall and peak
    device memory printed); the stored factors must be finite and equal
    the same port train on the CPU from the same generator within rtol
    1e-3, atol 2e-4 (f32 sums in another order); one half-step of each side
    on the card, from the trained factors, against float64 direct solves
    of 64 sampled rows (the widest among them) within 1e-3 of a row's
    largest entry; a second card train of the same data, reported
    bit-identical or not; then ``pio deploy`` on a thread of this process
    and 50 ``/queries.json`` (unseenOnly, blackList, an unknown user), each
    answer held against float64 scoring on the host (swaps only at ties
    within rtol/atol 1e-5), K1's counter (set to 0 before the deploy) at
    least one launch a known user's query, ``pio undeploy``;
12c. ``pio train`` of the same engine with ``checkpointEvery`` 2 under
    ``PIO_CHECKPOINT_DIR``, ``PIO_TRAIN_RETRIES=1`` and
    ``PIO_FAULT_INJECT=als.sweep:2`` (a fault after the first snapshot):
    the fault must fire, the retry resume, the run's snapshots be gone at
    the end, and the factors equal 12b's within rtol 2e-4, atol 2e-5 (the
    JAX bar, tests/test_checkpoint.py:56-57), bit-identity reported;
12d. the e-commerce template on the same shop (view and buy, implicit ALS,
    rank 32, alpha 1.0, 4 sweeps, unseenOnly): ``pio train`` (wall, peak
    memory), finite factors, the category masks and the popularity counts
    equal to the events'; a live ``$set`` of ``unavailableItems`` (the 50
    most popular items) and three live views of a user unknown at train
    time; ``pio deploy`` on a thread and 200 rule queries (categories,
    unknown categories, whiteList, empty whiteList, blackList, the
    recent-views user, cold users with and without categories), each
    answer held against a numpy oracle built from the trained factors and
    the generated events (float64 scores, ties within rtol/atol 1e-5;
    popularity answers by their scores, each item checked to qualify);
the event server, the front end and the micro-batcher (slice 10):
14. a ``shop14`` app in the same store: ``pio eventserver --workers 2`` as
    a subprocess takes 12b's 270k ``rate`` + 30k ``buy`` events over HTTP
    with its access key, in batches of 50 from 8 keep-alive clients (a
    process of their own; events/s and a batch's p50/p99): every
    acknowledged event must be in the store once, the segments per writer
    (``seg-w0-<pid>``, ``seg-w1-<pid>``), and six scrapes of ``/metrics``
    over fresh connections must each read ``pio_events_ingested_total`` =
    300,000; ``pio train`` on the card; then ``deploy(auto_reload=1.0)`` on
    the card in this process under closed-loop keep-alive clients at 1, 8
    and 32, 300 queries a level, with the default handler pool, with
    ``PIO_HTTP_POOL=32`` (the only way past K1's streaming pass on an
    8-core host: the pool caps a micro-batch) and with
    ``PIO_SERVE_BATCH=off`` at 32: p50, p99, q/s, the
    ``pio_serve_batch_size`` histogram, K1's launches by route (counts set
    to 0 just before each level, read just after; the tiled route must
    launch in the pool-32 round) and 0 serial re-runs, every answer held
    against float64 host scoring; a hot reload (20k ``rate`` events of 500
    new users over HTTP, ``pio train``): ``GET /`` names the new instance
    within the poll interval plus 5 s, the new users' answers equal the new
    factors, ``torch.cuda.memory_allocated`` after the swap and a
    ``gc.collect()`` within 2 MiB of the models' own difference (the old
    generation released); a feedback round of 200 queries leaves 200
    ``predict`` events equal to the answers; ``pio undeploy`` stops every
    server and the event server group (exit 0), no child left;
CCO at every scale and the similar-product template (slice 11; run after
phase 14, 16 before 15):
16. phase 11b's app takes a ``$set`` of one or two of 50 ``categories`` on
    every item (``pio import``); ``pio build`` and ``pio train`` of
    ``examples/similar_product/engine.json`` on that app (its cooccurrence
    algorithm as the file has it: ``maxCorrelatorsPerItem`` 50, ``minLlr``
    1; the catalog is past the dense budget, so the P-resident strategy:
    25 K2 and 25 K3 launches), 64 sampled rows of the stored table held
    against a float64 numpy oracle on the training read (ids up to ties,
    scores within rtol/atol 1e-4), and of its ALS variant (rank 10, 10
    sweeps, implicit); each ``pio deploy``-ed on a thread and asked 200
    queries (1-5 items, num 1, 10 or 50, categories and an unknown one,
    whiteList, blackList, an unknown item), every answer held against the
    CPU predict of the same stored model (scores within rtol/atol 1e-5,
    swaps only at ties within that), p50/p99 printed;
pio eval and the five remaining templates (after 16, before 15):
18. 18a: ``pio eval`` of the port's example
    ``predictionio_tpu_torch.examples.recommendation.evaluation`` by its
    package path (precision@10, 3 folds, ALS ranks 4 and 8) on
    bench_als's users and items (943 x 1,682) with 50k ratings from the
    seed (its 100k cut to half for the script's time limit), taste
    groups; ``pio import`` into the localfs store), and the same
    evaluation through ``run_eval``
    with ``FastEvalEngine``: K1 launches >= 6 in each, both
    EvaluationInstances EVALCOMPLETED, the data source read once for both
    candidates, every score within EVAL_SCORE_ATOL (1e-4, about 3 of the
    ~30,000 scored held-out ratings) of the evaluation run on the CPU, and
    each fold's served lists (every candidate) equal to those of the same
    card-trained factors scored on the CPU but for near-tie swaps, with
    precision@10 equal query by query where no swap moved the held-out
    item;
    18b: 20,000 planted purchases first join 11b's app (5,000 new users
    each buy three items of one of 100 bundles from the catalog's tail,
    then the bundle's fourth item, so that item is the one held out); a
    copy of the port's predictionio_tpu_torch/examples/universal_recommender/
    evaluation.py on the app ``smoke`` (UREvaluation + MinLlrGrid, min_llr
    0, 2 and 5, eval_users 500) on that app through ``run_eval`` with
    ``FastEvalEngine``: K2 and K3 launch 3 x 50, every candidate's hit
    rate is above 0, and each candidate's
    card-trained model, moved to the CPU, answers the 500 queries in
    ``batch_predict`` (the device halves pinned, the card's code path)
    with the same lists but for near-tie swaps; hit rate and precision@10
    equal, NDCG and MRR equal query by query where no swap moved the
    held-out item; 18c: the complementary-purchase template on 11b's
    purchases (the planted ones included) in 1-hour baskets (the tiled
    basket rules at the reference's budget: 61 tiles of 1,664, one K3
    launch each), ``pio
    deploy`` on a thread and 200 carts of 1-5 items, every answer's ids
    valid, scores finite and positive and equal to the CPU predict of the
    stored model, and a 20,000-item cut of the first 4,000 baskets through
    the tiled strategy on the card bit-equal (ids and lifts) to the CPU;
    18d: examples/product_ranking/engine.json on 12b's shop, ``pio train``
    and ``pio deploy``, 200 queries of 5-50 items from 8 keep-alive clients
    (micro-batched), orders and scores against the CPU predict (rtol
    1e-4); 18e: classification (L-BFGS and Adam; 5,000 users of 3
    attributes), lead scoring (50,000 sessions) and text (NB, logistic
    regression, MLP; 5,574 messages, dim 4,096) from seeded memory stores,
    ``pio train``, ``pio deploy`` and 100 queries each, every answer equal
    to the CPU predict of the stored weights (confidences within 1e-4).
    A leg's train s and query p50/p99 and the launches the phase adds are
    printed, and the 18c train's tile 12 (100k x 1,664, b = 32, carry form)
    joins phase 13: K3 held against ``merge_desc(carry,
    tile_topk_desc_plain(...))`` on it (the tile's id offset, the initial
    and a random carry; values and ids equal), then timed;
15. ``bench.py:bench_scale``'s parity corpus (30,000 users x 3,000 items,
    1M zipf events from its seed, top_k 20, ``exclude_self``) through
    ``cco_indicators_coo`` dense, resident, chunked (the resident budget at
    0) and with the sparse runner on (``PIO_CCO_SPARSE=on``, host and
    device tails), item tile 1,024 and user block 4,096: the five tables
    bit-identical, K2/K3 launches 1, 3, 3, 0 and 1 each; then its full
    shape, 100,000 users x 131,072 items, 50M events from
    ``_gen_scale_batches(7, ...)``'s distribution streamed through
    ``block_interactions_stream`` (user block 4,096), into
    ``cco_indicators(blocked, blocked, n_total_users=100_000, top_k=50,
    item_tile=4096, exclude_self=True)``: resident (the auto rule's pick on
    the card) and chunked (the resident budget at 0), 32 K2 and 32 K3
    launches each, the two tables bit-identical, the peak device memory
    within 80 GB; staging s, train s, events/s and peak printed.  Between
    the legs, the native chunk layout (``layout_chunks``) must have loaded
    and lay the parity corpus out as the numpy layout does, and K2 on the
    card is read against its plain chain on the CPU (cells whose bits
    differ: why the sparse host tail scores on the training's device);
13. time each kernel, its plain version and a PyTorch yardstick where one
    exists, with CUDA events and the L2 flushed, beside its bound (bytes
    over 3.35 TB/s or operations over 67 TFLOP/s, the H100 SXM data sheet's
    peaks) and the SM clock and clock-event reasons, sampled through NVML
    while the timed launches run: K2 and K3 on random inputs and on one count
    tile and one score tile captured from the deployed-width train (with
    their measured share of nonzero counts and finite scores), and K2 on
    phase 4's row-strided sparse counts, 100,000 x 4,096 and the ragged
    37 x 190, each also contiguous; K1 at 1x32,
    64x32 on the row-strided mask and 256x64, and at B=1 against ``addmm`` +
    ``masked_fill_`` in 5 interleaved rounds; an empty kernel through the
    same timer, the floor under every reading.  K2's
    operations a nonzero cell are counted from the SASS of its cell
    function (``cuobjdump``), built in phase 2.  Then ALS training:
    ``als_train`` end to end after a one-sweep warm-up, three times, at
    ``bench_als``'s shape (bench.py:363-380: 943 x 1,682, 100k ratings,
    rank 10, 10 sweeps) and at 12b's deployed width (explicit and
    implicit), with ratings x iterations a second; and a half-step's
    device ms split into the normal equations' build, the Cholesky
    factorisations and the solves (CUDA events at ``solve_half``'s stage
    marks, the mean of three sweeps), with the sweeps' peak device memory.

Observability and the rest of the front end (slice 17) ride on the phases
above, each check failing the run:
7. two ALS queries sent with ``X-PIO-Debug``: each trace retained with
   route /queries.json and status 200, K1's counter moved by them;
11b. each ``pio train``'s span journal: ``train`` -> ``engine_train``
   (attempt 1), ``staging_summary`` (its staged counts equal the
   ``pio_train_staged_events_total`` delta), ``save_models``; the 50 K2 +
   50 K3 launches inside the ``train`` span; ``pio_train_runs_total`` and
   ``pio_train_duration_seconds`` moved by one;
14. the event server's first ingest batch traced (``group_commit_append``
   in its trace, either worker answering), the last PIPELINED_EVENTS
   events through the SDK's ``EventPipeline``; both servers'
   ``/metrics/history.json`` (two samples or more) and ``/healthz``; the
   1-client level's queries again through ``EngineClient``, equal to raw
   HTTP's answers; 32-client levels with ``PIO_TRACING=off`` and then on
   again, printed beside the default's p50 and q/s;
17. a second deploy with ``PIO_SERVE_BATCH=off`` answers TRACED_QUERIES
   traced queries on the device tail byte-equal to the batched deploy's,
   each trace's ``ur_predict`` holding the history, score, mask, topk and
   assemble laps (summing to no more than the span); one waterfall printed
   through ``pio trace --rid``;
19. a ``fold-*`` trace (``model_swap``) with ``follow_tail`` and
   ``follow_fold`` for each fold tick; each round's lineage record from
   ``append_observed`` to ``first_serve`` in ``STAGE_ORDER`` with
   ``fold.rellr``, its span printed beside the round's reflected time;
20. the two processes named by ``PIO_CLUSTER_NODE``; the subscriber's own
   records holding the ``repl.*`` stages, ``watcher_wake``, ``compose``,
   ``install`` and ``first_serve`` each round; every round's record
   stitched ``cluster_complete`` at the publisher and counted by
   ``pio_cluster_propagation_seconds``; ``/cluster/metrics.json`` naming
   the publisher and the subscriber up; ``/healthz`` with the cluster SLO
   rows; ``pio lineage --cluster`` and ``pio top --window 10`` printed;
22. ``pio dashboard`` (a subprocess) on 11b's store: ``/dashboard.json``
   equal to the store's instances and evaluations, the index listing 11b's
   trains with their span breakdowns, their ``/spans/<id>.json``, SIGINT
   ending it with exit 0.

Training over ranks (slice 18), after 18, in rank processes on this card
(``python -c`` running ``rank_main``, joined at a localhost port, each
with its own timeout and reaped at the end), started before 16 so that they
train beside 16 and 18 (since slice 20; phase 23 joins and checks them):
23. (a) one rank with ``PIO_NUM_PROCESSES=1`` and a coordinator: its
    backend must be NCCL; ``cco_train_indicators`` at ``bench_ur``'s shape
    over a dp = 1 mesh (two count all-reduces through NCCL), tables bit
    for bit phase 10's dense ones; it runs beside (b)-(d);
    (b) ``pio import`` of 11b's JSON-lines file into a sharedfs store (in a
    process of its own, started after phase 21), then two ranks sharing the
    card (backend gloo) each run ``pio train`` of the
    UR at the deployed width (``cli.main.main``, LLR weights off): the
    chunked strategy over the two ranks, 50 K2 and 50 K3 launches and 50
    count all-reduces a rank, ``merge_desc`` never on the card; both stored
    models bit-identical to 11b's one-rank tables; each rank's train wall,
    peak memory and the all-reduce's calls, GB and seconds printed, the
    peaks' sum within the card; (c) ALS at 12b's width over the two ranks
    (``prepare_als_data(dp=2)``, ``mesh=``) against one rank on the same
    layout: bit-identical, else within rtol 1e-3, atol 2e-4, the largest
    difference and the all-gathers' bytes printed; (d) logistic regression
    at 18e's classification shape (L-BFGS, 100 steps): W and b equal in
    both ranks and within 1e-4 of one rank's.

The operator drills (slice 19), after 15 and before 13:
24. drills 3-7 of ``predictionio_tpu_torch/tools`` at their tier-1
    wrappers' depth, each ``python -m predictionio_tpu_torch.tools.<drill>
    --device cuda`` in a process group of its own, all five started together:
    the trace round trip (a forced-slow query's waterfall, ``/traces.json``,
    the exemplar), serve parity (the host and device tails, serial and
    batched, candidate-pruned, over HTTP serial and pipelined, then live
    hot swaps, the model plane, the response cache and the native cores:
    every answer equal to the float, every generation the cache phase's
    follower swaps out collected), the freshness round trip (3 rounds of
    append -> fold -> reflected, exact against a card retrain), plane
    replication (a publisher and two ``--plane-from`` subscribers as ``pio
    deploy`` processes on the card, one SIGKILLed and resumed) and the
    lineage round trip (a ``--plane-publish`` publisher and a
    ``--plane-from`` subscriber: the subscriber explains a generation it
    did not produce).  Each must exit 0 within DRILL_TIMEOUT_S with its
    ``ok:`` verdict last and its process's launch line before it, K2 and
    K3 launched in each (each trains); each drill's wall and launch line
    are printed with the card's name and power limit.  Their launches are
    their own processes' and stay out of the kernels line.

The line before the last is one JSON object with a row per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import ctypes
import datetime
import json
import os
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import torch

SEED = 20261016
N_USERS, N_ITEMS, RANK = 5_000, 100_000, 32
RTOL, ATOL = 1e-5, 1e-5
PEAK_BYTES_S = 3.35e12        # H100 SXM HBM3
PEAK_F32_FLOP_S = 67e12       # H100 SXM fp32 outside the tensor cores
REPLACES = {"masked_score": "predictionio_tpu/ops/pallas_kernels.py:105",
            "llr_masked": "predictionio_tpu/ops/pallas_kernels.py:191",
            "tile_topk": "predictionio_tpu/ops/pallas_kernels.py:321"}
PEAK_ISSUE_S = PEAK_F32_FLOP_S / 2   # lane-instructions a second: 132 SMs x 128 x 1.98 GHz
HOST_COVER_CYCLES = 2_000_000       # ~1 ms of device spin before each timed call
# bench_ur's full shape (bench.py:62-63) and the deployed UR width
# (bench.py:150): users, items, primary events, other events, top_k, tile
BENCH_UR = (100_000, 8_192, 1_000_000, 3_000_000, 50, 4_096)
DEPLOYED_UR = (20_000, 100_000, 400_000, 800_000, 50, 4_096)
MEMORY_UR = (2_000, 10_000, 40_000, 80_000, 50, 4_096)   # phase 11's cut depth
SNAP_TAIL = (2_000, 4_000)     # phase 11b's tail import: purchase, view events
SNAP_DELETES = 50              # phase 11b's tombstoned view events (cut for the time limit)
UR_POOL, UR_TIMED = 100, 300   # users with history in the store; timed UR queries
RULE_TIMED = 200               # timed UR rule queries
N_CATEGORIES, N_TAGS = 50, 200  # item property values of the store path
T0 = 1_780_000_000.0
T2015 = 1_420_070_400.0        # 2015-01-01T00:00:00Z
QNOW = 1_772_323_200.0         # 2026-03-01T00:00:00Z: the rule queries' "now"
ENGINE_ID = "smoke-ur"
# the deployed ALS width (bench.py:151): users, items, rate events (covering
# the catalog), buy events, rank, iterations; the e-commerce template trains
# on ECOMM_VIEWS view events (covering the catalog) and the same buys
DEPLOYED_ALS = (N_USERS, N_ITEMS, 270_000, 30_000, RANK, 4)
ECOMM_VIEWS = 270_000
BENCH_ALS = (943, 1_682, 100_000, 10, 10)   # bench.py:363-380, MovieLens-100K's shape
ALS_LAMBDA = 0.05
ALS_RTOL, ALS_ATOL = 1e-3, 2e-4   # card factors vs the CPU port's: f32 sums in another order
HALF_STEP_RTOL = 1e-3             # a row's solve vs float64, over its largest entry
CK_RTOL, CK_ATOL = 2e-4, 2e-5     # resumed vs straight (tests/test_checkpoint.py:56-57)
ECOMM_RULE_QUERIES = 200
N_UNAVAILABLE = 50
DEPLOY_TIMEOUT_S = 300   # a `pio deploy` subprocess: start to first answer, and its exit


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


_T_IMPORT = time.perf_counter()


def phase(name: str) -> None:
    print(f"== {name} [{time.perf_counter() - _T_IMPORT:.1f} s into the script]", flush=True)


# -- phase 3: K1 against its plain version --------------------------------------


def score_inputs(b, k, n, dev, gen, mask_dtype=torch.uint8, strided=False):
    """Random u, v, bias and a ~10% mask; ``strided``: the mask in the layout
    ALS serving hands K1, ``ops.als.exclusion_mask``'s row-strided view
    (stride I + 1, so its rows start at every alignment)."""
    from predictionio_tpu_torch.ops.als import exclusion_mask

    u = torch.randn(b, k, generator=gen, device=dev)
    v = torch.randn(n, k, generator=gen, device=dev)
    hit = torch.rand(b, n, generator=gen, device=dev) < 0.1
    if strided:
        ids = torch.where(hit, torch.arange(n, device=dev), -1)
        mask = exclusion_mask(ids, n, dev)
        check(b == 1 or mask.stride(0) == n + 1, "exclusion_mask's layout changed")
        if mask_dtype == torch.bool:
            mask = mask.view(torch.bool)
        elif mask_dtype != torch.uint8:   # the same layout in another dtype
            wide = torch.zeros((b, n + 1), dtype=mask_dtype, device=dev)
            wide[:, :n] = mask
            mask = wide[:, :n]
    else:
        mask = hit.to(mask_dtype)
    bias = torch.randn(n, generator=gen, device=dev)
    return u, v, mask, bias


# (B, K, I, mask dtypes, strided): the serving shapes, packed and in
# exclusion_mask's row-strided layout, on both sides of the streaming /
# tiled cut (B <= 8 / B > 8), K no multiple of 4, I no multiple of 4
K1_CASES = ([(b, k, N_ITEMS, (torch.uint8,), False) for b in (1, 8, 256) for k in (32, 64)]
            + [(8, 32, N_ITEMS, (torch.float32,), False), (5, 12, 300, (torch.uint8,), False),
               (64, 32, N_ITEMS, (torch.uint8,), False)]
            + [(b, k, N_ITEMS, (torch.uint8,), True) for b in (1, 17, 64) for k in (12, 32)]
            + [(1, 32, N_ITEMS, (torch.bool,), True),
               (17, 33, N_ITEMS, (torch.uint8, torch.float32), True),
               (3, 33, 4_099, (torch.uint8, torch.float32), True),
               (64, 32, 99_999, (torch.uint8,), True), (9, 32, 100_003, (torch.bool,), True)])


def compare_kernel(hk, dev, gen) -> float:
    """Max |kernel - plain| over every finite score of every K1_CASES shape."""
    worst = 0.0
    for b, k, n, mask_dtypes, strided in K1_CASES:
        for with_bias in (False, True):
            for mask_dtype in mask_dtypes:
                u, v, mask, bias = score_inputs(b, k, n, dev, gen, mask_dtype, strided)
                bias = bias if with_bias else None
                got = hk.masked_score_matmul(u, v, mask, bias)
                want = hk.masked_score_matmul_plain(u, v, mask, bias)
                torch.cuda.synchronize()
                tag = (f"B={b} K={k} I={n} bias={with_bias} mask={mask_dtype} "
                       f"ld={mask.stride(0) if b > 1 else n}")
                check(torch.equal(torch.isneginf(got), torch.isneginf(want)),
                      f"-inf positions differ at {tag}")
                fin = torch.isfinite(want)
                check(bool(torch.isfinite(got[fin]).all()), f"non-finite score at {tag}")
                err = (got[fin] - want[fin]).abs()
                tol = ATOL + RTOL * want[fin].abs()
                check(bool((err <= tol).all()),
                      f"kernel vs plain beyond rtol/atol 1e-5 at {tag}: "
                      f"max abs err {err.max().item()}")
                worst = max(worst, err.max().item())
                print(f"  ok {tag} max_abs_err={err.max().item():.3e}")
    return worst


# -- phases 6-8: the served ALS model ----------------------------------------


def make_state(rng):
    """JAX-ALSModel-shaped state: factors, id lists, per-user seen CSR."""
    from predictionio_tpu_torch.store.columnar import CSRLookup

    x = rng.normal(scale=0.5, size=(N_USERS, RANK)).astype(np.float32)
    y = rng.normal(scale=0.5, size=(N_ITEMS, RANK)).astype(np.float32)
    per_user = rng.integers(3, 25, size=N_USERS)
    rows = np.repeat(np.arange(N_USERS), per_user)
    items = rng.integers(0, N_ITEMS, size=len(rows))
    seen = CSRLookup.from_pairs(rows, items, N_USERS)
    return {"X": x, "Y": y,
            "users": [f"u{i}" for i in range(N_USERS)],
            "items": [f"i{i}" for i in range(N_ITEMS)],
            "seen": seen.to_state()}


def queries(rng, n):
    """Query bodies of every kind the template takes."""
    out = []
    for j in range(n):
        body = {"user": f"u{int(rng.integers(N_USERS))}",
                "num": int(rng.choice([1, 4, 10, 20, 100]))}
        if j % 3 == 1:
            body["unseenOnly"] = True
        if j % 4 == 2:
            body["blackList"] = [f"i{int(i)}" for i in rng.integers(N_ITEMS, size=5)]
        out.append(body)
    return out


def reference(model, hk, body):
    """The query scored by the plain version on the card and ranked on the
    host by (score desc, item id asc): [(item, score)], and the full score
    row (for telling a near-tie swap from a wrong answer)."""
    uid = model.user_dict.id(str(body["user"]))
    if uid is None:
        return [], None
    excl = list(model.seen.row(uid)) if body.get("unseenOnly") else []
    excl += [model.item_dict.id(b) for b in body.get("blackList", [])
             if model.item_dict.id(b) is not None]
    n = len(model.item_factors)
    mask = torch.zeros((1, n), dtype=torch.uint8, device=model.device)
    if excl:
        mask[0, torch.as_tensor(excl, dtype=torch.int64, device=model.device)] = 1
    s = hk.masked_score_matmul_plain(model.user_factors_device()[uid][None],
                                     model.item_factors_device(), mask)[0]
    s = s.cpu().numpy()
    order = np.lexsort((np.arange(n), -s))[: min(int(body.get("num", 10)), n)]
    return [(model.item_dict.str(int(i)), float(s[i])) for i in order
            if np.isfinite(s[i])], s


def check_answer(model, hk, body, got) -> int:
    """``check_ranked`` against the plain version's answer on the card."""
    want, s = reference(model, hk, body)
    return check_ranked(model, body, got, want, s)


def check_ranked(model, body, got, want, s) -> int:
    """Same items as ``want``, in its order, scores within tolerance.  Two
    items may trade places only where their reference scores ``s`` tie
    within the tolerance (the kernel and the reference sum in different
    orders); returns how many such positions there were."""
    got = [(d["item"], d["score"]) for d in got["itemScores"]]
    check(len(got) == len(want), f"{body}: {len(got)} items, want {len(want)}")
    swaps = 0
    for (gi, gs), (wi, ws) in zip(got, want):
        tol = ATOL + RTOL * abs(ws)
        check(abs(gs - ws) <= tol, f"{body}: score {gs} vs {ws}")
        if gi != wi:
            plain_gi = s[model.item_dict.id(gi)]
            check(abs(plain_gi - ws) <= tol, f"{body}: item {gi} where {wi} belongs")
            swaps += 1
    return swaps


def post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        check(resp.status == 200, f"HTTP {resp.status} for {body}")
        return json.loads(resp.read())


# -- observability: traces, span journals, lineage (phases 7, 11b, 14, 17, 19, 20, 22)

TRACED_QUERIES = 20        # phase 17's traced queries on the unbatched device tail
TRACE_WAIT_S = 10.0        # a trace or lineage record is recorded after the response
UR_LAPS = ("history", "score", "mask", "topk", "assemble")


def post_traced(url, body, rid) -> bytes:
    """POST ``body`` with ``X-PIO-Debug`` (the flight recorder keeps its
    trace) under the request id ``rid``; the response bytes."""
    req = urllib.request.Request(url, data=json.dumps(body).encode(), headers={
        "Content-Type": "application/json", "X-PIO-Debug": "1", "X-Request-ID": rid})
    with urllib.request.urlopen(req, timeout=60) as resp:
        check(resp.status in (200, 201), f"HTTP {resp.status} for {body}")
        return resp.read()


def fetch_trace(base, rid, timeout=TRACE_WAIT_S) -> dict:
    """``/traces/<rid>.json`` of the server at ``base``, polled with a
    deadline: the front end records a trace after the response is queued."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            return get_json(f"{base}/traces/{rid}.json", timeout=10)
        except urllib.error.HTTPError as e:
            check(e.code == 404 and time.monotonic() < deadline,
                  f"the trace {rid} at {base}: HTTP {e.code}")
            time.sleep(0.05)


def hist_count(h) -> int:
    """Observations of a registry histogram, over all its label sets."""
    return int(sum(v["count"] for v in h._snapshot_series().values()))


def cli_out(*argv) -> str:
    """One port ``pio`` command in this process; its standard output,
    which is printed as well."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        pio(*argv)
    text = buf.getvalue()
    print(text, end="" if text.endswith("\n") else "\n")
    return text


def trace_als_queries(hk, base, bodies) -> list:
    """Phase 7: ALS queries sent with ``X-PIO-Debug``, each retained by the
    flight recorder with route /queries.json and status 200; K1's counter
    moved by them."""
    k0 = hk.masked_score_matmul.launches
    docs = []
    for j, body in enumerate(bodies):
        rid = f"smoke7-{j}"
        post_traced(base + "/queries.json", body, rid)
        doc = fetch_trace(base, rid)
        check(doc["route"] == "/queries.json" and doc["status"] == 200
              and doc["reason"] == "debug" and doc["method"] == "POST",
              f"7: the trace of {rid}: {doc['route']} {doc['status']} {doc['reason']}")
        docs.append(doc)
    moved = hk.masked_score_matmul.launches - k0
    check(moved >= len(bodies), f"7: the traced queries launched K1 {moved} times")
    print(f"  {len(docs)} queries with X-PIO-Debug retained: "
          + ", ".join(f"{d['rid']} {d['method']} {d['route']} {d['status']} {d['reason']} "
                      f"{d['durationMs']:.3f} ms" for d in docs)
          + f"; K1 launched {moved} times by them")
    return docs


def train_obs_counts() -> dict:
    """The train metrics a ``pio train`` moves: runs, timed runs and the
    staged events by source."""
    from predictionio_tpu_torch.store.event_store import staging_counts
    from predictionio_tpu_torch.workflow import core_workflow as cw

    return {"runs": cw._M_TRAINS.value(status="COMPLETED"), "timed": hist_count(cw._M_TRAIN_S),
            "staged": {m: cw._M_TRAIN_STAGED.value(mode=m) for m in staging_counts()}}


def check_train_journal(store, engine_id, before, launches) -> dict:
    """Phase 11b: the span journal of ``engine_id``'s newest train is the
    tree ``train`` -> ``engine_train`` (attempt 1), ``staging_summary``,
    ``save_models``; the staged counts on ``staging_summary`` equal the
    ``pio_train_staged_events_total`` delta; ``pio_train_runs_total`` and
    ``pio_train_duration_seconds`` moved by one.  The K2/K3 counters were
    zeroed just before the train and read just after, so ``launches`` fell
    inside the ``train`` span."""
    from predictionio_tpu_torch.obs import spans

    after = train_obs_counts()
    inst = store.engine_instances.get_latest_completed(engine_id, "1", "default")
    recs = spans.read_journal(spans.journal_path(store, inst.id))
    roots = [s for s in recs if s.get("parent") is None]
    check(len(roots) == 1 and roots[0]["name"] == "train",
          f"11b: journal roots {[s['name'] for s in roots]}")
    root = roots[0]
    kids = {s["name"]: s for s in recs if s.get("parent") == root["id"]}
    check(sorted(kids) == ["engine_train", "save_models", "staging_summary"]
          and len(recs) == 4, f"11b: the train's spans {[s['name'] for s in recs]}")
    check(kids["engine_train"]["attrs"] == {"attempt": 1},
          f"11b: engine_train {kids['engine_train'].get('attrs')}")
    staged = {m: int(after["staged"][m] - before["staged"][m]) for m in after["staged"]}
    check(kids["staging_summary"].get("attrs", {}) == {f"staged_{m}": v
                                                        for m, v in staged.items()},
          f"11b: staging_summary {kids['staging_summary'].get('attrs')} against the "
          f"counter's delta {staged}")
    check(after["runs"] - before["runs"] == 1 and after["timed"] - before["timed"] == 1,
          f"11b: pio_train_runs_total moved {after['runs'] - before['runs']}, "
          f"pio_train_duration_seconds {after['timed'] - before['timed']}")
    out = {"instance": inst.id, "staged": staged, "launches_in_train_span": launches,
           **{f"{n}_s": kids[n]["duration_s"] for n in kids}, "train_s": root["duration_s"]}
    print(f"  pio train's span journal ({inst.id}): train {root['duration_s']:.3f} s -> "
          f"engine_train {out['engine_train_s']:.3f} s (attempt 1, K2/K3 {launches} inside), "
          f"staging_summary {kids['staging_summary']['attrs']} (= the "
          f"pio_train_staged_events_total delta), save_models {out['save_models_s']:.3f} s; "
          "pio_train_runs_total and pio_train_duration_seconds moved by one")
    return out


def traced_unbatched(dev, variants, batched_port, users) -> dict:
    """Phase 17: a second ``deploy`` of the same model with
    ``PIO_SERVE_BATCH=off`` answers TRACED_QUERIES queries sent with
    ``X-PIO-Debug`` on the device tail, byte-equal to the batched deploy's
    answers; each trace holds one ``ur_predict`` span whose laps (history,
    score, mask, topk, assemble) sum to no more than the span; one
    waterfall printed through ``pio trace --rid``.  The laps read the host
    clock: the device's work lands in the lap that reads it back."""
    from predictionio_tpu_torch.serve import response_cache
    from predictionio_tpu_torch.workflow.create_server import deploy

    bodies = [{"user": u, "num": 10} for u in users[:TRACED_QUERIES]]
    os.environ["PIO_SERVE_CACHE"] = "off"     # every query runs the tail
    server = None
    try:
        batched = [post_raw(f"http://127.0.0.1:{batched_port}/queries.json", b)
                   for b in bodies]
        os.environ["PIO_SERVE_BATCH"] = "off"
        try:
            server = deploy(str(variants[False]), host="127.0.0.1", port=0, device=dev)
        finally:
            os.environ.pop("PIO_SERVE_BATCH", None)
        check(server.pio_state.batcher is None, "17: PIO_SERVE_BATCH=off still batches")
        port = server.server_address[1]
        base = f"http://127.0.0.1:{port}"
        got = [post_traced(base + "/queries.json", b, f"smoke17-{j}")
               for j, b in enumerate(bodies)]
        differ = sum(g != w for g, w in zip(got, batched))
        check(differ == 0, f"17: {differ} unbatched answers differ from the batched deploy's")
        laps, spans_ms, slack = {}, [], []
        for j in range(len(bodies)):
            doc = fetch_trace(base, f"smoke17-{j}")
            urs = [s for s in doc["spans"] if s["name"] == "ur_predict"]
            check(len(urs) == 1, f"17: smoke17-{j} holds {len(urs)} ur_predict spans")
            sp = urs[0]
            kids = [s for s in doc["spans"] if s.get("parent") == sp["id"]]
            names = [k["name"] for k in kids]
            check(sp["attrs"]["tail"] == "device" and names == list(UR_LAPS),
                  f"17: smoke17-{j}: tail {sp['attrs'].get('tail')}, laps {names}")
            total = sum(k["duration_s"] for k in kids)
            check(total <= sp["duration_s"] + 1e-6,
                  f"17: smoke17-{j}: laps {total} s past the span's {sp['duration_s']} s")
            for k in kids:
                laps.setdefault(k["name"], []).append(k["duration_s"] * 1e3)
            spans_ms.append(sp["duration_s"] * 1e3)
            slack.append((sp["duration_s"] - total) * 1e3)
        med = {n: statistics.median(v) for n, v in laps.items()}
        print(f"  {len(bodies)} traced queries on the device tail (PIO_SERVE_BATCH=off, "
              "response cache off), answers byte-equal to the batched deploy's; ur_predict "
              f"median {statistics.median(spans_ms):.3f} ms, laps median ms "
              f"{ {n: round(v, 4) for n, v in med.items()} } (their sum under the span by a "
              f"median {statistics.median(slack):.4f} ms); the widest lap: "
              f"{max(med, key=med.get)}")
        text = cli_out("trace", f"127.0.0.1:{port}", "--rid", "smoke17-0")
        check("ur_predict" in text and "topk" in text, "17: pio trace --rid printed no laps")
        return {"queries": len(bodies), "ur_predict_ms": spans_ms, "laps_median_ms": med,
                "widest_lap": max(med, key=med.get)}
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
        os.environ.pop("PIO_SERVE_CACHE", None)


def fold_traces(base, folds: int) -> list:
    """Phase 19: the flight recorder holds a ``fold-*`` trace (reason
    ``model_swap``) for each fold tick, with ``follow_tail``,
    ``follow_fold`` and ``model_swap`` spans."""
    index = get_json(base + "/traces.json")["traces"]
    docs = [get_json(f"{base}/traces/{t['rid']}.json") for t in index
            if t["rid"].startswith("fold-") and t["reason"] == "model_swap"]
    with_fold = [d for d in docs if {"follow_tail", "follow_fold", "model_swap"}
                 <= {s["name"] for s in d["spans"]}]
    check(len(with_fold) >= folds,
          f"19: {len(with_fold)} fold traces with follow_tail and follow_fold for "
          f"{folds} fold ticks")
    return with_fold


def round_records(records, starts, what) -> list:
    """The lineage record of each round: the first one that begins at or
    after the round's append (less one follower interval: the tick that
    saw the append began before it) and holds every stage from
    ``append_observed`` to ``first_serve``, in ``STAGE_ORDER``, with
    ``fold.rellr``."""
    from predictionio_tpu_torch.obs.lineage import STAGE_ORDER

    out = []
    for r, t_wall in enumerate(starts):
        cands = sorted((d for d in records if d["start"] >= t_wall - FOLLOW_INTERVAL_S - 0.05
                        and {"append_observed", "fold.rellr", "publish", "install",
                             "first_serve"} <= {s["stage"] for s in d["stages"]}),
                       key=lambda d: d["start"])
        check(cands, f"{what}: no complete lineage record for round {r}")
        doc = cands[0]
        ranks = [STAGE_ORDER.index(s["stage"]) for s in doc["stages"]
                 if s["stage"] in STAGE_ORDER]
        check(ranks == sorted(ranks), f"{what}: round {r}'s stages out of STAGE_ORDER: "
                                      f"{[s['stage'] for s in doc['stages']]}")
        serve = [s for s in doc["stages"] if s["stage"] == "first_serve"]
        end = max(s["start"] + s["duration_s"] for s in serve)
        out.append({"lid": doc["lid"], "generation": doc.get("generation"),
                    "outcome": doc["outcome"], "stages": [s["stage"] for s in doc["stages"]],
                    "append_to_first_serve_ms": (end - doc["start"]) * 1e3})
    return out


def lineage_records(base) -> list:
    """Every merged lineage record the server at ``base`` answers."""
    index = get_json(base + "/lineage.json")["records"]
    return [get_json(f"{base}/lineage/{r['lid']}.json") for r in index]


# -- phase 13: timing ----------------------------------------------------------


class SMClock:
    """Card 0's SM clock and clock-event (throttle) reasons, read through
    NVML by a background thread while timed launches run (``sampling``);
    ``summary`` covers the samples since ``reset``."""

    SM = 1   # NVML_CLOCK_SM
    REASONS = {0x1: "gpu_idle", 0x2: "applications_clocks", 0x4: "sw_power_cap",
               0x8: "hw_slowdown", 0x10: "sync_boost", 0x20: "sw_thermal",
               0x40: "hw_thermal", 0x80: "hw_power_brake", 0x100: "display_clocks"}

    def __init__(self):
        self.nvml = ctypes.CDLL("libnvidia-ml.so.1")
        check(self.nvml.nvmlInit_v2() == 0, "nvmlInit_v2 failed")
        self.handle = ctypes.c_void_p()
        check(self.nvml.nvmlDeviceGetHandleByIndex_v2(0, ctypes.byref(self.handle)) == 0,
              "NVML has no card 0")
        self.reasons_fn = (getattr(self.nvml, "nvmlDeviceGetCurrentClocksEventReasons", None)
                           or self.nvml.nvmlDeviceGetCurrentClocksThrottleReasons)
        self.samples = []

    def read(self):
        """(SM MHz, reason bits) now."""
        mhz, reasons = ctypes.c_uint(), ctypes.c_ulonglong()
        check(self.nvml.nvmlDeviceGetClockInfo(self.handle, self.SM, ctypes.byref(mhz)) == 0,
              "nvmlDeviceGetClockInfo failed")
        check(self.reasons_fn(self.handle, ctypes.byref(reasons)) == 0,
              "NVML clock-event reasons failed")
        return mhz.value, reasons.value

    @contextlib.contextmanager
    def sampling(self, period_s=0.001):
        stop, errors = threading.Event(), []

        def poll():
            try:
                while True:
                    self.samples.append(self.read())
                    if stop.wait(period_s):
                        return
            except Exception as e:   # reported by the timing thread
                errors.append(e)

        thread = threading.Thread(target=poll, daemon=True)
        thread.start()
        try:
            yield
        finally:
            stop.set()
            thread.join()
        if errors:
            raise SmokeFailure(f"NVML sampling failed: {errors[0]!r}")

    def reset(self):
        self.samples = []

    def summary(self) -> dict:
        mhz = [m for m, _ in self.samples]
        bits = 0
        for _, r in self.samples:
            bits |= r
        return {"sm_mhz_min": min(mhz), "sm_mhz_max": max(mhz), "samples": len(mhz),
                "reasons": [name for bit, name in self.REASONS.items() if bits & bit]}


def clock_text(c: dict) -> str:
    return (f"sm {c['sm_mhz_min']}-{c['sm_mhz_max']} MHz over {c['samples']} samples "
            f"during the timing, reasons {'+'.join(c['reasons']) or 'none'}")


def time_cold(fn, flush, clock, reps=50):
    """Median ms of one call with the L2 cache flushed before it (the
    catalog's factors are not left in L2 by the previous query); the SM
    clock is sampled while the timed calls run.  A ~1 ms spin on the
    device follows the flush, so that a launch the host makes late (an
    NVML read can stall it) adds no idle time between the events."""
    for _ in range(5):
        fn()
    times = []
    with clock.sampling():
        for _ in range(reps):
            flush.zero_()
            torch.cuda._sleep(HOST_COVER_CYCLES)
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(bytes_, f32_ops):
    """(ms, "bytes" | "operations"): the larger of the bytes over the
    memory rate and the fp32 operations over their peak rate."""
    t_bytes, t_ops = bytes_ / PEAK_BYTES_S * 1e3, f32_ops / PEAK_F32_FLOP_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_ms(b, k, n, with_bias=False, mask_bytes=1):
    bytes_ = 4 * (b * k + n * k + b * n) + mask_bytes * b * n + (4 * n if with_bias else 0)
    return bound(bytes_, 2 * b * n * k + (b * n if with_bias else 0))


def time_masked_score(hk, dev, gen, b, k, n, flush, clock, strided=False):
    """K1, its plain version and ``addmm`` + ``masked_fill_`` on one input;
    ``strided``: all three read the mask in exclusion_mask's layout."""
    u, v, mask, _ = score_inputs(b, k, n, dev, gen, strided=strided)
    # the uint8 mask's bytes as bool, strides kept
    fill, zero = mask.view(torch.bool), torch.zeros(n, device=dev)

    def library():
        return torch.addmm(zero, u, v.T).masked_fill_(fill, float("-inf"))

    launches = hk.masked_score_matmul.launches
    clock.reset()
    row = {"B": b, "K": k, "I": n, "mask_ld": mask.stride(0) if b > 1 else n,
           "ms": time_cold(lambda: hk.masked_score_matmul(u, v, mask), flush, clock),
           "plain_ms": time_cold(lambda: hk.masked_score_matmul_plain(u, v, mask), flush, clock),
           "library_ms": time_cold(library, flush, clock)}
    hk.masked_score_matmul.launches = launches   # timing launches do not count
    row["bound_ms"], row["bound_by"] = bound_ms(b, k, n)
    row["sm_clock"] = clock.summary()
    return row


# (B, K, strided mask) of K1's timing rows: the first is the kernels line's
K1_TIMED = [(1, 32, False), (64, 32, True), (256, 64, False)]


def time_empty(flush, clock) -> float:
    """The floor of a ``time_cold`` reading: an empty kernel
    (``torch.cuda._sleep(0)``, a spin of no cycles) timed the same way."""
    return time_cold(lambda: torch.cuda._sleep(0), flush, clock)


def k1_text(r, smi) -> str:
    layout = f"mask ld {r['mask_ld']} (exclusion_mask's strided view)" if r["mask_ld"] != r["I"] \
        else "packed mask"
    return (f"  masked_score B={r['B']} K={r['K']} I={r['I']}, {layout}: "
            f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"addmm+masked_fill_ {r['library_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
            f"{100 * r['bound_ms'] / r['ms']:.0f}% of it) | {clock_text(r['sm_clock'])} | {smi}")


def k1_rounds_text(k1_rounds, smi) -> list:
    lines = [f"  K1 re-time round {j + 1} B=1 K=32 I={N_ITEMS}: kernel {r['k1_ms']:.4f} ms, "
             f"addmm+masked_fill_ {r['library_ms']:.4f} ms | {clock_text(r['sm_clock'])} "
             f"| {smi}" for j, r in enumerate(k1_rounds)]
    k1s, libs = [r["k1_ms"] for r in k1_rounds], [r["library_ms"] for r in k1_rounds]
    lines.append(f"  K1 re-time over {len(k1_rounds)} rounds: kernel median "
                 f"{statistics.median(k1s):.4f} ms (range {min(k1s):.4f}-{max(k1s):.4f}), "
                 f"addmm+masked_fill_ median {statistics.median(libs):.4f} ms "
                 f"(range {min(libs):.4f}-{max(libs):.4f}); kernel below the call in "
                 f"{sum(a < b for a, b in zip(k1s, libs))} of {len(k1s)} rounds | {smi}")
    return lines


def time_llr(hk, counts, row, col, n, flush, clock, ops_per_cell, label):
    """K2 on one input: kernel, plain version, bound (bytes, or the
    operations of this input's nonzero cells)."""
    launches = hk.llr_masked_scores.launches
    r, c = counts.shape
    nnz = int((counts > 0).sum())
    clock.reset()
    row_ = {"input": label, "R": r, "C": c, "nonzero_share": nnz / (r * c),
            "ms": time_cold(lambda: hk.llr_masked_scores(counts, row, col, n, 2.0), flush, clock),
            "plain_ms": time_cold(lambda: hk.llr_masked_scores_plain(counts, row, col, n, 2.0),
                                  flush, clock, reps=10),
            "library_ms": None}   # no single PyTorch call computes G²
    hk.llr_masked_scores.launches = launches   # timing launches do not count
    # int32 counts and marginals in, f32 scores out; a zero count costs no
    # operation
    row_["bound_ms"], row_["bound_by"] = bound(r * c * (4 + 4) + 4 * (r + c),
                                               nnz * ops_per_cell)
    row_["sm_clock"] = clock.summary()
    return row_


def time_topk(hk, s, b, flush, clock, label, carry=None, id_offset=0):
    """K3 on one input, without or with a carry: kernel, plain version,
    ``torch.topk(values, b)`` and the bound."""
    from predictionio_tpu_torch.ops.topk import merge_desc

    launches = hk.tile_topk_desc.launches
    r, w = s.shape
    if carry is None:
        plain = lambda: hk.tile_topk_desc_plain(s, b, id_offset)  # noqa: E731
    else:
        plain = lambda: merge_desc(  # noqa: E731
            *carry, *hk.tile_topk_desc_plain(s, b, id_offset))
    clock.reset()
    row_ = {"input": label, "R": r, "W": w, "b": b, "carry": carry is not None,
            "finite_share": float(torch.isfinite(s).float().mean()),
            "ms": time_cold(lambda: hk.tile_topk_desc(s, b, id_offset, carry), flush, clock),
            "plain_ms": time_cold(plain, flush, clock, reps=10),
            "library_ms": time_cold(lambda: torch.topk(s, b, dim=1), flush, clock)}
    hk.tile_topk_desc.launches = launches
    # each score read once (and the carry), b values and ids written; at
    # least one comparison per score
    carry_bytes = r * b * 8 if carry is not None else 0
    row_["bound_ms"], row_["bound_by"] = bound(r * w * 4 + r * b * 8 + carry_bytes, r * w)
    row_["sm_clock"] = clock.summary()
    return row_


def retime_k1(hk, dev, gen, flush, clock, rounds=5):
    """K1 at B=1 against addmm + masked_fill_, interleaved round by round."""
    u, v, mask, _ = score_inputs(1, 32, N_ITEMS, dev, gen)
    fill, zero = mask.bool(), torch.zeros(N_ITEMS, device=dev)
    launches = hk.masked_score_matmul.launches
    out = []
    for _ in range(rounds):
        clock.reset()
        k1 = time_cold(lambda: hk.masked_score_matmul(u, v, mask), flush, clock)
        lib = time_cold(lambda: torch.addmm(zero, u, v.T).masked_fill_(fill, float("-inf")),
                        flush, clock)
        out.append({"k1_ms": k1, "library_ms": lib, "sm_clock": clock.summary()})
    hk.masked_score_matmul.launches = launches
    return out


# -- phase 2: K2's instructions a cell, from SASS -----------------------------------

# A kernel around K2's nonzero-cell function alone: its SASS, less the
# probe's own loads, stores and index arithmetic, is the work of one nonzero
# cell.
LLR_PROBE = r"""
#include "{source}"
extern "C" __global__ void llr_cell_probe(const int32_t* c, const float* m, float* o) {{
  const int t = threadIdx.x;
  o[t] = llr_nonzero(c[t], m[0], m[2 + t], m[1], m[0] + m[1]);
}}
"""
_PROBE_OVERHEAD = ("LDG", "STG", "S2R", "S2UR", "LDC", "ULDC", "EXIT", "NOP", "BRA", "RET")


def parse_sass(text):
    """{function: [(offset, opcode, operands)]} of ``cuobjdump --dump-sass``."""
    import re

    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m and cur is not None:
            body = re.sub(r"^@!?U?P[T0-9]+\s+", "", m.group(2))
            op, _, rest = body.partition(" ")
            cur.append((int(m.group(1), 16), op, rest))
    return funcs


def llr_sass_count(build) -> dict:
    """SASS instructions on K2's nonzero-cell path, from a probe built from
    the checkout's ``llr_masked.cu``: the probe's main path (out-of-line
    division slow paths, reached by CALL, excluded) less its own overhead.
    Also the instruction count of each K2 kernel in the built library."""
    cuobjdump = str(Path(build.nvcc()).with_name("cuobjdump"))
    lib = subprocess.run([cuobjdump, "--dump-sass", str(build.artifact("llr_masked"))],
                         capture_output=True, text=True, timeout=120, check=True).stdout
    kernels = {name: len(ins) for name, ins in parse_sass(lib).items()}
    probe_dir = build.BUILD_DIR / "sass_probe"
    probe_dir.mkdir(parents=True, exist_ok=True)
    src, cubin = probe_dir / "llr_cell_probe.cu", probe_dir / "llr_cell_probe.cubin"
    src.write_text(LLR_PROBE.format(source=build.source("llr_masked").resolve()))
    subprocess.run([build.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                    "-O3", "-cubin", "-o", str(cubin), str(src)],
                   capture_output=True, text=True, timeout=300, check=True)
    sass = subprocess.run([cuobjdump, "--dump-sass", str(cubin)], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    ins = parse_sass(sass)["llr_cell_probe"]
    # the main path ends at its last EXIT before the first out-of-line
    # subroutine (the division slow path, which ends in RET)
    rets = [off for off, op, _ in ins if op.startswith("RET")]
    end = max(off for off, op, _ in ins if op == "EXIT" and (not rets or off < rets[0]))
    main = [op for off, op, _ in ins if off <= end]
    sub = [op for off, op, _ in ins if off > end and op not in ("NOP", "BRA")]
    cell = [op for op in main if op.split(".")[0] not in _PROBE_OVERHEAD
            and not op.startswith("IMAD.WIDE")]
    hist = {}
    for op in cell:
        hist[op.split(".")[0]] = hist.get(op.split(".")[0], 0) + 1
    return {"instructions": len(cell), "ops": len(cell) + hist.get("FFMA", 0),
            "by_opcode": dict(sorted(hist.items(), key=lambda kv: -kv[1])),
            "probe_total": len(ins), "slow_path": len(sub), "kernels": kernels}


def train_tiles(cco, hk, td, dev, tile):
    """The resident tiled loop of ``ops/cco.py:_cco_indicators_resident`` as
    the deployed train runs it (LLR threshold 0, the primary's diagonal
    masked), up to K3: yields (event name, first item of the tile, counts,
    row marginals, column marginals, scores) for each item tile of each
    event type."""
    primary = td.event_names[0]
    p_user, p_item, p_dict, _ = td.interactions[primary]
    n_users, n_items = len(td.user_dict), len(p_dict)
    prim = cco._ResidentPrimary((p_user, p_item), n_users, n_items, dev)
    for name in td.event_names:
        a_user, a_item, a_dict, _ = td.interactions[name]
        n_tiles = -(-len(a_dict) // tile)
        self_pair = name == primary
        if not self_pair:
            staged = cco._StagedCOO(a_user, a_item, dev, "item", tile, n_tiles)
        for t in range(n_tiles):
            t0 = t * tile
            if self_pair:
                at = cco._tile_slab(prim.pt, t0, tile)
            else:
                u, i = staged.span(t)
                at = cco._densify(i - t0, u, cco._round_up(tile, 8), prim.n_rows)
            counts = cco._count_product(prim.pt, at)[:n_items, :tile]
            cc = cco._marginal(at)[:tile]
            scores = hk.llr_masked_scores(counts, prim.rc, cc, float(n_users), 0.0)
            if self_pair:
                scores.diagonal(offset=-t0).fill_(float("-inf"))
            yield name, t0, counts, prim.rc, cc, scores
            del at, counts, cc, scores


def capture_train_tiles(cco, hk, td, dev, tile, t=12):
    """One count tile and its score tile as the deployed train makes them:
    tile ``t`` of the second event type against the resident primary."""
    for name, t0, counts, rc, cc, scores in train_tiles(cco, hk, td, dev, tile):
        if name == td.event_names[1] and t0 == t * tile:
            return counts, rc, cc, float(len(td.user_dict)), scores
    raise SmokeFailure(f"the deployed train has no tile {t} of {td.event_names[1]}")


# -- phases 4-5: K2 and K3 against their plain versions -----------------------------


def llr_inputs(r, c, dev, gen, kind="random"):
    """Counts with ~30% nonzero cells ("random") or at the training tiles'
    sparsity ("sparse": ~0.16% nonzero, every 50th row all zero), and
    marginals that bound them."""
    if kind == "random":
        counts = torch.randint(0, 8, (r, c), generator=gen, device=dev, dtype=torch.int32)
        counts *= torch.rand(r, c, generator=gen, device=dev) < 0.3
    else:
        counts = torch.randint(1, 40, (r, c), generator=gen, device=dev, dtype=torch.int32)
        counts *= torch.rand(r, c, generator=gen, device=dev) < 0.0016
        counts[::50] = 0
    row = counts.sum(1, dtype=torch.int32) + torch.randint(
        0, 60, (r,), generator=gen, device=dev, dtype=torch.int32)
    col = counts.sum(0, dtype=torch.int32) + torch.randint(
        0, 60, (c,), generator=gen, device=dev, dtype=torch.int32)
    return counts, row, col, float(int(row.max()) + int(col.max()) + 100)


def strided_view(counts):
    """The same counts as a row-strided view whose row stride (C + 3) is no
    multiple of 4 and whose base is one element into its allocation."""
    r, c = counts.shape
    wide = torch.zeros((r, c + 3), dtype=counts.dtype, device=counts.device)
    wide[:, 1:c + 1] = counts
    return wide[:, 1:c + 1]


# (counts kind, R, C, row-strided view)
LLR_CASES = [("random", 100_000, 4_096, False), ("random", 8_192, 8_192, False),
             ("random", 37, 190, False), ("sparse", 100_000, 4_096, False),
             ("sparse", 100_000, 4_096, True), ("sparse", 37, 190, True)]
# (scores kind, R, W, b) without a carry
TOPK_CASES = [("ties", 100_000, 4_096, 64), ("ties", 8_192, 8_192, 64),
              ("ties", 1, 300_000, 64), ("ties", 37, 300, 8),
              ("sparse", 100_000, 4_096, 64), ("ascending", 100_000, 4_096, 64),
              ("sparse", 8_192, 4_096, 8), ("ascending", 8_192, 4_097, 8),
              ("ties", 8_192, 4_096, 1024), ("sparse", 8_192, 4_096, 1024),
              ("ascending", 2_048, 4_096, 1024)]
# (b, R, W) of the carry form, each with every scores kind: the UR train's
# tile, the basket-rules tile of 18c's train (100,000 items, tile 1,664,
# b = 32) and two edge shapes
CARRY_CASES = [(64, 100_000, 4_096), (32, 100_000, 1_664), (8, 8_192, 4_096),
               (1024, 2_048, 4_096)]


def compare_llr(hk, dev, gen) -> float:
    worst = 0.0
    for kind, r, c, strided in LLR_CASES:
        counts, row, col, n = llr_inputs(r, c, dev, gen, kind)
        if strided:
            counts = strided_view(counts)
        zeros = (counts == 0).float().mean().item()
        for thr in (0.0, 2.0):
            got = hk.llr_masked_scores(counts, row, col, n, thr)
            want = hk.llr_masked_scores_plain(counts, row, col, n, thr)
            torch.cuda.synchronize()
            tag = (f"K2 [{r} x {c}] {kind} zeros={zeros:.4f} "
                   f"ld={counts.stride(0)} threshold={thr}")
            fin = torch.isfinite(want)
            err = (got[fin] - want[fin]).abs().max().item() if bool(fin.any()) else 0.0
            check(torch.equal(got, want), f"{tag}: kernel and plain differ (max abs err {err})")
            worst = max(worst, err)
            print(f"  ok {tag} finite={int(fin.sum())} bit_equal=True")
            del got, want, fin
        del counts
    return worst


def topk_inputs(r, w, dev, gen, kind="ties"):
    """"ties": scores on a 1/8 grid (many exact ties), every ninth column
    -inf, half of row 0 -inf and row 1 one constant.  "sparse": the
    training tiles, -inf but ~0.16% finite scores on a 1/8 grid, row 1 all
    -inf.  "ascending": every row ascending (row 0 with ties), so every
    score passes K3's pre-filter."""
    if kind == "ties":
        s = torch.round(torch.randn(r, w, generator=gen, device=dev) * 8) / 8
        s[:, ::9] = float("-inf")
        s[0, : w // 2] = float("-inf")
        if r > 1:
            s[1] = 0.5
    elif kind == "sparse":
        s = torch.full((r, w), float("-inf"), device=dev)
        keep = torch.rand(r, w, generator=gen, device=dev) < 0.0016
        s[keep] = torch.round(torch.rand(int(keep.sum()), generator=gen, device=dev) * 400) / 8
        if r > 1:
            s[1] = float("-inf")
    else:
        s = torch.arange(w, device=dev, dtype=torch.float32).repeat(r, 1) / 7
        s[0] = torch.div(torch.arange(w, device=dev), 3, rounding_mode="floor").float()
    return s


def topk_carry(r, b, dev, gen, kind):
    """The tiled loop's initial carry (b x (-inf, 0)), or a random sorted
    one with ties, -inf tails and arbitrary ids."""
    if kind == "initial":
        return (torch.full((r, b), float("-inf"), device=dev),
                torch.zeros((r, b), dtype=torch.int32, device=dev))
    cs = torch.round(torch.randn(r, b, generator=gen, device=dev) * 4) / 4
    cs[:, (3 * b) // 4:] = float("-inf")
    cs = torch.sort(cs, dim=1, descending=True).values
    return cs, torch.randint(0, 2**30, (r, b), generator=gen, device=dev, dtype=torch.int32)


def compare_topk(hk, dev, gen) -> float:
    from predictionio_tpu_torch.ops.topk import merge_desc

    for kind, r, w, b in TOPK_CASES:
        s = topk_inputs(r, w, dev, gen, kind)
        got_v, got_i = hk.tile_topk_desc(s, b)
        want_v, want_i = hk.tile_topk_desc_plain(s, b)
        torch.cuda.synchronize()
        tag = f"K3 [{r} x {w}] {kind} b={b}"
        check(torch.equal(got_v, want_v), f"{tag}: values differ")
        check(torch.equal(got_i, want_i), f"{tag}: ids differ")
        print(f"  ok {tag} values and ids equal")
        del s, got_v, got_i, want_v, want_i
    for kind in ("ties", "sparse", "ascending"):
        for b, r, w in CARRY_CASES:
            s = topk_inputs(r, w, dev, gen, kind)
            for carry_kind in ("initial", "random"):
                cs, ci = topk_carry(r, b, dev, gen, carry_kind)
                got_v, got_i = hk.tile_topk_desc(s, b, id_offset=40_960, carry=(cs, ci))
                want_v, want_i = merge_desc(cs, ci, *hk.tile_topk_desc_plain(
                    s, b, id_offset=40_960))
                torch.cuda.synchronize()
                tag = f"K3 carry form [{r} x {w}] {kind} b={b} carry={carry_kind}"
                check(torch.equal(got_v, want_v), f"{tag}: values differ from merge_desc")
                check(torch.equal(got_i, want_i), f"{tag}: ids differ from merge_desc")
                print(f"  ok {tag} equals merge_desc(carry, tile_topk_desc(...))")
            del s
    return 0.0


def check_topk_carry(hk, s, b, id_offset, dev, gen, label):
    """K3's carry form on a tile the main path captured, at its id offset,
    against ``merge_desc(carry, tile_topk_desc_plain(...))`` from the
    initial and from a random sorted carry: values and ids equal."""
    from predictionio_tpu_torch.ops.topk import merge_desc

    for carry_kind in ("initial", "random"):
        cs, ci = topk_carry(s.shape[0], b, dev, gen, carry_kind)
        got_v, got_i = hk.tile_topk_desc(s, b, id_offset=id_offset, carry=(cs, ci))
        want_v, want_i = merge_desc(cs, ci, *hk.tile_topk_desc_plain(s, b, id_offset=id_offset))
        torch.cuda.synchronize()
        tag = (f"K3 carry form on the {label} [{s.shape[0]} x {s.shape[1]}] b={b} "
               f"id_offset={id_offset} carry={carry_kind}")
        check(torch.equal(got_v, want_v), f"{tag}: values differ from merge_desc")
        check(torch.equal(got_i, want_i), f"{tag}: ids differ from merge_desc")
        print(f"  ok {tag} equals merge_desc(carry, tile_topk_desc(...))")


# -- phases 10-12: UR training and serving -----------------------------------------


def synth_commerce(n_users, n_items, n_buy, n_view, seed=0):
    """bench.py:synth_commerce (zipf-ish popularity), copied: this script
    imports nothing of the JAX side."""
    rng = np.random.default_rng(seed)
    pop = rng.zipf(1.3, size=n_buy * 4) % n_items
    return (rng.integers(0, n_users, n_buy).astype(np.int32),
            pop[:n_buy].astype(np.int32),
            rng.integers(0, n_users, n_view).astype(np.int32),
            pop[n_buy:n_buy + n_view].astype(np.int32))


def deployed_arrays(shape=None):
    """The interactions of a UR shape (the deployed width is bench.py:150's
    commerce events): both event types cover the whole catalog (so each has
    ceil(items / 4,096) item tiles), then zipf-popular items."""
    n_users, n_items, n_p, n_v, _, _ = shape or DEPLOYED_UR
    rng = np.random.default_rng(SEED)
    cover = np.arange(n_items)
    pu = rng.integers(0, n_users, n_p).astype(np.int32)
    pi = np.concatenate([cover, rng.zipf(1.3, n_p - n_items) % n_items]).astype(np.int32)
    vu = rng.integers(0, n_users, n_v).astype(np.int32)
    vi = np.concatenate([cover, rng.zipf(1.2, n_v - n_items) % n_items]).astype(np.int32)
    return pu, pi, vu, vi


def iso(epoch_s: float) -> str:
    return datetime.datetime.fromtimestamp(epoch_s, datetime.timezone.utc).isoformat()


def epoch(text: str) -> float:
    return datetime.datetime.fromisoformat(text).timestamp()


def item_columns(n_items):
    """Every item's properties, from the seed, as columns: a category of 50
    (zipf-skewed), 1-3 distinct tags of 200 (-1 pads), and epoch-second
    dates (NaN where missing): releaseDate over 2015-2026 (missing on 5%),
    availableDate and expireDate around QNOW (each missing on 10%; 1% of
    items each have the bound at QNOW exactly)."""
    rng = np.random.default_rng(SEED + 2)
    cat = (rng.zipf(1.3, n_items) - 1) % N_CATEGORIES
    base = rng.integers(0, N_TAGS, n_items)
    tags = np.stack([base, (base + rng.integers(1, N_TAGS // 2, n_items)) % N_TAGS,
                     (base + rng.integers(N_TAGS // 2, N_TAGS, n_items)) % N_TAGS], 1)
    tags[np.arange(3)[None, :] >= rng.integers(1, 4, n_items)[:, None]] = -1
    day = 86_400
    dates = {"releaseDate": (T2015 + rng.integers(0, 12 * 365 * day, n_items)).astype(np.float64),
             "availableDate": QNOW - rng.integers(-30 * day, 400 * day, n_items),
             "expireDate": QNOW + rng.integers(-30 * day, 400 * day, n_items)}
    for name, share in (("releaseDate", 0.05), ("availableDate", 0.1), ("expireDate", 0.1)):
        d = dates[name].astype(np.float64)
        if name != "releaseDate":
            d[rng.choice(n_items, n_items // 100, replace=False)] = QNOW
        d[rng.random(n_items) < share] = np.nan
        dates[name] = d
    return cat, tags, dates


def item_properties(cols):
    """The ``$set`` property map of every item, from its columns."""
    cat, tags, dates = cols
    props = {}
    for j in range(len(cat)):
        p = {"category": f"c{cat[j]}", "tags": [f"t{t}" for t in tags[j] if t >= 0]}
        for name, d in dates.items():
            if not np.isnan(d[j]):
                p[name] = iso(float(d[j]))
        props[f"i{j}"] = p
    return props


def write_jsonl(path, arrays, props):
    """``store_events``'s events as a JSON-lines file for ``pio import``,
    built in bulk from the arrays (times as ISO strings by numpy, lines by
    one format string per event type; no ``Event`` objects)."""
    t = iso(T0 - 1)
    with open(path, "w") as f:
        f.writelines(json.dumps({"event": "$set", "entityType": "item", "entityId": item,
                                 "properties": p, "eventTime": t, "creationTime": t}) + "\n"
                     for item, p in props.items())
        write_interactions(f, log_blocks(arrays))


def log_blocks(arrays):
    """The interactions of ``arrays`` as log blocks (event name, users,
    items, event times in epoch seconds): every purchase, one a second from
    T0, then every view."""
    pu, pi, vu, vi = arrays
    return [("purchase", pu, pi, T0 + np.arange(len(pu), dtype=np.float64)),
            ("view", vu, vi, T0 + len(pu) + np.arange(len(vu), dtype=np.float64))]


def write_interactions(f, blocks):
    """Interaction lines of ``blocks``, in order, one format string an event
    type (times as ISO strings by numpy)."""
    for name, users, items, times in blocks:
        iso_t = np.datetime_as_string(times.astype(np.int64).astype("datetime64[s]"),
                                      timezone="UTC").tolist()
        line = ('{"event":"%s","entityType":"user","entityId":"u%%d","targetEntityType":'
                '"item","targetEntityId":"i%%d","eventTime":"%%s","creationTime":"%%s"}\n'
                % name)
        f.writelines(map(line.__mod__, zip(users.tolist(), items.tolist(), iso_t, iso_t)))


def store_events(Event, arrays, props):
    """The events a deployment ingests: every purchase (one a second from
    T0), then every view, and one ``$set`` per item before them."""
    pu, pi, vu, vi = arrays
    t_view = T0 + len(pu)
    events = [Event("$set", "item", item, properties=p, event_time=T0 - 1, creation_time=T0 - 1)
              for item, p in props.items()]
    for name, users, items, t0 in (("purchase", pu, pi, T0), ("view", vu, vi, t_view)):
        events.extend(Event(name, "user", f"u{u}", "item", f"i{i}", event_time=t0 + k,
                            creation_time=t0 + k)
                      for k, (u, i) in enumerate(zip(users.tolist(), items.tolist())))
    return events


def expected_training_data(ur, arrays, props, shape=None, blocks=None):
    """``ur_training_data_from_arrays`` on the store's arrays (or on log
    ``blocks`` in log order, as ``log_blocks`` gives them), in the order
    ``URDataSource.read_training`` gives them: dictionary codes by first
    appearance in the log; users of the primary event first, each type's
    items in code order."""
    blocks = blocks or log_blocks(arrays)
    n_users, n_items = (shape or DEPLOYED_UR)[:2]

    def first_seen(seq):
        uniq, idx = np.unique(seq, return_index=True)
        return uniq[np.argsort(idx, kind="stable")]

    def positions(ids, n):
        pos = np.full(n, -1, np.int64)
        pos[ids] = np.arange(len(ids))
        return pos

    def of(name, k):
        return np.concatenate([b[k] for b in blocks if b[0] == name])

    user_of_code = first_seen(np.concatenate([b[1] for b in blocks]))
    code_of_user = positions(user_of_code, n_users)
    p_codes = np.unique(code_of_user[of("purchase", 1)])
    users = user_of_code[np.concatenate([p_codes, np.setdiff1d(code_of_user[of("view", 1)],
                                                               p_codes)])]
    user_pos = positions(users, n_users)
    item_of_code = first_seen(np.concatenate([b[2] for b in blocks]))
    code_of_item = positions(item_of_code, n_items)
    inter = {}
    for name in ("purchase", "view"):
        u, i = of(name, 1), of(name, 2)
        items = item_of_code[np.unique(code_of_item[i])]
        inter[name] = (user_pos[u], positions(items, n_items)[i], [f"i{x}" for x in items],
                       of(name, 3))
    return ur.ur_training_data_from_arrays(
        ["purchase", "view"], [f"u{x}" for x in users], inter, props)


def same_training_data(got, want):
    """The read_training check: users, every type's arrays and item
    dictionary, and the item properties equal."""
    check(got.event_names == want.event_names, "event names differ")
    check(got.user_dict.to_state() == want.user_dict.to_state(), "user dictionaries differ")
    for name, (wu, wi, wd, wt) in want.interactions.items():
        gu, gi, gd, gt = got.interactions[name]
        check(all(g.dtype == w.dtype and np.array_equal(g, w)
                  for g, w in ((gu, wu), (gi, wi), (gt, wt))), f"{name}: arrays differ")
        check(gd.to_state() == wd.to_state(), f"{name}: item dictionaries differ")
    check(got.item_properties == want.item_properties, "item properties differ")


def engine_variant(use_llr, shape=None):
    """The engine.json a deployment of the store path trains and serves
    (LLR weights on: its own engine id, so both deploy from one store)."""
    shape = shape or DEPLOYED_UR
    return {"id": ENGINE_ID + ("-llr" if use_llr else ""),
            "engineFactory": "universal_recommender",
            "datasource": {"params": {"appName": "smoke",
                                      "eventNames": ["purchase", "view"]}},
            "algorithms": [{"name": "ur", "params": {
                "appName": "smoke", "maxCorrelatorsPerItem": shape[4],
                "itemTile": shape[5], "useLlrWeights": use_llr,
                "availableDateName": "availableDate", "expireDateName": "expireDate"}}]}


def numpy_counts(pu, pi, au, ai, n_items_t, rows):
    """Exact cooccurrence count rows and row marginals of sampled primary
    items, from deduplicated pairs."""
    p = np.unique(pu.astype(np.int64) << 32 | pi)
    p_u, p_i = p >> 32, p & 0xFFFFFFFF
    a = np.unique(au.astype(np.int64) << 32 | ai)
    a_u, a_i = a >> 32, a & 0xFFFFFFFF
    out, marg = [], []
    for r in rows:
        users = p_u[p_i == r]
        out.append(np.bincount(a_i[np.isin(a_u, users)], minlength=n_items_t))
        marg.append(len(users))
    return np.stack(out), np.asarray(marg), np.bincount(a_i, minlength=n_items_t)


def train_bench_shape(cco, hk, dev):
    """Phase 10: bench_ur's full shape through both strategies."""
    n_users, n_items, n_buy, n_view, top_k, _ = BENCH_UR
    bu, bi, vu, vi = synth_commerce(n_users, n_items, n_buy, n_view)
    others = [("buy", bu, bi, n_items), ("view", vu, vi, n_items)]
    check(cco._dense_path_ok(n_items, n_items), "bench shape should take the dense path")
    walls = []
    for run_ in range(2):   # the first run pays one-time set-up
        hk.llr_masked_scores.launches = hk.tile_topk_desc.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dense = cco.cco_train_indicators(bu, bi, others, n_users, n_items, top_k=top_k,
                                         exclude_self_for="buy", device=dev)
        walls.append(time.perf_counter() - t0)
    launches = (hk.llr_masked_scores.launches, hk.tile_topk_desc.launches)
    res_walls = []
    for run_ in range(2):   # timed as the dense train is: staging included
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prim = cco._ResidentPrimary((bu, bi), n_users, n_items, dev)
        resident = {name: cco._cco_indicators_resident(
            prim, (au, ai), n_items, n_users, top_k, 0.0, 1_024, name == "buy", au is bu)
            for name, au, ai, _ in others}
        res_walls.append(time.perf_counter() - t0)
    for name in dense:
        check(np.array_equal(dense[name][0].view(np.int32), resident[name][0].view(np.int32))
              and np.array_equal(dense[name][1], resident[name][1]),
              f"{name}: dense and resident tiled indicator tables differ")
        fin = np.isfinite(dense[name][0])
        check(fin.any() and not (dense[name][1][fin] < 0).any(), f"{name}: no indicators")
        print(f"  {name}: dense == resident (tile 1,024) bit for bit, "
              f"{int(fin.sum())} indicators, mean LLR {float(dense[name][0][fin].mean()):.3f}")
    del prim
    runner = cco._DenseRunner(bu, bi, n_users, n_items, n_items, dev)
    rows = np.random.default_rng(SEED).choice(n_items, 64, replace=False)
    for name, au, ai in (("buy", bu, bi), ("view", vu, vi)):
        C, rc, cc = runner.counts(au, ai, n_items, self_pair=name == "buy")
        want, want_rc, want_cc = numpy_counts(bu, bi, au, ai, n_items, rows)
        got = C[torch.as_tensor(rows, device=dev)].cpu().numpy()[:, :n_items]
        check(np.array_equal(got, want), f"{name}: count rows differ from numpy")
        check(np.array_equal(rc.cpu().numpy()[rows], want_rc), f"{name}: row marginals differ")
        check(np.array_equal(cc.cpu().numpy()[:n_items], want_cc), f"{name}: column marginals differ")
        print(f"  {name}: 64 sampled count rows, their marginals and every column "
              f"marginal equal numpy's (max count {int(want.max())})")
        del C
    events = n_buy + n_view
    print(f"  users={n_users} items={n_items} events={events} top_k={top_k} dense train "
          f"wall_s first={walls[0]:.3f} then={walls[1]:.3f} "
          f"events_per_s={events / walls[1]:.0f} launches K2={launches[0]} K3={launches[1]}")
    print(f"  resident tiled (tile 1,024) on the same data: wall_s first={res_walls[0]:.4f} "
          f"then={res_walls[1]:.4f}; dense then={walls[1]:.4f}")
    return {"wall_s": walls[1], "first_wall_s": walls[0], "events": events,
            "launches": launches, "resident_wall_s": res_walls[1],
            "resident_first_wall_s": res_walls[0]}, dense


def initial_carry(td, b, dev):
    """The tiled loop's carry before its first tile, for each event type:
    b x (-inf, id 0) for every primary item."""
    n_items = len(td.interactions[td.event_names[0]][2])
    return {name: (torch.full((n_items, b), float("-inf"), device=dev),
                   torch.zeros((n_items, b), dtype=torch.int32, device=dev))
            for name in td.event_names}


def unfused_indicators(cco, hk, td, dev, top_k, tile):
    """The deployed train's indicator tables rebuilt from the port's pieces
    with K3 unfused: each tile's K3 top-b without a carry, then
    ``merge_desc``."""
    from predictionio_tpu_torch.ops.topk import block_width, merge_desc

    b = block_width(top_k)
    best = initial_carry(td, b, dev)
    for name, t0, _, _, _, scores in train_tiles(cco, hk, td, dev, tile):
        best[name] = merge_desc(*best[name], *hk.tile_topk_desc(scores, b, id_offset=t0))
    out = {}
    for name, (best_s, best_i) in best.items():
        sc, idx = cco._finalize_topk(best_s, best_i, len(td.interactions[name][2]), top_k)
        out[name] = (idx.astype(np.int32), np.where(np.isfinite(sc), sc, 0.0).astype(np.float32))
    return out


@contextlib.contextmanager
def count_card_merges():
    """Every module of the port that holds ``merge_desc`` gets one that
    counts its calls on CUDA tensors; yields the one-element count."""
    from predictionio_tpu_torch.ops import topk

    merge_desc, count = topk.merge_desc, [0]

    def counting_merge(*args):
        count[0] += args[0].is_cuda
        return merge_desc(*args)

    holders = [m for name, m in list(sys.modules.items())
               if name.startswith("predictionio_tpu_torch")
               and getattr(m, "merge_desc", None) is merge_desc]
    for m in holders:
        m.merge_desc = counting_merge
    try:
        yield count
    finally:
        for m in holders:
            m.merge_desc = merge_desc


def timed_train(hk, algo, td):
    """``URAlgorithm.train``'s wall after a warm-up train (one-time set-up
    of the count product and kernels), and its K2/K3 launches."""
    algo.train(td)
    torch.cuda.synchronize()
    hk.llr_masked_scores.launches = hk.tile_topk_desc.launches = 0
    t0 = time.perf_counter()
    algo.train(td)
    return time.perf_counter() - t0, (hk.llr_masked_scores.launches, hk.tile_topk_desc.launches)


def check_tables(model, rebuilt, n_items, top_k, what):
    """The stored model's indicator tables against the unfused rebuild,
    bit for bit."""
    for name in ("purchase", "view"):
        idx, llr = model.indicator_idx[name], model.indicator_llr[name]
        check(idx.shape == (n_items, top_k) and (idx >= 0).any(), f"{what} {name}: bad table")
        check(bool(np.isfinite(llr).all()), f"{what} {name}: non-finite LLR")
        if name == "purchase":
            check(not (idx == np.arange(n_items)[:, None]).any(), "self-pairs not excluded")
        want_idx, want_llr = rebuilt[name]
        check(np.array_equal(idx, want_idx) and np.array_equal(llr.view(np.int32),
                                                               want_llr.view(np.int32)),
              f"{what} {name}: stored tables differ from the unfused K3 + merge_desc rebuild")
        print(f"  {what} {name}: [{n_items} x {top_k}] indicators, {int((idx >= 0).sum())} set, "
              "stored, loaded and bit-identical to the unfused K3 + merge_desc rebuild")


def train_memory(ur, cco, hk, dev):
    """Phase 11: the UR from the memory store at MEMORY_UR's cut depth —
    events with $set properties → a memory Storage → read_training (held
    against the arrays path) → URAlgorithm.train → run_train (K2/K3
    launches counted) → the model store → load_latest_models."""
    from predictionio_tpu_torch.events.event import Event
    from predictionio_tpu_torch.storage import App, Storage, StorageConfig, set_storage
    from predictionio_tpu_torch.workflow.core_workflow import load_latest_models, run_train
    from predictionio_tpu_torch.workflow.create_workflow import engine_from_variant

    n_users, n_items, n_p, n_v, top_k, tile = MEMORY_UR
    arrays = deployed_arrays(MEMORY_UR)
    props = item_properties(item_columns(n_items))
    store = Storage(StorageConfig.memory())
    set_storage(store)   # the data source reads the process default, as in the reference
    app = store.apps.insert(App(0, "smoke"))
    t0 = time.perf_counter()
    events = store_events(Event, arrays, props)
    build_s = time.perf_counter() - t0
    store.l_events.insert_batch(events, app)
    insert_s = time.perf_counter() - t0
    del events
    _, engine, ep = engine_from_variant(engine_variant(False, MEMORY_UR))
    t0 = time.perf_counter()
    td_store = engine.make_components(ep)[0].read_training()
    read_s = time.perf_counter() - t0
    td = expected_training_data(ur, arrays, props, MEMORY_UR)
    same_training_data(td_store, td)
    del td_store
    print(f"  {n_p + n_v} interactions + {n_items} $set item events built and inserted in "
          f"{insert_s:.3f} s (the Event objects {build_s:.3f} s of it); read_training "
          f"{read_s:.3f} s, equal to "
          "ur_training_data_from_arrays on the same arrays (interactions and item properties)")
    params = ep.algorithm_params_list[0][1]
    check(params.min_llr == 0.0, "the unfused rebuild assumes LLR threshold 0")
    # the dense strategy at this size: one K2 and one K3 an event type
    check(cco._dense_path_ok(n_items, n_items), "the cut depth should take the dense path")
    tiles = 2
    with count_card_merges() as merges:
        wall, train_launches = timed_train(hk, ur.URAlgorithm(params, device=dev), td)
        hk.llr_masked_scores.launches = hk.tile_topk_desc.launches = 0
        t0 = time.perf_counter()
        instance = run_train(engine, ep, ENGINE_ID, storage=store, device=dev)
        run_train_s = time.perf_counter() - t0
        launches = (hk.llr_masked_scores.launches, hk.tile_topk_desc.launches)
    check(instance.status == "COMPLETED", f"run_train left its instance {instance.status}")
    for what, got in (("URAlgorithm.train", train_launches), ("run_train", launches)):
        check(got == (tiles, tiles),
              f"K2/K3 launches {got} in {what} at {n_items} items, expected {tiles} each")
    check(merges[0] == 0, f"merge_desc ran {merges[0]} times on the card")
    found, (model,) = load_latest_models(ENGINE_ID, storage=store, device=dev)
    check(found.id == instance.id and model.device == dev, "load_latest_models")
    check_tables(model, unfused_indicators(cco, hk, td, dev, top_k, tile), n_items, top_k,
                 "memory store")
    print(f"  users={n_users} items={n_items} events={n_p + n_v} (dense) "
          f"URAlgorithm.train wall_s={wall:.3f} launches K2={train_launches[0]} "
          f"K3={train_launches[1]}; run_train wall_s={run_train_s:.3f} launches "
          f"K2={launches[0]} K3={launches[1]} merge_desc on the card={merges[0]}")
    set_storage(None)
    return {"shape": list(MEMORY_UR), "wall_s": wall, "launches": launches,
            "insert_s": insert_s, "event_build_s": build_s, "read_training_s": read_s,
            "run_train_s": run_train_s}


def localfs_env(root):
    """The ``PIO_STORAGE_*`` environment of one localfs store at ``root``."""
    return {"PIO_STORAGE_SOURCES_FS_TYPE": "localfs", "PIO_STORAGE_SOURCES_FS_PATH": str(root),
            **{f"PIO_STORAGE_REPOSITORIES_{r}_SOURCE": "FS"
               for r in ("METADATA", "EVENTDATA", "MODELDATA")}}


def pio(*argv):
    """One ``pio`` command in this process (so the launch counters can be
    read); fails the phase on a non-zero exit."""
    from predictionio_tpu_torch.cli.main import main as pio_main

    rc = pio_main(list(argv))
    check(rc == 0, f"pio {' '.join(argv)} exited {rc}")


def train_localfs(ur, cco, hk, dev, workdir):
    """Phase 11b: the deployed UR width through the localfs store and the
    ``pio`` entry points — a JSON-lines file → ``pio app new`` → ``pio
    import`` → read_training through the native scan (held against the
    arrays path) → ``pio build`` of both engine variants → ``pio train`` of
    the first (K2/K3 launches counted) → the model store."""
    from predictionio_tpu_torch.native import scanner
    from predictionio_tpu_torch.storage import get_storage, set_storage
    from predictionio_tpu_torch.workflow.core_workflow import load_latest_models
    from predictionio_tpu_torch.workflow.create_workflow import engine_from_variant
    from predictionio_tpu_torch.workflow.persistence import save_models

    n_users, n_items, n_p, n_v, top_k, tile = DEPLOYED_UR
    arrays = deployed_arrays()
    cols = item_columns(n_items)
    props = item_properties(cols)
    env = {**localfs_env(workdir / "store"), "PIO_TORCH_DEVICE": dev.type}
    os.environ.update(env)
    set_storage(None)    # the process default is built anew from the environment
    jsonl = workdir / "events.jsonl"
    t = {}
    t0 = time.perf_counter()
    write_jsonl(jsonl, arrays, props)
    t["jsonl_write_s"] = time.perf_counter() - t0
    pio("app", "new", "smoke")
    t0 = time.perf_counter()
    pio("import", "--app-name", "smoke", "--input", str(jsonl))
    t["import_s"] = time.perf_counter() - t0
    n_events = n_p + n_v + n_items
    store = get_storage()
    app = store.apps.get_by_name("smoke")
    segs = store.l_events.segment_paths(app.id)
    seg_bytes = sum(p.stat().st_size for p in segs)
    print(f"  {n_events} events written as JSON lines in {t['jsonl_write_s']:.3f} s "
          f"({jsonl.stat().st_size} bytes), imported in {t['import_s']:.3f} s "
          f"({n_events / t['import_s']:.0f} events/s) into {len(segs)} segments of "
          f"{seg_bytes} bytes")
    variants = {}
    for use_llr in (False, True):
        variants[use_llr] = workdir / f"engine-{use_llr}.json"
        variants[use_llr].write_text(json.dumps(engine_variant(use_llr)))
    _, engine, ep = engine_from_variant(engine_variant(False))
    served = scanner.scans_served
    t0 = time.perf_counter()
    td_store = engine.make_components(ep)[0].read_training()
    t["read_training_s"] = time.perf_counter() - t0
    check(scanner.scans_served == served + 1,
          f"read_training made {scanner.scans_served - served} native scans, not 1")
    td = expected_training_data(ur, arrays, props)
    same_training_data(td_store, td)
    del td_store
    print(f"  read_training through PEventStore.native_batch (one native scan) "
          f"{t['read_training_s']:.3f} s, equal to ur_training_data_from_arrays on the same "
          "arrays (interactions and item properties)")
    params = ep.algorithm_params_list[0][1]
    check(params.min_llr == 0.0, "the unfused rebuild assumes LLR threshold 0")
    tiles = 2 * -(-n_items // tile)
    launches, journals = {}, {}
    with count_card_merges() as merges:
        t["train_wall_s"], train_launches = timed_train(hk, ur.URAlgorithm(params, device=dev), td)
        for path in variants.values():
            pio("build", "--engine-json", str(path))
        # the LLR-weights variant trains from the snapshot below (cut here
        # for the time limit: its tables are the same)
        for use_llr, path in ((False, variants[False]),):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            hk.llr_masked_scores.launches = hk.tile_topk_desc.launches = 0
            obs0 = train_obs_counts()
            t0 = time.perf_counter()
            pio("train", "--engine-json", str(path))
            t[f"pio_train_s_llr_{use_llr}"] = time.perf_counter() - t0
            launches[use_llr] = (hk.llr_masked_scores.launches, hk.tile_topk_desc.launches)
            journals[use_llr] = check_train_journal(store, engine_variant(use_llr)["id"],
                                                    obs0, launches[use_llr])
    t["peak_device_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    for what, got in (("URAlgorithm.train", train_launches), *(
            (f"pio train (useLlrWeights {k})", v) for k, v in launches.items())):
        check(got == (tiles, tiles),
              f"K2/K3 launches {got} in {what} at {n_items} items, expected {tiles} each")
    check(merges[0] == 0, f"merge_desc ran {merges[0]} times on the card")
    rebuilt = unfused_indicators(cco, hk, td, dev, top_k, tile)
    t0 = time.perf_counter()
    instance, (model,) = load_latest_models(engine_variant(False)["id"], device=dev)
    t["load_s"] = time.perf_counter() - t0
    check(model.device == dev, "load_latest_models: the model is off the card")
    check_tables(model, rebuilt, n_items, top_k, "useLlrWeights False")
    t["blob_mb"] = len(store.models.get(instance.id)) / 1e6
    t0 = time.perf_counter()
    save_models(store, instance.id, [model])   # the same bytes again
    t["save_s"] = time.perf_counter() - t0
    print(f"  users={n_users} items={n_items} events={n_p + n_v} tiles={tiles} "
          f"URAlgorithm.train wall_s={t['train_wall_s']:.3f} launches K2={train_launches[0]} "
          f"K3={train_launches[1]}; pio train wall_s LLR weights off "
          f"{t['pio_train_s_llr_False']:.3f} (read, train, save), launches {launches}, peak_device_gb="
          f"{t['peak_device_gb']:.2f}, merge_desc on the card={merges[0]}; model blob "
          f"{t['blob_mb']:.1f} MB, save_s={t['save_s']:.3f} load_s={t['load_s']:.3f}")
    return model, td, arrays, cols, env, variants, {
        **t, "events": n_p + n_v, "set_events": n_items, "segments": len(segs),
        "segment_bytes": seg_bytes, "launches": launches[False], "journals": journals}


def training_read(engine, ep, what, staged_want):
    """One ``URDataSource.read_training`` in this process, timed, with the
    staged-event counts it moved (which must be ``staged_want``), no native
    scan, and native header parses only where the snapshot file is read."""
    from predictionio_tpu_torch.native import core as ncore
    from predictionio_tpu_torch.native import scanner
    from predictionio_tpu_torch.storage import snapshot as snap

    served, parses, before = scanner.scans_served, ncore.calls["scan"], snap.staged_counts()
    t0 = time.perf_counter()
    td = engine.make_components(ep)[0].read_training()
    secs = time.perf_counter() - t0
    moved = {k: v - before[k] for k, v in snap.staged_counts().items()}
    check(moved == staged_want, f"{what}: staged events {moved}, expected {staged_want}")
    check(scanner.scans_served == served, f"{what}: the native scan ran")
    if staged_want["snapshot"]:
        check(ncore.calls["scan"] == parses + 1,
              f"{what}: {ncore.calls['scan'] - parses} native header parses, not 1")
    return td, secs


def snapshot_path(ur, cco, hk, dev, workdir, arrays, props, native_train_s):
    """Phase 11b's snapshot steps on the store the native-scan trains read:
    ``pio snapshot`` (and ``--status``) → read_training served by the
    snapshot → ``pio import`` of a tail → the same read as a delta in this
    process, then cold as snapshot plus tail → SNAP_DELETES view events
    tombstoned → the read from the snapshot without them → ``pio train`` of
    both variants from the snapshot plus tail (a cold read each, K2/K3
    launches counted) → the model store.  Every read equals
    ``ur_training_data_from_arrays`` on the events it should hold."""
    from predictionio_tpu_torch.storage import get_storage
    from predictionio_tpu_torch.storage import snapshot as snap
    from predictionio_tpu_torch.store.columnar import read_batch
    from predictionio_tpu_torch.store.event_store import _STAGED
    from predictionio_tpu_torch.workflow.core_workflow import load_latest_models
    from predictionio_tpu_torch.workflow.create_workflow import engine_from_variant

    n_users, n_items, n_p, n_v, top_k, tile = DEPLOYED_UR
    n_events = n_p + n_v + n_items
    store = get_storage()
    app = store.apps.get_by_name("smoke")
    chan = store.l_events._chan_dir(app.id, None)
    _, engine, ep = engine_from_variant(engine_variant(False))
    t = {}

    # 1. pio snapshot, then its status
    t0 = time.perf_counter()
    pio("snapshot", "smoke")
    t["snapshot_build_wall_s"] = time.perf_counter() - t0
    pio("snapshot", "smoke", "--status")
    status = store.l_events.snapshot_status(app.id)
    check(status["events"] == n_events and status["tailEvents"] == 0
          and status["coverage"] == 1.0, f"snapshot status {status}")
    t["snapshot_build_s"] = status["buildSeconds"]
    t["snapshot_bytes"] = (chan / snap.SNAP_DIR / status["snapshot"]).stat().st_size
    print(f"  pio snapshot: {status['events']} events of {status['segmentsCovered']} segments "
          f"in {t['snapshot_build_s']:.3f} s (the command {t['snapshot_build_wall_s']:.3f} s), "
          f"{t['snapshot_bytes']} bytes; --status: coverage {status['coverage']}, "
          f"{status['tailEvents']} tail events")

    # 2. read_training served by the snapshot, cold
    _STAGED.invalidate()
    td, t["read_training_snapshot_s"] = training_read(
        engine, ep, "snapshot read", {"snapshot": n_events, "tail": 0, "delta": 0})
    blocks = log_blocks(arrays)
    same_training_data(td, expected_training_data(ur, arrays, props, blocks=blocks))
    t0 = time.perf_counter()
    store.l_events.snapshot_scan(app.id)
    t["snapshot_scan_s"] = time.perf_counter() - t0
    print(f"  read_training from the snapshot {t['read_training_snapshot_s']:.3f} s (the "
          f"native-scan read {native_train_s['read_training_s']:.3f} s), the snapshot read "
          f"alone (mapped columns, native header parse) {t['snapshot_scan_s']:.3f} s; equal "
          "to ur_training_data_from_arrays")

    # 3. a tail through pio import: a delta in this process, then cold
    rng = np.random.default_rng(SEED + 7)
    t_end = T0 + n_p + n_v
    tail = []
    for name, n in zip(("purchase", "view"), SNAP_TAIL):
        tail.append((name, rng.integers(0, n_users, n).astype(np.int32),
                     (rng.zipf(1.3, n) % n_items).astype(np.int32),
                     t_end + np.arange(n, dtype=np.float64)))
        t_end += n
    n_tail = sum(SNAP_TAIL)
    with open(workdir / "tail.jsonl", "w") as f:
        write_interactions(f, tail)
    pio("import", "--app-name", "smoke", "--input", str(workdir / "tail.jsonl"))
    blocks += tail
    want = expected_training_data(ur, arrays, props, blocks=blocks)
    td, t["read_training_delta_s"] = training_read(
        engine, ep, "delta read", {"snapshot": 0, "tail": 0, "delta": n_tail})
    same_training_data(td, want)
    _STAGED.invalidate()
    td, t["read_training_snapshot_tail_s"] = training_read(
        engine, ep, "snapshot and tail read", {"snapshot": n_events, "tail": n_tail, "delta": 0})
    same_training_data(td, want)
    print(f"  pio import of a {n_tail}-event tail; read_training as a delta in this process "
          f"{t['read_training_delta_s']:.3f} s ({n_tail} events staged), cold from the "
          f"snapshot and its tail {t['read_training_snapshot_tail_s']:.3f} s; both equal to "
          "the arrays path on the events and the tail")

    # 4. tombstones: view events whose user and item appeared earlier in the
    # log (so no dictionary's first-appearance order changes)
    log_u = np.concatenate([arrays[0], arrays[2]]).astype(np.int64)
    log_i = np.concatenate([arrays[1], arrays[3]]).astype(np.int64)
    pos = np.arange(len(log_u))
    first_u = np.full(n_users, len(log_u))
    first_i = np.full(n_items, len(log_i))
    np.minimum.at(first_u, log_u, pos)
    np.minimum.at(first_i, log_i, pos)
    cand = pos[n_p + n_items:]
    cand = cand[(first_u[log_u[cand]] < cand) & (first_i[log_i[cand]] < cand)]
    gone = np.sort(rng.choice(cand, SNAP_DELETES, replace=False))
    m = snap.load_manifest(chan)
    batch, ids, _ = read_batch(chan / snap.SNAP_DIR / m["snapshot"])
    rows = n_items + gone     # snapshot rows: the $set events, then the log
    check(all(batch.entity_dict.str(int(batch.entity_ids[r])) == f"u{log_u[p]}"
              and batch.target_dict.str(int(batch.target_ids[r])) == f"i{log_i[p]}"
              for r, p in zip(rows.tolist(), gone.tolist())), "tombstone rows do not match")
    victims = [bytes(ids.blob[ids.offs[r]:ids.offs[r + 1]]).decode() for r in rows.tolist()]
    del batch, ids
    t0 = time.perf_counter()
    for eid in victims:
        check(store.l_events.delete(eid, app.id), f"delete {eid}")
    t["delete_s"] = time.perf_counter() - t0
    keep = np.ones(n_v, bool)
    keep[gone - n_p] = False
    _, vu, vi = blocks[1][:3]
    blocks[1] = ("view", vu[keep], vi[keep], blocks[1][3][keep])
    want = expected_training_data(ur, arrays, props, blocks=blocks)
    n_snap = n_events - SNAP_DELETES
    td, t["read_training_tombstoned_s"] = training_read(
        engine, ep, "tombstoned read", {"snapshot": n_snap, "tail": n_tail, "delta": 0})
    same_training_data(td, want)
    check(len(td.interactions["view"][0]) == n_v + SNAP_TAIL[1] - SNAP_DELETES,
          "the tombstoned events were read")
    print(f"  {SNAP_DELETES} view events tombstoned through l_events.delete in "
          f"{t['delete_s']:.3f} s; read_training from the snapshot (no row path) "
          f"{t['read_training_tombstoned_s']:.3f} s leaves them out and equals the arrays path "
          "on what remains")

    # 5. pio train of both variants from the snapshot and its tail
    params = ep.algorithm_params_list[0][1]
    tiles = 2 * -(-n_items // tile)
    launches = {}
    with count_card_merges() as merges:
        for use_llr in (False, True):
            path = workdir / f"engine-{use_llr}.json"
            _STAGED.invalidate()    # a pio train process reads cold
            before = snap.staged_counts()
            hk.llr_masked_scores.launches = hk.tile_topk_desc.launches = 0
            t0 = time.perf_counter()
            pio("train", "--engine-json", str(path))
            t[f"pio_train_snapshot_s_llr_{use_llr}"] = time.perf_counter() - t0
            launches[use_llr] = (hk.llr_masked_scores.launches, hk.tile_topk_desc.launches)
            moved = {k: v - before[k] for k, v in snap.staged_counts().items()}
            check(moved == {"snapshot": n_snap, "tail": n_tail, "delta": 0},
                  f"pio train (useLlrWeights {use_llr}) staged {moved}")
    for use_llr, got in launches.items():
        check(got == (tiles, tiles), f"K2/K3 launches {got} in pio train from the snapshot "
              f"(useLlrWeights {use_llr}), expected {tiles} each")
    check(merges[0] == 0, f"merge_desc ran {merges[0]} times on the card")
    check(params.min_llr == 0.0, "the unfused rebuild assumes LLR threshold 0")
    rebuilt = unfused_indicators(cco, hk, td, dev, top_k, tile)
    for use_llr in (False, True):
        _, (model,) = load_latest_models(engine_variant(use_llr)["id"], device=dev)
        check_tables(model, rebuilt, n_items, top_k, f"from the snapshot, useLlrWeights {use_llr}")
    print(f"  pio train from the snapshot and its tail: LLR weights off "
          f"{t['pio_train_snapshot_s_llr_False']:.3f} s, on "
          f"{t['pio_train_snapshot_s_llr_True']:.3f} s (native scan, same run, LLR "
          f"weights off: {native_train_s['pio_train_s_llr_False']:.3f} s), launches {launches}, "
          f"merge_desc on the card={merges[0]}")
    return model, td, {**t, "tail_events": n_tail, "tombstoned": SNAP_DELETES,
                       "launches": launches[False]}


def ur_bodies():
    """The listed query of every kind phase 12 checks, and the users they
    ask for."""
    hist = ["u7", "u1234", "u19999"]
    return hist, [
        {"user": hist[0], "num": 10}, {"user": hist[1], "num": 20},
        {"user": hist[2], "num": 10}, {"user": "no-such-user", "num": 10},
        {"item": "i42", "num": 10}, {"itemSet": ["i3", "i17", "i512"], "num": 10},
        {"user": hist[0], "num": 10, "blacklistItems": ["i0", "i1", "i2"]},
        {"user": hist[1], "num": 1}, {"user": hist[2], "num": 100}]


def ur_queries(rng, n, users):
    """Timed query bodies drawn from the deployed users (all with history
    in the store), items and item sets; every num, a blacklist every fifth."""
    n_items = DEPLOYED_UR[1]
    out = []
    for j in range(n):
        if j % 4 < 2:
            body = {"user": users[int(rng.integers(len(users)))]}
        elif j % 4 == 2:
            body = {"item": f"i{int(rng.integers(n_items))}"}
        else:
            body = {"itemSet": [f"i{int(i)}" for i in rng.integers(n_items, size=3)]}
        body["num"] = int(rng.choice([1, 4, 10, 20, 100]))
        if j % 5 == 4:
            body["blacklistItems"] = [f"i{int(i)}" for i in rng.integers(n_items, size=5)]
        out.append(body)
    return out


def rule_queries(rng, n, users):
    """Rule query bodies over ``users``: hard filters on one and on
    several categories, boosts (bias 0.5 and 2.0), a filter on the
    multi-valued tags, an unknown field name and an unknown value (which
    match nothing), dateRange with after only, before only and both, and
    currentDate at QNOW (where 1% of items' bounds lie) and around it."""
    year = 365 * 86_400
    out = []
    for j in range(n):
        body = {"user": users[j % len(users)], "num": int(rng.choice([4, 10, 20]))}
        cats = [f"c{int(c)}" for c in rng.integers(0, 8, 3)]
        kind = j % 10
        if kind == 0:
            body["fields"] = [{"name": "category", "values": cats[:1], "bias": -1}]
        elif kind == 1:
            body["fields"] = [{"name": "category", "values": cats, "bias": -1}]
        elif kind == 2:
            body["fields"] = [{"name": "category", "values": cats[:1], "bias": 0.5},
                              {"name": "tags", "values": [f"t{int(rng.integers(N_TAGS))}"],
                               "bias": 2.0}]
        elif kind == 3:
            body["fields"] = [{"name": "tags", "bias": -1, "values": [
                f"t{int(t)}" for t in rng.integers(0, N_TAGS, 12)]}]
        elif kind == 4:
            body["fields"] = [{"name": "no-such-field", "values": cats[:1], "bias": -1}]
        elif kind == 5:
            body["fields"] = [{"name": "category", "values": ["no-such-value"], "bias": -1}]
        elif kind == 6:
            body["dateRange"] = {"name": "releaseDate",
                                 "after": iso(T2015 + float(rng.integers(0, 11 * year)))}
        elif kind == 7:
            body["dateRange"] = {"name": "releaseDate",
                                 "before": iso(T2015 + float(rng.integers(1, 11 * year)))}
        elif kind == 8:
            a = T2015 + float(rng.integers(0, 8 * year))
            body["dateRange"] = {"name": "releaseDate", "after": iso(a),
                                 "before": iso(a + float(rng.integers(year, 3 * year)))}
            body["fields"] = [{"name": "category", "values": cats, "bias": 2.0}]
        else:
            now = QNOW if j % 20 == 9 else QNOW + float(rng.integers(-60, 60)) * 86_400
            body["currentDate"] = iso(now)
        out.append(body)
    return out


def check_rule_oracle(body, got, cols) -> int:
    """Every returned item passes every hard filter and date rule of its
    query, read straight from the item property columns; returns the
    items checked."""
    cat, tags, dates = cols
    for d in got["itemScores"]:
        j = int(d["item"][1:])
        for f in body.get("fields", []):
            if f["bias"] >= 0:
                continue
            have = ({f"c{cat[j]}"} if f["name"] == "category" else
                    {f"t{t}" for t in tags[j] if t >= 0} if f["name"] == "tags" else set())
            check(bool(have & set(f["values"])), f"{body}: item {j} fails {f}")
        dr = body.get("dateRange")
        if dr:
            ts = dates[dr["name"]][j]
            check(not np.isnan(ts) and ts >= epoch(dr.get("after") or iso(0))
                  and ("before" not in dr or ts <= epoch(dr["before"])),
                  f"{body}: item {j} outside the date range")
        if "currentDate" in body:
            now = epoch(body["currentDate"])
            check(dates["availableDate"][j] <= now <= dates["expireDate"][j],
                  f"{body}: item {j} not available at {body['currentDate']}")
    return len(got["itemScores"])


def mask_build_ms(ur, model, variant, body, reps=5):
    """The composed rule mask's build on the card for one query: the first
    build on a freshly loaded model (property indexes, value masks and
    date offsets built), then the median of ``reps`` repeats (their LRUs
    warm)."""
    algo = ur.URAlgorithm(ur.URAlgorithmParams.from_json(variant["algorithms"][0]["params"]))
    key = algo._mask_rule_key(ur.URQuery.from_json(body))
    out = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        algo._mask_from_key(model, key)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out[0], float(np.median(out[1:]))


def check_ur_answer(body, got, want, signal, item_dict):
    """Items equal in order, scores within rtol 1e-5; items may trade places
    only inside a run of scores within that tolerance, and at a run cut by
    num only with items whose CPU signal lies in the run."""
    g = [(d["item"], d["score"]) for d in got["itemScores"]]
    w = [(d["item"], d["score"]) for d in want["itemScores"]]
    check(len(g) == len(w), f"{body}: {len(g)} items, want {len(w)}")
    close = lambda a, b: abs(a - b) <= RTOL * abs(b) + 1e-7  # noqa: E731
    for (_, gs), (_, ws) in zip(g, w):
        check(close(gs, ws), f"{body}: score {gs} vs {ws}")
    swaps, j = 0, 0
    while j < len(w):
        e = j + 1
        while e < len(w) and close(w[e][1], w[e - 1][1]):
            e += 1
        gi, wi = {x for x, _ in g[j:e]}, {x for x, _ in w[j:e]}
        swaps += sum(a[0] != b[0] for a, b in zip(g[j:e], w[j:e]))
        if e < len(w) or signal is None:
            check(gi == wi, f"{body}: items {sorted(gi)} where {sorted(wi)} belong")
        else:
            for x in gi - wi:
                check(close(float(signal[item_dict.id(x)]), w[j][1]),
                      f"{body}: item {x} in a run it does not belong to")
        j = e
    return swaps


def timed_posts(url, bodies):
    """The answers and the host-clock ms of each POST, one after another."""
    answers, lat_ms = [], []
    for body in bodies:
        t0 = time.perf_counter()
        answers.append(post(url, body))
        lat_ms.append((time.perf_counter() - t0) * 1e3)
    return answers, lat_ms


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def get_json(url, timeout=60):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read())


@contextlib.contextmanager
def pio_deploy(engine_json, env):
    """``pio deploy`` of ``engine_json`` as a subprocess on the card (the
    store's ``PIO_STORAGE_*`` environment, its output in a file beside the
    engine.json); yields (base url, seconds from the start to its first
    answer of ``GET /``).  On leaving, ``pio undeploy`` must stop it and it
    must exit 0; it is killed in any case."""
    port = free_port()
    root = Path(__file__).resolve().parent
    log_path = Path(engine_json).with_suffix(".deploy.log")
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "predictionio_tpu_torch.cli.main", "deploy",
             "--engine-json", str(engine_json), "--ip", "127.0.0.1", "--port", str(port)],
            cwd=root, env={**os.environ, **env, "PYTHONPATH": str(root)},
            stdout=log, stderr=subprocess.STDOUT)
    base = f"http://127.0.0.1:{port}"
    try:
        while True:
            check(proc.poll() is None, f"pio deploy exited {proc.returncode}: "
                  f"{log_path.read_text()[-4000:]}")
            check(time.perf_counter() - t0 < DEPLOY_TIMEOUT_S, "pio deploy did not answer")
            try:
                get_json(base + "/", timeout=5)
                break
            except (urllib.error.URLError, ConnectionError):
                time.sleep(0.2)
        up_s = time.perf_counter() - t0
        yield base, up_s
        pio("undeploy", "--port", str(port), "--timeout", "60")
        rc = proc.wait(timeout=DEPLOY_TIMEOUT_S)
        out = log_path.read_text()
        check(rc == 0, f"pio deploy exited {rc} after pio undeploy: {out[-4000:]}")
        print(f"  pio deploy said: {out.strip()}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def serve_ur(ur, model, arrays, cols, dev, env, variants):
    """Phase 12: ``pio deploy`` subprocesses of the two engine variants of
    phase 11b's store (LLR weights off and on, business rules on the $set
    properties), each stopped by ``pio undeploy``.  The listed bodies go
    first and are each checked against the CPU predict; then UR_TIMED
    plain queries, one rule query over every property (the first build of
    the model's rule state) and RULE_TIMED rule queries drawn from UR_POOL
    users with history (plus items and item sets) are timed, every tenth
    of each checked the same way, and every rule answer against the numpy
    oracle of check_rule_oracle; a malformed currentDate answers 400."""
    from predictionio_tpu_torch.storage import get_storage

    hist_users, bodies = ur_bodies()
    rng = np.random.default_rng(SEED + 1)
    pool = hist_users + [u for u in (f"u{int(j)}" for j in rng.choice(
        DEPLOYED_UR[0], UR_POOL, replace=False)) if u not in hist_users][: UR_POOL - 3]
    timed = ur_queries(rng, UR_TIMED, pool)
    rules = rule_queries(rng, RULE_TIMED, pool)
    cpu_model = ur.ur_model_from_state(model.__getstate__(), device="cpu")
    store = get_storage()   # the CPU predict reads the histories from the same store
    t0 = time.perf_counter()
    store.l_events.warm_entity_index(store.apps.get_by_name("smoke").id)
    index_s = time.perf_counter() - t0
    probe = {"user": pool[0], "currentDate": iso(QNOW),
             "fields": [{"name": "category", "values": ["c0", "c3"], "bias": -1},
                        {"name": "tags", "values": ["t7"], "bias": 2.0}],
             "dateRange": {"name": "releaseDate", "after": iso(T2015 + 3 * 365 * 86_400)}}
    mask_ms = mask_build_ms(ur, model, engine_variant(False), probe)
    print(f"  rule mask build on the card for {probe}: first {mask_ms[0]:.3f} ms on the "
          f"loaded model, then {mask_ms[1]:.3f} ms (median of 5, its LRUs warm); the "
          f"serving history index of the store built in {index_s:.3f} s in this process")
    out = {"mask_build_ms": {"first": mask_ms[0], "warm": mask_ms[1]},
           "history_index_s": index_s}
    for use_llr, path in variants.items():
        variant = engine_variant(use_llr)
        with pio_deploy(path, env) as (base, up_s):
            info = get_json(base + "/")
            check(info["devices"] == [str(dev)], f"deployed on {info['devices']}, not {dev}")
            url = base + "/queries.json"
            answers, lat_ms = timed_posts(url, bodies)
            first_s = up_s + lat_ms[0] / 1e3
            timed_answers, timed_ms = timed_posts(url, timed)
            # the first rule query builds the model's property indexes and
            # date offsets (each once a model): timed on its own
            (probe_answer,), (probe_ms,) = timed_posts(url, [probe])
            rule_answers, rule_ms = timed_posts(url, rules)
            status = refused(url, {"user": hist_users[0], "currentDate": "01/03/2026"})
            if not use_llr:   # one round under concurrent load, micro-batched
                n_load, conc, distinct = UR_LOAD
                load_bodies = level_bodies(ur_queries(rng, distinct, pool), n_load, SEED + 12)
                m0 = metrics_text(base)
                statuses, load_ms, load_answers, load_wall = run_clients(
                    Path(path).parent, int(base.rsplit(":", 1)[1]), "/queries.json",
                    load_bodies, conc)
                m1 = metrics_text(base)
                check(set(statuses) == {200}, f"UR under load: statuses {set(statuses)}")
                n_b, q_b, reruns = (
                    family_value(m1, name) - family_value(m0, name)
                    for name in ("pio_serve_batch_size_count", "pio_serve_batch_size_sum",
                                 "pio_serve_batch_serial_reruns_total"))
                check(n_b > 0 and q_b == n_load, f"UR under load: {q_b} of {n_load} queries "
                      f"in {n_b} micro-batches")
                check(reruns == 0, f"UR under load: {reruns} serial re-runs")
        check(status == 400, f"a malformed currentDate answered {status}, not 400")
        algo = ur.URAlgorithm(ur.URAlgorithmParams.from_json(
            variant["algorithms"][0]["params"]))
        checked = (list(zip(bodies, answers)) + [(probe, probe_answer)]
                   + list(zip(timed, timed_answers))[::10]
                   + list(zip(rules, rule_answers))[::10])
        if not use_llr:   # every loaded answer too
            checked += list(zip(load_bodies, load_answers))
        swaps = 0
        refs = {}   # the CPU predict and signal of each distinct body
        for body, got in checked:
            ref_key = json.dumps(body, sort_keys=True)
            if ref_key not in refs:
                refs[ref_key] = cpu_reference(ur, algo, cpu_model, body)
            want, sig = refs[ref_key]
            swaps += check_ur_answer(body, got, want, sig, cpu_model.item_dict)
        for body, got in zip(bodies + timed, answers + timed_answers):
            check(len(got["itemScores"]) == min(body["num"], len(cpu_model.item_dict))
                  and all(np.isfinite(d["score"]) for d in got["itemScores"]),
                  f"{body}: short answer or non-finite score")
        oracle_items = sum(check_rule_oracle(b, g, cols) for b, g in
                           zip(rules + [probe], rule_answers + [probe_answer]))
        empty = sum(not g["itemScores"] for g in rule_answers)
        p50, p99 = np.percentile(timed_ms, [50, 99])
        r50, r99 = np.percentile(rule_ms, [50, 99])
        print(f"  use_llr_weights={use_llr}: pio deploy answered GET / {up_s:.3f} s after "
              f"its start, its first query {first_s:.3f} s after; {len(checked)} answers "
              f"equal the CPU predict ({swaps} near-tie swaps); {len(rules)} rule answers, "
              f"{oracle_items} items, all pass the numpy oracle ({empty} empty: nothing "
              f"matches); a malformed currentDate answered 400; latency_ms "
              f"first={lat_ms[0]:.3f}, over {len(timed)} plain queries p50={p50:.3f} "
              f"p99={p99:.3f} max={max(timed_ms):.3f}, first rule query {probe_ms:.3f}, then "
              f"over {len(rules)} rule queries p50={r50:.3f} p99={r99:.3f} "
              f"max={max(rule_ms):.3f} (host clock, one client, a connection per request); "
              "pio undeploy stopped it, exit 0")
        if not use_llr:
            lp50, lp99 = np.percentile(load_ms, [50, 99])
            out["load"] = {"queries": n_load, "clients": conc, "p50_ms": float(lp50),
                           "p99_ms": float(lp99), "qps": n_load / load_wall,
                           "batches": n_b, "batch_mean": q_b / n_b, "serial_reruns": reruns}
            print(f"  UR under load: {n_load} queries from {conc} keep-alive clients p50 "
                  f"{lp50:.3f} ms p99 {lp99:.3f} ms {n_load / load_wall:.1f} q/s, "
                  f"{int(n_b)} micro-batches (mean {q_b / n_b:.2f} queries) through "
                  "serve_batch_predict, every answer equal to the CPU predict")
        out[use_llr] = {"deploy_up_s": up_s, "deploy_to_first_answer_s": first_s,
                        "first_ms": lat_ms[0], "p50_ms": float(p50), "p99_ms": float(p99),
                        "max_ms": max(timed_ms), "n": len(timed), "checked": len(checked),
                        "rule_first_ms": probe_ms,
                        "rule_p50_ms": float(r50), "rule_p99_ms": float(r99),
                        "rule_max_ms": max(rule_ms), "rule_n": len(rules),
                        "rule_items_checked": oracle_items, "rule_empty": empty}
    return out


def cpu_reference(ur, algo, cpu_model, body):
    """The CPU predict of ``body`` on the stored model (the port's plain
    path, reading the histories from this process's store) and its masked
    signal as a host vector (None for a pure backfill query): what every
    answer on the card is held against."""
    q = ur.URQuery.from_json(body)
    want = algo.predict(cpu_model, q).to_json()
    hist = algo._query_hist(cpu_model, q)
    sig = algo._score_history(cpu_model, hist) if hist is not None else None
    if sig is not None:
        sig = sig.numpy() if isinstance(sig, torch.Tensor) else np.asarray(sig)
        key = algo._mask_rule_key(q)
        if key is not None:
            sig = sig * algo._mask_from_key(cpu_model, key, host=True)
    return want, sig


# -- phase 17: the UR's caches, the host tail and checkpointed training -----------

CACHE_TRIPLES, CACHE_QUERIES = 100, 400   # distinct (user, rules, num); zipf-drawn queries
HOST_TAIL_QUERIES = 25    # 17d: plain and rule queries each (cut for the time limit)
RULE_SETS, RULE_SET_QUERIES = 5, 10       # phase 17b
HISTORY_USERS, HISTORY_BUYS = 20, 3       # phase 17c


def post_raw(url, body) -> bytes:
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        check(resp.status == 200, f"HTTP {resp.status} for {body}")
        return resp.read()


def cache_triples(rng, users):
    """CACHE_TRIPLES distinct (user, rules, num) bodies: plain queries and
    the rule kinds of ``rule_queries``, num 4, 10 or 20."""
    rules = rule_queries(rng, CACHE_TRIPLES, users)
    out = []
    for j, body in enumerate(rules):
        if j % 2:
            body = {"user": body["user"], "num": body["num"]}
        out.append(body)
    return out


def outcome_values(counter, outcomes, **labels):
    return {o: counter.value(outcome=o, **labels) for o in outcomes}


def split_ms(bodies, ms):
    """Host-clock ms of each query split by whether its body came before
    (the first occurrence: a miss after a flush) or after (a hit)."""
    seen, hits, misses = set(), [], []
    for body, t in zip(bodies, ms):
        key = json.dumps(body, sort_keys=True)
        (hits if key in seen else misses).append(t)
        seen.add(key)
    return hits, misses


def pct(ms):
    if not ms:
        return {"n": 0}
    p50, p99 = np.percentile(ms, [50, 99])
    return {"n": len(ms), "p50_ms": float(p50), "p99_ms": float(p99)}


def ur_caches_path(ur, cco, hk, ncore, dev, workdir, variants, stored, plain_train_s):
    """Phase 17: ``deploy`` of phase 11b's stored UR (LLR weights off) on a
    thread of this process, so the process-wide caches, the registry and
    the launch counters can be read.  (a) the response cache under 1 and
    32 clients, audited then timed, every answer byte-equal to the cache
    off and held against the CPU predict; (b) the composed rule-mask
    cache, its device masks bit for bit the host ones; (d) the host scorer
    and the candidate-pruned host tail on the card's host against the
    device tail; (e) a checkpointed ``pio train`` with a fault after the
    first event type, resumed on retry; (c) appends through the event
    server in this process and the history cache's invalidation.  The
    knobs switch between rounds: the serving path re-reads them per call."""
    from predictionio_tpu_torch.api.event_server import run_event_server
    from predictionio_tpu_torch.models.universal_recommender import engine as ur_engine
    from predictionio_tpu_torch.serve import history_cache, response_cache
    from predictionio_tpu_torch.storage import get_storage
    from predictionio_tpu_torch.workflow.core_workflow import load_latest_models
    from predictionio_tpu_torch.workflow.create_server import deploy

    t_phase = time.perf_counter()
    knobs = ("PIO_SERVE_CACHE", "PIO_SERVE_CACHE_AUDIT_N", "PIO_HISTORY_CACHE",
             "PIO_UR_SERVE_SCORER", "PIO_UR_SERVE_TAIL", "PIO_UR_SERVE_CANDIDATES",
             "PIO_CHECKPOINT_DIR", "PIO_TRAIN_RETRIES", "PIO_FAULT_INJECT")
    saved = {k: os.environ.get(k) for k in knobs}
    rng = np.random.default_rng(SEED + 17)
    users = [f"u{int(j)}" for j in rng.choice(DEPLOYED_UR[0], CACHE_TRIPLES, replace=False)]
    variant = engine_variant(False)
    algo = ur.URAlgorithm(ur.URAlgorithmParams.from_json(variant["algorithms"][0]["params"]))
    cpu_model = ur.ur_model_from_state(stored.__getstate__(), device="cpu")
    cache = response_cache.get_cache()
    out = {}
    server = deploy(str(variants[False]), host="127.0.0.1", port=0, device=dev)
    try:
        state = server.pio_state
        (model,) = state.models
        check(model.device == dev and cache.armed_for(model),
              "deploy: the UR model is off the card or the response cache is not armed on it")
        check(state.batcher is not None, "deploy on the card: no micro-batcher")
        port = server.server_address[1]
        url = f"http://127.0.0.1:{port}/queries.json"

        # -- (a) the response cache on the device tail
        triples = cache_triples(rng, users)
        draws = (rng.zipf(1.3, CACHE_QUERIES) - 1) % CACHE_TRIPLES
        bodies = [triples[int(j)] for j in draws]
        refs = {}
        for body in triples:
            refs[json.dumps(body, sort_keys=True)] = cpu_reference(ur, algo, cpu_model, body)
        os.environ.pop("PIO_SERVE_CACHE", None)
        rounds = {}
        for audit in ("1", "0"):
            os.environ["PIO_SERVE_CACHE_AUDIT_N"] = audit
            for conc in (1, 32):
                cache.clear()
                cache.on_swap([model])           # re-armed, empty: misses first
                c0 = outcome_values(response_cache._M_CACHE, ("hit", "miss", "bypass"))
                a0 = response_cache._M_AUDIT.value()
                t0 = time.perf_counter()
                if conc == 1:
                    raws, ms = [], []
                    for body in bodies:
                        q0 = time.perf_counter()
                        raws.append(post_raw(url, body))
                        ms.append((time.perf_counter() - q0) * 1e3)
                    answers = [json.loads(r) for r in raws]
                else:
                    statuses, ms, answers, _ = run_clients(workdir, port, "/queries.json",
                                                           bodies, conc)
                    check(set(statuses) == {200}, f"17a: statuses {set(statuses)}")
                wall = time.perf_counter() - t0
                c1 = outcome_values(response_cache._M_CACHE, ("hit", "miss", "bypass"))
                outcomes = {o: c1[o] - c0[o] for o in c1}
                mismatches = response_cache._M_AUDIT.value() - a0
                check(outcomes["hit"] > 0, f"17a: no response-cache hit in {outcomes}")
                check(mismatches == 0, f"17a: {mismatches} audit mismatches")
                swaps = 0
                for body, got in zip(bodies, answers):
                    want, sig = refs[json.dumps(body, sort_keys=True)]
                    swaps += check_ur_answer(body, got, want, sig, cpu_model.item_dict)
                hits, misses = split_ms(bodies, ms)
                rounds[f"audit{audit}_c{conc}"] = {
                    "outcomes": outcomes, "audit_mismatches": mismatches,
                    "hits": pct(hits), "misses": pct(misses), "qps": len(bodies) / wall,
                    "near_tie_swaps": swaps}
                if conc == 1 and audit == "1":
                    first_raw = dict(zip((json.dumps(b, sort_keys=True) for b in bodies), raws))
        os.environ["PIO_SERVE_CACHE"] = "off"
        off = {json.dumps(b, sort_keys=True): post_raw(url, b) for b in triples}
        os.environ.pop("PIO_SERVE_CACHE")
        unequal = [k for k, raw in first_raw.items() if off[k] != raw]
        check(not unequal, f"17a: {len(unequal)} answers differ from PIO_SERVE_CACHE=off, "
              f"e.g. {unequal[:1]}")
        out["response_cache"] = rounds
        for name, r in rounds.items():
            print(f"  17a {name}: {r['outcomes']} (pio_serve_cache_total), audit mismatches "
                  f"{r['audit_mismatches']}; hits {r['hits']}, misses {r['misses']}, "
                  f"{r['qps']:.1f} q/s; every answer held against the CPU predict "
                  f"({r['near_tie_swaps']} near-tie swaps)")
        print(f"  17a: the {len(first_raw)} distinct answers byte-equal to "
              "PIO_SERVE_CACHE=off")
        out["traced"] = traced_unbatched(dev, variants, port, users)
        cache.on_swap([model])   # the second deploy's install armed the cache on its model

        # -- (b) the composed rule-mask cache (response cache off)
        os.environ["PIO_SERVE_CACHE"] = "off"
        sets = [
            [{"name": "category", "values": ["c1", "c4", "c7"], "bias": -1}],
            [{"name": "category", "values": ["c2"], "bias": 0.5},
             {"name": "tags", "values": ["t11"], "bias": 2.0}],
            [{"name": "tags", "bias": -1, "values": [f"t{t}" for t in range(0, 120, 10)]}],
            {"dateRange": {"name": "releaseDate", "after": iso(T2015 + 2 * 365 * 86_400),
                           "before": iso(T2015 + 6 * 365 * 86_400)},
             "fields": [{"name": "category", "values": ["c0", "c3"], "bias": 2.0}]},
            {"currentDate": iso(QNOW)}]
        m0 = outcome_values(ur_engine._M_MASK_CACHE, ("hit", "miss", "evict"))
        first_ms, rest_ms = [], []
        for j, rules in enumerate(sets):
            extra = {"fields": rules} if isinstance(rules, list) else rules
            for r in range(RULE_SET_QUERIES):
                body = {"user": users[(j * RULE_SET_QUERIES + r) % len(users)], "num": 10,
                        **extra}
                q0 = time.perf_counter()
                got = post(url, body)
                (first_ms if r == 0 else rest_ms).append((time.perf_counter() - q0) * 1e3)
                if r < 2:
                    want, sig = cpu_reference(ur, algo, cpu_model, body)
                    check_ur_answer(body, got, want, sig, cpu_model.item_dict)
            key = algo._mask_rule_key(ur.URQuery.from_json(body))
            dmask = model.rule_mask_cache("device").peek(key)
            check(dmask is not None, f"17b: rule set {j} not in the device mask cache")
            hmask = algo._mask_from_key(model, key, host=True)
            check(np.array_equal(dmask.cpu().numpy().view(np.int32), hmask.view(np.int32)),
                  f"17b: rule set {j}: the device mask differs from the host mask")
        m1 = outcome_values(ur_engine._M_MASK_CACHE, ("hit", "miss", "evict"))
        mask_outcomes = {o: m1[o] - m0[o] for o in m1}
        check(mask_outcomes["hit"] >= RULE_SETS * (RULE_SET_QUERIES - 1),
              f"17b: pio_ur_rule_mask_cache_total {mask_outcomes}")
        out["rule_mask_cache"] = {"first_ms": first_ms, "rest": pct(rest_ms),
                                  "outcomes": mask_outcomes}
        print(f"  17b: {RULE_SETS} rule sets x {RULE_SET_QUERIES} users: first query of each "
              f"set {[round(x, 3) for x in first_ms]} ms, the rest {pct(rest_ms)}; "
              f"pio_ur_rule_mask_cache_total {mask_outcomes}; each set's device mask equals "
              "_mask_from_key(host=True) bit for bit")

        # -- (d) the host scorer and the pruned host tail on the card's host
        pool = users
        plain = ur_queries(rng, HOST_TAIL_QUERIES, pool) + rule_queries(rng, HOST_TAIL_QUERIES,
                                                                         pool)
        t0 = time.perf_counter()
        model.ensure_host_serving_state()
        host_state_s = time.perf_counter() - t0
        inv = {n: {"build_s": ur_engine._M_INV_BUILD.value(event=n),
                   "bytes": ur_engine._M_INV_BYTES.value(event=n)}
               for n in model.indicator_idx}
        tails = {}
        for tail in ("device", "host"):
            os.environ["PIO_UR_SERVE_SCORER"] = os.environ["PIO_UR_SERVE_TAIL"] = tail
            n0, f0 = ncore.calls["serve"], sum(v for _, v in ncore.fallbacks.items())
            k0 = outcome_values(ur_engine._M_CAND, (
                "pruned", "fallback_no_candidates", "fallback_backfill_reorder",
                "fallback_backfill_scan"))
            ur_engine._M_CAND_FRAC.clear_series()
            answers, ms = timed_posts(url, plain)
            k1 = outcome_values(ur_engine._M_CAND, tuple(k0))
            frac = list(ur_engine._M_CAND_FRAC._snapshot_series().values())
            tails[tail] = {"answers": answers, "ms": ms,
                           "candidate_frac_mean": (frac[0]["sum"] / frac[0]["count"]
                                                   if frac and frac[0]["count"] else None),
                           "native_serve_calls": ncore.calls["serve"] - n0,
                           "native_fallbacks": sum(v for _, v in ncore.fallbacks.items()) - f0,
                           "candidates": {o: k1[o] - k0[o] for o in k1}}
        for k in ("PIO_UR_SERVE_SCORER", "PIO_UR_SERVE_TAIL"):
            os.environ.pop(k)
        bit_equal, swaps = 0, 0
        for body, got, want in zip(plain, tails["host"]["answers"], tails["device"]["answers"]):
            swaps += check_ur_answer(body, got, want, None, cpu_model.item_dict)
            bit_equal += got == want
        h = tails["host"]
        check(h["native_serve_calls"] > 0 and h["native_fallbacks"] == 0,
              f"17d: native serve calls {h['native_serve_calls']}, fallbacks "
              f"{h['native_fallbacks']}")
        check(h["candidates"]["pruned"] > 0, f"17d: candidates {h['candidates']}")
        out["host_tail"] = {
            "queries": len(plain), "bit_equal": bit_equal, "near_tie_swaps": swaps,
            "host_serving_state_s": host_state_s, "inverted": inv,
            "candidates": h["candidates"], "native_serve_calls": h["native_serve_calls"],
            "candidate_frac_mean": h["candidate_frac_mean"],
            "host": pct(h["ms"]), "device": pct(tails["device"]["ms"])}
        print(f"  17d: {len(plain)} plain and rule queries, host scorer and pruned host tail "
              f"against the device tail: items equal, {bit_equal} of {len(plain)} answers "
              f"bit-equal ({swaps} near-tie swaps); native serve calls "
              f"{h['native_serve_calls']}, fallbacks 0; pio_ur_serve_candidate_total "
              f"{h['candidates']}, a pruned query's candidates "
              f"{h['candidate_frac_mean']} of the catalog on average "
              f"(pio_ur_serve_candidate_frac); host_inverted {inv} (ensure_host_serving_state "
              f"{host_state_s:.3f} s); host {out['host_tail']['host']} vs device "
              f"{out['host_tail']['device']} (host clock, one client)")
        os.environ.pop("PIO_SERVE_CACHE", None)

        # -- (e) checkpointed UR training, a fault after the first type
        ck_variant = dict(variant, id=ENGINE_ID + "-ck")
        ck_variant["algorithms"] = [{"name": "ur", "params": {
            **variant["algorithms"][0]["params"], "checkpoint": True}}]
        ck_path = workdir / "engine-ck.json"
        ck_path.write_text(json.dumps(ck_variant))
        ck_dir = workdir / "checkpoints"
        os.environ.update({"PIO_CHECKPOINT_DIR": str(ck_dir), "PIO_TRAIN_RETRIES": "1",
                           "PIO_FAULT_INJECT": "ur.indicators:2"})
        calls, real = [], cco.cco_train_indicators

        def counted(p_user, p_item, others, *a, **kw):
            k2, k3 = hk.llr_masked_scores.launches, hk.tile_topk_desc.launches
            try:
                return real(p_user, p_item, others, *a, **kw)
            finally:
                calls.append(([o[0] for o in others], hk.llr_masked_scores.launches - k2,
                              hk.tile_topk_desc.launches - k3))

        cco.cco_train_indicators = counted
        try:
            pio("build", "--engine-json", str(ck_path))
            t0 = time.perf_counter()
            pio("train", "--engine-json", str(ck_path))
            ck_s = time.perf_counter() - t0
        finally:
            cco.cco_train_indicators = real
        fired = "PIO_FAULT_INJECT" not in os.environ
        tiles = -(-DEPLOYED_UR[1] // DEPLOYED_UR[5])
        check(fired, "17e: the injected fault did not fire")
        check([c[0] for c in calls] == [["purchase"], ["view"]]
              and all(c[1:] == (tiles, tiles) for c in calls),
              f"17e: training calls {calls}: the retry did not resume past the first type")
        left = [p for p in (ck_dir / "ur").iterdir()] if (ck_dir / "ur").exists() else []
        check(not left, f"17e: snapshots left behind: {left}")
        _, (ck_model,) = load_latest_models(ck_variant["id"], device="cpu")
        for name in stored.indicator_idx:
            check(np.array_equal(ck_model.indicator_idx[name], stored.indicator_idx[name])
                  and np.array_equal(ck_model.indicator_llr[name].view(np.int32),
                                     stored.indicator_llr[name].view(np.int32)),
                  f"17e: the resumed {name} table differs from phase 11b's train")
        out["checkpointed_train"] = {"wall_s": ck_s, "plain_wall_s": plain_train_s,
                                     "calls": calls}
        print(f"  17e: pio train checkpointed, PIO_FAULT_INJECT=ur.indicators:2 fired, the "
              f"retry trained {calls[-1][0]} only (K2/K3 {calls[-1][1:]}; the faulted attempt "
              f"{calls[0][0]} {calls[0][1:]}), snapshots removed, tables bit-identical to "
              f"phase 11b's; wall {ck_s:.3f} s against the plain pio train "
              f"{plain_train_s:.3f} s")
        for k in ("PIO_CHECKPOINT_DIR", "PIO_TRAIN_RETRIES", "PIO_FAULT_INJECT"):
            os.environ.pop(k, None)

        # -- (c) appends through the event server and the history cache
        store = get_storage()
        app_id = store.apps.get_by_name("smoke").id
        key = store.access_keys.get_by_app_id(app_id)[0].key
        es = run_event_server(host="127.0.0.1", port=0, background=True)
        buyers = users[:HISTORY_USERS]
        plain_bodies = [{"user": u, "num": 10} for u in buyers]
        for body in plain_bodies:
            post(url, body)                         # cached: histories and answers
        s0 = history_cache._M_LOOKUP.value(outcome="stale")
        try:
            es_url = (f"http://127.0.0.1:{es.server_address[1]}/batch/events.json"
                      f"?accessKey={key}")
            batch = [{"event": "purchase", "entityType": "user", "entityId": u,
                      "targetEntityType": "item",
                      "targetEntityId": f"i{int(rng.integers(DEPLOYED_UR[1]))}"}
                     for u in buyers for _ in range(HISTORY_BUYS)]
            for j in range(0, len(batch), 50):
                res = post(es_url, batch[j:j + 50])
                check(all(r["status"] == 201 for r in res), f"17c: ingest {res}")
        finally:
            es.shutdown()
            es.server_close()
        after = [post(url, b) for b in plain_bodies]
        stale = history_cache._M_LOOKUP.value(outcome="stale") - s0
        check(stale >= HISTORY_USERS, f"17c: pio_history_cache_total stale +{stale}")
        for body, got in zip(plain_bodies, after):
            want, sig = cpu_reference(ur, algo, cpu_model, body)
            check_ur_answer(body, got, want, sig, cpu_model.item_dict)
        os.environ["PIO_HISTORY_CACHE"] = "off"
        uncached = [post(url, b) for b in plain_bodies]
        os.environ.pop("PIO_HISTORY_CACHE")
        check(uncached == after, "17c: answers differ with PIO_HISTORY_CACHE=off")
        out["history_cache"] = {"users": HISTORY_USERS, "events": len(batch),
                                "stale": stale}
        print(f"  17c: {len(batch)} purchase events of {HISTORY_USERS} users through the "
              f"event server; pio_history_cache_total stale +{stale}; their answers equal the "
              "CPU predict on the new histories and PIO_HISTORY_CACHE=off")
    finally:
        server.shutdown()
        server.server_close()
        cache.disarm()
        restore_env(saved)
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"  phase 17 wall {out['wall_s']:.3f} s")
    return out


# -- phase 19: the streaming fold and the follow-trainer ----------------------------

FOLLOW_ROUNDS = 2                # rounds of bench_freshness's protocol (bench.py:4080-4097; cut for the time limit)
                                 # in phases 19-21; the reference runs 8 (cut for the time limit)
FOLLOW_COBUYERS = 6              # co-buyers of a round's brand-new item
FOLLOW_INTERVAL_S = 0.2          # deploy(follow=): the follower's tick interval
FOLLOW_CAP_S = 30.0              # a round not reflected within this fails the phase
FOLLOW_GATE_S = 10.0             # the reference's append -> reflected p99 gate
FOLLOW_PROBES = 200              # probe queries held byte-equal to a card retrain
FOLLOW_SMALL = (500, 300, 5_000)  # 19b's app: users, items, purchases


def follow_counts(hk):
    """K2's and K3's launch counts, read under the wrappers' lock."""
    with hk._count_lock:
        return hk.llr_masked_scores.launches, hk.tile_topk_desc.launches


def follower_drained(follower, covered) -> bool:
    st = follower.status()
    return st["lastOutcome"] == "idle" and (st["coveredEvents"] or 0) >= covered


def wait_until(cond, timeout, what):
    end = time.perf_counter() + timeout
    while time.perf_counter() < end:
        if cond():
            return
        time.sleep(0.02)
    raise SmokeFailure(f"timed out after {timeout} s waiting for {what}")


def model_device_bytes(model) -> int:
    """Device bytes one URModel generation stages for serving."""
    total = 0
    for attr in model.__dict__.get("_staged", ()):
        v = model.__dict__.get(attr)
        tensors = (list(v.values()) if isinstance(v, dict) else [v])
        for t in tensors:
            for x in (t if isinstance(t, tuple) else (t,)):
                if isinstance(x, torch.Tensor) and x.device.type == "cuda":
                    total += x.numel() * x.element_size()
    return total


def k2_against_cell_scoring(fold_mod, cco, hk, state, dev, n_rows=512):
    """On a row slice of each event type's resident counts: K2's output
    gathered at the nonzero cells against ``_score_llr_cells`` on the card,
    the certificate's scoring, bit for bit.  → (cells, differing cells)."""
    cells = differ = 0
    n_total = float(len(state.user_dict))
    for name, st in state.types.items():
        if st.sc is None or not st.sc.nnz:
            continue
        _, t_llr = state._tuning(name)
        rows = np.unique(st.sc.keys[:: max(1, st.sc.nnz // n_rows)] >> np.int64(32))[:n_rows]
        local, cols, counts = st.sc.row_cells(rows)
        c = torch.zeros((len(rows), st.n_items), dtype=torch.int32, device=dev)
        li = torch.as_tensor(local, device=dev)
        ci = torch.as_tensor(cols.astype(np.int64), device=dev)
        c[li, ci] = torch.as_tensor(counts, device=dev)
        k2 = hk.llr_masked_scores(c, torch.as_tensor(state.row_counts[rows].astype(np.int32),
                                                     device=dev),
                                  torch.as_tensor(st.col_counts.astype(np.int32), device=dev),
                                  n_total, t_llr)[li, ci].cpu().numpy()
        cell = cco._score_llr_cells(counts.astype(np.float32),
                                    state.row_counts[rows][local].astype(np.float32),
                                    st.col_counts[cols].astype(np.float32), n_total, t_llr,
                                    device=dev)
        cells += len(cell)
        differ += int((k2.view(np.int32) != cell.view(np.int32)).sum())
        del c
    return cells, differ


def follow_small_cli(dev, workdir):
    """19b: ``pio train --follow`` as a subprocess on a small localfs app
    (FOLLOW_SMALL: a check of the CLI wiring, not of scale): the bootstrap
    publishes a COMPLETED instance, one delta (a brand-new item) another,
    equal to a card train of the same events; SIGINT ends it with exit 0."""
    from predictionio_tpu_torch.events.event import Event
    from predictionio_tpu_torch.storage import get_storage
    from predictionio_tpu_torch.store.event_store import invalidate_staging_cache
    from predictionio_tpu_torch.workflow.core_workflow import load_latest_models
    from predictionio_tpu_torch.workflow.create_workflow import engine_from_variant

    n_users, n_items, n_buy = FOLLOW_SMALL
    rng = np.random.default_rng(SEED + 19)
    users = rng.integers(0, n_users, n_buy)
    items = rng.zipf(1.3, n_buy) % n_items
    jsonl = workdir / "follow19b.jsonl"
    with open(jsonl, "w") as f:
        write_interactions(f, [("purchase", users, items,
                                T0 + np.arange(n_buy, dtype=np.float64))])
    pio("app", "new", "follow19b")
    pio("import", "--app-name", "follow19b", "--input", str(jsonl))
    variant = {"id": "smoke-follow19b", "engineFactory": "universal_recommender",
               "datasource": {"params": {"appName": "follow19b", "eventNames": ["purchase"]}},
               "algorithms": [{"name": "ur", "params": {"appName": "follow19b",
                                                        "maxCorrelatorsPerItem": 20}}]}
    path = workdir / "engine-follow19b.json"
    path.write_text(json.dumps(variant))
    store = get_storage()
    app_id = store.apps.get_by_name("follow19b").id

    def completed():
        return sorted((i for i in store.engine_instances.get_all()
                       if i.engine_id == variant["id"] and i.status == "COMPLETED"),
                      key=lambda i: i.start_time)

    env = {**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parent),
           "PIO_TORCH_DEVICE": dev.type}
    log_path = workdir / "follow19b.log"
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "predictionio_tpu_torch.cli.main", "train", "--follow",
             "--follow-interval", "0.2", "--engine-json", str(path)],
            env=env, cwd=str(workdir), stdout=log, stderr=subprocess.STDOUT)
        try:
            try:
                wait_until(lambda: len(completed()) >= 1 or proc.poll() is not None, 300,
                           "19b's bootstrap instance")
                check(proc.poll() is None, f"19b: pio train --follow exited {proc.returncode}")
                boot_s = time.perf_counter() - t0
                fresh = [f"cob19b_{j}" for j in range(FOLLOW_COBUYERS)]
                store.l_events.insert_batch(
                    [Event("purchase", "user", u, "item", it) for u in fresh
                     for it in ("i1", "fresh19b")], app_id)
                t1 = time.perf_counter()
                wait_until(lambda: len(completed()) >= 2 or proc.poll() is not None, 120,
                           "19b's folded instance")
                check(proc.poll() is None, f"19b: pio train --follow exited {proc.returncode}")
                fold_s = time.perf_counter() - t1
            finally:
                if proc.poll() is None:
                    proc.send_signal(2)   # SIGINT: the CLI stops the trainer, exits 0
                try:
                    rc = proc.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait(timeout=30)
                    raise SmokeFailure("19b: pio train --follow did not stop on SIGINT")
        except BaseException:
            print(log_path.read_text()[-4000:])
            raise
    check(rc == 0, f"19b: pio train --follow exited {rc} after SIGINT: "
                   f"{log_path.read_text()[-2000:]}")
    instances = completed()
    check(len(instances) == 2, f"19b: {len(instances)} COMPLETED instances, expected 2")
    _, (model,) = load_latest_models(variant["id"], device=dev)
    check("fresh19b" in model.item_dict, "19b: the folded instance lacks the delta's item")
    _, engine, ep = engine_from_variant(variant)
    invalidate_staging_cache()
    (ref,) = engine.train(ep, device=dev)
    for name in ref.indicator_idx:
        check(ref.item_dict.strings() == model.item_dict.strings()
              and np.array_equal(ref.indicator_idx[name], model.indicator_idx[name])
              and np.array_equal(ref.indicator_llr[name].view(np.int32),
                                 model.indicator_llr[name].view(np.int32)),
              f"19b: the folded {name} table differs from a card train")
    print(f"  19b: pio train --follow (a subprocess, {n_users} users x {n_items} items, "
          f"{n_buy} purchases: the CLI wiring at a small size) published its bootstrap "
          f"instance {boot_s:.3f} s after start and the delta's instance {fold_s:.3f} s after "
          f"the append, equal to a card train; SIGINT -> exit 0")
    return {"bootstrap_s": boot_s, "fold_s": fold_s, "instances": len(instances)}


def follow_path(ur, cco, hk, dev, workdir, variants):
    """Phase 19: ``deploy(follow=FOLLOW_INTERVAL_S)`` of phase 11b's stored UR
    (LLR weights off) in this process, so the launch counters and the
    follower read.  The follower bootstraps from the log (snapshot, tail,
    tombstones) through K2/K3 on the card; then FOLLOW_ROUNDS rounds of
    bench_freshness's protocol (bench.py:4080-4097): a probe user buys a
    brand-new seed item, and once that folds, FOLLOW_COBUYERS users buy the
    seed and a brand-new item, and /queries.json is polled until the probe's
    answer holds it (FOLLOW_CAP_S a round).  Every tick must fold (no retrain
    tick), K2 and K3 must launch during the folds, device memory may not
    grow past one generation's model plus the re-selection slice budget,
    K2 must equal the certificate's cell scoring bit for bit, and after the
    drain the live tables equal a from-scratch card train bit for bit, with
    FOLLOW_PROBES answers byte-equal.  19b: ``pio train --follow``."""
    import gc

    from predictionio_tpu_torch.events.event import Event
    from predictionio_tpu_torch.storage import get_storage
    from predictionio_tpu_torch.store.event_store import invalidate_staging_cache
    from predictionio_tpu_torch.streaming import fold as fold_mod
    from predictionio_tpu_torch.streaming import follow as follow_mod
    from predictionio_tpu_torch.workflow.create_server import deploy
    from predictionio_tpu_torch.workflow.create_workflow import engine_from_variant

    t_phase = time.perf_counter()
    out = {}
    store = get_storage()
    app_id = store.apps.get_by_name("smoke").id
    folds = follow_mod._M_FOLDS
    outcomes = ("fold", "retrain", "restage", "idle", "error", "disabled")
    f0 = {o: folds.value(outcome=o) for o in outcomes}
    r0 = {o: fold_mod._M_RELLR_ROWS.value(outcome=o) for o in ("certified", "selected")}
    gc.collect()
    torch.cuda.synchronize()
    with hk._count_lock:
        hk.llr_masked_scores.launches = hk.tile_topk_desc.launches = 0
    t0 = time.perf_counter()
    server = deploy(str(variants[False]), host="127.0.0.1", port=0, device=dev,
                    follow=FOLLOW_INTERVAL_S)
    try:
        state = server.pio_state
        follower = state.follower
        check(follower is not None and follower.mode == "fold",
              "19: deploy(follow=) hosts no fold-mode follower")
        url = f"http://127.0.0.1:{server.server_address[1]}/queries.json"
        wait_until(lambda: follower.generation >= 1
                   and follower.status()["lastOutcome"] == "idle", 600, "the bootstrap")
        out["bootstrap_s"] = time.perf_counter() - t0
        fstate = follower._fold
        covered = len(fstate.batch)
        boot_launches = follow_counts(hk)
        gc.collect()
        torch.cuda.synchronize()
        mem_boot = torch.cuda.memory_allocated(dev)
        st = follower.status()
        print(f"  deploy(follow={FOLLOW_INTERVAL_S}) bootstrapped the fold state from "
              f"{covered} events in {out['bootstrap_s']:.3f} s (deploy included): "
              f"stateMode {st['stateMode']}, pio_follow_state_bytes {st['stateBytes']} "
              f"(PIO_FOLLOW_STATE_BYTES default {fold_mod.state_budget_bytes()}), K2/K3 "
              f"launches {boot_launches} (every row re-selected on the card, chunks of "
              f"{fold_mod._RESELECT_SLICE_BYTES} B), device memory {mem_boot} B")
        check(st["stateMode"] == "sparse", f"19: state mode {st['stateMode']}")
        check(boot_launches[0] > 0 and boot_launches[1] > 0,
              f"19: the bootstrap launched K2/K3 {boot_launches}")
        lat_ms, rounds, starts = [], [], []
        for r in range(FOLLOW_ROUNDS):
            seed, fresh, probe = f"seed19_{r}", f"fresh19_{r}", f"probe19_{r}"
            rel0 = {o: fold_mod._M_RELLR_ROWS.value(outcome=o)
                    for o in ("certified", "selected")}
            k0 = follow_counts(hk)
            store.l_events.insert_batch([Event("purchase", "user", probe, "item", seed)],
                                        app_id)
            covered += 1
            wait_until(lambda: follower_drained(follower, covered), 120,
                       f"round {r}'s probe fold")
            cobuyers = [f"cob19_{r}_{j}" for j in range(FOLLOW_COBUYERS)]
            starts.append(time.time())
            t_append = time.perf_counter()
            store.l_events.insert_batch(
                [Event("purchase", "user", u, "item", it) for u in cobuyers
                 for it in (seed, fresh)], app_id)
            covered += 2 * FOLLOW_COBUYERS
            reflected = None
            while time.perf_counter() - t_append < FOLLOW_CAP_S:
                got = post(url, {"user": probe, "num": 30})
                if any(s["item"] == fresh for s in got["itemScores"]):
                    reflected = (time.perf_counter() - t_append) * 1e3
                    break
                time.sleep(0.01)
            check(reflected is not None,
                  f"19: round {r}: {fresh} not reflected within {FOLLOW_CAP_S} s")
            wait_until(lambda: follower_drained(follower, covered), 120,
                       f"round {r}'s drain")
            k1 = follow_counts(hk)
            rel = {o: fold_mod._M_RELLR_ROWS.value(outcome=o) - rel0[o] for o in rel0}
            rounds.append({"reflected_ms": reflected, "k2": k1[0] - k0[0], "k3": k1[1] - k0[1],
                           "rellr_rows": rel, "phase_s": dict(fstate.last_phase_s),
                           "emit_s": fstate.last_emit_s,
                           "last_rellr": dict(fstate.last_rellr_stats)})
            lat_ms.append(reflected)
            print(f"  round {r}: {fresh} reflected {reflected:.3f} ms after the append; "
                  f"rows certified/selected {rel}, K2/K3 launches {k1[0] - k0[0]}/"
                  f"{k1[1] - k0[1]}; the last fold's phases "
                  f"{ {k: round(v, 4) for k, v in fstate.last_phase_s.items()} } s, emit "
                  f"{fstate.last_emit_s:.4f} s")
        fold_launches = follow_counts(hk)
        out["launches"] = fold_launches
        during = (fold_launches[0] - boot_launches[0], fold_launches[1] - boot_launches[1])
        tick = {o: folds.value(outcome=o) - f0[o] for o in outcomes}
        rel_all = {o: fold_mod._M_RELLR_ROWS.value(outcome=o) - r0[o] for o in r0}
        check(tick["retrain"] == 0 and tick["restage"] == 0 and tick["error"] == 0,
              f"19: follow ticks {tick}: the follower left fold mode")
        check(tick["fold"] >= 2 * FOLLOW_ROUNDS, f"19: only {tick['fold']} fold ticks")
        check(during[0] > 0 and during[1] > 0,
              f"19: K2/K3 launched {during} times during the folds")
        gc.collect()
        torch.cuda.synchronize()
        mem_last = torch.cuda.memory_allocated(dev)
        (live,) = state.models
        gen_bytes = model_device_bytes(live)
        check(mem_last - mem_boot <= gen_bytes + fold_mod._RESELECT_SLICE_BYTES,
              f"19: device memory grew {mem_last - mem_boot} B over the folds, past one "
              f"generation ({gen_bytes} B) plus the slice budget")
        st = follower.status()
        p50, p99 = np.percentile(lat_ms, 50), np.percentile(lat_ms, 99)
        out.update({"reflected_ms": lat_ms, "p50_ms": float(p50), "p99_ms": float(p99),
                    "gate_ms": FOLLOW_GATE_S * 1e3, "ticks": tick, "rellr_rows": rel_all,
                    "launches_during_folds": during, "bootstrap_launches": boot_launches,
                    "state_bytes": st["stateBytes"], "state_mode": st["stateMode"],
                    "memory_after_bootstrap": mem_boot, "memory_after_last_fold": mem_last,
                    "generation_device_bytes": gen_bytes, "rounds": rounds})
        print(f"  append -> reflected over {FOLLOW_ROUNDS} rounds: p50 {p50:.3f} ms, p99 "
              f"{p99:.3f} ms against the reference's {FOLLOW_GATE_S:g} s gate "
              f"({'held' if p99 <= FOLLOW_GATE_S * 1e3 else 'missed'}); pio_follow_folds_total "
              f"{tick}; pio_follow_rellr_rows_total {rel_all}; K2/K3 launches during the "
              f"folds {during}; stateMode {st['stateMode']}, state bytes {st['stateBytes']}; "
              f"device memory after the bootstrap {mem_boot} B, after the last fold "
              f"{mem_last} B (a generation stages {gen_bytes} B)")
        base = f"http://127.0.0.1:{server.server_address[1]}"
        traces = fold_traces(base, tick["fold"])
        recs = round_records(lineage_records(base), starts, "19")
        out["observability"] = {"fold_traces": len(traces), "rounds": recs}
        print(f"  /traces.json: {len(traces)} fold-* traces (model_swap) with follow_tail and "
              f"follow_fold for {tick['fold']} fold ticks; /lineage.json: each round's record "
              "from append_observed to first_serve in STAGE_ORDER, fold.rellr in each: "
              + "; ".join(f"round {r} {d['lid']} gen {d['generation']} {d['outcome']} "
                          f"append_observed -> first serve {d['append_to_first_serve_ms']:.3f} ms "
                          f"(reflected {lat_ms[r]:.3f} ms)" for r, d in enumerate(recs)))

        # K2 on a captured row slice against the certificate's cell scoring
        cells, differ = k2_against_cell_scoring(fold_mod, cco, hk, fstate, dev)
        check(cells > 0 and differ == 0,
              f"19: K2 and _score_llr_cells(device=cuda) differ at {differ} of {cells} cells")
        out["k2_vs_cell_scoring"] = {"cells": cells, "differ": differ}
        print(f"  K2 gathered at {cells} nonzero cells of a row slice of each type equals "
              "_score_llr_cells on the card bit for bit")

        # the live model against a from-scratch card train
        _, engine, ep = engine_from_variant(engine_variant(False))
        invalidate_staging_cache()
        t1 = time.perf_counter()
        (ref,) = engine.train(ep, device=dev)
        out["retrain_s"] = time.perf_counter() - t1
        check(ref.item_dict.strings() == live.item_dict.strings(),
              "19: the live item dictionary differs from the card train's")
        for name in ref.indicator_idx:
            check(live.event_item_dicts[name].strings() == ref.event_item_dicts[name].strings()
                  and np.array_equal(live.indicator_idx[name], ref.indicator_idx[name])
                  and np.array_equal(live.indicator_llr[name].view(np.int32),
                                     ref.indicator_llr[name].view(np.int32)),
                  f"19: the live {name} table differs from a from-scratch card train")
        check(np.array_equal(np.asarray(live.popularity), np.asarray(ref.popularity)),
              "19: the live popularity differs from the card train's")
        rng = np.random.default_rng(SEED + 190)
        users = ([f"u{int(u)}" for u in rng.choice(
            DEPLOYED_UR[0], FOLLOW_PROBES - 5 * FOLLOW_ROUNDS - 1, replace=False)]
                 + [f"probe19_{r}" for r in range(FOLLOW_ROUNDS)]
                 + [f"cob19_{r}_{j}" for r in range(FOLLOW_ROUNDS) for j in range(4)]
                 + ["never-seen"])
        algo = engine.make_components(ep, device=dev)[2][0]
        differ_answers = 0
        for u in users:
            body = {"user": u, "num": 20}
            want = json.dumps(algo.predict(ref, ur.URQuery.from_json(body)).to_json()).encode()
            differ_answers += post_raw(url, body) != want
        check(differ_answers == 0,
              f"19: {differ_answers} of {len(users)} answers differ from the card train's")
        print(f"  after the drain: the live tables (ids and LLR of both types), item "
              f"dictionaries and popularity are bit-identical to a from-scratch card train "
              f"({out['retrain_s']:.3f} s); {len(users)} probe answers byte-equal")
        del ref
    finally:
        server.shutdown()
        server.server_close()
    check(follower._thread is not None and not follower._thread.is_alive(),
          "19: the follower thread outlived the server")
    torch.cuda.empty_cache()
    out["small_cli"] = follow_small_cli(dev, workdir)
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"  phase 19 wall {out['wall_s']:.3f} s")
    return out


# -- phase 20: the model plane and its replication ---------------------------------

PLANE_PROBES = 200          # answers held byte-equal, publisher against subscriber
PLANE_DELTA_BAR = 0.10      # a fold delta's write amplification (bench.py:2239-2340)
PLANE_DUP_BAR = 0.05        # a duplicate-only delta's
PLANE_TORN_CYCLES = 2       # torn re-syncs observed before the fault is lifted
PUB_NODE, SUB_NODE = "smoke-pub", "smoke-sub"   # the two nodes' PIO_CLUSTER_NODE
CLUSTER_SLOS = ("cluster_propagation_p99", "cluster_repl_lag", "cluster_qps_divergence",
                "cluster_p95_divergence")


def cluster_obs(pub_base, sub_base, prop0, starts, lat_ms, generation) -> dict:
    """Phase 20, after the freshness rounds: the subscriber's own lineage
    records hold, for each round, the ``repl.*`` stages, ``watcher_wake``,
    ``compose``, ``install`` and ``first_serve``; the publisher's
    federation lists the subscriber up (beside its own node) in
    ``/cluster/metrics.json``; ``pio_cluster_propagation_seconds`` counted
    every round (polled: the federation pulls the subscriber's stages on
    its scrape); ``pio lineage --cluster`` renders the stitched waterfall;
    the publisher's ``/healthz`` carries the cluster SLO rows; ``pio top
    --window 10`` prints against the publisher."""
    from predictionio_tpu_torch.obs import cluster as obs_cluster

    need = {"repl.recv", "repl.verify", "repl.land", "watcher_wake", "compose", "install",
            "first_serve"}
    sub_recs = lineage_records(sub_base)
    lanes = []
    for r, t_wall in enumerate(starts):
        cands = sorted((d for d in sub_recs if d["start"] >= t_wall
                        and need <= {s["stage"] for s in d["stages"]}),
                       key=lambda d: d["start"])
        check(cands, f"20: the subscriber holds no complete record for round {r}")
        lanes.append(cands[0])
        nodes = {s.get("node") for s in cands[0]["stages"]}
        check(nodes == {SUB_NODE}, f"20: the subscriber's stages are stamped {nodes}")
    def stitched_all():
        docs = [get_json(f"{pub_base}/lineage/{d['lid']}.json") for d in lanes]
        return docs if all(d["outcome"] == "cluster_complete" for d in docs) else None

    wait_until(stitched_all, 60, "20: each round's record stitched cluster_complete")
    wait_until(lambda: hist_count(obs_cluster._M_PROP) - prop0 >= len(starts), 30,
               "20: pio_cluster_propagation_seconds for every round")
    props = hist_count(obs_cluster._M_PROP) - prop0
    cm = get_json(pub_base + "/cluster/metrics.json")
    sub_node = cm["nodes"].get(SUB_NODE) or {}
    check(cm["node"] == PUB_NODE and sub_node.get("up") is True,
          f"20: /cluster/metrics.json node {cm['node']}, nodes {cm['nodes']}")
    health = get_json(pub_base + "/healthz")
    check(set(CLUSTER_SLOS) <= set(health["slos"]),
          f"20: /healthz SLO rows {sorted(health['slos'])}")
    stitched = get_json(f"{pub_base}/lineage/{lanes[-1]['lid']}.json")
    check(stitched.get("cluster", {}).get("expected") == [SUB_NODE]
          and stitched["outcome"] == "cluster_complete",
          f"20: the stitched record: {stitched['outcome']} {stitched.get('cluster')}")
    text = cli_out("lineage", pub_base.replace("http://", ""), "--lid", lanes[-1]["lid"],
                   "--cluster")
    check(SUB_NODE in text and "repl.land" in text, "20: pio lineage --cluster: no node lane")
    top = cli_out("top", pub_base.replace("http://", ""), "--window", "10")
    check("req/s" in top, "20: pio top printed no rows")
    out = {"subscriber_rounds": [{"lid": d["lid"], "stages": [s["stage"] for s in d["stages"]]}
                                 for d in lanes],
           "propagation_observed": props, "cluster_nodes": cm["nodes"],
           "healthz_cluster": {k: health["slos"][k]["verdict"] for k in CLUSTER_SLOS},
           "stitched_propagation_ms": stitched["cluster"].get("propagationMs")}
    print(f"  the subscriber's records ({SUB_NODE}) hold, each round, "
          f"{sorted(need)}; pio_cluster_propagation_seconds observed {props} stitched "
          f"records over {len(starts)} rounds; /cluster/metrics.json: publisher "
          f"{cm['node']}, {SUB_NODE} up, generation {sub_node.get('generation')} (the "
          f"publisher's {generation}); /healthz cluster rows "
          f"{out['healthz_cluster']}; the last round's stitched propagation "
          f"{out['stitched_propagation_ms']} ms beside its reflected {lat_ms[-1]:.3f} ms")
    return out


def smi_query(*args) -> str:
    return subprocess.run(["nvidia-smi", *args], capture_output=True, text=True,
                          timeout=60).stdout.strip()


def card_memory(dev) -> dict:
    """The card's memory in use (nvidia-smi, MiB), this process's torch
    reservations and allocations, and the compute processes with their
    memory as ``nvidia-smi --query-compute-apps`` lists them (a sandboxed
    machine may show other pids, or one line for all)."""
    used = smi_query("--query-gpu=memory.used", "--format=csv,noheader,nounits")
    return {"device_used_mib": float(used.splitlines()[0]),
            "this_reserved_mib": torch.cuda.memory_reserved(dev) / 2**20,
            "this_allocated_mib": torch.cuda.memory_allocated(dev) / 2**20,
            "compute_apps": "; ".join(smi_query(
                "--query-compute-apps=pid,used_memory",
                "--format=csv,noheader").splitlines()) or "none listed"}


def memory_split(base: dict, now: dict) -> dict:
    """Each process's card memory from two readings of ``card_memory``:
    ``base`` taken in this process alone (its context and what torch does
    not reserve: the card's use less torch's reservation), ``now`` with the
    subscriber running (the card's use less this process's share)."""
    own = base["device_used_mib"] - base["this_reserved_mib"]
    return {**now, "publisher_mib": own + now["this_reserved_mib"],
            "subscriber_mib": now["device_used_mib"] - own - now["this_reserved_mib"]}


def same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def plane_differences(got, want) -> list:
    """What of ``got`` (a composed plane model) differs from ``want`` bit for
    bit: every array the plane carries, the derived inverted CSRs and
    popularity order, the dictionaries and the item properties."""
    pairs = [("popularity", got.popularity, want.popularity),
             ("pop_order", got.__dict__["_host_pop_order"], want.host_pop_order()),
             ("user_seen indptr", got.user_seen.indptr, want.user_seen.indptr),
             ("user_seen values", got.user_seen.values, want.user_seen.values)]
    for n in want.indicator_idx:
        pairs += [(f"{n} idx", got.indicator_idx[n], want.indicator_idx[n]),
                  (f"{n} llr", got.indicator_llr[n], want.indicator_llr[n])]
        pairs += [(f"{n} inverted {part}", x, y) for part, x, y in zip(
            ("indptr", "rows", "w"), got.__dict__["_host_inv"][n], want.host_inverted(n))]
    for n, csr in want.user_seen_by_event.items():
        pairs += [(f"{n} seen indptr", got.user_seen_by_event[n].indptr, csr.indptr),
                  (f"{n} seen values", got.user_seen_by_event[n].values, csr.values)]
    bad = [name for name, x, y in pairs if not same_bits(x, y)]
    if list(got.indicator_idx) != list(want.indicator_idx):
        bad.append("event types")
    for name, x, y in [("item dictionary", got.item_dict, want.item_dict),
                       ("user dictionary", got.user_dict, want.user_dict)] + [
            (f"{n} dictionary", got.event_item_dicts[n], want.event_item_dicts[n])
            for n in want.event_item_dicts]:
        if x.strings() != y.strings():
            bad.append(name)
    if dict(got.item_properties) != dict(want.item_properties):
        bad.append("item properties")
    return bad


def metric_values(text: str, name: str) -> list:
    """The values of every series of ``name`` in a Prometheus scrape."""
    import re

    return [float(m.group(1)) for m in re.finditer(
        rf"^{name}(?:\{{[^}}]*\}})? (\S+)$", text, re.M)]


def plane_path(ur, hk, dev, workdir, variants, env):
    """Phase 20: the model plane and its replication at the deployed UR width,
    on phase 11b's stored model (LLR weights off) and app.  The publisher is
    ``deploy(follow=FOLLOW_INTERVAL_S, plane_publish=...)`` in this process
    (its own node-local plane directory; K2/K3's counters read here): it
    seeds its plane with the stored instance, its follower bootstraps and
    folds on the card, every generation goes through the plane (a keyframe
    or a delta arena) and is served composed.  The subscriber is ``pio
    deploy --plane-from`` as a subprocess on the card with a plane directory
    of its own.  A duplicate-only delta first (write amplification at most
    PLANE_DUP_BAR); then FOLLOW_ROUNDS rounds of bench_freshness's protocol
    (as phase 19), each timed from the co-buyers' append to the brand-new
    item in the probe's answer AT THE SUBSCRIBER (p99 at most FOLLOW_GATE_S,
    a round past FOLLOW_CAP_S fails), the two planeGenerations converging
    after each; the subscriber SIGKILLed while the stream moves on and
    restarted (no cold or lag re-sync: it resumes from its last flipped
    generation); file frames torn in flight (an advertised sha256 that is
    not the bytes') until PLANE_TORN_CYCLES torn re-syncs, the subscriber
    quarantining them while its old generation answers byte-equal, then
    converging; PLANE_PROBES answers byte-equal between the two; a fresh
    ``ModelPlane`` here composing the subscriber's newest generation bit-equal
    to the publisher's live model and its fold's.  K2 and K3 must launch
    during the folds; bytes by path, map/compose seconds and each process's
    card memory are printed."""
    import gc
    import signal

    from predictionio_tpu_torch.events.event import Event
    from predictionio_tpu_torch.obs import cluster as obs_cluster
    from predictionio_tpu_torch.obs import metrics as obs_metrics
    from predictionio_tpu_torch.storage import get_storage
    from predictionio_tpu_torch.streaming import plane as plane_mod
    from predictionio_tpu_torch.streaming import replicate
    from predictionio_tpu_torch.workflow.create_server import deploy

    t_phase = time.perf_counter()
    out = {}
    store = get_storage()
    app_id = store.apps.get_by_name("smoke").id
    root = Path(__file__).resolve().parent
    pub_dir, sub_dir = workdir / "plane-pub", workdir / "plane-sub"
    repl_port, sub_port = free_port(), free_port()
    sub_base = f"http://127.0.0.1:{sub_port}"
    # the subscriber's store sees this process's appends: its history cache
    # hears only its own, so it reads history uncached
    # each node names itself (PIO_CLUSTER_NODE) and keeps its own lineage
    # records; the subscriber samples its history every second, which the
    # publisher's federation scrapes every second
    sub_env = {**os.environ, **env, "PYTHONPATH": str(root), "PIO_TORCH_DEVICE": dev.type,
               "PIO_MODEL_PLANE_DIR": str(sub_dir), "PIO_HISTORY_CACHE": "off",
               "PIO_CLUSTER_NODE": SUB_NODE, "PIO_LINEAGE_DIR": str(workdir / "lineage-sub"),
               "PIO_TSDB_INTERVAL_S": "1"}
    log_path = workdir / "plane-subscriber.log"
    resync, pub_bytes = replicate._M_RESYNC, plane_mod._M_PUB_BYTES
    reasons = ("cold", "lag", "torn")
    b0 = {p: pub_bytes.value(path=p) for p in ("full", "delta", "ref")}
    publishes = []
    sub = {"proc": None}

    def start_subscriber():
        with open(log_path, "a") as log:
            sub["proc"] = subprocess.Popen(
                [sys.executable, "-m", "predictionio_tpu_torch.cli.main", "deploy",
                 "--engine-json", str(variants[False]), "--ip", "127.0.0.1",
                 "--port", str(sub_port), "--plane-from", f"127.0.0.1:{repl_port}"],
                cwd=root, env=sub_env, stdout=log, stderr=subprocess.STDOUT)

    def sub_info():
        proc = sub["proc"]
        check(proc.poll() is None, f"20: the subscriber exited {proc.returncode}: "
                                   f"{log_path.read_text()[-4000:]}")
        try:
            return get_json(sub_base + "/", timeout=5)
        except (urllib.error.URLError, ConnectionError, OSError):
            return None

    gc.collect()
    torch.cuda.synchronize()
    with hk._count_lock:
        hk.llr_masked_scores.launches = hk.tile_topk_desc.launches = 0
    os.environ["PIO_MODEL_PLANE_DIR"] = str(pub_dir)
    saved_obs = {k: os.environ.get(k) for k in ("PIO_CLUSTER_NODE", "PIO_CLUSTER_SCRAPE_S")}
    os.environ.update(PIO_CLUSTER_NODE=PUB_NODE, PIO_CLUSTER_SCRAPE_S="1")
    prop0 = hist_count(obs_cluster._M_PROP)
    t0 = time.perf_counter()
    try:
        server = deploy(str(variants[False]), host="127.0.0.1", port=0, device=dev,
                        follow=FOLLOW_INTERVAL_S, plane_publish=f"127.0.0.1:{repl_port}")
    finally:
        os.environ.pop("PIO_MODEL_PLANE_DIR", None)
        os.environ.pop("PIO_CLUSTER_SCRAPE_S")
    try:
        state = server.pio_state
        follower = state.follower
        check(state.plane is not None and state.replication is not None
              and follower is not None and follower.mode == "fold",
              "20: deploy(follow=, plane_publish=) hosts no plane, replicator or fold-mode "
              "follower")
        follower.add_publish_listener(lambda: publishes.append({
            **state.plane.last_publish_stats,
            "generation": int((state.plane.current() or {}).get("generation") or 0),
            "kind": (state.plane.current() or {}).get("kind")}))
        mem_base = card_memory(dev)   # this process alone
        start_subscriber()
        pub_url = f"http://127.0.0.1:{server.server_address[1]}/queries.json"
        sub_url = sub_base + "/queries.json"
        tag = obs_metrics.worker_tag()

        def converged():
            info = sub_info()
            return (info is not None and state.plane_generation > 0
                    and info["planeGeneration"] == state.plane_generation)

        def settled(covered):
            return follower_drained(follower, covered) and converged()

        wait_until(lambda: follower.generation >= 1
                   and follower.status()["lastOutcome"] == "idle", 600,
                   "20: the publisher's bootstrap")
        out["bootstrap_s"] = time.perf_counter() - t0
        fstate = follower._fold
        check(fstate.device.type == "cuda", f"20: the fold state is on {fstate.device}")
        covered = len(fstate.batch)
        boot_launches = follow_counts(hk)
        wait_until(converged, DEPLOY_TIMEOUT_S, "20: the subscriber's first generation")
        out["first_converged_s"] = time.perf_counter() - t0
        out["memory_first"] = memory_split(mem_base, card_memory(dev))
        keyframes = [p for p in publishes if p["kind"] == "full"]
        check(keyframes, "20: no keyframe was published after the listener was added")
        out["full_arena_bytes"] = keyframes[-1]["file"]
        print(f"  publisher: deploy(follow={FOLLOW_INTERVAL_S}, plane_publish) bootstrapped "
              f"from {covered} events in {out['bootstrap_s']:.3f} s (K2/K3 {boot_launches}); "
              f"the subscriber (pio deploy --plane-from, a subprocess) first converged on "
              f"generation {state.plane_generation} {out['first_converged_s']:.3f} s after "
              f"the deploy; the full arena {out['full_arena_bytes']} B on disk "
              f"({keyframes[-1]['logical']} B logical); card memory: {out['memory_first']}")

        # a duplicate-only delta: a new pair folded, then bought again
        store.l_events.insert_batch([Event("purchase", "user", "probe20_dup", "item",
                                           "seed20_dup")], app_id)
        covered += 1
        wait_until(lambda: settled(covered), 120, "20: the pair's fold")
        n0 = len(publishes)
        store.l_events.insert_batch([Event("purchase", "user", "probe20_dup", "item",
                                           "seed20_dup")], app_id)
        covered += 1
        wait_until(lambda: settled(covered), 120, "20: the duplicate's fold")
        dup = publishes[n0:]
        check(dup and all(p["kind"] == "delta" for p in dup),
              f"20: the duplicate published {[p['kind'] for p in dup]}")
        dup_amp = max(p["written"] / p["logical"] for p in dup)
        out["duplicate_delta"] = {"publishes": dup, "write_amplification": dup_amp}
        check(dup_amp <= PLANE_DUP_BAR,
              f"20: a duplicate-only delta wrote {dup_amp:.4%} of its generation's bytes")
        print(f"  a duplicate-only delta: {dup[-1]['written']} B written of "
              f"{dup[-1]['logical']} B logical (write amplification {dup_amp:.6f}, bar "
              f"{PLANE_DUP_BAR})")

        lat_ms, rounds, starts = [], [], []
        for r in range(FOLLOW_ROUNDS):
            seed, fresh, probe = f"seed20_{r}", f"fresh20_{r}", f"probe20_{r}"
            k0, n0 = follow_counts(hk), len(publishes)
            store.l_events.insert_batch([Event("purchase", "user", probe, "item", seed)],
                                        app_id)
            covered += 1
            wait_until(lambda: settled(covered), 120, f"20: round {r}'s probe fold")
            cobuyers = [f"cob20_{r}_{j}" for j in range(FOLLOW_COBUYERS)]
            starts.append(time.time())
            t_append = time.perf_counter()
            store.l_events.insert_batch(
                [Event("purchase", "user", u, "item", it) for u in cobuyers
                 for it in (seed, fresh)], app_id)
            covered += 2 * FOLLOW_COBUYERS
            reflected = None
            while time.perf_counter() - t_append < FOLLOW_CAP_S:
                got = post(sub_url, {"user": probe, "num": 30})
                if any(s["item"] == fresh for s in got["itemScores"]):
                    reflected = (time.perf_counter() - t_append) * 1e3
                    break
                time.sleep(0.01)
            check(reflected is not None,
                  f"20: round {r}: {fresh} not reflected at the subscriber within "
                  f"{FOLLOW_CAP_S} s")
            wait_until(lambda: settled(covered), 120, f"20: round {r}'s drain")
            k1 = follow_counts(hk)
            with urllib.request.urlopen(sub_base + "/metrics", timeout=30) as resp:
                sub_map_s = metric_values(resp.read().decode(), "pio_model_plane_map_seconds")
            pubs = publishes[n0:]
            rounds.append({
                "reflected_ms": reflected, "k2": k1[0] - k0[0], "k3": k1[1] - k0[1],
                "publishes": pubs,
                "publisher_map_s": plane_mod._M_MAP_S.value(worker=tag),
                "subscriber_map_s": sub_map_s})
            lat_ms.append(reflected)
            print(f"  round {r}: {fresh} reflected at the subscriber {reflected:.3f} ms after "
                  f"the append; publishes (kind, written/logical B) "
                  f"{[(p['kind'], p['written'], p['logical']) for p in pubs]}; K2/K3 "
                  f"{k1[0] - k0[0]}/{k1[1] - k0[1]}; map/compose+install s publisher "
                  f"{rounds[-1]['publisher_map_s']:.4f}, subscriber {sub_map_s}")
        fold_deltas = [p for rd in rounds for p in rd["publishes"] if p["kind"] == "delta"]
        check(fold_deltas, "20: no fold published a delta")
        amps = [p["written"] / p["logical"] for p in fold_deltas]
        p50, p99 = np.percentile(lat_ms, 50), np.percentile(lat_ms, 99)
        check(p99 <= FOLLOW_GATE_S * 1e3,
              f"20: append -> reflected at the subscriber p99 {p99:.3f} ms, past the "
              f"{FOLLOW_GATE_S:g} s gate")
        during = follow_counts(hk)
        during = (during[0] - boot_launches[0], during[1] - boot_launches[1])
        check(during[0] > 0 and during[1] > 0,
              f"20: K2/K3 launched {during} times during the folds")
        out.update({"reflected_ms": lat_ms, "p50_ms": float(p50), "p99_ms": float(p99),
                    "gate_ms": FOLLOW_GATE_S * 1e3, "rounds": rounds,
                    "fold_delta_amplification": {"min": min(amps), "max": max(amps),
                                                 "median": float(np.median(amps)),
                                                 "bar": PLANE_DELTA_BAR},
                    "launches_during_folds": during, "bootstrap_launches": boot_launches})
        print(f"  append -> reflected at the subscriber over {FOLLOW_ROUNDS} rounds: p50 "
              f"{p50:.3f} ms, p99 {p99:.3f} ms (gate {FOLLOW_GATE_S:g} s: held); a fold "
              f"delta's write amplification min {min(amps):.4f} median "
              f"{np.median(amps):.4f} max {max(amps):.4f} over {len(amps)} deltas, beside "
              f"the JAX package's bar {PLANE_DELTA_BAR} "
              f"({'held' if max(amps) <= PLANE_DELTA_BAR else 'missed'}); K2/K3 launches "
              f"during the folds {during}")
        out["observability"] = cluster_obs(
            f"http://127.0.0.1:{server.server_address[1]}", sub_base, prop0, starts, lat_ms,
            state.plane_generation)

        # SIGKILL the subscriber while the stream moves on, then restart it
        have = sub_info()["planeGeneration"]
        r_kill = {k: resync.value(reason=k) for k in reasons}
        sub["proc"].send_signal(signal.SIGKILL)
        sub["proc"].wait(timeout=60)
        store.l_events.insert_batch(
            [Event("purchase", "user", f"cob20_kill_{j}", "item", it)
             for j in range(FOLLOW_COBUYERS) for it in ("seed20_0", "fresh20_kill")], app_id)
        covered += 2 * FOLLOW_COBUYERS
        wait_until(lambda: follower_drained(follower, covered), 120, "20: the fold while down")
        moved_to = state.plane_generation
        check(moved_to > have, "20: the stream did not move while the subscriber was down")
        t1 = time.perf_counter()
        start_subscriber()
        wait_until(converged, DEPLOY_TIMEOUT_S, "20: the restarted subscriber's convergence")
        out["restart_converged_s"] = time.perf_counter() - t1
        rs = {k: resync.value(reason=k) - r_kill[k] for k in reasons}
        repl_status = sub_info()["freshness"]["replication"]
        check(rs["cold"] == 0 and rs["lag"] == 0 and repl_status["resyncs"] == 0,
              f"20: the restarted subscriber re-synced {rs}, {repl_status}")
        out["kill"] = {"had": have, "moved_to": moved_to, "resyncs": rs,
                       "restart_converged_s": out["restart_converged_s"]}
        print(f"  SIGKILL at generation {have}; the publisher moved to {moved_to} while it "
              f"was down; the restarted subscriber resumed (re-syncs {rs}) and converged "
              f"{out['restart_converged_s']:.3f} s after its start")

        # file frames torn in flight: quarantined, the old generation serves
        bodies = [{"user": f"cob20_{r}_0", "num": 20} for r in range(FOLLOW_ROUNDS)] + [
            {"user": f"u{j}", "num": 20} for j in range(12)]
        old_gen = state.plane_generation
        before = [post_raw(sub_url, b) for b in bodies]
        real_send = replicate._send_frame
        tear = {"on": True, "frames": 0}

        def tearing_send(sock, header, payload_len=0):
            if tear["on"] and header.get("type") == "file":
                tear["frames"] += 1
                header = dict(header, sha256="0" * 64)
            real_send(sock, header, payload_len)

        torn0 = resync.value(reason="torn")
        replicate._send_frame = tearing_send
        try:
            store.l_events.insert_batch([Event("purchase", "user", "probe20_torn", "item",
                                               "seed20_1")], app_id)
            covered += 1
            wait_until(lambda: follower_drained(follower, covered)
                       and resync.value(reason="torn") - torn0 >= PLANE_TORN_CYCLES
                       and any(sub_dir.glob("*.quarantine")), 120,
                       "20: the torn transfers' quarantine")
            info = sub_info()
            during_tear = [post_raw(sub_url, b) for b in bodies]
        finally:
            tear["on"] = False
            replicate._send_frame = real_send
        quarantined = sorted(p.name for p in sub_dir.glob("*.quarantine"))
        check(info["planeGeneration"] == old_gen < state.plane_generation,
              f"20: while torn the subscriber served generation {info['planeGeneration']} "
              f"(old {old_gen}, new {state.plane_generation})")
        check(during_tear == before, "20: the old generation's answers changed while torn")
        t1 = time.perf_counter()
        wait_until(converged, 120, "20: convergence after the torn transfers")
        out["torn"] = {"frames_torn": tear["frames"],
                       "torn_resyncs": resync.value(reason="torn") - torn0,
                       "quarantined": quarantined, "old_generation": old_gen,
                       "healed_s": time.perf_counter() - t1}
        print(f"  {tear['frames']} file frames torn in flight: {out['torn']['torn_resyncs']} "
              f"torn re-syncs, quarantined {quarantined}; generation {old_gen} kept "
              f"answering byte-equal ({len(bodies)} queries); converged on "
              f"{state.plane_generation} {out['torn']['healed_s']:.3f} s after the fault "
              "was lifted")

        # PLANE_PROBES answers, publisher against subscriber
        rng = np.random.default_rng(SEED + 200)
        users = ([f"u{int(u)}" for u in rng.choice(DEPLOYED_UR[0],
                                                   PLANE_PROBES - 4 * FOLLOW_ROUNDS - 2,
                                                   replace=False)]
                 + [f"probe20_{r}" for r in range(FOLLOW_ROUNDS)]
                 + [f"cob20_{r}_{j}" for r in range(FOLLOW_ROUNDS) for j in range(3)]
                 + ["cob20_kill_0", "never-seen"])
        differ = sum(post_raw(pub_url, {"user": u, "num": 20})
                     != post_raw(sub_url, {"user": u, "num": 20}) for u in users)
        check(differ == 0, f"20: {differ} of {len(users)} answers differ between the "
                           "publisher and the subscriber")

        # a fresh reader of the subscriber's plane, in this process
        t1 = time.perf_counter()
        reader = plane_mod.ModelPlane(str(sub_dir), device="cpu")
        got, info = reader.load(reader.current())
        out["fresh_compose_s"] = time.perf_counter() - t1
        check(info["planeGeneration"] == state.plane_generation,
              f"20: the subscriber's plane holds {info['planeGeneration']}")
        (live,) = state.models
        bad = plane_differences(got, live) + plane_differences(got, fstate.model)
        check(not bad, f"20: the subscriber's composed generation differs in {bad}")
        out["memory_last"] = memory_split(mem_base, card_memory(dev))
        fr = state.freshness()
        out.update({
            "answers": len(users), "generation": state.plane_generation,
            "publish_bytes": {p: pub_bytes.value(path=p) - b0[p]
                              for p in ("full", "delta", "ref")},
            "resyncs": {k: resync.value(reason=k) for k in reasons},
            "publisher_replication": fr.get("replication"),
            "publishes": len(publishes),
            "launches": follow_counts(hk)})
        print(f"  {len(users)} answers byte-equal between the publisher and the subscriber; "
              f"a fresh ModelPlane composed the subscriber's generation "
              f"{info['planeGeneration']} in {out['fresh_compose_s']:.3f} s, every array, "
              f"dictionary and the properties bit-equal to the publisher's live model and "
              f"its fold's; publish bytes by path {out['publish_bytes']} over "
              f"{len(publishes)} publishes; card memory: {out['memory_last']}")
    finally:
        server.shutdown()
        server.server_close()
        proc = sub["proc"]
        if proc is not None and proc.poll() is None:
            proc.send_signal(signal.SIGINT)
            try:
                rc = proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30)
                rc = None
            out["subscriber_exit"] = rc
        restore_env(saved_obs)
    check(out.get("subscriber_exit") == 0,
          f"20: the subscriber exited {out.get('subscriber_exit')} on SIGINT: "
          f"{log_path.read_text()[-2000:]}")
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"  phase 20 wall {out['wall_s']:.3f} s")
    return out


# -- phase 22: pio dashboard on phase 11b's store -----------------------------------


def dashboard_path(workdir, env) -> dict:
    """Phase 22: ``pio dashboard`` (a subprocess) on phase 11b's localfs
    store: ``/dashboard.json`` lists the store's engine instances and
    evaluations as the store holds them, the index page lists 11b's trains
    and the span breakdowns of the trains it shows, ``/spans/<id>.json``
    serves each of 11b's train journals, and SIGINT stops it with exit 0."""
    import signal

    from predictionio_tpu_torch.storage import Storage, StorageConfig

    t0 = time.perf_counter()
    store = Storage(StorageConfig(
        sources={"FS": {"type": "localfs", "path": env["PIO_STORAGE_SOURCES_FS_PATH"]}},
        repositories={r: "FS" for r in ("METADATA", "EVENTDATA", "MODELDATA")}))
    root = Path(__file__).resolve().parent
    port = free_port()
    base = f"http://127.0.0.1:{port}"
    log_path = workdir / "dashboard.log"
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "predictionio_tpu_torch.cli.main", "dashboard", "--ip",
             "127.0.0.1", "--port", str(port)], cwd=root,
            env={**os.environ, **env, "PYTHONPATH": str(root)}, stdout=log,
            stderr=subprocess.STDOUT)
    try:
        deadline = time.monotonic() + 120
        while True:
            check(proc.poll() is None, f"22: pio dashboard exited: {log_path.read_text()[-2000:]}")
            try:
                doc = get_json(base + "/dashboard.json", timeout=10)
                break
            except (urllib.error.URLError, ConnectionError, OSError):
                check(time.monotonic() < deadline, "22: pio dashboard never answered")
                time.sleep(0.2)
        up_s = time.perf_counter() - t0
        want = sorted((i.id, i.status, i.engine_id) for i in store.engine_instances.get_all())
        got = sorted((e["id"], e["status"], e["engineId"]) for e in doc["engineInstances"])
        check(got == want, f"22: /dashboard.json lists {len(got)} engine instances, the store "
                           f"{len(want)}")
        evals = sorted(i.id for i in store.evaluation_instances.get_completed())
        check(sorted(e["id"] for e in doc["evaluations"]) == evals,
              "22: /dashboard.json's evaluations differ from the store's")
        trains = [i for i in store.engine_instances.get_all()
                  if i.engine_id in (engine_variant(False)["id"], engine_variant(True)["id"])
                  and i.status == "COMPLETED"]
        check(trains, "22: no 11b train in the store")
        with urllib.request.urlopen(base + "/", timeout=60) as resp:
            page = resp.read().decode()
        missing = [i.id for i in trains if i.id[:12] not in page]
        check(not missing, f"22: the index lacks 11b's trains {missing}")
        check("engine_train: " in page and "save_models: " in page,
              "22: the index shows no train span breakdown")
        breakdowns = {}
        for i in trains:
            spans = get_json(f"{base}/spans/{i.id}.json")["spans"]
            names = {s["name"]: s["duration_s"] for s in spans}
            check({"train", "engine_train", "staging_summary", "save_models"} <= set(names),
                  f"22: /spans/{i.id}.json holds {sorted(names)}")
            breakdowns[i.id] = names
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=60)
        check(rc == 0, f"22: pio dashboard exited {rc} on SIGINT")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    out = {"up_s": up_s, "engine_instances": len(got), "evaluations": len(evals),
           "trains_11b": breakdowns, "wall_s": time.perf_counter() - t0}
    print(f"  pio dashboard answered {up_s:.3f} s after its start; /dashboard.json lists the "
          f"store's {len(got)} engine instances and {len(evals)} evaluations; the index lists "
          f"11b's {len(trains)} trains with span breakdowns: "
          + "; ".join(f"{k[:12]} " + ", ".join(f"{n} {v:.3f} s" for n, v in sorted(b.items()))
                      for k, b in breakdowns.items())
          + f"; SIGINT, exit 0; phase 22 wall {out['wall_s']:.3f} s")
    return out


# -- phase 21: the sharded, replicated store streaming uses ---------------------------

SHARDED = (2, 2)            # phase 21's events: shards, replicas (strict acknowledgement)
#: phase 21's events: the deployed width's users and items, 3/8 of its
#: interactions (cut for the time limit; the tiles and K2/K3 shapes are 11b's)
SHARDED_UR = DEPLOYED_UR[:2] + (150_000, 300_000) + DEPLOYED_UR[4:]
SHARDED_PROMOTE_AFTER = 1   # the round after which shard 0's primary node is taken away:
                            # the next round spans the new replica's re-sync
SHARDED_PROBES = 200        # answers held byte-equal to a card retrain


def sharded_env(workdir):
    """Phase 21's ``PIO_STORAGE_*``: EVENTDATA on ``sharded`` (SHARDED), METADATA
    on ``sql`` (one SQLite file), MODELDATA on ``sharedfs``."""
    shards, replicas = SHARDED
    return {"PIO_STORAGE_SOURCES_EV_TYPE": "sharded",
            "PIO_STORAGE_SOURCES_EV_PATH": str(workdir / "sharded"),
            "PIO_STORAGE_SOURCES_EV_SHARDS": str(shards),
            "PIO_STORAGE_SOURCES_EV_REPLICAS": str(replicas),
            "PIO_STORAGE_SOURCES_META_TYPE": "sql",
            "PIO_STORAGE_SOURCES_META_PATH": str(workdir / "meta.db"),
            "PIO_STORAGE_SOURCES_MODELS_TYPE": "sharedfs",
            "PIO_STORAGE_SOURCES_MODELS_PATH": str(workdir / "models"),
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "EV",
            "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "META",
            "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MODELS"}


def host_tables(model) -> dict:
    """A UR model's indicator tables on the host, ids as item strings."""
    out = {"items": model.item_dict.strings()}
    for name in model.indicator_idx:
        out[name] = (model.event_item_dicts[name].strings(),
                     np.array(model.indicator_idx[name]), np.array(model.indicator_llr[name]))
    return out


def tables_equal_up_to_ids(got, want, what) -> dict:
    """Two UR trains of the same events whose dictionaries differ in order: for
    every primary item, its row's LLR scores are the same bits in the same
    order, and the column items the same, but among equal scores (whose order
    follows the dictionary, and which may cross the top-k edge)."""
    row_of = {s: r for r, s in enumerate(got["items"])}
    check(sorted(got["items"]) == sorted(want["items"]), f"{what}: the item sets differ")
    perm = np.array([row_of[s] for s in want["items"]], np.int64)
    stats = {}
    for name in ("purchase", "view"):
        g_cols, g_idx, g_llr = got[name]
        w_cols, w_idx, w_llr = want[name]
        g_idx, g_llr = g_idx[perm], g_llr[perm]
        check(np.array_equal(g_llr.view(np.int32), w_llr.view(np.int32)),
              f"{what} {name}: the LLR scores differ, row for row")
        check(np.array_equal(g_idx < 0, w_idx < 0), f"{what} {name}: the padding differs")
        g_str = np.array(g_cols + [""], dtype=object)[g_idx]
        w_str = np.array(w_cols + [""], dtype=object)[w_idx]
        diff = g_str != w_str
        rows = np.flatnonzero(diff.any(axis=1))
        for r in rows:
            for v in np.unique(w_llr[r][diff[r]]):
                at = w_llr[r] == v
                edge = at[-1]   # ties at the top-k edge: the members may differ
                same = (set(g_str[r][at]) == set(w_str[r][at])) if not edge else True
                check(same, f"{what} {name}: row {want['items'][r]} differs at score {v}")
        stats[name] = {"rows_reordered_among_ties": int(len(rows)),
                       "cells_differing_among_ties": int(diff.sum())}
    return stats


def shard_node_bytes(store, shard, node, app_id) -> bytes:
    """Every byte of ``node``'s segments of ``shard`` (acknowledged event ids
    are looked for in them)."""
    ev = store.l_events._shards[shard].events(node)
    return b"".join(p.read_bytes() for p in ev.segment_paths(app_id))


def follower_drained_exactly(follower, covered) -> bool:
    """``follower_drained``, where a follower past ``covered`` fails at once:
    it has read some event twice."""
    got = follower.status()["coveredEvents"] or 0
    check(got <= covered, f"21: the follower covers {got} events, {covered} were written")
    return follower_drained(follower, covered)


def same_rows(got, want) -> bool:
    """Two batches hold the same rows, each as often, in any order: every
    row's event, entity type, entity, target, time and rating, the
    dictionaries compared through their strings."""
    if len(got) != len(want):
        return False
    cols = []
    for d, codes in (("event_dict", "event_codes"), ("entity_type_dict", "entity_type_codes"),
                     ("entity_dict", "entity_ids"), ("target_dict", "target_ids")):
        # got's codes as want's; a string want lacks reads -2
        remap = getattr(want, d).lookup_many(getattr(got, d).strings())
        remap = np.append(np.where(remap < 0, -2, remap), np.int32(-1)).astype(np.int64)
        cols.append((remap[getattr(got, codes)], getattr(want, codes).astype(np.int64)))
    cols.append((got.times_us, want.times_us))
    cols.append((got.ratings.view(np.int32), want.ratings.view(np.int32)))
    g_order = np.lexsort([c[0] for c in cols])
    w_order = np.lexsort([c[1] for c in cols])
    return all(np.array_equal(g[g_order], w[w_order]) for g, w in cols)


class FollowerRead:
    """The event store as the follower read it: ``snapshot_scan`` answers with
    the follower's batch, watermark and heads, everything else is the
    store's.  Staged through the retrain cache, it leaves the entry a
    training read of the same events in the same order would have left."""

    def __init__(self, events, follower):
        self._events, self._follower = events, follower

    def __getattr__(self, name):
        return getattr(self._events, name)

    def snapshot_scan(self, app_id, channel_id=None):
        f = self._follower
        return {"batch": f._fold.batch, "watermark": dict(f._wm), "heads": dict(f._heads)}


def sharded_path(ur, hk, dev, workdir, variants):
    """Phase 21: SHARDED_UR's events (11b's catalog and item properties,
    fewer interactions) through the backends streaming runs on: EVENTDATA
    ``sharded`` (SHARDED, strict acknowledgement), METADATA ``sql``,
    MODELDATA ``sharedfs``.  ``pio app new`` → ``pio import`` → the cold
    merged scan (two scan workers) → ``pio train`` (50 K2 + 50 K3 launches;
    tables equal those ``URAlgorithm.train`` gives on the same events through
    ``ur_training_data_from_arrays``, ids through the dictionaries) →
    ``deploy(follow=)`` in this process with an
    event server on the same store; FOLLOW_ROUNDS freshness rounds posted as
    HTTP batches, shard 0's primary node taken away after round
    SHARDED_PROMOTE_AFTER (one promotion, every event answered 201 on the new
    primary, the follower folds on; it never covers more events than were
    written).  After the drain the follower covers the import and every
    event answered 201, once each, and its rows are those of a cold read of
    the store; a card retrain of the follower's read equals the live tables
    bit for bit, and SHARDED_PROBES answers are byte-equal; the replica lag
    ends at 0."""
    import gc

    from predictionio_tpu_torch.api.event_server import run_event_server
    from predictionio_tpu_torch.storage import get_storage, set_storage
    from predictionio_tpu_torch.storage import sharded as sharded_mod
    from predictionio_tpu_torch.store import event_store
    from predictionio_tpu_torch.store.event_store import (
        invalidate_staging_cache,
        staging_counts,
    )
    from predictionio_tpu_torch.streaming import follow as follow_mod
    from predictionio_tpu_torch.workflow.core_workflow import load_latest_models
    from predictionio_tpu_torch.workflow.create_server import deploy
    from predictionio_tpu_torch.workflow.create_workflow import engine_from_variant

    t_phase = time.perf_counter()
    out = {}
    n_users, n_items, n_p, n_v, top_k, tile = SHARDED_UR
    arrays = deployed_arrays(SHARDED_UR)
    props = item_properties(item_columns(n_items))
    jsonl = workdir / "events21.jsonl"
    write_jsonl(jsonl, arrays, props)
    params = ur.URAlgorithmParams.from_json(engine_variant(False)["algorithms"][0]["params"])
    want_tables = host_tables(ur.URAlgorithm(params, device=dev).train(
        expected_training_data(ur, arrays, props, SHARDED_UR)))
    del arrays, props
    env = {**sharded_env(workdir), "PIO_TORCH_DEVICE": dev.type}
    saved = {k: os.environ.get(k) for k in
             [k for k in os.environ if k.startswith("PIO_STORAGE_")] + list(env)}
    for k in saved:
        os.environ.pop(k, None)
    os.environ.update(env)
    set_storage(None)
    store = None
    try:
        pio("app", "new", "smoke")
        t0 = time.perf_counter()
        pio("import", "--app-name", "smoke", "--input", str(jsonl))
        out["import_s"] = time.perf_counter() - t0
        n_events = n_p + n_v + n_items
        out["import_events_per_s"] = n_events / out["import_s"]
        store = get_storage()
        events = store.l_events
        check(isinstance(events, sharded_mod.ShardedEvents)
              and (events.n_shards, events.replicas) == SHARDED,
              f"21: EVENTDATA is {type(events).__name__}, not a {SHARDED} sharded store")
        app_id = store.apps.get_by_name("smoke").id
        per_shard = [len(list(sh.events().segment_paths(app_id))) for sh in events._shards]
        print(f"  pio import of {n_events} events (11b's catalog, {n_p} purchases and {n_v} "
              f"views) in {out['import_s']:.3f} s "
              f"({out['import_events_per_s']:.0f} events/s) into {SHARDED[0]} shards x "
              f"{SHARDED[1]} nodes, strict acknowledgement (PIO_STORE_ACK_REPLICAS "
              f"{sharded_mod._ack_replicas()}); primary segments a shard {per_shard}")

        # the cold merged scan (two workers, per-shard seconds), through the
        # staged retrain cache, which keeps the batch for pio train's read
        invalidate_staging_cache()
        t0 = time.perf_counter()
        staged = event_store._STAGED.staged_batch(events, app_id, None)
        out["cold_scan_s"] = time.perf_counter() - t0
        out["cold_scan_events_per_s"] = len(staged) / out["cold_scan_s"]
        out["scan_workers"] = sharded_mod._M_SCAN_WORKERS.value()
        out["scan_shard_s"] = [sharded_mod._M_SCAN_SHARD_S.value(shard=str(k))
                               for k in range(SHARDED[0])]
        check(len(staged) == n_events, f"21: the cold scan read {len(staged)} events")
        check(out["scan_workers"] == 2,
              f"21: pio_store_scan_workers read {out['scan_workers']} on the cold scan, not 2")
        print(f"  cold merged scan (fan-out on {out['scan_workers']:.0f} workers + BatchMerger, "
              f"no snapshot: each shard's log parsed): {len(staged)} events in "
              f"{out['cold_scan_s']:.3f} s ({out['cold_scan_events_per_s']:.0f} events/s); "
              f"per-shard scan seconds {[round(x, 4) for x in out['scan_shard_s']]}; gauge "
              f"pio_store_scan_merged_events_per_sec {sharded_mod._M_SCAN_RATE.value():.0f}")
        del staged

        # pio train: K2/K3 a tile, tables against the arrays path's
        tiles = 2 * -(-n_items // tile)
        pio("build", "--engine-json", str(variants[False]))
        torch.cuda.synchronize()
        with hk._count_lock:
            hk.llr_masked_scores.launches = hk.tile_topk_desc.launches = 0
        deltas = staging_counts()["delta"]
        t0 = time.perf_counter()
        pio("train", "--engine-json", str(variants[False]))
        out["train_s"] = time.perf_counter() - t0
        check(staging_counts()["delta"] == deltas,
              "21: pio train staged events past the cold scan's watermark")
        train_launches = out["train_launches"] = follow_counts(hk)
        check(train_launches == (tiles, tiles),
              f"21: pio train launched K2/K3 {train_launches}, expected {tiles} each")
        _, (model,) = load_latest_models(engine_variant(False)["id"], device=dev)
        out["tables"] = tables_equal_up_to_ids(host_tables(model), want_tables,
                                               "21: the sharded train against the arrays "
                                               "path's")
        del model
        print(f"  pio train {out['train_s']:.3f} s (its read served by the staged cache the cold "
              f"scan filled; train, save to sharedfs, instance in SQLite), K2/K3 launches "
              f"{train_launches}; tables equal URAlgorithm.train's on the same events "
              f"from the arrays, ids through the dictionaries: LLR bits row for row, column items "
              f"equal but among ties ({out['tables']})")
        gc.collect()
        torch.cuda.empty_cache()

        # deploy(follow=) with an event server on the same store
        key = store.access_keys.get_by_app_id(app_id)[0].key
        promos = sharded_mod._M_PROMOTIONS
        p0 = sum(promos.value(shard="0", reason=r) for r in ("primary-missing", "io-error"))
        folds = follow_mod._M_FOLDS
        outcomes = ("fold", "retrain", "restage", "idle", "error", "disabled")
        f0 = {o: folds.value(outcome=o) for o in outcomes}
        with hk._count_lock:
            hk.llr_masked_scores.launches = hk.tile_topk_desc.launches = 0
        t0 = time.perf_counter()
        server = deploy(str(variants[False]), host="127.0.0.1", port=0, device=dev,
                        follow=FOLLOW_INTERVAL_S)
        es = run_event_server(host="127.0.0.1", port=0, storage=store, background=True)
        try:
            follower = server.pio_state.follower
            check(follower is not None and follower.mode == "fold",
                  "21: deploy(follow=) hosts no fold-mode follower on the sharded store")
            url = f"http://127.0.0.1:{server.server_address[1]}/queries.json"
            es_url = (f"http://127.0.0.1:{es.server_address[1]}/batch/events.json"
                      f"?accessKey={key}")
            wait_until(lambda: follower.generation >= 1
                       and follower.status()["lastOutcome"] == "idle", 600, "21: the bootstrap")
            out["bootstrap_s"] = time.perf_counter() - t0
            covered = len(follower._fold.batch)
            check(covered == n_events, f"21: the follower bootstrapped {covered} events, "
                  f"the store holds {n_events}")
            acked = []     # (event id, shard) of every event answered 201

            def append(evs):
                body = [{"event": "purchase", "entityType": "user", "entityId": u,
                         "targetEntityType": "item", "targetEntityId": it} for u, it in evs]
                got = post(es_url, body)
                check(all(r.get("status") == 201 for r in got), f"21: an append answered {got}")
                acked.extend((r["eventId"], sharded_mod.shard_of("user", u, SHARDED[0]))
                             for r, (u, _) in zip(got, evs))

            lat_ms = []
            for r in range(FOLLOW_ROUNDS):
                seed, fresh, probe = f"seed21_{r}", f"fresh21_{r}", f"probe21_{r}"
                append([(probe, seed)])
                covered += 1
                wait_until(lambda: follower_drained_exactly(follower, covered), 120,
                           f"21: round {r}'s probe fold")
                cobuyers = [f"cob21_{r}_{j}" for j in range(FOLLOW_COBUYERS)]
                t_append = time.perf_counter()
                append([(u, it) for u in cobuyers for it in (seed, fresh)])
                covered += 2 * FOLLOW_COBUYERS
                reflected = None
                while time.perf_counter() - t_append < FOLLOW_CAP_S:
                    got = post(url, {"user": probe, "num": 30})
                    if any(x["item"] == fresh for x in got["itemScores"]):
                        reflected = (time.perf_counter() - t_append) * 1e3
                        break
                    time.sleep(0.01)
                check(reflected is not None,
                      f"21: round {r}: {fresh} not reflected within {FOLLOW_CAP_S} s")
                wait_until(lambda: follower_drained_exactly(follower, covered), 120,
                           f"21: round {r}'s drain")
                lat_ms.append(reflected)
                print(f"  round {r}: {fresh} reflected {reflected:.3f} ms after the append")
                if r == SHARDED_PROMOTE_AFTER - 1:
                    # take shard 0's primary node away; the next write to
                    # shard 0 promotes its replica and re-syncs a new one
                    sh0 = events._shards[0]
                    old = sh0.topology(force=True)["primary"]
                    t_yank = time.perf_counter()
                    os.rename(sh0.node_root(old), workdir / f"yanked-shard0-{old}")
                    u0 = next(f"promo21_{j}" for j in range(10_000)
                              if sharded_mod.shard_of("user", f"promo21_{j}", SHARDED[0]) == 0)
                    append([(u0, "i0")])
                    covered += 1
                    out["promotion_to_acked_write_s"] = time.perf_counter() - t_yank
                    new = sh0.topology(force=True)["primary"]
                    check(new != old, f"21: shard 0's primary is still {old}")
                    wait_until(lambda: follower_drained_exactly(follower, covered), 120,
                               "21: the fold after the promotion")
                    print(f"  shard 0: node {old} taken away; promoted to {new} and the next "
                          f"write acknowledged {out['promotion_to_acked_write_s']:.3f} s "
                          f"later (promotion and re-sync of a fresh replica included)")
            p1 = sum(promos.value(shard="0", reason=r) for r in ("primary-missing", "io-error"))
            check(p1 - p0 == 1, f"21: pio_store_promotions_total{{shard=0}} rose by {p1 - p0}")
            tick = {o: folds.value(outcome=o) - f0[o] for o in outcomes}
            check(tick["error"] == 0 and tick["fold"] >= 2 * FOLLOW_ROUNDS,
                  f"21: follow ticks {tick}")
            out["launches"] = follow_counts(hk)
            check(out["launches"][0] > 0 and out["launches"][1] > 0,
                  f"21: the follower launched K2/K3 {out['launches']}")
            # every event answered 201 is on its shard's primary
            primary0 = events._shards[0].topology(force=True)["primary"]
            blobs = {k: shard_node_bytes(store, k, events._shards[k].topology()["primary"],
                                       app_id) for k in range(SHARDED[0])}
            lost = [eid for eid, k in acked if f'"eventId":"{eid}"'.encode() not in blobs[k]]
            check(not lost, f"21: {len(lost)} of {len(acked)} acknowledged events are not on "
                  f"their shard's primary (shard 0 on node {primary0})")
            p50, p99 = np.percentile(lat_ms, 50), np.percentile(lat_ms, 99)
            out.update({"reflected_ms": lat_ms, "p50_ms": float(p50), "p99_ms": float(p99),
                        "gate_ms": FOLLOW_GATE_S * 1e3, "ticks": tick, "acked": len(acked),
                        "promotions": p1 - p0})
            check(p99 <= FOLLOW_GATE_S * 1e3, f"21: append -> reflected p99 {p99:.3f} ms")
            print(f"  append -> reflected over {FOLLOW_ROUNDS} rounds: p50 {p50:.3f} ms, p99 "
                  f"{p99:.3f} ms against the {FOLLOW_GATE_S:g} s gate; follow ticks {tick}; "
                  f"{len(acked)} events answered 201, every one on its shard's primary; "
                  f"pio_store_promotions_total{{shard=0}} +{p1 - p0}; K2/K3 launches of the "
                  f"follower {out['launches']}")

            # the drain: the follower covers the import and every event
            # answered 201, each once; a cold read of the store holds the
            # same rows
            (live,) = server.pio_state.models
            check(covered == n_events + len(acked)
                  and follower.status()["coveredEvents"] == covered
                  and len(follower._fold.batch) == covered,
                  f"21: the follower covers {follower.status()['coveredEvents']} events "
                  f"({len(follower._fold.batch)} rows), the store {n_events} + {len(acked)}")
            invalidate_staging_cache()
            t1 = time.perf_counter()
            cold = event_store._STAGED.staged_batch(events, app_id, None)
            out["drain_cold_scan_s"] = time.perf_counter() - t1
            # (a cold read is shard-major, the follower spliced each tick's
            # tail after its base: the same rows in other orders, so a cold
            # retrain's dictionaries differ in order from the live model's)
            check(same_rows(follower._fold.batch, cold),
                  f"21: the follower's {len(follower._fold.batch)} rows are not the "
                  f"{len(cold)} rows of a cold read of the store")
            del cold
            # a card retrain of the follower's read (its rows in its order,
            # staged through the cache, with the store's delta past its
            # watermark, which must be empty) equals the live model bit for bit
            invalidate_staging_cache()
            _, engine, ep = engine_from_variant(engine_variant(False))
            event_store._STAGED.staged_batch(FollowerRead(events, follower), app_id, None)
            deltas = staging_counts()["delta"]
            t1 = time.perf_counter()
            (ref,) = engine.train(ep, device=dev)
            out["retrain_s"] = time.perf_counter() - t1
            check(staging_counts()["delta"] == deltas,
                  "21: the store holds events past the follower's watermark after the drain")
            check(ref.item_dict.strings() == live.item_dict.strings(),
                  "21: the live item dictionary differs from the card retrain's")
            for name in ref.indicator_idx:
                check(live.event_item_dicts[name].strings()
                      == ref.event_item_dicts[name].strings()
                      and np.array_equal(live.indicator_idx[name], ref.indicator_idx[name])
                      and np.array_equal(live.indicator_llr[name].view(np.int32),
                                         ref.indicator_llr[name].view(np.int32)),
                      f"21: the live {name} table differs from a card retrain")
            check(np.array_equal(np.asarray(live.popularity), np.asarray(ref.popularity)),
                  "21: the live popularity differs from the card retrain's")
            invalidate_staging_cache()
            rng = np.random.default_rng(SEED + 210)
            users = ([f"u{int(u)}" for u in rng.choice(
                n_users, SHARDED_PROBES - FOLLOW_ROUNDS - 1, replace=False)]
                + [f"probe21_{r}" for r in range(FOLLOW_ROUNDS)] + ["never-seen"])
            algo = engine.make_components(ep, device=dev)[2][0]
            differ = 0
            for u in users:
                body = {"user": u, "num": 20}
                want = json.dumps(algo.predict(ref, ur.URQuery.from_json(body)).to_json())
                differ += post_raw(url, body) != want.encode()
            check(differ == 0, f"21: {differ} of {len(users)} answers differ from the retrain's")
            del ref, live
            print(f"  after the drain: the follower covers {covered} events, the import and "
                  f"every event answered 201 once, the rows of a cold read of the store "
                  f"({out['drain_cold_scan_s']:.3f} s); a card retrain of those rows in the "
                  f"follower's order ({out['retrain_s']:.3f} s, no event past its watermark) "
                  f"is bit-identical to the live model; {len(users)} answers byte-equal")
        finally:
            es.shutdown()
            es.server_close()
            server.shutdown()
            server.server_close()
        wait_until(lambda: all(s["replicaLagEvents"] == 0
                               for s in events.topology_status()["perShard"]), 60,
                   "21: the replicas to catch up")
        out["topology"] = events.topology_status()
        out["replica_lag_end"] = [s["replicaLagEvents"] for s in out["topology"]["perShard"]]
        print(f"  topology at the end: {out['topology']}")
    finally:
        if store is not None:
            store.l_events.close()
        for k in env:
            os.environ.pop(k, None)
        restore_env(saved)
        set_storage(None)
        jsonl.unlink(missing_ok=True)
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"  phase 21 wall {out['wall_s']:.3f} s")
    return out


def refused(url, body) -> int:
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status
    except urllib.error.HTTPError as e:
        return e.code


# -- phases 12b-12d: ALS training, its checkpoint/resume, the e-commerce template --


def shop_arrays():
    """The shop both ALS templates train on, from the seed: DEPLOYED_ALS's
    ``rate`` events (ratings 1-5) covering the catalog then uniform items,
    its ``buy`` events on zipf-popular items, ECOMM_VIEWS ``view`` events
    covering the catalog then zipf items, and one or two of N_CATEGORIES
    categories an item (zipf-skewed)."""
    n_users, n_items, n_rate, n_buy, _, _ = DEPLOYED_ALS
    rng = np.random.default_rng(SEED + 5)
    cover = np.arange(n_items)
    shop = {
        "rate": (rng.integers(0, n_users, n_rate),
                 np.concatenate([cover, rng.integers(0, n_items, n_rate - n_items)]),
                 rng.integers(1, 6, n_rate)),
        "buy": (rng.integers(0, n_users, n_buy), rng.zipf(1.3, n_buy) % n_items, None),
        "view": (rng.integers(0, n_users, ECOMM_VIEWS),
                 np.concatenate([cover, rng.zipf(1.2, ECOMM_VIEWS - n_items) % n_items]),
                 None),
    }
    first = (rng.zipf(1.3, n_items) - 1) % N_CATEGORIES
    second = np.where(rng.random(n_items) < 0.4,
                      (first + rng.integers(1, N_CATEGORIES, n_items)) % N_CATEGORIES, -1)
    shop["categories"] = np.stack([first, second], 1)
    return shop


def write_shop_jsonl(path, shop):
    """``shop`` as a JSON-lines file for ``pio import``: one ``$set`` of
    ``categories`` an item, then the rate, buy and view events one a
    second from T0 (lines by one format string an event type)."""
    t = iso(T0 - 1)
    t_next = T0
    with open(path, "w") as f:
        f.writelines(json.dumps({"event": "$set", "entityType": "item", "entityId": f"i{j}",
                                 "properties": {"categories": [f"c{c}" for c in cs if c >= 0]},
                                 "eventTime": t, "creationTime": t}) + "\n"
                     for j, cs in enumerate(shop["categories"].tolist()))
        for name in ("rate", "buy", "view"):
            users, items, ratings = shop[name]
            times = t_next + np.arange(len(users), dtype=np.float64)
            t_next += len(users)
            iso_t = np.datetime_as_string(times.astype(np.int64).astype("datetime64[s]"),
                                          timezone="UTC").tolist()
            props = "" if ratings is None else ',"properties":{"rating":%d}'
            line = ('{"event":"%s","entityType":"user","entityId":"u%%d","targetEntityType":'
                    '"item","targetEntityId":"i%%d"%s,"eventTime":"%%s","creationTime":"%%s"}\n'
                    % (name, props))
            cols = [users.tolist(), items.tolist()] + (
                [] if ratings is None else [ratings.tolist()]) + [iso_t, iso_t]
            f.writelines(map(line.__mod__, zip(*cols)))


def als_variant(engine_id="smoke-als", **extra):
    _, _, _, _, rank, iters = DEPLOYED_ALS
    return {"id": engine_id, "engineFactory": "recommendation",
            "datasource": {"params": {"appName": "shop", "eventNames": ["rate", "buy"]}},
            "algorithms": [{"name": "als", "params": {
                "rank": rank, "numIterations": iters, "lambda": ALS_LAMBDA, "seed": 7,
                **extra}}]}


def ecomm_variant():
    _, _, _, _, rank, iters = DEPLOYED_ALS
    return {"id": "smoke-ecomm", "engineFactory": "ecommerce",
            "datasource": {"params": {"appName": "shop", "eventNames": ["view", "buy"]}},
            "algorithms": [{"name": "ecomm", "params": {
                "appName": "shop", "rank": rank, "numIterations": iters,
                "lambda": ALS_LAMBDA, "alpha": 1.0, "seed": 7, "unseenOnly": True}}]}


@contextlib.contextmanager
def pio_deploy_here(engine_json):
    """``pio deploy`` of ``engine_json`` on a thread of this process (so
    the launch counters can be read); yields (base url, seconds to its
    first answer of ``GET /``).  On leaving, ``pio undeploy`` must stop it
    and its command must return 0."""
    from predictionio_tpu_torch.cli.main import main as pio_main

    port = free_port()
    rc = []
    thread = threading.Thread(target=lambda: rc.append(pio_main(
        ["deploy", "--engine-json", str(engine_json), "--ip", "127.0.0.1",
         "--port", str(port)])), daemon=True)
    t0 = time.perf_counter()
    thread.start()
    base = f"http://127.0.0.1:{port}"
    try:
        while True:
            check(thread.is_alive(), f"pio deploy returned {rc}")
            check(time.perf_counter() - t0 < DEPLOY_TIMEOUT_S, "pio deploy did not answer")
            try:
                get_json(base + "/", timeout=5)
                break
            except (urllib.error.URLError, ConnectionError):
                time.sleep(0.1)
        yield base, time.perf_counter() - t0
    finally:
        if thread.is_alive():
            pio("undeploy", "--port", str(port), "--timeout", "60")
            thread.join(DEPLOY_TIMEOUT_S)
    check(not thread.is_alive() and rc == [0], f"pio deploy returned {rc}")


def host_half_step(events, fixed, reg, rows):
    """Float64 direct solves of the explicit normal equations of ``rows``:
    ``events`` is (owner, other, rating) of one side, ``fixed`` the other
    side's factors."""
    owner, other, rating = events
    out = {}
    for r in rows:
        sel = owner == r
        y = fixed[other[sel]].astype(np.float64)
        a = y.T @ y + (reg * max(int(sel.sum()), 1) + 1e-6) * np.eye(fixed.shape[1])
        out[r] = np.linalg.solve(a, y.T @ rating[sel].astype(np.float64))
    return out


def check_half_step(als_ops, pd, model, dev):
    """One half-step of each side on the card, from the trained factors,
    against float64 direct solves on 64 sampled rows (the widest row
    among them); returns the largest error over a row's largest entry."""
    n_users, n_items = len(pd.user_dict), len(pd.item_dict)
    data = als_ops.prepare_als_data(pd.user_idx, pd.item_idx, pd.rating, n_users,
                                    n_items, dp=1)
    (user_plan,), (item_plan,) = als_ops._als_device_args(data, model.item_factors.shape[1], dev)
    rng = np.random.default_rng(SEED + 6)
    worst = 0.0
    for plan, fixed, owner, other, n in (
            (user_plan, model.item_factors, pd.user_idx, pd.item_idx, n_users),
            (item_plan, model.user_factors, pd.item_idx, pd.user_idx, n_items)):
        got = als_ops.solve_half(plan, torch.tensor(fixed, device=dev), ALS_LAMBDA).cpu().numpy()
        rows = np.unique(np.concatenate([rng.choice(n, 63, replace=False),
                                         [np.bincount(owner, minlength=n).argmax()]]))
        want = host_half_step((owner, other, pd.rating), fixed, ALS_LAMBDA, rows)
        for r, x in want.items():
            err = float(np.abs(got[r] - x).max() / max(np.abs(x).max(), 1e-30))
            check(err <= HALF_STEP_RTOL, f"half-step row {r}: error {err:.3g} of its largest "
                  f"entry against the float64 solve (bar {HALF_STEP_RTOL})")
            worst = max(worst, err)
    return worst


def als_reference_host(model, body):
    """The query scored on the host in float64 from the model's factors and
    seen lists, ranked by (score desc, item id asc)."""
    uid = model.user_dict.id(str(body["user"]))
    if uid is None:
        return [], None
    s = model.item_factors.astype(np.float64) @ model.user_factors[uid].astype(np.float64)
    if body.get("unseenOnly"):
        s[model.seen.row(uid)] = -np.inf
    for b in body.get("blackList", []):
        if model.item_dict.id(b) is not None:
            s[model.item_dict.id(b)] = -np.inf
    n = min(int(body.get("num", 10)), len(s))
    if n == 0:
        return [], s
    # the n-th largest score, then (score desc, id asc) among the items at
    # or above it: the full order's first n, ties included
    cand = np.flatnonzero(s >= np.partition(s, len(s) - n)[len(s) - n])
    order = cand[np.lexsort((cand, -s[cand]))][:n]
    return [(model.item_dict.str(int(i)), float(s[i])) for i in order if np.isfinite(s[i])], s


def als_path(reco, als_ops, hk, dev, workdir):
    """Phase 12b: the deployed ALS width through localfs and ``pio``."""
    from predictionio_tpu_torch.storage import get_storage
    from predictionio_tpu_torch.workflow.core_workflow import load_latest_models
    from predictionio_tpu_torch.workflow.create_workflow import engine_from_variant

    n_users, n_items, n_rate, n_buy, rank, iters = DEPLOYED_ALS
    shop = shop_arrays()
    t = {}
    jsonl = workdir / "shop.jsonl"
    write_shop_jsonl(jsonl, shop)
    pio("app", "new", "shop")
    t0 = time.perf_counter()
    pio("import", "--app-name", "shop", "--input", str(jsonl))
    t["import_s"] = time.perf_counter() - t0
    n_events = n_rate + n_buy + ECOMM_VIEWS + n_items
    print(f"  shop: {n_events} events ({n_rate} rate, {n_buy} buy, {ECOMM_VIEWS} view, "
          f"{n_items} $set categories) imported in {t['import_s']:.3f} s")
    jsonl.unlink()
    path = workdir / "als.json"
    path.write_text(json.dumps(als_variant()))
    pio("build", "--engine-json", str(path))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    pio("train", "--engine-json", str(path))
    t["pio_train_s"] = time.perf_counter() - t0
    t["pio_train_peak_device_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    _, (model,) = load_latest_models("smoke-als", device=dev)
    check(model.device == dev, "load_latest_models: the ALS model is off the card")

    # the same port train on the CPU, from the same generator
    _, engine, ep = engine_from_variant(als_variant())
    data_source, preparator, _, _ = engine.make_components(ep)
    pd = preparator.prepare(data_source.read_training())
    # the localfs read keeps the whole scan's dictionaries (as the JAX
    # package's does), so the user ids include the app's other entities:
    # their rows have no ratings and solve to zero
    raters = len(np.unique(pd.user_idx))
    check(raters == n_users and len(pd.item_dict) == n_items,
          f"{raters} users with ratings x {len(pd.item_dict)} items, want "
          f"{n_users} x {n_items}")
    t["ratings"] = len(pd.rating)
    params = ep.algorithm_params_list[0][1]
    t0 = time.perf_counter()
    cpu_model = reco.ALSAlgorithm(params, device="cpu").train(pd)
    t["cpu_train_s"] = time.perf_counter() - t0
    check(cpu_model.item_dict.strings() == model.item_dict.strings(), "item ids differ")
    check(cpu_model.user_dict.strings() == model.user_dict.strings(), "user ids differ")
    diffs = {}
    for side in ("user_factors", "item_factors"):
        card, cpu = getattr(model, side), getattr(cpu_model, side)
        check(np.isfinite(card).all(), f"non-finite {side} from the card")
        diffs[side] = float(np.abs(card - cpu).max())
        bad = np.abs(card - cpu) > ALS_ATOL + ALS_RTOL * np.abs(cpu)
        check(not bad.any(), f"{side}: {int(bad.sum())} entries off the CPU port's beyond "
              f"rtol {ALS_RTOL} atol {ALS_ATOL} (max abs diff {diffs[side]:.3g})")
    t["card_vs_cpu_max_abs_diff"] = diffs
    t["half_step_max_rel_err"] = check_half_step(als_ops, pd, model, dev)

    # a second card train of the same data: the same bits?
    again = reco.ALSAlgorithm(params, device=dev).train(pd)
    t["two_card_trains_bit_identical"] = bool(
        np.array_equal(again.user_factors, model.user_factors)
        and np.array_equal(again.item_factors, model.item_factors))
    print(f"  pio train {t['pio_train_s']:.3f} s (read, prepare, {iters} sweeps at rank "
          f"{rank} over {t['ratings']} ratings, save), peak device "
          f"{t['pio_train_peak_device_gb']:.3f} GB; the CPU port's train "
          f"{t['cpu_train_s']:.3f} s; card vs CPU factors max abs diff {diffs} (bar rtol "
          f"{ALS_RTOL} atol {ALS_ATOL}); half-step vs float64 solve, 64 rows a side: max "
          f"{t['half_step_max_rel_err']:.3g} of a row's largest entry; two card trains "
          f"bit-identical: {t['two_card_trains_bit_identical']}")
    del again, cpu_model

    # serve it: pio deploy -> /queries.json, through K1
    rng = np.random.default_rng(SEED + 7)
    bodies = [{"user": "u1", "num": 10}, {"user": "u2", "num": 10, "unseenOnly": True},
              {"user": "u3", "num": 5, "blackList": ["i0", "i1", "nope"]},
              {"user": "no-such-user", "num": 10}] + queries(rng, 46)
    known = sum(model.user_dict.id(b["user"]) is not None for b in bodies)
    hk.masked_score_matmul.launches = 0
    with pio_deploy_here(path) as (base, up_s):
        answers, lat_ms = timed_posts(base + "/queries.json", bodies)
    launches = hk.masked_score_matmul.launches
    check(launches >= known, f"{launches} masked_score launches for {known} queries")
    swaps = 0
    for body, got in zip(bodies, answers):
        want, s = als_reference_host(model, body)
        swaps += check_ranked(model, body, got, want, s)
    check(answers[3] == {"itemScores": []}, f"unknown user answered {answers[3]}")
    rest = sorted(lat_ms[1:])
    t.update({"deploy_to_first_answer_s": up_s, "queries": len(bodies),
              "k1_launches": launches, "near_tie_swaps": swaps,
              "http_p50_ms": rest[len(rest) // 2]})
    print(f"  pio deploy (this process) to first answer {up_s:.3f} s; {len(bodies)} "
          f"queries, every answer held against float64 host scoring ({swaps} near-tie "
          f"swaps), masked_score launches {launches} (warm-up included); latency p50 "
          f"{t['http_p50_ms']:.3f} ms")
    app = get_storage().apps.get_by_name("shop")
    return model, pd, shop, app.id, path, t


def als_checkpointed(dev, workdir, straight):
    """Phase 12c: ``pio train`` checkpointing every 2 sweeps, a fault
    injected once after the first snapshot, one retry: the retry resumes
    from the snapshot and its factors equal the straight run's."""
    from predictionio_tpu_torch.workflow.core_workflow import load_latest_models

    path = workdir / "als-ck.json"
    path.write_text(json.dumps(als_variant("smoke-als-ck", checkpointEvery=2)))
    ck = workdir / "ck"
    env = {"PIO_TRAIN_RETRIES": "1", "PIO_FAULT_INJECT": "als.sweep:2",
           "PIO_CHECKPOINT_DIR": str(ck)}
    os.environ.update(env)
    try:
        pio("build", "--engine-json", str(path))
        t0 = time.perf_counter()
        pio("train", "--engine-json", str(path))
        train_s = time.perf_counter() - t0
        check("PIO_FAULT_INJECT" not in os.environ, "the injected fault never fired")
    finally:
        for k in env:
            os.environ.pop(k, None)
    check(ck.is_dir() and not any((ck / "als").iterdir()),
          "the completed run left its snapshots behind")
    _, (model,) = load_latest_models("smoke-als-ck", device=dev)
    diffs = {}
    for side in ("user_factors", "item_factors"):
        got, want = getattr(model, side), getattr(straight, side)
        diffs[side] = float(np.abs(got - want).max())
        check(np.allclose(got, want, rtol=CK_RTOL, atol=CK_ATOL),
              f"resumed {side} off the straight run's (max abs diff {diffs[side]:.3g})")
    same = all(np.array_equal(getattr(model, s), getattr(straight, s))
               for s in ("user_factors", "item_factors"))
    print(f"  pio train with checkpointEvery=2, PIO_TRAIN_RETRIES=1 and a fault after the "
          f"first snapshot: {train_s:.3f} s, resumed factors vs the straight run max abs "
          f"diff {diffs} (bar rtol {CK_RTOL} atol {CK_ATOL}), bit-identical {same}")
    return {"pio_train_s": train_s, "vs_straight_max_abs_diff": diffs,
            "bit_identical": same}


def ecomm_queries(rng, n, users, unavailable):
    """``n`` e-commerce rule queries over ``users``: categories (one or two,
    and unknown ones), whiteList, blackList (with unavailable items), the
    two together, an empty whiteList, the recent-views user and cold
    users (with and without categories)."""
    out = []
    for j in range(n):
        kind = j % 10
        body = {"user": f"u{int(rng.choice(users))}", "num": int(rng.choice([1, 4, 10, 20]))}
        if kind in (1, 5):
            body["categories"] = [f"c{int(c)}" for c in rng.choice(
                N_CATEGORIES, int(rng.integers(1, 3)), replace=False)]
        if kind == 2:
            body["whiteList"] = [f"i{int(i)}" for i in rng.integers(0, 2_000, 40)] + [
                f"i{int(unavailable[0])}"]
        if kind in (3, 5):
            body["blackList"] = [f"i{int(i)}" for i in rng.integers(0, 200, 5)]
        if kind == 4:
            body["categories"] = ["no-such-category"]
        if kind == 6:
            body["whiteList"] = []
        if kind == 7:
            body["user"] = "newbie"
        if kind in (8, 9):
            body["user"] = f"cold{j}"
            if kind == 9:
                body["categories"] = [f"c{int(rng.integers(N_CATEGORIES))}"]
        out.append(body)
    return out


def ecomm_oracle(model, shop, live, body):
    """The answer to ``body`` from the trained factors and the shop's
    events, in float64 on the host (the reference template's three tiers
    and rules): [(item, score)], the score row, and whether the answer is
    the popularity tier (ranked with ties in no fixed order)."""
    n_items = len(model.item_dict)
    uid = model.user_dict.id(body["user"])
    ids, index = live["ids"], live["index"]   # item index -> number, and back
    allow = np.ones(n_items, bool)
    cats = body.get("categories")
    if cats is not None:
        names = {int(c[1:]) for c in cats if c[1:].isdigit()}
        have = shop["categories"][ids]
        allow &= np.isin(have, list(names)).any(axis=1) if names else False
    white = body.get("whiteList")
    if white is not None:
        w = np.zeros(n_items, bool)
        known = [int(i[1:]) for i in white if int(i[1:]) < n_items]
        w[index[known]] = True
        allow &= w
    excl = [int(i[1:]) for i in body.get("blackList", []) if int(i[1:]) < n_items]
    excl += list(live["unavailable"])
    seen = live["seen"].get(body["user"], set())
    excl += list(seen)            # unseenOnly: the user's view and buy events
    popular = uid is None or not model.user_factors[uid].any()
    if not popular:
        vec = model.user_factors[uid].astype(np.float64)
    elif body["user"] in live["recent"]:
        recent = np.asarray(sorted(index[live["recent"][body["user"]]]))
        vec = model.item_factors[recent].mean(axis=0).astype(np.float64)
        excl += ids[recent].tolist()
        popular = False
    if popular:
        s = live["popular"].astype(np.float64).copy()
    else:
        s = model.item_factors.astype(np.float64) @ vec
    s[~allow] = -np.inf
    s[index[excl]] = -np.inf
    order = np.lexsort((np.arange(n_items), -s))[: min(body["num"], n_items)]
    return [(model.item_dict.str(int(i)), float(s[i])) for i in order
            if np.isfinite(s[i])], s, popular


def check_ecomm(model, shop, live, body, got) -> int:
    want, s, popular = ecomm_oracle(model, shop, live, body)
    if not popular:
        return check_ranked(model, body, got, want, s)
    got = [(d["item"], d["score"]) for d in got["itemScores"]]
    check([g[1] for g in got] == [w[1] for w in want],
          f"{body}: popularity scores {got} want {want}")
    for item, score in got:   # ties in argsort's order: each item must qualify
        check(s[model.item_dict.id(item)] == score, f"{body}: {item} does not qualify")
    return 0


def ecomm_path(dev, workdir, shop, app_id):
    """Phase 12d: the e-commerce template on the same shop: ``pio train``
    (implicit ALS) → live constraint and view events → ``pio deploy`` →
    ECOMM_RULE_QUERIES rule queries, each held against ``ecomm_oracle``."""
    from predictionio_tpu_torch.events.event import Event
    from predictionio_tpu_torch.storage import get_storage
    from predictionio_tpu_torch.workflow.core_workflow import load_latest_models

    n_users, n_items, _, n_buy, rank, iters = DEPLOYED_ALS
    path = workdir / "ecomm.json"
    path.write_text(json.dumps(ecomm_variant()))
    pio("build", "--engine-json", str(path))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    pio("train", "--engine-json", str(path))
    t = {"pio_train_s": time.perf_counter() - t0,
         "pio_train_peak_device_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    _, (model,) = load_latest_models("smoke-ecomm", device=dev)
    check(np.isfinite(model.user_factors).all() and np.isfinite(model.item_factors).all(),
          "non-finite e-commerce factors")
    check(model.cat_masks.shape == (N_CATEGORIES, n_items),
          f"category masks {model.cat_masks.shape}")
    # the live state the queries meet: the popular items made unavailable,
    # and a user unknown at train time who viewed three items since
    bu, bi, _ = shop["buy"]
    vu, vi, _ = shop["view"]
    popular = np.bincount(vi, minlength=n_items) + 4.0 * np.bincount(bi, minlength=n_items)
    unavailable = np.argsort(-popular, kind="stable")[:N_UNAVAILABLE]
    store = get_storage()
    t_live = T0 + 10_000_000
    store.l_events.insert(Event("$set", "constraint", "unavailableItems",
                                properties={"items": [f"i{i}" for i in unavailable]},
                                event_time=t_live, creation_time=t_live), app_id)
    newbie = [7, n_items * 7 // 10, n_items - 1]
    for k, it in enumerate(newbie):
        store.l_events.insert(Event("view", "user", "newbie", "item", f"i{it}",
                                    event_time=t_live + 1 + k, creation_time=t_live + 1 + k),
                              app_id)
    seen = {}
    for users, items in ((vu, vi), (bu, bi)):
        for u, i in zip(users.tolist(), items.tolist()):
            seen.setdefault(f"u{u}", set()).add(i)
    seen["newbie"] = set(newbie)
    ids = np.asarray([int(s[1:]) for s in model.item_dict.strings()])
    index = np.empty(n_items, np.int64)
    index[ids] = np.arange(n_items)
    live = {"unavailable": unavailable.tolist(), "seen": seen, "ids": ids, "index": index,
            "recent": {"newbie": newbie}, "popular": model.popular}
    check(np.array_equal(model.popular[[model.item_dict.id(f"i{j}") for j in range(n_items)]],
                         popular.astype(np.float32)), "popularity differs from the events'")
    rng = np.random.default_rng(SEED + 8)
    bodies = ecomm_queries(rng, ECOMM_RULE_QUERIES, rng.choice(n_users, 100, replace=False),
                           unavailable)
    with pio_deploy_here(path) as (base, up_s):
        answers, lat_ms = timed_posts(base + "/queries.json", bodies)
    swaps = kinds = 0
    for body, got in zip(bodies, answers):
        swaps += check_ecomm(model, shop, live, body, got)
        kinds += bool(got["itemScores"])
    for j, body in enumerate(bodies):
        if body.get("categories") == ["no-such-category"] or body.get("whiteList") == []:
            check(answers[j] == {"itemScores": []}, f"{body} answered {answers[j]}")
    rest = sorted(lat_ms[1:])
    t.update({"deploy_to_first_answer_s": up_s, "rule_queries": len(bodies),
              "answered": kinds, "near_tie_swaps": swaps,
              "http_p50_ms": rest[len(rest) // 2],
              "http_p99_ms": rest[min(len(rest) - 1, int(0.99 * len(rest)))]})
    print(f"  e-commerce pio train {t['pio_train_s']:.3f} s (implicit, rank {rank}, {iters} "
          f"sweeps; peak device {t['pio_train_peak_device_gb']:.3f} GB); pio deploy to first "
          f"answer {up_s:.3f} s; {len(bodies)} rule queries ({kinds} non-empty) held against "
          f"the numpy oracle, {swaps} near-tie swaps; latency p50 {t['http_p50_ms']:.3f} ms "
          f"p99 {t['http_p99_ms']:.3f} ms (live seen and unavailable reads included)")
    return t


# -- phase 14: the event server, the event-loop front end and the micro-batcher --

FRONTEND_LEVELS = (1, 8, 32)     # closed-loop keep-alive clients
FRONTEND_QUERIES = 300           # queries at each level (cut for the time limit)
FRONTEND_POOL = 500              # distinct query bodies the levels draw from
INGEST_CLIENTS, INGEST_BATCH = 8, 50
RELOAD_USERS, RELOAD_EVENTS = 500, 20_000
RELOAD_INTERVAL_S = 1.0          # the deploy's auto-reload poll
RELOAD_SLACK_S = 5.0             # the install's bound beyond the poll interval
SWAP_SLACK_BYTES = 2 << 20       # device memory after the swap, beyond the models' own
FEEDBACK_QUERIES = 200
PIPELINED_EVENTS = 2_000         # phase 14's ingest sent one by one through EventPipeline
UR_LOAD = (500, 32, 100)         # UR queries, clients, distinct bodies
PROFILED_QUERIES = 500           # a profiled 32-client window after each setting's levels

LOAD_CLIENT = r"""
import http.client, json, sys, threading, time
url_host, port, path, conc, src, dst = sys.argv[1:7]
with open(src) as f:
    bodies = [json.dumps(b) for b in json.load(f)]
out = [None] * len(bodies)
nxt, lock = [0], threading.Lock()
gate = threading.Barrier(int(conc) + 1)

def work():
    conn = http.client.HTTPConnection(url_host, int(port), timeout=120)
    gate.wait()
    while True:
        with lock:
            k = nxt[0]
            nxt[0] += 1
        if k >= len(bodies):
            break
        t0 = time.perf_counter()
        conn.request("POST", path, bodies[k], {"Content-Type": "application/json"})
        r = conn.getresponse()
        data = r.read()
        out[k] = (r.status, (time.perf_counter() - t0) * 1e3, json.loads(data))
    conn.close()

ts = [threading.Thread(target=work) for _ in range(int(conc))]
[t.start() for t in ts]
gate.wait()
t0 = time.perf_counter()
[t.join() for t in ts]
wall = time.perf_counter() - t0
with open(dst, "w") as f:
    json.dump({"wall_s": wall, "results": out}, f)
"""


def run_clients(workdir, port, path, bodies, concurrency, timeout=600):
    """``concurrency`` closed-loop keep-alive clients in a process of their
    own (the server's GIL is not theirs) POST ``bodies`` to ``path``:
    (statuses, host-clock ms of each request, parsed answers, wall s)."""
    script = workdir / "load_client.py"
    if not script.exists():
        script.write_text(LOAD_CLIENT)
    src, dst = workdir / "load_in.json", workdir / "load_out.json"
    src.write_text(json.dumps(bodies))
    out = subprocess.run([sys.executable, str(script), "127.0.0.1", str(port), path,
                          str(concurrency), str(src), str(dst)],
                         capture_output=True, text=True, timeout=timeout)
    check(out.returncode == 0, f"the load clients failed: {out.stderr[-2000:]}")
    doc = json.loads(dst.read_text())
    src.unlink()
    dst.unlink()
    res = doc["results"]
    return [r[0] for r in res], [r[1] for r in res], [r[2] for r in res], doc["wall_s"]


def time_calls(obj, attr):
    """Wrap ``obj.attr`` (a micro-batcher's batch run, or the predictor
    of a server without one) with the host clock: the returned list gets
    (queries, ms) of every call, the readback included."""
    calls, fn = [], getattr(obj, attr)

    def timed(q):
        t0 = time.perf_counter()
        try:
            return fn(q)
        finally:
            calls.append((len(q) if isinstance(q, list) else 1,
                          (time.perf_counter() - t0) * 1e3))

    setattr(obj, attr, timed)
    return calls


def calls_summary(calls, wall_s):
    """Host ms of the timed calls: p50, p99, mean, and the share of the
    round's wall they cover (above 1 when calls overlap)."""
    ms = [c[1] for c in calls]
    p50, p99 = np.percentile(ms, [50, 99])
    return {"calls": len(ms), "p50_ms": float(p50), "p99_ms": float(p99),
            "mean_ms": float(np.mean(ms)), "share_of_wall": sum(ms) / 1e3 / wall_s}


def profiled_round(workdir, port, bodies, conc):
    """One load round under ``torch.profiler`` (CPU and CUDA activity):
    the clients' results and wall, the device's busy µs in the window
    (every kernel and copy, from any thread), the largest kernels, and
    the host's self µs in torch operators with the largest of them."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    try:   # the handler threads' operators, not only this thread's
        config = _ExperimentalConfig(profile_all_threads=True)
    except TypeError:   # an older torch: the operators go unmeasured (None)
        config = None
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 experimental_config=config) as prof:
        statuses, _, answers, wall = run_clients(workdir, port, "/queries.json", bodies, conc)
        torch.cuda.synchronize()
    kernels, ops = {}, {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0) or 0
        if us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels[ev.key] = {"us": us, "calls": ev.count}
        elif ev.device_type == torch.autograd.DeviceType.CPU and ev.self_cpu_time_total > 0:
            ops[ev.key] = {"us": ev.self_cpu_time_total, "calls": ev.count}
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1]["us"])[:6])
    top_ops = dict(sorted(ops.items(), key=lambda kv: -kv[1]["us"])[:6])
    op_us = sum(o["us"] for o in ops.values()) if config is not None else None
    return statuses, answers, wall, sum(k["us"] for k in kernels.values()), top, op_us, top_ops


def batch_hist_snapshot():
    """The in-process ``pio_serve_batch_size`` histogram: (bucket bounds,
    counts by bucket, sum, count)."""
    from predictionio_tpu_torch.obs import metrics as obs_metrics

    h = obs_metrics.get_registry().histogram("pio_serve_batch_size", "x")
    s = h._snapshot_series().get("", {"counts": [0] * (len(h.buckets) + 1), "sum": 0.0,
                                      "count": 0})
    return list(h.buckets) + ["+Inf"], s["counts"], s["sum"], s["count"]


def batch_hist_delta(before, after):
    bounds, c0, s0, n0 = before
    _, c1, s1, n1 = after
    hist = {str(b): c1[j] - c0[j] for j, b in enumerate(bounds) if c1[j] - c0[j]}
    return {"histogram_le": hist, "batches": n1 - n0,
            "mean": (s1 - s0) / (n1 - n0) if n1 > n0 else 0.0}


def check_als_answers(model, bodies, answers, refs=None):
    """Every answer held against float64 host scoring of its body (one
    reference a distinct body, kept in ``refs`` for later rounds on the
    same factors); near-tie swaps counted."""
    refs = {} if refs is None else refs
    swaps = 0
    for body, got in zip(bodies, answers):
        key = json.dumps(body, sort_keys=True)
        if key not in refs:
            refs[key] = als_reference_host(model, body)
        want, s = refs[key]
        swaps += check_ranked(model, body, got, want, s)
    return swaps


def segment_lines(store, app_id, needle):
    """The lines of an app's event log holding ``needle`` (bytes), read
    from its segment files."""
    out = []
    for seg in store.l_events.segment_paths(app_id):
        data = seg.read_bytes()
        pos = data.find(needle)
        while pos >= 0:
            a, b = data.rfind(b"\n", 0, pos) + 1, data.find(b"\n", pos)
            out.append(data[a:b])
            pos = data.find(needle, b)
    return out


def metrics_text(base):
    with urllib.request.urlopen(base + "/metrics", timeout=60) as resp:
        return resp.read().decode()


def family_value(text, name, **labels):
    from predictionio_tpu_torch.obs.exposition import family_total, parse_prometheus_text

    return family_total(parse_prometheus_text(text)[0], name, **labels)


def worker_pids(base, n, timeout=120):
    """Poll ``GET /`` over fresh connections until ``n`` distinct pids
    answered (the prefork readiness probe)."""
    pids, t0 = set(), time.perf_counter()
    while len(pids) < n:
        check(time.perf_counter() - t0 < timeout, f"only {len(pids)} of {n} workers answered")
        try:
            pids.add(get_json(base + "/", timeout=5)["pid"])
        except (urllib.error.URLError, ConnectionError):
            time.sleep(0.2)
    return pids


def cli_processes(marker):
    """Processes whose command line runs the port's console with
    ``marker`` in it (the prefork leftovers check)."""
    found = []
    for d in Path("/proc").iterdir():
        if not d.name.isdigit():
            continue
        try:
            cmd = (d / "cmdline").read_bytes().replace(b"\0", b" ").decode()
        except OSError:
            continue
        if "predictionio_tpu_torch.cli.main" in cmd and marker in cmd:
            found.append((int(d.name), cmd))
    return found


def device_bytes(model):
    """Bytes of the CUDA tensors a model has staged."""
    total = 0
    for v in list(model.__dict__.values()):
        for t in (v.values() if isinstance(v, dict) else
                  v if isinstance(v, (list, tuple)) else [v]):
            if isinstance(t, torch.Tensor) and t.is_cuda:
                total += t.numel() * t.element_size()
    return total


def restore_env(saved):
    """Put back the environment variables ``saved`` holds (None: unset)."""
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def level_bodies(pool, n, seed):
    rng = np.random.default_rng(seed)
    return [pool[int(j)] for j in rng.integers(0, len(pool), n)]


def ingest_pipelined(es_base, key, events):
    """Phase 14: ``events`` one by one through the SDK's ``EventPipeline``
    (one keep-alive connection, pipelined); their event ids, each
    acknowledged 201 as over raw HTTP, and the wall seconds."""
    from predictionio_tpu_torch.sdk import EventClient

    client = EventClient(key, es_base, timeout=60.0)
    t0 = time.perf_counter()
    with client.pipeline(depth=64) as pipe:
        handles = [pipe.create_event(
            e["event"], e["entityType"], e["entityId"], e["targetEntityType"],
            e["targetEntityId"], e.get("properties"),
            datetime.datetime.fromtimestamp(epoch(e["eventTime"]), datetime.timezone.utc))
            for e in events]
    ids = [h.result()["eventId"] for h in handles]
    wall = time.perf_counter() - t0
    check(len(ids) == len(events) and all(isinstance(i, str) and i for i in ids),
          "14: the pipelined events were not all acknowledged")
    print(f"  {len(ids)} events through the SDK's EventPipeline in {wall:.3f} s "
          f"({len(ids) / wall:.0f} events/s), each acknowledged with an event id")
    return ids, wall


def history_and_healthz(base, what) -> dict:
    """``/metrics/history.json`` of the server at ``base`` holds at least
    two samples (polled: the sampler ticks every PIO_TSDB_INTERVAL_S) and
    ``/healthz`` answers 200 with a verdict."""
    deadline = time.monotonic() + 30
    while True:
        hist = get_json(base + "/metrics/history.json")
        if len(hist["samples"]) >= 2:
            break
        check(time.monotonic() < deadline,
              f"{what}: /metrics/history.json holds {len(hist['samples'])} samples")
        time.sleep(0.5)
    with urllib.request.urlopen(base + "/healthz", timeout=60) as resp:
        check(resp.status == 200, f"{what}: /healthz answered {resp.status}")
        health = json.loads(resp.read())
    check(health["status"] in ("ok", "warn", "burning", "no_data"),
          f"{what}: /healthz {health}")
    return {"history_samples": len(hist["samples"]), "healthz": health["status"],
            "slos": {k: v["verdict"] for k, v in health.get("slos", {}).items()}}


def eventserver_obs(es_base, rid) -> dict:
    """Phase 14: the event server's trace of the debug batch holds the
    group commit's ``group_commit_append`` span (either worker answers: the
    group's traces are merged); its history ring and ``/healthz``."""
    doc = fetch_trace(es_base, rid)
    names = [s["name"] for s in doc["spans"]]
    check(doc["route"] == "/batch/events.json" and doc["status"] == 200
          and "group_commit_append" in names,
          f"14: the debug batch's trace: {doc['route']} {doc['status']} spans {names}")
    out = {"batch_trace_spans": names, "batch_trace_ms": doc["durationMs"],
           "eventserver": history_and_healthz(es_base, "14 event server")}
    print(f"  the debug batch's trace (worker {doc['worker']}): {doc['durationMs']:.3f} ms, "
          f"spans {names}; the event server's /metrics/history.json "
          f"{out['eventserver']['history_samples']} samples, /healthz "
          f"{out['eventserver']['healthz']}")
    return out


def queryserver_obs(workdir, port, level_1, round_32, n_queries) -> dict:
    """Phase 14, on the default deploy: the 1-client level's bodies again
    through the SDK's ``EngineClient`` (one keep-alive connection) answer
    what raw HTTP answered; the history ring and ``/healthz``; then a
    32-client level with the flight recorder off (``PIO_TRACING=off``),
    then on again, beside the default's level: the recorder's per-request
    cost against the spread of two rounds with it on."""
    from predictionio_tpu_torch.obs import tracing
    from predictionio_tpu_torch.sdk import EngineClient

    base = f"http://127.0.0.1:{port}"
    bodies, raw = level_1
    client = EngineClient(base, timeout=60.0)
    got = [client.send_query(b) for b in bodies]
    differ = sum(g != w for g, w in zip(got, raw))
    check(differ == 0, f"14: {differ} EngineClient answers differ from raw HTTP's")
    out = {"engine_client_queries": len(got), "queryserver": history_and_healthz(base, "14")}
    kept = tracing.get_recorder()
    saved = os.environ.get("PIO_TRACING")
    bodies32 = level_bodies(bodies, n_queries, SEED + 32)
    rounds = {"on": {"p50_ms": round_32["p50_ms"], "qps": round_32["qps"]}}
    for name in ("off", "on_again"):
        if name == "off":
            os.environ["PIO_TRACING"] = "off"
            tracing.set_recorder(tracing.FlightRecorder())
        try:
            check(tracing.get_recorder().enabled == (name != "off"),
                  f"14: the flight recorder is {'on' if name == 'off' else 'off'} for {name}")
            statuses, lat_ms, _, wall = run_clients(workdir, port, "/queries.json", bodies32,
                                                    32)
        finally:
            tracing.set_recorder(kept)
            restore_env({"PIO_TRACING": saved})
        check(set(statuses) == {200}, f"14 tracing {name}: statuses {set(statuses)}")
        rounds[name] = {"p50_ms": float(np.percentile(lat_ms, 50)),
                        "qps": len(bodies32) / wall}
    out["tracing_32_clients"] = rounds
    print(f"  {len(got)} queries through the SDK's EngineClient answer what raw HTTP "
          f"answered; the query server's /metrics/history.json "
          f"{out['queryserver']['history_samples']} samples, /healthz "
          f"{out['queryserver']['healthz']}; 32 clients, {n_queries} queries a round, the "
          "flight recorder on (default), off (PIO_TRACING=off), on again: "
          + ", ".join(f"{k} p50 {v['p50_ms']:.3f} ms {v['qps']:.1f} q/s"
                      for k, v in rounds.items()) + " (host clock)")
    return out


def frontend_path(hk, dev, workdir, shop):
    """Phase 14: ``pio eventserver --workers 2`` ingest over HTTP → ``pio
    train`` → ``deploy(auto_reload=..., device="cuda")`` in this process
    under concurrent load (K1's launches by route, the batch sizes, every
    answer checked) → a hot reload of new users' events → a feedback round
    → both servers stopped, no child left."""
    import contextlib as _ctx
    import gc
    import io

    from predictionio_tpu_torch.storage import get_storage
    from predictionio_tpu_torch.workflow import create_server as cs

    n_users, n_items, n_rate, n_buy, rank, iters = DEPLOYED_ALS
    out = {}
    buf = io.StringIO()
    with _ctx.redirect_stdout(buf):
        pio("app", "new", "shop14")
    key = buf.getvalue().split("Access key: ")[1].split()[0]
    app_id = get_storage().apps.get_by_name("shop14").id
    root = Path(__file__).resolve().parent
    es_port = free_port()
    es_log = workdir / "eventserver.log"
    env = {**os.environ, "PYTHONPATH": str(root)}
    t0 = time.perf_counter()
    with open(es_log, "w") as log:
        es = subprocess.Popen([sys.executable, "-m", "predictionio_tpu_torch.cli.main",
                               "eventserver", "--ip", "127.0.0.1", "--port", str(es_port),
                               "--workers", "2"], cwd=root, env=env, stdout=log,
                              stderr=subprocess.STDOUT)
    es_base = f"http://127.0.0.1:{es_port}"
    servers, profiled, saved_env = [], [], {}
    try:
        pids = worker_pids(es_base, 2)
        out["eventserver_up_s"] = time.perf_counter() - t0
        # the shop's rate and buy events, one a second from T0, in batches of 50
        events = []
        t_ev = T0
        for name in ("rate", "buy"):
            users, items, ratings = shop[name]
            for j, (u, i) in enumerate(zip(users.tolist(), items.tolist())):
                e = {"event": name, "entityType": "user", "entityId": f"u{u}",
                     "targetEntityType": "item", "targetEntityId": f"i{i}",
                     "eventTime": iso(t_ev)}
                if ratings is not None:
                    e["properties"] = {"rating": int(ratings[j])}
                events.append(e)
                t_ev += 1
        # the first batch goes with X-PIO-Debug (its trace must hold the group
        # commit's span), the last PIPELINED_EVENTS one by one through the
        # SDK's EventPipeline, the rest as batches from the client processes
        piped = events[len(events) - PIPELINED_EVENTS:]
        batches = [events[k:k + INGEST_BATCH]
                   for k in range(0, len(events) - PIPELINED_EVENTS, INGEST_BATCH)]
        debug_acks = json.loads(post_traced(f"{es_base}/batch/events.json?accessKey={key}",
                                            batches[0], "smoke14-batch"))
        statuses, lat_ms, answers, wall = run_clients(
            workdir, es_port, f"/batch/events.json?accessKey={key}", batches[1:],
            INGEST_CLIENTS)
        check(set(statuses) == {200}, f"batch statuses {sorted(set(statuses))}")
        piped_ids, piped_s = ingest_pipelined(es_base, key, piped)
        acked = ([r["eventId"] for r in debug_acks if r["status"] == 201]
                 + [r["eventId"] for a in answers for r in a if r["status"] == 201]
                 + piped_ids)
        check(len(acked) == len(events) == n_rate + n_buy,
              f"{len(acked)} of {len(events)} events acknowledged 201")
        out["observability"] = eventserver_obs(es_base, "smoke14-batch")
        out["observability"]["pipelined"] = {"events": len(piped_ids), "wall_s": piped_s}
        store = get_storage()
        chan = Path(store.l_events.segment_paths(app_id)[0]).parent
        segs = sorted(p.name for p in chan.glob("seg-*.jsonl"))
        tags = {n.rsplit("-", 1)[0] for n in segs}
        check(tags == {f"seg-w0-{es.pid}", f"seg-w1-{es.pid}"},
              f"segments not per writer: {segs[:6]}")
        t0 = time.perf_counter()
        # the log's lines are canonical JSON (sorted keys): every line
        # holds one "eventId" (the store's JSON parse of 300k lines costs
        # ~6 s; this reads the same bytes)
        stored = [ln.split(b'"eventId":"', 1)[1].split(b'"', 1)[0].decode()
                  for ln in segment_lines(store, app_id, b'"eventId":"')]
        n_lines = sum(seg.read_bytes().count(b"\n") for seg in store.l_events.segment_paths(app_id))
        check(n_lines == len(stored), f"{n_lines} lines, {len(stored)} event ids")
        check(len(stored) == len(set(stored)) and set(stored) == set(acked),
              f"{len(stored)} events in the store, {len(set(acked) - set(stored))} acked "
              "ones missing")
        read_s = time.perf_counter() - t0
        scraped = []
        t0 = time.perf_counter()
        while len(scraped) < 6:   # fresh connections: the kernel picks the worker
            check(time.perf_counter() - t0 < 60, f"/metrics never converged: {scraped}")
            v = family_value(metrics_text(es_base), "pio_events_ingested_total")
            if v == len(events):
                scraped.append(v)
            else:
                scraped.clear()
                time.sleep(0.3)
        p50, p99 = np.percentile(lat_ms, [50, 99])
        out["ingest"] = {"events": len(events), "requests": len(batches), "wall_s": wall,
                         "events_per_s": len(events) / wall, "batch_p50_ms": float(p50),
                         "batch_p99_ms": float(p99), "segments": len(segs),
                         "store_read_s": read_s, "workers": sorted(pids)}
        print(f"  pio eventserver --workers 2 up in {out['eventserver_up_s']:.3f} s; "
              f"{len(events)} events in {len(batches)} batches of {INGEST_BATCH} from "
              f"{INGEST_CLIENTS} keep-alive clients in {wall:.3f} s = "
              f"{out['ingest']['events_per_s']:.0f} events/s, a batch p50 {p50:.3f} ms p99 "
              f"{p99:.3f} ms (host clock); all {len(acked)} acknowledged events in the store "
              f"once, in {len(segs)} per-writer segments; /metrics of either worker: "
              f"pio_events_ingested_total = {int(scraped[0])}")

        # pio train on the card, then deploy in this process (K1's counter reads)
        path = workdir / "als14.json"
        variant = als_variant("smoke-als14")
        variant["datasource"]["params"]["appName"] = "shop14"
        path.write_text(json.dumps(variant))
        pio("build", "--engine-json", str(path))
        t0 = time.perf_counter()
        pio("train", "--engine-json", str(path))
        out["pio_train_s"] = time.perf_counter() - t0

        rng = np.random.default_rng(SEED + 14)
        pool = queries(rng, FRONTEND_POOL)
        rounds, refs = [], {}   # one trained instance serves every round
        level_answers = {}
        # the PIO_HTTP_POOL=32 server, batching as a CUDA deploy does by
        # default, stays up for the hot reload below
        settings = [("default pool", {}, FRONTEND_LEVELS),
                    ("PIO_SERVE_BATCH=off", {"PIO_SERVE_BATCH": "off"}, (32,)),
                    ("PIO_HTTP_POOL=32", {"PIO_HTTP_POOL": "32"}, FRONTEND_LEVELS)]
        httpd = None
        for name, setting, levels in settings:
            # set for the server's whole life: every install (a reload's
            # too) reads PIO_SERVE_BATCH again
            saved_env = {k: os.environ.get(k) for k in setting}
            os.environ.update(setting)
            httpd = cs.deploy(str(path), host="127.0.0.1", port=0, device=dev.type,
                              auto_reload=RELOAD_INTERVAL_S)
            servers.append(httpd)
            state = httpd.pio_state
            check((state.batcher is not None) == ("PIO_SERVE_BATCH" not in setting),
                  f"{name}: micro-batcher {'on' if state.batcher else 'off'}")
            model = state.models[0]
            check(model.device == dev, f"{name}: the deployed model is off the card")
            port = httpd.server_address[1]
            # host time of each batch run (or each predict, batcher off)
            calls = (time_calls(state.batcher, "_run") if state.batcher is not None
                     else time_calls(state, "predictor"))
            for conc in levels:
                bodies = level_bodies(pool, FRONTEND_QUERIES, SEED + conc)
                hist0 = batch_hist_snapshot()
                reruns0 = cs._M_SERIAL_RERUNS.value()
                hk.reset_k1_counts()
                calls.clear()
                statuses, lat_ms, answers, wall = run_clients(
                    workdir, port, "/queries.json", bodies, conc)
                launches = (hk.masked_score_matmul.launches,
                            dict(hk.masked_score_matmul.launches_by_route))
                hist = batch_hist_delta(hist0, batch_hist_snapshot())
                reruns = cs._M_SERIAL_RERUNS.value() - reruns0
                run_ms = calls_summary(calls, wall)
                check(set(statuses) == {200}, f"{name} c={conc}: statuses {set(statuses)}")
                swaps = check_als_answers(model, bodies, answers, refs)
                check(reruns == 0, f"{name} c={conc}: {reruns} serial re-runs on a clean load")
                check(launches[0] > 0, f"{name} c={conc}: no masked_score launch")
                level_answers[(name, conc)] = (bodies, answers)
                p50, p99 = np.percentile(lat_ms, [50, 99])
                r = {"setting": name, "clients": conc, "queries": len(bodies),
                     "p50_ms": float(p50), "p99_ms": float(p99), "qps": len(bodies) / wall,
                     "k1_launches": launches[0], "k1_by_route": launches[1],
                     "k1_launches_per_query": launches[0] / len(bodies),
                     "batch": hist, "serial_reruns": reruns, "near_tie_swaps": swaps,
                     "pool": httpd._pool_size,
                     ("batch_run" if state.batcher is not None else "predict"): run_ms}
                rounds.append(r)
                print(f"  {name} (pool {httpd._pool_size}), {conc} clients: {len(bodies)} "
                      f"queries p50 {p50:.3f} ms p99 {p99:.3f} ms {r['qps']:.1f} q/s (host "
                      f"clock); K1 launches {launches[0]} {launches[1]}; batches "
                      f"{hist['batches']} mean {hist['mean']:.2f} by le {hist['histogram_le']}; "
                      f"{'a batch run' if state.batcher is not None else 'a predict'} "
                      f"{run_ms['calls']} calls p50 {run_ms['p50_ms']:.3f} ms p99 "
                      f"{run_ms['p99_ms']:.3f} ms mean {run_ms['mean_ms']:.3f} ms, their sum "
                      f"{run_ms['share_of_wall']:.3f} of the wall; serial re-runs {reruns}; "
                      f"every answer against float64 host scoring ({swaps} near-tie swaps)")
            if name == "default pool":
                out["observability"].update(queryserver_obs(
                    workdir, port, level_answers[(name, 1)], rounds[-1], FRONTEND_QUERIES))
            # where a concurrent query's time goes: the device's busy share
            # of a 32-client window, beside the host time of its batch runs
            bodies = level_bodies(pool, PROFILED_QUERIES, SEED + 17)
            hist0 = batch_hist_snapshot()
            calls.clear()
            statuses, answers, wall, busy_us, top, op_us, top_ops = profiled_round(
                workdir, port, bodies, 32)
            hist = batch_hist_delta(hist0, batch_hist_snapshot())
            check(set(statuses) == {200}, f"{name} profiled round: statuses {set(statuses)}")
            swaps = check_als_answers(model, bodies, answers, refs)
            run_ms = calls_summary(calls, wall)
            prof_r = {"setting": name, "clients": 32, "queries": len(bodies), "wall_s": wall,
                      "device_busy_us": busy_us, "device_busy_share": busy_us / 1e6 / wall,
                      "device_us_per_call": busy_us / run_ms["calls"],
                      "host_calls": run_ms, "batches": hist["batches"],
                      "kernels_us": top, "host_op_us": op_us,
                      "host_op_share": None if op_us is None else op_us / 1e6 / wall,
                      "host_ops_us": top_ops,
                      "near_tie_swaps": swaps}
            profiled.append(prof_r)
            print(f"  {name}, profiled window of {len(bodies)} queries from 32 clients in "
                  f"{wall:.3f} s: the device busy {busy_us:.1f} us = "
                  f"{prof_r['device_busy_share']:.4f} of the wall, "
                  f"{prof_r['device_us_per_call']:.1f} us a "
                  f"{'batch' if state.batcher is not None else 'predict'} against its host "
                  f"time p50 {run_ms['p50_ms']:.3f} ms mean {run_ms['mean_ms']:.3f} ms "
                  f"({run_ms['calls']} calls, their sum {run_ms['share_of_wall']:.3f} of the "
                  f"wall); kernels by device us: "
                  + "; ".join(f"{k[:60]} {v['us']:.1f} us x{v['calls']}"
                              for k, v in top.items())
                  + ("; host self time in torch operators not measured (the profiler "
                     "records one thread)" if op_us is None else
                     f"; host self time in torch operators {op_us:.1f} us = "
                     f"{prof_r['host_op_share']:.4f} of the wall: "
                     + "; ".join(f"{k[:40]} {v['us']:.1f} us x{v['calls']}"
                                 for k, v in top_ops.items())))
            del model, state
            if name != settings[-1][0]:
                pio("undeploy", "--port", str(port), "--timeout", "60")
                httpd.thread.join(DEPLOY_TIMEOUT_S)
                check(not httpd.thread.is_alive(), f"{name}: the server did not stop")
                restore_env(saved_env)
                saved_env = {}
        out["load"] = rounds
        out["profiled"] = profiled
        pool32 = [r for r in rounds if r["setting"] == "PIO_HTTP_POOL=32"]
        check(sum(r["k1_by_route"]["tiled"] for r in pool32) > 0,
              "PIO_HTTP_POOL=32: K1's tiled path never launched")

        # hot reload: 500 new users' events through the event server, pio train again
        state = httpd.pio_state
        port = httpd.server_address[1]
        check(state.batcher is not None, "the reloading server does not micro-batch")
        first = state.instance.id
        warm = [{"user": f"u{j}", "num": 10} for j in range(8)]
        run_clients(workdir, port, "/queries.json", warm, 8)
        gc.collect()
        torch.cuda.synchronize()
        mem_before = torch.cuda.memory_allocated(dev)
        old_bytes = device_bytes(state.models[0])
        rr = np.random.default_rng(SEED + 15)
        new_users = rr.integers(0, RELOAD_USERS, RELOAD_EVENTS)
        new_events = [{"event": "rate", "entityType": "user", "entityId": f"n{u}",
                       "targetEntityType": "item", "targetEntityId": f"i{int(i)}",
                       "properties": {"rating": int(r)}, "eventTime": iso(t_ev + k)}
                      for k, (u, i, r) in enumerate(zip(
                          new_users.tolist(), rr.integers(0, n_items, RELOAD_EVENTS),
                          rr.integers(1, 6, RELOAD_EVENTS)))]
        statuses, _, answers, _ = run_clients(
            workdir, es_port, f"/batch/events.json?accessKey={key}",
            [new_events[k:k + INGEST_BATCH] for k in range(0, RELOAD_EVENTS, INGEST_BATCH)],
            INGEST_CLIENTS)
        check(set(statuses) == {200} and all(r["status"] == 201 for a in answers for r in a),
              "the new users' events were not all acknowledged")
        probe = {"user": "n0", "num": 10}
        check(post(f"http://127.0.0.1:{port}/queries.json", probe) == {"itemScores": []},
              "a new user was known before the retrain")
        torch.cuda.reset_peak_memory_stats(dev)
        pio("train", "--engine-json", str(path))
        t_end = time.perf_counter()
        named = answered = None
        while named is None or answered is None:
            now = time.perf_counter() - t_end
            check(now < RELOAD_INTERVAL_S + RELOAD_SLACK_S + 30,
                  "the retrained instance never served")
            if named is None and get_json(f"http://127.0.0.1:{port}/")[
                    "engineInstanceId"] != first:
                named = time.perf_counter() - t_end
            if answered is None and post(f"http://127.0.0.1:{port}/queries.json",
                                         probe)["itemScores"]:
                answered = time.perf_counter() - t_end
            time.sleep(0.01)
        check(named <= RELOAD_INTERVAL_S + RELOAD_SLACK_S,
              f"GET / named the new instance {named:.3f} s after pio train, over the poll "
              f"interval {RELOAD_INTERVAL_S} s plus {RELOAD_SLACK_S} s")
        peak = torch.cuda.max_memory_allocated(dev)
        new_model = state.models[0]
        check(state.generation == 2 and new_model.user_dict.id("n0") is not None,
              f"generation {state.generation} after the reload")
        check(state.batcher is not None, "the reload turned the micro-batcher off")
        new_bodies = [{"user": f"n{j}", "num": 10} for j in range(RELOAD_USERS)]
        statuses, _, answers, _ = run_clients(workdir, port, "/queries.json", new_bodies, 8)
        check(set(statuses) == {200}, "new users' queries failed")
        swaps = check_als_answers(new_model, new_bodies, answers)
        new_bytes = device_bytes(new_model)
        del new_model
        gc.collect()
        torch.cuda.synchronize()
        mem_after = torch.cuda.memory_allocated(dev)
        check(mem_after - mem_before <= new_bytes - old_bytes + SWAP_SLACK_BYTES,
              f"device memory {mem_before} B before the swap, {mem_after} B after: more than "
              f"the new model's {new_bytes - old_bytes} B and {SWAP_SLACK_BYTES} B (the old "
              "generation was not released)")
        out["reload"] = {"events": RELOAD_EVENTS, "users": RELOAD_USERS,
                         "get_names_new_s": named, "first_new_answer_s": answered,
                         "memory_allocated_before": mem_before,
                         "memory_allocated_after": mem_after, "peak_during_swap": peak,
                         "old_model_device_bytes": old_bytes,
                         "new_model_device_bytes": new_bytes, "near_tie_swaps": swaps}
        print(f"  hot reload: {RELOAD_EVENTS} rate events of {RELOAD_USERS} new users over "
              f"HTTP, pio train, then GET / named the new instance {named:.3f} s and its "
              f"first new-user answer came {answered:.3f} s after pio train returned (poll "
              f"{RELOAD_INTERVAL_S} s); {len(new_bodies)} new users' answers equal float64 "
              f"scoring of the new factors ({swaps} near-tie swaps); "
              f"torch.cuda.memory_allocated {mem_before} B before, {mem_after} B after the swap "
              f"and gc (models {old_bytes} -> {new_bytes} B), peak {peak} B during it")
        pio("undeploy", "--port", str(port), "--timeout", "60")
        httpd.thread.join(DEPLOY_TIMEOUT_S)
        check(not httpd.thread.is_alive(), "the reloaded server did not stop")
        restore_env(saved_env)
        saved_env = {}

        # feedback: 200 queries, 200 predict events equal to the answers
        httpd = cs.deploy(str(path), host="127.0.0.1", port=0, device=dev.type, feedback=True)
        servers.append(httpd)
        fb_bodies = level_bodies(pool, FEEDBACK_QUERIES, SEED + 16)
        statuses, _, answers, _ = run_clients(workdir, httpd.server_address[1],
                                              "/queries.json", fb_bodies, 8)
        check(set(statuses) == {200}, "feedback round failed")
        pio("undeploy", "--port", str(httpd.server_address[1]), "--timeout", "60")
        httpd.thread.join(DEPLOY_TIMEOUT_S)
        predicts = [json.loads(ln) for ln in segment_lines(get_storage(), app_id,
                                                          b'"event":"predict"')]
        got = sorted(json.dumps([e["properties"]["query"], e["properties"]["prediction"]],
                                sort_keys=True) for e in predicts)
        want = sorted(json.dumps([b, a], sort_keys=True) for b, a in zip(fb_bodies, answers))
        check(len(predicts) == FEEDBACK_QUERIES and got == want,
              f"{len(predicts)} predict events, equal to the answers: {got == want}")
        out["feedback_events"] = len(predicts)
        print(f"  feedback: {FEEDBACK_QUERIES} queries, {len(predicts)} predict events whose "
              "query and prediction equal what was served")

        # shutdown: pio undeploy stops the event server group; no child left
        pio("undeploy", "--port", str(es_port), "--timeout", "60")
        rc = es.wait(timeout=DEPLOY_TIMEOUT_S)
        check(rc == 0, f"pio eventserver exited {rc}: {es_log.read_text()[-3000:]}")
        left = cli_processes(f"--port {es_port}")
        check(not left, f"event server children left behind: {left}")
        print(f"  pio undeploy stopped the event server group (exit 0) and every query "
              f"server; no child process left")
    finally:
        restore_env(saved_env)
        for h in servers:
            if h.thread is not None and h.thread.is_alive():
                h.shutdown()
                h.server_close()
        if es.poll() is None:
            es.kill()
            es.wait()
        for pid, _ in cli_processes(f"--port {es_port}"):
            with _ctx.suppress(OSError):
                os.kill(pid, 9)
    return out


# -- phase 15: CCO at bench_scale's shape, every strategy ---------------------------

# bench.py:bench_scale's parity corpus (users, items, events, top_k) and the
# item tile of its tiled legs here (three tiles, so the carry merges)
SCALE_PARITY = (30_000, 3_000, 1_000_000, 20, 1_024)
# bench.py:bench_scale's full shape: users, items, events, host batch, user
# block, item tile, top_k
SCALE_FULL = (100_000, 131_072, 50_000_000, 2_000_000, 4_096, 4_096, 50)
CARD_BYTES = 80e9   # the card's memory, which the full leg's peak must stay within


def gen_scale_batches(seed, n_users, n_items, n_events, batch):
    """bench.py:_gen_scale_batches, copied: uniform users, zipf(1.25)
    items, streamed in batches."""
    g = np.random.default_rng(seed)
    done = 0
    while done < n_events:
        n = min(batch, n_events - done)
        yield (g.integers(0, n_users, n).astype(np.int32),
               (g.zipf(1.25, n) % n_items).astype(np.int32))
        done += n


@contextlib.contextmanager
def cco_setting(cco, env, attrs):
    """The CCO switches (``PIO_CCO_*``) and module budgets of one strategy,
    restored on leaving."""
    keys = ("PIO_CCO_DENSE", "PIO_CCO_SPARSE", "PIO_CCO_SPARSE_TAIL")
    saved_env = {k: os.environ.pop(k, None) for k in keys}
    saved = {k: getattr(cco, k) for k in attrs}
    os.environ.update(env)
    for k, v in attrs.items():
        setattr(cco, k, v)
    try:
        yield
    finally:
        for k in keys:
            os.environ.pop(k, None)
        os.environ.update({k: v for k, v in saved_env.items() if v is not None})
        for k, v in saved.items():
            setattr(cco, k, v)


def timed_cco(hk, dev, fn):
    """``fn()``'s indicator table, wall seconds, peak device memory and
    K2/K3 launches (counts set to 0 just before, read just after)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    hk.llr_masked_scores.launches = hk.tile_topk_desc.launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, {"wall_s": time.perf_counter() - t0,
                 "peak_device_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
                 "launches": [hk.llr_masked_scores.launches, hk.tile_topk_desc.launches]}


def check_self_table(s, i, n_items, top_k, what):
    check(s.shape == (n_items, top_k) and i.shape == (n_items, top_k), f"{what}: shape")
    check(bool(np.isfinite(s[i >= 0]).all()) and bool((s[i < 0] == -np.inf).all()),
          f"{what}: scores not finite where set")
    check(int((i >= 0).sum()) > 0 and int(i.max()) < n_items, f"{what}: ids")
    check(not (i == np.arange(n_items)[:, None]).any(), f"{what}: self-pairs not excluded")


def same_table(a, b) -> bool:
    return (np.array_equal(a[1], b[1])
            and np.array_equal(a[0].view(np.int32), b[0].view(np.int32)))


def check_native_layout(cco, pu, pi, n_users, n_items) -> None:
    """The native chunk layout (``native.layout_chunks``, in the scanner's
    library) loaded, and ``block_interactions`` through it gives the numpy
    layout's arrays on the parity corpus."""
    from predictionio_tpu_torch import native

    check(native.layout_chunks(pu[:8], pi[:8], 4_096, -(-n_users // 4_096)) is not None,
          "the native chunk layout did not load")
    t0 = time.perf_counter()
    got = cco.block_interactions(pu, pi, n_users, n_items, user_block=4_096)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = cco.block_interactions_stream([(pu, pi)], n_users, n_items, user_block=4_096)
    numpy_s = time.perf_counter() - t0
    for name in ("local_u", "item", "mask"):
        check(np.array_equal(getattr(got, name), getattr(want, name)),
              f"native layout: {name} differs from the numpy layout")
    print(f"  native chunk layout of the parity corpus {native_s:.3f} s, equal to the numpy "
          f"layout's arrays ({numpy_s:.3f} s)")


def cpu_plain_vs_card(cco, hk, dev, pu, pi, n_users, n_items) -> dict:
    """Why the sparse runner's host tail scores its cells on the training's
    device: K2 on the card against its plain chain on the CPU, on the
    parity corpus's whole count matrix (from the host cross-join), cells
    whose f32 bits differ.  A reading, not a check."""
    p = cco._SparseHostCSR(pu, pi, n_items, n_users)
    C = cco._sparse_counts(p, p)
    args = [torch.from_numpy(C), torch.from_numpy(p.col_counts), torch.from_numpy(p.col_counts)]
    card = hk.llr_masked_scores(*[a.to(dev) for a in args], float(n_users), 0.0).cpu().numpy()
    host = hk.llr_masked_scores_plain(*args, float(n_users), 0.0).numpy()
    nz = C > 0
    r = {"nonzero_cells": int(nz.sum()),
         "bits_differ": int((card[nz].view(np.int32) != host[nz].view(np.int32)).sum()),
         "max_abs": float(np.abs(card[nz] - host[nz]).max())}
    print(f"  K2 on the card against its plain chain on the CPU, the parity corpus's "
          f"{r['nonzero_cells']} nonzero counts: {r['bits_differ']} scores differ in their f32 "
          f"bits (max abs {r['max_abs']:.3g}); the host tail therefore scores on the card")
    return r


def scale_path(cco, hk, dev):
    """Phase 15: bench_scale's parity corpus through the four strategies
    (dense, resident, chunked, sparse with its host and device tails),
    bit-identical; then its full shape (50M events streamed through
    ``block_interactions_stream``) through ``cco_indicators`` resident
    (the auto rule's pick) and chunked (the resident budget at 0),
    bit-identical, each under the card's memory."""
    out = {"parity": {}, "full": {}}
    n_users, n_items, n_events, top_k, tile = SCALE_PARITY
    rng = np.random.default_rng(5)
    pu = rng.integers(0, n_users, n_events).astype(np.int32)
    pi = (rng.zipf(1.25, n_events) % n_items).astype(np.int32)
    n_tiles = -(-n_items // tile)
    settings = {   # name: (environment, module budgets, K2/K3 launches each)
        "dense": ({"PIO_CCO_DENSE": "1", "PIO_CCO_SPARSE": "0"}, {}, 1),
        "resident": ({"PIO_CCO_DENSE": "0", "PIO_CCO_SPARSE": "0"}, {}, n_tiles),
        "chunked": ({"PIO_CCO_DENSE": "0", "PIO_CCO_SPARSE": "0"},
                    {"_RESIDENT_CARD_SHARE": 0.0}, n_tiles),
        "sparse_host": ({"PIO_CCO_SPARSE": "1", "PIO_CCO_SPARSE_TAIL": "host"}, {}, 0),
        "sparse_device": ({"PIO_CCO_SPARSE": "1", "PIO_CCO_SPARSE_TAIL": "device"}, {}, 1),
    }
    tables = {}
    for name, (env, attrs, want) in settings.items():
        with cco_setting(cco, env, attrs):
            tables[name], r = timed_cco(hk, dev, lambda: cco.cco_indicators_coo(
                pu, pi, pu, pi, n_users, n_items, n_items, top_k=top_k, user_block=4_096,
                item_tile=tile, exclude_self=True, device=dev))
        check_self_table(*tables[name], n_items, top_k, f"parity leg, {name}")
        check(r["launches"] == [want, want],
              f"parity leg, {name}: K2/K3 launches {r['launches']}, expected {want} each")
        check(same_table(tables[name], tables["dense"]),
              f"parity leg: the {name} table differs from the dense one")
        out["parity"][name] = {**r, "events_per_s": n_events / r["wall_s"]}
        print(f"  parity leg ({n_users} users x {n_items} items, {n_events} zipf events, "
              f"top_k {top_k}, tile {tile}) {name}: {r['wall_s']:.3f} s, "
              f"{n_events / r['wall_s']:.4g} events/s, peak {r['peak_device_gb']:.3f} GB, "
              f"K2/K3 launches {r['launches']}; bit-identical to dense")
    del tables
    out["parity"]["cpu_log1p"] = cpu_plain_vs_card(cco, hk, dev, pu, pi, n_users, n_items)
    check_native_layout(cco, pu, pi, n_users, n_items)
    n_users, n_items, n_events, batch, user_block, tile, top_k = SCALE_FULL
    check(cco._resident_p_ok(n_users, n_items, tile, dev),
          "the auto rule should keep the full shape's primary resident on this card")
    t0 = time.perf_counter()
    blocked = cco.block_interactions_stream(
        gen_scale_batches(7, n_users, n_items, n_events, batch), n_users, n_items,
        user_block=user_block)
    out["full"]["staging_s"] = stage_s = time.perf_counter() - t0
    print(f"  full leg: {n_events} events streamed in batches of {batch} through "
          f"block_interactions_stream in {stage_s:.3f} s ({n_events / stage_s:.4g} events/s; "
          f"{blocked.n_blocks} blocks x {blocked.local_u.shape[1]} wide)")
    n_tiles = -(-n_items // tile)
    tables = {}
    for name, attrs in (("resident", {}), ("chunked", {"_RESIDENT_CARD_SHARE": 0.0})):
        with cco_setting(cco, {}, attrs):
            tables[name], r = timed_cco(hk, dev, lambda: cco.cco_indicators(
                blocked, blocked, n_total_users=n_users, top_k=top_k, item_tile=tile,
                exclude_self=True, device=dev))
        torch.cuda.empty_cache()
        check_self_table(*tables[name], n_items, top_k, f"full leg, {name}")
        check(r["launches"] == [n_tiles, n_tiles],
              f"full leg, {name}: K2/K3 launches {r['launches']}, expected {n_tiles} each")
        check(r["peak_device_gb"] * 1e9 <= CARD_BYTES,
              f"full leg, {name}: peak {r['peak_device_gb']:.3f} GB")
        out["full"][name] = {**r, "events_per_s": n_events / r["wall_s"]}
        print(f"  full leg ({n_users} users x {n_items} items, top_k {top_k}, tile {tile}, "
              f"user block {user_block}) {name}: train {r['wall_s']:.3f} s, "
              f"{n_events / r['wall_s']:.4g} events/s, peak {r['peak_device_gb']:.3f} GB, "
              f"K2/K3 launches {r['launches']}, {int((tables[name][1] >= 0).sum())} "
              "indicators set")
    check(same_table(tables["resident"], tables["chunked"]),
          "full leg: the resident and chunked tables differ")
    print("  full leg: resident and chunked tables bit-identical")
    launches = [sum(r["launches"][k] for leg in out.values() for r in leg.values()
                    if isinstance(r, dict) and "launches" in r) for k in (0, 1)]
    out["launches"] = launches
    return out


# -- phase 16: the similar-product template at the deployed width -------------------

SP_QUERIES = 200
SP_COOC_ID, SP_ALS_ID = "smoke-sp-cooc", "smoke-sp-als"


def sp_categories(n_items):
    """One or two of N_CATEGORIES categories an item (zipf-skewed), from
    the seed."""
    rng = np.random.default_rng(SEED + 16)
    first = (rng.zipf(1.3, n_items) - 1) % N_CATEGORIES
    second = np.where(rng.random(n_items) < 0.4,
                      (first + rng.integers(1, N_CATEGORIES, n_items)) % N_CATEGORIES, -1)
    return np.stack([first, second], 1)


def sp_variants(workdir):
    """examples/similar_product/engine.json on phase 11b's app (its
    cooccurrence algorithm as it is), and the same with the ALS algorithm
    (rank 10, 10 sweeps)."""
    base = json.loads((Path(__file__).resolve().parent / "examples/similar_product/"
                       "engine.json").read_text())
    base["datasource"]["params"]["appName"] = "smoke"
    cooc = {**base, "id": SP_COOC_ID}
    als = {**base, "id": SP_ALS_ID, "algorithms": [
        {"name": "als", "params": {"rank": 10, "numIterations": 10}}]}
    paths = {}
    for name, v in (("cooccurrence", cooc), ("als", als)):
        paths[name] = workdir / f"sp-{name}.json"
        paths[name].write_text(json.dumps(v))
    return paths, base["algorithms"][0]["params"]


def sp_queries(rng, n, n_items):
    """``n`` similar-product queries: 1-5 items, num of 1, 10 or 50, and on
    a share of them categories (and an unknown one), a whiteList, a
    blackList and items unknown to the model."""
    out = []
    for j in range(n):
        kind = j % 8
        body = {"items": [f"i{int(i)}" for i in rng.integers(0, n_items, int(rng.integers(1, 6)))],
                "num": int(rng.choice([1, 10, 50]))}
        if kind in (1, 5):
            body["categories"] = [f"c{int(c)}" for c in rng.choice(
                N_CATEGORIES, int(rng.integers(1, 3)), replace=False)]
        if kind == 2:
            body["whiteList"] = [f"i{int(i)}" for i in rng.integers(0, n_items, 2_000)]
        if kind in (3, 5):
            body["blackList"] = [f"i{int(i)}" for i in rng.integers(0, n_items, 20)]
        if kind == 4:
            body["categories"] = ["no-such-category"]
        if kind == 6:
            body["items"].append("no-such-item")
        out.append(body)
    return out


def llr64(k11, rc, cc, n):
    """Dunning's G² in float64, in Mahout's entropy form (independent of
    the port's determinant form in f32)."""
    def xlogx(x):
        return np.where(x > 0, x * np.log(np.maximum(x, 1e-300)), 0.0)

    k12, k21 = rc - k11, cc - k11
    k22 = n - k11 - k12 - k21
    row = xlogx(k11 + k12 + k21 + k22) - xlogx(k11 + k12) - xlogx(k21 + k22)
    col = xlogx(k11 + k12 + k21 + k22) - xlogx(k11 + k21) - xlogx(k12 + k22)
    mat = xlogx(k11 + k12 + k21 + k22) - xlogx(k11) - xlogx(k12) - xlogx(k21) - xlogx(k22)
    return np.maximum(2.0 * (row + col - mat), 0.0)


def check_sp_rows(model, td, min_llr, top_k, rows):
    """Sampled rows of the trained cooccurrence table against a float64
    numpy oracle on the training data: distinct (user, item) pairs, counts
    by bincount, G² by ``llr64``, the self-pair and scores under
    ``min_llr`` dropped, the top ``top_k`` by (score desc, id asc).  Scores
    within rtol/atol 1e-4; an id may differ only where the oracle's scores
    tie within that; the number set may differ only by cells within it of
    the threshold."""
    n_items, n_users = len(td.item_dict), len(td.user_dict)
    flat = np.unique(td.user_idx.astype(np.int64) * n_items + td.item_idx)
    du, di = flat // n_items, flat % n_items            # sorted by user
    cc = np.bincount(di, minlength=n_items).astype(np.float64)
    starts = np.searchsorted(du, np.arange(n_users + 1))
    for r in rows:
        co = np.concatenate([di[starts[u]:starts[u + 1]] for u in du[di == r]])
        k11 = np.bincount(co, minlength=n_items).astype(np.float64)
        s = np.where(k11 > 0, llr64(k11, cc[r], cc, float(n_users)), -np.inf)
        s[r] = -np.inf
        tol = 1e-4 + 1e-4 * np.abs(s)
        lo = int(min((s >= min_llr + tol).sum(), top_k))
        hi = int(min((s >= min_llr - tol).sum(), top_k))
        s[s < min_llr] = -np.inf
        want = np.lexsort((np.arange(n_items), -s))[:top_k]
        got_i, got_s = model.indicator_idx[r], model.indicator_llr[r]
        n_set = int((got_i >= 0).sum())
        check(lo <= n_set <= hi, f"row {r}: {n_set} indicators set, want {lo}..{hi}")
        for j in range(min(n_set, lo)):
            ws = s[want[j]]
            check(abs(got_s[j] - ws) <= tol[want[j]], f"row {r}: score {got_s[j]} vs {ws}")
            check(got_i[j] == want[j] or abs(s[got_i[j]] - ws) <= tol[want[j]],
                  f"row {r}: id {got_i[j]} where {want[j]} belongs")


def similar_product_path(hk, dev, workdir):
    """Phase 16: the similar-product template on phase 11b's app: ``$set``
    categories imported, ``pio train`` of examples/similar_product/
    engine.json (cooccurrence: resident, 25 K2 and 25 K3 launches) and of
    its ALS variant, each ``pio deploy``-ed on a thread and SP_QUERIES
    answers held against the CPU predict of the same model."""
    from predictionio_tpu_torch.models import similar_product as sp
    from predictionio_tpu_torch.workflow.core_workflow import load_latest_models
    from predictionio_tpu_torch.workflow.create_workflow import engine_from_variant

    _, n_items, _, _, _, tile = DEPLOYED_UR
    cats = sp_categories(n_items)
    jsonl = workdir / "sp-categories.jsonl"
    t = iso(T0 - 1)
    with open(jsonl, "w") as f:
        f.writelines(json.dumps({"event": "$set", "entityType": "item", "entityId": f"i{j}",
                                 "properties": {"categories": [f"c{c}" for c in cs if c >= 0]},
                                 "eventTime": t, "creationTime": t}) + "\n"
                     for j, cs in enumerate(cats.tolist()))
    pio("import", "--app-name", "smoke", "--input", str(jsonl))
    jsonl.unlink()
    paths, cooc_params = sp_variants(workdir)
    out = {}
    rng = np.random.default_rng(SEED + 17)
    bodies = sp_queries(rng, SP_QUERIES, n_items)
    n_tiles = -(-n_items // tile)
    for name, engine_id in (("cooccurrence", SP_COOC_ID), ("als", SP_ALS_ID)):
        pio("build", "--engine-json", str(paths[name]))
        r = {}
        _, r["pio_train"] = timed_cco(hk, dev, lambda: pio(
            "train", "--engine-json", str(paths[name])))
        want = n_tiles if name == "cooccurrence" else 0
        check(r["pio_train"]["launches"] == [want, want],
              f"similar-product {name}: K2/K3 launches {r['pio_train']['launches']}, "
              f"expected {want} each")
        factory, engine, ep = engine_from_variant(json.loads(paths[name].read_text()))
        if name == "cooccurrence":
            td = engine.make_components(ep)[0].read_training()
        _, (model,) = load_latest_models(engine_id, device=dev)
        check(type(model) is sp.SPModel and model.kind == name and model.device == dev,
              f"similar-product {name}: loaded {type(model).__name__}")
        check(len(model.item_dict) == n_items, f"similar-product {name}: {len(model.item_dict)} "
              "items")
        check(model.cat_masks.shape == (N_CATEGORIES, n_items), "category masks")
        if name == "cooccurrence":
            top_k = cooc_params["maxCorrelatorsPerItem"]
            check_self_table(np.where(model.indicator_idx >= 0, model.indicator_llr, -np.inf),
                             model.indicator_idx, n_items, top_k, "similar-product table")
            rows = np.random.default_rng(SEED + 18).choice(n_items, 64, replace=False)
            check_sp_rows(model, td, cooc_params["minLlr"], top_k, rows)
            print(f"  similar-product cooccurrence table [{n_items} x {top_k}], "
                  f"{int((model.indicator_idx >= 0).sum())} set; 64 sampled rows equal a "
                  "float64 numpy oracle from the view events")
        else:
            check(bool(np.isfinite(model.item_factors).all()), "non-finite SP factors")
        _, (cpu_model,) = load_latest_models(engine_id, device="cpu")
        cpu_predict = engine.predictor(ep, [cpu_model])
        with pio_deploy_here(paths[name]) as (base, up_s):
            answers, lat_ms = timed_posts(base + "/queries.json", bodies)
        swaps = answered = 0
        for body, got in zip(bodies, answers):
            q = factory.query_class.from_json(body)
            want_ans = cpu_predict(q).to_json()

            def full(q=q):
                q.num = n_items
                return {d.item: d.score for d in cpu_predict(q).item_scores}

            swaps += check_same_answer(body, got, want_ans, full)
            answered += bool(got["itemScores"])
        for body, got in zip(bodies, answers):
            if body.get("categories") == ["no-such-category"]:
                check(got == {"itemScores": []}, f"{body} answered {got}")
        rest = sorted(lat_ms[1:])
        r.update({"deploy_to_first_answer_s": up_s, "queries": len(bodies),
                  "answered": answered, "near_tie_swaps": swaps,
                  "http_p50_ms": rest[len(rest) // 2],
                  "http_p99_ms": rest[min(len(rest) - 1, int(0.99 * len(rest)))]})
        out[name] = r
        p = r["pio_train"]
        print(f"  similar-product {name}: pio train {p['wall_s']:.3f} s (peak "
              f"{p['peak_device_gb']:.3f} GB, K2/K3 launches {p['launches']}); pio deploy to "
              f"first answer {up_s:.3f} s; {len(bodies)} queries ({answered} non-empty) equal "
              f"to the CPU predict, {swaps} near-tie swaps; p50 {r['http_p50_ms']:.3f} ms "
              f"p99 {r['http_p99_ms']:.3f} ms")
        del model, cpu_model
        torch.cuda.empty_cache()
    del td
    out["launches"] = [out["cooccurrence"]["pio_train"]["launches"][k] for k in (0, 1)]
    return out


def check_same_answer(body, got, want, full) -> int:
    """The served answer against the CPU predict of the same model: the
    same length, scores within rtol/atol 1e-5, items in the same order
    except swaps between scores that tie within the bar (the card's float
    scatter-add and matmul sum in another order); ``full()`` is the CPU
    predict of every eligible item, read only at a swap.  Returns the
    swaps."""
    g = [(d["item"], d["score"]) for d in got["itemScores"]]
    w = [(d["item"], d["score"]) for d in want["itemScores"]]
    check(len(g) == len(w), f"{body}: {len(g)} items, want {len(w)}")
    swaps, every = 0, None
    for (gi, gs), (wi, ws) in zip(g, w):
        tol = ATOL + RTOL * abs(ws)
        check(abs(gs - ws) <= tol, f"{body}: score {gs} vs {ws}")
        if gi != wi:
            every = every or full()
            check(gi in every and abs(every[gi] - ws) <= tol,
                  f"{body}: item {gi} where {wi} belongs")
            swaps += 1
    return swaps

# -- phase 18: pio eval and the five remaining templates ---------------------------

# 18a: MovieLens-100K's users and items (bench.py:363-380) with half its
# ratings, a depth cut that keeps the script inside its time limit
EVAL_ALS = BENCH_ALS[:2] + (50_000,) + BENCH_ALS[3:]
# 18a: card vs CPU scores of the same evaluation; 1e-4 is about 3 of the
# ~30,000 held-out ratings of 4 or more that precision@10 scores
EVAL_SCORE_ATOL = 1e-4
UR_EVAL_USERS = 500               # 18b: the example's eval_users
UR_BUNDLES = (100, 5_000)         # 18b: planted bundles, and the new users who buy one
CP_QUERIES = 200                  # 18c: carts of 1-5 items
CP_CUT = (20_000, 4_000)          # 18c: items and first baskets of the CPU cut
PR_QUERIES, PR_CLIENTS = 200, 8   # 18d
PR_RTOL = 1e-4
LEG_QUERIES = 100                 # 18e: queries a leg
TEXT_MESSAGES, TEXT_DIM = 5_574, 4_096   # the SMS Spam Collection's count
# 18e's classification and lead-scoring sizes are halved (from 10,000 users
# and 100,000 sessions) to keep phase 18 near 90 s; 18a-18c run whole
CLS_USERS = 5_000
LEAD_SESSIONS = 50_000
CONF_ATOL = 1e-4                  # 18e: card vs CPU confidences and scores


def port_example(workdir, example, name, replace=()):
    """A copy of the port's ``predictionio_tpu_torch/examples/<example>/
    evaluation.py`` with each (old, new) of ``replace`` applied, imported as
    ``name`` from a directory of the work dir put on ``sys.path``."""
    import importlib

    src = (Path(__file__).resolve().parent / "predictionio_tpu_torch" / "examples" / example
           / "evaluation.py").read_text()
    for old, new in replace:
        check(old in src, f"the port's {example} example has no {old!r}")
        src = src.replace(old, new)
    check("predictionio_tpu." not in src, f"the port's {example} example names the JAX package")
    mods = workdir / "evalmods"
    mods.mkdir(exist_ok=True)
    (mods / f"{name}.py").write_text(src)
    if str(mods) not in sys.path:
        sys.path.insert(0, str(mods))
    return importlib.import_module(name)


def eval_ratings():
    """18a's rate events (``EVAL_ALS``), from the seed: users in 8
    taste groups, items in 8 genres; 60% of a user's ratings fall in the
    group's genre (rated 4-5), the rest anywhere (rated 1-3)."""
    n_users, n_items, n_ratings, _, _ = EVAL_ALS
    rng = np.random.default_rng(SEED + 180)
    group, genre = rng.integers(0, 8, n_users), rng.integers(0, 8, n_items)
    u = rng.integers(0, n_users, n_ratings)
    i = rng.integers(0, n_items, n_ratings)
    pref = rng.random(n_ratings) < 0.6
    for g in range(8):
        sel = pref & (group[u] == g)
        i[sel] = rng.choice(np.flatnonzero(genre == g), int(sel.sum()))
    r = np.where(pref, rng.integers(4, 6, n_ratings), rng.integers(1, 4, n_ratings))
    return u, i, r


def eval_scores(inst):
    check(inst.status == "EVALCOMPLETED", f"evaluation instance {inst.id}: {inst.status}")
    doc = json.loads(inst.evaluator_results_json)
    return doc["bestScore"], [c["score"] for c in doc["engineParamsScores"]]


def write_ratings_jsonl(path, u, i, r):
    """18a's rate events as a JSON-lines file for ``pio import``, one a
    second from T0 (lines by one format string)."""
    times = T0 + np.arange(len(u), dtype=np.float64)
    iso_t = np.datetime_as_string(times.astype(np.int64).astype("datetime64[s]"),
                                  timezone="UTC").tolist()
    line = ('{"event":"rate","entityType":"user","entityId":"u%d","targetEntityType":"item",'
            '"targetEntityId":"i%d","properties":{"rating":%d},"eventTime":"%s",'
            '"creationTime":"%s"}\n')
    with open(path, "w") as f:
        f.writelines(map(line.__mod__, zip(u.tolist(), i.tolist(), r.tolist(), iso_t, iso_t)))


def eval_reco_path(hk, dev, workdir):
    """18a: ``pio eval`` of the port's example predictionio_tpu_torch/
    examples/recommendation/evaluation.py by package path (precision@10,
    3 folds, ALS ranks 4 and 8) on bench_als's shape, its app ``MyApp``
    imported into the work dir's localfs store, then the same evaluation
    through run_eval with ``FastEvalEngine`` (the data source read once for both candidates), both on the card; and by
    ``Evaluation.run`` on the CPU: every score within EVAL_SCORE_ATOL of
    it; and FastEval's served lists against its card-trained factors
    scored on the CPU (``check_reco_folds``)."""
    import importlib

    from predictionio_tpu_torch.models.recommendation import engine as reco_engine
    from predictionio_tpu_torch.storage import get_storage
    from predictionio_tpu_torch.workflow.core_workflow import run_eval
    from predictionio_tpu_torch.workflow.fast_eval import FastEvalEngine

    u, i, r = eval_ratings()
    jsonl = workdir / "myapp.jsonl"
    write_ratings_jsonl(jsonl, u, i, r)
    t0 = time.perf_counter()
    pio("app", "new", "MyApp")
    pio("import", "--app-name", "MyApp", "--input", str(jsonl))
    jsonl.unlink()
    out = {"events": len(u), "import_s": time.perf_counter() - t0}
    # the port's example itself, as `pio eval` names it by package path
    module = importlib.import_module("predictionio_tpu_torch.examples.recommendation.evaluation")
    path = f"{module.__name__}.RecommendationEvaluation"
    hk.reset_k1_counts()
    t0 = time.perf_counter()
    pio("eval", path)
    torch.cuda.synchronize()
    out["pio_eval_s"] = time.perf_counter() - t0
    out["k1_launches_pio_eval"] = hk.masked_score_matmul.launches

    def instance(cls):
        (inst,) = [x for x in get_storage().evaluation_instances.get_completed()
                   if x.evaluation_class == cls]
        return inst

    inst = instance(path)
    card_best, card = eval_scores(inst)
    # the FastEval run's host clock by stage (each call synchronized), and
    # the data source's reads counted
    split = {"read_eval": [], "train": [], "batch_predict": []}
    wrapped = [(reco_engine.RecoDataSource, "read_eval"), (reco_engine.ALSAlgorithm, "train"),
               (reco_engine.ALSAlgorithm, "batch_predict")]
    real = {name: getattr(cls, name) for cls, name in wrapped}

    def timed(name):
        def call(*args):
            t0 = time.perf_counter()
            try:
                return real[name](*args)
            finally:
                torch.cuda.synchronize()
                split[name].append(time.perf_counter() - t0)
        return call

    evaluation = module.RecommendationEvaluation()
    fast = FastEvalEngine(evaluation.engine, device=dev)
    recorded = []

    def runner(engine, ep):
        res = fast.eval(engine, ep)
        recorded.append(res)
        return res

    for cls, name in wrapped:
        setattr(cls, name, timed(name))
    try:
        hk.reset_k1_counts()
        t0 = time.perf_counter()
        res = run_eval(evaluation, evaluation_class=path + " (FastEval)", device=dev,
                       eval_runner=runner)
        torch.cuda.synchronize()
        out["fast_eval_s"] = time.perf_counter() - t0
        out["k1_launches_fast_eval"] = hk.masked_score_matmul.launches
    finally:
        for cls, name in wrapped:
            setattr(cls, name, real[name])
    out["fast_eval_split_s"] = {k: sum(v) for k, v in split.items()}
    reads = split["read_eval"]
    check(len(reads) == 1 and fast.stats["folds"] == 1 and fast.stats["folds_hit"] == 1,
          f"FastEvalEngine read the folds {len(reads)} times ({fast.stats})")
    stats = dict(fast.stats)
    t0 = time.perf_counter()
    out["folds_check"] = check_reco_folds(reco_engine, evaluation, fast, recorded)
    out["folds_check"]["cpu_batch_predict_s"] = time.perf_counter() - t0
    fast_best, fast_scores = eval_scores(instance(path + " (FastEval)"))
    check(fast_best == res.best_score, "the FastEval instance's best score")
    t0 = time.perf_counter()
    cpu_eval = module.RecommendationEvaluation()
    cpu = cpu_eval.run(eval_runner=FastEvalEngine(cpu_eval.engine, device="cpu").eval)
    out["cpu_eval_s"] = time.perf_counter() - t0
    cpu_scores = [s for _, s, _ in cpu.engine_params_scores]
    for name, best, scores in (("pio eval", card_best, card),
                               ("FastEval", fast_best, fast_scores)):
        check(len(scores) == 2, f"{name}: {len(scores)} candidates")
        check(abs(best - cpu.best_score) <= EVAL_SCORE_ATOL,
              f"{name}: best {best} vs the CPU's {cpu.best_score}")
        for s, c in zip(scores, cpu_scores):
            check(abs(s - c) <= EVAL_SCORE_ATOL, f"{name}: score {s} vs the CPU's {c}")
    for key in ("k1_launches_pio_eval", "k1_launches_fast_eval"):
        check(out[key] >= 6, f"18a: {out[key]} K1 launches ({key}), want >= 6")
    out.update({"pio_eval_scores": card, "fast_eval_scores": fast_scores,
                "cpu_scores": cpu_scores, "fast_eval_stats": stats,
                "instance_status": inst.status})
    print(f"  18a pio eval (recommendation, {len(u)} ratings, ranks 4 and 8, 3 folds): "
          f"import {out['import_s']:.3f} s; pio eval {out['pio_eval_s']:.3f} s, precision@10 "
          f"{card} (K1 launches {out['k1_launches_pio_eval']}); FastEval "
          f"{out['fast_eval_s']:.3f} s (host clock by stage: "
          f"{ {k: round(v, 3) for k, v in out['fast_eval_split_s'].items()} }), "
          f"{fast_scores}, folds read once ({stats}); CPU "
          f"{out['cpu_eval_s']:.3f} s, {cpu_scores}; instances EVALCOMPLETED; served "
          f"lists of {out['folds_check']['lists']} fold queries equal to the card's factors "
          f"scored on the CPU ({out['folds_check']['near_tie_swaps']} near-tie swaps, "
          f"{out['folds_check']['moved_scores']} precision@10 scores moved by one; "
          f"{out['folds_check']['cpu_batch_predict_s']:.3f} s)")
    return out


def check_reco_folds(reco_engine, evaluation, fast, recorded):
    """18a: every candidate's card-trained factors, fold by fold, answer the
    fold's queries again in ``batch_predict`` on the CPU (K1's plain
    version): the same lists as FastEval served on the card, but for swaps
    between items whose float64 host scores tie within rtol/atol 1e-5;
    precision@10 equal query by query unless the held-out item is one a
    swap moved across the list's end."""
    metric = evaluation.metric
    swaps = moved = lists = 0
    for ci, ep in enumerate(evaluation.engine_params_list):
        _, per_fold = fast._get_models(ep)
        algo = evaluation.engine.make_components(ep, device="cpu")[2][0]
        check(len(recorded[ci]) == len(per_fold), f"18a: {len(recorded[ci])} folds recorded")
        for (info, qpa), (model,) in zip(recorded[ci], per_fold):
            cpu_model = reco_engine.ALSModel(model.user_factors, model.item_factors,
                                             model.user_dict, model.item_dict, model.seen,
                                             device="cpu")
            cpu = algo.batch_predict(cpu_model, [q for q, _, _ in qpa])
            fold_moved = moved
            uf = np.asarray(model.user_factors, np.float64)
            itf = np.asarray(model.item_factors, np.float64)
            for (q, p, a), c in zip(qpa, cpu):
                g = [(x.item, x.score) for x in p.item_scores]
                w = [(x.item, x.score) for x in c.item_scores]
                tag = f"18a candidate {ci} {info} user {q.user}"
                check(len(g) == len(w), f"{tag}: {len(g)} items on the card, {len(w)} on the CPU")
                for (gi, gs), (wi, ws) in zip(g, w):
                    tol = ATOL + RTOL * abs(ws)
                    check(abs(gs - ws) <= tol, f"{tag}: score {gs} vs {ws}")
                    if gi != wi:
                        host = float(uf[model.user_dict.id(q.user)]
                                     @ itf[model.item_dict.id(gi)])
                        check(abs(host - ws) <= tol, f"{tag}: item {gi} where {wi} belongs")
                        swaps += 1
                if metric.score_one(q, p, a) != metric.score_one(q, c, a):
                    check(a[0] in {i for i, _ in g} ^ {i for i, _ in w},
                          f"{tag}: precision@10 differs with no swap at the held-out item")
                    moved += 1
                lists += 1
            if moved == fold_moved:
                check(metric.calculate([(info, qpa)]) == metric.calculate(
                    [(info, [(q, c, a) for (q, _, a), c in zip(qpa, cpu)])]),
                      f"18a candidate {ci} {info}: precision@10 on the card and the CPU")
    return {"lists": lists, "near_tie_swaps": swaps, "moved_scores": moved}


def same_rank_lists(card, cpu, rtol=RTOL):
    """Card and CPU answers of one query: the same items in the same order
    but for swaps between scores within ``rtol`` of each other; returns
    the swaps."""
    g = [(s.item, s.score) for s in card.item_scores]
    w = [(s.item, s.score) for s in cpu.item_scores]
    check(len(g) == len(w), f"{len(g)} items on the card, {len(w)} on the CPU")
    swaps = 0
    for (gi, gs), (wi, ws) in zip(g, w):
        check(abs(gs - ws) <= ATOL + rtol * abs(ws), f"score {gs} vs {ws}")
        if gi != wi:
            check(gi in dict(w) and abs(dict(w)[gi] - ws) <= ATOL + rtol * abs(ws),
                  f"item {gi} where {wi} belongs")
            swaps += 1
    return swaps


def plant_bundles(workdir, n_users, n_items):
    """18b's signal in 11b's app, whose zipf purchases are independent of
    the user: UR_BUNDLES[1] new users each buy the first three items of one
    of UR_BUNDLES[0] bundles (four items each from the catalog's tail,
    which the zipf draws almost never reach) and then its fourth, a second
    apart and after every other event of the app, so the fourth is the
    purchase the leave-one-out split holds out.  Imported with ``pio
    import``; returns the events planted."""
    n_bundles, n_buyers = UR_BUNDLES
    users = (n_users + np.arange(n_buyers)).astype(np.int32)
    bundle = np.arange(n_buyers) % n_bundles
    items = n_items - 4 * n_bundles + 4 * bundle[:, None] + np.arange(4)
    times = T0 + 100_000_000 + 4 * np.arange(n_buyers)[:, None] + np.arange(4)
    path = workdir / "bundles.jsonl"
    with open(path, "w") as f:
        write_interactions(f, [("purchase", np.repeat(users, 4), items.ravel().astype(np.int32),
                                times.ravel().astype(np.float64))])
    pio("import", "--app-name", "smoke", "--input", str(path))
    path.unlink()
    return items.size


def rank_of(result, item):
    return next((r for r, s in enumerate(result.item_scores) if s.item == item), None)


def eval_ur_path(hk, dev, workdir):
    """18b: UR_BUNDLES planted in 11b's app (``plant_bundles``), then a
    copy of the port's predictionio_tpu_torch/examples/universal_recommender/
    evaluation.py (UREvaluation + MinLlrGrid: min_llr 0, 2, 5; eval_users
    500) on it through run_eval with FastEvalEngine on the card: K2 and K3 launch 3 x
    a train's count, and every candidate's hit rate is above 0; each
    candidate's card-trained model is then moved to the CPU and its
    batch_predict run there (the device halves pinned, the card's code
    path): lists equal but for swaps at near ties, and the four rank
    metrics equal, with the card's list kept for any query whose held-out
    item a swap moved."""
    from predictionio_tpu_torch.workflow.core_workflow import run_eval
    from predictionio_tpu_torch.workflow.fast_eval import FastEvalEngine

    n_users, n_items, _, _, _, tile = DEPLOYED_UR
    t0 = time.perf_counter()
    planted = plant_bundles(workdir, n_users, n_items)
    plant_s = time.perf_counter() - t0
    module = port_example(workdir, "universal_recommender", "port_ur_evaluation",
                          [('"MyShop"', '"smoke"'),
                           ("eval_users=500", f"eval_users={UR_EVAL_USERS}")])
    evaluation = module.UREvaluation()
    evaluation.engine_params_list = list(module.MinLlrGrid().engine_params_list)
    fast = FastEvalEngine(evaluation.engine, device=dev)
    recorded = []

    def runner(engine, ep):
        res = fast.eval(engine, ep)
        recorded.append(res)
        return res

    result, r = timed_cco(hk, dev, lambda: run_eval(
        evaluation, evaluation_class="port_ur_evaluation.UREvaluation", device=dev,
        eval_runner=runner))
    per_train = 2 * -(-n_items // tile)
    n_cand = len(evaluation.engine_params_list)
    check(r["launches"] == [n_cand * per_train] * 2,
          f"18b: K2/K3 launches {r['launches']}, want {n_cand} x {per_train} each")
    metrics = [evaluation.metric] + list(evaluation.other_metrics)
    out = {"planted_events": planted, "plant_import_s": plant_s, "eval_s": r["wall_s"],
           "launches": r["launches"], "peak_device_gb": r["peak_device_gb"],
           "candidates": []}
    saved = {k: os.environ.get(k) for k in ("PIO_UR_SERVE_SCORER", "PIO_UR_SERVE_TAIL")}
    os.environ.update(PIO_UR_SERVE_SCORER="device", PIO_UR_SERVE_TAIL="device")
    try:
        for ci, ep in enumerate(evaluation.engine_params_list):
            (info, qpa), = recorded[ci]
            check(len(qpa) == UR_EVAL_USERS, f"18b: {len(qpa)} eval queries")
            _, per_fold = fast._get_models(ep)
            model = per_fold[0][0]
            algo = evaluation.engine.make_components(ep)[2][0]
            model.to_device("cpu")
            t0 = time.perf_counter()
            cpu = algo.batch_predict(model, [q for q, _, _ in qpa])
            cpu_s = time.perf_counter() - t0
            swaps = sum(same_rank_lists(p, c) for (_, p, _), c in zip(qpa, cpu))
            # the UR blacklists the user's own purchases: a held-out item
            # bought before can never be a hit
            seen = sum(model.item_dict.id(a) in set(model.user_seen.row(
                model.user_dict.id(q.user)).tolist()) for q, _, a in qpa)
            answered = sum(bool(p.item_scores) for _, p, _ in qpa)
            card_v = [m.calculate([(info, qpa)]) for m in metrics]
            cpu_v = [m.calculate([(info, [(q, c, a) for (q, _, a), c in zip(qpa, cpu)])])
                     for m in metrics]
            _, score, others = result.engine_params_scores[ci]
            check(card_v == [score] + list(others), "18b: the recorded metrics")
            check(card_v[0] > 0, f"18b candidate {ci}: hit rate {card_v[0]}")
            # a held-out item ranked elsewhere on the CPU must sit where a
            # near-tie swap changed the list; such a query keeps the card's
            # list, and then every metric must agree exactly
            moved, patched = 0, []
            for (q, p, a), c in zip(qpa, cpu):
                rp, rc = rank_of(p, a), rank_of(c, a)
                if rp != rc:
                    check(rp is not None and rc is not None
                          and p.item_scores[rp].item != c.item_scores[rp].item
                          and p.item_scores[rc].item != c.item_scores[rc].item,
                          f"18b candidate {ci}: {q.user}'s held-out item moved without a swap")
                    moved += 1
                patched.append((q, p if rp != rc else c, a))
            check([m.calculate([(info, patched)]) for m in metrics] == card_v
                  and (moved > 0 or cpu_v == card_v),
                  f"18b candidate {ci}: metrics {card_v} on the card, {cpu_v} on the CPU "
                  f"({moved} held-out items moved by a swap)")
            out["candidates"].append({"metrics_card": card_v, "metrics_cpu": cpu_v,
                                      "near_tie_swaps": swaps, "moved_by_a_swap": moved,
                                      "cpu_batch_predict_s": cpu_s, "answered": answered,
                                      "held_out_in_history": seen})
            print(f"  18b candidate {ci} ({[m.header() for m in metrics]}): card {card_v}, "
                  f"CPU {cpu_v}, {swaps} near-tie swaps over {len(qpa)} lists ({moved} moved "
                  f"a held-out item; {answered} non-empty; {seen} held-out items already in "
                  f"the user's purchases); CPU batch_predict {cpu_s:.3f} s")
            del model
    finally:
        restore_env(saved)
    torch.cuda.empty_cache()
    print(f"  18b pio eval (UR, 11b's app and {planted} planted purchases imported in "
          f"{plant_s:.3f} s, {n_cand} candidates, {UR_EVAL_USERS} users): "
          f"{r['wall_s']:.3f} s, K2/K3 launches {r['launches']}, peak "
          f"{r['peak_device_gb']:.3f} GB, best {result.metric_header} {result.best_score:.6f} "
          f"(candidate {result.best_index})")
    return out


def cp_variant():
    return {"id": "smoke-cp", "engineFactory": "complementary_purchase",
            "datasource": {"params": {"appName": "smoke", "eventName": "purchase",
                                      "basketWindow": "1 hour"}},
            "algorithms": [{"name": "rules", "params": {"maxRulesPerItem": 20}}]}


def capture_basket_tile(cco, td, dev, t):
    """Tile ``t``'s rule scores [n_items, tile] of the complementary-purchase
    train, rebuilt as ``basket_rules`` builds them (for phase 13's K3 row),
    on the host, and the tile's first item id."""
    n_items = len(td.item_dict)
    tile = cco.basket_tile(n_items)
    chunk = max(256, min(cco._BASKET_CHUNK, (cco._BASKET_CHUNK_BYTES // (n_items * 2))
                         // 256 * 256))
    baskets = cco._StagedBaskets(td.basket_idx, td.item_idx, n_items, lambda n_b: chunk, dev)
    t0 = t * tile
    width = min(tile, n_items - t0)
    counts = torch.zeros((baskets.rows, cco._round_up(width, 8)), dtype=torch.int32, device=dev)
    for c in range(baskets.n_chunks):
        m = baskets.matrix(c)
        counts += cco._count_product(m, cco._tile_slab(m, t0, width))
    ci = torch.as_tensor(baskets.ci.astype(np.float32)).to(dev)
    n = torch.tensor(float(td.n_baskets), device=dev)
    zero = torch.zeros((), device=dev)
    s = cco._basket_scores(counts[:n_items, :width].to(torch.float32), ci[:, None],
                           ci[t0:t0 + width][None, :], n, zero, zero)
    s.diagonal(offset=-t0).fill_(float("-inf"))
    return s.cpu(), t0


def cp_bodies(rng, n, n_items):
    """Carts of 1-5 items, zipf-popular (as the purchases are), num 1, 5 or
    20; every eighth with an item unknown to the model."""
    out = []
    for j in range(n):
        items = [f"i{int(x)}" for x in rng.zipf(1.3, int(rng.integers(1, 6))) % n_items]
        if j % 8 == 7:
            items.append("no-such-item")
        out.append({"items": items, "num": int(rng.choice([1, 5, 20]))})
    return out


def cp_path(cco, hk, dev, workdir):
    """18c: the complementary-purchase template on 11b's app (its purchase
    events in 1-hour baskets): ``pio train`` (item tiles through K3's carry
    form, one launch a tile), ``pio deploy`` on a thread and CP_QUERIES
    carts, each answer valid and held against the CPU predict of the same
    model; a CP_CUT cut of the same baskets through the tiled strategy on
    the card and on the CPU, bit-equal."""
    from predictionio_tpu_torch.models.complementary_purchase import engine as cp
    from predictionio_tpu_torch.workflow.core_workflow import load_latest_models
    from predictionio_tpu_torch.workflow.create_workflow import engine_from_variant

    path = workdir / "cp.json"
    path.write_text(json.dumps(cp_variant()))
    pio("build", "--engine-json", str(path))
    factory, engine, ep = engine_from_variant(cp_variant())
    td = engine.make_components(ep)[0].read_training()
    n_items = len(td.item_dict)
    tile = cco.basket_tile(n_items)
    n_tiles = -(-n_items // tile)
    _, r = timed_cco(hk, dev, lambda: pio("train", "--engine-json", str(path)))
    check(r["launches"] == [0, n_tiles], f"18c: K2/K3 launches {r['launches']}, want "
          f"[0, {n_tiles}] ({n_items} items, tile {tile})")
    _, (model,) = load_latest_models("smoke-cp", device=dev)
    _, (cpu_model,) = load_latest_models("smoke-cp", device="cpu")
    check(type(model) is cp.CPModel and model.comp_idx.shape == (n_items, 20), "18c: the model")
    rules = int((model.comp_idx >= 0).sum())
    check(rules > 0 and bool((model.comp_idx < n_items).all()), "18c: the rule table")
    cpu_predict = engine.predictor(ep, [cpu_model])
    bodies = cp_bodies(np.random.default_rng(SEED + 181), CP_QUERIES, n_items)
    with pio_deploy_here(path) as (base, up_s):
        answers, lat_ms = timed_posts(base + "/queries.json", bodies)
    swaps = answered = 0
    for body, got in zip(bodies, answers):
        for d in got["itemScores"]:
            check(model.item_dict.id(d["item"]) is not None and np.isfinite(d["score"])
                  and d["score"] > 0, f"18c: {body} answered {d}")
        q = factory.query_class.from_json(body)

        def full(q=q):
            q.num = n_items
            return {d.item: d.score for d in cpu_predict(q).item_scores}

        swaps += check_same_answer(body, got, cpu_predict(q).to_json(), full)
        answered += bool(got["itemScores"])
    check(answered >= CP_QUERIES // 2, f"18c: {answered} of {CP_QUERIES} carts answered")
    n_cut, b_cut = CP_CUT
    keep = (td.item_idx < n_cut) & (td.basket_idx < b_cut)
    check(n_cut > cco._BASKET_RULES_DENSE_MAX_ITEMS, "18c: the cut takes the tiled strategy")
    t0 = time.perf_counter()
    card_cut = cco.basket_rules(td.basket_idx[keep], td.item_idx[keep], b_cut, n_cut,
                                top_k=20, device=dev)
    cut_card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_cut = cco.basket_rules(td.basket_idx[keep], td.item_idx[keep], b_cut, n_cut,
                               top_k=20, device="cpu")
    cut_cpu_s = time.perf_counter() - t0
    check(np.array_equal(card_cut[1], cpu_cut[1]) and np.array_equal(card_cut[0], cpu_cut[0]),
          "18c: the cut's ids or lifts differ between the card and the CPU")
    tile_scores = capture_basket_tile(cco, td, dev, min(12, n_tiles - 1))
    rest = sorted(lat_ms[1:])
    out = {"pio_train_s": r["wall_s"], "peak_device_gb": r["peak_device_gb"],
           "launches": r["launches"], "n_items": n_items, "n_baskets": td.n_baskets,
           "tile": tile, "tiles": n_tiles, "rules": rules, "deploy_to_first_answer_s": up_s,
           "answered": answered, "near_tie_swaps": swaps,
           "http_p50_ms": rest[len(rest) // 2],
           "http_p99_ms": rest[min(len(rest) - 1, int(0.99 * len(rest)))],
           "cut": {"items": n_cut, "baskets": b_cut, "events": int(keep.sum()),
                   "rules": int((cpu_cut[1] >= 0).sum()), "card_s": cut_card_s,
                   "cpu_s": cut_cpu_s}}
    print(f"  18c complementary purchase: {td.n_baskets} baskets of {len(td.item_idx)} purchases "
          f"over {n_items} items, pio train {r['wall_s']:.3f} s ({n_tiles} tiles of {tile}, "
          f"K3 launches {r['launches'][1]}, peak {r['peak_device_gb']:.3f} GB), {rules} rules; "
          f"{CP_QUERIES} carts ({answered} answered) equal the CPU predict, {swaps} near-tie "
          f"swaps, p50 {out['http_p50_ms']:.3f} ms p99 {out['http_p99_ms']:.3f} ms; cut "
          f"{n_cut} items x {b_cut} baskets bit-equal to the CPU (card {cut_card_s:.3f} s, "
          f"CPU {cut_cpu_s:.3f} s)")
    del model, cpu_model, td
    torch.cuda.empty_cache()
    return out, tile_scores


def pr_bodies(rng, n, n_users, n_items):
    """Queries of 5-50 items for known users, with an unknown user and an
    unknown item now and then."""
    out = []
    for j in range(n):
        user = f"u{int(rng.integers(0, n_users))}" if j % 10 else "no-such-user"
        items = [f"i{int(x)}" for x in rng.integers(0, n_items, int(rng.integers(5, 51)))]
        if j % 7 == 3:
            items.append("no-such-item")
        out.append({"user": user, "items": items})
    return out


def pr_path(dev, workdir):
    """18d: examples/product_ranking/engine.json on 12b's shop: ``pio
    train`` on the card, ``pio deploy`` on a thread, PR_QUERIES queries
    from PR_CLIENTS keep-alive clients (micro-batched through
    ``serve_batch_predict``), every answer held against the CPU predict of
    the same model (order, scores within rtol PR_RTOL)."""
    from predictionio_tpu_torch.workflow.core_workflow import load_latest_models
    from predictionio_tpu_torch.workflow.create_workflow import engine_from_variant

    n_users, n_items = DEPLOYED_ALS[:2]
    variant = json.loads((Path(__file__).resolve().parent / "examples/product_ranking/"
                          "engine.json").read_text())
    variant["id"] = "smoke-pr"
    variant["datasource"]["params"]["appName"] = "shop"
    path = workdir / "pr.json"
    path.write_text(json.dumps(variant))
    pio("build", "--engine-json", str(path))
    t0 = time.perf_counter()
    pio("train", "--engine-json", str(path))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    factory, engine, ep = engine_from_variant(variant)
    _, (cpu_model,) = load_latest_models("smoke-pr", device="cpu")
    cpu_predict = engine.predictor(ep, [cpu_model])
    bodies = pr_bodies(np.random.default_rng(SEED + 182), PR_QUERIES, n_users, n_items)
    before = batch_hist_snapshot()
    with pio_deploy_here(path) as (base, up_s):
        port = int(base.rsplit(":", 1)[1])
        statuses, lat_ms, answers, wall = run_clients(workdir, port, "/queries.json", bodies,
                                                      PR_CLIENTS)
    batch = batch_hist_delta(before, batch_hist_snapshot())
    check(set(statuses) == {200}, f"18d: statuses {sorted(set(statuses))}")
    swaps = 0
    for body, got in zip(bodies, answers):
        want = cpu_predict(factory.query_class.from_json(body)).to_json()
        check(got["isOriginal"] == want["isOriginal"], f"18d: {body['user']} isOriginal")
        g = [(d["item"], d["score"]) for d in got["itemScores"]]
        w = [(d["item"], d["score"]) for d in want["itemScores"]]
        check(sorted(i for i, _ in g) == sorted(i for i, _ in w), "18d: the items ranked")
        for (gi, gs), (wi, ws) in zip(g, w):
            check(abs(gs - ws) <= ATOL + PR_RTOL * abs(ws), f"18d: score {gs} vs {ws}")
            if gi != wi:
                check(abs(dict(w)[gi] - ws) <= ATOL + PR_RTOL * abs(ws),
                      f"18d: {gi} where {wi} belongs")
                swaps += 1
    lat = sorted(lat_ms)
    out = {"pio_train_s": train_s, "deploy_to_first_answer_s": up_s, "near_tie_swaps": swaps,
           "p50_ms": lat[len(lat) // 2], "p99_ms": lat[min(len(lat) - 1, int(0.99 * len(lat)))],
           "qps": len(bodies) / wall, "batch": batch,
           "original": sum(a["isOriginal"] for a in answers)}
    print(f"  18d product ranking (shop: {len(cpu_model.user_dict)} users x "
          f"{len(cpu_model.item_dict)} items): pio train {train_s:.3f} s; {PR_QUERIES} queries "
          f"of 5-50 items from {PR_CLIENTS} clients, p50 {out['p50_ms']:.3f} ms p99 "
          f"{out['p99_ms']:.3f} ms {out['qps']:.1f} q/s, mean batch {batch['mean']:.2f}; equal to "
          f"the CPU predict ({swaps} near-tie swaps, {out['original']} unrankable)")
    return out


def cls_events(Event, n_users):
    rng = np.random.default_rng(SEED + 183)
    a = rng.integers(0, 5, (n_users, 3)).astype(float)
    z = a[:, 0] - 0.8 * a[:, 1] + 0.5 * a[:, 2] + rng.normal(0, 1.0, n_users)
    labels = np.where(z > 2.5, "high", np.where(z > 0.5, "mid", "low"))
    out = []
    for u in range(n_users):
        t = T0 + u
        out.append(Event("$set", "user", f"u{u}", properties={
            "attr0": a[u, 0], "attr1": a[u, 1], "attr2": a[u, 2]}, event_time=t, creation_time=t))
        out.append(Event("$set", "user", f"u{u}", properties={"label": str(labels[u])},
                         event_time=t + 0.5, creation_time=t + 0.5))
    return out


def lead_events(Event, n_sessions):
    rng = np.random.default_rng(SEED + 184)
    pages = [f"/p{k}" for k in range(40)]
    refs, browsers = ["google", "direct", "ads", "mail", "social"], ["Chrome", "Safari", "Edge"]
    out = []
    for s in range(n_sessions):
        t = T0 + 3 * s
        page = pages[int(rng.zipf(1.4)) % len(pages)]
        ref = refs[int(rng.integers(len(refs)))]
        props = {"sessionId": f"s{s}", "landingPageId": page, "referrerId": ref,
                 "browser": browsers[int(rng.integers(len(browsers)))]}
        out.append(Event("view", "user", f"v{s % 20_000}", "item", page, properties=props,
                         event_time=t, creation_time=t))
        rate = 0.05 + 0.25 * (page in ("/p1", "/p2")) + 0.1 * (ref == "ads")
        if rng.random() < rate:
            out.append(Event("buy", "user", f"v{s % 20_000}", "item", "x",
                             properties={"sessionId": f"s{s}"}, event_time=t + 1,
                             creation_time=t + 1))
    return out


def text_events(Event, n):
    """SMS-shaped messages from the seed: 13% spam (the collection's 747
    of 5,574), 4-20 words of a 3,000-word vocabulary, spam skewed to its
    own 300 words."""
    rng = np.random.default_rng(SEED + 185)
    vocab = [f"w{k}" for k in range(3_000)]
    out = []
    for k in range(n):
        spam = rng.random() < 747 / 5_574
        words = [vocab[int(x)] for x in (rng.integers(0, 300, rng.integers(4, 21)) if spam
                                          else rng.zipf(1.2, rng.integers(4, 21)) % 3_000)]
        t = T0 + k
        out.append(Event("train", "content", f"m{k}", properties={
            "text": " ".join(words), "label": "spam" if spam else "ham"},
            event_time=t, creation_time=t))
    return out


LEGS = [  # name, app, engineFactory, algorithm name, algorithm params
    ("classification lbfgs", "cls", "classification", "logreg", {"iterations": 100, "l2": 0.01}),
    ("classification adam", "cls", "classification", "logreg",
     {"iterations": 200, "l2": 0.01, "optimizer": "adam", "learningRate": 0.05}),
    ("lead scoring", "lead", "lead_scoring", "logreg", {"iterations": 200, "l2": 0.001}),
    ("text nb", "sms", "text", "nb", {"dim": TEXT_DIM}),
    ("text logreg", "sms", "text", "logreg", {"dim": TEXT_DIM, "iterations": 60}),
    ("text mlp", "sms", "text", "mlp", {"iterations": 150}),
]


def leg_bodies(rng, app, n):
    if app == "cls":
        return [{f"attr{k}": float(rng.integers(0, 5)) for k in range(3)} for _ in range(n)]
    if app == "lead":
        return [{"landingPageId": f"/p{int(rng.integers(0, 45))}",
                 "referrerId": str(rng.choice(["google", "ads", "mail", "new"])),
                 "browser": str(rng.choice(["Chrome", "Edge", "Lynx"]))} for _ in range(n)]
    return [{"text": " ".join(f"w{int(x)}" for x in rng.integers(0, 600, rng.integers(1, 15)))}
            for _ in range(n)]


def same_leg_answer(app, got, want, body):
    if app == "lead":
        check(abs(got["score"] - want["score"]) <= 1e-6, f"18e: {body}: {got} vs {want}")
        return
    check(got["label"] == want["label"], f"18e: {body}: {got} vs {want}")
    if "confidence" in want:
        check(abs(got["confidence"] - want["confidence"]) <= CONF_ATOL,
              f"18e: {body}: {got} vs {want}")


def small_templates_path(dev, workdir):
    """18e: classification (L-BFGS and Adam), lead scoring and text (NB,
    logistic regression, MLP), each from a seeded memory store: ``pio
    train`` on the card, ``pio deploy`` on a thread and LEG_QUERIES
    queries, every answer held against the CPU predict of the same stored
    weights."""
    from predictionio_tpu_torch.events.event import Event
    from predictionio_tpu_torch.storage import App, Storage, StorageConfig, set_storage
    from predictionio_tpu_torch.workflow.core_workflow import load_latest_models
    from predictionio_tpu_torch.workflow.create_workflow import engine_from_variant

    store = Storage(StorageConfig.memory())
    set_storage(store)      # pio train and pio deploy read the process default
    cls_app, lead_app, sms_app = (store.apps.insert(App(0, a)) for a in ("cls", "lead", "sms"))
    out = {}
    try:
        t0 = time.perf_counter()
        for app, events in ((cls_app, cls_events(Event, CLS_USERS)),
                            (lead_app, lead_events(Event, LEAD_SESSIONS)),
                            (sms_app, text_events(Event, TEXT_MESSAGES))):
            store.l_events.insert_batch(events, app)
        out["insert_s"] = time.perf_counter() - t0
        rng = np.random.default_rng(SEED + 186)
        for name, app, factory_name, algo, params in LEGS:
            engine_id = "smoke-" + name.replace(" ", "-")
            variant = {"id": engine_id, "engineFactory": factory_name,
                       "datasource": {"params": {"appName": app}},
                       "algorithms": [{"name": algo, "params": params}]}
            path = workdir / f"{engine_id}.json"
            path.write_text(json.dumps(variant))
            t0 = time.perf_counter()
            pio("train", "--engine-json", str(path))
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            factory, engine, ep = engine_from_variant(variant)
            _, cpu_models = load_latest_models(engine_id, device="cpu")
            cpu_predict = engine.predictor(ep, cpu_models)
            bodies = leg_bodies(rng, app, LEG_QUERIES)
            with pio_deploy_here(path) as (base, _):
                answers, lat_ms = timed_posts(base + "/queries.json", bodies)
            for body, got in zip(bodies, answers):
                same_leg_answer(app, got, cpu_predict(factory.query_class.from_json(body))
                                .to_json(), body)
            lat = sorted(lat_ms)
            labels = sorted({json.dumps(a.get("label", round(a.get("score", 0), 1)))
                             for a in answers})
            out[name] = {"pio_train_s": train_s, "p50_ms": lat[len(lat) // 2],
                         "p99_ms": lat[min(len(lat) - 1, int(0.99 * len(lat)))],
                         "distinct_answers": len(labels)}
            print(f"  18e {name}: pio train {train_s:.3f} s; {LEG_QUERIES} queries equal the "
                  f"CPU predict of the stored weights ({len(labels)} distinct answers), p50 "
                  f"{out[name]['p50_ms']:.3f} ms p99 {out[name]['p99_ms']:.3f} ms")
        return out
    finally:
        set_storage(None)


def eval_templates_path(cco, hk, dev, workdir):
    """Phase 18: 18a-18e, with the launches each kernel made in them."""
    t_phase = time.perf_counter()
    out = {}
    walls = {}
    lap = [time.perf_counter()]

    def leg_done(name):
        now = time.perf_counter()
        walls[name] = now - lap[0]
        lap[0] = now

    phase("18a. pio eval of the recommendation template (bench_als's users and items), plain and "
          "FastEval, against the same evaluation on the CPU")
    out["eval_reco"] = eval_reco_path(hk, dev, workdir)
    leg_done("18a")
    phase("18b. pio eval of the UR on 11b's app (min_llr grid), card models against "
          "their CPU batch_predict")
    out["eval_ur"] = eval_ur_path(hk, dev, workdir)
    leg_done("18b")
    phase("18c. the complementary-purchase template on 11b's purchases: pio train (tiled "
          "basket rules), pio deploy, carts")
    out["complementary_purchase"], tile_scores = cp_path(cco, hk, dev, workdir)
    leg_done("18c")
    phase("18d. the product-ranking template on 12b's shop: pio train, pio deploy under "
          f"{PR_CLIENTS} clients")
    out["product_ranking"] = pr_path(dev, workdir)
    leg_done("18d")
    phase("18e. classification, lead scoring and text: pio train, pio deploy, queries")
    out["small_templates"] = small_templates_path(dev, workdir)
    leg_done("18e")
    ea, eu, ec = out["eval_reco"], out["eval_ur"], out["complementary_purchase"]
    out["launches"] = {
        "masked_score": ea["k1_launches_pio_eval"] + ea["k1_launches_fast_eval"],
        "llr_masked": eu["launches"][0],
        "tile_topk": eu["launches"][1] + ec["launches"][1]}
    out["wall_s"] = time.perf_counter() - t_phase
    out["leg_wall_s"] = walls
    print(f"  phase 18 wall {out['wall_s']:.3f} s (legs: "
          f"{ {k: round(v, 3) for k, v in walls.items()} }); launches it adds: {out['launches']}")
    return out, tile_scores


# -- phase 13: ALS train timing ----------------------------------------------------


def bench_als_data(als_ops):
    """bench.py:bench_als's MovieLens-100K-shaped ratings (seed 0)."""
    n_users, n_items, n_ratings, _, _ = BENCH_ALS
    rng = np.random.default_rng(0)
    u = rng.integers(0, n_users, n_ratings).astype(np.int32)
    i = rng.integers(0, n_items, n_ratings).astype(np.int32)
    r = rng.integers(1, 6, n_ratings).astype(np.float32)
    return als_ops.prepare_als_data(u, i, r, n_users, n_items, dp=1), n_ratings


def time_als_train(als_ops, data, n_ratings, rank, iters, dev, implicit=False, reps=3):
    """``als_train`` end to end (plans, sweeps, readback) after a one-sweep
    warm-up: seconds of each rep and ratings x iterations a second of the
    fastest."""
    als_ops.als_train(data, k=rank, reg=ALS_LAMBDA, iterations=1, implicit=implicit,
                      device=dev)
    secs = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, _ = als_ops.als_train(data, k=rank, reg=ALS_LAMBDA, iterations=iters,
                                 implicit=implicit, device=dev)
        secs.append(time.perf_counter() - t0)
    check(np.isfinite(x).all(), "non-finite factors in the timed train")
    return {"train_s": secs, "ratings_x_iters_per_s": n_ratings * iters / min(secs)}


def half_step_stages(als_ops, data, rank, dev, implicit=False, sweeps=3):
    """Device ms of one half-step of each side, split into the normal
    equations' build, the Cholesky factorisations and the solves (CUDA
    events at the stage marks of ``solve_half``), the mean of ``sweeps``
    sweeps after one warm-up sweep; and the peak device memory of the
    sweeps."""
    args = als_ops._als_device_args(data, rank, dev)
    x0, y0 = als_ops._als_init(data, rank, 7)
    x0, y0 = x0.to(dev), y0.to(dev)
    als_ops._als_sweeps(data, x0, y0, 1, ALS_LAMBDA, args=args, implicit=implicit)
    marks = []

    def mark(stage):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((stage, ev))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    als_ops._als_sweeps(data, x0, y0, sweeps, ALS_LAMBDA, args=args, implicit=implicit,
                        mark=mark)
    torch.cuda.synchronize()
    out = {"user": {"build": 0.0, "cholesky": 0.0, "solve": 0.0},
           "item": {"build": 0.0, "cholesky": 0.0, "solve": 0.0}}
    side = "user"
    for (stage, a), (_, b) in zip(marks, marks[1:]):
        if stage == "end":
            side = "item" if side == "user" else "user"
            continue
        out[side][stage] += a.elapsed_time(b) / sweeps
    out["peak_gb_above_inputs"] = (torch.cuda.max_memory_allocated(dev) - base) / 1e9
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    return out


# -- phase 23: training over ranks -------------------------------------------------

RANK_TIMEOUT_S = 600            # a phase-23 rank process, start to exit
RANK_DIST_TIMEOUT_S = 300       # its process group's init and collective timeout
RANKS_ALS_RTOL, RANKS_ALS_ATOL = 1e-3, 2e-4   # the card's bar for ALS factors (12b)
RANKS_LOGREG_ATOL = 1e-4
RANKS_ENGINE_ID = ENGINE_ID + "-ranks"


def shared_env(workdir) -> dict:
    """The ``PIO_STORAGE_*`` environment of phase 23b's sharedfs store."""
    return {"PIO_STORAGE_SOURCES_SH_TYPE": "sharedfs",
            "PIO_STORAGE_SOURCES_SH_PATH": str(workdir / "shared"),
            **{f"PIO_STORAGE_REPOSITORIES_{r}_SOURCE": "SH"
               for r in ("METADATA", "EVENTDATA", "MODELDATA")}}


SHARED_IMPORT = r"""
import sys, time
from predictionio_tpu_torch.cli.main import main
rc = main(["app", "new", "smoke"])
t0 = time.perf_counter()
rc = rc or main(["import", "--app-name", "smoke", "--input", sys.argv[1]])
print(f"IMPORT_S {time.perf_counter() - t0}", flush=True)
sys.exit(rc)
"""


def start_shared_import(workdir) -> subprocess.Popen:
    """Phase 23b's sharedfs store filled by ``pio app new`` and ``pio import``
    of 11b's file in a process of its own, started after phase 21 so it runs
    beside the phases before 23 (``finish_shared_import`` joins it)."""
    root = str(Path(__file__).resolve().parent)
    with open(workdir / "shared-import.out", "w") as out, \
            open(workdir / "shared-import.err", "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-c", SHARED_IMPORT, str(workdir / "events.jsonl")], cwd=root,
            env={**os.environ, **shared_env(workdir), "PYTHONPATH": root},
            stdout=out, stderr=err)
    proc.logs = workdir / "shared-import"
    return proc


def finish_shared_import(proc: subprocess.Popen) -> float:
    """The background import's seconds; it fails the phase unless it ended
    with exit 0 within RANK_TIMEOUT_S."""
    try:
        proc.wait(timeout=RANK_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    so, se = (Path(f"{proc.logs}{ext}").read_text() for ext in (".out", ".err"))
    lines = [ln for ln in so.splitlines() if ln.startswith("IMPORT_S ")]
    check(proc.returncode == 0 and len(lines) == 1,
          f"23b: the sharedfs pio import exited {proc.returncode}\n{so[-2000:]}\n{se[-3000:]}")
    return float(lines[0].split()[1])


def rank_main(spec: dict) -> None:
    """One rank of phase 23, started by ``start_ranks`` as ``python -c``: it
    joins the process group from the PIO_* environment (the backend chosen
    from the topology), runs the parts ``spec["parts"]`` names on its card
    and prints one ``RANK_RESULT`` JSON line (walls, peak memory, K2/K3
    launches, the collectives' calls, bytes and seconds)."""
    from predictionio_tpu_torch.ops import als, cco, logreg
    from predictionio_tpu_torch.ops import hopper_kernels as hk
    from predictionio_tpu_torch.parallel import distributed as dist
    from predictionio_tpu_torch.parallel.mesh import create_mesh

    t0 = time.perf_counter()
    dist.init_distributed(device=spec["device"])
    dev = dist.local_device()
    on_card = dev.type == "cuda"
    rank = dist.process_index()
    out = {"rank": rank, "world": dist.process_count(), "backend": dist.backend(),
           "device": str(dev), "init_s": time.perf_counter() - t0}
    mesh = create_mesh()
    out["dp"] = mesh.shape["dp"]

    def begin():
        if on_card:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        dist.reset_collective_counts()
        hk.llr_masked_scores.launches = hk.tile_topk_desc.launches = 0
        return time.perf_counter()

    def end(t_begin, **extra):
        if on_card:
            torch.cuda.synchronize(dev)
        return {"wall_s": time.perf_counter() - t_begin,
                "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9 if on_card else 0.0,
                "launches": [hk.llr_masked_scores.launches, hk.tile_topk_desc.launches],
                "collectives": dist.collective_counts(), **extra}

    if "bench" in spec["parts"]:
        n_users, n_items, n_buy, n_view, top_k, _ = spec["bench_ur"]
        bu, bi, vu, vi = synth_commerce(n_users, n_items, n_buy, n_view)
        t = begin()
        tables = cco.cco_train_indicators(
            bu, bi, [("buy", bu, bi, n_items), ("view", vu, vi, n_items)], n_users, n_items,
            top_k=top_k, exclude_self_for="buy", mesh=mesh, device=dev)
        out["bench"] = end(t)
        np.savez(spec["bench_out"].format(rank=rank),
                 **{f"{k}_{j}": v[j] for k, v in tables.items() for j in (0, 1)})
    if "ur" in spec["parts"]:
        from predictionio_tpu_torch.cli.main import main as pio_main
        from predictionio_tpu_torch.models import universal_recommender  # noqa: F401

        with count_card_merges() as merges:
            t = begin()
            rc = pio_main(["train", "--engine-json", spec["engine_json"]])
            out["ur"] = end(t, rc=rc, merges_on_card=merges[0])
    if "als" in spec["parts"]:
        a = np.load(spec["als_in"])
        rank_k, iters = spec["als"]
        data = als.prepare_als_data(a["u"], a["i"], a["r"], int(a["n_users"]),
                                    int(a["n_items"]), dp=mesh.shape["dp"])
        t = begin()
        x, y = als.als_train(data, k=rank_k, reg=ALS_LAMBDA, iterations=iters, seed=7,
                             mesh=mesh, device=dev)
        out["als"] = end(t)
        np.savez(spec["als_out"].format(rank=rank), x=x, y=y)
    if "logreg" in spec["parts"]:
        c = np.load(spec["logreg_in"])
        t = begin()
        w, b = logreg.logreg_train(c["x"], c["y"], int(c["n_classes"]), l2=0.01,
                                   iterations=100, mesh=mesh, device=dev)
        out["logreg"] = end(t)
        np.savez(spec["logreg_out"].format(rank=rank), w=w, b=b)
    out["wall_s"] = time.perf_counter() - t0
    print("RANK_RESULT " + json.dumps(out), flush=True)


def start_ranks(n: int, spec: dict, env: dict, dev, logs: Path) -> list:
    """``n`` rank processes on ``dev``'s kind of device (``python -c``
    running ``rank_main``), joined at a free localhost port; each writes
    its output to ``<logs>-<k>.out`` and ``.err`` (a file: a rank never
    blocks on a pipe while another waits for it in a collective)."""
    root = str(Path(__file__).resolve().parent)
    spec = {**spec, "device": dev.type}
    env = {**env, "PYTHONPATH": root, "PIO_NUM_PROCESSES": str(n),
           "PIO_COORDINATOR_ADDRESS": f"127.0.0.1:{free_port()}",
           "PIO_DIST_TIMEOUT_S": str(RANK_DIST_TIMEOUT_S), "PIO_TORCH_DEVICE": dev.type}
    code = "import json, sys, chip_smoke; chip_smoke.rank_main(json.loads(sys.argv[1]))"
    procs = []
    for k in range(n):
        with open(f"{logs}-{k}.out", "w") as out, open(f"{logs}-{k}.err", "w") as err:
            p = subprocess.Popen([sys.executable, "-c", code, json.dumps(spec)], cwd=root,
                                 env={**env, "PIO_PROCESS_ID": str(k)}, stdout=out,
                                 stderr=err)
        p.logs = f"{logs}-{k}"
        procs.append(p)
    return procs


def finish_ranks(procs: list, what: str) -> list:
    """Each rank's RANK_RESULT; a rank that fails, or outlives
    RANK_TIMEOUT_S, fails the phase.  Every rank is reaped."""
    results = []
    try:
        deadline = time.monotonic() + RANK_TIMEOUT_S
        for k, p in enumerate(procs):
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 1))
            except subprocess.TimeoutExpired:
                raise SmokeFailure(f"{what}: rank {k} ran past {RANK_TIMEOUT_S} s")
            so, se = (Path(p.logs + ext).read_text() for ext in (".out", ".err"))
            lines = [ln for ln in so.splitlines() if ln.startswith("RANK_RESULT ")]
            check(p.returncode == 0 and len(lines) == 1,
                  f"{what}: rank {k} exited {p.returncode}\n{so[-3000:]}\n{se[-6000:]}")
            results.append(json.loads(lines[0][len("RANK_RESULT "):]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return results


def collective_text(c: dict) -> str:
    return ", ".join(f"{k} {v['calls']} calls {v['bytes'] / 1e9:.4f} GB {v['seconds']:.3f} s"
                     for k, v in c.items() if v["calls"])


def launch_ranks(dev, workdir, als_pd, shared_import) -> dict:
    """Phase 23's rank processes, started once the sharedfs import has
    ended (``finish_shared_import``) so they train beside phases 16 and 18;
    ``ranks_path`` joins and checks them.  (a) one rank under NCCL at
    bench_ur's shape; (b)-(d) two ranks sharing the card under gloo: ``pio
    train`` of the UR from the sharedfs store, ALS at 12b's width, logistic
    regression at 18e's shape."""
    base = dict(os.environ)
    t0 = time.perf_counter()
    launched = {"import_s": finish_shared_import(shared_import)}
    launched["import_wait_s"] = time.perf_counter() - t0
    engine_json = workdir / "engine-ranks.json"
    engine_json.write_text(json.dumps({**engine_variant(False), "id": RANKS_ENGINE_ID}))
    np.savez(workdir / "ranks-als-in.npz", u=als_pd.user_idx, i=als_pd.item_idx,
             r=als_pd.rating, n_users=len(als_pd.user_dict), n_items=len(als_pd.item_dict))
    x_cls, y_cls = cls_arrays(CLS_USERS)
    np.savez(workdir / "ranks-logreg-in.npz", x=x_cls, y=y_cls, n_classes=3)
    spec = {"parts": ["ur", "als", "logreg"], "engine_json": str(engine_json),
            "als": list(DEPLOYED_ALS[4:]),
            "als_in": str(workdir / "ranks-als-in.npz"),
            "als_out": str(workdir / "ranks-als-{rank}.npz"),
            "logreg_in": str(workdir / "ranks-logreg-in.npz"),
            "logreg_out": str(workdir / "ranks-logreg-{rank}.npz")}
    a_spec = {"parts": ["bench"], "bench_out": str(workdir / "ranks-bench-{rank}.npz"),
              "bench_ur": list(BENCH_UR)}
    launched["t0"] = time.perf_counter()
    launched["procs"] = (start_ranks(1, a_spec, base, dev, workdir / "rank-a")
                         + start_ranks(2, spec, {**base, **shared_env(workdir)}, dev,
                                       workdir / "rank-b"))
    return launched


def ranks_path(dev, workdir, bench_tables, tables_11b, als_pd, launched):
    """Phase 23: training over ranks on this card, the processes
    ``launch_ranks`` started joined and checked.  (a) one rank under NCCL
    trains bench_ur's shape with a dp = 1 mesh, tables bit-identical to
    phase 10's; (b) two ranks sharing the card under gloo run ``pio train``
    of the UR at the deployed width from a sharedfs store filled by ``pio
    import`` of 11b's file (50 K2 and 50 K3 launches and 50 all-reduces
    each, no ``merge_desc`` on the card), each stored model bit-identical to
    11b's one-rank train; (c) ALS at 12b's width over the two ranks against
    one rank on the same dp = 2 layout; (d) logistic regression at 18e's
    classification shape over the two ranks against one rank.  The
    sharedfs import runs from phase 21 on, the ranks from phase 16 on; (a)
    runs beside (b)-(d)."""
    from predictionio_tpu_torch.ops import als as als_ops
    from predictionio_tpu_torch.ops import logreg as lr_ops
    from predictionio_tpu_torch.storage import Storage, StorageConfig
    from predictionio_tpu_torch.workflow.persistence import load_models

    t_phase = time.perf_counter()
    out = {k: launched[k] for k in ("import_s", "import_wait_s")}
    n_users, n_items = len(als_pd.user_dict), len(als_pd.item_dict)
    x_cls, y_cls = cls_arrays(CLS_USERS)
    procs = launched["procs"]
    try:
        (a,) = finish_ranks(procs[:1], "23a")
        ranks = finish_ranks(procs[1:], "23b-d")
        out["ranks_wall_s"] = time.perf_counter() - launched["t0"]
        out["join_wait_s"] = time.perf_counter() - t_phase
    finally:   # a failed rank leaves none of the others running
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    check(a["backend"] == "nccl", f"23a: one rank on its own card joined with {a['backend']}")
    got = np.load(workdir / "ranks-bench-0.npz")
    for name, (s, i) in bench_tables.items():
        check(np.array_equal(got[f"{name}_0"].view(np.int32), s.view(np.int32))
              and np.array_equal(got[f"{name}_1"], i),
              f"23a: {name}: the dp = 1 mesh's tables differ from phase 10's")
    ar = a["bench"]["collectives"]["all_reduce"]
    check(ar["calls"] == 2 and tuple(a["bench"]["launches"]) == (2, 2),
          f"23a: {ar['calls']} all-reduces, launches {a['bench']['launches']}")
    out["a"] = a
    print(f"  23a: one rank, backend {a['backend']} on {a['device']} (init "
          f"{a['init_s']:.3f} s): bench_ur's shape over a dp = 1 mesh, the dense runner, "
          f"tables bit-identical to phase 10's; train {a['bench']['wall_s']:.3f} s, peak "
          f"{a['bench']['peak_gb']:.3f} GB, {collective_text(a['bench']['collectives'])}")
    out["ranks"] = ranks
    card_gb = torch.cuda.get_device_properties(dev).total_memory / 1e9
    tiles = 2 * -(-DEPLOYED_UR[1] // DEPLOYED_UR[5])
    for r in ranks:
        ur = r["ur"]
        ar = ur["collectives"]["all_reduce"]
        check(r["backend"] == "gloo", f"23b: two ranks on one card joined with {r['backend']}")
        check(ur["rc"] == 0, f"23b: rank {r['rank']}: pio train exited {ur['rc']}")
        check(tuple(ur["launches"]) == (tiles, tiles),
              f"23b: rank {r['rank']}: K2/K3 launches {ur['launches']}, expected {tiles} each")
        check(ar["calls"] == tiles, f"23b: rank {r['rank']}: {ar['calls']} all-reduces")
        check(ur["merges_on_card"] == 0, f"23b: merge_desc ran {ur['merges_on_card']} times")
        print(f"  23b: rank {r['rank']} backend {r['backend']} on {r['device']} (init "
              f"{r['init_s']:.3f} s): pio train {ur['wall_s']:.3f} s, peak {ur['peak_gb']:.3f} "
              f"GB, K2/K3 launches {ur['launches']}, merge_desc on the card "
              f"{ur['merges_on_card']}, {collective_text(ur['collectives'])}")
    peak_sum = a["bench"]["peak_gb"] + sum(max(r[p]["peak_gb"] for p in ("ur", "als", "logreg"))
                                           for r in ranks)
    check(peak_sum <= card_gb, f"23: the ranks' peaks {peak_sum:.3f} GB exceed the card")
    store = Storage(StorageConfig(sources={"SH": {"type": "sharedfs",
                                                  "path": str(workdir / "shared")}},
                                  repositories={r: "SH" for r in
                                                ("METADATA", "EVENTDATA", "MODELDATA")}))
    stored = [inst for inst in store.engine_instances.get_all()
              if inst.engine_id == RANKS_ENGINE_ID]
    check(len(stored) == 2 and all(i.status == "COMPLETED" for i in stored),
          f"23b: {len(stored)} stored instances, expected one a rank")
    for inst in stored:
        (model,) = load_models(store, inst.id, device="cpu")
        got = host_tables(model)
        check(got["items"] == tables_11b["items"], "23b: the item dictionaries differ")
        for name in ("purchase", "view"):
            (g_cols, g_idx, g_llr), (w_cols, w_idx, w_llr) = got[name], tables_11b[name]
            check(g_cols == w_cols and np.array_equal(g_idx, w_idx)
                  and np.array_equal(g_llr.view(np.int32), w_llr.view(np.int32)),
                  f"23b: instance {inst.id}: the {name} table differs from 11b's one rank")
        del model
    print(f"  23b: both stored models ({[i.id for i in stored]}) bit-identical to 11b's "
          f"one-rank train; the sharedfs pio import {out['import_s']:.3f} s (from phase 21 "
          f"on; the ranks' start waited {out['import_wait_s']:.3f} s for it); the three ranks' "
          f"peaks sum to {peak_sum:.3f} GB of {card_gb:.1f}")

    _, _, _, _, rank_k, iters = DEPLOYED_ALS
    data = als_ops.prepare_als_data(als_pd.user_idx, als_pd.item_idx, als_pd.rating,
                                    n_users, n_items, dp=2)
    one = als_ops.als_train(data, k=rank_k, reg=ALS_LAMBDA, iterations=iters, seed=7,
                            device=dev)
    del data
    out["als"] = {}
    for r in ranks:
        got = np.load(workdir / f"ranks-als-{r['rank']}.npz")
        diffs = [float(np.abs(got[k] - w).max()) for k, w in zip("xy", one)]
        same = all(np.array_equal(got[k].view(np.int32), w.view(np.int32))
                   for k, w in zip("xy", one))
        if not same:
            for k, w in zip("xy", one):
                check(np.allclose(got[k], w, rtol=RANKS_ALS_RTOL, atol=RANKS_ALS_ATOL),
                      f"23c: rank {r['rank']}: {k} beyond rtol {RANKS_ALS_RTOL} atol "
                      f"{RANKS_ALS_ATOL} of one rank (max {max(diffs)})")
        out["als"][r["rank"]] = {"bit_identical": same, "max_abs_diff": max(diffs)}
        ag = r["als"]["collectives"]["all_gather"]
        print(f"  23c: rank {r['rank']}: ALS {n_users} x {n_items} x rank {rank_k}, {iters} "
              f"sweeps over dp = 2: {r['als']['wall_s']:.3f} s, peak {r['als']['peak_gb']:.3f} "
              f"GB; factors {'bit-identical to' if same else 'within the bar of'} one rank on "
              f"the same layout (max |diff| {max(diffs):.3g}); all-gather {ag['calls']} calls "
              f"{ag['bytes'] / 1e6:.3f} MB {ag['seconds']:.3f} s")

    w1, b1 = lr_ops.logreg_train(x_cls, y_cls, 3, l2=0.01, iterations=100, device=dev)
    r0, r1 = (np.load(workdir / f"ranks-logreg-{r['rank']}.npz") for r in ranks)
    check(np.array_equal(r0["w"], r1["w"]) and np.array_equal(r0["b"], r1["b"]),
          "23d: W and b differ between the ranks")
    err = max(float(np.abs(r0["w"] - w1).max()), float(np.abs(r0["b"] - b1).max()))
    check(err <= RANKS_LOGREG_ATOL, f"23d: W, b {err} from one rank's")
    out["logreg_max_abs_diff"] = err
    for r in ranks:
        print(f"  23d: rank {r['rank']}: logistic regression {len(y_cls)} x "
              f"{x_cls.shape[1]}, L-BFGS 100 steps: {r['logreg']['wall_s']:.3f} s, "
              f"{collective_text(r['logreg']['collectives'])}")
    print(f"  23d: W and b equal in both ranks, {err:.3g} from one rank's (bar "
          f"{RANKS_LOGREG_ATOL})")
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"  phase 23 wall {out['wall_s']:.3f} s, of which {out['join_wait_s']:.3f} s "
          f"waiting for the ranks (started {out['ranks_wall_s']:.3f} s before they were "
          "all joined, beside phases 16 and 18)")
    return out


def cls_arrays(n_users):
    """18e's classification examples as arrays: the three attributes of
    ``cls_events`` and the label's index among the sorted labels."""
    rng = np.random.default_rng(SEED + 183)
    a = rng.integers(0, 5, (n_users, 3)).astype(float)
    z = a[:, 0] - 0.8 * a[:, 1] + 0.5 * a[:, 2] + rng.normal(0, 1.0, n_users)
    y = np.where(z > 2.5, 0, np.where(z > 0.5, 2, 1))   # high, low, mid
    return a.astype(np.float32), y.astype(np.int64)


# -- the run ---------------------------------------------------------------------


# -- phase 24: the operator drills ------------------------------------------------

#: the drills that train and serve on the card (predictionio_tpu_torch/tools),
#: each at its CPU wrapper's depth; every one trains its model in its own process
DRILLS = ("check_trace_roundtrip", "check_serve_parity", "check_freshness_roundtrip",
          "check_plane_replication", "check_lineage_roundtrip")
DRILL_TIMEOUT_S = 300   # the drills run together: the phase's limit


def drills_path(smi: str, device: str = "cuda") -> dict:
    """Phase 24: drills 3-7 of the port's operator tools, each ``python -m
    predictionio_tpu_torch.tools.<drill> --device cuda`` as a process of its
    own, all started together (the freshness, plane and lineage drills start
    ``pio deploy`` children of their own on the card) and reaped at the
    end.  Each must exit 0 with its ``ok:`` verdict last and, before it, its
    process's launch line: K2 and K3 launched in every drill (each trains).
    A drill's wall is its process's, start to exit, while the others run.
    Each drill leads a process group of its own: whatever it leaves running
    when it exits or the phase fails is killed with it."""
    root = Path(__file__).resolve().parent
    env = {k: v for k, v in os.environ.items() if not k.startswith("PIO_")}
    env["PYTHONPATH"] = str(root)
    logs = Path(tempfile.mkdtemp(prefix="chip-drills-"))
    t0 = time.perf_counter()
    running, out = {}, {}
    try:
        for name in DRILLS:
            streams = (open(logs / f"{name}.out", "w+"), open(logs / f"{name}.err", "w+"))
            running[name] = (subprocess.Popen(
                [sys.executable, "-m", f"predictionio_tpu_torch.tools.{name}",
                 "--device", device],
                stdout=streams[0], stderr=streams[1], cwd=root, env=env,
                start_new_session=True), streams)
        walls = {}
        while len(walls) < len(running):
            for name, (proc, _) in running.items():
                if name not in walls and proc.poll() is not None:
                    walls[name] = time.perf_counter() - t0
            check(time.perf_counter() - t0 < DRILL_TIMEOUT_S,
                  f"24: drills {sorted(set(running) - set(walls))} still running after "
                  f"{DRILL_TIMEOUT_S} s")
            time.sleep(0.1)
        failed = []
        for name, (proc, (so, se)) in running.items():
            so.seek(0)
            se.seek(0)
            stdout, stderr = so.read(), se.read()
            lines = stdout.strip().splitlines()
            try:
                check(proc.returncode == 0 and len(lines) >= 2
                      and lines[-1].startswith("ok: "), f"exited {proc.returncode}")
                check(lines[-2].startswith("launches: "), "printed no launch line")
                launches = json.loads(lines[-2][len("launches: "):])
                check(launches["device"] == device, f"ran on {launches['device']}")
                if device == "cuda":
                    check(launches["llr_masked"] > 0 and launches["tile_topk"] > 0,
                          f"trained without K2/K3: {launches}")
            except SmokeFailure as e:
                # every drill's verdict is read before the phase fails
                tail = "\n".join((stdout + stderr).strip().splitlines()[-40:])
                print(f"  {name}: {walls[name]:.3f} s, FAILED: {e}\n{tail}")
                failed.append(name)
                continue
            out[name] = {"wall_s": walls[name], "launches": launches, "ok": lines[-1],
                         "notes": [ln for ln in lines[:-2]
                                   if " phase: " in ln or ln.startswith("/healthz ")]}
            print(f"  {name}: {walls[name]:.3f} s, {lines[-2]}")
            for note in out[name]["notes"]:
                print(f"    {note}")
            print(f"    {lines[-1]} | {smi}")
        check(not failed, f"24: drills {failed} failed")
    finally:
        for proc, streams in running.values():
            # a drill's process group holds its pio deploy children too
            with contextlib.suppress(ProcessLookupError):
                os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            for f in streams:
                f.close()
        shutil.rmtree(logs, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t0
    return out


def run() -> None:
    if not torch.cuda.is_available():
        raise SmokeFailure("no CUDA card: the port's main path runs on the GPU")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        from predictionio_tpu_torch.controller import EngineParams
        from predictionio_tpu_torch.device import resolve_device
        from predictionio_tpu_torch.models import recommendation as reco
        from predictionio_tpu_torch.models import universal_recommender as ur
        from predictionio_tpu_torch.native import core as ncore
        from predictionio_tpu_torch.native import scanner
        from predictionio_tpu_torch.ops import als as als_ops
        from predictionio_tpu_torch.ops import build
        from predictionio_tpu_torch.ops import cco
        from predictionio_tpu_torch.ops import hopper_kernels as hk
        from predictionio_tpu_torch.workflow.create_server import deploy_models
    except ImportError as e:
        raise SmokeFailure(f"the port is not beside this script: {e}") from e
    t_start = time.perf_counter()

    phase("1. card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi.splitlines()[0])
    dev = resolve_device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    phase("2. build")
    # the native event-log scanner and the scan core's header parse (host
    # code, g++) build beside the kernels, each on a thread of its own
    host_built = {}

    def build_host(name, load):
        t0 = time.perf_counter()
        host_built[name] = (load(), time.perf_counter() - t0)

    host = [threading.Thread(target=build_host, args=args) for args in (
        ("event-log scanner", scanner.native_available),
        ("scan core header parse", lambda: ncore.lib() is not None))]
    for t in host:
        t.start()
    build_s = build.build_all()
    for t in host:
        t.join()
    for name, (ok, secs) in host_built.items():
        check(ok, f"the native {name} did not build")
    print(f"build_s={build_s:.3f} kernels={sorted(build.SIGNATURES)}; native host code "
          "(g++): " + ", ".join(f"{name} {secs:.3f} s" for name, (_, secs)
                                 in sorted(host_built.items())))
    for name, log in build.build_logs.items():
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    sass = llr_sass_count(build)
    ops_per_cell = sass["ops"]
    print(f"  llr_masked SASS: {sass['instructions']} instructions a nonzero cell "
          f"({ops_per_cell} operations, an FFMA counted as two; division slow path "
          f"{sass['slow_path']} more, out of line), by opcode {sass['by_opcode']}; "
          f"kernels in the library: {sass['kernels']}")

    phase("3. K1 vs plain")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    errs = {"masked_score": compare_kernel(hk, dev, gen)}
    phase("4. K2 vs plain")
    errs["llr_masked"] = compare_llr(hk, dev, gen)
    phase("5. K3 vs plain")
    errs["tile_topk"] = compare_topk(hk, dev, gen)
    torch.cuda.empty_cache()

    phase("6. ALS model")
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    model = reco.als_model_from_state(make_state(rng), device="cuda")
    engine = reco.RecommendationEngine.apply()
    ep = EngineParams(algorithm_params_list=[("als", reco.ALSAlgorithmParams(rank=RANK))])
    print(f"users={N_USERS} items={N_ITEMS} rank={RANK} seen_nnz={model.seen.nnz} "
          f"build_s={time.perf_counter() - t0:.3f}")

    phase("7. ALS HTTP /queries.json")
    listed = [{"user": "u1", "num": 10},
              {"user": "u2", "num": 10, "unseenOnly": True},
              {"user": "u3", "num": 10, "blackList": ["i0", "i1", "i99999", "nope"]},
              {"user": "u4", "num": 1},
              {"user": "u5", "num": 100},
              {"user": "no-such-user", "num": 10}]
    bodies = listed + queries(rng, 44)
    swaps = 0
    hk.masked_score_matmul.launches = 0
    server = deploy_models(engine, ep, [model], port=0, query_class=reco.RecoQuery)
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}/queries.json"
        answers, lat_ms = timed_posts(url, bodies)
        http_launches = hk.masked_score_matmul.launches
        traced_7 = trace_als_queries(hk, f"http://127.0.0.1:{server.server_address[1]}",
                                     listed[:2])
    finally:
        server.shutdown()
        server.server_close()
    check(answers[5] == {"itemScores": []}, f"unknown user answered {answers[5]}")
    for body, got in zip(bodies, answers):
        swaps += check_answer(model, hk, body, got)
    rest = sorted(lat_ms[1:])
    print(f"queries={len(bodies)} launches={http_launches} latency_ms "
          f"first={lat_ms[0]:.3f} then p50={rest[len(rest) // 2]:.3f} "
          f"max={rest[-1]:.3f} (host clock, one client, a connection per request)")

    phase("8. ALS batch_predictor")
    batch_bodies = queries(rng, 256)
    predict_batch = engine.batch_predictor(ep, [model])
    hk.masked_score_matmul.launches = 0
    t0 = time.perf_counter()
    results = predict_batch([reco.RecoQuery.from_json(b) for b in batch_bodies])
    batch_s = time.perf_counter() - t0
    batch_launches = hk.masked_score_matmul.launches
    for body, res in zip(batch_bodies, results):
        swaps += check_answer(model, hk, body, res.to_json())
    print(f"queries={len(batch_bodies)} launches={batch_launches} "
          f"max_batch={predict_batch.max_batch} wall_s={batch_s:.4f} "
          f"near_tie_swaps={swaps}")

    phase("9. ALS launch counters")
    check(http_launches > 0, "the HTTP path launched no masked_score kernel")
    check(batch_launches > 0, "batch_predictor launched no masked_score kernel")
    print(f"masked_score launches: http={http_launches} batch={batch_launches}")
    del model, engine
    torch.cuda.empty_cache()

    phase("10. UR train at bench_ur's full shape: dense and resident tiled")
    bench, bench_tables = train_bench_shape(cco, hk, dev)   # the tables: phase 23a's reference
    torch.cuda.empty_cache()

    phase("11. UR train from the memory store at a cut depth (run_train)")
    memory = train_memory(ur, cco, hk, dev)
    torch.cuda.empty_cache()

    workdir = Path(tempfile.mkdtemp(prefix="chip-smoke-"))
    shared_import = launched = None
    try:
        phase("11b. UR at the deployed width through localfs and pio "
              "(app new, import, build, train)")
        model, _, arrays, cols, env, variants, deployed = train_localfs(ur, cco, hk, dev,
                                                                        workdir)
        tables_11b = host_tables(model)   # phase 23b's reference, ids as strings
        del model
        torch.cuda.empty_cache()
        print("  -- the columnar snapshot and the staged cache")
        ur_model, td, snapshot = snapshot_path(ur, cco, hk, dev, workdir, arrays,
                                               item_properties(cols), deployed)
        torch.cuda.empty_cache()

        phase("12. UR HTTP /queries.json from pio deploy subprocesses, with business rules")
        served = serve_ur(ur, ur_model, arrays, cols, dev, env, variants)
        torch.cuda.empty_cache()

        phase("17. the UR's response, rule-mask and history caches, the host tail and "
              "checkpointed training, on deploy in this process")
        caches = ur_caches_path(ur, cco, hk, ncore, dev, workdir, variants, ur_model,
                                snapshot["pio_train_snapshot_s_llr_False"])
        del ur_model
        torch.cuda.empty_cache()

        phase("19. the streaming fold and the follow-trainer: deploy(follow=) on 11b's app, "
              "freshness rounds, K2/K3 re-selecting folded rows, parity with a card train; "
              "19b pio train --follow")
        follow = follow_path(ur, cco, hk, dev, workdir, variants)
        torch.cuda.empty_cache()

        phase("20. the model plane and its replication: deploy(follow=, plane_publish=) "
              "here, pio deploy --plane-from as a subprocess, freshness rounds at the "
              "subscriber, a killed and a torn subscriber, answers and arrays bit-equal")
        planes = plane_path(ur, hk, dev, workdir, variants, env)
        torch.cuda.empty_cache()

        phase("21. the sharded store streaming runs on: events on 2 shards x 2 replicas, "
              "metadata in SQLite, models on sharedfs; pio import, pio train, "
              "deploy(follow=) with freshness rounds through a promotion of shard 0")
        shard = sharded_path(ur, hk, dev, workdir, variants)
        shared_import = start_shared_import(workdir)   # phase 23b's store, meanwhile
        torch.cuda.empty_cache()

        phase("22. pio dashboard on 11b's store: the index with 11b's trains and their span "
              "breakdowns, /dashboard.json against the store")
        dashboard = dashboard_path(workdir, env)

        phase("12b. ALS at the deployed width through localfs and pio "
              "(import, train, deploy, /queries.json)")
        als_model, als_pd, shop, shop_app, _, als_run = als_path(reco, als_ops, hk, dev,
                                                                 workdir)
        torch.cuda.empty_cache()
        phase("12c. ALS pio train checkpointed, a fault injected, resumed on retry")
        als_run["checkpointed"] = als_checkpointed(dev, workdir, als_model)
        del als_model
        torch.cuda.empty_cache()
        phase("12d. the e-commerce template on the same shop: pio train, pio deploy, "
              "rule queries")
        ecomm_run = ecomm_path(dev, workdir, shop, shop_app)
        torch.cuda.empty_cache()
        phase("14. pio eventserver --workers 2 -> HTTP ingest -> pio train -> deploy with "
              "auto-reload under concurrent load (micro-batched K1) -> hot reload -> feedback")
        frontend = frontend_path(hk, dev, workdir, shop)
        del shop
        torch.cuda.empty_cache()
        # phase 23's ranks train from here on, beside 16 and 18 (the count
        # all-reduces of 23b move 41 GB a rank through gloo)
        launched = launch_ranks(dev, workdir, als_pd, shared_import)
        phase("16. the similar-product template on 11b's app: pio train (cooccurrence, "
              "ALS), pio deploy, /queries.json against the CPU predict")
        similar = similar_product_path(hk, dev, workdir)
        torch.cuda.empty_cache()
        phase("18. pio eval and the five remaining templates (product ranking, "
              "complementary purchase, classification, lead scoring, text)")
        slice13, basket_tile_scores = eval_templates_path(cco, hk, dev, workdir)
        torch.cuda.empty_cache()
        phase("23. training over ranks on this card: one rank under NCCL (bench_ur's shape, "
              "a dp = 1 mesh); two ranks sharing the card under gloo: pio train of the UR "
              "at the deployed width from a sharedfs store, ALS at 12b's width, logistic "
              "regression at 18e's shape (started before phase 16)")
        ranks = ranks_path(dev, workdir, bench_tables, tables_11b, als_pd, launched)
        del tables_11b, bench_tables
        (workdir / "events.jsonl").unlink()
        torch.cuda.empty_cache()
    finally:
        # a phase before 23 failed: nothing it started runs on
        for proc in [shared_import] + (launched["procs"] if launched else []):
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(workdir, ignore_errors=True)

    phase("15. CCO at bench_scale's shape: the parity corpus through every strategy, "
          "then 100,000 x 131,072 with 50M events resident and chunked")
    scale = scale_path(cco, hk, dev)
    torch.cuda.empty_cache()

    phase("24. the operator drills on the card: trace, serve parity, freshness, plane "
          "replication and lineage round trips (predictionio_tpu_torch/tools, "
          "--device cuda), each a process of its own, started together")
    drills = drills_path(smi.splitlines()[0])

    phase("13. timing")
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)   # > 50 MB L2
    clock = SMClock()
    empty_ms = time_empty(flush, clock)
    rows = {"masked_score": [time_masked_score(hk, dev, gen, b, k, N_ITEMS, flush, clock, st)
                             for b, k, st in K1_TIMED]}
    n_items, tile = DEPLOYED_UR[1], DEPLOYED_UR[5]
    counts, row, col, n = llr_inputs(n_items, tile, dev, gen)
    rows["llr_masked"] = [time_llr(hk, counts, row, col, n, flush, clock, ops_per_cell,
                                   "random")]
    del counts
    s = topk_inputs(n_items, tile, dev, gen)
    rows["tile_topk"] = [time_topk(hk, s, 64, flush, clock, "random")]
    del s
    counts, rc, cc, n, scores = capture_train_tiles(cco, hk, td, dev, tile)
    rows["llr_masked"].append(time_llr(hk, counts, rc, cc, n, flush, clock, ops_per_cell,
                                       "deployed train tile 12 of view"))
    del counts
    rows["tile_topk"].append(time_topk(hk, scores, 64, flush, clock,
                                       "deployed train tile 12 of view"))
    rows["tile_topk"].append(time_topk(hk, scores, 64, flush, clock,
                                       "deployed train tile 12 of view",
                                       carry=topk_carry(n_items, 64, dev, gen, "initial")))
    del scores
    scores, t0 = basket_tile_scores
    scores = scores.to(dev)
    del basket_tile_scores
    check_topk_carry(hk, scores, 32, t0, dev, gen, "basket rules tile 12 of the 18c train")
    rows["tile_topk"].append(time_topk(hk, scores, 32, flush, clock,
                                       "basket rules tile 12 of the 18c train",
                                       carry=topk_carry(scores.shape[0], 32, dev, gen,
                                                        "initial"), id_offset=t0))
    del scores
    k1_rounds = retime_k1(hk, dev, gen, flush, clock)
    # K2 on the row-strided shapes phase 2 holds for correctness (LLR_CASES):
    # sparse counts at the train tile's width and the ragged 37 x 190, each
    # a view whose row stride is C + 3, then the same counts contiguous (the
    # stride's cost, read in one run)
    for kind, r, c, strided in LLR_CASES:
        if strided:
            counts, row, col, n = llr_inputs(r, c, dev, gen, kind)
            for view, how in ((strided_view(counts), "row-strided view"),
                              (counts, "the same counts contiguous")):
                rows["llr_masked"].append(time_llr(hk, view, row, col, n, flush, clock,
                                                   ops_per_cell, f"{kind} counts, {how}"))
            del counts, view
    del flush
    torch.cuda.empty_cache()
    data, n_ratings = bench_als_data(als_ops)
    _, _, _, rank, iters = BENCH_ALS
    als_timing = {"bench_als": {**time_als_train(als_ops, data, n_ratings, rank, iters, dev),
                                "half_step_ms": half_step_stages(als_ops, data, rank, dev)}}
    data = als_ops.prepare_als_data(als_pd.user_idx, als_pd.item_idx, als_pd.rating,
                                    len(als_pd.user_dict), len(als_pd.item_dict), dp=1)
    _, _, _, _, rank, iters = DEPLOYED_ALS
    for implicit in (False, True):
        als_timing[f"deployed{'_implicit' if implicit else ''}"] = {
            **time_als_train(als_ops, data, len(als_pd.rating), rank, iters, dev, implicit),
            "half_step_ms": half_step_stages(als_ops, data, rank, dev, implicit)}
    del data, als_pd
    print(f"  empty kernel (torch.cuda._sleep(0)) through time_cold: {empty_ms:.4f} ms, "
          f"the event and launch floor of every reading below | {smi}")
    for r in rows["masked_score"]:
        print(k1_text(r, smi))
    for line in k1_rounds_text(k1_rounds, smi):
        print(line)
    sass["issue_slot_estimate_ms"] = {}
    for r in rows["llr_masked"]:
        print(f"  llr_masked [{r['R']} x {r['C']}] {r['input']}, nonzero share "
              f"{r['nonzero_share']:.6f}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"library: no single call, bound {r['bound_ms']:.4f} ms ({r['bound_by']}; "
              f"{ops_per_cell} operations a nonzero cell) | {clock_text(r['sm_clock'])} "
              f"| {smi}")
        # an estimate, not a measurement: issue slots at one lane-instruction
        # each, at the assumed PEAK_ISSUE_S
        cells = r["R"] * r["C"]
        est = {"nonzero_cells": cells * r["nonzero_share"] * sass["instructions"]
               / PEAK_ISSUE_S * 1e3,
               "every_cell": cells * sass["instructions"] / PEAK_ISSUE_S * 1e3}
        sass["issue_slot_estimate_ms"][r["input"]] = est
        print(f"    estimate: issue slots of {sass['instructions']} instructions a cell at "
              f"{PEAK_ISSUE_S:.3g} a second take {est['nonzero_cells']:.4f} ms for the "
              f"nonzero cells, {est['every_cell']:.4f} ms were every cell computed")
    for r in rows["tile_topk"]:
        print(f"  tile_topk [{r['R']} x {r['W']}] b={r['b']} {r['input']}"
              f"{' with the initial carry' if r['carry'] else ''}, finite share "
              f"{r['finite_share']:.6f}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"torch.topk {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}) | {clock_text(r['sm_clock'])} | {smi}")
    print(f"  UR train: bench shape {bench['events']} events in {bench['wall_s']:.3f} s; "
          f"deployed width {deployed['events']} events in {deployed['train_wall_s']:.3f} s "
          f"(URAlgorithm.train); UR HTTP over {served[False]['n']} queries "
          f"p50 {served[False]['p50_ms']:.3f} ms p99 {served[False]['p99_ms']:.3f} ms | {smi}")
    print(f"  localfs path: JSONL write {deployed['jsonl_write_s']:.3f} s, pio import "
          f"{deployed['import_s']:.3f} s ({deployed['segment_bytes']} segment bytes), "
          f"read_training (native scan) {deployed['read_training_s']:.3f} s, pio train "
          f"{deployed['pio_train_s_llr_False']:.3f} s (peak {deployed['peak_device_gb']:.2f} "
          f"GB), model blob {deployed['blob_mb']:.1f} MB saved in {deployed['save_s']:.3f} s, "
          f"loaded in {deployed['load_s']:.3f} s; pio deploy to first answer "
          f"{served[False]['deploy_to_first_answer_s']:.3f} s; rule mask "
          f"build first {served['mask_build_ms']['first']:.3f} ms, warm "
          f"{served['mask_build_ms']['warm']:.3f} ms; rule queries over HTTP p50 "
          f"{served[False]['rule_p50_ms']:.3f} ms p99 {served[False]['rule_p99_ms']:.3f} ms "
          f"| {smi}")
    print(f"  snapshot path: pio snapshot {snapshot['snapshot_build_s']:.3f} s "
          f"({snapshot['snapshot_bytes']} bytes), read_training from it "
          f"{snapshot['read_training_snapshot_s']:.3f} s (native scan "
          f"{deployed['read_training_s']:.3f} s), the snapshot read alone "
          f"{snapshot['snapshot_scan_s']:.3f} s, a {snapshot['tail_events']}-event delta "
          f"{snapshot['read_training_delta_s']:.3f} s, snapshot and tail "
          f"{snapshot['read_training_snapshot_tail_s']:.3f} s, tombstoned "
          f"{snapshot['read_training_tombstoned_s']:.3f} s; pio train from it "
          f"{snapshot['pio_train_snapshot_s_llr_False']:.3f} s (native scan "
          f"{deployed['pio_train_s_llr_False']:.3f} s) | {smi}")
    for name, r in als_timing.items():
        hs = r["half_step_ms"]
        print(f"  ALS train {name}: {[round(s, 4) for s in r['train_s']]} s (als_train end to "
              f"end after a warm-up), {r['ratings_x_iters_per_s']:.4g} ratings x iterations "
              f"a second; a half-step's device ms, user side: build {hs['user']['build']:.3f}, "
              f"Cholesky {hs['user']['cholesky']:.3f}, solve {hs['user']['solve']:.3f}; item "
              f"side: build {hs['item']['build']:.3f}, Cholesky {hs['item']['cholesky']:.3f}, "
              f"solve {hs['item']['solve']:.3f}; peak device {hs['peak_gb']:.4f} GB "
              f"({hs['peak_gb_above_inputs']:.4f} above the resident inputs) | {smi}")
    print(f"  ALS path: pio import {als_run['import_s']:.3f} s, pio train "
          f"{als_run['pio_train_s']:.3f} s (peak {als_run['pio_train_peak_device_gb']:.3f} GB), "
          f"checkpointed and resumed {als_run['checkpointed']['pio_train_s']:.3f} s; "
          f"e-commerce pio train {ecomm_run['pio_train_s']:.3f} s, rule queries p50 "
          f"{ecomm_run['http_p50_ms']:.3f} ms p99 {ecomm_run['http_p99_ms']:.3f} ms | {smi}")
    load_launches = sum(r["k1_launches"] for r in frontend["load"])
    by_route = {route: sum(r["k1_by_route"][route] for r in frontend["load"])
                for route in ("streaming", "tiled")}
    for r in frontend["load"]:
        print(f"  front end, {r['setting']} ({r['pool']} handler threads), {r['clients']} "
              f"clients: p50 {r['p50_ms']:.3f} ms p99 {r['p99_ms']:.3f} ms {r['qps']:.1f} q/s; "
              f"mean batch {r['batch']['mean']:.2f}; K1 {r['k1_launches_per_query']:.3f} "
              f"launches a query {r['k1_by_route']} | {smi}")
    for r in frontend["profiled"]:
        h = r["host_calls"]
        print(f"  front end profiled, {r['setting']}, 32 clients: device busy "
              f"{r['device_busy_share']:.4f} of the wall, {r['device_us_per_call']:.1f} us a "
              f"call against a host p50 {h['p50_ms']:.3f} ms ({h['calls']} calls, their sum "
              f"{h['share_of_wall']:.3f} of the wall); torch operators' host self time "
              f"{'not measured' if r['host_op_share'] is None else round(r['host_op_share'], 4)}"
              f" of the wall | {smi}")
    fi, fr = frontend["ingest"], frontend["reload"]
    print(f"  ingest over HTTP {fi['events_per_s']:.0f} events/s (batch p50 "
          f"{fi['batch_p50_ms']:.3f} ms p99 {fi['batch_p99_ms']:.3f} ms); hot reload: new "
          f"instance named {fr['get_names_new_s']:.3f} s, first new answer "
          f"{fr['first_new_answer_s']:.3f} s after pio train; memory_allocated "
          f"{fr['memory_allocated_before']} -> {fr['memory_allocated_after']} B; UR under "
          f"{UR_LOAD[1]} clients mean batch {served['load']['batch_mean']:.2f} | {smi}")
    for leg in ("parity", "full"):
        for name, r in scale[leg].items():
            if isinstance(r, dict) and "wall_s" in r:
                print(f"  CCO {leg} leg, {name}: {r['wall_s']:.3f} s, {r['events_per_s']:.4g} "
                      f"events/s, peak {r['peak_device_gb']:.3f} GB, K2/K3 launches "
                      f"{r['launches']} | {smi}")
    print(f"  CCO full leg staging (block_interactions_stream, host) "
          f"{scale['full']['staging_s']:.3f} s | {smi}")
    for name in ("cooccurrence", "als"):
        r = similar[name]
        print(f"  similar-product {name}: pio train {r['pio_train']['wall_s']:.3f} s, "
              f"/queries.json p50 {r['http_p50_ms']:.3f} ms p99 {r['http_p99_ms']:.3f} ms | {smi}")
    ra, rh = caches["response_cache"]["audit0_c1"], caches["host_tail"]
    print(f"  UR caches (phase 17): response-cache hits p50 {ra['hits'].get('p50_ms', 0):.3f} "
          f"ms p99 {ra['hits'].get('p99_ms', 0):.3f} ms, misses p50 "
          f"{ra['misses'].get('p50_ms', 0):.3f} ms p99 {ra['misses'].get('p99_ms', 0):.3f} ms "
          f"(one client); host tail p50 {rh['host']['p50_ms']:.3f} ms p99 "
          f"{rh['host']['p99_ms']:.3f} ms against the device tail's p50 "
          f"{rh['device']['p50_ms']:.3f} ms p99 {rh['device']['p99_ms']:.3f} ms; "
          f"checkpointed pio train {caches['checkpointed_train']['wall_s']:.3f} s "
          f"(plain {caches['checkpointed_train']['plain_wall_s']:.3f} s); phase 17 "
          f"{caches['wall_s']:.3f} s | {smi}")
    a18, b18, c18 = slice13["eval_reco"], slice13["eval_ur"], slice13["complementary_purchase"]
    d18, e18 = slice13["product_ranking"], slice13["small_templates"]
    print(f"  phase 18 {slice13['wall_s']:.3f} s: 18a pio eval {a18['pio_eval_s']:.3f} s, "
          f"FastEval {a18['fast_eval_s']:.3f} s; 18b UR eval {b18['eval_s']:.3f} s (3 trains); "
          f"18c pio train {c18['pio_train_s']:.3f} s, carts p50 {c18['http_p50_ms']:.3f} ms p99 "
          f"{c18['http_p99_ms']:.3f} ms; 18d pio train {d18['pio_train_s']:.3f} s, {PR_CLIENTS} "
          f"clients p50 {d18['p50_ms']:.3f} ms p99 {d18['p99_ms']:.3f} ms; 18e "
          + "; ".join(f"{k} train {v['pio_train_s']:.3f} s p50 {v['p50_ms']:.3f} ms p99 "
                      f"{v['p99_ms']:.3f} ms" for k, v in e18.items() if isinstance(v, dict))
          + f"; launches {slice13['launches']} | {smi}")
    print(f"  phase 19 {follow['wall_s']:.3f} s: bootstrap {follow['bootstrap_s']:.3f} s, "
          f"append -> reflected p50 {follow['p50_ms']:.3f} ms p99 {follow['p99_ms']:.3f} ms "
          f"(gate {follow['gate_ms']:.0f} ms), state bytes {follow['state_bytes']}, "
          f"K2/K3 launches during the folds {follow['launches_during_folds']}, card retrain "
          f"{follow['retrain_s']:.3f} s; 19b bootstrap {follow['small_cli']['bootstrap_s']:.3f} "
          f"s, fold {follow['small_cli']['fold_s']:.3f} s | {smi}")
    print(f"  phase 20 {planes['wall_s']:.3f} s: append -> reflected at the subscriber p50 "
          f"{planes['p50_ms']:.3f} ms p99 {planes['p99_ms']:.3f} ms (gate "
          f"{planes['gate_ms']:.0f} ms); full arena {planes['full_arena_bytes']} B; publish "
          f"bytes by path {planes['publish_bytes']}; fold delta write amplification "
          f"{planes['fold_delta_amplification']}; duplicate-only "
          f"{planes['duplicate_delta']['write_amplification']:.6f}; fresh compose "
          f"{planes['fresh_compose_s']:.3f} s; restart to convergence "
          f"{planes['restart_converged_s']:.3f} s; card memory first {planes['memory_first']} "
          f"last {planes['memory_last']} | {smi}")
    print(f"  phase 21 {shard['wall_s']:.3f} s: pio import {shard['import_events_per_s']:.0f} "
          f"events/s; cold merged scan {shard['cold_scan_events_per_s']:.0f} events/s on "
          f"{shard['scan_workers']:.0f} workers, per-shard seconds "
          f"{[round(x, 4) for x in shard['scan_shard_s']]}; pio train {shard['train_s']:.3f} s; "
          f"append -> reflected p50 {shard['p50_ms']:.3f} ms p99 {shard['p99_ms']:.3f} ms; "
          f"promotion to the next acknowledged write {shard['promotion_to_acked_write_s']:.3f} "
          f"s; replica lag at the end {shard['replica_lag_end']} | {smi}")
    tr = caches["traced"]
    fo = frontend["observability"]
    print(f"  observability: phase 17's traced device-tail queries (PIO_SERVE_BATCH=off) "
          f"ur_predict median {statistics.median(tr['ur_predict_ms']):.3f} ms, laps median "
          f"{ {k: round(v, 4) for k, v in tr['laps_median_ms'].items()} } ms, the widest "
          f"{tr['widest_lap']}; phase 14 at 32 clients, the flight recorder "
          + ", ".join(f"{k} p50 {v['p50_ms']:.3f} ms {v['qps']:.1f} q/s"
                      for k, v in fo["tracing_32_clients"].items())
          + "; phase 19 append_observed -> first serve "
          f"{[round(d['append_to_first_serve_ms'], 3) for d in follow['observability']['rounds']]}"
          f" ms; phase 20 propagation observed "
          f"{planes['observability']['propagation_observed']} times; phase 22 "
          f"{dashboard['wall_s']:.3f} s | {smi}")
    rb = ranks["ranks"]
    print(f"  phase 23 {ranks['wall_s']:.3f} s: 23a {ranks['a']['backend']}, 23b-d "
          f"{rb[0]['backend']}; pio train over two ranks "
          + ", ".join(f"rank {r['rank']} {r['ur']['wall_s']:.3f} s peak {r['ur']['peak_gb']:.3f} "
                      f"GB, {collective_text(r['ur']['collectives'])}" for r in rb)
          + f"; ALS factors {ranks['als']} | {smi}")
    print(f"  phase 24 {drills['wall_s']:.3f} s: "
          + ", ".join(f"{name} {drills[name]['wall_s']:.3f} s (K2/K3 "
                      f"{drills[name]['launches']['llr_masked']}/"
                      f"{drills[name]['launches']['tile_topk']})" for name in DRILLS)
          + f" | {smi}")
    print(f"  chip_smoke wall {time.perf_counter() - t_start:.3f} s | {smi}")
    launches = {"masked_score": (http_launches + batch_launches + als_run["k1_launches"]
                                 + load_launches + slice13["launches"]["masked_score"]),
                "llr_masked": (deployed["launches"][0] + scale["launches"][0]
                               + similar["launches"][0] + follow["launches"][0]
                               + planes["launches"][0] + shard["train_launches"][0]
                               + shard["launches"][0]
                               + sum(c[1] for c in caches["checkpointed_train"]["calls"])
                               + slice13["launches"]["llr_masked"]
                               + sum(r["ur"]["launches"][0] for r in ranks["ranks"])),
                "tile_topk": (deployed["launches"][1] + scale["launches"][1]
                              + similar["launches"][1] + follow["launches"][1]
                              + planes["launches"][1] + shard["train_launches"][1]
                              + shard["launches"][1]
                              + sum(c[2] for c in caches["checkpointed_train"]["calls"])
                              + slice13["launches"]["tile_topk"]
                              + sum(r["ur"]["launches"][1] for r in ranks["ranks"]))}
    print(json.dumps({"ur_train": {"bench_shape": bench, "memory_store": memory,
                                   "deployed_width_localfs": deployed,
                                   "deployed_width_snapshot": snapshot},
                      "ur_http": {str(k).lower(): v for k, v in served.items()},
                      "als": {"deployed_path": als_run, "ecommerce": ecomm_run,
                              "timing": als_timing},
                      "frontend": frontend, "cco_scale": scale,
                      "similar_product": similar, "ur_caches": caches,
                      "follow": follow, "plane": planes, "sharded": shard,
                      "slice13": slice13, "dashboard": dashboard, "traced_als": traced_7,
                      "ranks": ranks, "drills": drills,
                      "k1_retime": k1_rounds, "empty_kernel_ms": empty_ms, "llr_sass": sass,
                      "wall_s": time.perf_counter() - t_start}))
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda",
        "source": f"predictionio_tpu_torch/ops/csrc/{name}.cu",
        "replaces": REPLACES[name], "launches": launches[name],
        "max_abs_err": errs[name], "ms": rows[name][0]["ms"],
        "plain_ms": rows[name][0]["plain_ms"], "bound_ms": rows[name][0]["bound_ms"],
        "bound_by": rows[name][0]["bound_by"], "library_ms": rows[name][0]["library_ms"],
        "shapes": rows[name], "card": smi,
        **({"launches_by_route_phase14": by_route} if name == "masked_score" else {})}
        for name in REPLACES]}))


def main() -> int:
    try:
        run()
    except Exception:   # any failed phase: report it, print no result
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
