#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

1. Setup: the card's name and power limit, torch/CUDA versions, and the
   build of every kernel from ``src/repro_torch/csrc`` (time and the
   ``-Xptxas -v`` summary).
2. Kernel checks: each kernel against its plain PyTorch version on the
   card, at the main path's shapes (the paper's 150 MB budget: k = B =
   4218 clusters/prototypes, d = 384, 256-document microbatches, 64-query
   flushes, nprobe 8, top-10). Floats agree within rtol 1e-5 (atol 1e-6);
   decisions (keep, label, ids, pos, routes) are equal except at
   near-ties, where the plain version's competing scores differ by under
   1e-5 and the kernel's pick must score within 1e-5 of the plain pick;
   int8 rows are equal or off by one only where v/scale lies within 1e-4
   of a half-integer; scales agree within 2 ulp. Times are CUDA events over
   warm repeated calls.
   The staged path's kernels (rerank, prefilter, assign) are held the
   same way, with their edge cases: a depth-32 strided ring view, fp32
   rings, dead and duplicate routes, k above the live count; a zero
   basis row and a batch off the rows a block takes; K = 4218 and B = 1.
   Admit is also held with live=None (every row live). Serve's route-only
   entry (the serving cache's route witness) must give the fused kernel's
   routes bit for bit, and agree with its plain version under the
   near-tie rule. Admit's two
   launches (prologue, tile kernel), mips's (score-and-select, merge) and
   serve's (route tiles, routed rerank) are timed apart; assign's, admit's and prefilter's kernels per
   call are listed as torch.profiler records them, and the launch floor
   (one empty kernel from ``csrc/launch_floor.cu``) is timed as the
   kernels are.
3. Main path: a ``RAGServer`` on the full-size int8 config ingests 16
   batches of the NYT-like stream and answers queries two-stage, then a
   prototype-only server answers on the same engine; every ticket must be
   answered, every kernel launched (counts reset just before, read just
   after) and no plain version called; the heavy-hitter kernel launches
   once per batch. The fp32 config (depth 16) runs a few batches too.
   Answers are checked against the plain versions. The fused ingest
   ms/batch is printed next to the per-arrival loop's (PERF.md).
3b. Heavy hitter: the kernel against its plain loop, every state leaf and
   info entry exact, on the main path's own 16 calls (their masked labels
   and draws), on a Zipf label stream over 4218 clusters at capacity 100
   for every policy with exact counts, Morris, adaptive (max capacity 200)
   and gate_below_capacity, on an all-dropped batch whose window is full,
   and at B = 1. Then timed: the main path's busiest batch, and 256 valid
   Zipf arrivals at bmax 4218 (MIN_EVICT; RANDOM_EVICT) and at capacity
   100 (full), each with its device ms, the wrapper's host ms a call, us
   per valid arrival, its hits, inserts, evictions and dropped arrivals,
   the bound (the Gumbel rows of the arrivals that evict, not all B x
   bmax) and the plain loop's host ms.
4. Staged path: the same config, seed, warmup and the main path's own 16
   batches, from a fresh init, through ``engine.staged_ingest_impl``
   (``screen -> assign_update -> count -> update_representatives ->
   store_write (store-side quantize) -> upsert_snapshot``), and 8 flushes
   of 64 queries through ``route -> rerank -> decode_rerank`` on a
   published snapshot; counts reset just before: prefilter and assign
   launch once per batch, mips and rerank once per flush, heavy_hitter
   once per batch, admit and serve never, no plain version runs. The store must fill (at least 128 live
   ring slots, 8 valid prototypes, 90% of routes and picks live), so the
   comparison is not empty. Held per batch against the fused
   ``ingest_impl`` on the same batches and counter draws (keep, labels
   and ring rows under the near-tie rule; a near-tie that flips a
   decision is reported and ends the comparison there), and per flush
   against the fused ``serve_topk`` on the same snapshot (routes, pos).
4b. Async path: an ``AsyncServer`` on the same config, seed and warmup
   ingests the main path's 16 batches by ``serve_round`` (publish every
   4; ingest on its own CUDA stream) while a submitter thread submits a
   64-query burst a round; then ``sync``, the remaining flushes, and
   ``close``. Every ticket is answered exactly once, from a published
   snapshot; sampled flushes, run again whole on the recorded snapshot
   they name, give the same answers bit for bit; the lag is 0 after
   ``sync``; admit, heavy_hitter and serve launch (counts reset just
   before) and no plain version runs; torch.profiler puts the ingest
   kernels on another stream than serve's. Prints flush and answer
   p50/p99 while ingest runs beside the synchronous server's, ingest
   ms/batch on the ingest thread, docs/s and the lag at each publish.
   Then the same run once more with the interpreter's thread switch
   interval at 0.5 ms (default 5 ms), with the same checks: a diagnostic
   of how long a flush waits for the interpreter lock behind ingest.
4c. Cached async path (run after 6, so that the recsys phases' peak
   memory does not carry the new servers' per-stream cuBLAS workspaces):
   an ``AsyncServer`` with the result cache (384
   entries) and the hot set (capacity 64, refresh every 8 flushes, min
   count 2, an 8 MB pin budget = a tier of 256 clusters of 25,348 B) on
   the same config, seed and warmup ingests the main path's 16 batches
   (publish every 4) while 64-query flushes of Zipf (alpha 1.1) draws
   over a pool of 512 stream queries run, then 16 flushes with ingest
   idle, then a batch of padding rows (doc id -1: a publish that moves no
   cluster, so every entry survives it) and the last idle round once
   more; counts reset just before: serve's route-only entry launches once
   per flush that had pending queries (the route pass; mips never), the
   heavy-hitter kernel once per such flush on the query stream beside once
   per ingest batch, serve for the cold and hot sub-batches, no plain
   version; no route order is left unwitnessed and no served row's routes
   differ from the pass's. Every ticket is answered
   once and every answer equals, bit for bit (scores, doc ids, clusters),
   its query served alone by ``engine.query_snapshot`` on the recorded
   snapshot it names; hits, hot-tier serves, tier rebuilds and re-keyed
   entries must be non-zero, and the route-checked hits at least the 59
   the mips witness with its near-tie margin gave. Every query-side
   counter update the path made (the state before it, its signatures) is
   run again through the kernel and its plain loop, every leaf equal; every
   tier serve (the tier's rings and remapped route labels, the queries) is
   run again through the serve kernel and its plain version under the
   near-tie rule. Prints the flush p50/p99 (while ingest runs; idle)
   beside the same idle draws uncached on the same snapshot, the hit
   rate, the route-free exact and the route-checked hits, what the route
   check met before the clean publish (hits, routes moved, orders a
   near-tie left open: 0), the witness over the 512-query pool on the last
   snapshot (its routes must equal the served routes bit for bit; the
   near-ties among them are printed), hot-served, pinned bytes, and the
   query-side counter's device ms a call.
4d. Durable async path (after 4c): first, two engines ingest the 16 batches and
   must end bit-equal (ingest is deterministic on the card). Then a
   durable ``AsyncServer`` (journal + checkpoints every 4 applied batches,
   fsync, in a temporary directory) takes 12 batches with flushes between
   them, and its ingest thread is killed at admit hit 11
   (``faults.inject("ingest.admit:crash@11")``); a new server on the same
   directories recovers (restore, then replay of the journal tail on the
   ingest stream) and ingests the last 4 batches. Its engine state must
   equal the uncrashed engine's leaf for leaf, bit for bit (generator,
   store and counter included); admit and heavy_hitter launch once per
   applied, replayed and new batch. Prints the journal append ms, the
   full and delta checkpoints (MB, dirty clusters, device copy ms, write
   ms), the save's host ms on the ingest thread, recovery ms (restore,
   then replay) and the flush p50 overall and while a checkpoint write
   was in flight.
4e. Sharded path (after 4d): a ``ShardedEngine`` on ``make_streaming_mesh(2,
   2)`` (all four shards on the one card; the device map is printed) on
   the same config, seed and warmup ingests the main path's 16 batches,
   publishes every 4 (full, then delta by the dirty signature) and answers
   8 fused flushes of 64 queries, 4 staged and 4 prototype-only; counts
   reset just before: admit and heavy_hitter launch twice a batch, serve
   twice a fused flush, rerank twice a staged one, mips once a staged or
   prototype-only flush, no plain version. Each data shard must equal a
   single-device ``Engine`` replaying its half of every batch from
   ``shard_init_state``, bit for bit; the last publish must equal a full
   rebuild (``reconcile_states``) on the card bit for bit and on the host
   (ints exact, floats within rtol 1e-5); every answer must equal the
   single-device query on the merged snapshot under the near-tie rule;
   every admit and heavy_hitter call of the sharded ingest (128 rows a
   shard) is recorded with its output and held against its plain version
   on the same inputs (admit under the near-tie rule, every counter leaf
   and info entry bit for bit); every serve call under its localized label
   table and every rerank call under its localized routes is run again
   against the plain version; one store shard holds half the store's bytes. Prints ingest ms/batch
   (sharded, the two replays, one engine on the whole batch), publish ms
   and dirty clusters, a full rebuild's ms on the card and the host, the
   fused flush p50/p99 beside the single-device one, and peak memory.
4f. The launcher: ``python -m repro_torch.launch.serve --mesh 2,2
   --two-stage --async --cache-entries 384 --hotset --checkpoint-dir <tmp>``
   at d = 384, int8 depth 64, 16 batches of 256 with 64 queries each, in
   its own process; it must exit 0 with every query it submitted answered,
   the map on one device, no restart, a checkpoint per batch, and one store
   shard holding half the bytes of a k = 150 store; a second run of 2
   batches on the same directory must recover from that last checkpoint
   with nothing left to replay. Its traffic repeats no query, so cache hits
   and pinned clusters are 0 by construction (printed, not held: 4c holds
   the cache and hot tier); its kernels at k = 150 are not held against
   their plain versions (4e holds the same kernels at k = 4218).
5. Recsys kernels: the bag kernel against its plain version at MIND's
   serve_p99 and serve_bulk shapes (1,000,000 x 64 item table, histories
   of 50 drawn from a Zipf popularity, p ~ 1/r^1.2, with a valid prefix
   of uniform length), plus its edge cases (unsorted segments with empty
   bags, a bf16 table, int64 ids, d = 18, weights=None in sum and mean, a
   bag of one entry; the d = 18 cases, N(0, 1) rows, against the plain
   version on the CPU, whose order of summation is the kernel's; wherever
   the segments are sorted, the sorted entry equals the sorting wrapper
   bit for bit); device time of MIND's path (the sorted entry: one
   launch) and of the sorting wrapper, plain, library
   (``F.embedding_bag`` + divide) and bound. Mips at MIND's retrieval
   shape (4 x 64 against 1,000,000 x 64, k = 100) likewise, and at DIEN's
   and FM's (1 x 18 and 1 x 11 against 1,000,000 rows of N(0, 0.02)), each
   with its two launches timed apart, beside the plain version and the
   library.
6. Recsys path: MIND at full width (``configs/mind.py``, params drawn on
   the card from a seeded generator) runs serve_p99, serve_bulk and
   retrieval_cand once each with the counts reset just before: bag
   launches once per user_vectors call, mips once per retrieve, no plain
   version runs; one more user_vectors call makes exactly one bag launch
   (the counter) and no sort (torch.profiler's kernel list holds one
   bag kernel and no sort kernel). Outputs are finite and shaped as the
   reference's;
   user_vectors and scores agree with the same steps on the plain bag,
   retrieved ids with plain mips + stable top-k under the near-tie rule.
   Per step: device ms, host ms, peak memory. DIEN, BERT4Rec and FM then
   run serve_p99, retrieval_cand and serve_bulk at full width (BERT4Rec's
   serve_bulk is skipped: its [262144, 2, 200, 200] fp32 attention
   scores alone are 84 GB, more than the card holds); each one's retrieved
   scores and ids are held against plain mips + stable top-k on the
   queries and table its retrieve hands mips (FM's [1,000,000, 11] table).
7. Comparison path (after 4f): the eight methods of ``core/baselines.py``
   at the tables' settings (``benchmarks/common.py::default_methods``:
   static capacity 1024, full rebuild buffer 1024 k 100 every 256,
   reservoir 256, heap-only 512 anchors capacity 100, IVF-PQ 2048 / 32
   cells / m 8 / nprobe 8, SAKR k 100 capacity 100, streaming k 150
   capacity 100 every 256 alpha 0.1; table 14's two-stage: depth 16,
   nprobe 16) at d = 384 replay one NYT-like stream: 2 warmup batches of
   256, then 24, a round of 50 queries every 4. Counts reset just before
   each method: mips once a round for the flat-index methods and the
   prototype-only pipelines, serve once a round two-stage, admit and
   heavy_hitter once a batch through the pipelines, heavy_hitter once a
   batch for heap-only, none for IVF-PQ, no plain version. Each method's
   last round is held against the same state queried through the plain
   versions (IVF-PQ: on the CPU) under the near-tie rule; every admit call
   of the pipelines under the near-tie rule, every heavy-hitter call of
   heap-only and SAKR against the plain loop, bit for bit. Printed per
   method: ingest ms/batch (median, host clock around ``synchronize()``),
   query ms a round, ``memory_bytes()``, Recall@10 and nDCG@10 against an
   exact oracle over every document streamed (diagnostics, no limits);
   the retrieval bound (``theory.check_bound``) on the streaming method's
   final state; table 13's QA (a fact stream over the BTC-like stream, 64
   entities, 40 batches of 128, 60 questions, each answered): EM, F1 and
   ROUGE-L, static (capacity 1024) against streaming (k 150, capacity
   100, every 128, alpha 0.1).
8. Training path (after 7, its state freed): the bag backward kernel
   (``csrc/bag_backward.cu``, port-side: the reference cannot
   differentiate its Pallas bag) against its plain version on the card at
   MIND's train shape (65,536 histories of 50: 3,276,800 entries into the
   1,000,000 x 64 item table, Zipf ids, padding at row 0 with weight 0)
   in mean and sum, weights None, the train launcher's batch (every entry
   on row 0, weight 1), a bf16 table, int64 ids, weights requiring grad
   (d_w), d = 18, B = 1, and unsorted segments with empty bags (also
   through ``ops.embedding_bag``'s autograd node): each element within
   1e-5 of the sum of its own terms' magnitudes + 1e-6 (bf16: half a bf16
   ulp more, the kernel's f32 sum rounded once), untouched rows zero, two
   calls bit-equal. Timed: device ms beside a stable ``torch.sort`` of
   the ids (the library yardstick of the kernel's own sort), plain,
   library (autograd of ``F.embedding_bag(..., per_sample_weights=w)`` +
   divide, timed only) and bound; one call split by launch under
   torch.profiler into the kernel's parts (sort, clear, counts, offsets +
   chunk sums + hot-row partials, level 2, spanning rows, dense pass; a
   launch outside the kernel fails the run). The row gathers' backward (``gather_backward``: the
   same kernel, one entry a bag, for the gradient of ``item_emb[ids]``)
   likewise at MIND's history gather, every id on row 0, int64 ids and
   the target gather, its library yardstick PyTorch's own backward of
   ``table[ids]``, its split, and each of a step's four row gathers timed
   at its own shape (history, target twice, 512 negatives; the last three
   beside their plain version and the library's). Then one MIND train step
   through the kernels against the same step through the plain bag and
   gather backward on the card, from the same state and draws (gradients
   within rtol 1e-5 and an atol of 1e-6 + 1e-5 x the magnitude of the
   element's own bag and gather terms; params after ``apply`` within rtol
   1e-5 / atol 1e-6); ``apply``'s device ms; one step with the gathers'
   backward by PyTorch's own indexing beside one by the kernel; one step
   under torch.profiler, its device time by kernel and its idle share.
   Then the slice's path: a ``Trainer`` with MIND's optimizer
   (``configs/mind.py``: AdamW, lr 1e-3, clip 1.0) takes 6 steps of
   65,536 on seeded Zipf batches with a checkpoint every 3, counts reset
   just before: bag and bag_backward launch once a step, gather_backward
   4 times (history, target twice, negatives), nothing else, no plain
   version; losses finite, the params move; a second ``Trainer`` on
   the same directory resumes at 6 and reaches 8. Printed: step ms (host
   clock around ``synchronize()``), steps/s, the bag's device ms a step,
   ``apply`` ms, peak memory, checkpoint MB and a blocking write's ms.
   FM, DIEN and BERT4Rec then take 2 steps each at full width, at 65,536
   rows where a step fits in three quarters of the card's memory (a
   memory-fraction cap; an OutOfMemoryError halves the batch), else at
   the largest power of two that does, the cut printed with its reason. Last, the train launcher
   (``python -m repro_torch.launch.train --arch mind --full --steps 4
   --ckpt-interval 2``) in its own process, then again to 6 on the same
   directory, which must resume at 4.
9. Models path (last, after ``empty_cache()``; no kernel of the port is on
   it, and counts reset just before must read 0; (b)-(e) under
   ``torch.no_grad()``, ``empty_cache()`` between the models). The checks
   run on params from ``init`` with the attention projections rescaled to
   the usual fan-in (``conditioned``): at the init's own scale
   (the reference's Builder takes the heads axis as fan-in) the scores
   are nearly one-hot and a random model past a few layers is chaotic,
   fp32 rounding alone moving its logits by O(1); that yardstick is
   printed (fp32 vs a float64 run, at 2 layers and at full depth).
   (a) The paper's embedder (``streaming-rag-embedder``) at full width
   embeds 512 x 128 seeded token ids under padding masks of varied
   lengths with one all-padding row; the card's result equals the same
   module's on the CPU with the same params within max abs err 1e-4 (at
   the init's own scale printed too), the all-padding row is exactly
   zero, the rest unit norm; then a ``Trainer`` takes 3 steps of
   ``train_pairs`` (256 x 128) from ``init``, losses finite. (b)
   qwen2-1.5b at full width (bf16, flash, QKV bias, tied): ``prefill`` 4
   x 1024 with budget S + 32, 32 greedy ``decode_step``s, then the
   reference's decode-vs-forward check: the last decode's logits against
   ``hidden`` + ``logits`` over the whole sequence, within 5e-2 of max
   |logit| in bf16 and 1e-3 in fp32 (the same params upcast), the argmax
   equal in every row but at a near-tie (a top-2 gap under that max abs
   err); on the fp32 prefill the flash path against the q-chunked exact
   path (``use_flash=False``), logits and cache k / v within 1e-4 of
   their max |value|, each beside the exact path's distance from a
   float64 run. (c) h2o-danube-1.8b at full width (bf16, window 4096):
   ``prefill`` 1 x 4608, past the window, so every cache slot holds
   position p at slot p % 4096 (the last 4096 positions); 16 decode
   steps; the same check over 4624 tokens. (d) deepseek-moe-16b at full
   width and full depth (bf16, flash; 16.38 B params): first one MoE
   layer of it at fp32 on 4096 seeded tokens, at its capacity factor
   1.25 and at 1.0 (C 384, the mean load, where assignments must drop:
   asserted), the card against the same function on the CPU (expert ids
   equal but where two router scores lie within 1e-5, every assignment's
   slot or drop equal away from the experts a near-tie moved, y within
   1e-4 of max |y| on the tokens routed alike, aux within rtol 1e-5, two
   card calls bit-equal); then ``prefill`` 4 x 1024 with budget S + 32 and 32 greedy
   ``decode_step``s, decode vs forward as in (b) with the MoE capacity
   raised so that no assignment drops (asserted: 0 dropped), within 5e-2
   in bf16 and, on params of its own cut to 4 layers (1 dense, 3 MoE; the
   fp32 model at full depth is 65.5 GB), within 1e-3 in fp32; at the real
   capacity factor the dropped share of each MoE layer of the prefill is
   printed, and the decode floor (every weight a step uses read once at
   3.35 TB/s) beside the decode time. (e) deepseek-v3-671b at full width
   cut in depth to 4 layers (its 3 dense layers and 1 MoE layer, with the
   MTP block: 26.72 B params, 53.4 GB; at full depth 1.34 TB): one MLA
   layer at fp32, B = 1, S = 512, card vs CPU (``mla_attention`` and the
   prefill cache's c_kv / k_rope within 1e-4 of their max); ``prefill`` 2
   x 256 + 16 decode steps with the capacity raised, decode vs forward
   within 5e-2 in bf16; a timed ``prefill`` 2 x 2048 at the real capacity
   factor; ``loss`` on 2 x 512 with MTP, ce / aux / mtp_ce finite. Params
   are ``conditioned`` in every stack and the MTP block (MLA's wq_b to std
   1/sqrt(q_lora_rank), wk_b / wv_b to 1/sqrt(kv_lora_rank), wo to
   1/sqrt(h * v_head_dim)), the init's float64 yardstick printed beside
   (deepseek-moe-16b at 2 and 4 layers, deepseek-v3's dense MLA layers at
   1 and 2). Neither config trains at full width on one card: its optimizer
   state does not fit; phase 11 prints the share a device of a mesh would
   hold by the specs.
   Printed: device ms and sequences/s (encoder), step ms, prefill ms,
   decode ms a token and tokens/s, launches, kernel ms and idle share of
   one call, peak memory (after each deepseek ``init`` too), each beside
   the card's name and power limit, and each part's seconds.
10. GNN path (last, after ``empty_cache()``): MeshGraphNet at full width
   (15 layers, d_hidden 128, 2-layer MLPs with LayerNorm, sum aggregation,
   remat). minibatch_lg's batches are sampled on the host by the
   ``NeighborSampler`` (1,024 roots, fan-out 15 then 10) from
   ``random_csr_graph(232,965, 492)`` (~114.6 M edges), node features and
   labels gathered from seeded tables on the card. (a) The segment sum
   (``bag_backward.cu``'s gather entry run forward) against its plain
   version at minibatch_lg's padded shape (168,960 entries into 169,984
   rows, d = 128, ids the sampled batch's ``edge_dst``), with every id 0
   (the dummy batch's one hot row) and int64 ids: each element within
   1e-5 of the sum of its terms' magnitudes + 1e-6, empty rows exactly
   zero, two calls bit-equal; the gather backward the same way at
   ``hn[src]``'s shape; device ms, plain, library (``index_add_``) and the
   bound, and the entry's launches by part. (b) One forward, loss and
   gradient on the card against the same module on the CPU with the same
   params on a sampled batch (the CPU without remat, whose recompute
   gives the same values): outputs and loss within 1e-4 of their max
   |value|, each gradient leaf within 1e-3 of its max |grad| or, where
   the CPU's fp32 run is further than that from a float64 run of the
   same params (on the card, through the plain gathers and segment sums;
   a node-encoder weight's gradient sums ~88 k nodes' terms with
   cancellation), within twice that distance (printed); two card train
   steps from one state bit-equal. (c) ``Trainer`` runs of 3
   steps each on full_graph_sm (2,708 nodes and 10,556 uniform edges,
   padded to 3,072 / 10,752), molecule (128 molecules of 30 nodes and 64
   edges, the MSE branch) and minibatch_lg, then ogb_products full batch
   on a random CSR graph of its mean degree with nodes and edges halved
   together until a step fits (an OutOfMemoryError under the cap halves
   it; the cut printed with its reason); counts reset just before each
   run: the segment sum launches 2 a layer a step (forward, recompute),
   the gather backward 2, nothing else, no plain version; losses finite.
   (d) The train launcher (``--arch meshgraphnet --full --shape molecule
   --steps 4 --ckpt-interval 2``) in its own process, then resumed to 6.
   Printed: the host ms to sample a batch, step ms, steps/s, launches a
   step, the bag_backward.cu kernels' ms, kernel ms and idle share of one
   step (torch.profiler), peak memory, each beside the card's name and
   power limit.
11. Mesh path (training-side distribution): (a) every registered arch's
   train-state specs (``sharding.train_state_pspecs``) on 16 x 16 (data,
   model) and 2 x 16 x 16 (pod, data, model), computed on meta: no card
   memory allocated (asserted), the params + optimizer bytes a position
   holds printed beside the whole. (b) MIND at full width (65,536 rows,
   10^6 x 64 items, AdamW) with ``Trainer(mesh=...)`` on a 2 x 2 mesh whose
   every position is the one card: 3 ``fit`` steps on the mesh and 3
   without on the same batches, the states bit-equal (else the difference
   printed, failing past 1e-5 of max |value|); counts reset just before:
   bag 1, bag_backward 1 and gather_backward 4 launches a step, nothing
   else, no plain version; then the checkpoint written without the mesh
   restored onto it and one more step, bit-equal to the step without. (c)
   MIND's batch split over 4 data shards, each shard's gradients;
   ``compressed_grad_allreduce`` on the card and on the CPU from the same
   gradients (int8 payloads equal but one-off at half-integers within
   1e-4, scales within 2 ulp, totals within 1e-5 of max |value|); the
   int8 sum's error against ``fold_sum`` after 1 and 8 rounds of error
   feedback; ``hierarchical_psum`` on a 2 x 2 (pod, data) grid within 1e-5
   of ``fold_sum``. Printed: step ms with and without the mesh, a step's
   gather and split ms, the state bytes a position holds, peak memory,
   launches a step, device ms of the collectives, each beside the card's
   name and power limit.
12. One JSON line of kernel numbers, then ``{"ok": true, "device": ...}``.

Exits non-zero, printing no result, without a CUDA device or without the
rest of the repository beside it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import warnings

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

from repro_torch.configs.streaming_rag import paper_pipeline_config  # noqa: E402
from repro_torch.core import baselines, heavy_hitter, pipeline, theory  # noqa: E402
from repro_torch.core import index as index_lib  # noqa: E402
from repro_torch.data.qa import FactStream, exact_match, rouge_l, token_f1  # noqa: E402
from repro_torch.data.streams import make_stream  # noqa: E402
from repro_torch.distributed import collectives, compression, sharding  # noqa: E402
from repro_torch.engine import stages  # noqa: E402
from repro_torch.engine.engine import (Engine, ingest_impl,  # noqa: E402
                                       staged_ingest_impl)
from repro_torch.kernels import build, counts  # noqa: E402
from repro_torch.kernels.admit.admit import admit_cuda, admit_launcher  # noqa: E402
from repro_torch.kernels.admit.ref import admit_ref  # noqa: E402
from repro_torch.kernels.assign.assign import assign_cuda  # noqa: E402
from repro_torch.kernels.assign.ref import assign_ref  # noqa: E402
from repro_torch.kernels.bag import ops as bag_ops  # noqa: E402
from repro_torch.kernels.bag.bag import (embedding_bag_backward_cuda,  # noqa: E402
                                         embedding_bag_cuda, embedding_bag_sorted_cuda,
                                         gather_backward_cuda, segment_sum_cuda)
from repro_torch.kernels.bag.ref import (embedding_bag_backward_ref,  # noqa: E402
                                         embedding_bag_ref, embedding_bag_sorted_ref,
                                         gather_backward_ref, segment_sum_ref)
from repro_torch.kernels.common import (NEG_INF, l2_normalize,  # noqa: E402
                                        l2_normalize_queries, require_full_fp32,
                                        stable_topk)
from repro_torch.kernels.heavy_hitter.heavy_hitter import update_batch_cuda  # noqa: E402
from repro_torch.kernels.heavy_hitter.ref import update_batch_ref  # noqa: E402
from repro_torch.kernels.mips.mips import mips_launcher, mips_topk_cuda  # noqa: E402
from repro_torch.kernels.mips.ref import mips_topk_ref  # noqa: E402
from repro_torch.kernels.prefilter.prefilter import prefilter_scores_cuda  # noqa: E402
from repro_torch.kernels.prefilter.ref import prefilter_scores_ref  # noqa: E402
from repro_torch.kernels.rerank.ref import rerank_topk_ref  # noqa: E402
from repro_torch.kernels.rerank.rerank import rerank_topk_cuda  # noqa: E402
from repro_torch.kernels.serve.ref import serve_routes_ref, serve_topk_ref  # noqa: E402
from repro_torch.kernels.serve.serve import (serve_launcher, serve_routes_cuda,  # noqa: E402
                                             serve_topk_cuda)
from repro_torch.models import gnn as gnn_lib  # noqa: E402
from repro_torch.models import layers as lm_layers  # noqa: E402
from repro_torch.models import recsys  # noqa: E402
from repro_torch.launch.mesh import describe, make_debug_mesh  # noqa: E402
from repro_torch.models.api import TrainState, get_arch, list_archs  # noqa: E402
from repro_torch.models.transformer import TransformerLM  # noqa: E402
from repro_torch.models.testing import assert_finite, dummy_batch  # noqa: E402
from repro_torch.obs import kern  # noqa: E402
from repro_torch.serve.durability import CheckpointStore, DurabilityConfig  # noqa: E402
from repro_torch.serve.hotset import route_signature  # noqa: E402
from repro_torch.serve.runtime import AsyncServer  # noqa: E402
from repro_torch.serve.server import RAGServer, ServerConfig  # noqa: E402
from repro_torch.store import docstore, quant  # noqa: E402
from repro_torch.testing import faults  # noqa: E402
from repro_torch.train import checkpoint as ckpt_lib  # noqa: E402
from repro_torch.train import optimizer as opt_lib  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

PEAK_FP32 = 67e12      # H100 SXM fp32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12   # H100 SXM HBM3 bytes/s
RTOL, ATOL, TIE = 1e-5, 1e-6, 1e-5
SPIN_CYCLES = 300_000_000   # about 0.2 s of one spinning kernel at H100 clocks
SEED = 0
BATCH, QUERIES, TOPK, NPROBE = 256, 64, 10, 8
MAIN_BATCHES, STAGED_FLUSHES = 16, 8
# the staged store must hold at least this much for its comparison to mean
# anything (the main path's batches fill ~180 slots and ~11 prototypes)
MIN_LIVE_SLOTS, MIN_PROTOTYPES, MIN_LIVE_SHARE = 128, 8, 0.9
SOURCES = {"admit": "src/repro/kernels/admit/admit.py:177",
           "serve": "src/repro/kernels/serve/serve.py:230",
           "mips": "src/repro/kernels/mips/mips.py:79",
           "rerank": "src/repro/kernels/rerank/rerank.py:141",
           "prefilter": "src/repro/kernels/prefilter/prefilter.py:58",
           "assign": "src/repro/kernels/assign/assign.py:78",
           "bag": "src/repro/kernels/bag/bag.py:72",
           # serve.cu's route-only entry: stage 1 of serve_topk_pallas
           "serve_route": "src/repro/kernels/serve/serve.py:230",
           # port-side: no pallas_call; the reference's lax.scan of update_one
           "heavy_hitter": "src/repro/core/heavy_hitter.py:289",
           "bag_backward": ("port-side: no pallas_call; autodiff of "
                            "src/repro/kernels/bag/ref.py:13 embedding_bag_ref"),
           # bag_backward.cu's gather entry: one entry a bag, no segments
           "gather_backward": ("port-side: no pallas_call; the transpose of "
                               "src/repro/models/recsys.py:198's row gather (jnp.take)"),
           # the same entry's sum run forward: the GNN's aggregation
           "segment_sum": ("port-side: no pallas_call; src/repro/models/gnn.py:168 "
                           "jax.ops.segment_sum")}
# a kernel whose source is another's file
CSRC_OF = {"serve_route": "serve", "gather_backward": "bag_backward",
           "segment_sum": "bag_backward"}
RECSYS_STEPS = ("serve_p99", "serve_bulk", "retrieval_cand")
LOOP_INGEST_MS = 250.59   # fused ingest ms/batch with the per-arrival loop in place
#                           of the heavy-hitter kernel (PERF.md; H100 80GB HBM3, 700 W)
HH_ZIPF_CLUSTERS, HH_ZIPF_CAPACITY, HH_ZIPF_BATCHES = 4218, 100, 3
ASYNC_PUBLISH_EVERY = 4
# the cached path (4c): table 21's gate cell, Zipf alpha 1.1 over a pool
# larger than the cache; 8 MB of pinned tier = 256 clusters of 25,348 B
CACHE_ENTRIES, CACHE_POOL, CACHE_ZIPF, CACHE_IDLE_FLUSHES = 384, 512, 1.1, 16
PIN_BUDGET_MB, HOT_CAPACITY, HOT_REFRESH = 8.0, 64, 8
# route-checked hits on this path when the witness was the mips pass with a
# near-tie margin (five runs, H100 80GB HBM3 at 700 W; PERF.md): serve's own
# route pass verifies at least those
PARENT_ROUTE_CHECKED = 59
# the durable path (4d): checkpoint every 4 applied batches, the ingest
# thread killed at admit hit 11 (batch seq 10)
DURABLE_EVERY, DURABLE_CRASH_AT = 4, 11
# the sharded path (4e): a 2 x 2 mesh on the one card (k = 4218 divides by
# M = 2), a publish every 4 batches, then 8 fused flushes and 4 each staged
# and prototype-only; the launcher (4f) at the same width, in its own process
SHARDED_MESH, SHARDED_PUBLISH_EVERY, SHARDED_FLUSHES, SHARDED_OTHER_FLUSHES = (2, 2), 4, 8, 4
LAUNCH_FLAGS = ("--mesh", "2,2", "--two-stage", "--async", "--cache-entries", "384",
                "--hotset", "--dim", "384", "--store-depth", "64", "--store-dtype", "int8",
                "--batches", "16", "--batch", "256", "--qps", "64")
LAUNCH_TIMEOUT_S = 300
# the comparison path (7): the tables' methods at d = 384 over the NYT-like
# stream, 2 warmup batches then 24, a round of 50 queries every 4 batches;
# table 13's QA protocol (40 batches of 128, 60 questions, 20 topics)
CMP_DIM, CMP_WARM, CMP_BATCHES, CMP_ROUND_EVERY, CMP_QUERIES = 384, 2, 24, 4, 50
CMP_NPROBE = 16   # table 14's two-stage
QA_BATCHES, QA_BATCH, QA_QUESTIONS, QA_ENTITIES, QA_TOPICS = 40, 128, 60, 64, 20
# the training path (8): MIND at full width, a checkpoint every 3 of 6 steps,
# then a resume to 8 (4 row gathers a step: history, target twice,
# negatives); FM, DIEN and BERT4Rec a few steps each under a cap of three
# quarters of the card's memory, at 65,536 where a step fits under it, else
# at the largest power of two that does (an OutOfMemoryError fails the run);
# the train launcher
TRAIN_STEPS, TRAIN_CKPT_EVERY, OTHER_TRAIN_STEPS, MIND_GATHERS = 6, 3, 3, 4
TRAIN_BATCH, TRAIN_MEMORY_FRACTION = 65_536, 0.75
# FM peaks near 17-27 GB and DIEN near 59 GB (of a 63.8 GB cap) at 65,536;
# BERT4Rec's attention scores [B, 2, 200, 200] fp32, kept for the backward
# in each of 2 blocks with their softmax, put 8,192 rows near 32 GB, so a
# step at 16,384 or more does not fit under the cap
OTHER_TRAIN_BATCH = {"fm": 65_536, "dien": 65_536, "bert4rec": 8_192}
BERT4REC_TRAIN_CUT = ("bert4rec's train batch cut 65536 -> 8192: a step takes ~4 MB a "
                      "row (its attention scores [B, 2, 200, 200] fp32 and their softmax, "
                      "kept for the backward in each of its 2 blocks, are 1.28 MB of it), "
                      "so one at 16384 or more does not fit under the cap")
TRAIN_LAUNCH_FLAGS = ("--arch", "mind", "--full", "--ckpt-interval", "2")
# the models path (9): the paper's embedder at its embed and train_pairs
# shapes; qwen2-1.5b's prefill and greedy decode within its budget; a
# danube prefill past its 4096 window, so the ring wraps by 512
EMBED_SHAPE, EMBED_TOL, ENCODER_TRAIN_STEPS = (512, 128), 1e-4, 3
QWEN_SHAPE, QWEN_DECODE = (4, 1024), 32
DANUBE_SHAPE, DANUBE_DECODE = (1, 4608), 16
# decode-vs-forward relative to max |logit| (fp32; bf16); flash vs exact on the
# fp32 prefill, relative to each compared tensor's max |value| (PERF.md)
LM_FP32_TOL, LM_BF16_TOL, FLASH_EXACT_TOL = 1e-3, 5e-2, 1e-4
# DeepSeek (9d, 9e): one MoE layer of deepseek-moe-16b at fp32 on 4096 seeded
# tokens and one MLA layer of deepseek-v3 at B = 1, S = 512, card vs CPU
# (outputs and caches within 1e-4 of their max |value|, the aux loss within
# rtol 1e-5, expert ids equal but where two router scores lie within 1e-5);
# deepseek-moe-16b prefills 4 x 1024 and decodes 32 tokens at full depth in
# bf16, its decode-vs-forward also at fp32 on 4 layers (1 dense, 3 MoE);
# deepseek-v3 is cut to 4 layers (its 3 dense layers and 1 MoE layer, with
# the MTP block) and prefills 2 x 256 + 16 decode steps, then 2 x 2048
DS_MOE_SHAPE, DS_MOE_DECODE, DS_MOE_LAYER_TOKENS, DS_MOE_FP32_LAYERS = (4, 1024), 32, 4096, 4
DS_V3_LAYERS, DS_V3_SHAPE, DS_V3_DECODE, DS_V3_TIMED, DS_V3_LOSS = 4, (2, 256), 16, (2, 2048), (2, 512)
DS_LAYER_TOL, DS_AUX_RTOL, DS_TIE = 1e-4, 1e-5, 1e-5
# the MoE layer is held card vs CPU again at a capacity equal to the mean
# load (C 384), where assignments drop (asserted), so the drop path is compared
DS_DROP_CF = 1.0
DS_V3_CUT = ("deepseek-v3-671b cut in depth 61 -> 4 layers (its 3 dense layers and the first "
             "of its 58 MoE layers, with the MTP block): at full depth its params are 1.34 TB "
             "in bf16; the cut is 26.72 B params, 53.4 GB, which one 80 GB card holds beside "
             "a 2 x 2048 prefill")
DS_TRAIN_WAITS = ("neither deepseek config trains at full width on one card (phase 11 prints "
                  "a mesh device's share by the specs): AdamW's fp32 moments of deepseek-moe-16b "
                  "are 131 GB, Adafactor's factored state of deepseek-v3 plus its params far "
                  "past one card")
# the GNN path (10): MeshGraphNet at full width (15 layers, d_hidden 128,
# remat), 3 Trainer steps on each shape under the training path's memory
# cap; minibatch_lg's batches sampled on the host from a random CSR graph of
# its node count and mean degree; card vs CPU outputs and loss within 1e-4
# of their max |value|, each grad leaf within 1e-3 of its max |grad| or, where
# fp32 rounding alone (the CPU's fp32 run against a float64 one) moves that
# leaf further, within twice that (H100 80GB HBM3 at 700 W: node_encoder.w0
# card vs CPU 1.24e-3, the CPU vs float64 7.9e-4); ogb_products full batch on
# a random CSR graph whose nodes and edges are halved together until a step fits
GNN_TRAIN_STEPS, GNN_OUT_TOL, GNN_GRAD_TOL, GNN_MAX_HALVINGS = 3, 1e-4, 1e-3, 8
GNN_LAUNCH_FLAGS = ("--arch", "meshgraphnet", "--full", "--shape", "molecule",
                    "--ckpt-interval", "2")
# the mesh path (11): every arch's train-state specs on meta at 16 x 16 and
# 2 x 16 x 16; MIND at full width on a 2 x 2 mesh of the one card, 3 Trainer
# steps against 3 without the mesh on the same batches, then a checkpoint
# written without the mesh restored onto it and one more step; MIND's batch
# split over 4 data shards for the compressed all-reduce (card vs CPU: int8
# payloads equal but at half-integers within 1e-4, scales within 2 ulp,
# totals within 1e-5 of their max |value|) and the hierarchical sum on a
# 2 x 2 (pod, data) grid (within 1e-5 of fold_sum's max |value|)
MESH_SPEC_MESHES = (((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")))
MESH_SHAPE, MESH_STEPS, MESH_SHARDS, MESH_EF_ROUNDS, MESH_TOL = (2, 2), 3, 4, 8, 1e-5
# BERT4Rec's serve_bulk attention scores: 262144 x 2 heads x 200 x 200 fp32
BERT4REC_BULK_SKIP = ("bert4rec serve_bulk skipped on one card: its attention "
                      "scores [262144, 2, 200, 200] fp32 alone are 84 GB (the "
                      "reference runs it sharded over a pod); the CPU smoke "
                      "test covers the cell")


def full_config(store_dtype: str, depth: int) -> pipeline.PipelineConfig:
    return pipeline.budget_to_config(150.0, dim=384, base=paper_pipeline_config(
        dim=384, store_depth=depth, store_dtype=store_dtype))


def cuda_ms(fn, iters: int = 20) -> tuple[float, float]:
    """(device ms, host-bound ms) per call, warm. Device time: CUDA events
    around ``iters`` calls queued behind a spinning kernel, so the card
    never waits for the host's Python; host-bound: the same loop with the
    card idle, which is what a caller that waits on each call pays."""
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    torch.cuda._sleep(SPIN_CYCLES)
    ev[1].record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    queued_ms = (time.perf_counter() - t0) * 1e3
    ev[2].record()
    torch.cuda.synchronize()
    if queued_ms >= ev[0].elapsed_time(ev[1]):
        raise RuntimeError("the card caught up with the host: not a device time")
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) * 1e3 / iters
    return ev[1].elapsed_time(ev[2]) / iters, host


def device_ms(fn, iters: int = 20) -> tuple[float, str]:
    """``cuda_ms``'s device time where the call never waits for the card;
    for a call that does (a plain or library call that synchronizes
    inside, such as a large sort, or one whose thousands of launches fill
    the launch queue), CUDA events around ``iters`` warm calls, which then
    hold the host's share too. Returns (ms, how it was taken)."""
    try:
        return cuda_ms(fn, iters)[0], "queued"
    except RuntimeError:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(iters):
            fn()
        ev[1].record()
        torch.cuda.synchronize()
        return ev[0].elapsed_time(ev[1]) / iters, ("events around calls: the calls do not "
                                                   "queue ahead of the card")


def launch_floor_ms() -> float:
    """Device ms of one empty kernel on the current stream, by ``cuda_ms``:
    what one launch costs, read beside a bound far below it."""
    lib = build.load("launch_floor")
    lib.empty_launch.argtypes = [build.P]
    lib.empty_launch.restype = build.I
    stream = build.stream_of(torch.device("cuda"))
    return cuda_ms(lambda: build.check(lib, lib.empty_launch(stream), "empty_launch"))[0]


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def close(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a - b).abs() <= ATOL + RTOL * b.abs()


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max()) if a.numel() else 0.0


class Check:
    """Collects failures and near-tie counts of one kernel's checks."""

    def __init__(self, name: str):
        self.name, self.fail, self.ties, self.err = name, [], 0, 0.0

    def floats(self, what, k, p):
        self.err = max(self.err, max_err(k, p))
        bad = int((~close(k, p)).sum())
        if bad:
            self.fail.append(f"{what}: {bad} values off (max |d| {max_err(k, p):.3g})")

    def decisions(self, what, differ, tie_ok):
        """``differ`` marks mismatches, ``tie_ok`` those the near-tie rule
        allows."""
        n_diff, n_ok = int(differ.sum()), int((differ & tie_ok).sum())
        self.ties += n_ok
        if n_diff != n_ok:
            self.fail.append(f"{what}: {n_diff - n_ok} mismatches not at near-ties")

    def done(self, label):
        print(f"  check {self.name:9s} {label:28s} "
              f"{'ok' if not self.fail else 'FAIL'}  near-ties {self.ties}  "
              f"max|d| {self.err:.3g}")
        if self.fail:
            raise AssertionError(f"{self.name} {label}: " + "; ".join(self.fail))


# ------------------------------------------------------------------- admit
def check_admit(x, basis, cent, alpha, live, store_dtype, chk: Check):
    out_k = admit_cuda(x, basis, cent, alpha, live, store_dtype=store_dtype)
    out_p = admit_ref(x, basis, cent, alpha, live, store_dtype=store_dtype)
    torch.cuda.synchronize()
    hold_admit(out_k, out_p, x, cent, alpha, store_dtype, chk)
    return out_k


def hold_admit(out_k, out_p, x, cent, alpha, store_dtype, chk: Check):
    """The kernel's outputs against the plain version's: floats close,
    keep/labels/int8 rows equal but at near-ties."""
    r_k, keep_k, lab_k, sim_k, v_k, s_k = out_k
    r_p, keep_p, lab_p, sim_p, v_p, s_p = out_p
    chk.floats("r", r_k, r_p)
    chk.floats("sims", sim_k, sim_p)
    chk.decisions("keep", keep_k != keep_p, (r_p - alpha).abs() < TIE)
    sims = l2_normalize(x) @ l2_normalize(cent).T
    pick_k = sims.gather(1, lab_k.long()[:, None])[:, 0]
    pick_p = sims.gather(1, lab_p.long()[:, None])[:, 0]
    chk.decisions("labels", lab_k != lab_p, pick_k >= pick_p - TIE)
    if store_dtype == "int8":
        ulp = torch.nextafter(s_p, torch.full_like(s_p, np.inf)) - s_p
        bad_scale = int(((s_k - s_p).abs() > 2 * ulp).sum())
        if bad_scale:
            chk.fail.append(f"scales: {bad_scale} beyond 2 ulp")
        z = l2_normalize(x) / s_p[:, None]
        half = (z - z.floor() - 0.5).abs() < 1e-4
        diff = v_k.int() - v_p.int()
        chk.decisions("int8 rows", diff != 0, (diff.abs() == 1) & half)
    elif (v_k is None) != (v_p is None):
        chk.fail.append(f"rows: kernel gave {'none' if v_k is None else 'some'}, "
                        f"plain {'none' if v_p is None else 'some'}")
    elif v_p is not None:   # a store of depth 0 asks for no rows
        chk.floats("rows", v_k, v_p)


def admit_split(x, basis, cent, alpha, live, iters: int = 20) -> str:
    """Device ms of the kernel's two launches apart (the prologue, then the
    tile kernel) and together, int8 rows. Each timed tile kernel follows an
    untimed prologue, which zeroes the merge keys and the done counter, so
    its last block decodes the labels and sims as in a call."""
    _, run = admit_launcher(x, basis, cent, alpha, live, store_dtype="int8")
    pro, both = (cuda_ms(lambda p=p: run(p))[0] for p in (1, 3))
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2 * iters)]
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    for i in range(iters):
        run(1)
        ev[2 * i].record()
        run(2)
        ev[2 * i + 1].record()
    torch.cuda.synchronize()
    tiles = sum(ev[2 * i].elapsed_time(ev[2 * i + 1]) for i in range(iters)) / iters
    return (f"prologue {pro:.4f} ms, tile kernel {tiles:.4f} ms (after its prologue, "
            f"decode included), both {both:.4f} ms device")


def admit_bound(B, d, K, n, int8):
    flops = 2.0 * B * d * (K + n) + 2.0 * K * d + 4.0 * B * d
    nbytes = 4 * (B * d + n * d + K * d) + B + B * 13 + B * d * (1 if int8 else 4) + 4 * B
    return bound(flops, nbytes)


# -------------------------------------------------------------------- mips
def check_mips(q, index, valid, k, chk: Check):
    s_k, i_k = mips_topk_cuda(q, index, valid, k)
    s_p, i_p = mips_topk_ref(q, index, valid, k)
    torch.cuda.synchronize()
    chk.floats("scores", s_k, s_p)
    S = torch.where(valid[None], q @ index.T, NEG_INF)
    got = S.gather(1, i_k.long())
    chk.decisions("ids", i_k != i_p, (got - s_p).abs() < TIE)
    return s_k, i_k


def mips_bound(Q, N, d, k):
    return bound(2.0 * Q * N * d, 4 * (Q * d + N * d) + N + 8 * Q * k)


def mips_split(q, index, valid, k) -> str:
    """Device ms of the kernel's two launches apart (score-and-select, then
    merge) and together, on the path its plan picks at this shape."""
    plan, _, _, run = mips_launcher(q, index, valid, k)
    sel, mer, both = (cuda_ms(lambda p=p: run(p))[0] for p in (1, 2, 3))
    return (f"{plan.path} path: score-and-select {sel:.4f} ms, merge {mer:.4f} ms, "
            f"both {both:.4f} ms device")


def kernels_per_call(fn) -> str:
    """``kern.launched_kernels`` as a report ("not measured" where the profiler
    records no device activity)."""
    try:
        names = kern.launched_kernels(fn)
    except Exception as e:  # the profiler is a report here, not a check
        return f"not measured ({type(e).__name__}: {e})"
    if not names:
        return "not measured (the profiler recorded no device activity)"
    return f"{len(names)}: " + ", ".join(names)


# ------------------------------------------------------------------- serve
def plain_route_scores(qr, vectors, valid):
    return torch.where(valid[None], qr @ vectors.T, NEG_INF)


def ring_score(qn, embs, live, scales, cluster, slot):
    """Plain score of ring entries (cluster, slot) [Q, k] for each query."""
    e = embs[cluster.clamp(min=0).long(), slot.long()].float()      # [Q, k, d]
    s = torch.einsum("qd,qkd->qk", qn, e)
    if scales is not None:
        s = s * scales[cluster.clamp(min=0).long(), slot.long()]
    ok = live[cluster.clamp(min=0).long(), slot.long()] & (cluster >= 0)
    return torch.where(ok, s, NEG_INF)


def entry_scores(qn, embs, live, scales, routes, pos):
    """Plain score of each picked entry pos = j * depth + slot of the
    query's route list (NEG_INF where pos is -1)."""
    depth = embs.shape[1]
    cl = routes.gather(1, (pos.clamp(min=0) // depth).long())
    cl = torch.where(pos >= 0, cl, -1)
    return ring_score(qn, embs, live, scales, cl, pos.clamp(min=0) % depth)


def serve_split(qr, qn, vectors, valid, labels, embs, live, scales, k, nprobe) -> str:
    """Device ms of the kernel's two launches apart (route tiles, then the
    routed rerank) and together, with the plan that sized them."""
    plan, _, _, _, run = serve_launcher(qr, qn, vectors, valid, labels, embs, live, k,
                                        nprobe, scales)
    t1, t2, both = (cuda_ms(lambda p=p: run(p))[0] for p in (1, 2, 3))
    return (f"route tiles of {8 * plan.rm} queries x 64 ({plan.ntiles} column tiles, "
            f"{plan.m} route keys a query) {t1:.4f} ms, rerank in clusters of "
            f"{plan.cluster} {t2:.4f} ms, both {both:.4f} ms device")


def check_serve(qr, qn, vectors, valid, labels, embs, live, scales, k, nprobe,
                chk: Check):
    out_k = serve_topk_cuda(qr, qn, vectors, valid, labels, embs, live, k,
                            nprobe, scales)
    out_p = serve_topk_ref(qr, qn, vectors, valid, labels, embs, live, k,
                           nprobe, scales)
    torch.cuda.synchronize()
    hold_answers(qr, qn, vectors, valid, embs, live, scales, out_k, out_p, chk)
    return out_k


def hold_routes(qr, vectors, valid, r_k, r_p, chk: Check) -> torch.Tensor:
    """Routes ``r_k`` against ``r_p`` on the same index: a query's routes
    may differ only after a near-tie among the plain route scores up to
    the first probe where they do. Returns the queries whose routes
    differ."""
    nprobe = r_k.shape[1]
    rs = torch.sort(plain_route_scores(qr, vectors, valid), dim=1,
                    descending=True).values[:, :nprobe + 1]
    gaps = (rs[:, :-1] - rs[:, 1:]) < TIE
    first = torch.argmax((r_k != r_p).int(), dim=1)
    tie_q = torch.cumsum(gaps.int(), dim=1).gather(1, first[:, None])[:, 0] > 0
    route_diff = (r_k != r_p).any(dim=1)
    chk.decisions("routes", route_diff, tie_q)
    return route_diff


def hold_answers(qr, qn, vectors, valid, embs, live, scales, got, want, chk: Check):
    """Two-stage answers ``got`` = (scores, pos, routes) against ``want``
    on the same index and rings, under the near-tie rule."""
    (s_k, p_k, r_k), (s_p, p_p, r_p) = got, want
    same = ~hold_routes(qr, vectors, valid, r_k, r_p, chk)
    # positions: where routes agree, the pick must score (under the plain
    # scoring of that ring entry) within TIE of the reference's pick
    entry = entry_scores(qn, embs, live, scales, r_k, p_k)
    chk.floats("scores", s_k[same], s_p[same])
    chk.floats("scores vs entries", s_k[same], entry[same])
    chk.decisions("pos", (p_k != p_p) & same[:, None], (entry - s_p).abs() < TIE)


def serve_bound(Q, d, cap, routes, depth, nprobe, k, itemsize, int8):
    """Bytes: queries, the index, and each distinct routed ring once."""
    distinct = int(torch.unique(routes[routes >= 0]).numel())
    ring = depth * (d * itemsize + 1 + (4 if int8 else 0))
    nbytes = 2 * Q * d * 4 + cap * (d * 4 + 5) + distinct * ring + Q * (k * 8 + nprobe * 4)
    flops = 2.0 * Q * (cap + nprobe * depth) * d
    return bound(flops, nbytes)


def check_serve_routes(qr, vectors, valid, labels, fused_routes, nprobe, chk: Check):
    """The route-only entry against the fused kernel's routes on the same
    index (bit for bit: one computation) and its plain version (the
    near-tie rule)."""
    r_k = serve_routes_cuda(qr, vectors, valid, labels, nprobe)
    r_p = serve_routes_ref(qr, vectors, valid, labels, nprobe)
    torch.cuda.synchronize()
    if not torch.equal(r_k, fused_routes):
        chk.fail.append(f"{int((r_k != fused_routes).any(dim=1).sum())} queries routed "
                        "otherwise than the fused kernel routes them")
    hold_routes(qr, vectors, valid, r_k, r_p, chk)
    return r_k


def route_bound(Q, d, cap, nprobe):
    """Bytes: the queries, the index (rows, valid, labels) and the routes."""
    return bound(2.0 * Q * cap * d, 4 * Q * d + cap * (4 * d + 5) + 4 * Q * nprobe)


def synthetic_store(C, depth, d, int8, gen, fill=0.6):
    dev = "cuda"
    rows = l2_normalize(torch.randn((C * depth, d), generator=gen, device=dev))
    if int8:
        q, s = quant.quantize_int8(rows, dim=-1)
        embs, scales = q.view(C, depth, d), s.view(C, depth)
    else:
        embs, scales = rows.view(C, depth, d), None
    live = torch.rand((C, depth), generator=gen, device=dev) < fill
    live[torch.rand((C,), generator=gen, device=dev) < 0.05] = False  # empty rings
    return embs, live, scales


# ------------------------------------------------------------------ rerank
def check_rerank(q, embs, live, routes, k, scales, chk: Check):
    s_k, p_k = rerank_topk_cuda(q, embs, live, routes, k, scales)
    s_p, p_p = rerank_topk_ref(q, embs, live, routes, k, scales)
    torch.cuda.synchronize()
    got = entry_scores(q, embs, live, scales, routes, p_k)
    chk.floats("scores", s_k, s_p)
    chk.floats("scores vs entries", s_k, got)
    chk.decisions("pos", p_k != p_p, (got - s_p).abs() < TIE)
    return s_k, p_k


def rerank_bound(Q, d, routes, depth, k, itemsize, int8):
    """Bytes: queries, routes, each distinct routed ring once, outputs."""
    distinct = int(torch.unique(routes[routes >= 0]).numel())
    ring = depth * (d * itemsize + 1 + (4 if int8 else 0))
    nbytes = Q * d * 4 + routes.numel() * 4 + distinct * ring + Q * k * 8
    return bound(2.0 * Q * routes.shape[1] * depth * d, nbytes)


# --------------------------------------------------------------- prefilter
def check_prefilter(x, basis, alpha, chk: Check):
    r_k = prefilter_scores_cuda(x, basis)
    r_p = prefilter_scores_ref(x, basis)
    torch.cuda.synchronize()
    chk.floats("r", r_k, r_p)
    chk.decisions("keep", (r_k >= alpha) != (r_p >= alpha),
                  (r_p - alpha).abs() < TIE)


def prefilter_bound(B, n, d):
    return bound(2.0 * B * n * d + 3.0 * B * d, 4 * (B * d + n * d + B))


# ------------------------------------------------------------------ assign
def label_ties(x, cent, lab_k, lab_p):
    """Where two label vectors differ, whether the plain cosines of the
    two picks lie within TIE of each other."""
    sims = l2_normalize(x) @ l2_normalize(cent).T
    pick_k = sims.gather(1, lab_k.long()[:, None])[:, 0]
    pick_p = sims.gather(1, lab_p.long()[:, None])[:, 0]
    return (pick_k - pick_p).abs() < TIE


def check_assign(x, cent, chk: Check):
    i_k, s_k = assign_cuda(x, cent)
    i_p, s_p = assign_ref(x, cent)
    torch.cuda.synchronize()
    chk.floats("sims", s_k, s_p)
    chk.decisions("labels", i_k != i_p, label_ties(x, cent, i_k, i_p))


def assign_bound(B, K, d):
    return bound(2.0 * B * K * d + 3.0 * (B + K) * d, 4 * (B * d + K * d) + 8 * B)


def check_stage_kernels(results, x, st, alpha, q, vectors, valid, labels, gen):
    """The staged path's kernels against their plain versions at the main
    path's shapes, plus edge cases; device, host, plain and library times."""
    K, d = st.clus.centroids.shape
    # ---- rerank: routes from the index (10% dead labels), 8 queries with
    # a duplicate route, one query routed nowhere
    _, slots = mips_topk_ref(q, vectors, valid, NPROBE)
    routes = labels[slots.long()]
    routes[:8, 1] = routes[:8, 0]
    routes[9] = -1
    chk = Check("rerank")
    embs, live_r, scales = synthetic_store(K, 64, d, True, gen)
    check_rerank(q, embs, live_r, routes, TOPK, scales, chk)
    check_rerank(q, embs[:, :32], live_r[:, :32], routes, TOPK, scales[:, :32], chk)
    ms, host = cuda_ms(lambda: rerank_topk_cuda(q, embs, live_r, routes, TOPK, scales))
    plain, _ = cuda_ms(lambda: rerank_topk_ref(q, embs, live_r, routes, TOPK, scales),
                       iters=5)
    b_ms, b_by = rerank_bound(QUERIES, d, routes, 64, TOPK, 1, True)
    del embs, live_r, scales
    e32, l32, _ = synthetic_store(K, 16, d, False, gen)
    _, p32 = check_rerank(q, e32, l32, routes, 100, None, chk)
    short = int((p32 < 0).any(dim=1).sum())
    assert short > 0, "k = 100 must exceed some query's live candidates"
    del e32, l32
    chk.done(f"int8 d64 + view d32 + fp32 d16 k100 ({short} q k>live)")
    results["rerank"] = dict(max_abs_err=chk.err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                             bound_by=b_by, library_ms=None, host_ms=host)

    # ---- prefilter: admit's ragged batch, a zero basis row, B off the block
    basis = st.pre.basis
    bz = basis.clone()
    bz[2] = 0.0
    chk = Check("prefilter")
    check_prefilter(x, basis, alpha, chk)
    check_prefilter(x, bz, alpha, chk)
    check_prefilter(x[:250], basis, alpha, chk)
    chk.done("zero basis row, B=250, 37 dead rows")
    ms, host = cuda_ms(lambda: prefilter_scores_cuda(x, basis))
    plain, _ = cuda_ms(lambda: prefilter_scores_ref(x, basis))
    F = torch.nn.functional
    lib, _ = cuda_ms(lambda: torch.mean(torch.mm(F.normalize(x), F.normalize(basis).T), 1))
    b_ms, b_by = prefilter_bound(BATCH, basis.shape[0], d)
    results["prefilter"] = dict(max_abs_err=chk.err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                                bound_by=b_by, library_ms=lib, host_ms=host)
    print("  prefilter library_ms is four calls: "
          "torch.mean(torch.mm(F.normalize(x), F.normalize(basis).T), 1)")
    print(f"  prefilter: kernels per call {kernels_per_call(lambda: prefilter_scores_cuda(x, basis))}")

    # ---- assign: the batch against all K centroids, and one row alone
    cent = st.clus.centroids
    chk = Check("assign")
    check_assign(x, cent, chk)
    check_assign(x[:1], cent, chk)
    chk.done(f"K={K}, B=256 and B=1")
    ms, host = cuda_ms(lambda: assign_cuda(x, cent))
    plain, _ = cuda_ms(lambda: assign_ref(x, cent))
    xn, cn = l2_normalize(x), l2_normalize(cent)
    lib, _ = cuda_ms(lambda: torch.max(torch.mm(xn, cn.T), 1))
    b_ms, b_by = assign_bound(BATCH, K, d)
    results["assign"] = dict(max_abs_err=chk.err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                             bound_by=b_by, library_ms=lib, host_ms=host)
    print("  assign library_ms is two calls on unit rows: torch.max(torch.mm(xn, cn.T), 1)")
    print(f"  assign: kernels per call {kernels_per_call(lambda: assign_cuda(x, cent))}")
    print("  admit: kernels per call "
          + kernels_per_call(lambda: admit_cuda(x, st.pre.basis, cent, alpha, None,
                                                store_dtype="int8")))
    print("  rerank: no single PyTorch call computes the same function (library_ms null)")


# ------------------------------------------------------------------ recsys
def zipf_ids(rng, n: int, size) -> np.ndarray:
    """Item ids drawn from a Zipf-like popularity, p ~ 1/r^1.2 (id = rank - 1)."""
    p = 1.0 / np.arange(1, n + 1) ** 1.2
    return rng.choice(n, size=size, p=p / p.sum()).astype(np.int32)


def recsys_batch(arch, shape: str, rng) -> dict:
    """A seeded batch for one step: the spec's entries (``dummy_batch``),
    with every id drawn from the Zipf popularity and, for histories, a
    valid prefix of length uniform in [1, S] (padding at id 0)."""
    spec = arch.step(shape).input_specs
    batch = dummy_batch(spec, seed=SEED)
    if "fields" in batch:
        B, nf = spec["fields"].shape
        batch["fields"] = torch.from_numpy(
            zipf_ids(rng, arch.cfg.rows_per_field, (B, nf))).cuda()
        return batch
    B, S = spec["hist"].shape
    n = arch.cfg.n_items
    mask = np.arange(S)[None, :] < rng.integers(1, S + 1, (B, 1))
    batch["hist"] = torch.from_numpy(np.where(mask, zipf_ids(rng, n, (B, S)), 0)
                                     .astype(np.int32)).cuda()
    batch["hist_mask"] = torch.from_numpy(mask).cuda()
    batch["target"] = torch.from_numpy(zipf_ids(rng, n, (B,))).cuda()
    return batch


def mind_bag_inputs(batch):
    """The (indices, segments, weights, bags) MIND's user_vectors hands the bag."""
    hist, mask = batch["hist"], batch["hist_mask"]
    B, S = hist.shape
    seg = torch.arange(B, dtype=torch.int32, device="cuda")[:, None].expand(B, S).reshape(-1)
    return torch.where(mask, hist, 0).reshape(-1), seg, mask.float().reshape(-1), B


@contextlib.contextmanager
def plain_recsys():
    """The recsys path with its bag and mips dispatch swapped for their
    plain versions, on the same card. Yields the list of (queries, index)
    that the plain mips was called on."""
    seen = []

    def plain_mips(q, index, valid, k):
        seen.append((q, index))
        return mips_topk_ref(q, index, valid, k)

    saved = recsys.embedding_bag_sorted, recsys.mips_topk
    recsys.embedding_bag_sorted, recsys.mips_topk = embedding_bag_sorted_ref, plain_mips
    try:
        yield seen
    finally:
        recsys.embedding_bag_sorted, recsys.mips_topk = saved


def check_bag(table, idx, seg, bags, w, mode, chk: Check, plain_on_cpu=False):
    """Returns the number of empty bags (which must come out zero). The
    plain version sums with ``index_add_``, whose order on the card changes
    from run to run; ``plain_on_cpu`` runs it on CPU copies, in the order
    the kernel sums in, for rows whose size makes that order show. Where
    the segments are sorted, the sorted entry (one launch, no sort) must
    equal the sorting wrapper bit for bit."""
    out_k = embedding_bag_cuda(table, idx, seg, bags, w, mode)
    if seg.numel() < 2 or bool((seg[1:] >= seg[:-1]).all()):
        out_s = embedding_bag_sorted_cuda(table, idx, seg, bags, w, mode)
        if not torch.equal(out_s, out_k):
            chk.fail.append(f"sorted entry != sorting wrapper ({mode} d{table.shape[1]})")
    if plain_on_cpu:
        out_p = embedding_bag_ref(table.cpu(), idx.cpu(), seg.cpu(), bags,
                                  None if w is None else w.cpu(), mode).cuda()
    else:
        out_p = embedding_bag_ref(table, idx, seg, bags, w, mode)
    torch.cuda.synchronize()
    chk.floats(f"{mode} d{table.shape[1]} {table.dtype}", out_k, out_p)
    empty = torch.bincount(seg.long(), minlength=bags) == 0
    if not bool((out_k[empty] == 0).all()):
        chk.fail.append("an empty bag is not zero")
    return int(empty.sum())


def bag_bound(table, idx, bags):
    """Bytes: each distinct row once, 12 bytes per entry, the bags out."""
    d, L = table.shape[1], idx.numel()
    distinct = int(torch.unique(idx).numel())
    nbytes = distinct * d * table.element_size() + L * 12 + bags * d * 4
    return bound(2.0 * L * d, nbytes) + (distinct,)


def time_bag(label, table, idx, seg, bags, w, mode):
    """Device ms of MIND's path (the sorted entry: one launch on MIND's own
    tensors) and of the sorting wrapper, host ms, plain ms, library ms
    (F.embedding_bag + divide) and the bound."""
    ms, host = cuda_ms(lambda: embedding_bag_sorted_cuda(table, idx, seg, bags, w, mode))
    wrap, wrap_host = cuda_ms(lambda: embedding_bag_cuda(table, idx, seg, bags, w, mode))
    sort_ms, _ = cuda_ms(lambda: torch.argsort(seg, stable=True))
    order = torch.argsort(seg, stable=True)
    idx_s, seg_s, w_s = idx[order].int(), seg[order].int(), w[order].float()
    plain, _ = device_ms(lambda: embedding_bag_ref(table, idx, seg, bags, w, mode), iters=5)
    offsets = torch.searchsorted(seg_s, torch.arange(bags, device="cuda", dtype=torch.int32),
                                 out_int32=True)
    cnt = torch.diff(offsets, append=torch.tensor([idx.numel()], device="cuda",
                                                  dtype=torch.int32))
    denom = torch.clamp(cnt.float(), min=1.0)[:, None]
    F = torch.nn.functional

    def library():
        return F.embedding_bag(idx_s, table, offsets, mode="sum",
                               per_sample_weights=w_s) / denom

    lib_err = max_err(library(), embedding_bag_ref(table, idx, seg, bags, w, mode))
    lib, _ = cuda_ms(library)
    b_ms, b_by, distinct = bag_bound(table, idx, bags)
    print(f"  bag {label}: L={idx.numel()} bags={bags} distinct rows {distinct}; "
          f"MIND's path (sorted entry, one launch) {ms:.4f} ms device ({host:.4f} ms a "
          f"call from the host), sorting wrapper {wrap:.4f} ms device ({wrap_host:.4f} ms "
          f"host; its stable argsort alone {sort_ms:.4f} ms), "
          f"plain {plain:.4f} ms, library {lib:.4f} ms (two calls: F.embedding_bag "
          f"+ divide; max|d| vs plain {lib_err:.3g}), bound {b_ms:.4f} ms ({b_by})")
    return dict(ms=ms, host_ms=host, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                bound_by=b_by)


def phase_recsys_kernels(results):
    """bag and mips against their plain versions at MIND's shapes. Returns
    (arch, params, batches) for the recsys path."""
    arch = get_arch("mind")
    t0 = time.perf_counter()
    params = arch.init(SEED)
    rng = np.random.default_rng(SEED)
    batches = {shape: recsys_batch(arch, shape, rng) for shape in RECSYS_STEPS}
    torch.cuda.synchronize()
    table = params["item_emb"]
    print(f"recsys kernels at MIND's width: item table {tuple(table.shape)}; params and "
          f"Zipf batches in {time.perf_counter() - t0:.2f} s")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 2)
    chk = Check("bag")
    for shape in ("serve_p99", "serve_bulk"):
        idx, seg, w, B = mind_bag_inputs(batches[shape])
        check_bag(table, idx, seg, B, w, "mean", chk)
    idx, seg, w, B = mind_bag_inputs(batches["serve_p99"])
    check_bag(table.to(torch.bfloat16), idx, seg, B, w, "mean", chk)
    check_bag(table, idx.long(), seg.long(), B, w, "mean", chk)   # int64 ids as they are
    # N(0, 1) rows: held against the plain version on the CPU (check_bag)
    t18 = torch.randn((1000, 18), generator=gen, device="cuda")
    for mode in ("sum", "mean"):
        i40 = torch.randint(0, 1000, (40,), generator=gen, device="cuda", dtype=torch.int32)
        s40 = torch.randint(0, 5, (40,), generator=gen, device="cuda", dtype=torch.int32)
        empty = check_bag(t18, i40, s40, 8, None, mode, chk,   # unsorted, bags 5..7 empty
                          plain_on_cpu=True)
        check_bag(table, idx, seg, B, None, mode, chk)
        check_bag(t18, i40[:1], torch.ones((1,), dtype=torch.int32, device="cuda"), 3,
                  None, mode, chk, plain_on_cpu=True)         # a bag of one entry
    chk.done(f"p99+bulk+bf16+i64+d18+w=None, {empty} empty")
    times = {}
    for shape in ("serve_p99", "serve_bulk"):
        idx, seg, w, B = mind_bag_inputs(batches[shape])
        times[shape] = time_bag(shape, table, idx, seg, B, w, "mean")
    results["bag"] = dict(max_abs_err=chk.err, **times["serve_p99"])

    # mips at the retrieval shape: MIND's 4 interest vectors, k = 100
    with plain_recsys():
        u = arch.user_vectors(params, batches["retrieval_cand"])[0].contiguous()
    valid = torch.ones((table.shape[0],), dtype=torch.bool, device="cuda")
    chk = Check("mips")
    check_mips(u, table, valid, 100, chk)
    chk.done("MIND retrieval, k=100")
    ms, host = cuda_ms(lambda: mips_topk_cuda(u, table, valid, 100))
    plain, plain_how = device_ms(lambda: mips_topk_ref(u, table, valid, 100))
    lib, lib_how = device_ms(lambda: torch.topk(torch.mm(u, table.T), 100))
    b_ms, b_by = mips_bound(u.shape[0], table.shape[0], table.shape[1], 100)
    print(f"  mips at MIND's retrieval shape ({u.shape[0]} x {u.shape[1]} vs "
          f"{table.shape[0]} x {table.shape[1]}, k=100): {ms:.4f} ms device ({host:.4f} ms "
          f"a call from the host), plain {plain:.4f} ms ({plain_how}), library "
          f"{lib:.4f} ms (torch.topk(torch.mm(q, X.T), 100), two calls; {lib_how}), "
          f"bound {b_ms:.4f} ms ({b_by}); {mips_split(u, table, valid, 100)}")
    # DIEN's and FM's retrieve shapes: one query against 10^6 rows of d = 18
    # and d = 11 (rows not 16-byte aligned), N(0, 0.02) rows
    chk = Check("mips")
    for d in (18, 11):
        t = torch.randn((table.shape[0], d), generator=gen, device="cuda") * 0.02
        u1 = torch.randn((1, d), generator=gen, device="cuda")
        check_mips(u1, t, valid, 100, chk)
        ms, _ = cuda_ms(lambda: mips_topk_cuda(u1, t, valid, 100))
        plain, plain_how = device_ms(lambda: mips_topk_ref(u1, t, valid, 100))
        lib, _ = device_ms(lambda: torch.topk(torch.mm(u1, t.T), 100))
        b_ms, b_by = mips_bound(1, t.shape[0], d, 100)
        print(f"  mips at 1 x {d} vs {t.shape[0]} x {d}, k=100: {ms:.4f} ms device, plain "
              f"{plain:.4f} ms ({plain_how}), library {lib:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by}); {mips_split(u1, t, valid, 100)}")
        del t
    chk.done("Q=1, d=18 and d=11, k=100")
    return arch, params, batches


def hold_retrieve(u, table, got, want, chk: Check):
    """Retrieved (scores, ids) against the plain composition: scores within
    tolerance; every score is its id's score under one interest; ids equal
    except at near-ties of the plain list (neighbours within TIE)."""
    (s_k, i_k), (s_p, i_p) = got, want
    chk.floats("retrieve scores", s_k, s_p)
    per_interest = torch.einsum("bid,bkd->bik", u, table[i_k.long()])
    own = (per_interest - s_k[:, None]).abs().min(dim=1).values
    if not bool((own < TIE).all()):
        chk.fail.append("a retrieved score is no interest's score of its id")
    gap = (s_p[:, :-1] - s_p[:, 1:]).abs() < TIE
    near = torch.zeros_like(i_p, dtype=torch.bool)
    near[:, 1:] |= gap
    near[:, :-1] |= gap
    chk.decisions("retrieve ids", i_k != i_p, near)


def run_steps(arch, params, batches, shapes):
    """Each step once; per step (output, host ms, peak MB)."""
    out = {}
    for shape in shapes:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        res = arch.step(shape).fn(params, batches[shape])
        torch.cuda.synchronize()
        out[shape] = (res, (time.perf_counter() - t) * 1e3,
                      torch.cuda.max_memory_allocated() / 1e6)
    return out


def expect_shapes(arch, shape, res):
    """The reference's output shapes: [B] scores, or ([B, 100], [B, 100])."""
    B = arch.shapes[shape].dim("batch")
    if arch.shapes[shape].kind == "retrieval":
        s, i = res
        assert s.shape == i.shape == (B, 100) and i.dtype == torch.int32, (s.shape, i.shape)
    else:
        assert res.shape == (B,) and res.dtype == torch.float32, res.shape
    assert_finite(res, f"{arch.name}/{shape}")


def phase_recsys(arch, params, batches, results):
    """MIND's three serve steps at full width through the bag and mips
    kernels, held against the plain composition; then DIEN, BERT4Rec, FM."""
    counts.reset_all()
    ran = run_steps(arch, params, batches, RECSYS_STEPS)
    launches = counts.snapshot()
    print(f"recsys path: MIND {arch.cfg}; launches {launches}")
    assert launches["bag"]["kernel"] == len(RECSYS_STEPS), launches   # one per user_vectors
    assert launches["mips"]["kernel"] == 1, launches                  # one per retrieve
    assert all(c["plain"] == 0 for c in launches.values()), "a plain version ran"
    results["bag"]["launches"] = launches["bag"]["kernel"]
    # MIND's user_vectors: exactly one bag launch and no sort, by the
    # launch counter and by the kernels torch.profiler lists for one call
    b = batches["serve_p99"]
    counts.reset_all()
    arch.user_vectors(params, b)
    uv_launches = counts.snapshot()["bag"]
    assert uv_launches == {"kernel": 1, "plain": 0}, uv_launches
    names = kern.launched_kernels(lambda: arch.user_vectors(params, b))
    bag_k = [n for n in names if n in ("bag_few_kernel", "bag_many_kernel")]
    sorts = [n for n in names if "sort" in n.lower()]
    assert len(bag_k) == 1 and not sorts, names
    print(f"  mind user_vectors: 1 bag launch, no sort ({len(names)} kernels a call: "
          f"{', '.join(names)})")
    table = params["item_emb"]
    chk = Check("mind")
    for shape in RECSYS_STEPS:
        res, first_ms, peak = ran[shape]
        expect_shapes(arch, shape, res)
        b = batches[shape]
        uv = arch.user_vectors(params, b)
        with plain_recsys():
            uv_p = arch.user_vectors(params, b)
            res_p = arch.step(shape).fn(params, b)
        chk.floats(f"user_vectors {shape}", uv, uv_p)
        if shape == "retrieval_cand":
            hold_retrieve(uv_p, table, res, res_p, chk)
        else:
            chk.floats(f"score {shape}", res, res_p)
        fn = arch.step(shape).fn
        dev, host = cuda_ms(lambda: fn(params, b), iters=3 if shape == "serve_bulk" else 10)
        print(f"  mind {shape:14s} B={b['hist'].shape[0]:6d}: {dev:.4f} ms device, "
              f"{host:.4f} ms host (first call {first_ms:.2f} ms), peak memory "
              f"{peak:.1f} MB")
    chk.done("vs plain bag/mips on the card")

    for name in ("dien", "bert4rec", "fm"):
        del params, batches
        torch.cuda.empty_cache()
        arch = get_arch(name)
        params = arch.init(SEED)
        rng = np.random.default_rng(SEED)
        shapes = [s for s in ("serve_p99", "retrieval_cand", "serve_bulk")
                  if not (name == "bert4rec" and s == "serve_bulk")]
        batches = {s: recsys_batch(arch, s, rng) for s in shapes}
        counts.reset_all()
        ran = run_steps(arch, params, batches, shapes)
        launches = counts.snapshot()
        assert launches["mips"]["kernel"] == 1 and launches["bag"]["kernel"] == 0, launches
        assert all(c["plain"] == 0 for c in launches.values()), "a plain version ran"
        # retrieve against plain mips on the queries and index it was given
        # (FM's concatenated [rows, k + 1] table included)
        with plain_recsys() as seen:
            want = arch.step("retrieval_cand").fn(params, batches["retrieval_cand"])
        (q, index), = seen
        chk = Check(name)
        hold_retrieve(q.reshape(want[0].shape[0], -1, q.shape[1]), index,
                      ran["retrieval_cand"][0], want, chk)
        chk.done(f"retrieve q {tuple(q.shape)} vs {tuple(index.shape)}")
        del seen, q, index, want
        for shape in shapes:
            res, first_ms, peak = ran[shape]
            expect_shapes(arch, shape, res)
            fn = arch.step(shape).fn
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn(params, batches[shape])
            torch.cuda.synchronize()
            print(f"  {name:8s} {shape:14s} {(time.perf_counter() - t) * 1e3:.2f} ms host "
                  f"(warm; first {first_ms:.2f} ms), peak memory {peak:.1f} MB, finite")
        if name == "bert4rec":
            print(f"  {BERT4REC_BULK_SKIP}")


# -------------------------------------------------------------------- main
def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def phase_setup():
    print(nvidia_smi())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    require_full_fp32()
    t0 = time.perf_counter()
    built = build.build_all()
    print(f"built {sorted(built)} in {time.perf_counter() - t0:.2f} s "
          f"(per source: " + ", ".join(f"{n} {b.seconds:.2f} s" for n, b in sorted(built.items())) + ")")
    for name, b in sorted(built.items()):
        for line in b.log.splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling entry")):
                print(f"  ptxas[{name}] {line.strip()}")


def warmup_rows(stream, k):
    n = -(-2 * k // BATCH)
    return np.concatenate([stream.next_batch(BATCH)["embedding"] for _ in range(n)])


def phase_kernels(results: dict):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    cfg = full_config("int8", 64)
    K, d = cfg.clus.num_clusters, cfg.clus.dim
    stream = make_stream("nyt", dim=d)
    warm = warmup_rows(stream, K)
    st = pipeline.init(cfg, SEED, warm, device="cuda")
    basis, cent = st.pre.basis, st.clus.centroids
    alpha = cfg.pre.alpha
    print(f"kernel checks at K={K} d={d} B={BATCH} Q={QUERIES} k={TOPK} nprobe={NPROBE}")
    print(f"  launch floor: {launch_floor_ms():.4f} ms device (one empty kernel, "
          "csrc/launch_floor.cu, timed as the kernels are)")

    # ---- admit: a ragged batch (the tail rows dead and zero), fp32 + int8
    x = torch.from_numpy(stream.next_batch(BATCH)["embedding"]).cuda()
    live = torch.ones((BATCH,), dtype=torch.bool, device="cuda")
    live[-37:] = False
    x[-37:] = 0.0
    chk = Check("admit")
    for dt in ("fp32", "int8"):
        check_admit(x, basis, cent, alpha, live, dt, chk)
        check_admit(x, basis, cent, alpha, None, dt, chk)
    chk.done("fp32+int8, 37 dead rows, live=None")
    ms, host = cuda_ms(lambda: admit_cuda(x, basis, cent, alpha, live, store_dtype="int8"))
    ms_none, _ = cuda_ms(lambda: admit_cuda(x, basis, cent, alpha, None, store_dtype="int8"))
    print(f"  admit with live=None: {ms_none:.4f} ms device")
    print(f"  admit launches apart at B={BATCH} vs {K} x {d}: "
          f"{admit_split(x, basis, cent, alpha, live)}")
    plain, _ = cuda_ms(lambda: admit_ref(x, basis, cent, alpha, live, store_dtype="int8"))
    b_ms, b_by = admit_bound(BATCH, d, K, basis.shape[0], True)
    results["admit"] = dict(max_abs_err=chk.err, ms=ms, plain_ms=plain,
                            bound_ms=b_ms, bound_by=b_by, library_ms=None, host_ms=host)

    # ---- mips: the prototype index with invalid rows
    q = l2_normalize(torch.from_numpy(stream.queries(QUERIES)["embedding"]).cuda())
    vectors = l2_normalize(cent)
    valid = torch.rand((K,), generator=gen, device="cuda") < 0.9
    chk = Check("mips")
    check_mips(q, vectors, valid, TOPK, chk)
    check_mips(q, vectors, valid, NPROBE, chk)
    chk.done("10% invalid rows")
    bias = torch.where(valid, 0.0, NEG_INF)[None].expand(QUERIES, K)
    ms, host = cuda_ms(lambda: mips_topk_cuda(q, vectors, valid, TOPK))
    plain, _ = cuda_ms(lambda: mips_topk_ref(q, vectors, valid, TOPK))
    lib, _ = cuda_ms(lambda: torch.topk(torch.addmm(bias, q, vectors.T), TOPK))
    b_ms, b_by = mips_bound(QUERIES, K, d, TOPK)
    results["mips"] = dict(max_abs_err=chk.err, ms=ms, plain_ms=plain,
                           bound_ms=b_ms, bound_by=b_by, library_ms=lib, host_ms=host)
    print("  mips library_ms is two calls: torch.topk(torch.addmm(bias, q, X.T), k)")
    print(f"  mips launches apart at Q={QUERIES} vs {K} x {d}, k={TOPK}: "
          f"{mips_split(q, vectors, valid, TOPK)}")

    # ---- serve: int8 depth 64, fp32 depth 16, a depth-32 strided view;
    # 10% of route labels dead so some queries meet dead routes
    labels = torch.randperm(K, generator=gen, device="cuda").to(torch.int32)
    labels[torch.rand((K,), generator=gen, device="cuda") < 0.1] = -1
    chk = Check("serve")
    embs, live_r, scales = synthetic_store(K, 64, d, True, gen)
    out = check_serve(q, q, vectors, valid, labels, embs, live_r, scales, TOPK,
                      NPROBE, chk)
    dead = int((out[2] < 0).any(dim=1).sum())
    check_serve(q, q, vectors, valid, labels, embs[:, :32], live_r[:, :32],
                scales[:, :32], TOPK, NPROBE, chk)
    chk_r = Check("serve_route")
    check_serve_routes(q, vectors, valid, labels, out[2], NPROBE, chk_r)
    chk_r.done("== fused routes, vs plain")
    ms_r, host_r = cuda_ms(lambda: serve_routes_cuda(q, vectors, valid, labels, NPROBE))
    plain_r, _ = cuda_ms(lambda: serve_routes_ref(q, vectors, valid, labels, NPROBE))
    b_ms, b_by = route_bound(QUERIES, d, K, NPROBE)
    results["serve_route"] = dict(max_abs_err=chk_r.err, ms=ms_r, plain_ms=plain_r,
                                  bound_ms=b_ms, bound_by=b_by, library_ms=None,
                                  host_ms=host_r)
    ms, host = cuda_ms(lambda: serve_topk_cuda(q, q, vectors, valid, labels, embs,
                                               live_r, TOPK, NPROBE, scales))
    plain, _ = cuda_ms(lambda: serve_topk_ref(q, q, vectors, valid, labels, embs,
                                              live_r, TOPK, NPROBE, scales), iters=5)
    b_ms, b_by = serve_bound(QUERIES, d, K, out[2], 64, NPROBE, TOPK, 1, True)
    print(f"  serve launches apart at Q={QUERIES} vs {K} x {d}, int8 depth 64: "
          f"{serve_split(q, q, vectors, valid, labels, embs, live_r, scales, TOPK, NPROBE)}")
    del embs, live_r, scales
    cfg32 = full_config("fp32", 16)
    K32 = cfg32.clus.num_clusters
    e32, l32, _ = synthetic_store(K32, 16, d, False, gen)
    lab32 = torch.randperm(K32, generator=gen, device="cuda")[:K].to(torch.int32)
    lab32[labels < 0] = -1
    check_serve(q, q, vectors, valid, lab32, e32, l32, None, TOPK, NPROBE, chk)
    del e32, l32
    chk.done(f"int8 d64 + view d32 + fp32 d16, {dead} q w/ dead routes")
    results["serve"] = dict(max_abs_err=chk.err, ms=ms, plain_ms=plain,
                            bound_ms=b_ms, bound_by=b_by, library_ms=None, host_ms=host)
    print("  admit, serve and serve_route: no single PyTorch call computes the same "
          "function (library_ms null)")
    check_stage_kernels(results, x, st, alpha, q, vectors, valid, labels, gen)
    return stream, warm


def answers_ok(answers, k):
    for a in answers:
        live = a["doc_ids"] >= 0
        assert a["scores"].shape == (k,) and a["doc_ids"].shape == (k,)
        assert np.all(np.isfinite(a["scores"][live])), a
    return True


def compare_with_plain(engine, q, two_stage):
    """The engine's answer against the plain versions composed the same way
    on the same card state: scores within tolerance, ids equal except at
    near-ties. Returns the number of near-tie id swaps."""
    cfg, st = engine.cfg, engine.state
    s_k, _, i_k, _ = engine.query(q, TOPK, two_stage=two_stage, nprobe=NPROBE)
    qn = l2_normalize(q)
    if two_stage:
        scales = st.store.scales if st.store.embs.dtype == torch.int8 else None
        s_p, pos, routes = serve_topk_ref(qn, qn, st.index.vectors, st.index.valid,
                                          st.route_labels, st.store.embs,
                                          st.store.ids >= 0, TOPK, NPROBE, scales)
        i_p = stages.decode_rerank(st.store.ids, routes, s_p, pos,
                                   cfg.store_depth, NPROBE)[2]
    else:
        s_p, rows = mips_topk_ref(qn, st.index.vectors, st.index.valid, TOPK)
        i_p = st.index.ids[rows.long()]
    assert bool(((s_k - s_p).abs() < TIE).all()), "scores disagree with plain"
    return int(((i_k != i_p) & (s_p > NEG_INF / 2)).sum())


@contextlib.contextmanager
def timed_heavy_hitter():
    """Times each ``heavy_hitter.update_batch`` call (the counter's share of
    ingest, host clock between two synchronizes) into the first yielded
    list, in ms, and records each call's (cfg, state, labels, draws) into
    the second. The draws are made here from the caller's generator, as
    ``update_batch`` would make them."""
    hh_ms, calls = [], []
    real_update = heavy_hitter.update_batch

    def timed_update(cfg, state, labels, gen=None, draws=None):
        if draws is None:
            draws = heavy_hitter.draw(cfg, labels.shape[0], gen, labels.device)
        calls.append((cfg, state, labels, draws))
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real_update(cfg, state, labels, draws=draws)
        torch.cuda.synchronize()
        hh_ms.append((time.perf_counter() - t) * 1e3)
        return out

    heavy_hitter.update_batch = timed_update
    try:
        yield hh_ms, calls
    finally:
        heavy_hitter.update_batch = real_update


def phase_main(stream, warm, results):
    """``stream`` continues the stream the warmup came from. Returns the
    ingested batches."""
    cfg = full_config("int8", 64)
    scfg = ServerConfig(max_batch=QUERIES, topk=TOPK, two_stage=True, nprobe=NPROBE)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    server = RAGServer(cfg, scfg, seed=SEED, warmup=warm, device="cuda")
    torch.cuda.synchronize()
    print(f"main path: k={cfg.clus.num_clusters} B={cfg.hh.bmax()} int8 depth "
          f"{cfg.store_depth}, state {pipeline.state_memory_bytes(cfg) / 1e6:.1f} MB, "
          f"init {time.perf_counter() - t0:.2f} s")

    batches = [stream.next_batch(BATCH) for _ in range(MAIN_BATCHES)]
    queries = stream.queries(QUERIES * 12)["embedding"]
    counts.reset_all()
    ingest_ms, submitted, answers = [], 0, []
    with timed_heavy_hitter() as (hh_ms, hh_calls):
        for i, b in enumerate(batches):
            torch.cuda.synchronize()
            t = time.perf_counter()
            server.ingest(b["embedding"], b["doc_id"])
            torch.cuda.synchronize()
            ingest_ms.append((time.perf_counter() - t) * 1e3)
            if i >= 4:
                for qv in queries[(i - 4) * QUERIES:(i - 3) * QUERIES]:
                    server.submit(qv)
                    submitted += 1
                answers += server.flush()
        answers += server.drain()
        proto = RAGServer(cfg, ServerConfig(max_batch=QUERIES, topk=TOPK),
                          engine=server.engine)
        for qv in queries[-2 * QUERIES:]:
            proto.submit(qv)
        proto_answers = proto.drain()
    torch.cuda.synchronize()
    launches = counts.snapshot()
    print(f"  launches on the main path: {launches}")
    for name in ("admit", "serve", "mips"):
        assert launches[name]["kernel"] > 0, f"{name} kernel never launched"
        results[name]["launches"] = launches[name]["kernel"]
    # one heavy-hitter launch per ingest batch (its plain version: none)
    assert launches["heavy_hitter"]["kernel"] == len(batches), launches["heavy_hitter"]
    results["heavy_hitter"] = dict(launches=launches["heavy_hitter"]["kernel"])
    assert all(c["plain"] == 0 for c in launches.values()), "a plain version ran"
    assert len(answers) == submitted, (len(answers), submitted)
    assert sorted(a["ticket"] for a in answers) == list(range(submitted))
    assert len(proto_answers) == 2 * QUERIES
    answers_ok(answers, TOPK)
    answers_ok(proto_answers, TOPK)

    eng = server.engine
    # device->host syncs the port makes in one more ingest batch, as torch
    # reports them, each at the innermost line of the port that made it
    # (switching the debug mode on reports one of its own, not counted)
    sync_sites = []

    def on_warning(message, *_a, **_k):
        port = [f for f in traceback.extract_stack()[:-1] if "repro_torch" in f.filename]
        if "synchroniz" in str(message) and port:
            sync_sites.append(f"{os.path.basename(port[-1].filename)}:{port[-1].lineno}")

    x, ids = stream.next_batch(BATCH)["embedding"], np.arange(10**6, 10**6 + BATCH,
                                                                 dtype=np.int32)
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = on_warning
        torch.cuda.set_sync_debug_mode("warn")
        try:
            eng.ingest(x, ids)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = len(sync_sites)
    ctr = eng.device_counters()
    lat = server.latency_stats()
    steady = ingest_ms[1:]
    print(f"  ingest ms/batch: median {np.median(steady):.2f} (first {ingest_ms[0]:.2f}; "
          f"with the per-arrival loop instead of the kernel: {LOOP_INGEST_MS} on an H100 80GB "
          f"HBM3 at 700 W); heavy-hitter update {np.median(hh_ms[1:]):.3f} ms = "
          f"{np.median(hh_ms[1:]) / np.median(steady) * 100:.1f}% of a batch (host clock "
          f"between synchronizes, one kernel launch)")
    print(f"  syncs per ingest batch: {syncs} seen by torch's sync debug mode, "
          f"{eng.host_syncs / (len(batches) + 1):.0f} counted by the engine; at {sync_sites}")
    print(f"  two-stage flush p50 {lat['p50_ms']:.3f} ms p99 {lat['p99_ms']:.3f} ms over "
          f"{lat['batches']} flushes; prototype-only p50 {proto.latency_stats()['p50_ms']:.3f} ms")
    print(f"  answered {len(answers)}/{submitted} two-stage + {len(proto_answers)}/"
          f"{2 * QUERIES} prototype-only; upserts {eng.state.upserts}; index size "
          f"{eng.index_size()}; store fill {ctr['store_fill']:.4f}; admit rate "
          f"{ctr['admit_rate']:.3f}; max memory {torch.cuda.max_memory_allocated() / 1e6:.1f} MB")
    q = torch.from_numpy(queries[:QUERIES]).cuda()
    for two in (True, False):
        n = compare_with_plain(eng, q, two)
        print(f"  {'two-stage' if two else 'prototype-only'} answers vs plain "
              f"versions on the card: agree, {n} near-tie id swaps")
    del server, proto, eng
    torch.cuda.empty_cache()

    cfg32 = full_config("fp32", 16)
    server32 = RAGServer(cfg32, scfg, seed=SEED, warmup=warm, device="cuda")
    for b in (stream.next_batch(BATCH) for _ in range(5)):
        server32.ingest(b["embedding"], b["doc_id"])
    for qv in queries[:QUERIES]:
        server32.submit(qv)
    got = server32.drain()
    assert len(got) == QUERIES and answers_ok(got, TOPK)
    n = compare_with_plain(server32.engine, q, True)
    print(f"  fp32 depth-16 config: k={cfg32.clus.num_clusters}, 5 batches, "
          f"{len(got)} answered, upserts {server32.engine.state.upserts}, vs plain: "
          f"{n} near-tie id swaps")
    return batches, hh_calls, lat


def written(store, before_ids):
    """(index tuple, ids, int8 rows, scales) of the ring slots a batch wrote."""
    w = torch.nonzero(store.ids != before_ids, as_tuple=True)
    return w, store.ids[w], store.embs[w], store.scales[w]


def phase_staged(stream, warm, batches, results):
    """The staged decomposition on the main path's config, seed, warmup
    and batches, held against the fused composition on the same batches."""
    cfg = full_config("int8", 64)
    alpha, depth = cfg.pre.alpha, cfg.store_depth
    n_batches = len(batches)
    queries = torch.from_numpy(stream.queries(QUERIES * STAGED_FLUSHES)["embedding"]).cuda()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 1)
    draws = [heavy_hitter.draw(cfg.hh, BATCH, gen, "cuda") for _ in batches]

    # the fused composition first, recorded per batch, outside the counts
    fused = pipeline.init(cfg, SEED, warm, device="cuda")
    ref = []
    for b, dr in zip(batches, draws):
        before = fused.store.ids.clone()
        fused, info = ingest_impl(cfg, fused, b["embedding"], b["doc_id"], dr)
        ref.append((info["keep"], info["labels"], written(fused.store, before),
                    info["stored"]))
    del fused

    # the staged composition, counted
    staged = pipeline.init(cfg, SEED, warm, device="cuda")
    torch.cuda.synchronize()
    seen, stored, ingest_ms, flush_ms, answers = [], [], [], [], []
    counts.reset_all()
    with timed_heavy_hitter() as (hh_ms, _):
        for b, dr in zip(batches, draws):
            before, cent = staged.store.ids.clone(), staged.clus.centroids
            torch.cuda.synchronize()
            t = time.perf_counter()
            staged, info = staged_ingest_impl(cfg, staged, b["embedding"],
                                              b["doc_id"], dr)
            torch.cuda.synchronize()
            ingest_ms.append((time.perf_counter() - t) * 1e3)
            seen.append((info["keep"], info["labels"], written(staged.store, before),
                         cent, staged.pre.basis))
            stored.append(info["stored"])
    snap = Engine(cfg, state=staged).publish()
    for f in range(STAGED_FLUSHES):
        q = queries[f * QUERIES:(f + 1) * QUERIES]
        torch.cuda.synchronize()
        t = time.perf_counter()
        routes = stages.route(cfg.index, snap.index, snap.route_labels, q, NPROBE)
        scores, pos = stages.rerank(snap.store, l2_normalize(q), routes, TOPK)
        out = stages.decode_rerank(snap.store.ids, routes, scores, pos, depth, NPROBE)
        host = [o.cpu().numpy() for o in out]
        flush_ms.append((time.perf_counter() - t) * 1e3)
        answers.append((q, routes, scores, pos, host))
    torch.cuda.synchronize()
    launches = counts.snapshot()
    print(f"staged path: the main path's {n_batches} batches of {BATCH}, "
          f"{STAGED_FLUSHES} flushes of {QUERIES}; launches {launches}")
    want = dict(prefilter=n_batches, assign=n_batches, mips=STAGED_FLUSHES,
                rerank=STAGED_FLUSHES, heavy_hitter=n_batches, admit=0, serve=0)
    for name, n in want.items():
        assert launches[name]["kernel"] == n, (name, launches[name], n)
    assert all(c["plain"] == 0 for c in launches.values()), "a plain version ran"
    for name in ("rerank", "prefilter", "assign"):
        results[name]["launches"] = launches[name]["kernel"]
    n_answered = live_routes = live_picks = 0
    for _, routes, _, _, (sc, rows, ids, clusters) in answers:
        live = ids >= 0
        assert sc.shape == ids.shape == (QUERIES, TOPK) and np.isfinite(sc[live]).all()
        n_answered += sc.shape[0]
        live_routes += int((routes >= 0).sum())
        live_picks += int(live.sum())
    assert n_answered == STAGED_FLUSHES * QUERIES
    live_slots, protos = int((staged.store.ids >= 0).sum()), int(staged.index.valid.sum())
    print(f"  keep per batch {[int(k.sum()) for k, *_ in seen]}; stored per batch "
          f"{[int(m.sum()) for m in stored]} (fused: "
          f"{[int(r[3].sum()) for r in ref]})")
    print(f"  staged store: {live_slots} live ring slots, {protos} valid prototypes, "
          f"{staged.upserts} upserts; live routes {live_routes}/"
          f"{n_answered * NPROBE}, live picks {live_picks}/{n_answered * TOPK}")
    assert live_slots >= MIN_LIVE_SLOTS and protos >= MIN_PROTOTYPES, (live_slots, protos)
    assert live_routes >= MIN_LIVE_SHARE * n_answered * NPROBE
    assert live_picks >= MIN_LIVE_SHARE * n_answered * TOPK

    # per batch against the fused composition
    chk = Check("staged")
    flip = None
    for i, (b, (keep_f, lab_f, (w, ids_f, rows_f, sc_f), _),
            (keep_s, lab_s, (w_s, ids_s, rows_s, sc_s), cent, basis)) in enumerate(
                zip(batches, ref, seen)):
        x = torch.from_numpy(b["embedding"]).cuda()
        r_p = prefilter_scores_ref(x, basis)
        keep_diff = keep_s != keep_f
        chk.decisions(f"keep b{i}", keep_diff, (r_p - alpha).abs() < TIE)
        lab_diff = (lab_s != lab_f) & keep_s & keep_f
        chk.decisions(f"labels b{i}", lab_diff,
                      label_ties(x, cent, lab_s.clamp(min=0), lab_f.clamp(min=0)))
        if bool(keep_diff.any() | lab_diff.any()):
            flip = i
            print(f"  a near-tie flipped a decision in batch {i}: keep "
                  f"{int(keep_diff.sum())}, labels {int(lab_diff.sum())}; "
                  f"comparing batches 0..{i - 1} only")
            break
        same_slots = len(w[0]) == len(w_s[0]) and all(torch.equal(a, c) for a, c in zip(w, w_s))
        if not same_slots or not torch.equal(ids_s, ids_f):
            chk.fail.append(f"batch {i}: the staged store wrote other slots or docs")
            break
        # int8 rows: +-1 only where v/scale lies within 1e-4 of a half-integer
        v = l2_normalize(x[(ids_s - int(b["doc_id"][0])).long()])
        ulp = torch.nextafter(sc_s, torch.full_like(sc_s, np.inf)) - sc_s
        bad = int(((sc_f - sc_s).abs() > 2 * ulp).sum())
        if bad:
            chk.fail.append(f"batch {i}: {bad} scales beyond 2 ulp")
        z = v / sc_s[:, None]
        half = (z - z.floor() - 0.5).abs() < 1e-4
        diff = rows_f.int() - rows_s.int()
        chk.decisions(f"int8 rows b{i}", diff != 0, (diff.abs() == 1) & half)
    batches_held = n_batches if flip is None else flip
    rows_held = sum(len(seen[i][2][1]) for i in range(batches_held))

    # per flush against the fused serve kernel on the same snapshot
    for q, routes, scores, pos, _ in answers:
        fused_out = stages.serve_topk(cfg.index, snap.index, snap.route_labels,
                                      snap.store, q, TOPK, NPROBE)
        qn = l2_normalize(q)
        hold_answers(qn, qn, snap.index.vectors, snap.index.valid, snap.store.embs,
                     snap.store.ids >= 0, snap.store.scales, (scores, pos, routes),
                     fused_out, chk)
    chk.done(f"{batches_held} batches ({rows_held} rows), {STAGED_FLUSHES} flushes")

    steady, hh = np.median(ingest_ms[1:]), np.median(hh_ms[1:])
    print(f"  staged ingest ms/batch: median {steady:.2f} with the heavy-hitter update, "
          f"{steady - hh:.2f} without it (update {hh:.3f} ms; first batch "
          f"{ingest_ms[0]:.2f})")
    print(f"  staged flush p50 {np.percentile(flush_ms, 50):.3f} ms p99 "
          f"{np.percentile(flush_ms, 99):.3f} ms over {len(flush_ms)} flushes; answered "
          f"{n_answered}/{STAGED_FLUSHES * QUERIES}; upserts {staged.upserts}; index size "
          f"{int(staged.index.valid.sum())}; store live {int((staged.store.ids >= 0).sum())}")


# ------------------------------------------------------------ heavy hitter
def hh_hold(got, want, what, chk: Check):
    """Every HHState leaf and every info entry equal, bit for bit."""
    (s_k, i_k), (s_p, i_p) = got, want
    bad = [n for n, a, b in zip(s_p._fields, s_k, s_p)
           if a.dtype != b.dtype or not torch.equal(a, b)]
    bad += [n for n in i_p if i_k[n].dtype != i_p[n].dtype or not torch.equal(i_k[n], i_p[n])]
    if bad:
        chk.fail.append(f"{what}: {', '.join(bad)} differ")


def hh_check(cfg, state, labels, draws, what, chk: Check):
    """The kernel against its plain version on the same state and draws;
    returns the kernel's and the plain version's new states."""
    got = update_batch_cuda(cfg, state, labels, draws)
    want = update_batch_ref(cfg, state, labels, draws)
    torch.cuda.synchronize()
    hh_hold(got, want, what, chk)
    return got[0], want[0]


def hh_bound(cfg, B, bmax, rows):
    """Bytes these inputs need: labels and draws in, the state in and out
    once, the info out, and for RANDOM_EVICT the Gumbel rows of the
    ``rows`` arrivals that evict (no other arrival reads its row); no
    arithmetic worth a bound (integer compares)."""
    cells = cfg.cms_depth * cfg.cms_width if cfg.policy == heavy_hitter.Policy.COUNT_MIN else 0
    state = 8 * bmax + 4 * cells + 28
    draws = 4 * B * (1 + int(cfg.morris))
    if cfg.policy == heavy_hitter.Policy.RANDOM_EVICT:
        draws += 4 * rows * bmax
    return bound(0.0, 4 * B + draws + 2 * state + 10 * B)


def hh_tally(state, new, labels, info) -> dict:
    """What a batch did: hits, inserts, evictions, dropped arrivals."""
    ev = int(new.total_evictions) - int(state.total_evictions)
    return dict(valid=int((labels >= 0).sum()), hits=int(info["hit"].sum()),
                inserts=int(info["admitted"].sum()) - ev, evictions=ev,
                dropped=int((labels < 0).sum()))


def hh_timed(what, cfg, st, lab, dr):
    """Device ms and the wrapper's host ms a call of one update, its tally,
    us per valid arrival, the plain loop's host ms and the bound."""
    new, info = update_batch_cuda(cfg, st, lab, dr)
    t = hh_tally(st, new, lab, info)
    ms, host = cuda_ms(lambda: update_batch_cuda(cfg, st, lab, dr))
    plain = hh_plain_ms(lambda: update_batch_ref(cfg, st, lab, dr), iters=1)
    b_ms, b_by = hh_bound(cfg, lab.shape[0], st.labels.shape[0], t["evictions"])
    print(f"  hh {what}: {ms:.4f} ms device, {host:.4f} ms a call from the host, "
          f"{ms * 1e3 / max(t['valid'], 1):.3f} us per valid arrival; {t}; plain loop "
          f"{plain:.2f} ms (host clock); bound {b_ms:.6f} ms ({b_by})")
    return ms, host, plain, b_ms, b_by


def hh_plain_ms(fn, iters: int = 2) -> float:
    """Host ms of the plain loop between synchronizes (it is host-bound)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / iters


def hh_zipf_cfg(policy, option):
    kw = dict(capacity=HH_ZIPF_CAPACITY, policy=policy)
    if option == "morris":
        kw["morris"] = True
    elif option == "adaptive":
        kw.update(adaptive=True, max_capacity=2 * HH_ZIPF_CAPACITY)
    elif option == "gate":
        kw["gate_below_capacity"] = True
    return heavy_hitter.HHConfig(**kw)


def phase_heavy_hitter(results, calls):
    """The heavy-hitter kernel against its plain loop, every leaf exact:
    on the main path's own 16 calls (MIN_EVICT, bmax 4218, the masked
    labels and draws that path used), on a Zipf label stream over 4218
    clusters at capacity 100 (paper Table 2's B; all arrivals valid) for
    each policy with exact counts, Morris, adaptive (max 200) and
    gate_below_capacity, on an all-dropped batch whose window is already
    full, and at B = 1. Then times: device, bound, plain."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 3)
    rng = np.random.default_rng(SEED + 3)
    chk = Check("hh")
    valid = [int((lab >= 0).sum()) for _, _, lab, _ in calls]
    for i, (cfg, st, lab, dr) in enumerate(calls):
        hh_check(cfg, st, lab, dr, f"main batch {i}", chk)
    cfg0, st0, lab0, dr0 = calls[0]
    hh_check(cfg0, st0, lab0[:1], {k: v[:1] for k, v in dr0.items()}, "main B=1", chk)
    writes = {}
    for policy in heavy_hitter.Policy:
        for option in ("exact", "morris", "adaptive", "gate"):
            cfg = hh_zipf_cfg(policy, option)
            st_k = st_p = heavy_hitter.init(cfg, "cuda")
            for b in range(HH_ZIPF_BATCHES):
                lab = torch.from_numpy(zipf_ids(rng, HH_ZIPF_CLUSTERS, (BATCH,))).cuda()
                dr = heavy_hitter.draw(cfg, BATCH, gen, "cuda")
                got = update_batch_cuda(cfg, st_k, lab, dr)
                want = update_batch_ref(cfg, st_p, lab, dr)
                torch.cuda.synchronize()
                hh_hold(got, want, f"zipf {policy.name} {option} batch {b}", chk)
                st_k, st_p = got[0], want[0]
            writes[f"{policy.name}/{option}"] = (int(st_k.total_writes),
                                                 int(st_k.total_evictions))
            if option == "adaptive":   # an all-dropped batch on a full window
                full = st_k._replace(seen_in_window=torch.tensor(
                    cfg.window + 3, dtype=torch.int32, device="cuda"))
                drop = torch.full((BATCH,), -1, dtype=torch.int32, device="cuda")
                dr = heavy_hitter.draw(cfg, BATCH, gen, "cuda")
                new, _ = hh_check(cfg, full, drop, dr, f"{policy.name} all dropped", chk)
                if int(new.seen_in_window) != 0:
                    chk.fail.append("the all-dropped batch did not close the window")
            one = torch.from_numpy(zipf_ids(rng, HH_ZIPF_CLUSTERS, (1,))).cuda()
            hh_check(cfg, st_k, one, heavy_hitter.draw(cfg, 1, gen, "cuda"),
                     f"{policy.name} {option} B=1", chk)
    chk.done(f"main x{len(calls)}, zipf 4 policies x 4 options, dropped, B=1")
    print(f"  hh: valid arrivals per main batch {valid}; zipf (writes, evictions) "
          f"after {HH_ZIPF_BATCHES} batches: {writes}")
    # ---- times: the main path's busiest batch; 256 valid Zipf arrivals at
    # bmax 4218 (MIN_EVICT, and RANDOM_EVICT, which never fills) and at
    # capacity 100 (full)
    i = int(np.argmax(valid))
    cfg, st, lab, dr = calls[i]
    ms, host, plain, b_ms, b_by = hh_timed(
        f"at the main path's batch {i} (MIN_EVICT, bmax {st.labels.shape[0]}, {valid[i]} "
        f"valid of {BATCH})", cfg, st, lab, dr)
    results["heavy_hitter"].update(max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=b_ms,
                                   bound_by=b_by, library_ms=None, host_ms=host)
    for policy, cap in ((heavy_hitter.Policy.MIN_EVICT, st.labels.shape[0]),
                        (heavy_hitter.Policy.RANDOM_EVICT, st.labels.shape[0]),
                        (heavy_hitter.Policy.MIN_EVICT, HH_ZIPF_CAPACITY)):
        cfg = heavy_hitter.HHConfig(capacity=cap, policy=policy)
        st_z = heavy_hitter.init(cfg, "cuda")
        for _ in range(3):   # fill some slots first (capacity 100: all)
            lab = torch.from_numpy(zipf_ids(rng, HH_ZIPF_CLUSTERS, (BATCH,))).cuda()
            st_z, _ = update_batch_cuda(cfg, st_z, lab, heavy_hitter.draw(cfg, BATCH, gen,
                                                                           "cuda"))
        lab = torch.from_numpy(zipf_ids(rng, HH_ZIPF_CLUSTERS, (BATCH,))).cuda()
        dr = heavy_hitter.draw(cfg, BATCH, gen, "cuda")
        hh_check(cfg, st_z, lab, dr, f"{policy.name} bmax {cfg.capacity} zipf", chk)
        hh_timed(f"{policy.name} at bmax {cfg.capacity}, {BATCH} valid Zipf arrivals",
                 cfg, st_z, lab, dr)
    chk.done("timed inputs")
    print("  heavy_hitter: no PyTorch call computes the same function (library_ms null)")



# ------------------------------------------------------------------- async
class RecordingEngine(Engine):
    """Keeps every published snapshot (so answers can be held against the
    snapshot they name) and the host ms of each ingest batch on the
    thread that ran it (no synchronize added)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.published, self.ingest_ms = {}, []

    def ingest(self, x, doc_ids, draws=None):
        t = time.perf_counter()
        out = super().ingest(x, doc_ids, draws)
        self.ingest_ms.append((time.perf_counter() - t) * 1e3)
        return out

    def publish(self):
        snap = super().publish()
        self.published[snap.version] = snap
        return snap


class LagServer(AsyncServer):
    """Records (snapshot version, lag in docs) at every publish."""

    def __init__(self, *a, **kw):
        self.lags = []
        super().__init__(*a, **kw)

    def _publish(self):
        super()._publish()
        self.lags.append((self._snapshot.version, self.stats["docs"] - self._published_docs))


def kernel_streams(trace_path: str) -> dict[str, list]:
    """The CUDA stream id of each launch, by kernel name, in a
    torch.profiler chrome trace."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    out: dict[str, list] = {}
    for e in events:
        if e.get("cat") == "kernel":
            out.setdefault(e["name"], []).append(e.get("args", {}).get("stream"))
    return out


def phase_async(stream, warm, batches, sync_lat, switch_s=None):
    """An AsyncServer on the main path's config, seed and warmup ingests
    the main path's 16 batches by serve_round (publish every 4) while a
    submitter thread submits a 64-query burst each round. ``switch_s``
    sets the interpreter's thread switch interval for the run (a
    diagnostic of where a flush waits; None keeps the default and adds
    the torch.profiler window)."""
    switch = sys.getswitchinterval()
    if switch_s is not None:
        sys.setswitchinterval(switch_s)
        print(f"async path again, the interpreter's switch interval {switch_s * 1e3:g} ms "
              f"(default {switch * 1e3:g} ms):")
    try:
        _async_run(stream, warm, batches, sync_lat, profiled=switch_s is None)
    finally:
        sys.setswitchinterval(switch)


def _async_run(stream, warm, batches, sync_lat, profiled):
    from torch.profiler import ProfilerActivity, profile

    cfg = full_config("int8", 64)
    scfg = ServerConfig(max_batch=QUERIES, topk=TOPK, two_stage=True, nprobe=NPROBE)
    eng = RecordingEngine(cfg, SEED, warm, device="cuda")
    server = LagServer(cfg, scfg, engine=eng, publish_every=ASYNC_PUBLISH_EVERY, queue_max=8)
    qs = stream.queries(QUERIES * len(batches))["embedding"]
    torch.cuda.synchronize()
    submitted, flushes = {}, []
    rounds = threading.Semaphore(0)
    lock = threading.Lock()

    def submitter():
        for r in range(len(batches)):
            if not rounds.acquire(timeout=120):
                return
            for qv in qs[r * QUERIES:(r + 1) * QUERIES]:
                t = server.submit(qv)
                with lock:
                    submitted[t] = qv

    counts.reset_all()
    sub = threading.Thread(target=submitter)
    sub.start()
    t0 = time.perf_counter()
    for b in batches:
        out = server.serve_round(b)   # flush first, then enqueue the batch
        if out:
            flushes.append(out)
        rounds.release()
    sub.join(120)
    assert not sub.is_alive(), "the submitter did not finish"
    during = server.latency_stats()   # the flushes while ingest ran
    server.sync(timeout=300)
    ingest_s = time.perf_counter() - t0
    while True:
        out = server.flush()
        if not out:
            break
        flushes.append(out)
    launches = counts.snapshot()
    fresh = server.freshness_stats()
    answers = [a for f in flushes for a in f]
    # the flushes after sync, with the ingest thread idle
    idle = list(server.stats["query_latency_ms"])[during["batches"]:]
    print(f"async path: {len(batches)} batches by serve_round, publish every "
          f"{ASYNC_PUBLISH_EVERY}, {len(submitted)} queries in bursts of {QUERIES}; "
          f"launches {launches}")
    assert sorted(a["ticket"] for a in answers) == sorted(submitted), "a ticket lost or repeated"
    assert len(answers) == len(submitted) == QUERIES * len(batches)
    assert {a["snapshot_version"] for a in answers} <= set(eng.published)
    assert fresh["lag_docs"] == 0, fresh
    for name in ("admit", "heavy_hitter", "serve"):
        assert launches[name]["kernel"] > 0, f"{name} never launched on the async path"
    assert launches["admit"]["kernel"] == launches["heavy_hitter"]["kernel"] == len(batches)
    assert all(c["plain"] == 0 for c in launches.values()), "a plain version ran"
    # each sampled flush again, whole, on the snapshot it names: bit for bit
    held = 0
    for f in flushes[::3]:
        snap = eng.published[f[0]["snapshot_version"]]
        q = np.stack([submitted[a["ticket"]] for a in f])
        s_, _, ids, _ = eng.query_snapshot(snap, q, TOPK, two_stage=True, nprobe=NPROBE)
        s_, ids = s_.cpu().numpy(), ids.cpu().numpy()
        for j, a in enumerate(f):
            if not (np.array_equal(a["doc_ids"], ids[j]) and np.array_equal(a["scores"], s_[j])):
                raise AssertionError(f"ticket {a['ticket']}: not its snapshot's answer")
            held += 1
    answers_ok(answers, TOPK)
    live = sum(int((b["doc_id"] >= 0).sum()) for b in batches)
    steady = eng.ingest_ms[1:]
    print(f"  answered {len(answers)}/{len(submitted)} exactly once from "
          f"{len({a['snapshot_version'] for a in answers})} snapshots; {held} answers held "
          f"bit for bit against their recorded snapshot; lag after sync {fresh['lag_docs']}")
    print(f"  flush while ingest runs: p50 {during['p50_ms']:.3f} ms p99 {during['p99_ms']:.3f} "
          f"ms, answer p50 {during['answer_p50_ms']:.3f} ms p99 {during['answer_p99_ms']:.3f} "
          f"ms over {during['batches']} flushes; synchronous server (main path, this card): "
          f"p50 {sync_lat['p50_ms']:.3f} p99 {sync_lat['p99_ms']:.3f}, answer p50 "
          f"{sync_lat['answer_p50_ms']:.3f} p99 {sync_lat['answer_p99_ms']:.3f} ms; this "
          f"server's {len(idle)} flushes after sync (ingest idle): "
          + (f"p50 {np.percentile(idle, 50):.3f} ms max {max(idle):.3f} ms" if idle
             else "none"))
    print(f"  ingest on the ingest thread: {np.median(steady):.2f} ms/batch median (first "
          f"{eng.ingest_ms[0]:.2f}); {live} docs ingested and published in {ingest_s:.3f} s "
          f"= {live / ingest_s:.0f} docs/s; lag (docs) at each publish {server.lags}")
    if not profiled:
        server.close(timeout=300)
        return
    # torch.profiler: the ingest kernels run on another stream than serve's
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        b = stream.next_batch(BATCH)
        server.ingest(b["embedding"], b["doc_id"])
        for qv in qs[:QUERIES]:
            server.submit(qv)
        server.flush()
        server.sync(timeout=300)
        torch.cuda.synchronize()
    server.close(timeout=300)
    trace = str(build.BUILD_DIR / "async_trace.json")
    prof.export_chrome_trace(trace)
    streams = kernel_streams(trace)
    ingest_k = {n: s for n, s in streams.items()
                if any(k in n for k in ("admit_prologue_kernel", "assign_tile_kernel",
                                        "heavy_hitter_kernel"))}
    serve_k = {n: s for n, s in streams.items()
               if any(k in n for k in ("route_tile_kernel", "serve_rerank_kernel"))}
    ingest_s_ids = set().union(*ingest_k.values()) if ingest_k else set()
    serve_s_ids = set().union(*serve_k.values()) if serve_k else set()
    hh_n = sum(len(v) for n, v in ingest_k.items() if "heavy_hitter_kernel" in n)
    print(f"  torch.profiler over one more batch and flush: streams of the ingest kernels "
          f"{sorted(map(str, ingest_s_ids))}, of the serve kernels "
          f"{sorted(map(str, serve_s_ids))}; heavy_hitter kernels for the one batch: {hh_n}")
    assert len(ingest_k) == 3 and len(serve_k) == 2, (sorted(streams))
    assert hh_n == 1, hh_n
    assert None not in ingest_s_ids | serve_s_ids, "the trace names no stream"
    assert not ingest_s_ids & serve_s_ids, "ingest and serve kernels share a stream"


# ------------------------------------------------------------ cached async
def zipf_pool_draws(rng, pool: int, n: int, alpha: float = CACHE_ZIPF) -> np.ndarray:
    """``n`` indices into a pool of ``pool`` queries, rank r drawn with
    probability ~ 1 / r^alpha."""
    p = 1.0 / np.arange(1, pool + 1) ** alpha
    return rng.choice(pool, size=n, p=p / p.sum())


@contextlib.contextmanager
def calls_seen(obj, name, hook):
    """Run ``hook(*args)`` before each call of ``obj.name`` while active."""
    real = getattr(obj, name)

    def seen(*a, **kw):
        hook(*a, **kw)
        return real(*a, **kw)

    setattr(obj, name, seen)
    try:
        yield
    finally:
        setattr(obj, name, real)


@contextlib.contextmanager
def recorded(obj, name, into: list):
    """Append ``(args, kwargs, output)`` of each call of ``obj.name`` to
    ``into`` while active."""
    real = getattr(obj, name)

    def rec(*a, **kw):
        out = real(*a, **kw)
        into.append((a, kw, out))
        return out

    setattr(obj, name, rec)
    try:
        yield
    finally:
        setattr(obj, name, real)


def check_tier_serves(cfg, calls, chk: Check) -> int:
    """The serve kernel over each hot tier the cached path served from,
    with the inputs ``HotSet.serve`` gave it (the tier's remapped route
    labels, its gathered rings), against serve's plain version."""
    n = 0
    for snap, labels, tier, q, k, nprobe, depth in calls:
        qn = l2_normalize_queries(q)
        scales = tier.scales if tier.embs.dtype == torch.int8 else None
        embs, live, scales = stages.slice_rings(tier.embs, docstore.live_mask(tier),
                                                scales, depth)
        check_serve(qn if cfg.index.normalize else q, qn, snap.index.vectors,
                    snap.index.valid, labels, embs, live, scales, k, nprobe, chk)
        n += q.shape[0]
    return n


def route_witness_census(cfg, eng, snap, q) -> str:
    """The route witness on ``snap`` for the queries ``q``: its routes must
    equal, bit for bit, the routes the fused serve kernel serves them
    through, near-ties among their top NPROBE + 1 route scores included
    (how many hold one is reported)."""
    routes = stages.route_witnessed(cfg.index, snap.index, snap.route_labels, q, NPROBE)
    served = eng.routed_query_snapshot(snap, q, TOPK, NPROBE)[4].cpu().numpy()
    assert np.array_equal(routes, served), \
        f"{int((routes != served).any(axis=1).sum())} queries: witness != served routes"
    sc, _, _ = index_lib.search(cfg.index, snap.index, q, NPROBE + 1)
    gaps = torch.where(sc[:, :-1] > NEG_INF / 2, sc[:, :-1] - sc[:, 1:], float("inf"))
    return (f"witness == served routes for all {q.shape[0]}; "
            f"{int((gaps < TIE).any(dim=1).sum())} hold a near-tie (gap < {TIE:g}) "
            f"among their top {NPROBE + 1} route scores; "
            f"{int(torch.sum(snap.index.valid))} valid prototypes")


def phase_cached(stream, warm, batches, results):
    """4c. The cached async path: result cache + hot set on the main
    path's config, ingesting its 16 batches (publish every 4) while
    64-query flushes of Zipf draws over a 512-query pool run, then 16
    flushes with ingest idle, then a publish that moves no cluster and
    the last idle round once more. Every answer is held bit for bit
    against its query served alone on the recorded snapshot it names;
    the query-side counter and the tier serves against their plain
    versions on the inputs the path gave them."""
    cfg = full_config("int8", 64)
    base = dict(max_batch=QUERIES, topk=TOPK, two_stage=True, nprobe=NPROBE)
    scfg = ServerConfig(**base, cache_entries=CACHE_ENTRIES, hotset=True,
                        pin_budget_mb=PIN_BUDGET_MB, hotset_capacity=HOT_CAPACITY,
                        hotset_refresh=HOT_REFRESH, hotset_min_count=2)
    eng = RecordingEngine(cfg, SEED, warm, device="cuda")
    server = AsyncServer(cfg, scfg, engine=eng, publish_every=ASYNC_PUBLISH_EVERY,
                         queue_max=8)
    hot, cache = server._hotset, server._result_cache
    pool = stream.queries(CACHE_POOL)["embedding"]
    rng = np.random.default_rng(SEED)
    rounds = [zipf_pool_draws(rng, CACHE_POOL, QUERIES)
              for _ in range(len(batches) + CACHE_IDLE_FLUSHES)]
    # a publish that moves no cluster (a batch of padding rows, doc id -1,
    # as a fixed-size producer pads a quiet interval) keeps every entry, so
    # the last idle round asked again is answered through the route check
    pad_batch = dict(embedding=batches[-1]["embedding"],
                     doc_id=np.full_like(batches[-1]["doc_id"], -1))
    torch.cuda.synchronize()
    asked, flushes, flush_ms = {}, [], []
    observed, tier_calls = [], []

    def flush_round(draws):
        for i in draws:
            asked[server.submit(pool[i])] = i
        t = time.perf_counter()
        out = server.flush()
        flush_ms.append((time.perf_counter() - t) * 1e3)
        flushes.append(out)

    with calls_seen(hot, "observe", lambda routes: observed.append((hot.hh, routes))), \
            calls_seen(hot, "serve", lambda snap, q, k, nprobe, depth: tier_calls.append(
                (snap, hot._hot_labels, hot._tier, q, k, nprobe, depth))):
        counts.reset_all()
        for r, b in enumerate(batches):
            flush_round(rounds[r])
            server.ingest(b["embedding"], b["doc_id"])
        server.sync(timeout=300)
        for r in range(len(batches), len(rounds)):
            flush_round(rounds[r])
        before = cache.stats()
        found = dict(hit=before["hits"] - before["hits_exact"],
                     routes_moved=cache.routes_moved, near_tie=server.route_near_ties)
        server.ingest(pad_batch["embedding"], pad_batch["doc_id"])
        server.sync(timeout=300)
        clean_publish = dict(eng.last_publish_info)
        flush_round(rounds[-1])
        torch.cuda.synchronize()
        launches = counts.snapshot()
    cs, hs, rs = server.cache_stats(), hot.stats(), cache.stats()
    route_checked = rs["hits"] - rs["hits_exact"]
    answers = [a for f in flushes for a in f]
    ingested = len(batches) + 1
    print(f"cached async path: cache {CACHE_ENTRIES} entries, hot set (capacity "
          f"{HOT_CAPACITY}, refresh {HOT_REFRESH}, pin budget {PIN_BUDGET_MB} MB = "
          f"{hs['tier_bucket']} clusters x {hot.per_cluster_bytes} B); "
          f"{len(answers)} queries, Zipf alpha {CACHE_ZIPF} over {CACHE_POOL}; "
          f"launches {launches}")
    assert sorted(a["ticket"] for a in answers) == sorted(asked), "a ticket lost or repeated"
    assert len(answers) == QUERIES * (len(rounds) + 1)
    for name in ("serve_route", "serve", "heavy_hitter"):
        assert launches[name]["kernel"] > 0, f"{name} never launched on the cached path"
    # one route pass (serve's route-only entry) and one query-side counter
    # update a flush that had pending queries, beside one counter update
    # per ingest batch
    assert launches["heavy_hitter"]["kernel"] == ingested + launches["serve_route"]["kernel"]
    assert launches["serve_route"]["kernel"] == len(observed) <= len(rounds) + 1
    assert launches["mips"]["kernel"] == 0, launches["mips"]
    results["serve_route"]["launches"] = launches["serve_route"]["kernel"]
    # the witness is serve's own stage 1: nothing is left unwitnessed, and
    # every served row's routes are the pass's
    assert server.route_near_ties == 0 and server.route_mismatches == 0, \
        (server.route_near_ties, server.route_mismatches)
    assert launches["admit"]["kernel"] == ingested
    assert all(c["plain"] == 0 for c in launches.values()), "a plain version ran"
    assert cs["hits"] > 0 and cs["hot_served"] > 0 and cs["tier_rebuilds"] > 0, cs
    assert clean_publish["mode"] == "republish", clean_publish
    assert rs["rekeyed"] > before["rekeyed"] and route_checked >= PARENT_ROUTE_CHECKED, \
        (route_checked, rs)
    # every answer: its query alone on the snapshot it names, bit for bit
    for a in answers:
        snap = eng.published[a["snapshot_version"]]
        s_, _, ids, cl = eng.query_snapshot(snap, pool[asked[a["ticket"]]][None], TOPK,
                                            two_stage=True, nprobe=NPROBE)
        if not (np.array_equal(a["scores"], s_[0].cpu().numpy())
                and np.array_equal(a["doc_ids"], ids[0].cpu().numpy())
                and np.array_equal(a["clusters"], cl[0].cpu().numpy())):
            raise AssertionError(f"ticket {a['ticket']}: not its snapshot's answer")
    answers_ok(answers, TOPK)
    ties = route_witness_census(cfg, eng, eng.published[max(eng.published)],
                                torch.from_numpy(np.asarray(pool, np.float32)).cuda())
    # the query-side counter: the kernel against its plain loop on every
    # update the path made (the state before it, its padded signatures,
    # explicit draws: MIN_EVICT at admit_prob 1 lets no draw decide)
    chk = Check("heavy_hitter")
    dgen = torch.Generator(device="cuda").manual_seed(SEED)
    for st, routes in observed:
        sigs = np.full((QUERIES,), -1, np.int32)
        sigs[:len(routes)] = [route_signature(r) for r in routes]
        sig_t = torch.from_numpy(sigs).cuda()
        hh_check(hot.hh_cfg, st, sig_t,
                 heavy_hitter.draw(hot.hh_cfg, QUERIES, dgen, sig_t.device),
                 "query side", chk)
    # ... and timed on its final state: live signatures (hits) and padding
    sigs = torch.full((QUERIES,), -1, dtype=torch.int32, device="cuda")
    live = [s for s in hot.hh.labels.cpu().tolist() if s >= 0][:QUERIES // 2]
    sigs[:len(live)] = torch.tensor(live, dtype=torch.int32)
    draws = heavy_hitter.draw(hot.hh_cfg, QUERIES, hot._gen, sigs.device)
    hh_check(hot.hh_cfg, hot.hh, sigs, draws, "query side, timed inputs", chk)
    chk.done(f"query side ({len(observed) + 1} updates)")
    hh_dev, hh_host = cuda_ms(lambda: heavy_hitter.update_batch(
        hot.hh_cfg, hot.hh, sigs, draws=draws))
    chk = Check("serve")
    n_tier = check_tier_serves(cfg, tier_calls, chk)
    chk.done(f"hot tier ({len(tier_calls)} serves)")
    assert n_tier == cs["hot_served"], (n_tier, cs["hot_served"])
    server.close(timeout=300)
    # the same idle rounds, uncached, on the same final snapshot
    plain_srv = AsyncServer(cfg, ServerConfig(**base), engine=eng, publish_every=10**9)
    idle_u = []
    for r in range(len(batches), len(rounds)):
        for i in rounds[r]:
            plain_srv.submit(pool[i])
        t = time.perf_counter()
        plain_srv.flush()
        idle_u.append((time.perf_counter() - t) * 1e3)
    plain_srv.close(timeout=300)
    during, idle = flush_ms[:len(batches)], flush_ms[len(batches):len(rounds)]
    print(f"  answered {len(answers)} exactly once; every answer bit-equal to its query "
          f"alone on its recorded snapshot ({len({a['snapshot_version'] for a in answers})} "
          f"snapshots); route pass vs served routes differed on "
          f"{server.route_mismatches} rows; {server.route_near_ties} pending rows left "
          f"unverified by a near-tie")
    print(f"  hit rate {cs['hit_rate']:.4f} ({cs['hits']} hits, {rs['hits_exact']} route-free "
          f"exact = {rs['hits_exact'] / len(answers):.4f} of queries, {route_checked} "
          f"route-checked, {cs['misses']} misses); hot-served {cs['hot_served']}; tier "
          f"rebuilds {cs['tier_rebuilds']}; pinned {cs['pinned_bytes']} B "
          f"({cs['pinned_clusters']} clusters); invalidated {cs['invalidated']}, cleared "
          f"{cs['cleared']}, evicted {cs['evicted_lru']}, rekeyed {rs['rekeyed']} "
          f"({before['rekeyed']} before the clean publish, whose route-checked hits are "
          f"{route_checked - (before['hits'] - before['hits_exact'])} of "
          f"{QUERIES}); before it, the route check met a re-keyed entry "
          f"{sum(found.values())} times: {found}")
    print(f"  route witness over the {CACHE_POOL}-query pool on the last snapshot: {ties}")
    print(f"  route-checked hits {route_checked}, at least the {PARENT_ROUTE_CHECKED} the "
          f"mips witness with its near-tie margin gave on this path")
    print(f"  flush ms cached: while ingest runs p50 {np.percentile(during, 50):.3f} p99 "
          f"{np.percentile(during, 99):.3f}; ingest idle p50 {np.percentile(idle, 50):.3f} "
          f"p99 {np.percentile(idle, 99):.3f}; uncached, the same idle draws on the same "
          f"snapshot: p50 {np.percentile(idle_u, 50):.3f} p99 {np.percentile(idle_u, 99):.3f}")
    print(f"  query-side heavy_hitter (capacity {HOT_CAPACITY}, B = {QUERIES}): "
          f"{hh_dev:.4f} ms device, {hh_host:.4f} ms a call from the host")
    del server, plain_srv, eng, observed, tier_calls
    torch.cuda.empty_cache()


# ----------------------------------------------------------- durable async
@contextlib.contextmanager
def timed_method(obj, name, into: list):
    """Host ms of each call of ``obj.name`` into ``into`` while active."""
    real = getattr(obj, name)

    def timed(*a, **kw):
        t = time.perf_counter()
        out = real(*a, **kw)
        into.append((time.perf_counter() - t) * 1e3)
        return out

    setattr(obj, name, timed)
    try:
        yield into
    finally:
        setattr(obj, name, real)


def same_state(a, b) -> list[str]:
    """The leaves (checkpoint keystr paths) where two states differ."""
    fa, fb = ckpt_lib.flatten_tree(a), ckpt_lib.flatten_tree(b)
    assert fa.keys() == fb.keys()
    return [k for k in fa if not np.array_equal(ckpt_lib.to_host(fa[k]),
                                                ckpt_lib.to_host(fb[k]))]


def phase_durable(stream, warm, batches):
    """4d. The durable async path: journal + checkpoints every 4 applied
    batches (fsync), the ingest thread killed at admit hit 11, recovery
    on the same directories, the rest of the stream; the recovered state
    against an engine that never crashed, leaf for leaf, bit for bit."""
    cfg = full_config("int8", 64)
    scfg = ServerConfig(max_batch=QUERIES, topk=TOPK, two_stage=True, nprobe=NPROBE)
    crash_batch, cut = DURABLE_CRASH_AT - 1, DURABLE_CRASH_AT + 1
    # determinism first: two engines, the same batches, bit-equal states
    ref, twin = (Engine(cfg, SEED, warm, device="cuda") for _ in range(2))
    for b in batches:
        ref.ingest(b["embedding"], b["doc_id"])
        twin.ingest(b["embedding"], b["doc_id"])
    torch.cuda.synchronize()
    diff = same_state(ref.state, twin.state)
    assert not diff, f"ingest is not deterministic on the card: {diff}"
    del twin
    qs = stream.queries(QUERIES * len(batches))["embedding"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_durable_") as tmp:
        dcfg = DurabilityConfig(checkpoint_dir=tmp, checkpoint_every=DURABLE_EVERY,
                                fsync=True)
        counts.reset_all()
        srv = AsyncServer(cfg, scfg, engine=Engine(cfg, SEED, warm, device="cuda"),
                          publish_every=ASYNC_PUBLISH_EVERY, durability=dcfg,
                          queue_max=len(batches))
        dur = srv._durable
        saves, appends, snap_ms, waits, flush_ms = [], [], [], [], []
        durable_cb = dur.ckpt.on_durable
        dur.ckpt.on_durable = lambda seq: (saves.append(dict(dur.ckpt.last_save)),
                                           durable_cb(seq))
        with timed_method(dur.journal, "append", appends), \
                timed_method(dur, "checkpoint", snap_ms), \
                timed_method(dur.ckpt, "wait", waits), \
                faults.inject(f"ingest.admit:crash@{DURABLE_CRASH_AT}") as plan:
            for r, b in enumerate(batches[:cut]):
                try:
                    srv.ingest(b["embedding"], b["doc_id"])
                except RuntimeError:
                    pass   # the thread died; the batch was journaled before the put
                for qv in qs[r * QUERIES:(r + 1) * QUERIES]:
                    srv.submit(qv)
                writing = dur.ckpt._thread is not None and dur.ckpt._thread.is_alive()
                t = time.perf_counter()
                srv.flush()
                flush_ms.append(((time.perf_counter() - t) * 1e3, writing))
            srv._thread.join(120)
            assert not srv._thread.is_alive(), "the injected crash did not land"
            assert plan.fired("ingest.admit") == 1
        dur.ckpt.wait()
        applied = dur._applied_seq
        dur.close()
        torch.cuda.synchronize()
        restore_ms = []
        fresh = Engine(cfg, SEED, warm, device="cuda")
        torch.cuda.synchronize()
        t = time.perf_counter()
        with timed_method(CheckpointStore, "restore", restore_ms):
            srv2 = AsyncServer(cfg, scfg, engine=fresh,
                               publish_every=ASYNC_PUBLISH_EVERY, durability=dcfg)
        torch.cuda.synchronize()
        recover_ms = (time.perf_counter() - t) * 1e3
        rep = srv2.recovery_report
        for b in batches[cut:]:
            srv2.ingest(b["embedding"], b["doc_id"])
        srv2.sync(timeout=300)
        torch.cuda.synchronize()
        diff = same_state(ref.state, srv2.engine.state)
        srv2.close(timeout=300)
        launches = counts.snapshot()
    print(f"durable async path: checkpoint every {DURABLE_EVERY} applied batches (fsync), "
          f"{cut} batches journaled, the ingest thread killed at batch seq {crash_batch} "
          f"({applied + 1} applied); launches {launches}")
    assert applied == crash_batch - 1, applied
    assert rep["checkpoint_seq"] is not None and rep["quarantined"] == [], rep
    assert rep["applied_seq"] == cut - 1, rep
    assert not diff, f"recovered state differs from the uncrashed engine's: {diff}"
    expect = applied + 1 + rep["replayed"] + len(batches) - cut
    assert launches["admit"]["kernel"] == launches["heavy_hitter"]["kernel"] == expect
    assert launches["serve"]["kernel"] > 0
    assert all(c["plain"] == 0 for c in launches.values()), "a plain version ran"
    fulls = [s for s in saves if s["mode"] == "full"]
    deltas = [s for s in saves if s["mode"] == "delta"]
    assert fulls and deltas, saves
    busy = [ms for ms, w in flush_ms if w]
    print(f"  recovered state equals the uncrashed engine's leaf for leaf, bit for bit "
          f"(generator, store and counter included); ingest twice from one state: "
          f"bit-equal")
    print(f"  journal append (+fsync) p50 {np.percentile(appends, 50):.3f} ms a batch "
          f"over {len(appends)}")
    for what, ss in (("full", fulls), ("delta", deltas)):
        print(f"  {what} checkpoints: " + "; ".join(
            f"seq {s['seq']} {s['bytes'] / 1e6:.2f} MB, {s['dirty_clusters']} clusters, "
            f"device copy {s['copy_ms']:.3f} ms, write {s['write_ms']:.1f} ms"
            for s in ss))
    print(f"  save() on the ingest thread: " + ", ".join(
        f"{s['mode']} {ms:.3f} ms ({w:.3f} of it waiting for the previous write)"
        for s, ms, w in zip(saves, snap_ms, waits))
        + " (the rest: signature, gather, queued copies; pinned buffers allocated on "
          "first use)")
    print(f"  recovery {recover_ms:.1f} ms in all: restore {restore_ms[0]:.1f} ms (checkpoint "
          f"seq {rep['checkpoint_seq']}), then replay of {rep['replayed']} batches and the "
          f"first publish {recover_ms - restore_ms[0]:.1f} ms")
    print(f"  flush p50 {np.percentile([m for m, _ in flush_ms], 50):.3f} ms over "
          f"{len(flush_ms)}; while a checkpoint was being written: "
          + (f"p50 {np.percentile(busy, 50):.3f} ms over {len(busy)}" if busy
             else "no flush fell inside a write"))
    del ref, srv, srv2, fresh
    torch.cuda.empty_cache()


# ----------------------------------------------------------------- sharded
def same_tensors(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def held_answers(got, want, what: str, chk: Check):
    """Sharded (scores, rows, ids, clusters) against the single-device
    answer on the merged snapshot: scores within tolerance, the rest equal
    except where the single-device scores hold a near-tie."""
    chk.floats(f"{what} scores", got[0], want[0])
    s = want[0]
    gap = torch.full_like(s, float("inf"))
    gap[:, :-1] = s[:, :-1] - s[:, 1:]
    tie = gap < TIE
    tie[:, 1:] |= gap[:, :-1] < TIE
    for name, g, w in zip(("rows", "ids", "clusters"), got[1:4], want[1:4]):
        chk.decisions(f"{what} {name}", g != w, tie)


def phase_sharded(stream, warm, batches):
    """4e. The sharded engine on a 2 x 2 mesh (every shard on the one
    card) at the main path's width: the 16 batches, a publish every 4
    (full, then delta), fused, staged and prototype-only flushes; held
    against single-device replays of each data shard, the host merge and
    the single-device query on the merged snapshot."""
    from repro_torch.engine.sharded import ShardedEngine, reconcile_states, state_to
    from repro_torch.kernels.heavy_hitter import ops as hh_ops
    from repro_torch.kernels.rerank import ops as rerank_ops
    from repro_torch.kernels.serve import ops as serve_ops
    from repro_torch.launch.mesh import make_streaming_mesh

    cfg = full_config("int8", 64)
    D, M = SHARDED_MESH
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mesh = make_streaming_mesh(D, M)
    eng = ShardedEngine(cfg, mesh, SEED, warmup=warm, reconcile_every=10**9,
                        reconcile_mode="delta")
    replays = [Engine(cfg, state=ShardedEngine.shard_init_state(cfg, SEED, s, D, warm))
               for s in range(D)]
    single = Engine(cfg, SEED, warm, device="cuda")
    qs = stream.queries(QUERIES * SHARDED_FLUSHES)["embedding"]
    print(f"sharded path: {eng.describe()}; k={cfg.clus.num_clusters} (k/M = "
          f"{cfg.clus.num_clusters // M}), int8 depth {cfg.store_depth}, "
          f"{len(batches)} batches of {BATCH}, publish every {SHARDED_PUBLISH_EVERY}")
    torch.cuda.synchronize()
    ms = dict(sharded=[], replays=[], single=[])
    publishes, served, tier_calls, admits, hhs = [], [], [], [], []
    counts.reset_all()
    with recorded(stages, "admit_op", admits), recorded(hh_ops, "update_batch", hhs):
        for i, b in enumerate(batches):
            t = time.perf_counter()
            eng.ingest(b["embedding"], b["doc_id"])
            torch.cuda.synchronize()
            ms["sharded"].append((time.perf_counter() - t) * 1e3)
            if (i + 1) % SHARDED_PUBLISH_EVERY == 0:
                t = time.perf_counter()
                eng.prepare_publish()
                snap = eng.publish()
                torch.cuda.synchronize()
                publishes.append(((time.perf_counter() - t) * 1e3,
                                  dict(eng.last_publish_info)))
    snap = eng.serving
    with calls_seen(serve_ops, "serve_topk", lambda *a, **kw: tier_calls.append(
            ("serve", a, kw))), \
            calls_seen(rerank_ops, "rerank_topk", lambda *a, **kw: tier_calls.append(
                ("rerank", a, kw))):
        flush_ms = []
        for f in range(SHARDED_FLUSHES):
            q = qs[f * QUERIES:(f + 1) * QUERIES]
            t = time.perf_counter()
            out = eng.query_snapshot(snap, q, TOPK, two_stage=True, nprobe=NPROBE)
            out = tuple(a.cpu() for a in out)
            flush_ms.append((time.perf_counter() - t) * 1e3)
            served.append(("fused", q, out))
        for f in range(SHARDED_OTHER_FLUSHES):
            q = qs[f * QUERIES:(f + 1) * QUERIES]
            served.append(("staged", q, tuple(a.cpu() for a in eng.query_snapshot(
                snap, q, TOPK, two_stage=True, nprobe=NPROBE, staged=True))))
            served.append(("prototype-only", q, tuple(a.cpu() for a in eng.query_snapshot(
                snap, q, TOPK))))
    torch.cuda.synchronize()
    launches = counts.snapshot()
    print(f"  launches on the sharded path: {launches}")
    n_b = len(batches)
    assert launches["admit"]["kernel"] == launches["heavy_hitter"]["kernel"] == D * n_b
    assert launches["serve"]["kernel"] == M * SHARDED_FLUSHES
    assert launches["rerank"]["kernel"] == M * SHARDED_OTHER_FLUSHES
    assert launches["mips"]["kernel"] == 2 * SHARDED_OTHER_FLUSHES  # staged route + proto
    assert all(c["plain"] == 0 for c in launches.values()), "a plain version ran"
    peak = torch.cuda.max_memory_allocated()

    # admit and heavy_hitter at this path's shapes (BATCH / D rows a shard)
    # against their plain versions on the inputs the path gave them
    assert len(admits) == len(hhs) == D * n_b, (len(admits), len(hhs))
    chk_a, chk_h = Check("admit"), Check("hh")
    for a, kw, out in admits:
        x, _, cent, alpha, _ = a
        hold_admit(out, admit_ref(*a, **kw), x, cent, alpha, kw["store_dtype"], chk_a)
    for i, (a, _, out) in enumerate(hhs):
        hh_hold(out, update_batch_ref(*a), f"sharded call {i}", chk_h)
    rows = sorted({int(a[0].shape[0]) for a, _, _ in admits})
    chk_a.done(f"sharded ingest x{len(admits)} B={rows}")
    chk_h.done(f"sharded ingest x{len(hhs)}")
    del admits, hhs

    # each data shard == a single-device replay of its sub-stream, bit for bit
    h = BATCH // D
    for b in batches:
        for s, rep in enumerate(replays):
            t = time.perf_counter()
            rep.ingest(b["embedding"][s * h:(s + 1) * h], b["doc_id"][s * h:(s + 1) * h])
            torch.cuda.synchronize()
            ms["replays"].append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        single.ingest(b["embedding"], b["doc_id"])
        torch.cuda.synchronize()
        ms["single"].append((time.perf_counter() - t) * 1e3)
    for s, rep in enumerate(replays):
        diff = same_state(rep.state, eng.shards[s])
        assert not diff, f"data shard {s} differs from its replay: {diff}"
    # the publish == reconcile_states on the card (a full rebuild), bit for
    # bit, and == reconcile_states on the host, ints exact, floats close
    full_store = docstore.DocStore(*(torch.cat(ts) for ts in zip(*snap.store)))
    torch.cuda.synchronize()
    t = time.perf_counter()
    card = reconcile_states(cfg, eng.shards)
    torch.cuda.synchronize()
    rebuild_ms = (time.perf_counter() - t) * 1e3
    assert same_tensors((*card.index[:3], card.route_labels, *card.store),
                        (*snap.index[:3], snap.route_labels, *full_store)), \
        "the delta publish differs from a full rebuild"
    t = time.perf_counter()
    host = reconcile_states(cfg, [state_to(s, "cpu") for s in eng.shards])
    host_ms = (time.perf_counter() - t) * 1e3
    chk = Check("reconcile")
    chk.floats("index vectors", snap.index.vectors.cpu(), host.index.vectors)
    bad = [name for name, a, b in (
        ("index ids", snap.index.ids, host.index.ids),
        ("index valid", snap.index.valid, host.index.valid),
        ("route labels", snap.route_labels, host.route_labels),
        *((f"store {n}", a, b) for n, a, b in zip(docstore.DocStore._fields,
                                                   full_store, host.store)))
        if not torch.equal(a.cpu(), b)]
    chk.fail += [f"{name} differs" for name in bad]
    chk.done("publish vs host merge")
    assert eng.store_bytes_per_device() * M == docstore.memory_bytes(cfg.store)

    # answers == the single-device query on the merged snapshot
    merged = snap._replace(store=full_store)
    chk = Check("sharded")
    single_ms = []
    for kind, q, got in served:
        t = time.perf_counter()
        want = single.query_snapshot(merged, q, TOPK, two_stage=kind != "prototype-only",
                                     nprobe=NPROBE)
        want = tuple(a.cpu() for a in want)
        if kind == "fused":
            single_ms.append((time.perf_counter() - t) * 1e3)
        held_answers(got, want, kind, chk)
    chk.done(f"answers ({len(served)} flushes)")
    answers_live = sum(int((got[2] >= 0).sum()) for _, _, got in served)
    assert answers_live > 0
    # the serve and rerank kernels under localized labels and routes
    chk_s, chk_r = Check("serve"), Check("rerank")
    for name, a, kw in tier_calls:
        if name == "serve":
            check_serve(*a[:7], kw.get("scales"), a[7], a[8], chk_s)
        else:
            check_rerank(*a[:5], kw.get("scales"), chk_r)
    dead = sum(int((a[4] < 0).sum()) for n, a, _ in tier_calls if n == "serve")
    chk_s.done(f"localized labels ({dead} -1)")
    chk_r.done("localized routes")

    full = [p for p in publishes if p[1]["mode"] == "full"]
    delta = [p for p in publishes if p[1]["mode"] != "full"]
    assert any(p[1]["mode"] == "delta" for p in delta), publishes
    steady = lambda v: np.median(v[1:])  # noqa: E731
    print(f"  every data shard bit-equal to its single-device replay; the delta publish "
          f"bit-equal to a full rebuild on the card and to the host merge; store bytes "
          f"per device {eng.store_bytes_per_device()} x {M} = full")
    print(f"  ingest ms/batch: sharded median {steady(ms['sharded']):.2f} (first "
          f"{ms['sharded'][0]:.2f}); the two shards' replays {steady(ms['replays']) * D:.2f} "
          f"({steady(ms['replays']):.2f} each); one engine on the whole batch "
          f"{steady(ms['single']):.2f}")
    print(f"  publish ms: full {', '.join(f'{p[0]:.2f}' for p in full)} (the first); delta "
          + ", ".join(f"{p[0]:.2f} ({p[1]['mode']}, {p[1]['dirty_clusters']} dirty clusters)"
                      for p in delta)
          + f"; a full rebuild from the final states {rebuild_ms:.2f} on the card, "
            f"{host_ms:.1f} on the host")
    print(f"  two-stage flush of {QUERIES}: sharded p50 {np.percentile(flush_ms, 50):.3f} ms "
          f"p99 {np.percentile(flush_ms, 99):.3f} over {len(flush_ms)}; single-device on "
          f"the merged snapshot p50 {np.percentile(single_ms, 50):.3f} p99 "
          f"{np.percentile(single_ms, 99):.3f}; {answers_live} live answers held")
    print(f"  peak memory {peak / 1e6:.1f} MB (2 shard states, the snapshot, the merge)")
    del eng, replays, single, snap, merged, card, host, served, tier_calls
    torch.cuda.empty_cache()


def run_module(module: str, args, root: str, label: str) -> list[str]:
    """``python -m module args`` in its own process from ``root``, its
    output echoed, a non-zero exit raised; returns its stdout lines."""
    env = {**os.environ, "PYTHONPATH": os.path.join(root, "src")}
    cmd = [sys.executable, "-m", module, *args]
    t = time.perf_counter()
    out = subprocess.run(cmd, cwd=root, env=env, capture_output=True, text=True,
                         timeout=LAUNCH_TIMEOUT_S)
    print(f"{label}: {' '.join(cmd[1:])} (exit {out.returncode}, "
          f"{time.perf_counter() - t:.1f} s)")
    for line in out.stdout.splitlines():
        print(f"  | {line}")
    if out.returncode != 0:
        raise AssertionError(f"{module} failed:\n{out.stderr[-4000:]}")
    return out.stdout.splitlines()


def launcher_run(flags, tmp: str, root: str) -> dict[str, str]:
    """One run of the serving launcher; returns its summary lines, label
    -> value."""
    lines = run_module("repro_torch.launch.serve", [*flags, "--checkpoint-dir", tmp], root,
                       "launcher")
    return {ln.split(":", 1)[0].strip(): ln.split(":", 1)[1].strip()
            for ln in lines if " : " in ln}


def phase_launcher():
    """4f. ``python -m repro_torch.launch.serve`` in its own process on the
    card, sharded, async, cached, durable; then again on the same
    directory, where it must recover first."""
    root = os.path.dirname(os.path.abspath(__file__))
    batches = int(LAUNCH_FLAGS[LAUNCH_FLAGS.index("--batches") + 1])
    with tempfile.TemporaryDirectory(prefix="chip_smoke_launch_") as tmp:
        first = launcher_run(LAUNCH_FLAGS, tmp, root)
        again = list(LAUNCH_FLAGS)
        again[again.index("--batches") + 1] = "2"
        second = launcher_run(again, tmp, root)
    want = ("device map", "docs ingested", "queries answered", "index size", "durability",
            "supervision", "serving cache", "hot tier", "state memory", "store bytes/dev")
    missing = [w for w in want if w not in first]
    assert not missing and "recovered" not in first, (missing, sorted(first))
    for lines, n in ((first, 16 * 64), (second, 2 * 64)):
        got, sub = lines["queries answered"].split(" submitted")[0].split(" / ")
        assert int(got) == int(sub) == n, lines["queries answered"]
    assert "on 1 device(s)" in first["device map"], first["device map"]
    assert first["supervision"] == "restarts=0 quarantined=[]", first["supervision"]
    seq = first["durability"].split()[0]
    assert seq == f"checkpoint_seq={batches - 1}" and "'failed': 0" in first["durability"], \
        first["durability"]
    assert second["recovered"].startswith(f"{seq} replayed=0 batches"), second["recovered"]
    store = paper_pipeline_config(dim=384, k=150, store_depth=64, store_dtype="int8").store
    assert int(first["store bytes/dev"]) * 2 == docstore.memory_bytes(store), \
        first["store bytes/dev"]
    print(f"  launcher: every query answered, one card, {seq}, the second run recovered "
          f"from it ({second['recovered']}); store bytes/dev x 2 = a k=150 store; cache "
          f"{first['serving cache']}; hot tier {first['hot tier']} (no query repeats)")


# -------------------------------------------------------------- comparison
def comparison_methods(d: int) -> dict:
    """name -> (Method, its config) at the settings the tables compare the
    methods at: ``benchmarks/common.py::default_methods`` and table 14's
    two-stage config (store depth 16, nprobe 16)."""
    cfg = paper_pipeline_config(dim=d, k=150, capacity=100, update_interval=256, alpha=0.1)
    cfg2 = paper_pipeline_config(dim=d, k=150, capacity=100, update_interval=256,
                                 alpha=0.1, store_depth=16)
    ivf = index_lib.IVFPQConfig(capacity=2048, dim=d, nlist=32, m=8, nprobe=8)
    ms = [(baselines.make_static_rag(d, capacity=1024), None),
          (baselines.make_full_rebuild(d, buffer_size=1024, k=100, rebuild_interval=256),
           None),
          (baselines.make_reservoir(d, k=256), None),
          (baselines.make_heap_only(d, n_anchors=512, capacity=100), None),
          (baselines.make_ivfpq(d, capacity=ivf.capacity, nlist=ivf.nlist, m=ivf.m,
                                nprobe=ivf.nprobe), ivf),
          (baselines.make_sakr(d, k=100, capacity=100), None),
          (baselines.make_streaming_rag(cfg), cfg),
          (baselines.make_streaming_rag_two_stage(cfg2, nprobe=CMP_NPROBE), cfg2)]
    return {m.name: (m, c) for m, c in ms}


def comparison_launches(name: str, ingests: int, rounds: int) -> dict[str, int]:
    """The kernel launches a method's run must make: mips once a round over
    a flat index (the baselines' and the prototype-only pipelines'), serve
    once a round two-stage, admit and heavy_hitter once a batch through the
    pipeline, heavy_hitter once a batch for heap-only; IVF-PQ none."""
    want = {n: 0 for n in counts.COUNTS}
    if name in ("static_rag", "full_rebuild", "reservoir", "heap_only", "sakr",
                "streaming_rag"):
        want["mips"] = rounds
    if name == "streaming_rag_2stage":
        want["serve"] = rounds
    if name in ("heap_only", "sakr", "streaming_rag", "streaming_rag_2stage"):
        want["heavy_hitter"] = ingests
    if name in ("sakr", "streaming_rag", "streaming_rag_2stage"):
        want["admit"] = ingests
    return want


def plain_method_answer(name: str, cfg, st, q):
    """The method's answer on its state through the plain versions (IVF-PQ,
    plain PyTorch on both devices, on the CPU)."""
    if name == "ivfpq_incremental":
        host = st.index._replace(**{f: getattr(st.index, f).cpu()
                                    for f in ("coarse", "codebooks", "codes", "cell",
                                              "ids", "valid")})
        return index_lib.ivfpq_search(cfg, host, q.cpu(), TOPK)
    qn = l2_normalize_queries(q)
    if name == "streaming_rag_2stage":
        scales = st.store.scales if st.store.embs.dtype == torch.int8 else None
        s_p, pos, routes = serve_topk_ref(qn, qn, st.index.vectors, st.index.valid,
                                          st.route_labels, st.store.embs,
                                          docstore.live_mask(st.store), TOPK, CMP_NPROBE,
                                          scales)
        return stages.decode_rerank(st.store.ids, routes, s_p, pos, cfg.store_depth,
                                    CMP_NPROBE)[:3]
    s_p, rows = mips_topk_ref(qn, st.index.vectors, st.index.valid, TOPK)
    return s_p, rows, st.index.ids[rows.long()]


def recall_ndcg(qv, doc_ids, V, T, o_ids, o_sc, k=TOPK) -> tuple[float, float]:
    """Recall@k (topic coverage against the exact oracle's top-k) and
    nDCG@k (graded relevance max(cos, 0) over the oracle's ideal DCG), as
    the repo's tables define them."""
    N = len(T)
    rec, rels = [], np.zeros((len(qv), k))
    for i in range(len(qv)):
        o_t = {t for t in T[o_ids[i]] if t >= 0}
        got = [int(d) for d in doc_ids[i] if 0 <= d < N]
        rec.append(len(o_t & {T[d] for d in got if T[d] >= 0}) / max(len(o_t), 1))
        for j, d in enumerate(doc_ids[i][:k]):
            if 0 <= d < N:
                rels[i, j] = float(qv[i] @ V[int(d)])
    disc = 1.0 / np.log2(np.arange(2, k + 2))
    dcg = np.sum(np.maximum(rels, 0.0) * disc, axis=1)
    idcg = np.sum(np.maximum(o_sc, 0.0) * disc, axis=1)
    return float(np.mean(rec)), float(np.mean(dcg / np.maximum(idcg, 1e-9)))


def qa_run(method, d: int) -> dict:
    """Table 13's protocol on the card: a fact stream over the BTC-like
    stream, warmup then QA_BATCHES batches, QA_QUESTIONS questions asked
    one at a time, summaries of the busiest topics."""
    fs = FactStream(make_stream("btc", dim=d, seed=SEED), n_entities=QA_ENTITIES, seed=SEED)
    warm = fs.next_batch(QA_BATCH)
    st = method.init(SEED, warm["embedding"], device="cuda")
    st = method.ingest(st, warm["embedding"], warm["doc_id"])
    for _ in range(QA_BATCHES):
        b = fs.next_batch(QA_BATCH)
        st = method.ingest(st, b["embedding"], b["doc_id"])
    qs = fs.qa_queries(QA_QUESTIONS)
    assert len(qs) == QA_QUESTIONS, len(qs)
    em, f1, rl = [], [], []
    for q in qs:
        ids = method.query(st, q["embedding"][None], TOPK)[2].cpu().numpy()
        assert ids.shape == (1, TOPK) and (ids >= 0).any(), f"{q['question']} unanswered"
        pred = fs.read(q, ids)
        em.append(exact_match(pred, q["answer"]))
        f1.append(token_f1(f"value is {pred}", f"value is {q['answer']}"))
    for t in sorted({fs.entity_topic[q["entity"]] for q in qs})[:QA_TOPICS]:
        qv = (fs.base.means[t] / np.linalg.norm(fs.base.means[t])).astype(np.float32)
        ref = fs.summary_reference(int(t))
        if ref:
            rl.append(rouge_l(fs.summarize(int(t), method.query(st, qv[None], TOPK)[2]
                                           .cpu().numpy()), ref))
    return dict(EM=float(np.mean(em)), F1=float(np.mean(f1)),
                ROUGE_L=float(np.mean(rl)) if rl else 0.0, questions=len(qs))


def phase_comparison():
    """7. The paper's comparison path: the eight methods at the tables'
    settings, d = 384, over one replayed stream; launch counts per method;
    answers, admit and heavy-hitter calls held against the plain versions;
    Recall@10 / nDCG@10 against an exact oracle; table 13's QA; the
    retrieval bound on the streaming method's final state."""
    from repro_torch.kernels.heavy_hitter import ops as hh_ops

    d = CMP_DIM
    stream = make_stream("nyt", dim=d, seed=SEED)
    warm = [stream.next_batch(BATCH) for _ in range(CMP_WARM)]
    batches, rounds = [], []
    for i in range(CMP_BATCHES):
        batches.append(stream.next_batch(BATCH))
        if (i + 1) % CMP_ROUND_EVERY == 0:
            rounds.append(stream.queries(CMP_QUERIES)["embedding"])
    arc = warm + batches
    V_all = np.concatenate([b["embedding"] for b in arc])
    T_all = np.concatenate([b["topic"] for b in arc])
    assert np.array_equal(np.concatenate([b["doc_id"] for b in arc]), np.arange(len(T_all)))
    # the exact oracle of each round over every document streamed before it
    oracle, V_dev = [], torch.from_numpy(V_all).cuda()
    for r, q in enumerate(rounds):
        n = (CMP_WARM + (r + 1) * CMP_ROUND_EVERY) * BATCH
        o_sc, o_ids = stable_topk(torch.from_numpy(q).cuda() @ V_dev[:n].T, TOPK)
        oracle.append((n, o_ids.cpu().numpy(), o_sc.cpu().numpy()))
    warm_x = np.concatenate([b["embedding"] for b in warm])
    ingests = CMP_WARM + CMP_BATCHES
    print(f"comparison path: d={d}, {CMP_WARM} warmup + {CMP_BATCHES} batches of {BATCH} "
          f"(NYT-like), a round of {CMP_QUERIES} queries every {CMP_ROUND_EVERY} batches, "
          f"top-{TOPK}")
    chk_a, chk_h = Check("admit"), Check("hh")
    states = {}
    for name, (m, cfg) in comparison_methods(d).items():
        admits, hhs = [], []
        torch.cuda.synchronize()
        counts.reset_all()
        with recorded(stages, "admit_op", admits), recorded(hh_ops, "update_batch", hhs):
            st = m.init(SEED, warm_x, device="cuda")
            for b in warm:
                st = m.ingest(st, b["embedding"], b["doc_id"])
            ingest_ms, query_ms, outs = [], [], []
            for i, b in enumerate(batches):
                torch.cuda.synchronize()
                t = time.perf_counter()
                st = m.ingest(st, b["embedding"], b["doc_id"])
                torch.cuda.synchronize()
                ingest_ms.append((time.perf_counter() - t) * 1e3)
                if (i + 1) % CMP_ROUND_EVERY == 0:
                    q = torch.from_numpy(rounds[len(outs)]).cuda()
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    out = m.query(st, q, TOPK)
                    torch.cuda.synchronize()
                    query_ms.append((time.perf_counter() - t) * 1e3)
                    outs.append(out)
        torch.cuda.synchronize()
        launches = counts.snapshot()
        want = comparison_launches(name, ingests, len(rounds))
        got = {n: c["kernel"] for n, c in launches.items()}
        assert got == want, (name, got, want)
        assert all(c["plain"] == 0 for c in launches.values()), (name, launches)
        # the last round against the same state through the plain versions
        chk = Check(name[:9])
        held_answers(tuple(a.cpu() for a in outs[-1]),
                     tuple(a.cpu() for a in plain_method_answer(name, cfg, st, q)),
                     "last round", chk)
        chk.done(f"{name}: last round vs plain")
        for a, kw, out in admits:
            x, _, cent, alpha, _ = a
            hold_admit(out, admit_ref(*a, **kw), x, cent, alpha, kw["store_dtype"], chk_a)
        if name in ("heap_only", "sakr"):
            for i, (a, _, out) in enumerate(hhs):
                hh_hold(out, update_batch_ref(*a), f"{name} call {i}", chk_h)
        rec, nd = zip(*(recall_ndcg(rounds[r], o[2].cpu().numpy(), V_all[:n], T_all[:n],
                                    o_ids, o_sc)
                        for r, (o, (n, o_ids, o_sc)) in enumerate(zip(outs, oracle))))
        shown = {n: c for n, c in got.items() if c}
        print(f"  {name:21s} ingest {np.median(ingest_ms):8.3f} ms/batch (median; max "
              f"{max(ingest_ms):.3f}), query {np.median(query_ms):.3f} ms/round, memory "
              f"{m.memory_bytes() / 1e6:.3f} MB, Recall@10 {np.mean(rec):.4f}, nDCG@10 "
              f"{np.mean(nd):.4f}; launches {shown or 'none'}; admit calls {len(admits)}, "
              f"heavy_hitter calls {len(hhs)}")
        states[name] = (st, q)
        del admits, hhs
    chk_a.done("sakr + streaming + 2-stage ingest")
    chk_h.done("heap_only + sakr ingest")
    print("  full_rebuild rebuilds every batch (interval 256 = one batch): its ingest ms "
          "is k-means++ (100 sequential picks) and 3 Lloyd rounds over the 1024-row buffer")

    # the retrieval bound on the streaming method's final state: K_t the
    # index's valid prototypes, each document labelled by its nearest one
    st, q = states["streaming_rag"]
    protos, valid = st.index.vectors, st.index.valid
    sims = torch.where(valid[None], l2_normalize(V_dev) @ l2_normalize(protos).T, NEG_INF)
    rep = theory.check_bound(q, V_dev, protos, torch.argmax(sims, dim=1), valid)
    print(f"  bound (streaming_rag, {int(valid.sum())} prototypes, {len(V_all)} docs, last "
          f"round): R* {float(rep.r_star):.4f}, R(K_t) {float(rep.r_proto):.4f}, Δ "
          f"{float(rep.delta):.4f}; R* - √Δ {float(rep.bound_sqrt):.4f} holds "
          f"{bool(rep.holds_sqrt)}; R* - Δ {float(rep.bound_linear):.4f} holds "
          f"{bool(rep.holds_linear)}")
    del states

    # table 13: static (capacity 1024) against streaming
    qa_cfg = paper_pipeline_config(dim=d, k=150, capacity=100, update_interval=128,
                                   alpha=0.1)
    for m in (baselines.make_static_rag(d, capacity=1024),
              baselines.make_streaming_rag(qa_cfg)):
        t = time.perf_counter()
        r = qa_run(m, d)
        print(f"  QA {m.name:13s} EM {r['EM']:.4f} F1 {r['F1']:.4f} ROUGE-L "
              f"{r['ROUGE_L']:.4f} over {r['questions']} questions, all answered "
              f"({time.perf_counter() - t:.1f} s)")
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- training
def train_batch(arch, B: int, rng, key: int) -> dict:
    """A seeded train batch of B rows on the card: Zipf ids (p ~ 1/r^1.2),
    for histories a valid prefix of length uniform in [1, S] (padding at
    row 0), labels in {0, 1}, and the key the losses draw from."""
    labels = torch.from_numpy(rng.integers(0, 2, B).astype(np.float32)).cuda()
    if hasattr(arch.cfg, "n_fields"):
        f = zipf_ids(rng, arch.cfg.rows_per_field, (B, arch.cfg.n_fields))
        return {"fields": torch.from_numpy(f).cuda(), "labels": labels}
    S, n = arch.hist_len, arch.cfg.n_items
    mask = np.arange(S)[None, :] < rng.integers(1, S + 1, (B, 1))
    return {"hist": torch.from_numpy(np.where(mask, zipf_ids(rng, n, (B, S)), 0)
                                     .astype(np.int32)).cuda(),
            "hist_mask": torch.from_numpy(mask).cuda(),
            "target": torch.from_numpy(zipf_ids(rng, n, (B,))).cuda(),
            "labels": labels,
            "rng": torch.tensor([SEED, key], dtype=torch.uint32, device="cuda")}


def check_bag_backward(table, idx, seg, bags, w, grad, mode, chk: Check,
                       weights_grad=False):
    """The kernel twice (bit-equal) against the plain version on the card:
    each element within 1e-5 of the sum of its own terms' magnitudes (the
    plain version on |table|, |grad|, |w|) + 1e-6, the sums taken in
    another order; a bf16 gradient, the kernel's f32 sum rounded once,
    within half a bf16 ulp more of the plain f32 sum (a row whose terms
    cancel can differ by more than one bf16 ulp of its small sum after
    rounding); d_w within rtol 1e-5 + 1e-5 of its terms' magnitudes +
    1e-6; rows no entry touches exactly zero."""
    got_t, got_w = embedding_bag_backward_cuda(table, idx, seg, bags, grad, w, mode,
                                               weights_grad)
    again_t, again_w = embedding_bag_backward_cuda(table, idx, seg, bags, grad, w, mode,
                                                   weights_grad)
    t32 = table.float()
    want_t, want_w = embedding_bag_backward_ref(t32, idx, seg, bags, grad, w, mode,
                                                weights_grad)
    mag_t, mag_w = embedding_bag_backward_ref(t32.abs(), idx, seg, bags, grad.abs(),
                                              None if w is None else w.abs(), mode,
                                              weights_grad)
    torch.cuda.synchronize()
    what = f"{mode} d{table.shape[1]} {table.dtype} L={idx.numel()}"
    if not (torch.equal(got_t, again_t) and (got_w is None or torch.equal(got_w, again_w))):
        chk.fail.append(f"{what}: two calls differ")
    tol = 1e-5 * mag_t + ATOL
    if table.dtype == torch.bfloat16:   # its f32 sum rounded once: half a bf16 ulp more
        got32 = got_t.float()
        tol = tol + torch.maximum(got32.abs(), want_t.abs()) * 2.0 ** -8
    else:
        got32 = got_t
    bad = (got32 - want_t).abs() > tol
    chk.err = max(chk.err, max_err(got32, want_t))
    if int(bad.sum()):
        i = int(torch.argmax(((got32 - want_t).abs() - tol).flatten()))
        chk.fail.append(f"{what}: {int(bad.sum())} d_table values off (worst: kernel "
                        f"{float(got32.flatten()[i]):.6g}, plain {float(want_t.flatten()[i]):.6g}, "
                        f"terms' magnitude {float(mag_t.flatten()[i]):.6g})")
    if weights_grad:
        chk.err = max(chk.err, max_err(got_w, want_w))
        if bool(((got_w - want_w).abs() > RTOL * want_w.abs() + 1e-5 * mag_w + ATOL).any()):
            chk.fail.append(f"{what}: d_w off")
    touched = torch.zeros(table.shape[0], dtype=torch.bool, device="cuda")
    touched[idx.long()] = True
    if not bool((got_t[~touched] == 0).all()):
        chk.fail.append(f"{what}: an untouched row is not zero")
    del want_t, mag_t, again_t


def bag_backward_bound(table, idx, seg, bags, w, weights_grad=False):
    """Bytes: the dense d_table written once, grad_out and each entry's
    (index, segment, weight) read once; with d_w, each distinct row read
    and d_w written."""
    V, d = table.shape
    L, es = idx.numel(), table.element_size()
    nbytes = (V * d * es + bags * d * 4
              + L * (idx.element_size() + seg.element_size() + (4 if w is not None else 0)))
    if weights_grad:
        nbytes += int(torch.unique(idx).numel()) * d * es + L * 4
    return bound(3.0 * L * d, nbytes)


def time_bag_backward(table, idx, seg, bags, w, grad, mode):
    """Device ms of the kernel's call (its sort, counts and dense pass
    included), a stable torch.sort of the ids (the library yardstick of
    the kernel's sort), plain, library (autograd of
    F.embedding_bag(..., per_sample_weights=w) + divide: the backward
    alone, timed, never called by the port) and the bound."""
    ms, host = cuda_ms(lambda: embedding_bag_backward_cuda(table, idx, seg, bags, grad, w,
                                                           mode))
    sort_ms, _ = cuda_ms(lambda: torch.sort(idx, stable=True))
    plain, plain_how = device_ms(lambda: embedding_bag_backward_ref(table, idx, seg, bags,
                                                                    grad, w, mode), iters=5)
    offsets = torch.searchsorted(seg, torch.arange(bags, device="cuda", dtype=seg.dtype),
                                 out_int32=True)
    cnt = torch.diff(offsets, append=torch.tensor([idx.numel()], device="cuda",
                                                  dtype=torch.int32))
    denom = torch.clamp(cnt.float(), min=1.0)[:, None]
    tbl = table.detach().clone().requires_grad_(True)
    out = torch.nn.functional.embedding_bag(idx, tbl, offsets, mode="sum",
                                            per_sample_weights=w) / denom
    lib_err = max_err(torch.autograd.grad(out, tbl, grad, retain_graph=True)[0],
                      embedding_bag_backward_ref(table, idx, seg, bags, grad, w, mode)[0])
    lib, lib_how = device_ms(lambda: torch.autograd.grad(out, tbl, grad, retain_graph=True))
    b_ms, b_by = bag_backward_bound(table, idx, seg, bags, w)
    print(f"  bag_backward at MIND's train shape: L={idx.numel()} bags={bags} V={table.shape[0]}"
          f" d={table.shape[1]}: {ms:.4f} ms device ({host:.4f} ms a call from the host; "
          f"torch.sort of its ids {sort_ms:.4f} ms), plain {plain:.4f} ms ({plain_how}), "
          f"library {lib:.4f} ms (autograd of F.embedding_bag + divide, the backward alone; "
          f"{lib_how}; max|d| vs plain {lib_err:.3g}), bound {b_ms:.4f} ms ({b_by})")
    del out, tbl
    return dict(ms=ms, host_ms=host, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                bound_by=b_by, sort_ms=sort_ms)


def check_gather_backward(table, ids, grad, chk: Check):
    """The gather's backward twice (bit-equal) against its plain version on
    the card: each element within 1e-5 of the sum of its own terms'
    magnitudes + 1e-6; rows no id touches exactly zero."""
    got = gather_backward_cuda(table, ids, grad)
    again = gather_backward_cuda(table, ids, grad)
    want = gather_backward_ref(table, ids, grad)
    mag = gather_backward_ref(table, ids, grad.abs())
    torch.cuda.synchronize()
    what = f"ids {tuple(ids.shape)} {ids.dtype}"
    if not torch.equal(got, again):
        chk.fail.append(f"{what}: two calls differ")
    chk.err = max(chk.err, max_err(got, want))
    bad = int(((got - want).abs() > 1e-5 * mag + ATOL).sum())
    if bad:
        chk.fail.append(f"{what}: {bad} values off")
    touched = torch.zeros(table.shape[0], dtype=torch.bool, device="cuda")
    touched[ids.reshape(-1).long()] = True
    if not bool((got[~touched] == 0).all()):
        chk.fail.append(f"{what}: an untouched row is not zero")


def time_gather_backward(table, ids, grad):
    """Device ms of the gather's backward (its sort and dense pass
    included), plain (``index_add_``), library (PyTorch's own backward of
    ``table[ids]``, timed only) and the bound: the dense gradient written,
    grad_out and the ids read once."""
    ms, host = cuda_ms(lambda: gather_backward_cuda(table, ids, grad))
    plain, plain_how = device_ms(lambda: gather_backward_ref(table, ids, grad), iters=5)
    tbl = table.detach().clone().requires_grad_(True)
    out = tbl[ids.long()]
    lib, lib_how = device_ms(lambda: torch.autograd.grad(out, tbl, grad, retain_graph=True),
                             iters=2)
    V, d = table.shape
    b_ms, b_by = bound(float(ids.numel() * d), V * d * table.element_size()
                       + grad.numel() * 4 + ids.numel() * ids.element_size())
    print(f"  gather_backward at MIND's history gather: ids {tuple(ids.shape)} into "
          f"{V} x {d}: {ms:.4f} ms device ({host:.4f} ms a call from the host), plain "
          f"{plain:.4f} ms ({plain_how}), library {lib:.4f} ms (PyTorch's backward of "
          f"table[ids]; {lib_how}), bound {b_ms:.4f} ms ({b_by})")
    del out, tbl
    return dict(ms=ms, host_ms=host, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                bound_by=b_by)


@contextlib.contextmanager
def train_route(kernel: bool, seen: list):
    """MIND's profile bag and its row gathers as autograd nodes whose
    backward is the kernels (``kernel``) or the plain versions, on the
    card; each call's inputs and output gradient are recorded in ``seen``
    as (kind, inputs, {"grad": ...})."""
    saved = recsys.embedding_bag_sorted, recsys._rows

    def record(out, kind, inputs):
        rec = {}
        seen.append((kind, inputs, rec))
        if out.requires_grad:
            out.register_hook(lambda g: rec.__setitem__("grad", g))
        return out

    def bag(table, idx, seg, bags, w, mode):
        return record(bag_ops.bag_apply(table, idx, seg, bags, w, mode, True, kernel),
                      "bag", (idx, seg, bags, w, mode))

    def rows(table, ids):
        return record(bag_ops.gather_apply(table, ids, kernel), "gather", (ids,))

    recsys.embedding_bag_sorted, recsys._rows = bag, rows
    try:
        yield
    finally:
        recsys.embedding_bag_sorted, recsys._rows = saved


def hold_train_step(arch, state, batch):
    """One MIND train step through the bag and gather-backward kernels
    against the same step through their plain versions, on the card, from
    the same state and draws: gradients within rtol 1e-5 and an atol of
    1e-6 + 1e-5 x the magnitude of the element's own terms (item_emb: the
    bag's and the row gathers' terms, summed in the kernels' order, not
    index_add_'s); params after ``apply`` within rtol 1e-5 / atol 1e-6."""
    chk = Check("mind-step")
    seen_k, seen_p = [], []
    counts.reset_all()
    with train_route(True, seen_k):
        loss_k, _, g_k = arch.loss_and_grads(state.params, batch)
    with train_route(False, seen_p):
        loss_p, _, g_p = arch.loss_and_grads(state.params, batch)
    torch.cuda.synchronize()
    snap = counts.snapshot()
    assert snap["bag"] == snap["bag_backward"] == {"kernel": 1, "plain": 1}, snap
    assert snap["gather_backward"] == {"kernel": MIND_GATHERS, "plain": MIND_GATHERS}, snap
    table = state.params["item_emb"]
    mag = torch.zeros_like(table)
    for kind, inputs, rec in seen_p:   # the item_emb gradient's terms, in magnitude
        if kind == "bag":
            idx, seg, bags, w, mode = inputs
            mag += embedding_bag_backward_ref(table.abs(), idx, seg, bags, rec["grad"].abs(),
                                              w.abs(), mode)[0]
        else:
            mag += gather_backward_ref(table, inputs[0], rec["grad"].abs())
    chk.floats("loss", loss_k[None], loss_p[None])
    for name in g_p:
        k, p = g_k[name], g_p[name]
        atol = ATOL + (1e-5 * mag if name == "item_emb" else 0.0)
        bad = (k - p).abs() > RTOL * p.abs() + atol
        chk.err = max(chk.err, max_err(k, p))
        if int(bad.sum()):
            chk.fail.append(f"grad {name}: {int(bad.sum())} values off")
    new_k = opt_lib.apply(arch.optimizer, state.params, g_k, state.opt)[0]
    new_p = opt_lib.apply(arch.optimizer, state.params, g_p, state.opt)[0]
    for name in new_p:
        chk.floats(f"params {name} after apply", new_k[name], new_p[name])
    chk.done("kernel step vs plain step")
    return g_k


def host_step_ms(fn) -> float:
    """Host ms of one warm call of ``fn`` between synchronizes."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3


def profiled_launches(fn) -> tuple[float, list[tuple[str, float]]]:
    """One warm call of ``fn`` under torch.profiler: its host-clock ms and
    each device launch (name, device ms) in launch order. The profiler can
    drop a session's first kernels (seen in this script's own process),
    so ``fn`` runs twice in the session, each call behind a spinning
    kernel, and the launches after the last spin are the second call's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for spin in (SPIN_CYCLES // 20, SPIN_CYCLES // 100):
            torch.cuda._sleep(spin)
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
    evs = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    last_spin = max((i for i, e in enumerate(evs) if "spin" in e.name), default=-1)
    return wall, [(e.name, (e.device_time_total if hasattr(e, "device_time_total")
                            else e.cuda_time_total) / 1e3) for e in evs[last_spin + 1:]]


# bag_backward.cu's launches by the part of the design each does
BWD_PARTS = (("hist_kernel", "sort"), ("scan_kernel", "sort"), ("scatter_kernel", "sort"),
             ("Memset", "clear"), ("scale_kernel", "counts"),
             ("chunk_kernel", "offsets + chunk sums + hot-row partials"),
             ("group_kernel", "level 2"), ("finish_kernel", "spanning rows"),
             ("dense_kernel", "dense pass"), ("dw_kernel", "d_w"))


def backward_split(what: str, fn) -> dict[str, float]:
    """Print one warm call of a backward entry by launch (torch.profiler)
    and by part: sort, clear, counts, offsets + chunk sums + hot-row
    partials, level 2, spanning rows, dense pass; fails on a launch that
    is none of bag_backward.cu's (a library sort or fill)."""
    _, launches = profiled_launches(fn)
    parts: dict[str, float] = {}
    for name, ms in launches:
        part = next((p for k, p in BWD_PARTS if k.lower() in name.lower()), None)
        assert part is not None, f"{what}: a launch outside bag_backward.cu: {name}"
        parts[part] = parts.get(part, 0.0) + ms
    print(f"  {what} by launch (torch.profiler, one warm call): "
          + ", ".join(f"{next(p for k, p in BWD_PARTS if k.lower() in n.lower())} {ms:.4f}"
                      for n, ms in launches))
    print(f"  {what} by part: " + ", ".join(f"{p} {ms:.4f}" for p, ms in parts.items())
          + f"; sum {sum(parts.values()):.4f} ms over {len(launches)} launches")
    return parts


def kernels_by_name(launches) -> list[tuple[str, float, int]]:
    """(name, device ms, launches) per kernel name (its first 60
    characters), the most device time first."""
    by_name: dict[str, list] = {}
    for name, ms in launches:
        rec = by_name.setdefault(name[:60], [0.0, 0])
        rec[0] += ms
        rec[1] += 1
    return sorted(((n, ms, k) for n, (ms, k) in by_name.items()), key=lambda r: -r[1])


def step_breakdown(fn, top: int = 8):
    """One warm call of ``fn`` under torch.profiler: the device time by
    kernel name (the top ``top``), their sum against the host clock."""
    wall, launches = profiled_launches(fn)
    rows = kernels_by_name(launches)
    total = sum(ms for _, ms, _ in rows)
    # unclipped: kernel time past the wall (overlapping streams, an event
    # counted twice) shows as a negative share and is flagged
    idle = 1 - total / wall
    flag = "; KERNEL TIME EXCEEDS THE WALL: the count is suspect" if idle < 0 else ""
    print(f"  one mind train step under torch.profiler: {wall:.2f} ms host clock, "
          f"{total:.2f} ms of kernels ({len(launches)} launches; "
          f"device idle share {idle:.3f}{flag}); by device time:")
    for name, ms, n in rows[:top]:
        print(f"    {ms:9.3f} ms  x{n:4d}  {name}")


def train_a_few(name: str):
    """``name`` at full width, a few train steps at its OTHER_TRAIN_BATCH
    rows under a cap of TRAIN_MEMORY_FRACTION of the card's memory (an
    OutOfMemoryError under the cap fails the run); a cut printed with its
    reason."""
    arch = get_arch(name)
    rng = np.random.default_rng(SEED)
    state = arch.init_train_state(SEED)
    step = arch.step("train_batch").fn
    B = OTHER_TRAIN_BATCH[name]
    cap_gb = TRAIN_MEMORY_FRACTION * torch.cuda.get_device_properties(0).total_memory / 1e9
    batches = [train_batch(arch, B, rng, i + 1) for i in range(OTHER_TRAIN_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts.reset_all()
    ms, losses = [], []
    torch.cuda.set_per_process_memory_fraction(TRAIN_MEMORY_FRACTION)
    try:
        for b in batches:
            t = time.perf_counter()
            state, m = step(state, b)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
            losses.append(float(m["loss"]))
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
    snap = counts.snapshot()
    assert all(c["plain"] == 0 for c in snap.values()), (name, snap)
    assert all(c["kernel"] == 0 for n, c in snap.items() if n != "gather_backward"), snap
    assert all(np.isfinite(losses)) and int(state.opt.step) == OTHER_TRAIN_STEPS, losses
    peak = torch.cuda.max_memory_allocated() / 1e9
    reason = f"; {BERT4REC_TRAIN_CUT}" if B < TRAIN_BATCH else ""
    print(f"  {name:8s} train B={B}: {OTHER_TRAIN_STEPS} steps, ms "
          f"{', '.join(f'{x:.1f}' for x in ms)} (host clock around synchronize(); the first "
          f"cold), losses {', '.join(f'{x:.4f}' for x in losses)}, peak {peak:.2f} GB under a "
          f"{cap_gb:.1f} GB cap ({TRAIN_MEMORY_FRACTION} of the card), gather_backward "
          f"launches {snap['gather_backward']['kernel']}{reason}")
    del state, batches
    torch.cuda.empty_cache()


def phase_training(results):
    """8. The training path: the bag backward kernel against its plain
    version at MIND's train shape and edge cases; MIND at full width
    through ``Trainer.fit`` (counts reset just before), one step held
    against the plain bag step, a resume; FM, DIEN and BERT4Rec a few
    steps; the train launcher in its own process, twice."""
    arch = get_arch("mind")
    rng = np.random.default_rng(SEED)
    state = arch.init_train_state(SEED)
    batches = [train_batch(arch, TRAIN_BATCH, rng, i) for i in range(TRAIN_STEPS + 2)]
    table = state.params["item_emb"]
    print(f"training path: MIND {arch.cfg}, optimizer {arch.optimizer}; train batch "
          f"{TRAIN_BATCH}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 3)
    idx, seg, w, B = mind_bag_inputs(batches[0])
    grad = torch.randn((B, table.shape[1]), generator=gen, device="cuda") * 1e-4
    chk = Check("bag_bwd")
    for mode in ("mean", "sum"):
        check_bag_backward(table, idx, seg, B, w, grad, mode, chk)
        check_bag_backward(table, idx, seg, B, None, grad, mode, chk)       # weights=None
    check_bag_backward(table, torch.zeros_like(idx), seg, B, torch.ones_like(w), grad,
                       "mean", chk)                         # the launcher's batch: all on row 0
    check_bag_backward(table.to(torch.bfloat16), idx, seg, B, w, grad, "mean", chk)
    check_bag_backward(table, idx.long(), seg.long(), B, w, grad, "mean", chk)   # int64 ids
    check_bag_backward(table, idx, seg, B, w, grad, "mean", chk, weights_grad=True)
    t18 = torch.randn((table.shape[0], 18), generator=gen, device="cuda") * 0.02
    S, b18 = idx.numel() // B, min(4096, B)   # DIEN's width on 4096 of the histories
    check_bag_backward(t18, idx[: b18 * S], seg[: b18 * S], b18, w[: b18 * S],
                       torch.randn((b18, 18), generator=gen, device="cuda"), "mean", chk)
    del t18
    check_bag_backward(table, idx[:S], seg[:S], 1, w[:S], grad[:1], "mean", chk)   # B = 1
    # unsorted segments with empty bags, through the autograd node of
    # ``embedding_bag`` (the forward's sort, then the backward kernel)
    i40 = torch.randint(0, 1000, (400,), generator=gen, device="cuda", dtype=torch.int32)
    s40 = torch.randint(0, 37, (400,), generator=gen, device="cuda", dtype=torch.int32)
    w40 = torch.rand((400,), generator=gen, device="cuda")
    g40 = torch.randn((40, table.shape[1]), generator=gen, device="cuda")
    check_bag_backward(table, i40, s40, 40, w40, g40, "mean", chk)
    tl = table.detach().clone().requires_grad_(True)
    counts.reset_all()
    out = bag_ops.embedding_bag(tl, i40, s40, 40, w40, "mean")
    d_t = torch.autograd.grad(out, tl, g40)[0]
    assert counts.snapshot()["bag_backward"] == {"kernel": 1, "plain": 0}
    if not torch.equal(d_t, embedding_bag_backward_cuda(table, i40, s40, 40, g40, w40,
                                                        "mean")[0]):
        chk.fail.append("autograd through embedding_bag != the backward kernel's call")
    del tl, out, d_t
    chk.done("MIND train shape + zeros, bf16, i64, None, d_w, d18, B=1, unsorted")
    timed = time_bag_backward(table, idx, seg, B, w, grad, "mean")
    backward_split("bag_backward at MIND's train shape",
                   lambda: embedding_bag_backward_cuda(table, idx, seg, B, grad, w, "mean"))
    fwd_ms, _ = cuda_ms(lambda: embedding_bag_sorted_cuda(table, idx, seg, B, w, "mean"))
    print(f"  bag forward at the same shape: {fwd_ms:.4f} ms device")
    results["bag_backward"] = dict(max_abs_err=chk.err, **timed)
    # the row gathers' backward: MIND's history gather, the launcher's, int64
    hist = batches[0]["hist"]
    ghist = torch.randn((*hist.shape, table.shape[1]), generator=gen, device="cuda") * 1e-4
    chk = Check("gath_bwd")
    check_gather_backward(table, hist, ghist, chk)
    check_gather_backward(table, torch.zeros_like(hist), ghist, chk)
    check_gather_backward(table, hist.long(), ghist, chk)
    check_gather_backward(table, batches[0]["target"], ghist[:, 0].contiguous(), chk)
    chk.done("history, zeros, int64, target")
    results["gather_backward"] = dict(max_abs_err=chk.err,
                                      **time_gather_backward(table, hist, ghist))
    backward_split("gather_backward at the history gather",
                   lambda: gather_backward_cuda(table, hist, ghist))
    # the step's four row gathers, each at its own shape: the history, the
    # target twice (attention and the sampled softmax's positive) and the
    # 512 shared negatives
    negs = torch.randint(0, table.shape[0], (512,), generator=gen, device="cuda")
    shapes = (("history", hist, ghist), ("target", batches[0]["target"], ghist[:, 0]),
              ("target again", batches[0]["target"], ghist[:, 1]),
              ("negatives", negs, ghist[:512, 2]))
    timed_gathers = []
    for what, ids, g in shapes:
        g = g.contiguous()
        ms = cuda_ms(lambda: gather_backward_cuda(table, ids, g))[0]
        line = f"{what} {tuple(ids.shape)} {ms:.4f} ms"
        if what != "history":   # the history's plain and library times are above
            plain = device_ms(lambda: gather_backward_ref(table, ids, g), iters=5)[0]
            tbl = table.detach().clone().requires_grad_(True)
            out = tbl[ids.long()]
            lib = device_ms(lambda: torch.autograd.grad(out, tbl, g, retain_graph=True),
                            iters=2)[0]
            line += f" (plain {plain:.4f} ms, library {lib:.4f} ms)"
            del out, tbl
        timed_gathers.append(line)
    print("  gather_backward, the four row gathers of a MIND step at their own shapes (plain: "
          "index_add_; library: PyTorch's backward of table[ids]): "
          + "; ".join(timed_gathers) + " device")
    del ghist

    # one step through the kernels against the plain bag step
    g_k = hold_train_step(arch, state, batches[0])
    apply_ms, apply_how = device_ms(lambda: opt_lib.apply(arch.optimizer, state.params, g_k,
                                                          state.opt), iters=5)
    print(f"  apply (AdamW over {table.numel():,} + the other leaves, plain PyTorch): "
          f"{apply_ms:.3f} ms device ({apply_how})")
    del g_k
    step = arch.make_train_step()
    ms_kernel = host_step_ms(lambda: step(state, batches[1]))
    with contextlib.ExitStack() as stack:   # the row gathers' backward by PyTorch's indexing
        stack.callback(setattr, recsys, "_rows", recsys._rows)
        recsys._rows = lambda table, ids: table[ids.long()]
        ms_torch = host_step_ms(lambda: step(state, batches[1]))
    print(f"  mind train step, the row gathers' backward by PyTorch's own indexing "
          f"backward: {ms_torch:.2f} ms; by the gather_backward kernel: {ms_kernel:.2f} ms "
          f"(host clock around synchronize(), one warm step each)")
    step_breakdown(lambda: step(state, batches[1]))
    del state
    torch.cuda.empty_cache()

    # MIND's path: Trainer.fit at full width, counts reset just before
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        tr = Trainer(arch, TrainerConfig(total_steps=TRAIN_STEPS, ckpt_dir=tmp,
                                         ckpt_interval=TRAIN_CKPT_EVERY, log_interval=1))
        state = tr.init_state(SEED)
        p0 = state.params["item_emb"].clone()
        step_ms, base = [], tr.step_fn

        def timed_step(st, b):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = base(st, b)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        tr.step_fn = timed_step
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counts.reset_all()
        t = time.perf_counter()
        state, hist = tr.fit(iter(batches[:TRAIN_STEPS]), state=state)
        fit_s = time.perf_counter() - t
        launches = counts.snapshot()
        peak = torch.cuda.max_memory_allocated() / 1e9
        print(f"  mind Trainer.fit: {TRAIN_STEPS} steps of {TRAIN_BATCH}, launches {launches}")
        assert launches["bag"]["kernel"] == launches["bag_backward"]["kernel"] == TRAIN_STEPS
        assert launches["gather_backward"]["kernel"] == MIND_GATHERS * TRAIN_STEPS, launches
        assert all(c["plain"] == 0 for c in launches.values()), "a plain version ran"
        assert all(c["kernel"] == 0 for n, c in launches.items()
                   if n not in ("bag", "bag_backward", "gather_backward")), launches
        for n in ("bag_backward", "gather_backward"):
            results[n]["launches"] = launches[n]["kernel"]
        losses = [m["loss"] for _, m in hist]
        assert [s for s, _ in hist] == list(range(1, TRAIN_STEPS + 1)) and np.all(
            np.isfinite(losses)), hist
        assert not torch.equal(state.params["item_emb"], p0), "the params did not move"
        assert tr.ckpt.all_steps() == list(range(TRAIN_CKPT_EVERY, TRAIN_STEPS + 1,
                                                 TRAIN_CKPT_EVERY)), tr.ckpt.all_steps()
        ck = os.path.join(tmp, f"step_{TRAIN_STEPS:012d}", "arrays.npz")
        ck_mb = os.path.getsize(ck) / 1e6
        t = time.perf_counter()   # one blocking save of the same state, apart
        ckpt_lib.CheckpointManager(os.path.join(tmp, "timed")).save(TRAIN_STEPS, state)
        write_ms = (time.perf_counter() - t) * 1e3
        warm = step_ms[1:]
        print(f"  mind train step: {np.median(warm):.2f} ms median (host clock around "
              f"synchronize(); steps 2..{TRAIN_STEPS}: {', '.join(f'{x:.2f}' for x in warm)}; "
              f"first {step_ms[0]:.2f}), {1e3 / np.median(warm):.2f} steps/s; fit "
              f"{fit_s:.2f} s with {TRAIN_STEPS // TRAIN_CKPT_EVERY} async checkpoints; bag "
              f"forward {fwd_ms:.4f} + backward {timed['ms']:.4f} ms device a step; apply "
              f"{apply_ms:.3f} ms; peak {peak:.2f} GB; checkpoint {ck_mb:.1f} MB, a blocking "
              f"write {write_ms:.1f} ms; losses {', '.join(f'{x:.4f}' for x in losses)}")
        del state, p0
        torch.cuda.empty_cache()
        # resume: a second trainer on the same directory goes on to TRAIN_STEPS + 2
        tr2 = Trainer(arch, TrainerConfig(total_steps=TRAIN_STEPS + 2, ckpt_dir=tmp,
                                          ckpt_interval=TRAIN_CKPT_EVERY, log_interval=1))
        state2, hist2 = tr2.fit(iter(batches[TRAIN_STEPS:]))
        assert [s for s, _ in hist2] == [TRAIN_STEPS + 1, TRAIN_STEPS + 2], hist2
        assert int(state2.opt.step) == TRAIN_STEPS + 2
        print(f"  resumed at step {TRAIN_STEPS}: steps {[s for s, _ in hist2]}, opt.step "
              f"{int(state2.opt.step)}, losses {[round(m['loss'], 4) for _, m in hist2]}")
        del state2, tr, tr2
    del batches
    torch.cuda.empty_cache()

    for name in ("fm", "dien", "bert4rec"):
        train_a_few(name)

    # the train launcher at MIND's full width, then a resume on its directory
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_launch_") as tmp:
        first = run_module("repro_torch.launch.train", [*TRAIN_LAUNCH_FLAGS, "--steps", "4",
                                                        "--ckpt-dir", tmp], root, "  train launcher")
        assert first[-1] == "final checkpoint: 4" and first[-2].startswith("step 4: loss="), first
        saved = {n: os.stat(os.path.join(tmp, n)).st_mtime_ns for n in os.listdir(tmp)}
        second = run_module("repro_torch.launch.train", [*TRAIN_LAUNCH_FLAGS, "--steps", "6",
                                                         "--ckpt-dir", tmp], root, "  train launcher")
        steps = [ln.split(":")[0] for ln in second if ln.startswith("step ")]
        after = {n: os.stat(os.path.join(tmp, n)).st_mtime_ns for n in os.listdir(tmp)}
        assert steps == ["step 6"] and second[-1] == "final checkpoint: 6", second
        assert all(after.get(n) == m for n, m in saved.items()), (saved, after)
        print("  train launcher: 4 steps, then resumed at 4 to 6 (steps 2 and 4 untouched)")


def padded_tokens(rng, B: int, S: int, vocab: int):
    """Seeded token ids [B, S] and a padding mask of lengths uniform in
    [1, S], on the card."""
    mask = np.arange(S)[None, :] < rng.integers(1, S + 1, (B, 1))
    toks = rng.integers(0, vocab, (B, S)).astype(np.int32)
    return torch.from_numpy(toks).cuda(), torch.from_numpy(mask).cuda()


def float64_twin(arch, params):
    """``arch`` and its params with float64 params and activations (its
    attention scores stay fp32, as the reference computes them): the
    yardstick of how far fp32 rounding alone moves a result."""
    cfg64 = dataclasses.replace(arch.cfg, param_dtype=torch.float64)
    if hasattr(cfg64, "act_dtype"):
        cfg64 = dataclasses.replace(cfg64, act_dtype=torch.float64)
    return type(arch)(cfg64), opt_lib.tree_map(lambda t: t.double(), params)


def conditioned(params):
    """The params with the attention projections rescaled, in place, to
    the usual fan-in, in every layer stack and the MTP block: ``init`` (as
    the reference's Builder) takes the heads axis as fan-in of wq/wk/wv
    [d, h, hd] and of MLA's wq_b/wk_b/wv_b [r, h, x], and head_dim as
    wo's [h, hd, d], so q and k come out with std ~8-28 and the scores are
    nearly one-hot; past a few layers a random model is then chaotic, and
    fp32 rounding alone moves its logits by O(1) (printed beside).
    wq/wk/wv are scaled to std 1/sqrt(d_model), wq_b to 1/sqrt(q_lora_rank),
    wk_b/wv_b to 1/sqrt(kv_lora_rank), wo to 1/sqrt(h * hd); nothing else
    changes. Returns ``params``."""
    for name in ("layers", "dense_layers", "moe_layers", "mtp_block"):
        attn = params.get(name, {}).get("attn", {})
        for leaf in ("wq", "wk", "wv", "wq_b", "wk_b", "wv_b"):
            if leaf in attn:    # [..., fan-in, h, x]: std 1/sqrt(h) -> 1/sqrt(fan-in)
                attn[leaf].mul_((attn[leaf].shape[-2] / attn[leaf].shape[-3]) ** 0.5)
        if "wo" in attn:        # [..., h, hd, d]: std 1/sqrt(hd) -> 1/sqrt(h * hd)
            attn["wo"].div_(attn["wo"].shape[-3] ** 0.5)
    return params


def embed_on_card_and_cpu(arch, params, toks, mask) -> tuple:
    """(card result, max |card - CPU|, max |card - float64|, max |CPU -
    float64|) of ``embed`` on the same params."""
    emb = arch.embed(params, toks, mask)
    on_cpu = arch.embed(opt_lib.tree_map(lambda t: t.cpu(), params), toks.cpu(), mask.cpu())
    a64, p64 = float64_twin(arch, params)
    e64 = a64.embed(p64, toks, mask)
    return (emb, max_err(emb.cpu(), on_cpu), max_err(emb.double(), e64),
            max_err(on_cpu.double(), e64.cpu()))


def phase_encoder(smi: str, fails: list):
    """9a. The paper's embedder at full width: the card against the CPU
    on the same params, an all-padding row, then 3 Trainer steps."""
    arch = get_arch("streaming-rag-embedder")
    rng = np.random.default_rng(SEED)
    params = arch.init(SEED)
    B, S = EMBED_SHAPE
    toks, mask = padded_tokens(rng, B, S, arch.cfg.vocab)
    mask[B // 2] = False                        # one all-padding row
    with torch.no_grad():
        _, ref_err, ref_64, ref_cpu_64 = embed_on_card_and_cpu(arch, params, toks, mask)
        params = conditioned(params)
        emb, err, card_64, cpu_64 = embed_on_card_and_cpu(arch, params, toks, mask)
    norms = torch.linalg.vector_norm(emb, dim=-1)
    keep = torch.arange(B, device="cuda") != B // 2
    print(f"  embedder {arch.cfg}: {sum(t.numel() for t in opt_lib.leaves(params)):,} params; "
          f"embed {B} x {S}, conditioned params: card vs CPU max |d| {err:.4g} (limit "
          f"{EMBED_TOL}), against a float64 run card {card_64:.4g}, CPU {cpu_64:.4g}; at the "
          f"init's own scale: card vs CPU {ref_err:.4g}, against float64 card {ref_64:.4g}, "
          f"CPU {ref_cpu_64:.4g}; all-padding row max |x| {float(emb[B // 2].abs().max())}, "
          f"other norms in [{float(norms[keep].min()):.6f}, {float(norms[keep].max()):.6f}]")
    if err > EMBED_TOL:
        fails.append(f"embedder: card vs CPU max |d| {err:.4g} > {EMBED_TOL}")
    assert bool((emb[B // 2] == 0).all()), "the all-padding row is not zero"
    assert bool(torch.isfinite(emb).all()) and float((norms[keep] - 1).abs().max()) < 1e-5
    with torch.no_grad():
        ms, how = device_ms(lambda: arch.embed(params, toks, mask), iters=5)
    print(f"  embedder embed {B} x {S}: {ms:.3f} ms device per batch ({how}), "
          f"{B / ms * 1e3:.0f} sequences/s [{smi}]")

    B, S = arch.shapes["train_pairs"].dim("batch"), arch.shapes["train_pairs"].dim("seq")
    batches = []
    for _ in range(ENCODER_TRAIN_STEPS):
        a, am = padded_tokens(rng, B, S, arch.cfg.vocab)
        p, pm = padded_tokens(rng, B, S, arch.cfg.vocab)
        batches.append({"anchor": a, "anchor_mask": am, "positive": p, "positive_mask": pm})
    with tempfile.TemporaryDirectory(prefix="chip_smoke_embedder_") as tmp:
        tr = Trainer(arch, TrainerConfig(total_steps=ENCODER_TRAIN_STEPS, ckpt_dir=tmp,
                                         ckpt_interval=ENCODER_TRAIN_STEPS + 1, log_interval=1))
        state = tr.init_state(SEED)
        step_ms, base = [], tr.step_fn

        def timed_step(st, b):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = base(st, b)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        tr.step_fn = timed_step
        torch.cuda.reset_peak_memory_stats()
        state, hist = tr.fit(iter(batches), state=state)
        peak = torch.cuda.max_memory_allocated() / 1e9
    losses = [m["loss"] for _, m in hist]
    assert [s for s, _ in hist] == list(range(1, ENCODER_TRAIN_STEPS + 1)) and np.all(
        np.isfinite(losses)), hist
    assert int(state.opt.step) == ENCODER_TRAIN_STEPS
    print(f"  embedder Trainer.fit: {ENCODER_TRAIN_STEPS} steps of train_pairs {B} x {S}, ms "
          f"{', '.join(f'{x:.2f}' for x in step_ms)} (host clock around synchronize(); the "
          f"first cold), losses {', '.join(f'{x:.4f}' for x in losses)}, alignment "
          f"{hist[-1][1]['alignment']:.4f}, peak {peak:.2f} GB [{smi}]")
    del params, state, batches, emb
    torch.cuda.empty_cache()


def greedy(arch, params, toks, steps: int, budget):
    """prefill, then ``steps`` greedy decode steps: (the last decode's
    logits, the tokens fed, the cache after prefill, the first token fed)."""
    lp, cache = arch.prefill(params, toks, budget=budget)
    nxt = torch.argmax(lp, -1).to(torch.int32)
    first, c0, fed = nxt, cache, []
    for _ in range(steps):
        fed.append(nxt)
        ld, cache = arch.decode_step(params, cache, nxt)
        nxt = torch.argmax(ld, -1).to(torch.int32)
    return ld, torch.cat([toks, torch.stack(fed, 1)], 1), c0, first


def decode_vs_forward(arch, params, toks, steps: int, budget) -> dict:
    """The reference's decode consistency check: the last of ``steps``
    greedy decode steps against ``hidden`` + ``logits`` over the whole
    sequence."""
    ld, seq, cache, first = greedy(arch, params, toks, steps, budget)
    pos = torch.arange(seq.shape[1], dtype=torch.int32, device="cuda").expand(seq.shape)
    h, _ = arch.hidden(params, seq, pos)
    full = arch.logits(params, h[:, -1:])[:, 0]
    ld32, full32 = ld.float(), full.float()
    top2 = torch.topk(full32, 2, dim=-1).values
    return dict(err=max_err(ld32, full32), scale=float(full32.abs().max()),
                moved=(torch.argmax(ld32, -1) != torch.argmax(full32, -1)).cpu(),
                gaps=(top2[:, 0] - top2[:, 1]).cpu(), cache=cache, first=first,
                seq_len=seq.shape[1])


def time_lm(arch, params, toks, budget, cache, first, smi: str) -> str:
    """Prefill and decode times of ``arch`` (device ms by ``device_ms``),
    and the chained decode loop on the host clock."""
    B = toks.shape[0]
    pre_ms, pre_how = device_ms(lambda: arch.prefill(params, toks, budget=budget), iters=3)
    dec_ms, dec_how = device_ms(lambda: arch.decode_step(params, cache, first), iters=10)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    greedy(arch, params, toks, 8, budget)
    loop_ms = (time.perf_counter() - t0) * 1e3
    split = []
    for what, fn in (("prefill", lambda: arch.prefill(params, toks, budget=budget)),
                     ("decode", lambda: arch.decode_step(params, cache, first))):
        wall, launches = profiled_launches(fn)
        busy = sum(ms for _, ms in launches)
        split.append(f"{what} {len(launches)} launches, {busy:.2f} ms of kernels in {wall:.2f} "
                     f"ms host (idle share {1 - busy / wall:.3f})")
    return (f"prefill {tuple(toks.shape)} {pre_ms:.2f} ms ({pre_how}), "
            f"{B * toks.shape[1] / pre_ms * 1e3:.0f} tokens/s; decode {dec_ms:.3f} ms a token "
            f"({dec_how}), {B / dec_ms * 1e3:.0f} tokens/s; prefill + 8 greedy decode steps "
            f"{loop_ms:.1f} ms host clock; torch.profiler: {'; '.join(split)}; peak "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB [{smi}]")


def hold_decode(name: str, r: dict, rel_tol: float, fails: list):
    """Max |d| within ``rel_tol`` of max |logit|; the argmax equal in
    every row, except a row whose forward top-2 gap is under that max |d|
    (a near-tie), which is printed."""
    ties = r["moved"] & (r["gaps"] <= r["err"])
    print(f"  {name}: decode vs forward over {r['seq_len']} tokens: max |d| {r['err']:.4g} "
          f"(limit {rel_tol * r['scale']:.4g}), max |logit| {r['scale']:.4g}, argmax moved in "
          f"{int(r['moved'].sum())} of {len(r['moved'])} rows ({int(ties.sum())} at near-ties), "
          f"smallest top-2 gap of the forward {float(r['gaps'].min()):.4g}")
    if bool((r["moved"] & ~ties).any()):
        fails.append(f"{name}: a row's argmax moved between decode and forward")
    if r["err"] > rel_tol * r["scale"]:
        fails.append(f"{name}: decode vs forward max |d| {r['err']:.4g}")


def cut_depth(cfg, params, n: int):
    """(config, params) of the first ``n`` layers: the dense stack first,
    then the MoE stack (views of ``params``)."""
    n_dense = min(n, cfg.first_k_dense if cfg.moe else cfg.n_layers)
    p = {k: v for k, v in params.items() if k not in ("dense_layers", "moe_layers")}
    for name, k in (("dense_layers", n_dense), ("moe_layers", n - n_dense)):
        if k:
            p[name] = opt_lib.tree_map(lambda t: t[:k], params[name])
    return dataclasses.replace(cfg, n_layers=n, first_k_dense=min(cfg.first_k_dense, n)), p


def reference_init_yardstick(arch, params, toks, depths=None) -> str:
    """fp32 vs float64 logits of the exact prefill at 2 layers and at full
    depth (or ``depths``), at the init's own scale: how chaotic the random
    model is (the float64 twin keeps the attention scores and the MoE's
    routing and combine in fp32, as the reference computes them)."""
    out = []
    for n in depths or (2, arch.cfg.n_layers):
        cfg, p = cut_depth(arch.cfg, params, n)
        cfg = dataclasses.replace(cfg, use_flash=False)
        l32 = TransformerLM(cfg).prefill(p, toks)[0]
        a64, p64 = float64_twin(TransformerLM(cfg), p)
        l64 = a64.prefill(p64, toks)[0]
        out.append(f"{n} layers {max_err(l32.double(), l64) / float(l64.abs().max()):.3g}")
        del p64, l64
    return ", ".join(out)


def phase_lms(smi: str, fails: list):
    """9b, 9c. qwen2-1.5b and h2o-danube-1.8b at full width, on
    conditioned params."""
    rng = np.random.default_rng(SEED + 1)
    arch = get_arch("qwen2-1.5b")
    B, S = QWEN_SHAPE
    budget = S + QWEN_DECODE
    toks = torch.from_numpy(rng.integers(0, arch.cfg.vocab, (B, S)).astype(np.int32)).cuda()
    cfg32 = dataclasses.replace(arch.cfg, param_dtype=torch.float32, act_dtype=torch.float32)
    arch32 = TransformerLM(cfg32, optimizer=arch.optimizer)
    params32 = arch32.init(SEED)
    print(f"  qwen2-1.5b: {sum(t.numel() for t in opt_lib.leaves(params32)):,} params, prefill "
          f"{B} x {S}, budget {budget}, {QWEN_DECODE} greedy decode steps; at the init's own "
          f"scale, the exact fp32 prefill's logits vs a float64 run, of max |logit|: "
          f"{reference_init_yardstick(arch32, params32, toks)}")
    params32 = conditioned(params32)
    params = opt_lib.tree_map(lambda t: t.to(arch.cfg.param_dtype), params32)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    r = decode_vs_forward(arch, params, toks, QWEN_DECODE, budget)
    hold_decode("qwen2-1.5b bf16", r, LM_BF16_TOL, fails)
    print(f"  qwen2-1.5b bf16: {time_lm(arch, params, toks, budget, r['cache'], r['first'], smi)}")
    del r, params
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    r = decode_vs_forward(arch32, params32, toks, QWEN_DECODE, budget)
    hold_decode("qwen2-1.5b fp32", r, LM_FP32_TOL, fails)
    print(f"  qwen2-1.5b fp32: {time_lm(arch32, params32, toks, budget, r['cache'], r['first'], smi)}")
    del r
    exact = TransformerLM(dataclasses.replace(cfg32, use_flash=False))
    lf, cf = arch32.prefill(params32, toks, budget=budget)
    le, ce = exact.prefill(params32, toks, budget=budget)
    errs = {n: (max_err(a.float(), b.float()), float(b.float().abs().max()))
            for n, a, b in (("logits", lf, le), ("k", cf["k"], ce["k"]), ("v", cf["v"], ce["v"]))}
    a64, p64 = float64_twin(exact, params32)
    l64, c64 = a64.prefill(p64, toks, budget=budget)
    del p64
    yard = {n: max_err(b.double(), c) for n, b, c in
            (("logits", le, l64), ("k", ce["k"], c64["k"]), ("v", ce["v"], c64["v"]))}
    print("  qwen2-1.5b fp32 prefill, flash vs q-chunked exact: "
          + ", ".join(f"{n} max |d| {e:.4g} (limit {FLASH_EXACT_TOL * m:.4g}; the exact path "
                      f"vs a float64 run {yard[n]:.4g})" for n, (e, m) in errs.items()))
    fails.extend(f"qwen2-1.5b flash vs exact {n}: max |d| {e:.4g}"
                 for n, (e, m) in errs.items() if e > FLASH_EXACT_TOL * m)
    assert torch.equal(cf["pos"], ce["pos"]) and torch.equal(cf["len"], ce["len"])
    del params32, lf, cf, le, ce, l64, c64
    torch.cuda.empty_cache()

    arch = get_arch("h2o-danube-1.8b")
    B, S = DANUBE_SHAPE
    W = arch.cfg.window
    torch.cuda.reset_peak_memory_stats()
    params = conditioned(arch.init(SEED))
    toks = torch.from_numpy(rng.integers(0, arch.cfg.vocab, (B, S)).astype(np.int32)).cuda()
    print(f"  h2o-danube-1.8b: {sum(t.numel() for t in opt_lib.leaves(params)):,} params "
          f"({arch.cfg.param_dtype}), window {W}, prefill {B} x {S} (ring shift "
          f"{(S - W) % W}), {DANUBE_DECODE} greedy decode steps")
    r = decode_vs_forward(arch, params, toks, DANUBE_DECODE, None)
    pos = r["cache"]["pos"]
    slots = torch.arange(W, device="cuda")
    assert pos.shape == (B, W) and bool((pos % W == slots).all()) and \
        int(pos.min()) == S - W and int(pos.max()) == S - 1, "the SWA ring layout"
    hold_decode("h2o-danube-1.8b bf16", r, LM_BF16_TOL, fails)
    print(f"  h2o-danube-1.8b bf16: "
          f"{time_lm(arch, params, toks, None, r['cache'], r['first'], smi)}")
    del params, r
    torch.cuda.empty_cache()


@contextlib.contextmanager
def moe_census(into: list):
    """Every MoE call's (assignments, dropped assignments) while inside,
    by wrapping ``layers.moe_ffn`` (the transformer calls it through the
    module) to count the drops of ``layers.route`` (deterministic: the
    routing ``moe_ffn`` computes) first; the counts stay on the card until
    read."""
    orig = lm_layers.moe_ffn

    def counted(p, x, cfg):
        into.append((x.shape[0] * cfg.top_k, lm_layers.route(p, x, cfg).dropped()))
        return orig(p, x, cfg)

    lm_layers.moe_ffn = counted
    try:
        yield
    finally:
        lm_layers.moe_ffn = orig


def drop_shares(census) -> list[float]:
    return [int(d) / n for n, d in census]


def no_drop(cfg):
    """``cfg`` with the MoE capacity raised past every expert's most
    assignments at any token count: C = int(cf * Tg * K / E) >= Tg for cf
    = E / K * 1.001 (0.001 Tg of slack keeps the float product off the
    integer below), and no expert takes a token twice."""
    moe = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        moe, capacity_factor=moe.num_experts / moe.top_k * 1.001))


def held_without_drops(arch, params, toks, steps, budget) -> dict:
    """``decode_vs_forward`` on ``arch`` with the capacity raised, every
    MoE call of it (prefill, decodes, the forward) dropping nothing."""
    census: list = []
    with moe_census(census):
        r = decode_vs_forward(TransformerLM(no_drop(arch.cfg)), params, toks, steps, budget)
    dropped = sum(int(d) for _, d in census)
    assert census and dropped == 0, f"{dropped} assignments dropped at the raised capacity"
    return r


def param_line(params) -> str:
    n = sum(t.numel() for t in opt_lib.leaves(params))
    gb = sum(t.numel() * t.element_size() for t in opt_lib.leaves(params)) / 1e9
    return (f"{n:,} params, {gb:.2f} GB; peak after init "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")


def decode_floor(params, B: int) -> str:
    """The least time a decode step takes: every weight it uses read once
    (the reference's dispatch runs every expert's GEMM over its C >= 8
    slots), the token embedding table only at the B rows it gathers, the
    MTP block and projection (training only) not at all."""
    emb = params["embed"]["embedding"]
    used = {k: v for k, v in params.items() if k not in ("mtp_block", "mtp_proj")}
    nbytes = sum(t.numel() * t.element_size() for t in opt_lib.leaves(used)) \
        - emb.numel() * emb.element_size() + B * emb.shape[1] * emb.element_size()
    return (f"decode floor {nbytes / PEAK_BYTES * 1e3:.2f} ms a step ({nbytes / 1e9:.2f} GB "
            f"of weights read once at 3.35 TB/s)")


def hold_moe_layer(cfg, smi: str, fails: list):
    """9d.1: one MoE layer of ``cfg`` at full width in fp32 on seeded
    tokens, at the config's capacity factor and at DS_DROP_CF, where
    assignments must drop (C equal to the mean load), the card against
    the same function on the CPU: expert ids equal but at near-ties (two
    selection scores within DS_TIE), every assignment's slot (its place in
    its expert's buffer, or dropped) equal away from the experts a
    near-tie moved, y within DS_LAYER_TOL of max |y| on the tokens routed
    alike, aux within rtol DS_AUX_RTOL; two card calls bit-equal."""
    T, K = DS_MOE_LAYER_TOKENS, cfg.moe.top_k
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    p, _ = lm_layers.init_moe(gen, cfg.moe, torch.float32)
    x = torch.randn((T, cfg.moe.d_model), generator=gen, device="cuda")
    pc = opt_lib.tree_map(lambda t: t.cpu(), p)
    xc = x.cpu()
    logits = xc @ pc["router"]
    sel = (torch.sigmoid(logits) + pc["router_bias"] if cfg.moe.router == "sigmoid_norm"
           else torch.softmax(logits, dim=1))
    for cf in (cfg.moe.capacity_factor, DS_DROP_CF):
        moe = dataclasses.replace(cfg.moe, capacity_factor=cf)
        name = f"{cfg.name} MoE layer at capacity factor {cf}"
        r = lm_layers.route(p, x, moe)
        y, aux = lm_layers.moe_ffn(p, x, moe)
        y2, aux2 = lm_layers.moe_ffn(p, x, moe)
        if not (torch.equal(y, y2) and torch.equal(aux, aux2)):
            fails.append(f"{name}: two card calls differ")
        ms, how = device_ms(lambda: lm_layers.moe_ffn(p, x, moe), iters=5)
        rc = lm_layers.route(pc, xc, moe)
        yc, auxc = lm_layers.moe_ffn(pc, xc, moe)
        ids, idc = r.ids.cpu(), rc.ids
        differ = ids != idc
        tie_ok = (sel.gather(1, ids.long()) - sel.gather(1, idc.long())).abs() < DS_TIE
        if bool((differ & ~tie_ok).any()):
            fails.append(f"{name}: {int((differ & ~tie_ok).sum())} expert ids differ off "
                         "near-ties")
        moved = differ.any(1)
        touched = torch.isin(ids, torch.cat([ids[moved], idc[moved]]).unique())
        slot, slot_c = r.slot.cpu().reshape(T, K), rc.slot.reshape(T, K)
        if bool(((slot != slot_c) & ~differ & ~touched).any()):
            fails.append(f"{name}: the slots of the kept assignments differ")
        dropped, dropped_c = int(r.dropped()), int(rc.dropped())
        if cf == DS_DROP_CF and dropped == 0:
            fails.append(f"{name}: no assignment dropped, so the drop path went unchecked")
        alike = ~moved & ((slot >= 0) == (slot_c >= 0)).all(1)
        err, scale = max_err(y.cpu()[alike], yc[alike]), float(yc.abs().max())
        if err > DS_LAYER_TOL * scale:
            fails.append(f"{name}: card vs CPU max |d| {err:.4g}")
        aux_err = abs(float(aux) - float(auxc))
        if aux_err > DS_AUX_RTOL * abs(float(auxc)):
            fails.append(f"{name}: aux {float(aux)!r} vs {float(auxc)!r}")
        G, Tg, C = lm_layers.groups(T, moe)
        print(f"  {name}, fp32 ({moe.num_experts} experts top-{K}, {moe.num_shared} shared, "
              f"{T} tokens: G {G}, capacity {C}, mean load {Tg * K // moe.num_experts}): card "
              f"vs CPU y max |d| {err:.4g} (limit {DS_LAYER_TOL * scale:.4g}) on "
              f"{int(alike.sum())} of {T} tokens routed alike; near-ties "
              f"{int((differ & tie_ok).sum())}; aux {float(aux):.7g} vs {float(auxc):.7g} (|d| "
              f"{aux_err:.3g}); dropped {dropped} (CPU {dropped_c}) of {T * K} assignments; "
              f"two card calls bit-equal; {ms:.3f} ms device ({how}) [{smi}]")
        del y, y2, yc
    del p, pc, x, xc


def hold_mla_layer(cfg, smi: str, fails: list):
    """9e.1: one MLA layer of ``cfg`` at full width in fp32, conditioned,
    at B = 1, S = 512: ``mla_attention`` and the prefill cache's c_kv /
    k_rope, card against CPU, each within DS_LAYER_TOL of its max."""
    mla = cfg.mla
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    p = conditioned({"mtp_block": {"attn": lm_layers.init_mla(gen, mla, torch.float32)[0]}})
    p = p["mtp_block"]["attn"]
    x = torch.randn((1, 512, mla.d_model), generator=gen, device="cuda")
    pos = torch.arange(512, dtype=torch.int32, device="cuda")[None]

    def run(pp, xx, pp_pos):
        return (lm_layers.mla_attention(pp, mla, xx, pp_pos, attn_chunk=cfg.attn_chunk,
                                        use_flash=cfg.use_flash),
                *lm_layers.mla_latents(pp, mla, xx, pp_pos))

    got = run(p, x, pos)
    want = run(opt_lib.tree_map(lambda t: t.cpu(), p), x.cpu(), pos.cpu())
    out = []
    for name, a, b in zip(("attention", "ckv", "krope"), got, want):
        err, scale = max_err(a.cpu(), b), float(b.abs().max())
        out.append(f"{name} max |d| {err:.4g} (limit {DS_LAYER_TOL * scale:.4g})")
        if err > DS_LAYER_TOL * scale:
            fails.append(f"{cfg.name} MLA layer {name}: card vs CPU max |d| {err:.4g}")
    print(f"  {cfg.name} MLA layer at fp32 (B 1, S 512, {mla.n_heads} heads, q/k "
          f"{mla.qk_nope_dim + mla.qk_rope_dim} v {mla.v_head_dim}, "
          f"{'flash' if cfg.use_flash else 'exact'}): card vs CPU " + ", ".join(out) + f" [{smi}]")


def phase_deepseek_moe(smi: str, fails: list):
    """9d. deepseek-moe-16b at full width and full depth."""
    arch = get_arch("deepseek-moe-16b")
    cfg = arch.cfg
    hold_moe_layer(cfg, smi, fails)
    torch.cuda.empty_cache()
    rng = np.random.default_rng(SEED + 2)
    B, S = DS_MOE_SHAPE
    budget = S + DS_MOE_DECODE
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)).cuda()

    cfg32 = dataclasses.replace(cfg, n_layers=DS_MOE_FP32_LAYERS, param_dtype=torch.float32,
                                act_dtype=torch.float32)
    arch32 = TransformerLM(cfg32)
    params32 = arch32.init(SEED)
    yard = reference_init_yardstick(arch32, params32, toks, depths=(2, DS_MOE_FP32_LAYERS))
    r = held_without_drops(arch32, conditioned(params32), toks, DS_MOE_DECODE, budget)
    print(f"  deepseek-moe-16b fp32, depth cut to {DS_MOE_FP32_LAYERS} (1 dense, "
          f"{DS_MOE_FP32_LAYERS - 1} MoE; the fp32 model at full depth is 65.5 GB): at the "
          f"init's own scale, the exact fp32 prefill's logits vs a float64 run, of max |logit|: "
          f"{yard}")
    hold_decode(f"deepseek-moe-16b fp32 ({DS_MOE_FP32_LAYERS} layers, capacity raised, 0 "
                "dropped)", r, LM_FP32_TOL, fails)
    del params32, r
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    params = conditioned(arch.init(SEED))
    print(f"  deepseek-moe-16b at full width and depth (bf16, flash): {param_line(params)}; "
          f"prefill {B} x {S}, budget {budget}, {DS_MOE_DECODE} greedy decode steps")
    r = held_without_drops(arch, params, toks, DS_MOE_DECODE, budget)
    hold_decode("deepseek-moe-16b bf16 (capacity raised, 0 dropped)", r, LM_BF16_TOL, fails)
    census: list = []
    with moe_census(census):
        arch.prefill(params, toks, budget=budget)
    shares = drop_shares(census)
    print(f"  deepseek-moe-16b prefill {B} x {S} at capacity factor {cfg.moe.capacity_factor} "
          f"(C {lm_layers.groups(B * S, cfg.moe)[2]}): dropped share per MoE layer "
          + ", ".join(f"{x:.4f}" for x in shares) + f" (mean {np.mean(shares):.4f})")
    print(f"  deepseek-moe-16b bf16: "
          f"{time_lm(arch, params, toks, budget, r['cache'], r['first'], smi)}; "
          f"{decode_floor(params, B)}")
    del params, r


def phase_deepseek_v3(smi: str, fails: list):
    """9e. deepseek-v3-671b at full width, cut in depth."""
    arch = get_arch("deepseek-v3-671b")
    cfg = dataclasses.replace(arch.cfg, n_layers=DS_V3_LAYERS)
    print(f"  {DS_V3_CUT}")
    hold_mla_layer(cfg, smi, fails)
    torch.cuda.empty_cache()
    rng = np.random.default_rng(SEED + 3)
    B, S = DS_V3_SHAPE
    budget = S + DS_V3_DECODE
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)).cuda()
    cfg2 = dataclasses.replace(cfg, n_layers=2, first_k_dense=2, mtp=False,
                               param_dtype=torch.float32, act_dtype=torch.float32)
    yard = reference_init_yardstick(TransformerLM(cfg2), TransformerLM(cfg2).init(SEED), toks,
                                    depths=(1, 2))
    print(f"  deepseek-v3-671b at the init's own scale, the exact fp32 prefill's logits vs a "
          f"float64 run, of max |logit| (its dense MLA layers): {yard}")
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    lm = TransformerLM(cfg, optimizer=arch.optimizer)
    params = conditioned(lm.init(SEED))
    print(f"  deepseek-v3-671b, {DS_V3_LAYERS} layers + MTP (bf16, flash, sigmoid routing, "
          f"route scale {cfg.moe.route_scale}): {param_line(params)}; prefill {B} x {S}, budget "
          f"{budget}, {DS_V3_DECODE} greedy decode steps")
    r = held_without_drops(lm, params, toks, DS_V3_DECODE, budget)
    hold_decode("deepseek-v3-671b bf16 (capacity raised, 0 dropped)", r, LM_BF16_TOL, fails)
    B2, S2 = DS_V3_TIMED
    big = torch.from_numpy(rng.integers(0, cfg.vocab, (B2, S2)).astype(np.int32)).cuda()
    census: list = []
    with moe_census(census):
        lm.prefill(params, big)
    print(f"  deepseek-v3-671b prefill {B2} x {S2} at capacity factor "
          f"{cfg.moe.capacity_factor} (C {lm_layers.groups(B2 * S2, cfg.moe)[2]}): dropped "
          f"share of its MoE layer {drop_shares(census)[0]:.4f}")
    print(f"  deepseek-v3-671b bf16 (decode on the {B} x {budget} cache): "
          f"{time_lm(lm, params, big, None, r['cache'], r['first'], smi)}; "
          f"{decode_floor(params, B)}")
    Bl, Sl = DS_V3_LOSS
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (Bl, Sl)).astype(np.int32)
                                        ).cuda()}
    loss, m = lm.loss(params, batch)
    vals = {k: float(v) for k, v in {"loss": loss, **m}.items()}
    assert sorted(m) == ["aux", "ce", "mtp_ce"] and all(np.isfinite(v) for v in vals.values()), vals
    print(f"  deepseek-v3-671b loss on {Bl} x {Sl} with MTP (weight {cfg.mtp_weight}): "
          + ", ".join(f"{k} {v:.6g}" for k, v in vals.items()))
    print(f"  {DS_TRAIN_WAITS}")
    del params, r, big


def phase_models():
    """9. The models path: the paper's embedder, two dense LMs and the
    two DeepSeek configs at full width. None of the port's kernels is on
    it."""
    smi = nvidia_smi()
    print("models path:")
    counts.reset_all()
    fails: list[str] = []
    t0 = time.perf_counter()
    phase_encoder(smi, fails)
    with torch.no_grad():
        phase_lms(smi, fails)
        print(f"  9a-9c {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        phase_deepseek_moe(smi, fails)
        torch.cuda.empty_cache()
        print(f"  9d {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        phase_deepseek_v3(smi, fails)
        torch.cuda.empty_cache()
        print(f"  9e {time.perf_counter() - t0:.1f} s")
    snap = counts.snapshot()
    assert all(c["kernel"] == 0 and c["plain"] == 0 for c in snap.values()), snap
    assert not fails, "models path: " + "; ".join(fails)


# --------------------------------------------------------------------- GNN
def pad512(n: int) -> int:
    return -(-n // gnn_lib.PAD_TO) * gnn_lib.PAD_TO


def gnn_buffers(src, dst, n: int, N: int, E: int) -> dict:
    """Edge ids and masks on the card: the live edges first, the padding
    at node 0 (masked), as the sampler pads."""
    e = len(src)
    s, t = np.zeros(E, np.int32), np.zeros(E, np.int32)
    s[:e], t[:e] = src, dst
    return {"edge_src": torch.from_numpy(s).cuda(), "edge_dst": torch.from_numpy(t).cuda(),
            "node_mask": torch.arange(N, device="cuda") < n,
            "edge_mask": torch.arange(E, device="cuda") < e}


def gnn_full_batch(arch, src, dst, n: int, d_feat: int, n_out: int, gen,
                   graph_of=None) -> dict:
    """A full-batch graph on the card, node and edge buffers padded to
    multiples of 512: features N(0, 1), class labels uniform in [0,
    n_out), or (``graph_of``: each node's graph) one N(0, 1) target a
    graph broadcast to its nodes, [N, 1] (molecule's regression)."""
    N, E = pad512(n), pad512(len(src))
    b = gnn_buffers(src, dst, n, N, E)
    b["node_feat"] = torch.randn((N, d_feat), generator=gen, device="cuda")
    b["edge_feat"] = torch.randn((E, arch.cfg.d_edge_feat), generator=gen, device="cuda")
    if graph_of is None:
        b["labels"] = torch.randint(0, n_out, (N,), generator=gen, device="cuda",
                                    dtype=torch.int32)
    else:
        target = torch.randn((int(graph_of.max()) + 1, 1), generator=gen, device="cuda")
        lab = torch.zeros((N, 1), device="cuda")
        lab[:n] = target[torch.from_numpy(graph_of).cuda()]
        b["labels"] = lab
    return b


def csr_edges(indptr, indices):
    """(src, dst) of a CSR graph's edges: the neighbour sends to its row."""
    deg = np.diff(indptr)
    return indices.astype(np.int32), np.repeat(np.arange(len(deg), dtype=np.int32), deg)


def gnn_sampled_batch(arch, sampler, feats, labels, rng, gen):
    """One minibatch_lg batch: 1,024 roots without replacement, their
    fan-out subgraph by the sampler on the host (timed), node features
    and labels gathered from the tables on the card by original node id
    (padding rows zero), edge features N(0, 1). Returns (batch, host ms
    of the sampler, live nodes, live edges)."""
    d = dict(arch.shapes["minibatch_lg"].dims)
    roots = rng.choice(d["n_nodes"], d["batch_nodes"], replace=False)
    t = time.perf_counter()
    sub = sampler.sample(roots, d["pad_nodes"], d["pad_edges"])
    host_ms = (time.perf_counter() - t) * 1e3
    N, E = arch.padded_sizes("minibatch_lg")   # the sampler's buffers, 512-aligned
    n, e = sub["n_nodes"], sub["n_edges"]
    b = gnn_buffers(sub["edge_src"][:e], sub["edge_dst"][:e], n, N, E)
    orig = torch.zeros(N, dtype=torch.int64)
    orig[:d["pad_nodes"]] = torch.from_numpy(sub["orig_nodes"])
    orig = orig.cuda()
    b["node_feat"] = torch.where(b["node_mask"][:, None], feats[orig], 0.0)
    b["labels"] = labels[orig]
    b["edge_feat"] = torch.randn((E, arch.cfg.d_edge_feat), generator=gen, device="cuda")
    return b, host_ms, n, e


def check_segment_sum(x, ids, n: int, chk: Check):
    """The segment sum twice (bit-equal) against its plain version on the
    card: each element within 1e-5 of the sum of its own terms'
    magnitudes + 1e-6 (another order of the same sum); rows no id names
    exactly zero."""
    got = segment_sum_cuda(x, ids, n)
    again = segment_sum_cuda(x, ids, n)
    want = segment_sum_ref(x, ids, n)
    mag = segment_sum_ref(x.abs(), ids, n)
    torch.cuda.synchronize()
    what = f"ids {tuple(ids.shape)} {ids.dtype} into {n}"
    if not torch.equal(got, again):
        chk.fail.append(f"{what}: two calls differ")
    chk.err = max(chk.err, max_err(got, want))
    bad = int(((got - want).abs() > RTOL * mag + ATOL).sum())
    if bad:
        chk.fail.append(f"{what}: {bad} values off")
    touched = torch.zeros(n, dtype=torch.bool, device="cuda")
    touched[ids.long()] = True
    if not bool((got[~touched] == 0).all()):
        chk.fail.append(f"{what}: an empty segment is not zero")


def time_segment_sum(x, ids, n: int):
    """Device ms of the segment sum (its sort and dense pass included),
    plain (``segment_sum_ref``: ``index_add_`` in f32), library (one
    ``torch.zeros(n, d).index_add_(0, ids, x)``, timed only) and the
    bound: the entries read once, the dense result written once."""
    E, d = x.shape
    ms, host = cuda_ms(lambda: segment_sum_cuda(x, ids, n))
    plain, plain_how = device_ms(lambda: segment_sum_ref(x, ids, n), iters=5)
    lib_fn = lambda: torch.zeros((n, d), device="cuda").index_add_(0, ids, x)  # noqa: E731
    lib_err = max_err(lib_fn(), segment_sum_ref(x, ids, n))
    lib, lib_how = device_ms(lib_fn, iters=5)
    b_ms, b_by = bound(float(E * d), E * d * 4 + n * d * 4 + E * ids.element_size())
    print(f"  segment_sum at minibatch_lg: {E} entries into {n} x {d}: {ms:.4f} ms device "
          f"({host:.4f} ms a call from the host), plain {plain:.4f} ms ({plain_how}), "
          f"library {lib:.4f} ms (zeros + index_add_, float atomics; {lib_how}; max|d| vs "
          f"plain {lib_err:.3g}), bound {b_ms:.4f} ms ({b_by})")
    return dict(ms=ms, host_ms=host, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                bound_by=b_by)


def gnn_kernels(arch, batch, gen, results):
    """10a. The segment sum and the gather backward at minibatch_lg's
    shapes, against their plain versions."""
    N, E, d = batch["node_mask"].numel(), batch["edge_mask"].numel(), arch.cfg.d_hidden
    x = torch.randn((E, d), generator=gen, device="cuda")
    dst, src = batch["edge_dst"], batch["edge_src"]
    zeros = torch.zeros_like(dst)          # every id 0: the dummy batch's one hot row
    chk = Check("seg_sum")
    check_segment_sum(x, dst, N, chk)
    check_segment_sum(x, zeros, N, chk)
    check_segment_sum(x, dst.long(), N, chk)
    chk.done("minibatch_lg dst, zeros, int64")
    results["segment_sum"] = dict(max_abs_err=chk.err, **time_segment_sum(x, dst, N))
    backward_split("segment_sum at minibatch_lg", lambda: segment_sum_cuda(x, dst, N))
    backward_split("segment_sum, every id 0", lambda: segment_sum_cuda(x, zeros, N))
    zeros_ms = cuda_ms(lambda: segment_sum_cuda(x, zeros, N))[0]
    print(f"  segment_sum, every id 0: {zeros_ms:.4f} ms device")
    hn = torch.randn((N, d), generator=gen, device="cuda")
    chk = Check("gath_bwd")
    check_gather_backward(hn, src, x, chk)
    check_gather_backward(hn, torch.zeros_like(src), x, chk)
    check_gather_backward(hn, batch["edge_dst"], x, chk)
    chk.done("hn[src], hn[dst], zeros at minibatch_lg")
    ms = cuda_ms(lambda: gather_backward_cuda(hn, src, x))[0]
    plain = device_ms(lambda: gather_backward_ref(hn, src, x), iters=5)[0]
    print(f"  gather_backward at hn[src] ({E} ids into {N} x {d}): {ms:.4f} ms device, plain "
          f"{plain:.4f} ms")


def tree_rel(got, want) -> dict[str, float]:
    """Leaf path -> max |got - want| / max |want| over nested dicts."""
    out = {}

    def walk(g, w, path):
        if isinstance(w, dict):
            for k in w:
                walk(g[k], w[k], f"{path}.{k}" if path else k)
        else:
            scale = max(float(w.abs().max()), 1e-30)
            out[path] = float((g.cpu().double() - w.cpu().double()).abs().max()) / scale

    walk(got, want, "")
    return out


def gnn_out_loss_grads(arch, params, batch):
    """(out, loss, grads) of one forward and backward: ``loss_and_grads``,
    with the forward's output recorded on its way."""
    seen = {}
    forward = arch.forward

    def recording(p, b):
        seen["out"] = forward(p, b)
        return seen["out"]

    arch.forward = recording
    try:
        loss, _, grads = arch.loss_and_grads(params, batch)
    finally:
        del arch.forward          # the class's method again
    return seen["out"].detach(), loss, grads


@contextlib.contextmanager
def gnn_plain_route():
    """MeshGraphNet's row gathers and segment sums through their plain
    versions on the tensors' device (the float64 yardstick on the card:
    the kernels take f32 and bf16)."""
    saved = gnn_lib.gather_rows, gnn_lib.segment_sum
    gnn_lib.gather_rows = lambda t, ids: bag_ops.gather_apply(t, ids, False)
    gnn_lib.segment_sum = lambda x, ids, n: bag_ops.segment_sum_apply(x, ids, n, False)
    try:
        yield
    finally:
        gnn_lib.gather_rows, gnn_lib.segment_sum = saved


def gnn_twin(arch, **changes):
    """A MeshGraphNet with ``arch``'s widths and shapes and its config
    changed by ``changes``."""
    twin = gnn_lib.MeshGraphNet(dataclasses.replace(arch.cfg, **changes))
    twin.shapes, twin.d_feat, twin.n_out = arch.shapes, arch.d_feat, arch.n_out
    return twin


def gnn_card_vs_cpu(arch, batch, smi: str, fails: list):
    """10b. One forward, loss and gradient at full width on a sampled
    minibatch_lg batch: the card against the CPU with the same params
    (the CPU without remat, whose recompute gives the same values), and
    a float64 run on the card through the plain versions (the yardstick
    of fp32 rounding); then two card train steps from one state,
    bit-equal."""
    params = arch.init(SEED)
    t = time.perf_counter()
    out, loss, grads = gnn_out_loss_grads(arch, params, batch)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t
    p_cpu = opt_lib.tree_map(lambda t: t.cpu(), params)
    b_cpu = {k: v.cpu() for k, v in batch.items()}
    t = time.perf_counter()
    out_c, loss_c, grads_c = gnn_out_loss_grads(gnn_twin(arch, remat=False), p_cpu, b_cpu)
    cpu_s = time.perf_counter() - t
    t = time.perf_counter()
    with gnn_plain_route():
        _, loss_64, grads_64 = gnn_out_loss_grads(
            gnn_twin(arch, param_dtype=torch.float64),
            opt_lib.tree_map(lambda t: t.double(), params),
            {k: v.double() if v.is_floating_point() else v for k, v in batch.items()})
    torch.cuda.synchronize()
    f64_s = time.perf_counter() - t
    out_err = max_err(out.cpu(), out_c) / float(out_c.abs().max())
    loss_err = abs(float(loss) - float(loss_c)) / abs(float(loss_c))
    rel, yard = tree_rel(grads, grads_c), tree_rel(grads_c, grads_64)
    card64 = tree_rel(grads, grads_64)
    worst = sorted(rel, key=lambda k: -rel[k] / max(GNN_GRAD_TOL, 2 * yard[k]))[:4]
    print(f"  card vs CPU, full width on a sampled batch (card {card_s:.2f} s cold, CPU "
          f"{cpu_s:.1f} s, float64 on the card {f64_s:.2f} s): out {out_err:.3g} of max |out| "
          f"{float(out_c.abs().max()):.4g} (limit {GNN_OUT_TOL}), loss {float(loss):.6f} vs "
          f"{float(loss_c):.6f} (rel {loss_err:.3g}; float64 {float(loss_64):.6f}); grads, the "
          f"worst leaves against their limits: " + ", ".join(
              f"{k} {rel[k]:.3g} (CPU vs float64 {yard[k]:.3g}, card vs float64 "
              f"{card64[k]:.3g})" for k in worst)
          + f"; worst leaf of all: card vs CPU {max(rel.values()):.3g}, CPU vs float64 "
          f"{max(yard.values()):.3g}, card vs float64 {max(card64.values()):.3g} [{smi}]")
    if out_err > GNN_OUT_TOL or loss_err > GNN_OUT_TOL:
        fails.append(f"gnn card vs CPU: out {out_err:.3g}, loss {loss_err:.3g}")
    over = [k for k in rel if rel[k] > max(GNN_GRAD_TOL, 2 * yard[k])]
    if over:
        fails.append(f"gnn card vs CPU grads over their limits: {over}")
    del p_cpu, b_cpu, grads_c, grads_64, out_c, out
    state = TrainState(params, opt_lib.init(arch.optimizer, params))
    step = arch.step("minibatch_lg").fn
    s1, m1 = step(state, batch)
    s2, m2 = step(state, batch)
    torch.cuda.synchronize()
    l1, l2 = ([*opt_lib.leaves(s.params), *opt_lib.leaves(s.opt.mu),
               *opt_lib.leaves(s.opt.nu), s.opt.step] for s in (s1, s2))
    same = len(l1) == len(l2) and all(torch.equal(a, b) for a, b in zip(l1, l2))
    print(f"  two card train steps from one state: {'bit-equal' if same else 'DIFFER'} "
          f"({len(l1)} leaves of params and moments), losses {float(m1['loss']):.6f}, "
          f"{float(m2['loss']):.6f}")
    if not same or not torch.equal(m1["loss"], m2["loss"]):
        fails.append("gnn: two card train steps from one state differ")
    del state, s1, s2, grads, params


def gnn_train(arch, shape: str, batches, smi: str, what: str):
    """10c. ``Trainer.fit`` on ``batches`` under the memory cap, counts
    reset just before: the segment sum 2 a layer a step (forward and
    remat's recompute), the gather backward 2, nothing else, no plain
    version; then one step under torch.profiler. Returns the counts."""
    L, n = arch.cfg.n_layers, len(batches)
    cap_gb = TRAIN_MEMORY_FRACTION * torch.cuda.get_device_properties(0).total_memory / 1e9
    with tempfile.TemporaryDirectory(prefix="chip_smoke_gnn_") as tmp:
        tr = Trainer(arch, TrainerConfig(total_steps=n, ckpt_dir=tmp, ckpt_interval=n + 1,
                                         log_interval=1))
        state = tr.init_state(SEED)
        step_ms, base = [], tr.step_fn

        def timed_step(st, b):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = base(st, b)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        tr.step_fn = timed_step
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.set_per_process_memory_fraction(TRAIN_MEMORY_FRACTION)
        try:
            counts.reset_all()
            state, hist = tr.fit(iter(batches), state=state)
            snap = counts.snapshot()
        finally:
            torch.cuda.set_per_process_memory_fraction(1.0)
        peak = torch.cuda.max_memory_allocated() / 1e9
    assert snap["segment_sum"] == {"kernel": 2 * L * n, "plain": 0}, (shape, snap)
    assert snap["gather_backward"] == {"kernel": 2 * L * n, "plain": 0}, (shape, snap)
    assert all(c == {"kernel": 0, "plain": 0} for k, c in snap.items()
               if k not in ("segment_sum", "gather_backward")), (shape, snap)
    losses = [m["loss"] for _, m in hist]
    assert [s for s, _ in hist] == list(range(1, n + 1)) and np.all(np.isfinite(losses)), hist
    step = arch.make_train_step()
    wall, launches = profiled_launches(lambda: step(state, batches[0]))
    total = sum(ms for _, ms in launches)
    ours = sum(ms for name, ms in launches
               if any(k.lower() in name.lower() for k, _ in BWD_PARTS))
    warm = step_ms[1:] or step_ms
    print(f"  {what}: {n} Trainer steps, ms {', '.join(f'{x:.1f}' for x in step_ms)} (host "
          f"clock around synchronize(); the first cold), {1e3 / np.median(warm):.2f} steps/s "
          f"warm; launches a step segment_sum {snap['segment_sum']['kernel'] // n}, "
          f"gather_backward {snap['gather_backward']['kernel'] // n}; one step under "
          f"torch.profiler: {wall:.1f} ms host clock, {total:.1f} ms of kernels in "
          f"{len(launches)} launches (device idle share {1 - total / wall:.3f}), of which "
          f"bag_backward.cu's {ours:.2f} ms; losses {', '.join(f'{x:.4f}' for x in losses)}; "
          f"peak {peak:.2f} GB under a {cap_gb:.1f} GB cap [{smi}]")
    print("    by device time: " + "; ".join(
        f"{ms:.2f} ms x{k} {name}" for name, ms, k in kernels_by_name(launches)[:5]))
    del state
    torch.cuda.empty_cache()
    return snap


def gnn_ogb_cut(arch, gen, smi: str):
    """ogb_products full batch on ``random_csr_graph`` at the shape's mean
    degree, nodes (and so edges) halved until one train step fits under
    the memory cap (an OutOfMemoryError halves it). Returns (batches,
    label)."""
    d = dict(arch.shapes["ogb_products"].dims)
    n_full, deg = d["n_nodes"], round(d["n_edges"] / d["n_nodes"])
    step = arch.step("ogb_products").fn
    state = arch.init_train_state(SEED)
    tried = []
    for halvings in range(GNN_MAX_HALVINGS):
        n = -(-n_full // 2 ** halvings)
        src, dst = csr_edges(*gnn_lib.random_csr_graph(n, deg, SEED))
        batch = gnn_full_batch(arch, src, dst, n, d["d_feat"], d["n_out"], gen)
        fits = True
        torch.cuda.set_per_process_memory_fraction(TRAIN_MEMORY_FRACTION)
        try:
            step(state, batch)
            torch.cuda.synchronize()
        except torch.cuda.OutOfMemoryError:
            fits = False
        finally:
            torch.cuda.set_per_process_memory_fraction(1.0)
        if fits:
            break
        tried.append(f"1/{2 ** halvings} ({n} nodes, {len(src)} edges) did not fit")
        del batch
        gc.collect()
        torch.cuda.empty_cache()
    else:
        raise AssertionError("ogb_products: no cut fits: " + "; ".join(tried))
    cut = (f"ogb_products cut 1/{2 ** halvings}: {n} of {n_full} nodes, {len(src)} of "
           f"{d['n_edges']} edges (mean degree {deg}), d_feat {d['d_feat']}, n_out "
           f"{d['n_out']}, full batch: at full size its fp32 edge latents alone are "
           f"{d['n_edges'] * arch.cfg.d_hidden * 4 / 1e9:.1f} GB a layer, {arch.cfg.n_layers} of "
           f"them kept for the backward under remat; " + ("; ".join(tried) or "the full size fit"))
    print(f"  {cut} [{smi}]")
    batches = [batch] + [gnn_full_batch(arch, src, dst, n, d["d_feat"], d["n_out"], gen)
                         for _ in range(GNN_TRAIN_STEPS - 1)]
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return batches, f"ogb_products at cut 1/{2 ** halvings}: {n} nodes, {len(src)} edges"


def phase_gnn(results):
    """10. The GNN path: MeshGraphNet at full width on the card."""
    smi = nvidia_smi()
    arch = get_arch("meshgraphnet")
    print(f"GNN path: MeshGraphNet {arch.cfg}, optimizer {arch.optimizer}")
    fails: list[str] = []
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 10)
    d = dict(arch.shapes["minibatch_lg"].dims)
    t = time.perf_counter()
    deg = round(d["n_edges"] / d["n_nodes"])
    indptr, indices = gnn_lib.random_csr_graph(d["n_nodes"], deg, SEED)
    graph_s = time.perf_counter() - t
    sampler = gnn_lib.NeighborSampler(indptr, indices, (d["fanout1"], d["fanout2"]),
                                      SEED)
    feats = torch.randn((d["n_nodes"], d["d_feat"]), generator=gen, device="cuda")
    labels = torch.randint(0, d["n_out"], (d["n_nodes"],), generator=gen, device="cuda",
                           dtype=torch.int32)
    sampled = [gnn_sampled_batch(arch, sampler, feats, labels, rng, gen)
               for _ in range(GNN_TRAIN_STEPS + 1)]
    mb = [b for b, _, _, _ in sampled]
    print(f"  minibatch_lg graph: random_csr_graph({d['n_nodes']}, {deg}): "
          f"{int(indptr[-1])} edges, "
          f"{(indptr.nbytes + indices.nbytes) / 1e9:.2f} GB of host CSR, built in "
          f"{graph_s:.2f} s; {len(sampled)} batches of {d['batch_nodes']} roots, fan-out "
          f"{d['fanout1']}·{d['fanout2']}: live nodes "
          f"{', '.join(str(n) for _, _, n, _ in sampled)} of {d['pad_nodes']}, live edges "
          f"{', '.join(str(e) for _, _, _, e in sampled)} of {d['pad_edges']}; host ms to "
          f"sample a batch {', '.join(f'{ms:.1f}' for _, ms, _, _ in sampled)}")
    del sampled
    gnn_kernels(arch, mb[0], gen, results)
    gnn_card_vs_cpu(arch, mb[-1], smi, fails)
    del feats, labels, indptr, indices, sampler
    torch.cuda.empty_cache()

    # (c) Trainer runs; minibatch_lg's is the path whose launches the JSON line reports
    sm = dict(arch.shapes["full_graph_sm"].dims)
    g = np.random.default_rng(SEED + 1)
    edges = [(g.integers(0, sm["n_nodes"], sm["n_edges"]),
              g.integers(0, sm["n_nodes"], sm["n_edges"])) for _ in range(GNN_TRAIN_STEPS)]
    gnn_train(arch, "full_graph_sm",
              [gnn_full_batch(arch, s_, t_, sm["n_nodes"], sm["d_feat"], sm["n_out"], gen)
               for s_, t_ in edges], smi,
              f"full_graph_sm ({sm['n_nodes']} -> {pad512(sm['n_nodes'])} nodes, "
              f"{sm['n_edges']} -> {pad512(sm['n_edges'])} edges)")
    mo = dict(arch.shapes["molecule"].dims)
    nm, em, B = mo["n_nodes"], mo["n_edges"], mo["batch"]
    graph_of = np.repeat(np.arange(B), nm).astype(np.int64)
    mol = []
    for _ in range(GNN_TRAIN_STEPS):
        base_ = np.repeat(np.arange(B) * nm, em)
        mol.append(gnn_full_batch(arch, base_ + g.integers(0, nm, B * em),
                                  base_ + g.integers(0, nm, B * em), B * nm, mo["d_feat"],
                                  mo["n_out"], gen, graph_of=graph_of))
    gnn_train(arch, "molecule", mol, smi,
              f"molecule ({B} x {nm} -> {pad512(B * nm)} nodes, {B * em} edges; MSE)")
    del mol
    snap = gnn_train(arch, "minibatch_lg", mb[:GNN_TRAIN_STEPS], smi,
                     f"minibatch_lg (padded {mb[0]['node_mask'].numel()} nodes / "
                     f"{mb[0]['edge_mask'].numel()} edges)")
    results["segment_sum"]["launches"] = snap["segment_sum"]["kernel"]
    del mb
    torch.cuda.empty_cache()
    ogb, what = gnn_ogb_cut(arch, gen, smi)
    gnn_train(arch, "ogb_products", ogb, smi, what)
    del ogb
    torch.cuda.empty_cache()

    # (d) the train launcher on molecule, then a resume on its directory
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_gnn_launch_") as tmp:
        first = run_module("repro_torch.launch.train", [*GNN_LAUNCH_FLAGS, "--steps", "4",
                                                        "--ckpt-dir", tmp], root,
                           "  gnn train launcher")
        assert first[-1] == "final checkpoint: 4" and first[-2].startswith("step 4: loss="), first
        second = run_module("repro_torch.launch.train", [*GNN_LAUNCH_FLAGS, "--steps", "6",
                                                         "--ckpt-dir", tmp], root,
                            "  gnn train launcher")
        steps = [ln.split(":")[0] for ln in second if ln.startswith("step ")]
        assert steps == ["step 6"] and second[-1] == "final checkpoint: 6", second
        print("  gnn train launcher: 4 steps of molecule at full width, then resumed at 4 to 6")
    assert not fails, "GNN path: " + "; ".join(fails)


# --------------------------------------------------------------- mesh path
def mesh_specs(smi: str):
    """11a. Every arch's train-state specs on meta (nothing allocated),
    and the bytes of params + optimizer state one mesh position holds."""
    for shape, axes in MESH_SPEC_MESHES:
        mesh = make_debug_mesh(shape, axes)
        cells = []
        for name in list_archs():
            arch = get_arch(name)
            before = torch.cuda.memory_allocated()
            t = time.perf_counter()
            specs = sharding.train_state_pspecs(arch, mesh)
            state = arch.abstract_train_state("meta")
            per_dev = sharding.per_device_bytes(state, specs, mesh)
            took = time.perf_counter() - t
            leaves: list = []
            sharding.tree_map(leaves.append, state)
            whole = sum(x.numel() * x.element_size() for x in leaves)
            assert all(x.device.type == "meta" for x in leaves), name
            assert torch.cuda.memory_allocated() == before, (name, "allocated on the card")
            cells.append(f"{name} {per_dev / 1e9:.3f} of {whole / 1e9:.1f} GB ({took:.2f} s)")
        print(f"  specs on {'x'.join(map(str, shape))} {axes}, params + optimizer state a "
              f"position holds (of the whole), computed on meta with no card memory "
              f"allocated: " + "; ".join(cells) + f" [{smi}]")


def timed_steps(trainer, into: list):
    """Wrap ``trainer.step_fn`` to record each step's ms (host clock around
    synchronize())."""
    base = trainer.step_fn

    def step(st, b):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = base(st, b)
        torch.cuda.synchronize()
        into.append((time.perf_counter() - t) * 1e3)
        return out

    trainer.step_fn = step


def same_leaves(got, want) -> tuple[bool, float]:
    """(every leaf bit-equal, the largest |difference| over max |value|),
    ``got`` gathered onto ``want``'s device."""
    a, b = [], []
    sharding.tree_map(b.append, want)
    sharding.tree_map(a.append, sharding.unshard(got, b[0].device))
    assert len(a) == len(b)
    equal, rel = True, 0.0
    for x, y in zip(a, b):
        assert x.shape == y.shape and x.dtype == y.dtype
        if not torch.equal(x, y):
            equal = False
            d = float((x.double() - y.double()).abs().max())
            rel = max(rel, d / max(float(y.double().abs().max()), 1e-30))
    return equal, rel


def hold_same(what: str, got, want, fails: list):
    equal, rel = same_leaves(got, want)
    if not equal:
        # the same kernels on the same inputs should give the same bits
        print(f"  {what}: NOT bit-equal, largest difference {rel:.3g} of max |value|")
        if rel > MESH_TOL:
            fails.append(f"{what}: {rel:.3g} of max |value| apart")
    return equal


def mesh_launches(steps: int) -> dict:
    snap = counts.snapshot()
    assert snap["bag"]["kernel"] == snap["bag_backward"]["kernel"] == steps, snap
    assert snap["gather_backward"]["kernel"] == MIND_GATHERS * steps, snap
    assert all(c["plain"] == 0 for c in snap.values()), "a plain version ran"
    assert all(c["kernel"] == 0 for n, c in snap.items()
               if n not in ("bag", "bag_backward", "gather_backward")), snap
    return snap


def mesh_train(smi: str, fails: list):
    """11b. MIND at full width, the Trainer on a 2 x 2 mesh of the one card
    against the Trainer without it; then the elastic restore."""
    arch = get_arch("mind")
    rng = np.random.default_rng(SEED + 11)
    batches = [train_batch(arch, TRAIN_BATCH, rng, i + 1) for i in range(MESH_STEPS + 1)]
    mesh = make_debug_mesh(MESH_SHAPE)
    print(f"  {describe(mesh)}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
        def cfg(steps, where, every=10 ** 9):
            return TrainerConfig(total_steps=steps, ckpt_dir=os.path.join(tmp, where),
                                 ckpt_interval=every, log_interval=1)

        plain = Trainer(arch, cfg(MESH_STEPS, "plain", MESH_STEPS))
        plain_ms: list = []
        timed_steps(plain, plain_ms)
        want, _ = plain.fit(iter(batches[:MESH_STEPS]), state=plain.init_state(SEED))
        tr = Trainer(arch, cfg(MESH_STEPS, "mesh"), mesh=mesh)
        state = tr.init_state(SEED)
        mesh_ms: list = []
        timed_steps(tr, mesh_ms)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counts.reset_all()
        got, hist = tr.fit(iter(batches[:MESH_STEPS]), state=state)
        snap = mesh_launches(MESH_STEPS)
        peak = torch.cuda.max_memory_allocated() / 1e9
        del state
        equal = hold_same("mesh vs no mesh after 3 steps", got, want, fails)
        held = sharding.piece_bytes(got)
        gather_ms, how_g = device_ms(lambda: sharding.unshard(got, tr.device), iters=5)
        full = sharding.unshard(got, tr.device)
        split_ms, how_s = device_ms(lambda: sharding.place(full, tr.state_shardings), iters=5)
        del full
        emb = got.params["item_emb"]
        print(f"  mind Trainer.fit on the mesh: {MESH_STEPS} steps of {TRAIN_BATCH}, ms "
              f"{', '.join(f'{x:.2f}' for x in mesh_ms)} on the mesh and "
              f"{', '.join(f'{x:.2f}' for x in plain_ms)} without (host clock around "
              f"synchronize(); the first cold); a step's gather {gather_ms:.3f} ms + split "
              f"{split_ms:.3f} ms device ({how_g}; {how_s}); item_emb {emb.spec}, pieces "
              f"{tuple(emb.pieces[0, 0].shape)}; state bytes a position "
              f"{max(held.values()) / 1e9:.3f} GB; peak {peak:.2f} GB; launches a step bag "
              f"{snap['bag']['kernel'] // MESH_STEPS}, bag_backward "
              f"{snap['bag_backward']['kernel'] // MESH_STEPS}, gather_backward "
              f"{snap['gather_backward']['kernel'] // MESH_STEPS}; states "
              f"{'bit-equal' if equal else 'NOT bit-equal'}; losses "
              f"{', '.join(f'{m['loss']:.4f}' for _, m in hist)} [{smi}]")
        del got
        plain.ckpt.wait()
        # the elastic restore: the checkpoint written without the mesh, onto it
        tr2 = Trainer(arch, cfg(MESH_STEPS + 1, "plain"), mesh=mesh)
        t = time.perf_counter()
        restored, meta = tr2.resume_or_init()
        restore_s = time.perf_counter() - t
        assert meta["step"] == MESH_STEPS and isinstance(restored.params["item_emb"],
                                                          sharding.Sharded), meta
        equal_r, _ = same_leaves(restored, want)
        if not equal_r:
            fails.append("the restored state differs from the one saved")
        counts.reset_all()
        got2, _ = tr2.fit(iter(batches[MESH_STEPS:]), state=restored, start_step=MESH_STEPS)
        mesh_launches(1)
        del restored
        plain2 = Trainer(arch, cfg(MESH_STEPS + 1, "plain2"))
        want2, _ = plain2.fit(iter(batches[MESH_STEPS:]), state=want, start_step=MESH_STEPS)
        equal2 = hold_same("restored onto the mesh, one more step", got2, want2, fails)
        print(f"  a checkpoint written without the mesh restored onto it in {restore_s:.2f} s "
              f"({'bit-equal' if equal_r else 'NOT equal'} to the state saved), one more step "
              f"{'bit-equal' if equal2 else 'NOT bit-equal'} to the step without the mesh "
              f"[{smi}]")
        del got2, want2, plain, plain2, tr, tr2
    return arch, want, batches[0]


def payload_diffs(q_card, q_cpu, y, scale) -> int:
    """Entries off by one at a half-integer within 1e-4; raises on others."""
    q_card = q_card.cpu().to(torch.int32)
    off = q_card != q_cpu.to(torch.int32)
    if bool(off.any()):
        r = y[off].double() / float(scale)
        assert bool(((q_card - q_cpu.to(torch.int32))[off].abs() == 1).all()), "payload off by more than 1"
        assert bool(((r - r.floor() - 0.5).abs() < 1e-4).all()), "payload off away from a half-integer"
    return int(off.sum())


def mesh_collectives(arch, state, batch, smi: str, fails: list):
    """11c. The compressed all-reduce and the hierarchical sum on the card,
    on the gradients of MIND's batch split over 4 data shards."""
    rows = TRAIN_BATCH // MESH_SHARDS
    grads = []
    for i in range(MESH_SHARDS):
        part = {k: v if k == "rng" else v[i * rows:(i + 1) * rows] for k, v in batch.items()}
        grads.append(arch.loss_and_grads(state.params, part)[2])
    cpu, dev = torch.device("cpu"), state.params["item_emb"].device
    grads_cpu = [opt_lib.tree_map(lambda t: t.cpu(), g) for g in grads]
    names = sorted(grads[0])
    off = 0
    scale_ulps = 0.0
    for g, h in zip(grads, grads_cpu):
        for n in names:
            zero = torch.zeros_like(g[n])
            q_c, s_c, _ = compression.quantize_part(g[n], zero)
            q_h, s_h, _ = compression.quantize_part(h[n], zero.cpu())
            off += payload_diffs(q_c, q_h, h[n], s_h)
            ulp = float(np.spacing(np.float32(float(s_h))))
            scale_ulps = max(scale_ulps, abs(float(s_c) - float(s_h)) / ulp)
    if scale_ulps > 2:
        fails.append(f"compressed scales {scale_ulps:.1f} ulp apart")
    efs = [compression.init_ef(g) for g in grads]
    tot_c, _ = compression.compressed_grad_allreduce(grads, efs, dev)
    tot_h, _ = compression.compressed_grad_allreduce(
        grads_cpu, [compression.init_ef(h) for h in grads_cpu], cpu)
    tot_err = 0.0
    for n in names:
        want = tot_h[n].double()
        tot_err = max(tot_err, float((tot_c[n].cpu().double() - want).abs().max())
                      / max(float(want.abs().max()), 1e-30))
    if tot_err > MESH_TOL:
        fails.append(f"compressed totals card vs CPU {tot_err:.3g} of max |value| apart")
    del grads_cpu, tot_h
    exact = {n: collectives.fold_sum([g[n] for g in grads], dev) for n in names}
    acc = {n: torch.zeros_like(exact[n]) for n in names}
    ef_err = []
    for r in range(MESH_EF_ROUNDS):
        tot, efs = compression.compressed_grad_allreduce(grads, efs, dev)
        for n in names:
            acc[n] += tot[n]
        if r in (0, MESH_EF_ROUNDS - 1):
            ef_err.append(max(float((acc[n] / (r + 1) - exact[n]).abs().max())
                              / max(float(exact[n].abs().max()), 1e-30) for n in names))
    comp_ms, how_c = device_ms(lambda: compression.compressed_grad_allreduce(
        grads, efs, dev), iters=3)
    fold_ms, how_f = device_ms(lambda: [collectives.fold_sum([g[n] for g in grads], dev)
                                        for n in names], iters=3)
    grid = [[grads[0], grads[1]], [grads[2], grads[3]]]
    hier_err = 0.0
    for n in names:
        h = collectives.hierarchical_psum([[c[n] for c in pod] for pod in grid], dev)
        hier_err = max(hier_err, float((h - exact[n]).abs().max())
                       / max(float(exact[n].abs().max()), 1e-30))
    if hier_err > MESH_TOL:
        fails.append(f"hierarchical_psum {hier_err:.3g} of fold_sum's max |value| apart")
    hier_ms, how_h = device_ms(lambda: [collectives.hierarchical_psum(
        [[c[n] for c in pod] for pod in grid], dev) for n in names], iters=3)
    n_el = sum(grads[0][n].numel() for n in names)
    print(f"  compressed all-reduce over {MESH_SHARDS} data shards of {rows} rows "
          f"({n_el:,} gradient values a shard): int8 payloads card vs CPU equal but {off} "
          f"entries at half-integers, scales within {scale_ulps:.1f} ulp, totals within "
          f"{tot_err:.3g} of max |value|; the int8 sum vs fold_sum {ef_err[0]:.3g} of max "
          f"|value| after 1 round, {ef_err[1]:.3g} as the mean of {MESH_EF_ROUNDS} rounds of "
          f"error feedback; hierarchical_psum on 2 x 2 (pod, data) within {hier_err:.3g} of "
          f"fold_sum; device ms compressed {comp_ms:.3f} ({how_c}), fold_sum {fold_ms:.3f} "
          f"({how_f}), hierarchical {hier_ms:.3f} ({how_h}) [{smi}]")


def phase_mesh():
    """11. The mesh path: the specs, MIND's Trainer on a mesh, compression
    and the hierarchical sum on the card."""
    smi = nvidia_smi()
    t = time.perf_counter()
    fails: list[str] = []
    print("Mesh path:")
    mesh_specs(smi)
    arch, state, batch = mesh_train(smi, fails)
    mesh_collectives(arch, state, batch, smi, fails)
    del state, batch
    torch.cuda.empty_cache()
    print(f"  mesh path {time.perf_counter() - t:.1f} s")
    assert not fails, "mesh path: " + "; ".join(fails)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    phase_setup()
    results: dict = {}
    stream, warm = phase_kernels(results)
    batches, hh_calls, sync_lat = phase_main(stream, warm, results)
    phase_heavy_hitter(results, hh_calls)
    del hh_calls
    phase_staged(stream, warm, batches, results)
    phase_async(stream, warm, batches, sync_lat)
    phase_async(stream, warm, batches, sync_lat, switch_s=0.0005)
    torch.cuda.empty_cache()
    phase_recsys(*phase_recsys_kernels(results), results)
    # after the recsys phases: each server's ingest stream leaves cuBLAS a
    # 32 MiB workspace for the life of the process, which would otherwise
    # sit in every recsys peak-memory reading
    phase_cached(stream, warm, batches, results)
    phase_durable(stream, warm, batches)
    phase_sharded(stream, warm, batches)
    phase_launcher()
    phase_comparison()
    phase_training(results)
    torch.cuda.empty_cache()
    phase_models()
    torch.cuda.empty_cache()
    phase_gnn(results)
    torch.cuda.empty_cache()
    phase_mesh()
    for name, r in results.items():
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        print(f"{name:9s} kernel {r['ms']:.4f} ms device ({r['host_ms']:.4f} ms a call "
              f"from the host)  plain {r['plain_ms']:.4f} ms  library {lib}  "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})  "
              f"launches on its path {r['launches']}")
    print(f"total {time.perf_counter() - t0:.1f} s")
    kernels = [dict(name=n, route="cuda",
                    source=f"src/repro_torch/csrc/{CSRC_OF.get(n, n)}.cu",
                    replaces=SOURCES[n], launches=results[n]["launches"],
                    max_abs_err=results[n]["max_abs_err"], ms=results[n]["ms"],
                    plain_ms=results[n]["plain_ms"], bound_ms=results[n]["bound_ms"],
                    bound_by=results[n]["bound_by"], library_ms=results[n]["library_ms"])
               for n in SOURCES]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
