#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run if it fails:

1. Build: ``nvcc`` compiles the CUDA sources of ``kernels/csrc`` from the
   checkout into ``build/repro_torch/<hash>/``, one process per source.
2. Kernels against their plain PyTorch versions at the slice's shapes:
   ``gam_retrieve`` (rows, counts and skip map exact, scores within 4 ulp),
   ``tess_project`` (exact except certified near-ties) and ``gam_score``
   (f32 and bf16 within 1e-6; the elements that differ at all are counted:
   the plain version's f64 emulation of an fma double-rounds about one step
   in 2^29).
3. The slice: a 1,048,576-item catalog of the paper's schema (k=10,
   parse_tree, threshold 0.2, min_overlap 2, kappa 10), cluster-sorted with
   64 clusters at sigma 0.05, posting bucket sized to the longest list, is
   built with ``open_retriever(..., device="cuda")`` and answers 8 requests
   of 256 cluster-sorted queries (after one warm-up request).  The launch
   counts of all three kernels must move; the served ids must equal the
   dense oracle ``masked_topk`` (through the ``gam_score`` kernel) exactly;
   ``exact=True`` must equal ``brute``; a snapshot must round-trip
   bit-identically.  ``tess_project``'s launches are counted by rows.  Recovery accuracy against ``brute``, the discarded
   fraction, the scored-tile fraction, request latency and the device time
   of ``gam_retrieve`` within a request (CUDA events around its launch
   against the request's host clock) are printed.
3b. The compressed catalog: the same catalog under ``quantize="int8",
   rerank_factor=4, compress_postings=True``, built on the card, answers the
   same warm-up and 8 requests.  ``gam_retrieve_q`` must launch and the f32
   ``gam_retrieve`` must not; the slab built on the card must equal the CPU
   slab byte for byte; ``gam_retrieve_q`` must agree with its plain version
   (pool rows, counts and skip map exact, scores within 4 ulp); candidates
   (counts and skip map) must equal the f32 path's; on every query the
   served ids must be the exact top kappa of the pool's rows under the
   dense oracle's scores, and the served scores within 4 ulp of those; on
   every query whose pool holds the dense oracle's top kappa the served
   ids must equal the oracle's; a snapshot (varint postings, int8 slab)
   must round-trip bit-identically.  Recall against ``brute``, id
   agreement with the f32 path, pool-miss rows, how far each missed oracle
   row leads the pool's last row against the int8 score-error bound,
   factor bytes and request latency are printed.
   A pool of 256 (past the kernel's shared-memory lists) must agree with
   the plain version too; the int8 kernel's time at pools of 10, 40, 128
   and 256 is printed.
3c. The paper's inverted index and the §5.1 baselines, on phase 3's
   catalog and requests.  ``open_retriever(RetrieverSpec(backend="gam",
   ...), device="cuda")`` (the CSR on the card, the map through
   ``tess_project``, the candidates a chunk of queries at a time scored
   through ``gam_score``; both launch counts must move) answers the same
   warm-up and 8 requests: ids and ``n_scored`` must equal ``gam-device``'s
   on every
   query (phase 3's bucket leaves no spill, so the candidate sets are the
   same) and scores be within 4 ulp of them; ``exact=True`` must equal
   ``brute`` and a snapshot round-trip bit for bit.  The same under
   ``compress_postings=True`` must answer bit-identically to the flat
   index and round-trip too.  ``srp-lsh``, ``superbit-lsh``, ``cro`` and
   ``pca-tree`` at their default options answer a warm-up and 2 requests:
   ``exact=True`` must equal ``brute``, and each answer must be the exact
   top kappa of the backend's own candidates under the dense oracle
   (``masked_topk`` on their mask, scores within 4 ulp, ``n_scored`` their
   count).  Build seconds, postings and compressed index bytes, patterns,
   hits walked and candidates a query, recall@10 against ``brute``, the
   discarded fraction, request p50/p99 (host clock) and one request's time
   by stage (map, posting walk, scoring and top-kappa) are printed.
4. Timings: each kernel's median time, its plain version's, and its bound
   on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32, 989 TFLOP/s bf16); for the
   fused retrieval kernel also its route and its other floors (popcounts
   at 16 a clock an SM, one pass and Q / Q_t passes over the kept tiles);
   for ``tess_project`` (1,048,576 rows) and ``gam_score`` (the oracle's
   256 x 1,048,576) also the time in a CUDA graph, and for ``gam_score``
   its yardstick ``torch.where(mask != 0, u @ v.T, NEG)`` (two PyTorch
   calls, TF32 off; the port never calls it).
5. LM serving: tinyllama-1.1b at full width (22 layers, d 2048, 32 / 4
   heads, d_ff 5632, vocab 32,000 padded to 32,256) in bf16 with
   ``use_decode_kernel=True``, random weights from a seed, answers
   ``Engine.generate`` (greedy, batch 8, prompts of 1,024 tokens, 32 new
   tokens, capacity 1,064): one warm-up and 3 timed calls, each of which
   must launch ``decode_attention`` exactly 22 x 31 times.  Teacher-forced
   on the kernel path's tokens, the einsum path (``use_decode_kernel=False``)
   must give bf16 logits within 8 bf16 steps of the largest logit; at f32
   the greedy picks must be equal except on near-ties (the einsum path's top
   two within twice the paths' logit difference), counted, and the logits
   within 1e-3.  ``decode_attention`` is timed at this shape and at one
   layer of the ``decode_32k`` shape (batch 128, S 32,768), beside its plain
   version, its bound and ``scaled_dot_product_attention``, and held at both
   within one bf16 step of its plain version (rtol 2^-7, atol 1e-5; f32
   within 1e-5).  Prefill ms,
   decode-step p50/p99, tokens/s, the kernel's share of a step and peak
   device memory are printed.
5b. The GAM LM head: ``Engine(use_gam_head=True, gam_threshold=1.5,
   gam_min_overlap=2)`` on tinyllama narrowed to 4 layers, d 512, 8 / 1
   heads, d_ff 1,408, at the full vocab of 32,000 (the map runs at k = 512):
   batch 8, prompts of 128, 16 new tokens.  ``tess_project`` and
   ``gam_score`` must launch; each step's ids must equal ``masked_topk`` on
   the same masks; both kernels are held against their plain versions at
   this path's shapes: ``tess_project`` on the vocab (32,000 x 512, one
   launch) and on one step's hidden states (8 x 512, a launch a step),
   ``gam_score`` at 8 x 32,000 x 512, each timed eagerly and in a CUDA
   graph (``gam_score`` beside its yardstick).  Vocab rows scored per step, the discarded fraction
   and the agreement with the exact head are printed.
6. The service tier: the same catalog, schema and request generator behind
   ``open_retriever(RetrieverSpec(backend="sharded", n_shards=8,
   min_overlap=2, kappa=10, batch_size=256, ...), device="cuda")``, posting
   bucket sized so no shard spills.  12 requests of 256 queries, through
   ``query`` and through the ``Microbatcher`` in turns, with 8 batches of
   1,024 fresh + 1,024 rewritten upserts and 512 deletes streamed between
   them; then a background ``compact(async_=True)`` advanced one slice per
   request until it swaps; then hot traffic on 4 clusters and a
   ``repartition`` (at least two bn-groups required); then a 64-row delta
   and a ``snapshot`` -> ``restore``.  On every request the served ids must
   equal the dense oracle (the base's ``query_dense_reference`` and
   ``masked_topk`` over the delta, on the ``gam_score`` kernel), scores
   within 4 ulp, and ``gam_retrieve`` must launch once per bn-group plus
   once for a non-empty delta; after the swap and after the repartition the
   answers must equal a fresh ``gam-device`` build over the catalog bit for
   bit, the heterogeneous layout the uniform one, and the restored service
   the live one.  Latency and queries/s come from three timed windows of 50
   requests each, run back to back and held against the oracle after the
   window: the uniform layout with the streamed delta through ``query`` and
   through the ``Microbatcher``, and the repartitioned layout through
   ``query``.  Each window prints its request p50/p99/max (host clock) and
   its queries over its wall time; launches per request, the delta size,
   compaction slices, groups, device bytes and the ``ServiceMetrics``
   snapshot are printed too, with the device time of ``gam_retrieve``
   within 20 more requests of the uniform layout, and ``tess_project``'s
   launches on the main path by their rows, each size timed eagerly and in
   a CUDA graph beside its bound; a request's queries (256 rows), a
   compaction slice (262,144) and the largest rebuild are held against the
   plain version and join the ``kernels`` line.
6b. The same service under ``quantize="int8", rerank_factor=4,
   compress_postings=True``: 3 requests, whose served ids must be the exact
   top kappa of each query's pool and equal the dense oracle wherever the
   pool covers it; ``gam_retrieve_q`` launches once a request and the f32
   kernel never.
7. ``flash_prefill`` and ``gam_coarse`` through ``repro_torch.kernels.ops``
   at the shapes of ``tests/test_kernels.py`` (f32 and bf16, and S = 100)
   and at the LM substrate's: ``flash_prefill`` on layer 0's q/k/v of phase
   5's prefill (B 8, S 1,024, Hkv 4, G 8, hd 64, bf16, and the same q/k/v
   in f32), also against the model's blockwise attention; ``gam_coarse`` at
   B 8 on the ternary patterns of tinyllama's unembedding rows (d 2,048,
   V 32,000) and of phase 5b's (d 512), and at B 1 and B 64 on tinyllama's.
   Each is held against its plain version (``flash_prefill`` f32 within
   2e-5; bf16 within one bf16 step, rtol 2^-7 with an atol of 1e-5, since
   both sides compute in f32 and round once; ``gam_coarse`` within the
   rounding bound of two f32 sums of d terms, and, on inputs whose answer
   lies in h's third bf16 term (``gam_coarse.third_term_probe``, V 4,096),
   within an eighth of a two-term product's error against the f64
   product: the ``third_term`` of its rows) and timed beside it, its
   bound (``flash_prefill``: q.k once and p.v three times at the bf16
   tensor-core rate, the exact split of p; ``gam_coarse``: its bytes, or
   three bf16 mma a product at the bf16 rate) and its library yardstick
   (``scaled_dot_product_attention``; ``torch.mm`` on a pre-cast f32 copy
   of the patterns, TF32 off, then the scale).  ``gam_coarse`` is timed in
   a CUDA graph, as ``decode_attention`` at the slice's shape, with the
   patterns warm in L2 (``ms``) and cold (``cold_ms``: calls walk copies
   whose total passes twice the 50 MB L2).
8. The paper's learning loop (``configs/gam_mf``: k 10).  8a: the §6.2
   surrogate ``movielens_like_ratings(seed=0)`` (943 x 1,682, 73,786
   ratings) through ``train_mf(cfg=gam_mf.MF)`` (lr 0.005, 25 epochs,
   batch 8,192) on the card twice: U, V and the mse history must be
   bit-identical and the mse must fall; ``gam-device`` over V (bucket of
   the catalog's size, so nothing spills) answers all 943 users at kappa
   10, ids equal to the dense oracle (scores within 4 ulp), recall@10
   against ``brute`` printed.  8b: one epoch at MovieLens-20M's shape
   (138,493 x 26,744, density 0.0054, about 17 M ratings after dedupe)
   twice, bit-identical; the generator's host seconds, the call's seconds
   and ratings/s printed.  8c: ``DriftSimulator`` (64 users, 1,048,576
   items, seed 17, drift 0.2, hot half, 8,192 events a round) feeds
   ``StreamingMF`` (lr 0.5, momentum 0.6, batch 1,024, users frozen)
   warm-started from it; ``PushPolicy(min_cos=0.995, staleness_s=4.0)`` on
   a round clock, seeded with the catalog, lands each round's passers in
   one ``upsert`` into a live ``sharded`` retriever (phase 6's 8 shards,
   no list able to spill); 10 rounds, the 64 users queried each round and
   held against the dense oracle; ``tess_project`` and ``gam_retrieve``
   must launch in the rounds and a factor must be pushed; afterwards the
   live answers (exact False and True) must equal a ``sharded`` rebuild
   over the pushed catalog bit for bit.  Pushes, suppressions, staleness,
   ``partial_fit`` / flush / upsert / query times, the delta's rows and
   recall@10 online against a frozen retriever at rounds 1, 5 and 10 are
   printed.  The kernels are held against their plain versions on the
   inputs the rounds gave them (the oracle and the frozen queries do not
   count toward the launches).  8d: the paper's §6.2 chain,
   ``examples/movielens_repro_torch.py``'s ``main`` in this process on
   the card, nothing cut: ``train_mf`` on the surrogate, the §6 line-up
   (``gam``, ``gam-sparse``, SRP-LSH, Super-bit LSH, CRO, the PCA tree)
   over 200 users at kappa 10 with the example's assertions (GAM accuracy
   > 0.85, discard > 0.3, at least as accurate as each baseline within
   0.15 of its discard), the streaming replay of the 73,786 ratings into
   a live 2-shard ``sharded`` index (= a rebuild bit for bit) and the 400
   cached Zipf requests (``wrong == 0``).  ``gam_retrieve``,
   ``tess_project`` and ``gam_score`` must each launch more than once;
   the line-up must equal the port's on the CPU on the card's factors
   (``gam`` and ``gam-sparse`` per user; the baselines' discard but for
   boundary users, each explained by a hash code or PCA leaf apart,
   counted); every captured call is held to its plain version.  Stage
   seconds, the table, pushes and the cache's hit rate are printed.
9. Multi-host serving.  9a: two processes (``chip_smoke.py
   --multihost-worker``, spawned by ``repro_torch.launch.procs``) join
   one gloo group and share the card (the phase fails, naming it, when
   the compute mode is exclusive).  Each opens phase 6's catalog and
   settings as ``sharded-multihost`` at 2 hosts, replication 2, beside an
   in-process ``sharded`` retriever, and drives the same lifecycle:
   build, a query and an exact one, 1,024 fresh + 1,024 rewritten upserts
   and 512 deletes, a timed window of 100 requests (request p50/p99 on
   the host clock, the ``host_topk`` / ``collective_gather`` /
   ``collective_merge`` spans; host 0 then times ``sharded`` alone over
   the same requests while host 1 waits, and holds 2 of them against the
   dense oracle), ``mark_down(1)``, a background compaction with queries
   mid-flight, a repartition, a snapshot from host 0 restored on both;
   then a build at replication 1, where each host holds only its slice
   (its device bytes and ``memory_allocated`` printed).  Every answer
   must equal the ``sharded`` one bit for bit (ids, scores, ``n_scored``,
   discarded fractions) and every request launch ``gam_retrieve`` once
   per bn-group of the slices routed to its host plus once for the delta.
   One slice's launch is held against its plain version and timed, each
   host in turn (the ``gam_retrieve@multihost_slice`` rows).  9b: ``python
   -m repro_torch.launch.serve --service --hosts 2 --replication 2
   --fail-host 1 --items 1048576 --dim 10 --shards 8 --requests 64
   --verify --snapshot chiprun_out/mh_snapshot.npz --metrics-out
   chiprun_out/mh_metrics.prom`` must exit 0 with ``0 WRONG``, a failover
   of host 1, the bit-identical snapshot probe and kernel launches on
   both hosts; then ``--service`` at the same size and the LM mode at
   ``--reduced`` (``decode_attention`` launched).  Both processes share
   one card: the times measure the placement's overhead, not scaling.
10. The other LM families at their published widths, bf16, seeded random
   weights, each through ``Engine.generate`` (greedy, 32 new tokens, one
   warm-up and 2 timed calls, launches counted from 0 around them) with
   ``use_decode_kernel=True``, as the launcher serves them: 10a
   olmoe-1b-7b (16 layers, 64 experts top 8; batch 8, prompts of 1,024,
   capacity 1,064), 10b deepseek-v2-236b with its depth cut to 4 of 60
   layers (60 need about 476 GB; MLA, 160 experts top 6 + 2 shared; batch
   8, prompts of 1,024), 10c mamba2-780m (48 layers; batch 8, prompts of
   1,024: 4 SSD chunks), 10d recurrentgemma-9b (38 layers: 12 groups + 2
   tail; batch 4, prompts of 2,304, past the 2,048 window, so the ring
   wraps), 10e whisper-tiny (batch 8, frames (8, 1,500, 80), prompts of 4)
   and 10f internvl2-26b whole (48 layers; batch 8, 256 image embeddings
   of 3,200 + 768 tokens, capacity 1,064).  ``decode_attention`` must
   launch exactly layers x 31 times a call where the reference's decode
   takes the kernel branch (10a, 10e, 10f) and never elsewhere (MLA, SSM,
   the hybrid's ring).  10a, 10e, 10f: teacher-forced on the kernel path's
   tokens, the einsum path's bf16 logits within 8 bf16 steps of the
   largest (phase 5's tolerance), for MoE on each row's steps before the
   first position where the two paths' routing differs (``RoutingLog``:
   a near-tie of gates broken the other way after rounding in another
   order; counted and printed); ``decode_attention`` at each layout on the
   live cache, held within one bf16 step of its plain version and timed
   beside it, SDPA and its bound (the ``decode_attention@<arch>`` rows).
   f32 with fresh weights, batch 2: prefill + teacher-forced decode steps =
   the forward over the same tokens within 1e-3 (10a under a dropless
   capacity factor 8.0, 16 layers; 10b under 27.0 at 2 layers, 36 GB; 10d
   over the wrapped ring), within 1e-2 for 10c (1,024 + 256 steps against
   5 chunks, and a 1,000-token prefill, the single-chunk branch, against 4
   chunks; ``SSD_FWD_TOL`` says why).  Prefill ms, decode-step p50/p99,
   tokens/s, peak memory (above what earlier phases hold), the kernel's
   share of a step, dropped (token, slot) pairs a decode step (10a, 10b:
   capacity 1 at batch 8) and 10b's latent-cache bytes against a per-head
   K/V cache are printed.
11. LM training (no kernel of its own: the reference's training forward
   reaches no Pallas call; autograd runs through the model's plain torch).
   11a: tinyllama-1.1b at its published widths in bf16, seeded weights,
   trains through ``launch.steps.make_train_step`` on
   ``TokenPipeline(vocab=32,000, seed=0)`` for 20 steps (AdamW lr 1e-3,
   warmup 4) under the published ``remat="full"`` (each block keeps its
   inputs and runs its forward again in the backward) at the largest of
   batch 16 x seq 1,024, 8 x 1,024, 4 x 1,024 and 8 x 512 that fits
   (printed): every loss finite, the mean of the last 5 below
   the first 5's, the held-out nll (4 batches, seed 10,000,
   ``eval_batches``) falling.  Params and the AdamW state (bf16, f32,
   int32) go through ``save_checkpoint`` -> ``restore_checkpoint`` bit for
   bit, and the restored params' eval equals the live params'.
   ``Engine.generate`` from the restored params (``use_decode_kernel=True``,
   batch 8, prompts of 64, 8 new tokens) must launch ``decode_attention``
   22 x 7 times (counted from 0 around it) and give the live params'
   tokens.  ``make_gam_serve_step`` beside ``make_serve_step`` for 8 steps:
   each GAM pick is the f64 argmax over its own candidate set but for
   counted near-ties; the agreement with the exact head is printed.
   ``decode_attention`` is held to its plain version and timed at this
   layout (the ``decode_attention@trained_checkpoint`` row).  Step
   p50/p99 (CUDA events around each of the first 19 steps), forward +
   backward against the AdamW update, tokens/s, peak memory, checkpoint
   save/restore seconds and the 20th step under ``torch.profiler`` (device
   activities, busy share, top kernels) are printed with the card's name
   and power limit.  Then 4 steps at 8 x 1,024 under each of remat
   ``full``, ``dots`` and ``none`` from one init: step p50 (the last 3,
   CUDA events) and ``max_memory_allocated`` a mode, the first step's loss
   the same (1e-5 relative); a mode that does not fit is printed as such.
   11b: one f32 step of tinyllama at 2 layers, d 256 (remat ``full``) on
   the card and on the CPU from the same weights: loss within 1e-5
   relative, every gradient leaf within 1e-4 x its largest |g|, params
   within 1e-5 but where AdamW's update is eps-dominated (counted); on
   the card ``full`` and ``dots`` against ``none``: loss within 1e-5
   relative, every gradient leaf within 1e-4 x none's largest |g|, the
   bit-equal leaves counted.  11c: olmoe-1b-7b at its published widths
   cut to 2 of 16 layers, bf16, batch 8 x 512, 3 steps under ``full``
   (finite loss and gradients, aux > 0, dropped pairs printed; ``full``
   and ``dots`` against ``none`` as in 11b), and mamba2-780m,
   recurrentgemma-9b, whisper-tiny and internvl2-26b one step each at
   their reduced configs (finite loss, every gradient leaf finite).  11d:
   ``python -m repro_torch.launch.train --arch olmo-1b --reduced --steps
   12 --batch 2 --seq 32 --vocab 128`` and
   ``examples/{train_lm,quickstart,serve_stream,serve_gam}_torch.py``, each
   a process on the card, started together: each must exit 0 with its own
   assertions holding.
12. A device mesh: two ``chip_smoke.py --mesh-worker`` processes share the
   card in one group (gloo for both devices; DTensor's all-gather and
   reduce-scatter staged through host memory, ``launch.mesh.STAGED``,
   printed with calls, bytes and seconds).  12a: the 1M catalog as one
   ``sharded`` index (8 shards) placed over a 2-rank ``items`` mesh, 4
   shards a rank: 8 requests of 256 must equal single-device ``sharded``
   in the same process bit for bit (ids, scores, ``n_scored``), each rank
   launching ``gam_retrieve`` once a request and ``tess_project`` for its
   maps (counted from 0 around the requests); the kernel over a rank's
   rows is held against its plain version and timed; each rank's resident
   index bytes, request p50/p99 beside single-device.  12b: tinyllama-1.1b
   at published widths, depth cut to 8 of 22 layers, bf16, remat ``full``,
   4 steps of the unchanged ``make_train_step`` on DTensors on (data 2,
   model 1) and (data 1, model 2) at the largest of 4 x 1,024, 2 x 1,024,
   4 x 512 (global) that fits 0.48 of the card a rank (the first step
   probes it): the loss must fall, a rank's resident param + moment bytes
   stay the specs' share; at f32 on 2 layers, d 256, the sharded loss
   under remat ``full`` within 1e-5 relative and every gradient leaf
   within 1e-4 of its largest against one rank's without remat.  12c:
   tinyllama-1.1b serving greedily through the prefill and serve steps on
   (data 2, model 1), the cache sharded on batch: the first token of every
   row equal to single-device ``Engine``'s, the steps each row holds
   counted, ``decode_attention`` launched 22 x 31 times a rank and held
   against its plain version and SDPA on the rank's sequences; at f32 on
   2 layers, d 256, the sharded prefill and 31 decode steps give one
   device's tokens at every step, every cache leaf within 1e-5.
13. The cost analysis.  13a: ``python -m repro_torch.launch.dryrun``
   (tinyllama-1.1b ``train_4k`` and ``decode_32k`` on the 16 x 16 mesh,
   ``decode_32k`` with ``--multi-pod``), ``... launch.roofline`` (``train_4k``)
   and ``... launch.perf`` (olmoe-1b-7b ``decode_32k``, baseline, cap10,
   baseline+mesh1), processes on the host started together (meta tensors
   over a fake group; no card): each must exit 0 with every record of
   status ``ok``, printed.  13b: tinyllama-1.1b at its published widths in
   bf16, phase 5's decode step (batch 8, capacity 1,064, after a
   1,024-token prefill, ``decode_attention`` launched 22 times, counted
   from 0 around it) and phase 11a's train step (remat ``full``, 8 x
   1,024) are each counted once on meta tensors and once on the card's:
   flops by unit,
   bytes and kernel entries must be equal, and the counted argument bytes
   equal the tensors' bytes.  Each step is timed uncounted (p50, CUDA
   events) against its roofline bound on one card (the larger of the
   compute and memory terms of ``launch/roofline.py``); a share above
   1.05 fails (the count left out work).  The counted peak is printed
   beside ``torch.cuda.max_memory_allocated``; the train step without
   remat is counted on meta and its bound set against 11a's p50 of it;
   every figure with the
   card's name and power limit; ``decode_attention`` is held to its plain
   version and timed at this step's layout (the
   ``decode_attention@cost13b`` row).
Then the ``kernels`` JSON line (every kernel, at each shape above), the
card's name and power limit, and the result line.

Exits non-zero, printing no result, without a CUDA device or without the
rest of the repository.  Imports nothing of JAX.
"""
from __future__ import annotations

import collections
import dataclasses
import importlib
import importlib.util
import json
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

N_ITEMS = 1 << 20
K, N_CLUSTERS, SIGMA, THRESHOLD, MIN_OVERLAP, KAPPA = 10, 64, 0.05, 0.2, 2, 10
N_REQUESTS, BATCH = 8, 256
RERANK = 4                     # int8 re-rank pool = KAPPA * RERANK
WIDE_POOL = 256                # a pool past the kernel's shared-memory lists
ULP = 4
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_FLOPS = 67e12              # H100 SXM data sheet, outside the tensor cores


def card_name_and_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``'s
    first line."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    return smi[0] if smi else "not available"


def fail_unless(cond, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def clustered_catalog(n, k, n_clusters, sigma, seed):
    """Cluster-sorted unit rows around ``n_clusters`` unit centers."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, k)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    per = -(-n // n_clusters)
    items = (np.repeat(centers, per, axis=0)[:n]
             + sigma * rng.normal(size=(n, k)).astype(np.float32))
    items /= np.linalg.norm(items, axis=1, keepdims=True)
    return items, centers


def requests(centers, n, batch, sigma, seed):
    """``n`` batches of queries drawn around centers, sorted by home cluster."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        sel = np.sort(rng.integers(0, len(centers), batch))
        u = centers[sel] + sigma * rng.normal(
            size=(batch, centers.shape[1])).astype(np.float32)
        out.append((u / np.linalg.norm(u, axis=1, keepdims=True))
                   .astype(np.float32))
    return out


def near_tie_rows(z: np.ndarray) -> np.ndarray:
    """Rows whose top two float64 scaled running sums of Algorithm 2 are
    within 4 f32 ulp: their t* depends on rounding."""
    az = -np.sort(-np.abs(np.asarray(z, np.float64)), axis=-1)
    zs = np.cumsum(az, axis=-1) / np.sqrt(np.arange(1, az.shape[-1] + 1))
    top2 = -np.sort(-zs, axis=-1)[:, :2]
    return top2[:, 0] - top2[:, 1] <= ULP * np.spacing(
        top2[:, 0].astype(np.float32))


def max_ulp(a, b) -> int:
    a = np.ascontiguousarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.ascontiguousarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max()) if a.size else 0


def time_ms(torch, fn, reps: int) -> float:
    """Median device time of ``fn`` over ``reps`` runs (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def graph_ms(torch, fn, calls: int = 20, reps: int = 10) -> float:
    """Device time of one call of ``fn``: ``calls`` calls captured in one
    CUDA graph, the graph replayed (CUDA events, median of ``reps``), over
    ``calls``.  At microsecond kernels this leaves out the host's launch
    overhead, which the events around eager calls would time instead."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    torch.cuda.synchronize()
    return time_ms(torch, graph.replay, reps) / calls


L2_BYTES = 50e6                # H100 SXM data sheet


def cold_copies(torch, x, total: float = 2 * L2_BYTES) -> list:
    """``x`` and clones of it, enough that together they pass ``total``
    bytes: a call that walks them in turn finds its copy cold in L2."""
    n = max(2, -(-int(total) // (x.numel() * x.element_size())))
    return [x] + [x.clone() for _ in range(n - 1)]


def cold_graph_ms(torch, fns, rounds: int = 4, reps: int = 10) -> float:
    """Device time of one call with its large input cold in L2: ``fns``
    make the same call on different copies of that input (``cold_copies``),
    captured in turn ``rounds`` times in one CUDA graph and replayed."""
    for fn in fns:
        fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(rounds):
            for fn in fns:
                fn()
    torch.cuda.synchronize()
    return time_ms(torch, graph.replay, reps) / (rounds * len(fns))


def rerank_choice(torch, pool_rows, sc, kappa, topk_desc, neg):
    """What the exact re-rank must serve: the top ``kappa`` of each query's
    pool rows under the exact scores ``sc`` (Q, N), ordered (score desc, row
    asc).  Returns numpy (scores, ids), empty slots as (0, -1)."""
    n = sc.shape[1]
    key = torch.sort(torch.where(pool_rows >= 0, pool_rows.long(), n),
                     dim=1).values                  # row asc, empties last
    s = torch.where(key < n, torch.gather(sc, 1, key.clamp(max=n - 1)), neg)
    vals, col = topk_desc(s, kappa)                 # ties: column = row asc
    vals = vals.cpu().numpy()
    ids = torch.gather(key, 1, col).cpu().numpy()
    empty = vals <= neg / 2
    return np.where(empty, 0, vals), np.where(empty, -1, ids)


def miss_gaps(o_vals, o_ids, pool_rows, sc_last, err, bn):
    """For each oracle row (``o_ids`` (Q, kappa), -1 empty) that a full pool
    ``pool_rows`` lacks: its exact-score lead over the pool's last row
    (``sc_last`` (Q,)), the int8 score-error bound ``err`` (Q, n_blocks) of
    its own block, and that bound summed with the last row's block's, the
    most a quantized order can invert."""
    missed = ((o_ids[:, :, None] != pool_rows[:, None, :]).all(-1)
              & (o_ids >= 0) & (pool_rows[:, -1:] >= 0))
    q, _ = np.nonzero(missed)
    own = err[q, o_ids[missed] // bn]
    return (o_vals[missed] - sc_last[q], own,
            own + err[q, pool_rows[q, -1] // bn])


def bound_ms(n_bytes: float, flops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def matmul_where(torch, u, v, mask):
    """``gam_score``'s function as two PyTorch calls, its yardstick (TF32 is
    off): a full matrix product, then the mask.  The port never calls it."""
    from repro_torch.kernels.gam_score import NEG
    return torch.where(mask != 0, u @ v.T, NEG)


def sm_clock_hz() -> float:
    """The card's top SM clock (``nvidia-smi``), for the popcount floor."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60).stdout
    return float(out.split()[0]) * 1e6


class Spans:
    """While active, CUDA events around every call of ``module.name``: the
    device span of each launch, read against a request's host clock.  The
    function's body counts its launches on the module attribute, this
    wrapper, so the count carries over both ways."""

    def __init__(self, torch, module, name, sizes=False):
        self.torch, self.module, self.name = torch, module, name
        self.events, self.rows = [], []
        self.sizes = sizes

    def __enter__(self):
        orig = self.orig = getattr(self.module, self.name)
        torch = self.torch

        def timed(*args, **kw):
            if self.sizes:                   # rows of the first argument
                self.rows.append(int(args[0].shape[0]))
                return orig(*args, **kw)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = orig(*args, **kw)
            end.record()
            self.events.append((start, end))
            return out
        timed.launches = orig.launches
        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *exc):
        self.orig.launches = getattr(self.module, self.name).launches
        setattr(self.module, self.name, self.orig)

    def take(self) -> tuple[float, int]:
        """(device ms of the spans since the last take, their number)."""
        self.torch.cuda.synchronize()
        ms = sum(a.elapsed_time(b) for a, b in self.events)
        n = len(self.events)
        self.events.clear()
        return ms, n


def request_share(torch, serve, spans, n: int) -> dict:
    """``n`` requests through ``serve()``: each one's host-clock latency and
    the device time of the wrapped kernel's launches within it."""
    rows = []
    for _ in range(n):
        t0 = time.perf_counter()
        serve()
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) * 1e3
        dev, launches = spans.take()
        rows.append((host, dev, launches))
    host, dev, launches = (np.array(x) for x in zip(*rows))
    return {"requests": n, "request_ms_p50": float(np.median(host)),
            "kernel_device_ms_p50": float(np.median(dev)),
            "kernel_share_p50": float(np.median(dev / host)),
            "launches_per_request": int(launches.max())}


# ------------------------------------------- 3c. the paper's inverted index

BASELINES = ("srp-lsh", "superbit-lsh", "cro", "pca-tree")
BASELINE_REQUESTS = 2


def drive(torch, r, reqs) -> tuple[list, list]:
    """Request 0 warms up; the rest are answered and timed (host clock)."""
    lat, answers = [], []
    for i, users in enumerate(reqs):
        t0 = time.perf_counter()
        res = r.query(users)
        dt = time.perf_counter() - t0
        if i:
            lat.append(dt * 1e3)
            answers.append(res)
    return lat, answers


def same_answer(a, b) -> bool:
    return all(np.array_equal(getattr(a, f), getattr(b, f))
               for f in ("ids", "scores", "n_scored", "discarded_frac"))


def snapshot_round_trip(torch, r, spec, users, what) -> None:
    from repro_torch.kernels import _build
    from repro_torch.retriever import open_retriever
    snap = _build.build_dir() / "chip_smoke_snapshot.npz"
    before = r.query(users)
    r.snapshot(str(snap))
    after = open_retriever(spec, snapshot=str(snap), device="cuda").query(
        users)
    snap.unlink()
    fail_unless(same_answer(after, before),
                f"{what}: snapshot round trip changed the answers")


def phase_gam_index(torch, report, items, reqs, spec, answers, brute):
    """3c: ``gam`` (flat and compressed CSR) and the four §5.1 baselines on
    phase 3's catalog and requests, against ``gam-device``'s answers, the
    dense oracle and ``brute``."""
    from repro_torch.core.retrieval import masked_topk, recovery_accuracy
    gs = importlib.import_module("repro_torch.kernels.gam_score")
    tp = importlib.import_module("repro_torch.kernels.tess_project")
    from repro_torch.retriever import RetrieverSpec, open_retriever
    dev = torch.device("cuda")
    out: dict = {}
    truth = [brute.query(u) for u in reqs[1:]]

    # --- gam, flat: the main path of this phase, counts read around it
    gspec = dataclasses.replace(spec, backend="gam")
    tp.tess_project.launches = gs.gam_score.launches = 0
    t0 = time.perf_counter()
    rg = open_retriever(gspec, items=items, device="cuda")
    index = rg.index                    # the CSR is built on first use
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    lat, got = drive(torch, rg, reqs)
    launches = {"tess_project": tp.tess_project.launches,
                "gam_score": gs.gam_score.launches}
    for name, n in launches.items():
        fail_unless(n > 0, f"{name} never launched on gam's path")
    ulp = 0
    for want, res in zip(answers, got):
        fail_unless(np.array_equal(res.ids, want.ids),
                    "gam ids differ from gam-device's")
        fail_unless(np.array_equal(res.n_scored, want.n_scored),
                    "gam n_scored differs from gam-device's")
        real = want.ids >= 0
        ulp = max(ulp, max_ulp(np.where(real, res.scores, 0),
                               np.where(real, want.scores, 0)))
    fail_unless(ulp <= ULP, "gam scores beyond 4 ulp of gam-device's")
    for users, b in zip(reqs[1:3], truth):
        ex = rg.query(users, exact=True)
        fail_unless(np.array_equal(ex.ids, b.ids)
                    and np.array_equal(ex.scores, b.scores),
                    "gam exact=True differs from brute")
    snapshot_round_trip(torch, rg, gspec, reqs[1], "gam")
    hits = []
    for users in reqs[1:]:
        q_tau, q_mask = rg._map(torch.as_tensor(users, device=dev))
        starts = index.offsets[q_tau]
        lens = torch.where(q_mask, index.offsets[q_tau + 1] - starts, 0)
        hits.append(lens.sum(dim=1).double().mean().item())
    # a request's time by stage (host clock, synchronised after each)
    from repro_torch.core.retrieval import candidate_topk
    u1 = torch.as_tensor(reqs[1], device=dev)

    def stage(fn, reps=3):
        ts = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return res, float(np.median(ts))

    (q_tau, q_mask), map_ms = stage(lambda: rg._map(u1))
    (qrow, rows, _), walk_ms = stage(lambda: index.candidates(
        q_tau, spec.min_overlap, q_mask))
    _, score_ms = stage(lambda: candidate_topk(u1, rg._items_dev, qrow, rows,
                                               KAPPA))
    del qrow, rows
    print(f"gam: a request by stage (median of 3, host clock): map "
          f"{map_ms:.3f} ms, posting walk {walk_ms:.3f} ms, scoring and "
          f"top-kappa {score_ms:.3f} ms")
    out["gam"] = {
        "stage_ms": {"map": map_ms, "walk": walk_ms, "score_topk": score_ms},
        "build_s": build_s, "postings_bytes": index.nbytes,
        "hits_per_query": float(np.mean(hits)),
        "candidates_per_query": float(np.mean([r.n_scored.mean()
                                               for r in got])),
        "p50_ms": float(np.percentile(lat, 50)),
        "p99_ms": float(np.percentile(lat, 99)), "latency_ms": lat,
        "launches": launches, "max_ulp_vs_gam_device": ulp}
    g = out["gam"]
    print(f"gam: build {build_s:.2f} s (map + CSR), postings "
          f"{index.nbytes} B, {g['hits_per_query']:.0f} hits walked and "
          f"{g['candidates_per_query']:.0f} candidates a query, request p50 "
          f"{g['p50_ms']:.3f} ms p99 {g['p99_ms']:.3f} ms; launches "
          f"{launches}; ids and n_scored = gam-device on all "
          f"{N_REQUESTS * BATCH} queries, max ulp {ulp}; exact=True = brute;"
          " snapshot bit-identical")

    # --- gam, compressed postings: the same answers bit for bit
    cspec = dataclasses.replace(gspec, compress_postings=True)
    t0 = time.perf_counter()
    rc = open_retriever(cspec, items=items, device="cuda")
    rc.index
    torch.cuda.synchronize()
    c_build_s = time.perf_counter() - t0
    c_lat, c_got = drive(torch, rc, reqs)
    fail_unless(all(same_answer(a, b) for a, b in zip(c_got, got)),
                "compressed gam differs from the flat gam")
    snapshot_round_trip(torch, rc, cspec, reqs[1], "compressed gam")
    _, c_walk_ms = stage(lambda: rc.index.candidates(
        q_tau, spec.min_overlap, q_mask))
    st = rc.stats()
    out["gam_compressed"] = {
        "walk_ms": c_walk_ms,
        "build_s": c_build_s, "index_bytes": st["index_bytes"],
        "n_patterns": st["n_patterns"], "flat_bytes": index.nbytes,
        "p50_ms": float(np.percentile(c_lat, 50)),
        "p99_ms": float(np.percentile(c_lat, 99))}
    print(f"gam compressed: index_bytes {st['index_bytes']} "
          f"({st['n_patterns']} patterns) against {index.nbytes} flat, "
          f"build {c_build_s:.2f} s, request p50 "
          f"{out['gam_compressed']['p50_ms']:.3f} ms p99 "
          f"{out['gam_compressed']['p99_ms']:.3f} ms (walk and decode "
          f"{c_walk_ms:.3f} ms); answers bit-identical to the flat gam; "
          "snapshot bit-identical")
    recall = [recovery_accuracy(r.ids, b.ids).mean()
              for r, b in zip(got, truth)]
    out["gam"]["recall"] = float(np.mean(recall))
    out["gam"]["discarded_frac"] = float(np.mean(
        [r.discarded_frac.mean() for r in got]))
    del rc, index

    # --- the §5.1 baselines at their default options
    breq = reqs[:BASELINE_REQUESTS + 1]
    for name in BASELINES:
        bspec = RetrieverSpec(cfg=spec.cfg, backend=name, kappa=KAPPA)
        t0 = time.perf_counter()
        rb = open_retriever(bspec, items=items, device="cuda")
        torch.cuda.synchronize()
        b_build_s = time.perf_counter() - t0
        b_lat, b_got = drive(torch, rb, breq)
        for users, res, b in zip(breq[1:], b_got, truth):
            ex = rb.query(users, exact=True)
            fail_unless(np.array_equal(ex.ids, b.ids)
                        and np.array_equal(ex.scores, b.scores),
                        f"{name} exact=True differs from brute")
            u = torch.as_tensor(users, device=dev)
            qrow, rows = rb._impl.candidates(u)
            mask = torch.zeros((len(users), len(items)), dtype=torch.bool,
                               device=dev)
            mask[qrow, rows] = True
            o_vals, o_ids = masked_topk(u, rb._items_dev, mask, KAPPA)
            o_vals, o_ids = o_vals.cpu().numpy(), o_ids.cpu().numpy()
            empty = o_vals <= gs.NEG / 2
            fail_unless(np.array_equal(res.ids, np.where(empty, -1, o_ids)),
                        f"{name}: answers are not the exact top kappa of "
                        "its own candidates")
            fail_unless(max_ulp(np.where(empty, 0, res.scores),
                                np.where(empty, 0, o_vals)) <= ULP,
                        f"{name}: scores beyond 4 ulp of the dense oracle")
            fail_unless(np.array_equal(res.n_scored,
                                       mask.sum(dim=1).cpu().numpy()),
                        f"{name}: n_scored differs from its candidates")
            del mask
        row = {"build_s": b_build_s,
               "recall": float(np.mean([recovery_accuracy(r.ids, b.ids).mean()
                                        for r, b in zip(b_got, truth)])),
               "discarded_frac": float(np.mean([r.discarded_frac.mean()
                                                for r in b_got])),
               "candidates_per_query": float(np.mean([r.n_scored.mean()
                                                      for r in b_got])),
               "p50_ms": float(np.percentile(b_lat, 50))}
        out[name] = row
        print(f"baseline {name}: build {b_build_s:.2f} s, recall@{KAPPA} "
              f"{row['recall']:.4f}, discarded {row['discarded_frac']:.4f} "
              f"({row['candidates_per_query']:.0f} candidates a query), "
              f"request p50 {row['p50_ms']:.3f} ms; exact=True = brute, "
              "answers = exact top kappa of its candidates")
        del rb
    print(f"gam: recall@{KAPPA} {out['gam']['recall']:.4f}, discarded "
          f"{out['gam']['discarded_frac']:.4f} (the §5.1 comparison at "
          f"{len(items)} items)")
    report["gam_index"] = out


# ------------------------------------------------------ LM serving phases

LM_ARCH = "tinyllama-1.1b"
LM_SHAPE = dict(n_layers=22, d_model=2048, n_heads=32, n_kv_heads=4,
                head_dim=64, d_ff=5632, vocab=32000)
LM_BATCH, LM_PROMPT, LM_NEW = 8, 1024, 32
LM_CAPACITY = LM_PROMPT + LM_NEW + 8       # as launch/serve.py sizes it
LM_CALLS = 3                               # timed, after one warm-up
# bf16 logits of the kernel path and the einsum path may differ by this many
# bf16 steps at the largest logit's magnitude: each of the 22 layers rounds
# its attention output and residual stream to bf16 (relative step 2^-8)
# after summing in another order, and the logits are themselves bf16
LM_BF16_ULPS = 8
LM_F32_TOL = 1e-3                          # f32 logits, kernel vs einsum
GAM_LM = dict(n_layers=4, d_model=512, n_heads=8, n_kv_heads=1, head_dim=64,
              d_ff=1408)                  # narrow enough for the index
GAM_PROMPT, GAM_NEW = 128, 16
BF16_FLOPS = 989e12                        # H100 SXM data sheet, dense


def leaves(tree):
    """The tensors of a nested parameter dict."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in leaves(v)]
    return [tree]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def bf16_ulp(x: float) -> float:
    """The spacing of bf16 numbers at magnitude |x| (8 significant bits)."""
    return float(2.0 ** (np.floor(np.log2(max(abs(x), 2.0 ** -126))) - 7))


def first_argmax(torch, x):
    """Index of the first maximum along the last axis (ties: lowest id)."""
    from repro_torch.core.retrieval import topk_desc
    flat = x.reshape(-1, x.shape[-1])
    return topk_desc(flat, 1)[1][:, 0].reshape(x.shape[:-1])


def teacher_forced(torch, model, params, batch, tokens, capacity):
    """Logits (B, T, V_padded) of the prefill and of a decode step per
    given token: tokens[:, t] is fed after the prefill's pick t."""
    logits0, cache = model.prefill(params, batch, capacity)
    out = [logits0[:, 0]]
    for t in range(tokens.shape[1] - 1):
        logits, cache = model.decode_step(params, cache, tokens[:, t:t + 1])
        out.append(logits[:, 0])
    return torch.stack(out, dim=1)


def sdpa_call(torch, q, k, v, length):
    """The yardstick: one scaled_dot_product_attention over the same cache
    (q (B,Hkv,G,hd) -> (B,H,1,hd); K/V viewed as (B,Hkv,S,hd)), positions
    <= length.  Never on the port's path."""
    import torch.nn.functional as F
    b, hkv, g, hd = q.shape
    s = k.shape[1]
    qs = q.reshape(b, hkv * g, 1, hd)
    ks, vs = k.transpose(1, 2), v.transpose(1, 2)
    mask = None
    if int(length) < s - 1:
        mask = (torch.arange(s, device=q.device) <= length)[None, None, None]
    try:
        return lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, enable_gqa=True)
    except TypeError:                       # torch without enable_gqa
        ke = ks.repeat_interleave(g, dim=1)
        ve = vs.repeat_interleave(g, dim=1)
        return lambda: F.scaled_dot_product_attention(qs, ke, ve,
                                                      attn_mask=mask)


def decode_tol(dtype) -> tuple[float, float]:
    """(rtol, atol) of decode_attention against its plain version: f32
    1e-5; bf16 one bf16 step over a floor of 1e-5, as ``prefill_tol``: both
    sides compute in f32 from the same bf16 inputs and round once."""
    import torch
    return (1e-5, 1e-5) if dtype == torch.float32 else prefill_tol(dtype)


def decode_row(torch, name, q, k, v, length, launches, reps, graphed):
    """A kernels-line entry for decode_attention on (q, k, v, length); the
    kernel, its plain version and SDPA timed alike, in a CUDA graph when
    ``graphed`` (microsecond calls), else by events around eager calls."""
    da = importlib.import_module("repro_torch.kernels.decode_attention")
    b, hkv, g, hd = q.shape
    n = int(length) + 1
    got = da.decode_attention(q, k, v, length)
    want = da.decode_attention_plain(q, k, v, length).float()
    torch.cuda.synchronize()
    err = float((got.float() - want).abs().max())
    typical = float(want.abs().mean())
    rtol, atol = decode_tol(q.dtype)
    fail_unless(bool(torch.isclose(got.float(), want, rtol=rtol,
                                   atol=atol).all()),
                f"{name} {tuple(q.shape)} S {k.shape[1]} {q.dtype} differs "
                f"from its plain version by {err} (mean |want| "
                f"{typical:.3g})")
    elt = k.element_size()
    n_bytes = 2 * b * n * hkv * hd * elt + 2 * q.numel() * q.element_size()
    flops = 4.0 * b * hkv * g * hd * n
    rate = BF16_FLOPS if q.dtype == torch.bfloat16 else F32_FLOPS
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, flops / rate * 1e3
    sdpa = sdpa_call(torch, q, k, v, length)
    lib_err = float((sdpa().reshape(q.shape).float() - want).abs().max())

    def timed(fn, n):
        return graph_ms(torch, fn) if graphed else time_ms(torch, fn, n)

    row = {"name": name, "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
           "replaces": "src/repro/kernels/decode_attention.py:77",
           "launches": launches, "max_abs_err": err,
           "ms": timed(lambda: da.decode_attention(q, k, v, length), reps),
           "plain_ms": timed(lambda: da.decode_attention_plain(
               q, k, v, length), 3),
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": timed(sdpa, reps)}
    eager = time_ms(torch, lambda: da.decode_attention(q, k, v, length),
                    reps)
    print(f"{name}: B {b} Hkv {hkv} G {g} hd {hd} S {k.shape[1]} length "
          f"{int(length)} {q.dtype}, timed "
          f"{'in a CUDA graph' if graphed else 'by events'}: kernel "
          f"{row['ms']:.4f} ms (eager call {eager:.4f} ms), plain "
          f"{row['plain_ms']:.4f} ms, sdpa {row['library_ms']:.4f} ms "
          f"(max abs diff to plain {lib_err:.3g}), bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']}), kernel vs plain "
          f"max abs err {err:.3g} (mean |out| {typical:.3g}, tolerance "
          f"rtol {rtol:.3g} atol {atol:.3g})")
    return row, eager


def prefill_qkv(torch, cfg, params, batch):
    """Layer 0's roped q (B, S, H, hd), k and v (B, S, Hkv, hd) of the
    prefill of ``batch``, as the model's blockwise attention receives them."""
    from repro_torch.models.attention import _qkv
    from repro_torch.models.layers import apply_norm, rope
    from repro_torch.models.transformer import layer_params
    lp = layer_params(params["blocks"], 0)
    h = apply_norm(lp["norm1"], params["embed"][batch["tokens"]], cfg)
    q, k, v = _qkv(lp["attn"], h, cfg)
    pos = torch.arange(q.shape[1], device=q.device)[None, :]
    return (rope(q, pos, cfg.rope_theta), rope(k, pos, cfg.rope_theta), v,
            cfg)


def unembed_patterns(torch, model, params):
    """(d, V) int8 ternary patterns of the unit unembedding rows, mapped as
    the GAM head maps them (threshold 1.5 / sqrt(d), Algorithm 2 through
    the tess_project kernel)."""
    tp = importlib.import_module("repro_torch.kernels.tess_project")
    cfg = model.cfg
    w = (params["embed"] if cfg.tie_embeddings
         else params["lm_head"].T)[:cfg.vocab].float()
    w = w / torch.linalg.vector_norm(w, dim=1, keepdim=True)
    zt = torch.where(w.abs() >= 1.5 / cfg.d_model ** 0.5, w, 0.0)
    return tp.tess_project(zt.contiguous())[0].T.contiguous()


def phase_lm(torch, report, keep):
    """Phase 5: tinyllama-1.1b at full width, bf16, through Engine.generate
    with the decode_attention kernel; held against the einsum path."""
    from repro_torch.configs import get_config
    da = importlib.import_module("repro_torch.kernels.decode_attention")
    from repro_torch.models import Model
    from repro_torch.serving import Engine, ServeConfig
    dev = torch.device("cuda")
    cfg = get_config(LM_ARCH).with_(use_decode_kernel=True)
    fail_unless(all(getattr(cfg, k) == v for k, v in LM_SHAPE.items())
                and cfg.dtype == "bfloat16" and cfg.vocab_padded == 32256,
                f"{LM_ARCH} config is not the published one")
    t0 = time.perf_counter()
    model = Model(cfg)
    params = model.init(0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in leaves(params))
    prompts = np.random.default_rng(0).integers(0, cfg.vocab,
                                                (LM_BATCH, LM_PROMPT))
    batch = {"tokens": torch.as_tensor(prompts, device=dev)}
    eng = Engine(cfg, params, ServeConfig(max_new_tokens=LM_NEW),
                 capacity=LM_CAPACITY)
    per_call = cfg.n_layers * (LM_NEW - 1)

    # --- the main path: one warm-up and LM_CALLS timed calls
    da.decode_attention.launches = 0
    torch.cuda.reset_peak_memory_stats()
    results, walls = [], []
    for i in range(1 + LM_CALLS):
        before = da.decode_attention.launches
        t0 = time.perf_counter()
        res = eng.generate(batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        fail_unless(da.decode_attention.launches - before == per_call,
                    f"decode_attention launched "
                    f"{da.decode_attention.launches - before} times in a "
                    f"call, not {cfg.n_layers} x {LM_NEW - 1}")
        results.append(res)
    launches = da.decode_attention.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for res in results:
        fail_unless(res.tokens.shape == (LM_BATCH, LM_NEW)
                    and ((res.tokens >= 0) & (res.tokens < cfg.vocab)).all(),
                    "generated tokens of the wrong shape or range")
    deterministic = all(np.array_equal(r.tokens, results[0].tokens)
                        for r in results)
    steps = np.concatenate([r.step_ms for r in results[1:]])
    prefill = [r.prefill_ms for r in results[1:]]
    walls = walls[1:]
    tok_s = [LM_BATCH * LM_NEW / w for w in walls]

    # --- held against the einsum path, teacher-forced on the kernel's tokens
    tokens = torch.as_tensor(results[-1].tokens, device=dev).long()
    plain = Model(cfg.with_(use_decode_kernel=False))
    lk = teacher_forced(torch, model, params, batch, tokens, LM_CAPACITY)
    lp = teacher_forced(torch, plain, params, batch, tokens, LM_CAPACITY)
    lk, lp = lk[..., :cfg.vocab], lp[..., :cfg.vocab]
    fail_unless(torch.isfinite(lk).all() and torch.isfinite(lp).all(),
                "non-finite logits")
    fail_unless(torch.equal(first_argmax(torch, lk), tokens),
                "teacher-forced kernel-path logits do not reproduce the "
                "tokens Engine.generate picked")
    diff = (lk - lp).abs()
    bf16_tol = LM_BF16_ULPS * bf16_ulp(float(lp.abs().max()))
    bf16 = {"max_abs_diff": float(diff.max()),
            "mean_abs_diff": float(diff.mean()),
            "tolerance": bf16_tol,
            "max_abs_logit": float(lp.abs().max()),
            "greedy_agree": float((first_argmax(torch, lp) == tokens)
                                  .float().mean())}
    fail_unless(bf16["max_abs_diff"] <= bf16_tol,
                f"bf16 logits of the kernel path differ from the einsum path "
                f"by {bf16['max_abs_diff']} > {bf16_tol}")
    del lk, lp, diff, plain

    # --- the same at f32: equal greedy picks except counted near-ties
    cfg32 = cfg.with_(dtype="float32")
    params32 = tree_map(lambda t: t.float(), params)
    res32 = Engine(cfg32, params32, ServeConfig(max_new_tokens=LM_NEW),
                   capacity=LM_CAPACITY).generate(batch)
    tok32 = torch.as_tensor(res32.tokens, device=dev).long()
    lk = teacher_forced(torch, Model(cfg32), params32, batch, tok32,
                        LM_CAPACITY)[..., :cfg.vocab]
    lp = teacher_forced(torch, Model(cfg32.with_(use_decode_kernel=False)),
                        params32, batch, tok32, LM_CAPACITY)[..., :cfg.vocab]
    fail_unless(torch.equal(first_argmax(torch, lk), tok32),
                "teacher-forced f32 kernel-path logits do not reproduce the "
                "tokens Engine.generate picked")
    delta = (lk - lp).abs().amax(dim=-1)                  # (B, T)
    fail_unless(float(delta.max()) <= LM_F32_TOL,
                f"f32 logits differ by {float(delta.max())} > {LM_F32_TOL}")
    top2 = torch.topk(lp, 2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    differ = first_argmax(torch, lp) != tok32
    # picks can differ only where the einsum path's top two lie within twice
    # the two paths' largest logit difference at that step
    near_tie = gap <= 2 * delta
    fail_unless(not bool((differ & ~near_tie).any()),
                "f32 greedy picks differ on a step that is not a near-tie")
    f32 = {"max_abs_diff": float(delta.max()), "tolerance": LM_F32_TOL,
           "steps": int(tok32.numel()), "picks_differ": int(differ.sum()),
           "near_tie_steps": int(near_tie.sum()),
           "near_tie_steps_that_differ": int((differ & near_tie).sum())}
    del lk, lp, params32

    # --- decode_attention at this path's shape, on the live cache
    _, cache = model.prefill(params, batch, LM_CAPACITY)
    q = torch.randn((LM_BATCH, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads,
                     cfg.hd), generator=torch.Generator(dev).manual_seed(1),
                    device=dev).to(torch.bfloat16)
    last = LM_PROMPT + LM_NEW - 2                      # the last step's slot
    length = torch.tensor(last, dtype=torch.int32, device=dev)
    kc, vc = cache["k"][0], cache["v"][0]
    kc[:, LM_PROMPT:] = torch.randn_like(kc[:, LM_PROMPT:])
    vc[:, LM_PROMPT:] = torch.randn_like(vc[:, LM_PROMPT:])
    row, eager_ms = decode_row(torch, "decode_attention", q, kc, vc, length,
                               launches, 50, graphed=True)
    # the kernel's share of a step: its 22 calls in device time, and as
    # eager calls (host launch included), as the step makes them
    share = cfg.n_layers * row["ms"] / float(np.percentile(steps, 50))
    share_eager = cfg.n_layers * eager_ms / float(np.percentile(steps, 50))
    del cache, kc, vc

    lm = {"arch": LM_ARCH, "params": n_params, "dtype": cfg.dtype,
          "batch": LM_BATCH, "prompt": LM_PROMPT, "new_tokens": LM_NEW,
          "capacity": LM_CAPACITY, "init_s": init_s,
          "prefill_ms": prefill, "decode_step_ms": steps.tolist(),
          "decode_step_p50_ms": float(np.percentile(steps, 50)),
          "decode_step_p99_ms": float(np.percentile(steps, 99)),
          "tokens_per_s": tok_s, "generate_wall_s": walls,
          "decode_attention_share_of_step": share,
          "decode_attention_eager_share_of_step": share_eager,
          "peak_device_memory_gb": peak_gb, "deterministic": deterministic,
          "launches": {"decode_attention": launches},
          "bf16_vs_einsum": bf16, "f32_vs_einsum": f32}
    report["lm"] = lm
    print(f"lm: {LM_ARCH} ({n_params} params, bf16), batch {LM_BATCH}, "
          f"prompt {LM_PROMPT}, {LM_NEW} new tokens, capacity {LM_CAPACITY}: "
          f"prefill {np.median(prefill):.2f} ms, decode step p50 "
          f"{lm['decode_step_p50_ms']:.3f} ms p99 "
          f"{lm['decode_step_p99_ms']:.3f} ms, "
          f"{np.median(tok_s):.1f} tokens/s, decode_attention "
          f"{share:.1%} of a step in device time ({share_eager:.1%} as "
          f"eager calls), peak device memory {peak_gb:.2f} GB, "
          f"decode_attention launches {launches} ({per_call} per call)")
    print(f"lm: bf16 logits vs einsum path: max abs diff "
          f"{bf16['max_abs_diff']:.4g} (tolerance {bf16_tol:.4g}), mean "
          f"{bf16['mean_abs_diff']:.3g}, greedy picks agree on "
          f"{bf16['greedy_agree']:.4f} of steps; f32: max abs diff "
          f"{f32['max_abs_diff']:.3g}, picks differ on "
          f"{f32['picks_differ']} of {f32['steps']} steps, all near-ties "
          f"({f32['near_tie_steps']} near-tie steps)")
    big = LM_BATCH * 16                       # decode_32k: batch 128
    k32 = torch.randn((big, 32768, cfg.n_kv_heads, cfg.hd), device=dev,
                      dtype=torch.bfloat16)
    v32 = torch.randn_like(k32)
    q32 = torch.randn((big,) + q.shape[1:], device=dev, dtype=torch.bfloat16)
    row32, _ = decode_row(torch, "decode_attention@decode_32k", q32, k32,
                          v32, torch.tensor(32767, dtype=torch.int32,
                                            device=dev),
                          launches, 10, graphed=False)
    del k32, v32, q32
    keep["prefill"] = prefill_qkv(torch, cfg, params, batch)
    keep["patterns_d2048"] = unembed_patterns(torch, model, params)
    del model, params, eng
    torch.cuda.empty_cache()
    return [row, row32]


def phase_gam_head(torch, report, keep):
    """Phase 5b: the GAM LM head on a narrow tinyllama-shaped model at the
    full vocab (k = d_model = 512), through Engine(use_gam_head=True)."""
    from repro_torch.configs import get_config
    from repro_torch.core.retrieval import masked_topk
    da = importlib.import_module("repro_torch.kernels.decode_attention")
    gs = importlib.import_module("repro_torch.kernels.gam_score")
    tp = importlib.import_module("repro_torch.kernels.tess_project")
    from repro_torch.models import Model
    from repro_torch.serving import Engine, ServeConfig
    dev = torch.device("cuda")
    cfg = get_config(LM_ARCH).with_(use_decode_kernel=True, **GAM_LM)
    params = Model(cfg).init(1)
    prompts = np.random.default_rng(1).integers(0, cfg.vocab,
                                                (LM_BATCH, GAM_PROMPT))
    batch = {"tokens": torch.as_tensor(prompts, device=dev)}
    capacity = GAM_PROMPT + GAM_NEW + 8
    sc = ServeConfig(max_new_tokens=GAM_NEW, use_gam_head=True,
                     gam_threshold=1.5, gam_min_overlap=2)
    for fn in (tp.tess_project, gs.gam_score, da.decode_attention):
        fn.launches = 0
    tess_rows = Spans(torch, tp, "tess_project", sizes=True).__enter__()
    t0 = time.perf_counter()
    eng = Engine(cfg, params, sc, capacity=capacity)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    res = eng.generate(batch)
    torch.cuda.synchronize()
    launches = {"tess_project": tp.tess_project.launches,
                "gam_score": gs.gam_score.launches,
                "decode_attention": da.decode_attention.launches}
    tess_rows.__exit__()
    tess_by_rows = collections.Counter(tess_rows.rows)
    fail_unless(sum(tess_by_rows.values()) == launches["tess_project"]
                and tess_by_rows[LM_BATCH] > 0,
                f"tess_project by rows on the GAM-head path {tess_by_rows}")
    fail_unless(launches["tess_project"] > 0 and launches["gam_score"] > 0,
                f"the GAM head's kernels did not launch: {launches}")
    fail_unless(launches["decode_attention"] == cfg.n_layers * (GAM_NEW - 1),
                "decode_attention launches on the GAM-head path")
    head = eng.gam_head
    fail_unless(head.cfg.k == cfg.d_model and head.raw_embed.shape[0]
                == cfg.vocab, "the GAM head does not index the full vocab")

    # each step's ids equal the dense oracle on the same masks, teacher-forced
    model = eng.model
    tokens = torch.as_tensor(res.tokens, device=dev).long()
    _, cache = model.prefill(params, batch, capacity)
    scored, tf_agree = [], []
    exact_logits_fn = Model(cfg)
    for t in range(GAM_NEW - 1):
        hidden, cache = model.decode_step(params, cache, tokens[:, t:t + 1],
                                          return_hidden=True)
        h = hidden[:, 0]
        vals, ids, mask = head.topk(h, sc.kappa)
        o_vals, o_ids = masked_topk(h.float(), head.raw_embed, mask, sc.kappa)
        fail_unless(torch.equal(ids, o_ids.long()),
                    f"step {t}: GAM-head ids differ from masked_topk")
        fail_unless(torch.equal(ids[:, 0], tokens[:, t + 1]),
                    f"step {t}: Engine.generate did not serve the head's pick")
        exact = exact_logits_fn._logits(params, hidden)[:, 0, :cfg.vocab]
        tf_agree.append(float((first_argmax(torch, exact) == ids[:, 0])
                              .float().mean()))
        scored.append(int(mask.sum()))
    exact_res = Engine(cfg, params, ServeConfig(max_new_tokens=GAM_NEW),
                       capacity=capacity).generate(batch)
    agree = float((exact_res.tokens == res.tokens).mean())

    # the head's kernels at this path's shapes, against their plain versions
    norm = head.embed                                   # unit vocab rows
    zt = torch.where(norm.abs() >= head.cfg.threshold, norm, 0.0).contiguous()
    pat, a = tp.tess_project(zt)
    pat_p, a_p = tp.tess_project_plain(zt)
    torch.cuda.synchronize()
    differ = (pat != pat_p).any(dim=1).cpu().numpy()
    rows_diff = np.nonzero(differ)[0]
    excused = near_tie_rows(zt[rows_diff].cpu().numpy())
    fail_unless(excused.all(), f"tess_project (k={cfg.d_model}) rows "
                f"{rows_diff[~excused][:8]} differ and are not near-ties")
    same = torch.as_tensor(~differ, device=dev)
    err_tess = float((a[same] - a_p[same]).abs().max())
    fail_unless(err_tess == 0.0, "tess_project (wide) a differs")
    h = torch.randn((LM_BATCH, cfg.d_model), device=dev,
                    generator=torch.Generator(dev).manual_seed(2))
    mask = head.candidates(h)
    got = gs.gam_score(h, head.raw_embed, mask)
    want = gs.gam_score_plain(h, head.raw_embed, mask)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    err_score = float((got - want).abs().max())
    differ_score = int((got != want).sum())
    # one step's map: the normalised hidden states, thresholded as the
    # head's sparse_map does, LM_BATCH rows at k = d_model
    hn = h / (torch.sqrt((h * h).sum(-1, keepdim=True)) + 1e-9)
    z_step = torch.where(hn.abs() >= head.cfg.threshold, hn, 0.0)
    pat8, a8 = tp.tess_project(z_step)
    pat8_p, a8_p = tp.tess_project_plain(z_step)
    torch.cuda.synchronize()
    differ8 = (pat8 != pat8_p).any(dim=1).cpu().numpy()
    fail_unless(near_tie_rows(z_step[np.nonzero(differ8)[0]].cpu().numpy())
                .all(),
                "tess_project (head step) rows differ and are not near-ties")
    same8 = torch.as_tensor(~differ8, device=dev)
    err_tess8 = float((a8[same8] - a8_p[same8]).abs().max())
    fail_unless(err_tess8 == 0.0, "tess_project (head step) a differs")
    f = 4
    v, k = zt.shape
    shapes = [("tess_project@k512", "tess_project", tess_by_rows[v], err_tess,
               lambda: tp.tess_project(zt), lambda: tp.tess_project_plain(zt),
               (v * k * (f + 1 + f), 3 * k * v)),
              ("tess_project@head_step", "tess_project",
               tess_by_rows[LM_BATCH], err_tess8,
               lambda: tp.tess_project(z_step),
               lambda: tp.tess_project_plain(z_step),
               (LM_BATCH * k * (f + 1 + f), 3 * k * LM_BATCH)),
              ("gam_score@lm_head", "gam_score", launches["gam_score"],
               err_score, lambda: gs.gam_score(h, head.raw_embed, mask),
               lambda: gs.gam_score_plain(h, head.raw_embed, mask),
               (LM_BATCH * k * f + v * k * f + LM_BATCH * v * (1 + f),
                2 * k * int(mask.sum())))]
    rows = []
    for name, src, n_launch, err, kern, plain, (n_bytes, flops) in shapes:
        b_ms, b_by = bound_ms(n_bytes, flops)
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}.cu",
            "replaces": ("src/repro/kernels/tess_project.py:57"
                         if src == "tess_project"
                         else "src/repro/kernels/gam_score.py:60"),
            "launches": n_launch, "max_abs_err": err,
            "ms": time_ms(torch, kern, 20),
            "graph_ms": graph_ms(torch, kern),
            "plain_ms": time_ms(torch, plain, 3), "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None})
    rows[-1]["yardstick_ms"] = time_ms(torch, lambda: matmul_where(
        torch, h, head.raw_embed, mask), 20)
    for row in rows:
        print(f"gam head: {row['name']}: {row['launches']} launches, "
              f"{row['ms']:.4f} ms, in a CUDA graph {row['graph_ms']:.4f} "
              f"ms, bound {row['bound_ms']:.5f} ms ({row['bound_by']}), "
              f"plain {row['plain_ms']:.3f} ms"
              + (f", matmul + where (two calls) {row['yardstick_ms']:.4f} ms"
                 if "yardstick_ms" in row else ""))
    gam = {"config": GAM_LM, "vocab": cfg.vocab, "p": head.cfg.p,
           "table_bytes": head.index.table.numel() * 4,
           "bitset_bytes": (head.retriever._retrieve_meta.item_bits_t.numel()
                            * 4),
           "build_s": build_s, "launches": launches,
           "n_scored_vocab": res.n_scored_vocab,
           "discard_frac": res.discard_frac,
           "teacher_forced_pick_agree_exact": float(np.mean(tf_agree)),
           "free_running_token_agree_exact": agree,
           "tess_project_near_tie_rows": int(differ.sum()),
           "tess_project_by_rows": dict(tess_by_rows),
           "gam_score_elements_differing": differ_score,
           "prefill_ms": res.prefill_ms, "step_ms": res.step_ms}
    report["gam_head"] = gam
    print(f"gam head: {LM_ARCH} narrowed to {GAM_LM} at vocab {cfg.vocab} "
          f"(p = {head.cfg.p}, table {gam['table_bytes'] / 1e9:.2f} GB, "
          f"bitsets {gam['bitset_bytes'] / 1e9:.2f} GB, built in "
          f"{build_s:.1f} s): {res.n_scored_vocab:.1f} vocab rows scored per "
          f"step, discard fraction {res.discard_frac:.4f}, head pick = exact "
          f"pick on {gam['teacher_forced_pick_agree_exact']:.4f} of "
          f"teacher-forced steps, free-running tokens agree with the exact "
          f"head on {agree:.4f}; launches {launches}, tess_project by rows "
          f"{dict(tess_by_rows)}; tess_project near-tie rows "
          f"{int(differ.sum())} of {v}; gam_score elements differing from "
          f"plain {differ_score} of {got.numel()}")
    keep["patterns_d512"] = pat.T.contiguous()
    del eng, head, params
    torch.cuda.empty_cache()
    return rows


# ------------------------------------------------------ the service tier

SVC_SHARDS = 8
SVC_STREAM = 12                # requests while mutations stream in
SVC_MUTATE = 8                 # of which this many are followed by mutations
SVC_FRESH, SVC_REWRITE, SVC_DELETE = 1024, 1024, 512   # rows per mutation
SVC_SLICE_ROWS = 1 << 18       # compaction map slice
SVC_TARGET_BLOCKS = 2048       # repartition: blocks a shard is cut into
SVC_INT8_REQUESTS = 3
SVC_WINDOW = 50                # requests in each timed window
SVC_SHARE = 20                 # requests timed for the kernel's share
DEVICE = "cuda"                # the card; phases 6-7 run nowhere else


def service_oracle(torch, r, users):
    """The dense oracle over the live catalog of a ``sharded`` retriever:
    the base's ``query_dense_reference`` (posting-table masks, masked_topk on
    the gam_score kernel) and ``masked_topk`` over the delta with its own
    table's masks, merged under (score desc, id asc).  -> (scores, ids)."""
    from repro_torch.core.mapping import sparse_map
    from repro_torch.core.retrieval import masked_topk
    from repro_torch.kernels.gam_score import NEG
    u = torch.as_tensor(users, device=r.device)
    tau, vals = sparse_map(u, r.spec.cfg)
    mask = vals != 0
    b = r.base.query_dense_reference(u, tau, mask, KAPPA)
    scores = [b.scores]
    ids = [r.base.rows_to_ids(b.rows, b.scores)]
    if len(r.delta):
        dm = r.delta._index.batch_candidate_mask(tau, r.spec.min_overlap,
                                                 mask)
        dv, dr = masked_topk(u, torch.as_tensor(r.delta.factors,
                                                device=r.device), dm,
                             min(KAPPA, len(r.delta)))
        dv = dv.cpu().numpy()
        scores.append(dv)
        ids.append(np.where(dv <= NEG / 2, -1, r.delta.ids[
            dr.cpu().numpy().clip(0, len(r.delta) - 1)]))
    cat_s = np.concatenate(scores, axis=1)
    cat_i = np.concatenate(ids, axis=1)
    empty = cat_s <= NEG / 2
    order = np.lexsort((np.where(empty, 2 ** 62, cat_i), -cat_s),
                       axis=-1)[:, :KAPPA]
    top_s = np.take_along_axis(cat_s, order, axis=-1)
    top_i = np.take_along_axis(cat_i, order, axis=-1)
    return top_s, np.where(top_s <= NEG / 2, -1, top_i)


def rows_to_ids(base, rows, neg):
    """Global rows of a sharded base (-1 empty) -> catalog ids (-1 empty)."""
    return base.rows_to_ids(np.where(rows >= 0, rows, 0),
                            np.where(rows >= 0, 0.0, neg))


def check_oracle(torch, r, users, res, what):
    o_s, o_i = service_oracle(torch, r, users)
    fail_unless(np.array_equal(res.ids, o_i),
                f"{what}: served ids differ from the dense oracle")
    real = o_i >= 0
    fail_unless(max_ulp(np.where(real, res.scores, 0),
                        np.where(real, o_s, 0)) <= ULP,
                f"{what}: served scores beyond 4 ulp of the dense oracle")


def same_bits(a, b, what):
    fail_unless(np.array_equal(a.ids, b.ids)
                and np.array_equal(a.scores, b.scores), what)


def phase_service(torch, report, items, centers, cfg, bucket):
    """Phase 6: the gam_mf-1M catalog behind the ``sharded`` backend on the
    card, with streamed mutations, a background compaction, a repartition
    and a snapshot; every request held against the dense oracle."""
    gr = importlib.import_module("repro_torch.kernels.gam_retrieve")
    tp = importlib.import_module("repro_torch.kernels.tess_project")
    from repro_torch.retriever import RetrieverSpec, open_retriever
    spec = RetrieverSpec(
        cfg=cfg, backend="sharded", n_shards=SVC_SHARDS,
        min_overlap=MIN_OVERLAP, kappa=KAPPA, bucket=bucket,
        delta_bucket=1 << 15, batch_size=BATCH,
        options=(("compact_slice_rows", SVC_SLICE_ROWS),
                 ("rebalance_target_blocks", SVC_TARGET_BLOCKS)))
    t0 = time.perf_counter()
    r = open_retriever(spec, items=items, device=DEVICE)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    fail_unless(r.base.spills.shape[1] == 0, "the service's shards spill: "
                "the bucket must hold the longest posting list")
    dev_bytes = r.base.device_bytes()
    stream = requests(centers, 64, BATCH, SIGMA, seed=6)
    rng = np.random.default_rng(7)
    live = np.arange(N_ITEMS, dtype=np.int64)
    next_fresh = N_ITEMS
    counts = {"gam_retrieve": 0, "tess_project": 0}
    lat = {"stream": [], "compaction": [], "repartitioned": []}
    windows = {}
    per_request = []
    req = iter(stream)

    def serve(users, via_batcher, phase, check=True):
        """One request of 256 queries, timed on the host clock; the
        gam_retrieve launches it made must be one per bn-group plus one
        for a non-empty delta.  ``check``: hold it against the oracle now
        (a timed window holds its requests after the window)."""
        before = gr.gam_retrieve.launches
        t0 = time.perf_counter()
        if via_batcher:
            rids = [r.batcher.submit(u) for u in users]   # fires at 256
            outs = [r.batcher.result(i) for i in rids]
            fail_unless(all(o is not None and hasattr(o, "ids")
                            for o in outs), "the microbatcher lost a row")
            res = types.SimpleNamespace(
                ids=np.stack([o.ids for o in outs]),
                scores=np.stack([o.scores for o in outs]))
        else:
            res = r.query(users)
        torch.cuda.synchronize()
        lat.setdefault(phase, []).append((time.perf_counter() - t0) * 1e3)
        n = gr.gam_retrieve.launches - before
        want = len(r.base.metas) + (1 if len(r.delta) else 0)
        fail_unless(n == want, f"{phase}: gam_retrieve launched {n} times "
                    f"for a request, not {want} (groups + delta)")
        per_request.append(n)
        fail_unless(res.ids.shape == (BATCH, KAPPA), "service result shape")
        if check:
            check_oracle(torch, r, users, res, phase)
        return res

    def window(name, via_batcher, seed):
        """SVC_WINDOW requests back to back on a fixed layout: each one's
        latency, and queries/s as all queries over the window's wall time;
        every answer is held against the oracle once the window ends."""
        batch = requests(centers, SVC_WINDOW, BATCH, SIGMA, seed=seed)
        t0 = time.perf_counter()
        got = [serve(u, via_batcher, name, check=False) for u in batch]
        wall = time.perf_counter() - t0
        for users, res in zip(batch, got):
            check_oracle(torch, r, users, res, name)
        ms = lat[name]
        windows[name] = {
            "requests": len(ms), "wall_s": wall,
            "qps": BATCH * len(ms) / wall,
            "p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99)),
            "max_ms": float(max(ms)),
            "launches_per_request": per_request[-1]}

    def fresh_device(what, answers):
        ids, fac = r._catalog_arrays()
        g = open_retriever(RetrieverSpec(
            cfg=cfg, backend="gam-device", min_overlap=MIN_OVERLAP,
            kappa=KAPPA, bucket=bucket), items=fac, ids=ids, device=DEVICE)
        fail_unless(g.stats()["n_spill"] == 0, "gam-device spills")
        for users, res in answers:
            same_bits(res, g.query(users), f"{what}: the service differs "
                      "from a fresh gam-device build over its catalog")

    # --- the main path: requests, streamed mutations, compaction,
    # repartition; the counts are read right after it.  tess_project's
    # calls are tallied by their rows (queries, upserts, compaction slices)
    gr.gam_retrieve.launches = tp.tess_project.launches = 0
    tess_rows = Spans(torch, tp, "tess_project", sizes=True).__enter__()
    t_stream = time.perf_counter()
    for i in range(SVC_STREAM):
        serve(next(req), via_batcher=bool(i % 2), phase="stream")
        if i < SVC_MUTATE:
            fresh = np.arange(next_fresh, next_fresh + SVC_FRESH)
            next_fresh += SVC_FRESH
            rewrite = rng.choice(live, SVC_REWRITE, replace=False)
            up_ids = np.concatenate([fresh, rewrite])
            up = (centers[rng.integers(0, N_CLUSTERS, up_ids.size)]
                  + SIGMA * rng.normal(size=(up_ids.size, K))
                  ).astype(np.float32)
            up /= np.linalg.norm(up, axis=1, keepdims=True)
            r.upsert(up_ids, up)
            live = np.union1d(live, fresh)
            dead = rng.choice(live, SVC_DELETE, replace=False)
            r.delete(dead)
            live = np.setdiff1d(live, dead)
    stream_s = time.perf_counter() - t_stream
    delta_len = len(r.delta)
    fail_unless(r.n_items == live.size, "the catalog lost or gained rows")
    # the uniform layout with the streamed delta, by both routes (the
    # batcher's block traffic is dropped at the swap: the block count
    # changes, so it does not dilute the hot traffic the repartition reads)
    window("uniform+delta via query", via_batcher=False, seed=11)
    window("uniform+delta via batcher", via_batcher=True, seed=12)
    # the device time of gam_retrieve within a request of this layout
    share_batch = requests(centers, SVC_SHARE, BATCH, SIGMA, seed=14)
    share_iter, share_got = iter(share_batch), []
    with Spans(torch, gr, "gam_retrieve") as spans:
        svc_share = request_share(torch, lambda: share_got.append(serve(
            next(share_iter), via_batcher=False, phase="share",
            check=False)), spans, SVC_SHARE)
    for users, res in zip(share_batch, share_got):
        check_oracle(torch, r, users, res, "share")

    r.compact(async_=True)
    slices = 0
    while r.maintenance_stats()["compaction"]["active"]:
        serve(next(req), via_batcher=False, phase="compaction")
        slices += 1
        fail_unless(slices < 64, "the compaction never swapped")
    fail_unless(r.generation == 1 and len(r.delta) == 0,
                "the compaction did not swap in generation 1")
    check = [next(req) for _ in range(2)]
    uniform = [(u, r.query(u)) for u in check]
    fresh_device("after the swap", uniform)

    # hot traffic on a few clusters, through the batcher (its stats feed
    # the repartitioner's weights), then the skew-aware layout
    hot = requests(centers[:4], 2, BATCH, SIGMA, seed=8)
    for users in hot:
        serve(users, via_batcher=True, phase="stream")
    t0 = time.perf_counter()
    part = r.repartition(async_=False)
    repartition_s = time.perf_counter() - t0
    n_groups = len(part.groups)
    fail_unless(n_groups >= 2, f"the repartition gave {n_groups} bn-group")
    hetero = [(u, serve(u, via_batcher=False, phase="repartitioned"))
              for u, _ in uniform]
    for (_, a), (_, b) in zip(uniform, hetero):
        same_bits(a, b, "the heterogeneous layout differs from the uniform "
                  "one")
    fresh_device("after the repartition", hetero)
    window("repartitioned via query", via_batcher=False, seed=13)
    r.upsert(np.arange(next_fresh, next_fresh + 64), centers[:64])
    after = [(u, serve(u, via_batcher=False, phase="repartitioned"))
             for u in (next(req), next(req))]
    counts = {"gam_retrieve": gr.gam_retrieve.launches,
              "tess_project": tp.tess_project.launches}
    tess_rows.__exit__()
    for name, n in counts.items():
        fail_unless(n > 0, f"{name} never launched on the service path")
    # tess_project at the sizes the main path gave it, with their launches
    by_rows = collections.Counter(tess_rows.rows)
    fail_unless(sum(by_rows.values()) == counts["tess_project"],
                "tess_project calls and launches disagree")
    tess_svc, kernel_rows = [], []
    # the kernels line carries a request's queries, a compaction slice and
    # the largest rebuild
    named = {BATCH, SVC_SLICE_ROWS, max(by_rows)} & set(by_rows)
    for n in sorted(by_rows, key=lambda x: -by_rows[x])[:8]:
        z = torch.randn((n, K), device=DEVICE,
                        generator=torch.Generator(DEVICE).manual_seed(n))
        z = torch.where(z.abs() >= 0.5, z, 0.0)
        b_ms, b_by = bound_ms(n * K * (4 + 1 + 4), 3 * K * n)
        tess_svc.append({"rows": n, "launches": by_rows[n],
                         "ms": time_ms(torch, lambda: tp.tess_project(z), 20),
                         "graph_ms": graph_ms(torch,
                                              lambda: tp.tess_project(z)),
                         "bound_ms": b_ms, "bound_by": b_by})
        if n not in named:
            continue
        pat, a = tp.tess_project(z)
        pat_p, a_p = tp.tess_project_plain(z)
        torch.cuda.synchronize()
        differ = (pat != pat_p).any(dim=1).cpu().numpy()
        fail_unless(near_tie_rows(z[np.nonzero(differ)[0]].cpu().numpy())
                    .all(),
                    f"tess_project ({n} rows) rows differ and are not "
                    "near-ties")
        same = torch.as_tensor(~differ, device=DEVICE)
        err = float((a[same] - a_p[same]).abs().max())
        fail_unless(err == 0.0, f"tess_project ({n} rows) a differs")
        kernel_rows.append({
            "name": f"tess_project@service_{n}rows", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/tess_project.cu",
            "replaces": "src/repro/kernels/tess_project.py:57",
            "launches": by_rows[n], "max_abs_err": err,
            "ms": tess_svc[-1]["ms"], "graph_ms": tess_svc[-1]["graph_ms"],
            "plain_ms": time_ms(torch, lambda: tp.tess_project_plain(z), 3),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})

    snap = ROOT / "build" / "chip_smoke_service.npz"
    t0 = time.perf_counter()
    r.snapshot(str(snap))
    back = open_retriever(spec, snapshot=str(snap), device=DEVICE)
    snapshot_s = time.perf_counter() - t0
    snap.unlink()
    fail_unless(len(back.delta) == 64, "the restored delta is not the live "
                "one")
    for users, res in after:
        same_bits(res, back.query(users), "the restored service answers "
                  "differently")

    svc = {"n_shards": SVC_SHARDS, "build_s": build_s,
           "device_bytes": dev_bytes, "requests": len(per_request),
           "windows": windows, "latency_ms": lat, "stream_wall_s": stream_s,
           "launches_per_request": per_request,
           "delta_len_before_compaction": delta_len,
           "compaction_slices": slices,
           "compaction_request_ms_sum": float(sum(lat["compaction"])),
           "repartition_s": repartition_s, "groups": n_groups,
           "partition": {"lengths": list(part.lengths),
                         "bns": list(part.bns)},
           "snapshot_restore_s": snapshot_s, "launches": counts,
           "gam_retrieve_in_request": svc_share,
           "tess_project_by_rows": tess_svc,
           "metrics": r.metrics.snapshot()}
    report["service"] = svc
    m = svc["metrics"]
    print(f"service: {N_ITEMS} items in {SVC_SHARDS} shards, built in "
          f"{build_s:.1f} s; on the card {dev_bytes}")
    print(f"service: {len(per_request)} requests of {BATCH}, every one equal "
          f"to the dense oracle; gam_retrieve launches per request "
          f"{sorted(set(per_request))}; delta {delta_len} rows before the "
          f"compaction ({SVC_MUTATE} x ({SVC_FRESH} fresh + {SVC_REWRITE} "
          f"rewritten) upserts, {SVC_MUTATE} x {SVC_DELETE} deletes)")
    for name, w in windows.items():
        print(f"service window {name}: {w['requests']} requests of {BATCH} "
              f"back to back, {w['launches_per_request']} launches each, "
              f"request p50 {w['p50_ms']:.3f} ms p99 {w['p99_ms']:.3f} ms max "
              f"{w['max_ms']:.3f} ms (host clock), {w['qps']:.1f} queries/s "
              f"over the window's {w['wall_s']:.3f} s")
    print(f"service: compaction {slices} slices, {sum(lat['compaction']):.0f}"
          f" ms of requests while it ran (p50 "
          f"{np.percentile(lat['compaction'], 50):.3f} ms); equal to a fresh "
          f"gam-device build bit for bit; repartition to {n_groups} "
          f"bn-groups {list(part.bns)} in {repartition_s:.1f} s, "
          f"heterogeneous = uniform bit for bit; snapshot -> "
          f"restore with a 64-row delta bit-identical "
          f"({snapshot_s:.1f} s); launches {counts}")
    print(f"service: gam_retrieve within a request (uniform layout + "
          f"delta via query, {SVC_SHARE} requests): device "
          f"{svc_share['kernel_device_ms_p50']:.4f} ms of a "
          f"{svc_share['request_ms_p50']:.3f} ms request (CUDA events "
          f"around each launch, host clock around the request, p50), share "
          f"{svc_share['kernel_share_p50']:.3f}, "
          f"{svc_share['launches_per_request']} launches a request")
    print("service: tess_project by rows on the main path (rows: launches, "
          "eager ms, ms in a CUDA graph, bound ms): " + "; ".join(
              f"{t['rows']}: {t['launches']}, {t['ms']:.4f}, "
              f"{t['graph_ms']:.4f}, {t['bound_ms']:.5f}" for t in tess_svc))
    print("service: metrics " + json.dumps(
        {k: m[k] for k in ("n_requests", "n_batches", "qps",
                           "latency_p50_ms", "latency_p99_ms",
                           "occupancy_mean", "discard_mean",
                           "shard_balance", "n_upserts", "n_deletes",
                           "n_compactions", "n_async_compactions",
                           "n_compact_slices", "n_repartitions")}))
    del r, back
    torch.cuda.empty_cache()
    return kernel_rows


def phase_service_int8(torch, report, items, centers, cfg, bucket):
    """Phase 6b: the same service under the compressed catalog; served ids
    are the exact top kappa of each query's pool, and equal the dense
    oracle where the pool covers it."""
    from repro_torch.core.retrieval import topk_desc
    from repro_torch.core.mapping import sparse_map
    gr = importlib.import_module("repro_torch.kernels.gam_retrieve")
    gs = importlib.import_module("repro_torch.kernels.gam_score")
    from repro_torch.retriever import RetrieverSpec, open_retriever
    spec = RetrieverSpec(cfg=cfg, backend="sharded", n_shards=SVC_SHARDS,
                         min_overlap=MIN_OVERLAP, kappa=KAPPA, bucket=bucket,
                         batch_size=BATCH, quantize="int8",
                         rerank_factor=RERANK, compress_postings=True)
    t0 = time.perf_counter()
    r = open_retriever(spec, items=items, device=DEVICE)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    fail_unless(len(r.base.metas) == 1, "the uniform layout is one group")
    meta = r.base.metas[0]
    flat = r.base.factors_g[0]
    pool = KAPPA * RERANK
    gr.gam_retrieve.launches = gr.gam_retrieve_q.launches = 0
    users_all = requests(centers, SVC_INT8_REQUESTS, BATCH, SIGMA, seed=9)
    answers, lat = [], []
    for users in users_all:
        t0 = time.perf_counter()
        answers.append(r.query(users))
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    launches = {"gam_retrieve_q": gr.gam_retrieve_q.launches,
                "gam_retrieve": gr.gam_retrieve.launches}
    fail_unless(launches["gam_retrieve_q"] == SVC_INT8_REQUESTS
                and launches["gam_retrieve"] == 0,
                f"the compressed service launched {launches}")
    covered_queries = 0
    for users, res in zip(users_all, answers):
        u = torch.as_tensor(users, device=DEVICE)
        tau, vals = sparse_map(u, cfg)
        prs = gr.gam_retrieve_q(u, tau, vals != 0, meta, pool,
                                min_overlap=MIN_OVERLAP,
                                alive=r.base.alive_g[0])
        sc = gs.gam_score(u, flat, torch.ones((BATCH, flat.shape[0]),
                                              dtype=torch.bool,
                                              device=DEVICE))
        c_vals, c_rows = rerank_choice(torch, prs.rows, sc, KAPPA, topk_desc,
                                       gs.NEG)
        c_ids = rows_to_ids(r.base, c_rows, gs.NEG)
        fail_unless(np.array_equal(res.ids, c_ids), "int8 service: served "
                    "ids are not the exact top kappa of the pool")
        fail_unless(max_ulp(np.where(c_ids >= 0, res.scores, 0), c_vals)
                    <= ULP, "int8 service: a served score is beyond 4 ulp "
                    "of its exact score")
        o_s, o_i = service_oracle(torch, r, users)
        prow = rows_to_ids(r.base, prs.rows.cpu().numpy(), gs.NEG)
        covered = ((o_i[:, :, None] == prow[:, None, :]).any(-1)
                   | (o_i < 0)).all(axis=1)
        covered_queries += int(covered.sum())
        fail_unless(np.array_equal(res.ids[covered], o_i[covered]),
                    "int8 service: ids differ from the dense oracle on a "
                    "query whose pool covers it")
        del sc
    report["service_int8"] = {
        "build_s": build_s, "device_bytes": r.base.device_bytes(),
        "request_ms": lat, "launches": launches,
        "pool_covered_queries": covered_queries,
        "queries": SVC_INT8_REQUESTS * BATCH}
    print(f"service int8: built in {build_s:.1f} s, on the card "
          f"{r.base.device_bytes()}; {SVC_INT8_REQUESTS} requests "
          f"({', '.join(f'{x:.3f}' for x in lat)} ms), served ids = exact "
          f"top {KAPPA} of each pool of {pool} on every query and = the "
          f"dense oracle on all {covered_queries} of "
          f"{SVC_INT8_REQUESTS * BATCH} queries whose pool covers it; "
          f"launches {launches}")
    del r
    torch.cuda.empty_cache()


# ------------------------------------------------ the last two kernels

PREFILL_TEST_SHAPES = [(1, 64, 1, 1, 32), (2, 128, 2, 4, 64),
                       (1, 96, 1, 8, 64), (2, 256, 4, 2, 32),
                       (1, 100, 2, 3, 48)]
COARSE_TEST_SHAPES = [(1, 64, 500), (4, 128, 4096), (8, 32, 100),
                      (2, 256, 2049)]


def prefill_tol(dtype) -> tuple[float, float]:
    """(rtol, atol) between two f32 computations of causal attention whose
    outputs are rounded once to ``dtype``: f32 the reference's 2e-5; bf16
    one bf16 step (at most 2^-7 of the value) over a floor far below any
    output that f32 summation order could move."""
    import torch
    return (2e-5, 2e-5) if dtype == torch.float32 else (2.0 ** -7, 1e-5)


def phase_new_kernels(torch, report, lm):
    """Phase 7: flash_prefill and gam_coarse through the ``ops`` entries at
    the test shapes and at the LM substrate's, each held against its plain
    version; timed beside its plain version, its bound and (flash_prefill)
    SDPA."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import gam_coarse as gc
    from repro_torch.kernels import ops
    from repro_torch.models.attention import _grouped_attention
    dev = torch.device(DEVICE)
    gen = torch.Generator(dev).manual_seed(3)
    prefill = []
    for shape in PREFILL_TEST_SHAPES:
        b, s, hkv, g, hd = shape
        for dt in (torch.float32, torch.bfloat16):
            prefill.append(tuple(torch.randn(sh, device=dev, generator=gen)
                                 .to(dt) for sh in ((b, s, hkv, g, hd),
                                                    (b, s, hkv, hd),
                                                    (b, s, hkv, hd))))
    q_lm, k_lm, v_lm, lm_cfg = lm["prefill"]
    b, s, h, hd = q_lm.shape
    hkv = k_lm.shape[2]
    q5 = q_lm.reshape(b, s, hkv, h // hkv, hd).contiguous()
    i_lm = len(prefill)              # tinyllama's prefill: bf16, then f32
    prefill.append((q5, k_lm.contiguous(), v_lm.contiguous()))
    prefill.append(tuple(x.float() for x in prefill[i_lm]))
    coarse = []
    for bb, d, v in COARSE_TEST_SHAPES:
        coarse.append((torch.randn((bb, d), device=dev, generator=gen),
                       torch.randint(-1, 2, (d, v), device=dev,
                                     generator=gen, dtype=torch.int8),
                       torch.rand(v, device=dev, generator=gen)))
    i_coarse = len(coarse)       # the LM shapes: (name, B, patterns)
    lm_coarse = [("gam_coarse", LM_BATCH, lm["patterns_d2048"]),
                 ("gam_coarse@d512", LM_BATCH, lm["patterns_d512"]),
                 ("gam_coarse@b1", 1, lm["patterns_d2048"]),
                 ("gam_coarse@b64", 64, lm["patterns_d2048"])]
    for _, bb, pat in lm_coarse:
        nnz = pat.abs().sum(dim=0).float()
        coarse.append((torch.randn((bb, pat.shape[0]), device=dev,
                                   generator=gen), pat,
                       1.0 / torch.sqrt(torch.clamp(nnz, min=1.0))))

    # --- the path: the ops entries, with the counts set to 0 around it
    fp.flash_prefill.launches = gc.gam_coarse.launches = 0
    outs_p = [ops.flash_prefill(*x) for x in prefill]
    outs_c = [ops.gam_coarse(*x) for x in coarse]
    torch.cuda.synchronize()
    launches = {"flash_prefill": fp.flash_prefill.launches,
                "gam_coarse": gc.gam_coarse.launches}
    fail_unless(launches == {"flash_prefill": len(prefill),
                             "gam_coarse": len(coarse)},
                f"the ops entries launched {launches}")

    errs_p, typical = [], []
    for x, got in zip(prefill, outs_p):
        want = fp.flash_prefill_plain(*x).float()
        rtol, atol = prefill_tol(x[0].dtype)
        err = float((got.float() - want).abs().max())
        fail_unless(bool(torch.isclose(got.float(), want, rtol=rtol,
                                       atol=atol).all()),
                    f"flash_prefill {tuple(x[0].shape)} {x[0].dtype} differs "
                    f"from its plain version by {err} (mean |want| "
                    f"{float(want.abs().mean()):.3g})")
        errs_p.append(err)
        typical.append(float(want.abs().mean()))
    # the model's blockwise path (attn_f32) also computes in f32 and rounds
    # once to bf16: one bf16 step apart at most
    blockwise = _grouped_attention(q_lm, k_lm, v_lm, lm_cfg).float()
    got_lm = outs_p[i_lm].reshape(blockwise.shape).float()
    err_blockwise = float((got_lm - blockwise).abs().max())
    rtol, atol = prefill_tol(torch.bfloat16)
    fail_unless(bool(torch.isclose(got_lm, blockwise, rtol=rtol,
                                   atol=atol).all()),
                f"flash_prefill differs from the model's blockwise attention "
                f"by {err_blockwise} (mean |want| "
                f"{float(blockwise.abs().mean()):.3g})")
    errs_c = []
    for x, got in zip(coarse, outs_c):
        want = gc.gam_coarse_plain(*x)
        fail_unless(bool(((got - want).abs()
                          <= gc.coarse_tolerance(*x)).all()),
                    f"gam_coarse {tuple(x[1].shape)} differs from its plain "
                    "version beyond the f32 summation bound")
        errs_c.append(float((got - want).abs().max()))
    # the third bf16 term of h: at each LM shape's B and d (V 4,096), on
    # inputs whose answer lies in that term, the kernel against the f64
    # product, within an eighth of the error of a two-term product
    third = []
    for _, bb, pat in lm_coarse:
        xp = gc.third_term_probe(bb, pat.shape[0], 4096, seed=bb,
                                 device=dev)
        err3, err2 = gc.third_term_errors(gc.gam_coarse(*xp), *xp)
        fail_unless(err3 <= err2 / 8,
                    f"gam_coarse B {bb}, d {pat.shape[0]} loses h's third "
                    f"term: error {err3} against {err2} for two terms")
        third.append({"max_abs_err": err3, "two_terms_max_abs_err": err2,
                      "ratio": err3 / err2})
    print(f"new kernels: flash_prefill = plain at {len(prefill)} shapes "
          f"(max abs err {max(errs_p[:i_lm]):.3g} at the test shapes; at "
          f"tinyllama's prefill, mean |out| {typical[i_lm]:.3g}: bf16 "
          f"{errs_p[i_lm]:.3g}, f32 {errs_p[i_lm + 1]:.3g}, bf16 against the "
          f"model's blockwise attention {err_blockwise:.3g}); "
          f"gam_coarse = plain "
          f"within the f32 summation bound at {len(coarse)} shapes, and "
          f"within {max(r['ratio'] for r in third):.3g} of the two-term "
          f"error on the third-term inputs (at most 1/8); launches "
          f"{launches}")

    # --- timings at the LM shapes
    f, bf = 4, 2
    qs = q5.reshape(b, s, h, hd).transpose(1, 2)
    ks, vs = k_lm.transpose(1, 2), v_lm.transpose(1, 2)
    sdpa = (lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                                   enable_gqa=True))
    lib_err = float((sdpa().transpose(1, 2).reshape(q5.shape).float()
                     - outs_p[i_lm].float()).abs().max())
    pairs = s * (s + 1) / 2
    flops_half = 2.0 * b * h * hd * pairs           # q.k, and again p.v
    n_bytes = (2 * q5.numel() + k_lm.numel() + v_lm.numel()) * bf
    # q.k once and p.v three times (p as three exact bf16 terms), all at the
    # bf16 tensor-core rate; the f32 CUDA-core kernel's bound took p.v once
    # at the f32 rate
    t_ops = 4 * flops_half / BF16_FLOPS * 1e3
    t_ops_f32_pv = (flops_half / BF16_FLOPS + flops_half / F32_FLOPS) * 1e3
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    rows = [{"name": "flash_prefill", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/flash_prefill.cu",
             "replaces": "src/repro/kernels/flash_prefill.py:91",
             "launches": launches["flash_prefill"],
             "max_abs_err": errs_p[i_lm],
             "ms": time_ms(torch, lambda: fp.flash_prefill(*prefill[i_lm]),
                           10),
             "plain_ms": time_ms(torch, lambda: fp.flash_prefill_plain(
                 *prefill[i_lm]), 3),
             "bound_ms": max(t_ops, t_bytes),
             "bound_by": "operations" if t_ops >= t_bytes else "bytes",
             "library_ms": time_ms(torch, sdpa, 10)}]
    copies = {}
    for j, (name, _, pat) in enumerate(lm_coarse):
        x, err = coarse[i_coarse + j], errs_c[i_coarse + j]
        bb, d = x[0].shape
        v = x[1].shape[1]
        # bytes: each input read once, the output written once; operations:
        # the route's three bf16 mma's a product (h as three exact terms)
        # at the bf16 tensor-core rate
        c_bytes = (bb * d * f + d * v + v * f + bb * v * f) / HBM_BYTES_PER_S
        c_ops = 3 * 2.0 * bb * d * v / BF16_FLOPS
        if id(pat) not in copies:   # copies past twice the L2, walked in turn
            copies[id(pat)] = cold_copies(torch, pat)
        pf = pat.float()            # the yardstick's pre-cast copy
        rows.append({"name": name, "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/gam_coarse.cu",
                     "replaces": "src/repro/kernels/gam_coarse.py:43",
                     "launches": launches["gam_coarse"], "max_abs_err": err,
                     # in a CUDA graph, so the host's cost of an eager
                     # launch is not counted as the kernel's; the patterns
                     # warm in L2 (one copy) and cold (copies in turn)
                     "ms": graph_ms(torch, lambda x=x: gc.gam_coarse(*x)),
                     "cold_ms": cold_graph_ms(
                         torch, [lambda p=p, x=x: gc.gam_coarse(x[0], p, x[2])
                                 for p in copies[id(pat)]]),
                     "plain_ms": graph_ms(torch, lambda x=x:
                                          gc.gam_coarse_plain(*x), 5, 5),
                     "bound_ms": max(c_bytes, c_ops) * 1e3,
                     "bound_by": "bytes" if c_bytes >= c_ops else "operations",
                     "bound_note": "operations as three bf16 mma a product "
                                   "(h as three exact bf16 terms) at the bf16 "
                                   "tensor-core rate",
                     # torch.mm on a pre-cast f32 copy, TF32 off, then the
                     # scale: two calls, timed as the kernel is (warm)
                     "library_ms": graph_ms(
                         torch, lambda x=x, pf=pf: torch.mm(x[0], pf) * x[2]),
                     "library_note": "torch.mm(h, patterns_f32) * inv, two "
                                     "calls",
                     # gam_coarse.third_term_probe at this B and d, V 4,096
                     "third_term": third[j]})
        del pf
    del copies
    report["new_kernels"] = {
        "flash_prefill_lm_mean_abs_out": typical[i_lm],
        "flash_prefill_lm_f32_max_abs": errs_p[i_lm + 1],
        "flash_prefill_vs_blockwise_max_abs": err_blockwise,
        "sdpa_vs_kernel_max_abs": lib_err,
        "flash_prefill_bound_ms_pv_f32_rate": t_ops_f32_pv,
        "flash_prefill_bound_ms_f32_rate": 2 * flops_half / F32_FLOPS * 1e3,
        "flash_prefill_bound_ms_bf16_rate": 2 * flops_half / BF16_FLOPS * 1e3,
        "flash_prefill_bound_ms_bytes": t_bytes}
    eager = time_ms(torch, lambda: gc.gam_coarse(*coarse[i_coarse]), 20)
    report["new_kernels"]["gam_coarse_eager_call_ms"] = eager
    for row in rows:
        cold = (f" (cold L2 {row['cold_ms']:.4f} ms)" if "cold_ms" in row
                else "")
        print(f"{row['name']}: kernel {row['ms']:.4f} ms{cold}, plain "
              f"{row['plain_ms']:.4f} ms, library {row['library_ms']}, bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
    print(f"flash_prefill bound at tinyllama's prefill: "
          f"{t_ops:.4f} ms with q.k and three p.v (p as three exact bf16 "
          f"terms) at the bf16 rate; {t_ops_f32_pv:.4f} ms with p.v once at "
          f"the f32 rate (the f32 CUDA-core kernel's bound), "
          f"{2 * flops_half / F32_FLOPS * 1e3:.4f} ms "
          f"all f32, {2 * flops_half / BF16_FLOPS * 1e3:.4f} ms all bf16, "
          f"{t_bytes:.4f} ms by bytes; sdpa vs kernel max abs {lib_err:.3g}; "
          f"gam_coarse timed in a CUDA graph, patterns warm and cold in L2 "
          f"(one eager call at B 8, d 2048: "
          f"{eager:.4f} ms)")
    return rows


# --------------------------------------------------- 8. the learning loop

ML20M_USERS, ML20M_ITEMS, ML20M_DENSITY = 138_493, 26_744, 0.0054
LEARN_ITEMS = 1 << 20
LEARN_USERS, LEARN_EVENTS, LEARN_ROUNDS = 64, 8192, 10
LEARN_RECALL_ROUNDS = (1, 5, 10)


class Capture:
    """While active, the arguments of the first call of ``module.name`` at
    each new set of tensor shapes: the kernel is then held against its
    plain version on the inputs the main path gave it.  Calls and the
    launch count pass through unchanged (as in ``Spans``)."""

    def __init__(self, module, name):
        self.module, self.name, self.calls = module, name, {}

    def __enter__(self):
        orig = self.orig = getattr(self.module, self.name)

        def recorded(*args, **kw):
            key = tuple(tuple(a.shape) for a in args if hasattr(a, "shape"))
            self.calls.setdefault(key, (args, kw))
            return orig(*args, **kw)
        recorded.launches = orig.launches
        setattr(self.module, self.name, recorded)
        return self

    def __exit__(self, *exc):
        self.orig.launches = getattr(self.module, self.name).launches
        setattr(self.module, self.name, self.orig)


class Uncounted:
    """Launches made inside (checks, the frozen baseline) are taken back
    off the kernels' counts: they are not the main path's."""

    def __init__(self, *fns):
        self.fns = fns          # (module, name) pairs

    def __enter__(self):
        self.saved = [getattr(m, n).launches for m, n in self.fns]
        return self

    def __exit__(self, *exc):
        for (m, n), c in zip(self.fns, self.saved):
            getattr(m, n).launches = c


def retrieve_work(torch, args, kw, got) -> tuple[float, float]:
    """(bytes, operations) one ``gam_retrieve`` call must move and do, by
    phase 4's count: the shared metadata and kept tiles, each candidate
    row's factors once, 2k operations a (query, candidate) pair."""
    gr = importlib.import_module("repro_torch.kernels.gam_retrieve")
    users, _, q_tau, q_mask, meta, kappa = args
    q, k = users.shape
    q_bits = gr.pack_patterns(q_tau, q_mask, meta.p)
    alive8 = gr._alive8(kw.get("alive"), meta, users.device)
    spill8 = meta.spill8[0]
    rows = torch.zeros(meta.n_pad, dtype=torch.bool, device=users.device)
    step = 1 << 18
    for lo in range(0, meta.n_pad, step):
        hi = min(meta.n_pad, lo + step)
        ov = torch.zeros((q, hi - lo), dtype=torch.int32, device=users.device)
        for w in range(meta.words):
            ov += gr.popcount32(q_bits[:, w, None]
                                & meta.item_bits_t[w, None, lo:hi])
        cand = ((ov >= kw.get("min_overlap", 1)) | (spill8[lo:hi] != 0)) \
            & (alive8[lo:hi] != 0)
        rows[lo:hi] = cand.any(dim=0)
    f = 4
    blocks = int((~got.skipped).any(dim=0).sum())
    nb, qb, words, bn = (meta.n_blocks, got.skipped.shape[0], meta.words,
                         meta.bn)
    n_bytes = (q * k * (f + 1 + f) + nb * (words * f + 1)
               + blocks * bn * (words * f + 2) + q * nb * f + qb * nb
               + int(rows.sum()) * k * f + q * kappa * 2 * f
               + got.seg_counts.numel() * f)
    return n_bytes, 2 * k * int(got.blk_counts.sum())


def check_segment_sums(torch, call, q: int, n_blocks: int, where: str
                       ) -> str:
    """``call(rows, segments)`` (a fused retrieval over the first ``rows``
    queries) must give ``seg_counts`` equal to its ``blk_counts`` summed by
    segment, bit for bit: at one segment and at eight uneven ones, for ``q``
    queries and for ``q - 1`` (not a multiple of the merge kernel's four
    warps).  -> the line to print."""
    eight = (0, 1, 3, n_blocks // 5, n_blocks // 3, n_blocks // 2,
             n_blocks - 9, n_blocks - 1)
    for rows in (q, q - 1):
        for seg in (None, eight):
            got = call(rows, seg)
            blk = got.blk_counts.long()
            starts = [0] if seg is None else list(seg)
            want = torch.stack([blk[:, a:b].sum(1) for a, b in
                                zip(starts, starts[1:] + [n_blocks])], 1)
            fail_unless(got.seg_counts.shape == want.shape
                        and torch.equal(got.seg_counts.long(), want),
                        f"{where}: seg_counts differ from blk_counts summed "
                        f"by segment (Q {rows}, segments {seg})")
    return (f"{where}: seg_counts = blk_counts by segment (1 and 8 "
            f"segments, Q {q} and {q - 1})")


def learning_kernel_rows(torch, cap_r, cap_t, cap_s, launches, where):
    """The ``kernels`` rows of phase 8: each captured call of
    ``gam_retrieve``, ``tess_project`` and ``gam_score`` re-run through the
    kernel and its plain version on the same inputs and timed, beside its
    bound.  ``launches``: the phase's main-path counts."""
    gr = importlib.import_module("repro_torch.kernels.gam_retrieve")
    gs = importlib.import_module("repro_torch.kernels.gam_score")
    tp = importlib.import_module("repro_torch.kernels.tess_project")
    rows = []
    for key, (args, kw) in cap_r.items():
        got = gr.gam_retrieve(*args, **kw)
        want = gr.gam_retrieve_plain(*args, **kw)
        torch.cuda.synchronize()
        for name in ("rows", "blk_counts", "skipped"):
            fail_unless(torch.equal(getattr(got, name), getattr(want, name)),
                        f"gam_retrieve@{where} {name} differ from the plain "
                        "version")
        gv, wv = got.vals.cpu().numpy(), want.vals.cpu().numpy()
        fail_unless(max_ulp(gv, wv) <= ULP,
                    f"gam_retrieve@{where} scores beyond 4 ulp")
        b_ms, b_by = bound_ms(*retrieve_work(torch, args, kw, got))
        rows.append({
            "name": f"gam_retrieve@{where}_{key[0][0]}x{key[1][0]}",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/gam_retrieve.cu",
            "replaces": "src/repro/kernels/gam_retrieve.py:384",
            "launches": launches["gam_retrieve"],
            "max_abs_err": float(np.abs(gv - wv).max()),
            "ms": time_ms(torch, lambda: gr.gam_retrieve(*args, **kw), 20),
            "plain_ms": time_ms(torch,
                                lambda: gr.gam_retrieve_plain(*args, **kw), 3),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
    for key, (args, _) in cap_t.items():
        z = args[0]
        n = z.shape[0]
        pat, a = tp.tess_project(z)
        pat_p, a_p = tp.tess_project_plain(z)
        torch.cuda.synchronize()
        differ = (pat != pat_p).any(dim=1).cpu().numpy()
        fail_unless(near_tie_rows(z[np.nonzero(differ)[0]].cpu().numpy())
                    .all(), f"tess_project@{where} ({n} rows) rows differ "
                    "and are not near-ties")
        same = torch.as_tensor(~differ, device=z.device)
        err = float((a[same] - a_p[same]).abs().max()) if n else 0.0
        fail_unless(err == 0.0, f"tess_project@{where} ({n} rows) a differs")
        b_ms, b_by = bound_ms(n * z.shape[1] * (4 + 1 + 4), 3 * z.shape[1] * n)
        rows.append({
            "name": f"tess_project@{where}_{n}rows", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/tess_project.cu",
            "replaces": "src/repro/kernels/tess_project.py:57",
            "launches": launches["tess_project"], "max_abs_err": err,
            "ms": time_ms(torch, lambda: tp.tess_project(z), 20),
            "plain_ms": time_ms(torch, lambda: tp.tess_project_plain(z), 3),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
    for key, (args, _) in cap_s.items():
        u, v, mask = args
        sc, sc_p = gs.gam_score(u, v, mask), gs.gam_score_plain(u, v, mask)
        torch.cuda.synchronize()
        torch.testing.assert_close(sc, sc_p, rtol=1e-6, atol=1e-6)
        q, n, k = u.shape[0], v.shape[0], u.shape[1]
        b_ms, b_by = bound_ms(q * k * 4 + n * k * 4 + q * n * (1 + 4),
                              2 * k * int(mask.sum()))
        rows.append({
            "name": f"gam_score@{where}_{q}x{n}", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/gam_score.cu",
            "replaces": "src/repro/kernels/gam_score.py:60",
            "launches": launches["gam_score"],
            "max_abs_err": float((sc - sc_p).abs().max()),
            "ms": time_ms(torch, lambda: gs.gam_score(u, v, mask), 20),
            "plain_ms": time_ms(torch, lambda: gs.gam_score_plain(u, v, mask),
                                3),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
    return rows


def pick(calls: dict, keep) -> dict:
    """The captured calls whose shape key ``keep`` selects."""
    return {key: c for key, c in calls.items() if keep(key)}


def same_factors(a, b, what):
    fail_unless(all(np.array_equal(x, y) for x, y in zip(a, b)),
                f"{what}: two train_mf runs with one seed differ")


def load_example(name: str):
    """``examples/<name>.py`` as a module (as ``tests/test_torch_examples.py``
    loads it)."""
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def baseline_codes(impl, x) -> np.ndarray:
    """A §5.1 baseline's codes of rows ``x``: (n_tables, B) hash codes, or
    (1, B) PCA-tree leaves."""
    if hasattr(impl, "leaf_of"):
        return impl.leaf_of(x)[None].cpu().numpy()
    return impl._codes(impl._users(x)).cpu().numpy()


def candidate_sets(impl, users) -> list:
    qrow, rows = impl.candidates(impl._users(users))
    qrow, rows = qrow.cpu().numpy(), rows.cpu().numpy()
    return [set(rows[qrow == q].tolist()) for q in range(len(users))]


def lineup_against_cpu(card, cpu, users, items) -> dict:
    """8d: the card's §6 line-up against the port's on the CPU, on the
    card's factors.  ``gam`` and ``gam-sparse``: per-user accuracy and
    discard equal.  The baselines: discard equal but for boundary users,
    whose candidate sets differ between the card's structure and the
    CPU's; each must be explained by codes (hash codes, PCA leaves) that
    differ between the two, the user's own or those of every item in the
    two sets' difference (the same planes, seeds and dot-product order on
    both, so only rounding sets a code apart).  Returns the counts."""
    for name in ("gam", "gam-sparse"):
        for key in ("accuracy", "discard"):
            fail_unless(np.array_equal(card["lineup"][name][key],
                                       cpu["lineup"][name][key]),
                        f"8d: {name} {key} on the card differs from the "
                        "CPU's")
    counts = {}
    for name in ("srp-lsh", "superbit-lsh", "cro", "pca-tree"):
        a, b = card["methods"][name]._impl, cpu["methods"][name]._impl
        u_moved = (baseline_codes(a, users) != baseline_codes(b, users)).any(0)
        i_moved = set(np.nonzero((baseline_codes(a, items)
                                  != baseline_codes(b, items)).any(0))[0]
                      .tolist())
        sets = list(zip(candidate_sets(a, users), candidate_sets(b, users)))
        moved = np.array([x != y for x, y in sets])
        explained = u_moved | np.array([(x ^ y) <= i_moved for x, y in sets])
        fail_unless(not (moved & ~explained).any(),
                    f"8d: {name}: users {np.nonzero(moved & ~explained)[0]} "
                    "have other candidates on the card than on the CPU, "
                    "with no code apart")
        differ = (card["lineup"][name]["discard"]
                  != cpu["lineup"][name]["discard"])
        fail_unless(not (differ & ~moved).any(),
                    f"8d: {name}: discard differs with equal candidates")
        counts[name] = {"boundary_users": int(moved.sum()),
                        "items_apart": len(i_moved),
                        "discard_differs": int(differ.sum())}
    return counts


def phase_repro(torch, out) -> list:
    """8d: ``examples/movielens_repro_torch.py``'s ``main`` on the card, in
    this process, under the launch counters and the captures of the three
    kernels; then the line-up against the CPU's on the card's factors and
    each captured call against its plain version.  Fills ``out["8d"]``;
    returns the ``kernels`` rows."""
    from repro_torch.configs.gam_mf import MF
    gr = importlib.import_module("repro_torch.kernels.gam_retrieve")
    tp = importlib.import_module("repro_torch.kernels.tess_project")
    gs = importlib.import_module("repro_torch.kernels.gam_score")
    kernels = ((gr, "gam_retrieve"), (tp, "tess_project"), (gs, "gam_score"))
    ex = load_example("movielens_repro_torch")
    for m, n in kernels:
        getattr(m, n).launches = 0
    t0 = time.perf_counter()
    with Capture(gr, "gam_retrieve") as cap_r, \
            Capture(tp, "tess_project") as cap_t, \
            Capture(gs, "gam_score") as cap_s:
        try:
            card = ex.main(["--device", DEVICE])
        except AssertionError as e:
            fail_unless(False, "8d: an assertion of "
                        f"examples/movielens_repro_torch.py failed on the "
                        f"card: {e!r}")
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {n: getattr(m, n).launches for m, n in kernels}
    for name, n in launches.items():
        fail_unless(n > 1, f"8d: {name} launched {n} times, not more than "
                    "once")
    u, v = card["u"], card["v"]
    users = u[:ex.LINEUP_USERS]
    with Uncounted(*kernels):
        t0 = time.perf_counter()
        methods = ex.build_methods(v, MF.k, gam_threshold=0.25,
                                   gam_min_overlap=2, sparse_threshold=0.15,
                                   device="cpu")
        cpu = {"methods": methods,
               "lineup": ex.evaluate(methods, v, users, kappa=KAPPA,
                                     device="cpu")}
        cpu_s = time.perf_counter() - t0
        boundary = lineup_against_cpu(card, cpu, users, v)
        # every captured call is held to its plain version; the kernels
        # line keeps the line-up's shapes, a request of 64 and of 1 at the
        # largest group, the map at the catalog, the users, 64, 1 and the
        # largest delta
        rows = learning_kernel_rows(torch, cap_r.calls, cap_t.calls,
                                    cap_s.calls, launches, "8d")
    largest = {}
    for key in cap_r.calls:
        largest[key[0][0]] = max(largest.get(key[0][0], 0), key[1][0])
    delta = max((key[0][0] for key in cap_t.calls
                 if key[0][0] != len(v)), default=0)
    keep = ({f"gam_retrieve@8d_{q}x{n}" for q, n in largest.items()}
            | {f"tess_project@8d_{n}rows"
               for n in (len(v), ex.LINEUP_USERS, 64, 1, delta)}
            | {f"gam_score@8d_{key[0][0]}x{key[1][0]}" for key in cap_s.calls})
    rows = [r for r in rows if r["name"] in keep]
    lineup = {name: {key: r[key] for key in ("accuracy_mean", "discard_mean",
                                             "speedup")}
              for name, r in card["lineup"].items()}
    out["8d"] = {"wall_s": wall_s, "stage_s": card["stage_s"],
                 "lineup": lineup, "push": card["push"],
                 "cache": card["cache"], "wrong": card["wrong"],
                 "launches": launches, "cpu_lineup_s": cpu_s,
                 "boundary": boundary,
                 "calls_checked": {"gam_retrieve": len(cap_r.calls),
                                   "tess_project": len(cap_t.calls),
                                   "gam_score": len(cap_s.calls)}}
    ps, cs = card["push"], card["cache"]
    print(f"learn 8d: examples/movielens_repro_torch.py on the card in "
          f"{wall_s:.2f} s, stages " + ", ".join(
              f"{k} {t:.3f} s" for k, t in card["stage_s"].items())
          + "; line-up (accuracy / discard) " + ", ".join(
              f"{name} {r['accuracy_mean']:.4f} / {r['discard_mean']:.4f}"
              for name, r in lineup.items())
          + f"; = the CPU's on the card's factors ({cpu_s:.2f} s), "
          f"boundary users {boundary}; pushed {ps['pushed']}, suppressed "
          f"{ps['suppressed']}; cache hit rate {cs['hit_rate']:.4f}, "
          f"{cs['invalidations']} invalidations, wrong {card['wrong']}; "
          f"launches {launches}; calls held to plain "
          f"{out['8d']['calls_checked']}")
    return rows


def phase_learning(torch, report):
    """Phase 8: the paper's learning loop on the card.  8a trains the §6.2
    factors twice (bit-identical), maps and serves them; 8b runs one epoch
    at MovieLens-20M's shape; 8c learns a drifting 1M-item catalog into a
    live ``sharded`` service through ``StreamingMF`` and ``PushPolicy``;
    8d runs the paper's §6.2 chain, ``examples/movielens_repro_torch.py``."""
    import dataclasses as dc

    from repro_torch.configs import gam_mf
    from repro_torch.core.mapping import sparse_map
    from repro_torch.core.retrieval import masked_topk, recovery_accuracy
    from repro_torch.data import movielens_like_ratings
    from repro_torch.factorization import train_mf
    gr = importlib.import_module("repro_torch.kernels.gam_retrieve")
    gs = importlib.import_module("repro_torch.kernels.gam_score")
    tp = importlib.import_module("repro_torch.kernels.tess_project")
    from repro_torch.kernels.gam_score import NEG
    from repro_torch.online import (DriftSimulator, OnlineMFConfig,
                                    PushPolicy, StreamingMF)
    from repro_torch.retriever import RetrieverSpec, open_retriever

    kernels = ((gr, "gam_retrieve"), (tp, "tess_project"), (gs, "gam_score"))

    def counts():
        return {n: getattr(m, n).launches for m, n in kernels}

    out, kernel_rows = {}, []
    # ---- 8a: the §6.2 loop at MovieLens-100k's shape, k 10
    rows, cols, vals = movielens_like_ratings(seed=0)
    n_u, n_i = 943, 1682
    for fn in (gr.gam_retrieve, tp.tess_project, gs.gam_score):
        fn.launches = 0
    with Capture(gr, "gam_retrieve") as cap_r, \
            Capture(tp, "tess_project") as cap_t:
        runs, train_s = [], []
        for _ in range(2):
            t0 = time.perf_counter()
            runs.append(train_mf(rows, cols, vals, n_u, n_i, gam_mf.MF,
                                 device=DEVICE))
            torch.cuda.synchronize()
            train_s.append(time.perf_counter() - t0)
        u, v, hist = runs[0]
        same_factors(runs[0][:2], runs[1][:2], "8a")
        fail_unless(runs[0][2] == runs[1][2], "8a: the mse histories differ")
        fail_unless(hist[-1] < hist[0], "8a: the training mse did not fall")
        # a bucket of the catalog's size: no posting list can spill
        spec = RetrieverSpec(cfg=gam_mf.GAM, backend="gam-device",
                             min_overlap=gam_mf.MIN_OVERLAP, kappa=KAPPA,
                             bucket=n_i)
        r = open_retriever(spec, items=v, device=DEVICE)
        res = r.query(u)
    launches_a = counts()
    for name in ("gam_retrieve", "tess_project"):
        fail_unless(launches_a[name] > 0, f"8a: {name} never launched")
    ut = torch.as_tensor(u, device=DEVICE)
    with Capture(gs, "gam_score") as cap_s:
        o_vals, o_ids = masked_topk(ut, r._items_dev, r.candidate_masks(u),
                                    KAPPA)
    o_vals, o_ids = o_vals.cpu().numpy(), o_ids.cpu().numpy()
    empty = o_vals <= NEG / 2
    fail_unless(np.array_equal(res.ids, np.where(empty, -1, o_ids)),
                "8a: served ids differ from the dense oracle")
    fail_unless(max_ulp(np.where(empty, 0, res.scores),
                        np.where(empty, 0, o_vals)) <= ULP,
                "8a: served scores beyond 4 ulp of the dense oracle")
    brute = open_retriever(RetrieverSpec(cfg=gam_mf.GAM, backend="brute",
                                         kappa=KAPPA), items=v, device=DEVICE)
    recall_a = float(recovery_accuracy(res.ids, brute.query(u).ids).mean())
    launches_a["gam_score_oracle"] = gs.gam_score.launches
    kernel_rows += learning_kernel_rows(
        torch, cap_r.calls, cap_t.calls, cap_s.calls,
        launches_a | {"gam_score": launches_a["gam_score_oracle"]}, "8a")
    out["8a"] = {"ratings": int(len(vals)), "train_s": train_s,
                 "history": hist, "recall": recall_a,
                 "discarded": float(res.discarded_frac.mean()),
                 "launches": launches_a}
    print(f"learn 8a: train_mf (k 10, lr 0.005, 25 epochs, batch 8192) on "
          f"{len(vals)} ratings of {n_u} x {n_i}: {train_s[0]:.2f} s, "
          f"{train_s[1]:.2f} s, the two runs bit-identical; mse "
          f"{hist[0]:.4f} -> {hist[-1]:.4f}; gam-device over V: {n_u} users "
          f"at kappa {KAPPA}, ids = the dense oracle, recall@{KAPPA} vs brute "
          f"{recall_a:.4f}, discarded {out['8a']['discarded']:.4f}; launches "
          f"{launches_a}")
    del r, brute, runs

    # ---- 8b: one epoch at MovieLens-20M's shape
    t0 = time.perf_counter()
    rows, cols, vals = movielens_like_ratings(
        seed=0, n_users=ML20M_USERS, n_items=ML20M_ITEMS,
        density=ML20M_DENSITY)
    gen_s = time.perf_counter() - t0
    one = dc.replace(gam_mf.MF, epochs=1)
    runs, epoch_s = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        runs.append(train_mf(rows, cols, vals, ML20M_USERS, ML20M_ITEMS, one,
                             device=DEVICE))
        torch.cuda.synchronize()
        epoch_s.append(time.perf_counter() - t0)
    # the host's share of a call: the epoch's permutation, drawn alone
    t0 = time.perf_counter()
    np.random.default_rng(0).permutation(len(vals))
    perm_s = time.perf_counter() - t0
    same_factors(runs[0][:2], runs[1][:2], "8b")
    fail_unless(runs[0][2] == runs[1][2], "8b: the mse histories differ")
    fail_unless(all(np.isfinite(x).all() for x in runs[0][:2]),
                "8b: non-finite factors")
    n20 = int(len(vals))
    out["8b"] = {"ratings": n20, "generator_s": gen_s, "epoch_s": epoch_s,
                 "permutation_s": perm_s,
                 "ratings_per_s": n20 / min(epoch_s),
                 "steps": -(-n20 // one.batch), "mse": runs[0][2]}
    print(f"learn 8b: movielens_like_ratings at {ML20M_USERS} x "
          f"{ML20M_ITEMS}, density {ML20M_DENSITY}: {n20} ratings, "
          f"{gen_s:.1f} s on the host; one epoch of train_mf (batch "
          f"{one.batch}, {out['8b']['steps']} steps, the whole call) "
          f"{epoch_s[0]:.2f} s and {epoch_s[1]:.2f} s, bit-identical, "
          f"{out['8b']['ratings_per_s']:.0f} ratings/s; the permutation "
          f"alone {perm_s:.2f} s on the host")
    del rows, cols, vals, runs

    # ---- 8c: online learning into the live service at 1M items
    sim = DriftSimulator(n_users=LEARN_USERS, n_items=LEARN_ITEMS, k=K,
                         seed=17, drift=0.2, hot_frac=0.5,
                         events_per_round=LEARN_EVENTS)
    items0 = sim.items_at_start
    tau, mvals = sparse_map(torch.as_tensor(items0, device=DEVICE),
                            gam_mf.GAM)
    nz = (mvals != 0).cpu().numpy()
    longest = int(np.bincount(tau.cpu().numpy()[nz],
                              minlength=gam_mf.GAM.p).max())
    del tau, mvals, nz
    # pushes may lengthen a list by one entry each; the delta cannot hold
    # more rows than the rounds push, so neither structure spills
    spec = RetrieverSpec(
        cfg=gam_mf.GAM, backend="sharded", n_shards=SVC_SHARDS,
        min_overlap=gam_mf.MIN_OVERLAP, kappa=KAPPA,
        bucket=longest + LEARN_ROUNDS * LEARN_EVENTS,
        delta_bucket=LEARN_ROUNDS * LEARN_EVENTS, batch_size=BATCH)
    t0 = time.perf_counter()
    live = open_retriever(spec, items=items0, device=DEVICE)
    frozen = open_retriever(spec, items=items0, device=DEVICE)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    fail_unless(live.base.spills.shape[1] == 0, "8c: the shards spill")
    trainer = StreamingMF(OnlineMFConfig(k=K, lr=0.5, momentum=0.6, reg=1e-4,
                                         batch=1024, seed=3,
                                         update_users=False), device=DEVICE)
    trainer.warm_start(u=sim.users, v=items0)
    tick = [0.0]
    policy = PushPolicy(live, min_cos=0.995, staleness_s=4.0,
                        clock=lambda: tick[0])
    upsert_ms = []                      # a flush's upsert, on the host clock
    live_upsert = live.upsert

    def timed_upsert(ids, factors):
        t0 = time.perf_counter()
        live_upsert(ids, factors)
        torch.cuda.synchronize()
        upsert_ms.append((time.perf_counter() - t0) * 1e3)
    live.upsert = timed_upsert
    policy.seed(np.arange(LEARN_ITEMS), items0)
    catalog = items0.copy()
    users = sim.users
    fit_ms, flush_ms, query_ms, recall = [], [], [], {}
    gam_score_oracle = 0
    for fn in (gr.gam_retrieve, tp.tess_project, gs.gam_score):
        fn.launches = 0
    with Capture(gr, "gam_retrieve") as cap_r, \
            Capture(tp, "tess_project") as cap_t:
        for rnd in range(1, LEARN_ROUNDS + 1):
            tick[0] += 1.0
            events = sim.step()
            t0 = time.perf_counter()
            fit = trainer.partial_fit(events)
            torch.cuda.synchronize()
            fit_ms.append((time.perf_counter() - t0) * 1e3)
            touched = fit["touched_items"]
            policy.offer(touched, trainer.item_factors(touched))
            t0 = time.perf_counter()
            p_ids, p_fac = policy.flush()
            torch.cuda.synchronize()
            flush_ms.append((time.perf_counter() - t0) * 1e3)
            catalog[p_ids] = p_fac
            t0 = time.perf_counter()
            res = live.query(users)
            torch.cuda.synchronize()
            query_ms.append((time.perf_counter() - t0) * 1e3)
            fail_unless(res.ids.shape == (LEARN_USERS, KAPPA),
                        "8c: result shape")
            with Uncounted(*kernels):
                if rnd in LEARN_RECALL_ROUNDS:
                    truth = sim.true_topk(KAPPA)
                    recall[rnd] = {
                        "online": sim.recall(res.ids, truth),
                        "frozen": sim.recall(frozen.query(users).ids, truth)}
                before = gs.gam_score.launches
                check_oracle(torch, live, users, res, f"8c round {rnd}")
                gam_score_oracle += gs.gam_score.launches - before
    launches_c = counts()
    for name in ("gam_retrieve", "tess_project"):
        fail_unless(launches_c[name] > 0, f"8c: {name} never launched in "
                    "the rounds")
    fail_unless(policy.n_pushed > 0, "8c: no factor was pushed")
    fail_unless(live.delta._index is None or
                live.delta._index.spill.numel() == 0, "8c: the delta spills")
    ids = np.arange(LEARN_ITEMS, dtype=np.int64)
    fresh = open_retriever(spec, items=catalog, ids=ids, device=DEVICE)
    fail_unless(fresh.base.spills.shape[1] == 0, "8c: the rebuild spills")
    for exact in (False, True):
        same_bits(live.query(users, exact=exact),
                  fresh.query(users, exact=exact),
                  f"8c: the live service (exact={exact}) differs from a "
                  "sharded rebuild over the pushed catalog")
    m = live.metrics.snapshot()
    # the kernels line: the base and the last delta as the queries gave
    # them to gam_retrieve, and tess_project at a round's queries and at
    # the largest delta it mapped
    biggest = max(key[0][0] for key in cap_t.calls)
    deltas = [key[1][0] for key in cap_r.calls if key[1][0] != LEARN_ITEMS]
    kernel_rows += learning_kernel_rows(
        torch,
        pick(cap_r.calls, lambda key: key[1][0] in (LEARN_ITEMS,
                                                    max(deltas, default=0))),
        pick(cap_t.calls, lambda key: key[0][0] in (LEARN_USERS, biggest)),
        {}, launches_c, "8c")
    out["8c"] = {
        "items": LEARN_ITEMS, "events_per_round": LEARN_EVENTS,
        "rounds": LEARN_ROUNDS, "build_two_s": build_s,
        "pushed": policy.n_pushed, "suppressed": policy.n_suppressed,
        "staleness_p50_s": m["push_staleness_p50_s"],
        "partial_fit_ms": fit_ms, "flush_ms": flush_ms,
        "upsert_ms": upsert_ms,
        "query_ms": query_ms, "query_p50_ms": float(np.median(query_ms)),
        "delta_rows": len(live.delta), "recall": recall,
        "launches": launches_c, "gam_score_oracle": gam_score_oracle}
    report["learning"] = out
    print(f"learn 8c: {LEARN_ITEMS} items in {SVC_SHARDS} shards (live and "
          f"frozen built in {build_s:.1f} s), {LEARN_ROUNDS} rounds of "
          f"{LEARN_EVENTS} events: pushed {policy.n_pushed}, suppressed "
          f"{policy.n_suppressed}, staleness p50 {m['push_staleness_p50_s']}"
          f" s; partial_fit p50 {np.median(fit_ms):.2f} ms a round, flush "
          f"(gate + upsert) p50 {np.median(flush_ms):.2f} ms of which the "
          f"upsert {np.median(upsert_ms):.2f} ms, query of "
          f"{LEARN_USERS} users p50 {np.median(query_ms):.3f} ms (host "
          f"clock); delta {len(live.delta)} rows at the end; every answer = "
          f"the dense oracle; after the last round live = a sharded rebuild "
          f"bit for bit (exact False and True); launches {launches_c}")
    print("learn 8c: recall@10 online / frozen against the drifted truth: "
          + ", ".join(f"round {k} {v['online']:.4f} / {v['frozen']:.4f}"
                      for k, v in recall.items()))
    del live, frozen, fresh, trainer, policy, sim
    torch.cuda.empty_cache()

    # ---- 8d: the paper's §6.2 chain, through the example
    kernel_rows += phase_repro(torch, out)
    return kernel_rows


# ------------------------------------------------- 9. multi-host serving

MH_HOSTS = 2                   # processes sharing the one card
MH_WINDOW = 100                # requests in the timed window
MH_ORACLE = 2                  # window requests host 0 holds to the oracle
MH_GROUP_TIMEOUT = 600         # s: the gloo group's rendezvous, collectives
MH_DEADLINE = 900              # s: both 9a workers, or the phase fails
MH_LAUNCHER_TIMEOUT = 420      # s: each 9b launcher run


def multihost_worker(rank: int, coordinator: str, bucket: int) -> int:
    """Phase 9a's SPMD body: one of two processes sharing the card, joined
    by a gloo group, each driving the same lifecycle on the
    ``sharded-multihost`` backend (replication 2, then 1) beside an
    in-process ``sharded`` retriever over the same catalog.  Prints its
    numbers as one ``MH9 {json}`` line."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.mapping import GamConfig
    from repro_torch.launch.procs import init_process_group
    from repro_torch.obs.tracing import Tracer
    from repro_torch.retriever import RetrieverSpec, open_retriever
    gr = importlib.import_module("repro_torch.kernels.gam_retrieve")
    gs = importlib.import_module("repro_torch.kernels.gam_score")
    tp = importlib.import_module("repro_torch.kernels.tess_project")

    init_process_group(coordinator, MH_HOSTS, rank,
                       timeout_s=MH_GROUP_TIMEOUT)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    items, centers = clustered_catalog(N_ITEMS, K, N_CLUSTERS, SIGMA,
                                       seed=N_ITEMS)
    stream = iter(requests(centers, 64, BATCH, SIGMA, seed=9))
    cfg = GamConfig(k=K, scheme="parse_tree", threshold=THRESHOLD)

    def spec(backend, **kw):
        return RetrieverSpec(
            cfg=cfg, backend=backend, n_shards=SVC_SHARDS,
            min_overlap=MIN_OVERLAP, kappa=KAPPA, bucket=bucket,
            delta_bucket=1 << 15, batch_size=BATCH,
            options=(("compact_slice_rows", SVC_SLICE_ROWS),
                     ("rebalance_target_blocks", SVC_TARGET_BLOCKS)), **kw)

    def in_turn(fn):
        """``fn`` on each host in turn, the other one waiting at a barrier:
        a timing with the card to itself."""
        for h in range(MH_HOSTS):
            if h == rank:
                fn()
            dist.barrier()

    checks = Uncounted((gr, "gam_retrieve"), (tp, "tess_project"),
                       (gs, "gam_score"))
    out: dict = {"host": rank, "device": str(dev),
                 "launches_per_request": []}

    def served(r, users, what, **kw):
        """One request through the multi-host retriever, on the host clock;
        its gam_retrieve launches must be the bn-groups of the slices routed
        to this host plus one for a non-empty delta."""
        g0 = gr.gam_retrieve.launches
        t0 = time.perf_counter()
        res = r.query(users, **kw)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        n = gr.gam_retrieve.launches - g0
        routing = r.base.placement.route(r._down)
        want = sum(len(r.base.get_slice(sl).metas)
                   for sl, h in enumerate(routing) if h == rank)
        want += 1 if len(r.delta) else 0
        fail_unless(n == want, f"host {rank} {what}: gam_retrieve launched "
                    f"{n} times, not {want} (the groups of its routed "
                    "slices + the delta)")
        out["launches_per_request"].append(n)
        return res, ms

    def same(res, users, what, **kw):
        with checks:
            want = single.query(users, **kw)
        fail_unless(np.array_equal(res.ids, want.ids)
                    and np.array_equal(res.scores, want.scores)
                    and np.array_equal(res.n_scored, want.n_scored)
                    and np.array_equal(res.discarded_frac,
                                       want.discarded_frac),
                    f"host {rank} {what}: the multi-host answer differs "
                    "from single-host sharded")

    def step(r, what, **kw):
        users = next(stream)
        res, _ = served(r, users, what, **kw)
        same(res, users, what, **kw)
        return users, res

    # --- the main path: build, lifecycle, window; counts read after it
    gr.gam_retrieve.launches = tp.tess_project.launches = 0
    tracer = Tracer(clock=time.perf_counter)
    t0 = time.perf_counter()
    multi = open_retriever(spec("sharded-multihost", n_hosts=MH_HOSTS,
                                replication=MH_HOSTS), items=items,
                           device=dev, tracer=tracer)
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t0
    fail_unless(multi._distributed and multi.base.has_all_slices,
                f"host {rank}: not a distributed host holding every slice")
    with checks:
        single = open_retriever(spec("sharded"), items=items, device=dev)
    with Capture(gr, "gam_retrieve") as cap:
        step(multi, "after build")
    mine = [sl for sl, h in enumerate(multi.base.placement.route())
            if h == rank]
    out["placement"] = multi.base.placement.describe()
    out["slice_rows"] = multi.base.get_slice(mine[0]).partition.n_rows
    slice_calls = pick(cap.calls, lambda key: key[1][0] == out["slice_rows"])
    fail_unless(len(slice_calls) == 1, f"host {rank}: no launch on its slice")
    kernel_row = []

    def slice_row():
        with checks:
            kernel_row.extend(learning_kernel_rows(
                torch, slice_calls, {}, {}, {"gam_retrieve": 0},
                "multihost_slice"))

    in_turn(slice_row)
    del cap, slice_calls
    step(multi, "after build, exact", exact=True)

    rng = np.random.default_rng(7)
    fresh = np.arange(N_ITEMS, N_ITEMS + SVC_FRESH)
    up_ids = np.concatenate([fresh, rng.choice(N_ITEMS, SVC_REWRITE,
                                               replace=False)])
    up = (centers[rng.integers(0, N_CLUSTERS, up_ids.size)]
          + SIGMA * rng.normal(size=(up_ids.size, K))).astype(np.float32)
    up /= np.linalg.norm(up, axis=1, keepdims=True)
    dead = rng.choice(N_ITEMS, SVC_DELETE, replace=False)
    multi.upsert(up_ids, up)
    multi.delete(dead)
    with checks:
        single.upsert(up_ids, up)
        single.delete(dead)
    step(multi, "after upserts and deletes")

    # the timed window on the uniform layout with the streamed delta (as
    # phase 6's first window), the card shared: both hosts serve each
    # request
    dist.barrier()
    tracer.finished.clear()
    window = requests(centers, MH_WINDOW, BATCH, SIGMA, seed=19)
    t0 = time.perf_counter()
    got = [served(multi, u, "window") for u in window]
    wall = time.perf_counter() - t0
    ms = [m for _, m in got]
    spans = {}
    for name in ("host_topk", "collective_gather", "collective_merge",
                 "map", "delta", "merge"):
        d = [s.duration_s * 1e3 for tr in tracer.finished
             for s in tr.find(name)]
        spans[name] = {"n": len(d), "p50_ms": float(np.median(d)),
                       "p99_ms": float(np.percentile(d, 99))}
    fail_unless(spans["collective_gather"]["n"] == MH_WINDOW,
                f"host {rank}: {spans['collective_gather']['n']} gathers "
                f"traced in {MH_WINDOW} requests")
    for u, (res, _) in zip(window, got):
        same(res, u, "window")
    out["window"] = {"requests": MH_WINDOW, "wall_s": wall,
                     "qps": BATCH * MH_WINDOW / wall,
                     "p50_ms": float(np.percentile(ms, 50)),
                     "p99_ms": float(np.percentile(ms, 99)),
                     "spans": spans}
    single_ms = []

    def single_window():
        with checks:
            for u in window:
                t0 = time.perf_counter()
                single.query(u)
                torch.cuda.synchronize()
                single_ms.append((time.perf_counter() - t0) * 1e3)

    dist.barrier()
    if rank == 0:                   # the single-host baseline, card alone
        single_window()
        out["single_window"] = {"p50_ms": float(np.percentile(single_ms, 50)),
                                "p99_ms": float(np.percentile(single_ms, 99))}
        for u, (res, _) in zip(window[:MH_ORACLE], got[:MH_ORACLE]):
            with checks:
                check_oracle(torch, single, u, res,
                             "multi-host window vs the dense oracle")
    dist.barrier()

    multi.mark_down(1)
    step(multi, "host 1 marked down")
    out["failover"] = multi.host_status()
    fail_unless(out["failover"]["n_failovers"] >= 1
                and out["failover"]["routing"] == [0, 0],
                f"host {rank}: mark_down(1) did not re-route to host 0")
    multi.mark_up(1)
    multi.compact(async_=True)
    with checks:
        single.compact(async_=True)
    slices = 0
    while multi.maintenance_stats()["compaction"]["active"]:
        step(multi, f"compaction slice {slices}")
        slices += 1
        fail_unless(slices < 48, "the compaction never swapped")
    out["compaction_slices"] = slices
    part = multi.repartition(async_=False)
    with checks:
        fail_unless(single.repartition(async_=False) == part,
                    f"host {rank}: the repartitions differ")
    out["groups"] = len(part.groups)
    step(multi, "after repartition")
    step(multi, "after repartition, exact", exact=True)

    # snapshot from host 0, restored on both
    snap = ROOT / "build" / "chip_smoke_multihost.npz"
    t0 = time.perf_counter()
    if rank == 0:
        multi.snapshot(str(snap))
    dist.barrier()
    with checks:
        back = open_retriever(spec("sharded-multihost", n_hosts=MH_HOSTS,
                                   replication=MH_HOSTS),
                              snapshot=str(snap), device=dev)
        probe = next(stream)
        b = back.query(probe)
    a, _ = served(multi, probe, "snapshot probe")
    fail_unless(np.array_equal(a.ids, b.ids)
                and np.array_equal(a.scores, b.scores),
                f"host {rank}: the restored snapshot answers differently")
    out["snapshot_restore_s"] = time.perf_counter() - t0
    dist.barrier()
    if rank == 0:
        snap.unlink()

    # replication 1: each host holds only its half
    out["device_bytes_r2"] = multi.base.device_bytes()
    out["device_bytes_global"] = multi.base.global_index.device_bytes()
    ids, fac = single._catalog_arrays()
    del multi, back, a, b, got
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    m0 = torch.cuda.memory_allocated()
    multi1 = open_retriever(spec("sharded-multihost", n_hosts=MH_HOSTS,
                                 replication=1), items=fac, ids=ids,
                            device=dev)
    torch.cuda.synchronize()
    out["memory_r1"] = {"before": m0, "held": torch.cuda.memory_allocated()
                        - m0, "peak_during_build":
                        torch.cuda.max_memory_allocated() - m0}
    out["device_bytes_r1"] = multi1.base.device_bytes()
    fail_unless(not multi1.base.has_all_slices
                and sorted(multi1.base.slices) == [rank],
                f"host {rank} at replication 1 holds slices "
                f"{sorted(multi1.base.slices)}, not [{rank}]")
    # its share: the placement cuts the shards by rows, so a host's part
    # of the index is its slice's shards of the whole
    r1 = sum(out["device_bytes_r1"].values())
    whole = sum(out["device_bytes_global"].values())
    s_lo, s_hi = multi1.base.placement.slices[rank]
    out["share_r1"] = {"shards": s_hi - s_lo, "of": SVC_SHARDS,
                       "bytes_frac": r1 / whole}
    fail_unless(abs(r1 / whole - (s_hi - s_lo) / SVC_SHARDS) < 0.05
                and out["memory_r1"]["held"] < r1 + (64 << 20),
                f"host {rank} at replication 1 holds {r1} bytes of the "
                f"index ({out['memory_r1']['held']} allocated) against "
                f"{whole} for the whole, with {s_hi - s_lo} of "
                f"{SVC_SHARDS} shards")
    for i in range(3):
        step(multi1, f"replication 1, request {i}")
    path = {"gam_retrieve": gr.gam_retrieve.launches,
            "tess_project": tp.tess_project.launches}
    out["launches"] = path
    for name, n in path.items():
        fail_unless(n > 0, f"host {rank}: {name} never launched on the "
                    "multi-host path")
    for row in kernel_row:
        row["name"] = ("gam_retrieve@multihost_slice" if rank == 0 else
                       f"gam_retrieve@multihost_slice@host{rank}")
        row["launches"] = path["gam_retrieve"]
    out["kernel_row"] = kernel_row
    out["memory_allocated_end"] = torch.cuda.memory_allocated()
    print("MH9 " + json.dumps(out), flush=True)
    dist.destroy_process_group()
    return 0


def run_python(args: list, what: str, timeout: float):
    """Start ``python <args>`` from the checkout as the leader of a new
    process group (so a run past its deadline is killed with whatever it
    spawned).  Returns a function that waits for it and returns (stdout,
    seconds), failing unless it exits 0."""
    import os
    import signal
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    p = subprocess.Popen([sys.executable, *args], stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True, env=env,
                         cwd=ROOT, start_new_session=True)

    def wait():
        try:
            stdout, stderr = p.communicate(
                timeout=max(1.0, timeout - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            os.killpg(p.pid, signal.SIGKILL)
            p.communicate()
            raise SystemExit(f"chip_smoke: FAILED: {what}: ran past "
                             f"{timeout} s")
        seconds = time.perf_counter() - t0
        print(f"{what} (done within {seconds:.1f} s of its start, exit "
              f"{p.returncode}): python {' '.join(args)}")
        for line in stdout.splitlines():
            print(f"  | {line}")
        fail_unless(p.returncode == 0, f"{what}: exited {p.returncode}: "
                    f"{stderr[-3000:]}")
        return stdout, seconds

    return wait


def run_launcher(args: list, what: str) -> tuple[str, float]:
    """``python -m repro_torch.launch.serve <args>`` (``run_python``).
    Returns (stdout, seconds); fails unless it exits 0."""
    return run_python(["-m", "repro_torch.launch.serve", *args],
                      f"launcher {what}", MH_LAUNCHER_TIMEOUT)()


def launches_in(stdout: str, prefix: str) -> dict:
    """The ``{kernel: launches}`` dict a launcher printed after
    ``prefix`` (searched in the whole text: the lines of two hosts that
    share one stdout may run into each other)."""
    import ast
    import re
    found = re.search(re.escape(prefix) + r" *(\{[^{}]*\})", stdout)
    fail_unless(found is not None, f"no '{prefix}' in the launcher's "
                "output")
    return ast.literal_eval(found.group(1))


def phase_multihost(torch, report, bucket):
    """Phase 9: multi-host serving.  9a: two processes share the card in one
    gloo group (``launch.procs``) and run ``multihost_worker``; 9b: the
    serve launcher with ``--hosts 2``, single-host ``--service`` and the LM
    mode at ``--reduced``."""
    import re
    procs = importlib.import_module("repro_torch.launch.procs")
    mode = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    fail_unless("Exclusive" not in mode, f"the card's compute mode is "
                f"{mode!r}: a second process cannot open a context on it, "
                "so two hosts cannot share it")
    torch.cuda.empty_cache()
    # --- 9a
    coordinator = procs.free_coordinator()
    t0 = time.perf_counter()
    codes, outs = procs.run_workers(
        [[sys.executable, str(ROOT / "chip_smoke.py"), "--multihost-worker",
          str(h), coordinator, str(bucket)] for h in range(MH_HOSTS)],
        timeout=MH_DEADLINE, capture=True)
    seconds_a = time.perf_counter() - t0
    hosts = []
    for h, text in enumerate(outs):
        for line in text.splitlines():
            if line.startswith("MH9 "):
                hosts.append(json.loads(line[4:]))
            else:
                print(f"  [host {h}] {line}")
    fail_unless(codes == [0] * MH_HOSTS and len(hosts) == MH_HOSTS,
                f"multi-host workers exited {codes} (124: past the "
                f"{MH_DEADLINE} s deadline)")
    rows = []
    for o in hosts:
        w, sp = o["window"], o["window"]["spans"]
        k = o["kernel_row"][0]
        rows += o["kernel_row"]
        print(f"multihost host {o['host']} ({o['device']}, compute mode "
              f"{mode}): built in {o['build_s']:.1f} s; placement "
              f"{o['placement']}; gam_retrieve launches {o['launches']} "
              f"(per request {sorted(set(o['launches_per_request']))}, as "
              f"the routing says); failover {o['failover']['routing']} "
              f"({o['failover']['n_failovers']} failovers); compaction "
              f"{o['compaction_slices']} slices; repartition to "
              f"{o['groups']} groups; every answer = single-host sharded "
              "bit for bit")
        print(f"multihost host {o['host']}: window of {w['requests']} "
              f"requests of {BATCH} (both hosts serving), request p50 "
              f"{w['p50_ms']:.3f} ms p99 {w['p99_ms']:.3f} ms (host clock), "
              f"{w['qps']:.1f} queries/s; spans p50: host_topk "
              f"{sp['host_topk']['p50_ms']:.3f} ms, collective_gather "
              f"{sp['collective_gather']['p50_ms']:.3f} ms, "
              f"collective_merge {sp['collective_merge']['p50_ms']:.3f} ms"
              + (f"; single-host sharded alone p50 "
                 f"{o['single_window']['p50_ms']:.3f} ms p99 "
                 f"{o['single_window']['p99_ms']:.3f} ms"
                 if "single_window" in o else ""))
        print(f"multihost host {o['host']}: {k['name']} ({o['slice_rows']} "
              f"rows) {k['ms']:.4f} ms, plain {k['plain_ms']:.3f} ms, bound "
              f"{k['bound_ms']:.5f} ms ({k['bound_by']}), max abs err "
              f"{k['max_abs_err']}; replication 1: holds "
              f"{o['share_r1']['shards']} of {o['share_r1']['of']} shards, "
              f"{sum(o['device_bytes_r1'].values())} bytes of the index "
              f"(replication 2: {sum(o['device_bytes_r2'].values())}, the "
              f"global index {sum(o['device_bytes_global'].values())}), "
              f"memory_allocated +{o['memory_r1']['held']} (peak during the "
              f"build +{o['memory_r1']['peak_during_build']}); snapshot -> "
              f"restore on both {o['snapshot_restore_s']:.1f} s, "
              "bit-identical")
    # --- 9b: the launcher
    snap = ROOT / "chiprun_out" / "mh_snapshot.npz"
    snap.parent.mkdir(exist_ok=True)
    mh_args = ["--service", "--hosts", "2", "--replication", "2",
               "--fail-host", "1", "--items", str(N_ITEMS), "--dim", str(K),
               "--shards", str(SVC_SHARDS), "--requests", "64", "--verify",
               "--snapshot", "chiprun_out/mh_snapshot.npz", "--metrics-out",
               "chiprun_out/mh_metrics.prom"]
    text, s_mh = run_launcher(mh_args, "--hosts 2")
    fail_unless(re.search(r"verify: \d+ rounds bit-identical", text)
                is not None and re.search(r"\b0 WRONG\b", text) is not None,
                "--hosts 2: no verified rounds with '0 WRONG'")
    n_fail = re.search(r"failovers=(\d+)", text)
    fail_unless(n_fail is not None and int(n_fail.group(1)) >= 1
                and "down=[1]" in text, "--hosts 2: no failover of host 1")
    fail_unless("(probe bit-identical)" in text,
                "--hosts 2: no bit-identical snapshot probe")
    mh_launches = [launches_in(text, f"host {h} kernel launches:")
                   for h in range(MH_HOSTS)]
    for h, counts in enumerate(mh_launches):
        fail_unless(all(n > 0 for n in counts.values()),
                    f"--hosts 2: host {h} launched {counts}")
    fail_unless(snap.exists(), "--hosts 2 wrote no snapshot")
    snap.unlink()                   # too large to keep with the outputs
    sh_args = ["--service", "--items", str(N_ITEMS), "--dim", str(K),
               "--shards", str(SVC_SHARDS), "--requests", "64"]
    text, s_sh = run_launcher(sh_args, "--service")
    fail_unless("served 64/64 requests" in text, "--service did not serve "
                "every request")
    sh_launches = launches_in(text, "kernel launches:")
    fail_unless(all(n > 0 for n in sh_launches.values()),
                f"--service launched {sh_launches}")
    lm_args = ["--arch", "tinyllama-1.1b", "--reduced", "--batch", "2",
               "--prompt-len", "16", "--new-tokens", "8"]
    text, s_lm = run_launcher(lm_args, "LM --reduced")
    lm_launches = launches_in(text, "kernel launches:")
    fail_unless(lm_launches["decode_attention"] > 0,
                f"the LM mode launched {lm_launches}")
    report["multihost"] = {
        "compute_mode": mode, "workers_s": seconds_a, "hosts": hosts,
        "launcher": {"hosts_2": {"s": s_mh, "launches": mh_launches},
                     "service": {"s": s_sh, "launches": sh_launches},
                     "lm_reduced": {"s": s_lm, "launches": lm_launches}}}
    print(f"multihost: 9a {seconds_a:.1f} s; launcher --hosts 2 "
          f"{s_mh:.1f} s (0 WRONG, failover, snapshot probe bit-identical, "
          f"launches {mh_launches}), --service {s_sh:.1f} s ({sh_launches}),"
          f" LM --reduced {s_lm:.1f} s ({lm_launches})")
    return rows


# ---------------------------------------------- 10. the other LM families

FAM_BATCH, FAM_PROMPT, FAM_NEW = 8, 1024, 32
FAM_CALLS = 2                  # timed, after one warm-up
FAM_F32_BATCH = 2              # the f32 forward checks
DEEPSEEK_LAYERS = 4            # of 60: 60 layers need about 476 GB in bf16
DEEPSEEK_F32_LAYERS = 2        # its f32 forward check: 36 GB of weights
DEEPSEEK_DROPLESS = 27.0       # capacity >= T: int(27 T 6 / 160) >= T
OLMOE_DROPLESS = 8.0           # E / K
RG_BATCH, RG_PROMPT = 4, 2304  # past the 2,048 window: the ring wraps
SSD_SINGLE = 1000              # a prompt the SSD takes as one chunk
WHISPER_FRAMES, WHISPER_PROMPT = 1500, 4
VLM_PROMPT = 768               # behind 256 image tokens
# f32 logits of prefill + decode against the forward, for the attention,
# MLA, MoE and RG-LRU families: every matmul runs at another shape and the
# scan / recurrence sums in another order, a few 1e-6 at full depth and
# narrow width on the CPU (2.5e-6 olmoe, 2.4e-6 recurrentgemma); 1e-3 as
# phase 5's f32 tolerance
F32_FWD_TOL = 1e-3
# the same for mamba2: the chunked SSD's decay exp(cum_i - cum_j) is a
# difference of two f32 cumulative sums of up to q terms of about -0.8
# (q = 256, or 1,000 on the single-chunk branch), which the decode path's
# step-by-step recurrence does not share; at full depth and narrow width on
# the CPU the logits drift 6.1e-4 (1,024 + 256 steps against 5 chunks) and
# 2.0e-3 (the 1,000-token single chunk); 1e-2 leaves 5x
SSD_FWD_TOL = 1e-2


class RoutingLog:
    """Records each ``moe_ffn`` call's routing while a path runs: the call
    is wrapped, and ``moe.route`` on the same input (the function the call
    itself runs first) gives each token's experts and kept pairs, (B, S, K)
    each, sorted by expert.  A no-op for models without MoE."""

    def __init__(self, torch, enabled: bool):
        self.torch, self.enabled, self.calls = torch, enabled, []
        self.moe = importlib.import_module("repro_torch.models.moe")

    def __enter__(self):
        if self.enabled:
            orig = self.orig = self.moe.moe_ffn

            def logged(params, x, cfg):
                b, s, d = x.shape
                r = self.moe.route(params, x.reshape(b * s, d), cfg)
                keep = self.torch.empty_like(r.keep)
                keep[r.order] = r.keep
                order = self.torch.argsort(r.expert, dim=1)
                self.calls.append(tuple(
                    self.torch.gather(a, 1, order).reshape(b, s, -1)
                    .cpu().numpy() for a in (r.expert, keep.reshape(b * s,
                                                                    -1))))
                return orig(params, x, cfg)

            self.moe.moe_ffn = logged
        return self

    def __exit__(self, *exc):
        if self.enabled:
            self.moe.moe_ffn = self.orig

    def by_layer(self, n_layers: int) -> list:
        """Per layer (experts, kept) over the positions of all its calls."""
        return [tuple(np.concatenate([c[i] for c in self.calls[layer::
                                                               n_layers]],
                                     axis=1) for i in (0, 1))
                for layer in range(n_layers)]

    def dropped(self, n_layers: int, skip: int) -> np.ndarray:
        """Dropped pairs of each call after the first ``skip`` passes,
        summed over the layers of a pass: one number a decode step."""
        per_call = [int((~c[1]).sum()) for c in self.calls[skip * n_layers:]]
        return np.asarray(per_call).reshape(-1, n_layers).sum(axis=1)


def first_routing_diff(a: list, b: list) -> np.ndarray:
    """Per batch row, the first position whose experts or kept pairs differ
    at any layer between two logs (inf where none).  A row's computation
    depends only on its own routing, so its logits agree up to rounding
    before that position; past it they may not, with no kernel at fault: a
    near-tie of gates (or of two tokens' ranks within an expert's capacity)
    was broken the other way after rounding in another order."""
    n = min(a[0][0].shape[1], b[0][0].shape[1])
    diff = np.zeros(a[0][0].shape[:1] + (n,), bool)
    for (ea, ka), (eb, kb) in zip(a, b):
        diff |= ((ea[:, :n] != eb[:, :n]) | (ka[:, :n] != kb[:, :n])).any(-1)
    return np.where(diff.any(1), diff.argmax(1), np.inf)


def held_steps(first: np.ndarray, p0: int, steps: int) -> np.ndarray:
    """(B, steps): step t's logits (position p0 - 1 + t) precede the row's
    first routing difference."""
    return (p0 - 1 + np.arange(steps))[None, :] < first[:, None]


def family_batch(torch, cfg, b, prompt, seed):
    """Prompt tokens and the family's extras (whisper's frames, the VLM's
    image embeddings), f32 from a numpy rng, on the card."""
    dev = torch.device("cuda")
    r = np.random.default_rng(seed)
    batch = {"tokens": torch.as_tensor(r.integers(0, cfg.vocab, (b, prompt)),
                                       device=dev)}
    if cfg.family == "encdec":
        batch["frames"] = torch.as_tensor(r.normal(size=(
            b, WHISPER_FRAMES, cfg.d_frontend)).astype(np.float32),
            device=dev)
    if cfg.family == "vlm":
        batch["image_embeds"] = torch.as_tensor(r.normal(size=(
            b, cfg.n_image_tokens, cfg.d_frontend)).astype(np.float32),
            device=dev)
    return batch


def kernel_layers(cfg) -> int:
    """Layers whose decode takes the kernel branch (GQA, no ring, no
    window), as ``models/attention.attention_decode`` decides."""
    takes = (cfg.use_decode_kernel and not cfg.use_mla
             and cfg.family not in ("ssm", "hybrid")
             and cfg.attn_kind != "sliding")
    return cfg.n_layers if takes else 0


def serve_family(torch, name, cfg, batch, capacity):
    """The main path of one family: Engine.generate, one warm-up and
    FAM_CALLS timed calls, launches counted from 0 around them."""
    da = importlib.import_module("repro_torch.kernels.decode_attention")
    from repro_torch.models import Model
    from repro_torch.serving import Engine, ServeConfig
    base = torch.cuda.memory_allocated()       # what earlier phases hold
    t0 = time.perf_counter()
    model = Model(cfg)
    params = model.init(0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in leaves(params))
    eng = Engine(cfg, params, ServeConfig(max_new_tokens=FAM_NEW),
                 capacity=capacity)
    b = batch["tokens"].shape[0]
    per_call = kernel_layers(cfg) * (FAM_NEW - 1)
    da.decode_attention.launches = 0
    torch.cuda.reset_peak_memory_stats()
    results, walls = [], []
    for _ in range(1 + FAM_CALLS):
        before = da.decode_attention.launches
        t0 = time.perf_counter()
        res = eng.generate(batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        fail_unless(da.decode_attention.launches - before == per_call,
                    f"{name}: decode_attention launched "
                    f"{da.decode_attention.launches - before} times in a "
                    f"call, not {per_call}")
        fail_unless(res.tokens.shape == (b, FAM_NEW)
                    and ((res.tokens >= 0) & (res.tokens < cfg.vocab)).all(),
                    f"{name}: generated tokens of the wrong shape or range")
        results.append(res)
    launches = da.decode_attention.launches
    steps = np.concatenate([r.step_ms for r in results[1:]])
    stats = {"arch": cfg.arch_id, "n_layers": cfg.n_layers,
             "params": n_params, "dtype": cfg.dtype, "batch": b,
             "prompt": int(batch["tokens"].shape[1]),
             "prefix": model.n_prefix(), "new_tokens": FAM_NEW,
             "capacity": capacity, "init_s": init_s,
             "prefill_ms": [r.prefill_ms for r in results[1:]],
             "decode_step_p50_ms": float(np.percentile(steps, 50)),
             "decode_step_p99_ms": float(np.percentile(steps, 99)),
             "tokens_per_s": [b * FAM_NEW / w for w in walls[1:]],
             # the model's own peak: weights, cache and activations
             "peak_device_memory_gb": (torch.cuda.max_memory_allocated()
                                       - base) / 1e9,
             "held_before_gb": base / 1e9,
             "deterministic": all(np.array_equal(r.tokens, results[0].tokens)
                                  for r in results),
             "launches": {"decode_attention": launches}}
    return model, params, results[-1], stats


def kernel_vs_einsum(torch, name, model, params, batch, res, capacity):
    """Teacher-forced on the kernel path's tokens, the einsum path's bf16
    logits within LM_BF16_ULPS bf16 steps of the largest logit (phase 5's
    tolerance); with MoE, on each row's steps before its first routing
    difference (counted).  Returns the report and the kernel path's log."""
    from repro_torch.models import Model
    cfg = model.cfg
    tokens = torch.as_tensor(res.tokens, device="cuda").long()
    moe = cfg.family == "moe"
    with RoutingLog(torch, moe) as klog:
        lk = teacher_forced(torch, model, params, batch, tokens, capacity)
    with RoutingLog(torch, moe) as plog:
        lp = teacher_forced(torch, Model(cfg.with_(use_decode_kernel=False)),
                            params, batch, tokens, capacity)
    lk, lp = lk[..., :cfg.vocab], lp[..., :cfg.vocab]
    fail_unless(bool(torch.isfinite(lk).all() and torch.isfinite(lp).all()),
                f"{name}: non-finite logits")
    fail_unless(torch.equal(first_argmax(torch, lk), tokens),
                f"{name}: teacher-forced kernel-path logits do not reproduce "
                "the tokens Engine.generate picked")
    diff = (lk - lp).abs().amax(dim=-1).cpu().numpy()          # (B, T)
    held = np.ones(diff.shape, bool)
    if moe:
        p0 = model.n_prefix() + int(batch["tokens"].shape[1])
        held = held_steps(first_routing_diff(klog.by_layer(cfg.n_layers),
                                             plog.by_layer(cfg.n_layers)),
                          p0, diff.shape[1])
    tol = LM_BF16_ULPS * bf16_ulp(float(lp.abs().max()))
    worst = float(diff[held].max())
    fail_unless(worst <= tol, f"{name}: bf16 logits of the kernel path differ "
                f"from the einsum path by {worst} > {tol}")
    out = {"max_abs_diff": worst, "tolerance": tol,
           "max_abs_logit": float(lp.abs().max()),
           "steps": int(diff.size), "steps_held": int(held.sum()),
           "max_abs_diff_past_routing_difference":
               float(diff[~held].max()) if (~held).any() else None,
           "greedy_agree": float((first_argmax(torch, lp) == tokens)
                                 .float().mean())}
    print(f"{name}: bf16 logits, kernel vs einsum path (teacher-forced): max "
          f"abs diff {worst:.4g} (tolerance {tol:.4g}) on {out['steps_held']}"
          f" of {out['steps']} steps" + (
              f" (the rest follow a routing difference; there the max is "
              f"{out['max_abs_diff_past_routing_difference']:.4g})"
              if (~held).any() else "")
          + f", greedy picks agree on {out['greedy_agree']:.4f}")
    return out, klog


def forward_check(torch, name, cfg, prompt, steps, tol, seed):
    """f32, fresh weights: prefill of ``prompt`` tokens and ``steps`` - 1
    teacher-forced decode steps against the forward over ``prompt + steps``
    tokens, logits within ``tol``; with MoE, on each row's steps before its
    first routing difference (counted).  Batch FAM_F32_BATCH."""
    from repro_torch.models import Model
    model = Model(cfg)
    params = model.init(seed)
    r = np.random.default_rng(seed)
    toks = torch.as_tensor(r.integers(0, cfg.vocab, (FAM_F32_BATCH,
                                                     prompt + steps)),
                           device="cuda")
    moe = cfg.family == "moe"
    with RoutingLog(torch, moe) as flog:
        full = model.forward(params, {"tokens": toks})[0][
            :, prompt - 1:prompt - 1 + steps, :cfg.vocab]
    with RoutingLog(torch, moe) as dlog:
        tf = teacher_forced(torch, model, params,
                            {"tokens": toks[:, :prompt]}, toks[:, prompt:],
                            prompt + steps + 8)[..., :cfg.vocab]
    diff = (tf - full).abs().amax(dim=-1).cpu().numpy()       # (B, steps)
    held = np.ones(diff.shape, bool)
    if moe:
        held = held_steps(first_routing_diff(flog.by_layer(cfg.n_layers),
                                             dlog.by_layer(cfg.n_layers)),
                          prompt, steps)
    worst = float(diff[held].max())
    fail_unless(bool(torch.isfinite(tf).all()) and worst <= tol,
                f"{name}: f32 prefill + decode differ from the forward by "
                f"{worst} > {tol}")
    out = {"layers": cfg.n_layers, "batch": FAM_F32_BATCH, "prompt": prompt,
           "steps": steps, "max_abs_diff": worst, "tolerance": tol,
           "max_abs_logit": float(full.abs().max()),
           "steps_held": int(held.sum()), "steps_total": int(held.size)}
    print(f"{name}: f32 prefill {prompt} + {steps - 1} decode steps vs "
          f"forward over {prompt + steps} ({cfg.n_layers} layers, batch "
          f"{FAM_F32_BATCH}, capacity factor {cfg.capacity_factor}): max abs "
          f"diff {worst:.3g} (tolerance {tol:.3g}, max |logit| "
          f"{out['max_abs_logit']:.3g}) on {out['steps_held']} of "
          f"{out['steps_total']} steps")
    del model, params, full, tf
    torch.cuda.empty_cache()
    return out


def family_kernel_row(torch, name, model, params, batch, capacity,
                      launches):
    """decode_attention at this family's serving layout, on layer 0's live
    cache (K/V past the prompt made random), held against its plain version
    and timed beside it, SDPA and the bound (``decode_row``)."""
    cfg = model.cfg
    dev = torch.device("cuda")
    _, cache = model.prefill(params, batch, capacity)
    p0 = int(cache["len"])
    b = batch["tokens"].shape[0]
    kc, vc = cache["k"][0], cache["v"][0]
    kc[:, p0:] = torch.randn_like(kc[:, p0:])
    vc[:, p0:] = torch.randn_like(vc[:, p0:])
    q = torch.randn((b, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads,
                     cfg.hd), generator=torch.Generator(dev).manual_seed(1),
                    device=dev).to(torch.bfloat16)
    length = torch.tensor(p0 + FAM_NEW - 2, dtype=torch.int32, device=dev)
    row, eager = decode_row(torch, f"decode_attention@{name}", q, kc, vc,
                            length, launches, 50, graphed=True)
    del cache, kc, vc
    return row, eager


def print_family(name, st, extra=""):
    print(f"{name}: {st['arch']} ({st['n_layers']} layers, {st['params']} "
          f"params, {st['dtype']}), batch {st['batch']}, prompt "
          f"{st['prompt']}"
          + (f" + {st['prefix']} image tokens" if st["prefix"] else "")
          + f", {FAM_NEW} new tokens, capacity {st['capacity']}: prefill "
          f"{np.median(st['prefill_ms']):.2f} ms, decode step p50 "
          f"{st['decode_step_p50_ms']:.3f} ms p99 "
          f"{st['decode_step_p99_ms']:.3f} ms, "
          f"{np.median(st['tokens_per_s']):.1f} tokens/s, peak device "
          f"memory {st['peak_device_memory_gb']:.2f} GB (above the "
          f"{st['held_before_gb']:.2f} GB held before), decode_attention "
          f"launches {st['launches']['decode_attention']}{extra}")


def phase_families(torch, report):
    """Phase 10: the MoE, MLA, SSM, RG-LRU hybrid, encoder-decoder and VLM
    families at their published widths, each through Engine.generate."""
    from repro_torch.configs import get_config
    fams: dict = {}
    rows = []

    def done(key):
        torch.cuda.empty_cache()
        fams[key]["seconds"] = time.perf_counter() - t_fam

    def with_kernel(key, name, model, params, batch, res, st, capacity):
        """The kernel path's checks and its row; returns the share."""
        fams[key]["bf16_vs_einsum"], log = kernel_vs_einsum(
            torch, name, model, params, batch, res, capacity)
        row, eager = family_kernel_row(
            torch, name, model, params, batch, capacity,
            st["launches"]["decode_attention"])
        rows.append(row)
        share = model.cfg.n_layers * row["ms"] / st["decode_step_p50_ms"]
        share_eager = model.cfg.n_layers * eager / st["decode_step_p50_ms"]
        st["decode_attention_share_of_step"] = share
        st["decode_attention_eager_share_of_step"] = share_eager
        return log, (f", decode_attention {share:.1%} of a step in device "
                     f"time ({share_eager:.1%} as eager calls)")

    # --- 10a olmoe-1b-7b, all 16 layers
    t_fam = time.perf_counter()
    cfg = get_config("olmoe-1b-7b").with_(use_decode_kernel=True)
    batch = family_batch(torch, cfg, FAM_BATCH, FAM_PROMPT, 10)
    cap = FAM_PROMPT + FAM_NEW + 8
    model, params, res, st = serve_family(torch, "10a", cfg, batch, cap)
    fams["olmoe"] = st
    log, extra = with_kernel("olmoe", "olmoe-1b-7b", model, params, batch,
                             res, st, cap)
    drops = log.dropped(cfg.n_layers, skip=1)
    st["decode_capacity"] = int(max(1, cfg.capacity_factor * FAM_BATCH
                                    * cfg.moe_top_k / cfg.n_experts))
    st["dropped_pairs_per_decode_step"] = drops.tolist()
    print_family("10a", st, extra + f"; decode capacity "
                 f"{st['decode_capacity']} per expert: dropped pairs a decode "
                 f"step (all layers) mean {drops.mean():.1f} of "
                 f"{cfg.n_layers * FAM_BATCH * cfg.moe_top_k}")
    del model, params
    torch.cuda.empty_cache()
    st["f32_forward"] = forward_check(
        torch, "10a", cfg.with_(dtype="float32",
                                capacity_factor=OLMOE_DROPLESS),
        FAM_PROMPT, 8, F32_FWD_TOL, 11)
    done("olmoe")

    # --- 10b deepseek-v2-236b, depth cut to DEEPSEEK_LAYERS
    t_fam = time.perf_counter()
    full_cfg = get_config("deepseek-v2-236b")
    cfg = full_cfg.with_(n_layers=DEEPSEEK_LAYERS, use_decode_kernel=True)
    batch = family_batch(torch, cfg, FAM_BATCH, FAM_PROMPT, 12)
    model, params, res, st = serve_family(torch, "10b", cfg, batch, cap)
    fams["deepseek"] = st
    with RoutingLog(torch, True) as log:
        teacher_forced(torch, model, params, batch,
                       torch.as_tensor(res.tokens, device="cuda").long(),
                       cap)
    drops = log.dropped(cfg.n_layers, skip=1)
    _, cache = model.prefill(params, batch, cap)
    latent = sum(cache[k].numel() * cache[k].element_size()
                 for k in ("c_kv", "k_rope"))
    per_head = (cfg.n_layers * FAM_BATCH * cap * cfg.n_heads
                * (cfg.qk_nope_dim + cfg.qk_rope_dim + cfg.v_head_dim) * 2)
    st.update(latent_cache_bytes=latent, per_head_kv_bytes=per_head,
              dropped_pairs_per_decode_step=drops.tolist(),
              full_depth_param_gb=full_cfg.param_count() * 2 / 1e9)
    print_family("10b", st, f"; latent cache {latent} bytes against "
                 f"{per_head} for a per-head K/V cache "
                 f"({per_head / latent:.1f}x); dropped pairs a decode step "
                 f"(all layers) mean {drops.mean():.1f} of "
                 f"{cfg.n_layers * FAM_BATCH * cfg.moe_top_k}")
    del model, params, cache
    torch.cuda.empty_cache()
    st["f32_forward"] = forward_check(
        torch, "10b", cfg.with_(dtype="float32", n_layers=DEEPSEEK_F32_LAYERS,
                                capacity_factor=DEEPSEEK_DROPLESS),
        FAM_PROMPT, 8, F32_FWD_TOL, 13)
    done("deepseek")

    # --- 10c mamba2-780m, all 48 layers
    t_fam = time.perf_counter()
    cfg = get_config("mamba2-780m").with_(use_decode_kernel=True)
    batch = family_batch(torch, cfg, FAM_BATCH, FAM_PROMPT, 14)
    model, params, res, st = serve_family(torch, "10c", cfg, batch, cap)
    fams["mamba2"] = st
    print_family("10c", st)
    del model, params
    torch.cuda.empty_cache()
    cfg32 = cfg.with_(dtype="float32")
    # 4 chunks in the prefill, 5 in the forward; then the single-chunk
    # branch: a prefill of 1,000 against a forward of 4 chunks
    st["f32_forward"] = [
        forward_check(torch, "10c", cfg32, FAM_PROMPT, cfg.ssm_chunk,
                      SSD_FWD_TOL, 15),
        forward_check(torch, "10c", cfg32, SSD_SINGLE,
                      FAM_PROMPT - SSD_SINGLE, SSD_FWD_TOL, 16)]
    done("mamba2")

    # --- 10d recurrentgemma-9b, all 38 layers (12 groups + 2 tail)
    t_fam = time.perf_counter()
    cfg = get_config("recurrentgemma-9b").with_(use_decode_kernel=True)
    batch = family_batch(torch, cfg, RG_BATCH, RG_PROMPT, 17)
    rg_cap = RG_PROMPT + FAM_NEW + 8
    model, params, res, st = serve_family(torch, "10d", cfg, batch, rg_cap)
    fams["recurrentgemma"] = st
    print_family("10d", st, f"; attention ring of "
                 f"{min(rg_cap, cfg.local_window)} slots")
    del model, params
    torch.cuda.empty_cache()
    st["f32_forward"] = forward_check(torch, "10d",
                                      cfg.with_(dtype="float32"), RG_PROMPT,
                                      8, F32_FWD_TOL, 18)
    done("recurrentgemma")

    # --- 10e whisper-tiny
    t_fam = time.perf_counter()
    cfg = get_config("whisper-tiny").with_(use_decode_kernel=True)
    batch = family_batch(torch, cfg, FAM_BATCH, WHISPER_PROMPT, 19)
    w_cap = WHISPER_PROMPT + FAM_NEW + 8
    model, params, res, st = serve_family(torch, "10e", cfg, batch, w_cap)
    fams["whisper"] = st
    _, extra = with_kernel("whisper", "whisper-tiny", model, params, batch,
                           res, st, w_cap)
    print_family("10e", st, extra + f"; encoder frames {WHISPER_FRAMES}")
    del model, params
    done("whisper")

    # --- 10f internvl2-26b, whole
    t_fam = time.perf_counter()
    cfg = get_config("internvl2-26b").with_(use_decode_kernel=True)
    batch = family_batch(torch, cfg, FAM_BATCH, VLM_PROMPT, 20)
    v_cap = cfg.n_image_tokens + VLM_PROMPT + FAM_NEW + 8
    model, params, res, st = serve_family(torch, "10f", cfg, batch, v_cap)
    fams["internvl2"] = st
    _, extra = with_kernel("internvl2", "internvl2-26b", model, params,
                           batch, res, st, v_cap)
    print_family("10f", st, extra)
    del model, params
    done("internvl2")

    report["families"] = fams
    print("families: seconds " + ", ".join(
        f"{k} {v['seconds']:.1f}" for k, v in fams.items()))
    return rows


# ---------------------------------------------------- 11. LM training

# (batch, seq), largest first; 8 x 1,024 is PR 23's and 25's size
TRAIN_SIZES = ((16, 1024), (8, 1024), (4, 1024), (8, 512))
# each remat mode a few steps at 8 x 1,024 beside the published "full"
REMAT_MODES, REMAT_SIZE, REMAT_STEPS = ("full", "dots", "none"), (8, 1024), 4
TRAIN_STEPS, TRAIN_LR, TRAIN_WARMUP = 20, 1e-3, 4
TRAIN_EVAL = 4                     # held-out batches, pipeline seed 10,000
TRAIN_PROMPT, TRAIN_NEW = 64, 8    # serving from the restored checkpoint
TRAIN_GAM_STEPS = 8                # GAM serve steps beside the exact head
TRAIN_GAM = dict(coarse_k=128, budget=16_384)   # make_gam_serve_step's
PARITY_LM = dict(n_layers=2, d_model=256, n_heads=4, n_kv_heads=1,
                 head_dim=64, d_ff=704, dtype="float32")
PARITY_BATCH, PARITY_SEQ = 4, 128
# card against CPU at f32: the loss within 1e-5 relative; each gradient
# leaf within 1e-4 x the CPU leaf's largest |g| (cuBLAS and the CPU's BLAS
# sum in other orders; the reference against the port on the CPU stays
# within 3.5e-6 x, tests/test_torch_training.py); after a step, params
# within 1e-5 except where AdamW's denominator is eps-dominated
PARITY_LOSS_TOL, PARITY_GRAD_TOL, PARITY_PARAM_TOL = 1e-5, 1e-4, 1e-5
EPS_DOMINATED = 100.0              # sqrt(v_hat) below this many AdamW eps
OLMOE_TRAIN_LAYERS, OLMOE_TRAIN_STEPS = 2, 3
OLMOE_TRAIN_BATCH, OLMOE_TRAIN_SEQ = 8, 512
FAMILY_TRAIN = ("mamba2-780m", "recurrentgemma-9b", "whisper-tiny",
                "internvl2-26b")
ENTRY_TIMEOUT = 300                # s: each 11d subprocess


def flat_paths(tree, prefix="") -> dict:
    """path -> tensor of a nested parameter dict."""
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items()
                for p, v in flat_paths(sub, f"{prefix}/{k}").items()}
    return {prefix: tree}


def grads_of(torch, model, params, batch):
    """(loss, metrics, {path: grad}) of ``Model.loss`` on ``batch``."""
    live = tree_map(lambda t: t.detach().requires_grad_(True), params)
    flat = flat_paths(live)
    loss, met = model.loss(live, batch)
    grads = torch.autograd.grad(loss, list(flat.values()))
    return (loss.detach(), {k: v.detach() for k, v in met.items()},
            dict(zip(flat, grads)))


def all_finite(torch, grads: dict) -> bool:
    return all(bool(torch.isfinite(g).all()) for g in grads.values())


def tensor_bits_equal(torch, a, b) -> bool:
    """Same dtype, shape and bits (bf16 and f32 viewed as integers)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    if a.is_floating_point():
        a, b = a.view(ints[a.element_size()]), b.view(ints[b.element_size()])
    return torch.equal(a, b)


def profile_step(torch, fn) -> tuple:
    """One call of ``fn`` under torch.profiler -> (its result, stats):
    device activities (kernel launches and copies), device busy time and
    the host wall, and the top device kernels; ``None`` values where the
    profiler saw no device time (not measured)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy_ms = sum(getattr(e, "self_device_time_total", 0.0)
                  for e in events) / 1e3
    top = sorted(events, key=lambda e: -getattr(e, "self_device_time_total",
                                                0.0))[:6]
    if busy_ms == 0:
        return out, {"device_activities": None, "busy_ms": None,
                     "wall_ms": wall_ms, "busy_share": None, "top": []}
    return out, {"device_activities": sum(e.count for e in events),
                 "busy_ms": busy_ms, "wall_ms": wall_ms,
                 "busy_share": busy_ms / wall_ms,
                 "top": [(e.key[:60], getattr(e, "self_device_time_total",
                                              0.0) / 1e3, e.count)
                         for e in top]}


def train_size(torch, model, step_fn, cfg):
    """The largest (batch, seq) of TRAIN_SIZES whose train step fits the
    card (one step from a fresh init each; an out-of-memory step moves to
    the next size)."""
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.train import build_batch
    from repro_torch.training import adamw_init
    for b, s in TRAIN_SIZES:
        params = model.init(0)
        opt = adamw_init(params)
        batch = build_batch(cfg, TokenPipeline(
            vocab=cfg.vocab, seq_len=s, batch=b, seed=0).batch_at(0),
            np.random.default_rng(0))
        try:
            step_fn(params, opt, batch)
            torch.cuda.synchronize()
            return b, s
        except torch.cuda.OutOfMemoryError:
            print(f"11a: batch {b} x seq {s} does not fit the card")
        finally:
            del params, opt, batch
            torch.cuda.empty_cache()
    raise SystemExit("chip_smoke: FAILED: 11a: no training size fits")


def gam_vs_exact(torch, model, params, prompts, capacity, what):
    """``make_gam_serve_step`` beside ``make_serve_step``, teacher-forced on
    the exact head's picks for TRAIN_GAM_STEPS steps from one cache.  Every
    GAM pick must be the exact argmax (f64) over the step's own candidate
    set (recomputed with the step's f32 coarse stage), but where the two
    best f64 logits there lie within the f32 dot product's rounding bound
    (counted).  Returns the agreement with the exact head and the counts."""
    from repro_torch.launch import steps as steps_mod
    cfg = model.cfg
    patterns = unembed_patterns(torch, model, params)            # (d, V)
    nnz = patterns.float().abs().sum(dim=0)
    gam = {"patterns": patterns,
           "inv_sqrt_nnz": 1.0 / torch.sqrt(torch.clamp(nnz, min=1.0))}
    coarse_k, budget = TRAIN_GAM["coarse_k"], TRAIN_GAM["budget"]
    serve = steps_mod.make_serve_step(model)
    gam_step = steps_mod.make_gam_serve_step(model, **TRAIN_GAM)
    embed = (params["embed"] if cfg.tie_embeddings
             else params["lm_head"].T)
    logits, cache = model.prefill(params, {"tokens": prompts}, capacity)
    tok = torch.argmax(logits, dim=-1).int()
    same = ties = agree = n = 0
    gam_ms, exact_ms = [], []
    for _ in range(TRAIN_GAM_STEPS):
        clone = {k: v.clone() for k, v in cache.items()}
        hidden, _ = model.decode_step(
            params, {k: v.clone() for k, v in cache.items()}, tok,
            return_hidden=True)
        e = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        e[0].record()
        picked, _ = gam_step(params, gam, clone, tok)
        e[1].record()
        e[2].record()
        nxt, cache = serve(params, cache, tok)
        e[3].record()
        torch.cuda.synchronize()
        gam_ms.append(e[0].elapsed_time(e[1]))
        exact_ms.append(e[2].elapsed_time(e[3]))
        # the step's candidate set, by its own f32 coarse stage
        h = hidden[:, 0].float()
        cols = steps_mod._top_k(h.abs(), coarse_k)
        coarse = torch.einsum("bk,bkv->bv", torch.gather(h, 1, cols),
                              gam["patterns"][cols].float())
        cand = steps_mod._top_k(coarse * gam["inv_sqrt_nnz"][None, :],
                                budget)
        rows = embed[cand].double()                              # (B, C, d)
        exact = torch.einsum("bd,bcd->bc", h.double(), rows)
        best = torch.gather(cand, 1, exact.argmax(dim=1, keepdim=True))
        top2 = torch.topk(exact, 2, dim=1).values
        bound = cfg.d_model * 2.0 ** -24 * torch.einsum(
            "bd,bcd->bc", h.double().abs(), rows.abs()).amax(dim=1)
        tie = (top2[:, 0] - top2[:, 1]) <= 2 * bound
        ok = picked[:, 0].long() == best[:, 0]
        fail_unless(bool((ok | tie).all()),
                    f"{what}: a GAM pick is not the exact argmax over its "
                    "candidate set on a step that is not a near-tie")
        same += int(ok.sum())
        ties += int((~ok & tie).sum())
        agree += int((picked == nxt).sum())
        n += picked.numel()
        tok = nxt
    return {"agree_with_exact": agree / n, "picks": n,
            "equal_to_recomputation": same, "near_ties_off": ties,
            "coarse_k": coarse_k, "budget": budget,
            "gam_step_ms_p50": float(np.median(gam_ms)),
            "exact_step_ms_p50": float(np.median(exact_ms))}


def train_tinyllama(torch, st):
    """11a: tinyllama-1.1b at its published widths in bf16 trains, its
    checkpoint round-trips bit for bit, and the restored weights serve
    through decode_attention.  Returns the kernels-line row."""
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.train import build_batch
    from repro_torch.models import Model
    from repro_torch.serving import Engine, ServeConfig
    from repro_torch.training import AdamWConfig, adamw_init, eval_batches
    da = importlib.import_module("repro_torch.kernels.decode_attention")
    dev = torch.device("cuda")
    cfg = get_config(LM_ARCH)
    fail_unless(all(getattr(cfg, k) == v for k, v in LM_SHAPE.items())
                and cfg.dtype == "bfloat16" and cfg.vocab_padded == 32256,
                f"{LM_ARCH} config is not the published one")
    model = Model(cfg)
    opt_cfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                          total_steps=TRAIN_STEPS)
    step_fn = steps_mod.make_train_step(model, opt_cfg)
    b, s = train_size(torch, model, step_fn, cfg)
    print(f"11a: {LM_ARCH} trains at batch {b} x seq {s} (the largest of "
          f"{', '.join(f'{x} x {y}' for x, y in TRAIN_SIZES)} that fits)")

    params = model.init(0)
    n_params = sum(t.numel() for t in leaves(params))
    opt = adamw_init(params)
    rng = np.random.default_rng(0)
    held_out = [build_batch(cfg, t, rng) for t, _ in zip(TokenPipeline(
        vocab=cfg.vocab, seq_len=s, batch=b, seed=10_000), range(TRAIN_EVAL))]
    before = eval_batches(model, params, held_out)

    # the AdamW update's share: events around it inside the step
    upd = []
    orig_update = steps_mod.adamw_update

    def timed_update(*a, **kw):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = orig_update(*a, **kw)
        ev[1].record()
        upd.append(ev)
        return out

    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=s, batch=b, seed=0)
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    steps_mod.adamw_update = timed_update
    try:
        for i, tokens in zip(range(TRAIN_STEPS), pipe):
            batch = build_batch(cfg, tokens, rng)
            if i == TRAIN_STEPS - 1:        # the last step under the profiler
                (params, opt, met), prof = profile_step(
                    torch, lambda: step_fn(params, opt, batch))
                losses.append(float(met["loss"]))
                continue
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            params, opt, met = step_fn(params, opt, batch)
            ev[1].record()
            losses.append(float(met["loss"]))
            step_ms.append(ev[0].elapsed_time(ev[1]))
    finally:
        steps_mod.adamw_update = orig_update
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    upd_ms = [e[0].elapsed_time(e[1]) for e in upd[:len(step_ms)]]
    fail_unless(all(np.isfinite(losses)), f"11a: a loss is not finite: "
                f"{losses}")
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    fail_unless(last < first, f"11a: the mean of the last 5 losses {last} "
                f"is not below the first 5's {first}")
    after = eval_batches(model, params, held_out)
    fail_unless(after["nll"] < before["nll"], f"11a: held-out nll "
                f"{after['nll']} did not fall from {before['nll']}")
    p50, p99 = (float(np.percentile(step_ms, p)) for p in (50, 99))
    upd50 = float(np.percentile(upd_ms, 50))
    smi = card_name_and_limit()
    st.update({
        "arch": LM_ARCH, "params": n_params, "dtype": cfg.dtype,
        "batch": b, "seq": s, "steps": TRAIN_STEPS, "lr": TRAIN_LR,
        "warmup": TRAIN_WARMUP, "losses": losses,
        "loss_first5_mean": first, "loss_last5_mean": last,
        "eval_before": dict(before), "eval_after": dict(after),
        "step_ms": step_ms, "step_ms_p50": p50, "step_ms_p99": p99,
        "adamw_ms": upd_ms, "adamw_ms_p50": upd50,
        "fwd_bwd_ms_p50": float(np.percentile(
            np.subtract(step_ms, upd_ms), 50)),
        "tokens_per_s": b * s / (p50 / 1e3), "peak_device_memory_gb": peak_gb,
        "profile": prof, "nvidia_smi": smi})
    print(f"11a: {LM_ARCH} ({n_params} params, bf16), batch {b} x seq {s}, "
          f"{TRAIN_STEPS} steps (lr {TRAIN_LR}, warmup {TRAIN_WARMUP}): loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f} (mean of first 5 "
          f"{first:.4f}, last 5 {last:.4f}); held-out nll "
          f"{before['nll']:.4f} -> {after['nll']:.4f} over "
          f"{after['n_tokens']} tokens")
    print(f"11a: step p50 {p50:.2f} ms p99 {p99:.2f} ms (CUDA events around "
          f"each of the first {len(step_ms)} steps): forward + backward p50 "
          f"{st['fwd_bwd_ms_p50']:.2f} ms, AdamW update p50 {upd50:.2f} ms; "
          f"{st['tokens_per_s']:.0f} tokens/s; peak device memory "
          f"{peak_gb:.2f} GB; card {smi}")
    if prof["busy_ms"] is None:
        print("11a: the last step under the profiler: it saw no device time "
              "(launches and busy share not measured)")
    else:
        print(f"11a: the last step under the profiler: "
              f"{prof['device_activities']} device activities (kernel "
              f"launches and copies), device busy {prof['busy_ms']:.2f} of "
              f"{prof['wall_ms']:.2f} ms ({prof['busy_share']:.1%}); top: "
              + "; ".join(f"{k} {ms:.2f} ms x {c}"
                          for k, ms, c in prof["top"]), flush=True)

    # --- checkpoint round trip: params (bf16) and AdamW state (f32, int32)
    path = ROOT / "build" / "phase11_checkpoint.npz"
    t0 = time.perf_counter()
    save_checkpoint(str(path), {"params": params, "opt": opt},
                    step=TRAIN_STEPS)
    save_s = time.perf_counter() - t0
    ckpt_gb = path.stat().st_size / 1e9
    like = {"params": Model(cfg).init(1), "opt": adamw_init(params)}
    t0 = time.perf_counter()
    restored, step = restore_checkpoint(str(path), like)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    path.unlink()
    del like
    fail_unless(step == TRAIN_STEPS, f"11a: restored step {step}")
    live, back = flat_paths({"params": params, "opt": opt._asdict()}), \
        flat_paths({"params": restored["params"],
                    "opt": restored["opt"]._asdict()})
    fail_unless(live.keys() == back.keys() and all(
        tensor_bits_equal(torch, live[k], back[k]) for k in live),
        "11a: a restored leaf differs from the saved one")
    dtypes = sorted({str(t.dtype).removeprefix("torch.")
                     for t in live.values()})
    rparams = restored["params"]
    del opt, restored, live, back
    torch.cuda.empty_cache()
    re_eval = eval_batches(model, rparams, held_out)
    fail_unless(re_eval == after, f"11a: eval of the restored params "
                f"{re_eval} differs from the live params' {after}")
    st.update({"checkpoint_gb": ckpt_gb, "save_s": save_s,
               "restore_s": restore_s, "checkpoint_dtypes": dtypes})
    print(f"11a: checkpoint ({', '.join(dtypes)}) {ckpt_gb:.2f} GB: save "
          f"{save_s:.1f} s, restore {restore_s:.1f} s, every leaf bit for "
          f"bit, restored eval equal", flush=True)

    # --- serve from the restored checkpoint through decode_attention
    kcfg = cfg.with_(use_decode_kernel=True)
    kmodel = Model(kcfg)
    prompts = torch.as_tensor(TokenPipeline(
        vocab=cfg.vocab, seq_len=TRAIN_PROMPT, batch=8,
        seed=20_000).batch_at(0)[:, :TRAIN_PROMPT], device=dev)
    cap = TRAIN_PROMPT + TRAIN_NEW + 8
    sc = ServeConfig(max_new_tokens=TRAIN_NEW)
    da.decode_attention.launches = 0
    served = Engine(kcfg, rparams, sc, capacity=cap).generate(
        {"tokens": prompts})
    torch.cuda.synchronize()
    launches = da.decode_attention.launches
    want = cfg.n_layers * (TRAIN_NEW - 1)
    fail_unless(launches == want, f"11a: decode_attention launched "
                f"{launches} times serving the checkpoint, not {want}")
    live_served = Engine(kcfg, params, sc, capacity=cap).generate(
        {"tokens": prompts})
    fail_unless(np.array_equal(served.tokens, live_served.tokens),
                "11a: the restored weights serve other tokens than the "
                "live ones")
    st["decode_attention_launches"] = launches
    print(f"11a: Engine.generate from the restored weights: decode_attention "
          f"{launches} launches ({cfg.n_layers} x {TRAIN_NEW - 1}), tokens "
          f"equal to the live weights'", flush=True)
    gam = st["gam_head"] = gam_vs_exact(torch, kmodel, rparams, prompts, cap,
                                        "11a")
    print(f"11a: GAM serve step (coarse_k {gam['coarse_k']}, budget "
          f"{gam['budget']}) on the trained weights: {gam['picks']} picks, "
          f"{gam['equal_to_recomputation']} equal to the exact argmax over "
          f"their candidates, {gam['near_ties_off']} off on near-ties; "
          f"agreement with the exact head {gam['agree_with_exact']:.3f}; "
          f"step p50 {gam['gam_step_ms_p50']:.2f} ms against "
          f"{gam['exact_step_ms_p50']:.2f} ms exact", flush=True)

    # --- decode_attention at this path's shape, on the trained cache
    _, cache = kmodel.prefill(rparams, {"tokens": prompts}, cap)
    q = torch.randn((8, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads,
                     cfg.hd), generator=torch.Generator(dev).manual_seed(2),
                    device=dev).to(torch.bfloat16)
    length = torch.tensor(TRAIN_PROMPT + TRAIN_NEW - 2, dtype=torch.int32,
                          device=dev)
    row, _ = decode_row(torch, "decode_attention@trained_checkpoint", q,
                        cache["k"][0], cache["v"][0], length, launches, 50,
                        graphed=True)
    del cache, params, rparams
    torch.cuda.empty_cache()
    return row


def train_remat_modes(torch, st):
    """11a: tinyllama-1.1b at REMAT_SIZE, REMAT_STEPS steps under each of
    REMAT_MODES from the same init and batches (the first step probes and
    is not timed): step p50 and ``max_memory_allocated`` a mode, the first
    step's loss (the forward before any update) the same under every
    mode.  A mode that does not fit the card is printed as such."""
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import build_batch
    from repro_torch.models import Model
    from repro_torch.training import AdamWConfig, adamw_init
    b, s = REMAT_SIZE
    cfg = get_config(LM_ARCH)
    opt_cfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                          total_steps=TRAIN_STEPS)
    batches = [build_batch(cfg, t, np.random.default_rng(0)) for t, _ in
               zip(TokenPipeline(vocab=cfg.vocab, seq_len=s, batch=b,
                                 seed=0), range(REMAT_STEPS))]
    smi = card_name_and_limit()
    held = torch.cuda.memory_allocated()
    out = {"batch": b, "seq": s, "held_before_gb": held / 1e9,
           "nvidia_smi": smi}
    for mode in REMAT_MODES:
        model = Model(cfg.with_(remat=mode))
        step = make_train_step(model, opt_cfg)
        params = opt = met = None
        torch.cuda.reset_peak_memory_stats()
        losses, step_ms = [], []
        try:
            params = model.init(0)
            opt = adamw_init(params)
            for i, batch in enumerate(batches):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                params, opt, met = step(params, opt, batch)
                ev[1].record()
                losses.append(float(met["loss"]))
                if i:
                    step_ms.append(ev[0].elapsed_time(ev[1]))
            fits = True
        except torch.cuda.OutOfMemoryError:
            fits = False
        peak = torch.cuda.max_memory_allocated()
        del params, opt, met, model, step
        torch.cuda.empty_cache()
        if not fits:
            out[mode] = {"fits": False, "peak_gb": peak / 1e9}
            print(f"11a remat {mode}: batch {b} x seq {s} does not fit the "
                  f"card (peak {peak / 1e9:.2f} GB when it ran out) "
                  f"[{smi}]")
            continue
        fail_unless(all(np.isfinite(losses)), f"11a remat {mode}: losses "
                    f"{losses}")
        out[mode] = {"fits": True, "losses": losses, "step_ms": step_ms,
                     "step_ms_p50": float(np.percentile(step_ms, 50)),
                     "peak_gb": peak / 1e9}
    ran = [m for m in REMAT_MODES if out[m]["fits"]]
    fail_unless("full" in ran, "11a remat: the published full does not fit")
    first = {m: out[m]["losses"][0] for m in ran}
    fail_unless(all(abs(x - first["full"]) <= PARITY_LOSS_TOL
                    * abs(first["full"]) for x in first.values()),
                f"11a remat: the first step's loss differs by mode: "
                f"{first}")
    full = out["full"]
    print(f"11a remat at batch {b} x seq {s}, {REMAT_STEPS} steps a mode "
          f"from one init ({held / 1e9:.2f} GB held before): " + "; ".join(
              f"{m}: step p50 {out[m]['step_ms_p50']:.2f} ms "
              f"({out[m]['step_ms_p50'] / full['step_ms_p50']:.3f} x "
              f"full's), peak {out[m]['peak_gb']:.2f} GB"
              for m in ran) + f"; first loss {first} [{smi}]", flush=True)
    st.update(out)


def train_parity(torch, st):
    """11b: one f32 train step of a narrowed tinyllama on the card and on
    the CPU, from the same weights and batch."""
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import Model
    from repro_torch.training import AdamWConfig, adamw_init
    dev = torch.device("cuda")
    cfg = get_config(LM_ARCH).with_(**PARITY_LM)
    cpu, gpu = Model(cfg, device="cpu"), Model(cfg)
    p_cpu = cpu.init(0)
    p_gpu = tree_map(lambda t: t.to(dev), p_cpu)
    tokens = TokenPipeline(vocab=cfg.vocab, seq_len=PARITY_SEQ,
                           batch=PARITY_BATCH, seed=3).batch_at(0)
    b_cpu = {"tokens": torch.as_tensor(tokens)}
    b_gpu = {"tokens": torch.as_tensor(tokens, device=dev)}
    l_cpu, _, g_cpu = grads_of(torch, cpu, p_cpu, b_cpu)
    l_gpu, _, g_gpu = grads_of(torch, gpu, p_gpu, b_gpu)
    loss_rel = abs(float(l_gpu) - float(l_cpu)) / abs(float(l_cpu))
    fail_unless(loss_rel <= PARITY_LOSS_TOL, f"11b: loss on the card "
                f"{float(l_gpu)} against the CPU's {float(l_cpu)}")
    worst = max(float((g_gpu[k].cpu() - g).abs().max() / g.abs().max())
                for k, g in g_cpu.items())
    fail_unless(worst <= PARITY_GRAD_TOL, f"11b: a gradient leaf differs "
                f"by {worst} x its largest |g| > {PARITY_GRAD_TOL}")
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=2)
    pc, sc, mc = make_train_step(cpu, opt_cfg)(p_cpu, adamw_init(p_cpu),
                                               b_cpu)
    pg, sg, mg = make_train_step(gpu, opt_cfg)(p_gpu, adamw_init(p_gpu),
                                               b_gpu)
    met_rel = max(abs(float(mg[k]) - float(mc[k]))
                  / max(abs(float(mc[k])), 1e-30) for k in mc)
    fail_unless(met_rel <= PARITY_LOSS_TOL, f"11b: step metrics differ by "
                f"{met_rel} relative")
    b2c = 1 - opt_cfg.b2
    fc, fg = flat_paths(pc), flat_paths(pg)
    vc = flat_paths(sc.nu)
    off = 0
    for k, want in fc.items():
        bad = (fg[k].cpu() - want).abs() > PARITY_PARAM_TOL
        vhat = torch.sqrt(vc[k][bad] / b2c)
        fail_unless(bool((vhat < EPS_DOMINATED * opt_cfg.eps).all()),
                    f"11b: param {k} differs past {PARITY_PARAM_TOL} where "
                    "AdamW's update is not eps-dominated")
        off += int(bad.sum())
    n = sum(t.numel() for t in fc.values())
    modes = remat_against_none(torch, cfg, p_gpu, b_gpu, "11b")
    st.update({"config": PARITY_LM, "batch": PARITY_BATCH, "remat": modes,
               "seq": PARITY_SEQ, "loss_cpu": float(l_cpu),
               "loss_card": float(l_gpu), "loss_rel": loss_rel,
               "grad_worst_rel_to_max": worst, "metrics_worst_rel": met_rel,
               "params_off_eps_dominated": off, "params": n})
    print(f"11b: tinyllama at 2 layers, d 256, f32, batch {PARITY_BATCH} x "
          f"seq {PARITY_SEQ}: loss card {float(l_gpu):.7f} CPU "
          f"{float(l_cpu):.7f} (rel {loss_rel:.2g}); gradients within "
          f"{worst:.2g} x each leaf's largest |g| (tolerance "
          f"{PARITY_GRAD_TOL}); one AdamW step: metrics within "
          f"{met_rel:.2g}, {off} of {n} params past {PARITY_PARAM_TOL}, all "
          f"eps-dominated; {print_remat(modes)}")


def remat_against_none(torch, cfg, params, batch, what) -> dict:
    """``cfg``'s loss and gradients on the card under "full" and "dots"
    against "none"'s from the same params and batch: loss within
    PARITY_LOSS_TOL relative, each gradient leaf within PARITY_GRAD_TOL x
    none's largest |g|; the bit-equal leaves are counted."""
    from repro_torch.models import Model
    runs = {m: grads_of(torch, Model(cfg.with_(remat=m)), params, batch)
            for m in ("none", "full", "dots")}
    l0, _, g0 = runs.pop("none")
    out = {}
    for mode, (loss, _, grads) in runs.items():
        rel = abs(float(loss) - float(l0)) / abs(float(l0))
        worst = max(float((grads[k] - g).float().abs().max()
                          / max(float(g.float().abs().max()), 1e-30))
                    for k, g in g0.items())
        fail_unless(rel <= PARITY_LOSS_TOL and worst <= PARITY_GRAD_TOL,
                    f"{what} remat {mode}: loss rel {rel}, a gradient leaf "
                    f"{worst} x its largest |g| against none's")
        out[mode] = {"loss_bits_equal": tensor_bits_equal(torch, loss, l0),
                     "loss_rel": rel, "grad_worst_rel_to_max": worst,
                     "grads_bits_equal": sum(tensor_bits_equal(
                         torch, grads[k], g) for k, g in g0.items()),
                     "leaves": len(g0)}
    del runs
    return out


def print_remat(modes: dict) -> str:
    """``remat_against_none``'s result as a line."""
    parts = []
    for mode, r in modes.items():
        loss = ("bit-equal" if r["loss_bits_equal"]
                else f"rel {r['loss_rel']:.2g}")
        parts.append(f"{mode} against none: loss {loss}, gradients within "
                     f"{r['grad_worst_rel_to_max']:.2g} x each leaf's "
                     f"largest |g|, {r['grads_bits_equal']} of "
                     f"{r['leaves']} leaves bit-equal")
    return "; ".join(parts)


def train_families(torch, st):
    """11c: olmoe-1b-7b at its published widths cut to 2 layers, bf16, 3
    steps; four other families one step each at their reduced configs."""
    from repro_torch.configs import get_config, get_reduced_config
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import build_batch
    from repro_torch.models import Model
    from repro_torch.training import AdamWConfig, adamw_init
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1,
                          total_steps=OLMOE_TRAIN_STEPS)
    full = get_config("olmoe-1b-7b")
    cfg = full.with_(n_layers=OLMOE_TRAIN_LAYERS)
    model = Model(cfg)
    params = model.init(0)
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=OLMOE_TRAIN_SEQ,
                         batch=OLMOE_TRAIN_BATCH, seed=0)
    rng = np.random.default_rng(0)
    loss, met, grads = grads_of(torch, model, params,
                                build_batch(cfg, pipe.batch_at(0), rng))
    fail_unless(bool(torch.isfinite(loss)) and all_finite(torch, grads),
                "11c olmoe: a non-finite loss or gradient")
    fail_unless(float(met["aux"]) > 0, "11c olmoe: aux loss is not > 0")
    del grads
    modes = remat_against_none(torch, cfg, params, build_batch(
        cfg, pipe.batch_at(0), np.random.default_rng(0)), "11c olmoe")
    step = make_train_step(model, opt_cfg)
    opt = adamw_init(params)
    losses, auxes = [], []
    with RoutingLog(torch, True) as log:
        for _, tokens in zip(range(OLMOE_TRAIN_STEPS), pipe):
            params, opt, m = step(params, opt, build_batch(cfg, tokens, rng))
            losses.append(float(m["loss"]))
            auxes.append(float(m["aux"]))
            fail_unless(np.isfinite(float(m["grad_norm"])),
                        "11c olmoe: a non-finite gradient norm")
    fail_unless(all(np.isfinite(losses)) and min(auxes) > 0,
                f"11c olmoe: losses {losses}, aux {auxes}")
    drops = log.dropped(cfg.n_layers, skip=0)
    pairs = cfg.n_layers * OLMOE_TRAIN_BATCH * OLMOE_TRAIN_SEQ * cfg.moe_top_k
    st["olmoe"] = {"layers": cfg.n_layers, "of_layers": full.n_layers,
                   "batch": OLMOE_TRAIN_BATCH, "seq": OLMOE_TRAIN_SEQ,
                   "losses": losses, "aux": auxes, "remat": modes,
                   "dropped_pairs_per_step": drops.tolist(), "pairs": pairs}
    print(f"11c: olmoe-1b-7b at published widths, depth cut to "
          f"{cfg.n_layers} of {full.n_layers} layers, bf16, batch "
          f"{OLMOE_TRAIN_BATCH} x seq {OLMOE_TRAIN_SEQ}, "
          f"{OLMOE_TRAIN_STEPS} steps: losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}, aux "
          f"{', '.join(f'{x:.4f}' for x in auxes)}; every gradient leaf "
          f"finite; dropped (token, slot) pairs a step (all layers) "
          f"{drops.tolist()} of {pairs}; {print_remat(modes)}")
    del model, params, opt
    torch.cuda.empty_cache()
    for arch in FAMILY_TRAIN:
        cfg = get_reduced_config(arch)
        model = Model(cfg)
        params = model.init(0)
        batch = build_batch(cfg, TokenPipeline(
            vocab=cfg.vocab, seq_len=64, batch=2, seed=0).batch_at(0),
            np.random.default_rng(0))
        loss, _, grads = grads_of(torch, model, params, batch)
        _, _, m = make_train_step(model, opt_cfg)(params, adamw_init(params),
                                                  batch)
        fail_unless(bool(torch.isfinite(loss)) and all_finite(torch, grads)
                    and np.isfinite(float(m["loss"])),
                    f"11c {arch}: a non-finite loss or gradient")
        st[arch] = {"loss": float(loss), "step_loss": float(m["loss"]),
                    "grad_norm": float(m["grad_norm"]),
                    "leaves": len(grads)}
        print(f"11c: {arch} (reduced, f32): loss {float(loss):.4f}, one "
              f"step: loss {float(m['loss']):.4f}, grad norm "
              f"{float(m['grad_norm']):.4f}; all {len(grads)} gradient "
              "leaves finite")


def train_entry_points(torch, st):
    """11d: the train launcher and the four examples, each a process of its
    own on the card, all at once; each must exit 0 with its own assertions
    holding."""
    runs = [
        ("train launcher", ["-m", "repro_torch.launch.train", "--arch",
                            "olmo-1b", "--reduced", "--steps", "12",
                            "--batch", "2", "--seq", "32", "--vocab", "128"],
         "final loss"),
        ("train_lm_torch", ["examples/train_lm_torch.py"],
         "checkpoint restored at step 250"),
        ("quickstart_torch", ["examples/quickstart_torch.py"], "\nOK\n"),
        ("serve_stream_torch", ["examples/serve_stream_torch.py"], "\nOK\n"),
        ("serve_gam_torch", ["examples/serve_gam_torch.py"], "\nOK\n"),
    ]
    waits = [run_python(args, f"11d {name}", ENTRY_TIMEOUT)
             for name, args, _ in runs]
    for (name, args, marker), wait in zip(runs, waits):
        out, seconds = wait()
        fail_unless(marker in out, f"11d: {name} printed no {marker!r}")
        st[name] = seconds


def phase_training(torch, report):
    """Phase 11: LM training on the card (11a-11d)."""
    import gc
    gc.collect()                  # earlier phases' cycles may hold tensors
    torch.cuda.empty_cache()
    out: dict = {"held_at_start_gb": torch.cuda.memory_allocated() / 1e9}
    print(f"training: {out['held_at_start_gb']:.2f} GB of device memory "
          "allocated by earlier phases at the start", flush=True)
    t0 = time.perf_counter()
    out["11a"] = {}
    row = train_tinyllama(torch, out["11a"])
    out["11a"]["remat"] = {}
    train_remat_modes(torch, out["11a"]["remat"])
    out["11b"] = {}
    t1 = time.perf_counter()
    train_parity(torch, out["11b"])
    out["11c"] = {}
    t2 = time.perf_counter()
    train_families(torch, out["11c"])
    out["11d"] = {}
    t3 = time.perf_counter()
    train_entry_points(torch, out["11d"])
    t4 = time.perf_counter()
    out["seconds"] = {"11a": t1 - t0, "11b": t2 - t1, "11c": t3 - t2,
                      "11d": t4 - t3}
    report["training"] = out
    print("training: seconds " + ", ".join(
        f"{k} {v:.1f}" for k, v in out["seconds"].items()))
    return [row]


# ------------------------------------------------ 12. over a device mesh

MESH_RANKS = 2                 # processes sharing the one card (12a-c)
MESH_REQUESTS = 8              # of BATCH queries after one warm-up: 2,048
MESH_TRAIN_SIZES = ((4, 1024), (2, 1024), (4, 512))   # global, largest first
MESH_TRAIN_STEPS = 4           # the first probes the size; 3 are timed
# 12b's depth, of tinyllama's 22 layers: under the published remat the
# forward's collectives run again in the backward, and at 22 layers a step
# took 15.3 s on (data 2, model 1) and 47.5 s on (data 1, model 2) (H100,
# two ranks over gloo through host memory), 288 s for the part
MESH_TRAIN_LAYERS = 8
MESH_TRAIN_MESHES = ((2, 1), (1, 2))                  # (data, model)
MESH_SERVE_BATCH, MESH_PROMPT, MESH_NEW = 8, 1024, 32
MESH_MEMORY_SHARE = 0.48       # of the card, each rank (12b's size probe)
MESH_GROUP_TIMEOUT = 300       # s: the gloo group's rendezvous, collectives
MESH_DEADLINE = 600            # s: both workers, or the phase fails


def local_bytes(tree) -> int:
    """Bytes a rank holds of a tree of DTensors (or tensors)."""
    return int(sum((t.to_local() if hasattr(t, "to_local") else t).numel()
                   * t.element_size() for t in leaves(tree)))


def mesh_index_part(torch, rank, dev) -> dict:
    """12a: phase 6's catalog as one ``sharded`` index placed over the
    2-rank ``items`` mesh, against single-device ``sharded`` in the same
    process, request by request (posting bucket sized to the longest
    list, so no shard spills)."""
    from repro_torch.core.mapping import GamConfig, sparse_map
    from repro_torch.launch.mesh import make_index_mesh
    from repro_torch.retriever import RetrieverSpec, open_retriever
    gr = importlib.import_module("repro_torch.kernels.gam_retrieve")
    tp = importlib.import_module("repro_torch.kernels.tess_project")
    items, centers = clustered_catalog(N_ITEMS, K, N_CLUSTERS, SIGMA,
                                       seed=N_ITEMS)
    reqs = requests(centers, MESH_REQUESTS + 1, BATCH, SIGMA, seed=12)
    cfg = GamConfig(k=K, scheme="parse_tree", threshold=THRESHOLD)
    tau, vals = sparse_map(torch.as_tensor(items, device=dev), cfg)
    nz = (vals != 0).cpu().numpy()
    bucket = int(np.bincount(tau.cpu().numpy()[nz], minlength=cfg.p).max())
    del tau, vals
    spec = RetrieverSpec(cfg=cfg, backend="sharded", n_shards=SVC_SHARDS,
                         min_overlap=MIN_OVERLAP, kappa=KAPPA, bucket=bucket,
                         batch_size=BATCH)
    mesh = make_index_mesh(MESH_RANKS)
    t0 = time.perf_counter()
    placed = open_retriever(spec, items=items, device=dev, mesh=mesh)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    single = open_retriever(spec, items=items, device=dev)
    base = placed.base
    fail_unless(base.placed and base.shard_hi - base.shard_lo
                == SVC_SHARDS // MESH_RANKS, f"12a rank {rank}: the index "
                f"is not placed ({base.shard_lo}..{base.shard_hi})")
    placed.query(reqs[0])
    single.query(reqs[0])

    def timed(r, users):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = r.query(users)
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t) * 1e3

    gr.gam_retrieve.launches = tp.tess_project.launches = 0
    got = [timed(placed, u) for u in reqs[1:]]
    launches = {"gam_retrieve": gr.gam_retrieve.launches,
                "tess_project": tp.tess_project.launches}
    want = [timed(single, u) for u in reqs[1:]]
    for i, ((a, _), (b, _)) in enumerate(zip(got, want)):
        for f in ("ids", "scores", "n_scored"):
            fail_unless(np.array_equal(getattr(a, f), getattr(b, f)),
                        f"12a rank {rank} request {i}: {f} differ from "
                        "single-device sharded")
    fail_unless(launches["gam_retrieve"] == MESH_REQUESTS
                and launches["tess_project"] > 0, f"12a rank {rank}: "
                f"launches {launches}")
    # the kernel over this rank's rows against its plain version
    users = torch.as_tensor(reqs[1], device=dev)
    tau, vals = sparse_map(users, cfg)
    meta = base.metas[0]
    args = (users, base.factors_g[0], tau, vals != 0, meta, KAPPA)
    kw = dict(min_overlap=MIN_OVERLAP, alive=base.alive_g[0])
    k_out = gr.gam_retrieve(*args, **kw)
    p_out = gr.gam_retrieve_plain(*args, **kw)
    torch.cuda.synchronize()
    fail_unless(torch.equal(k_out.rows, p_out.rows)
                and torch.equal(k_out.blk_counts, p_out.blk_counts)
                and torch.equal(k_out.skipped, p_out.skipped),
                f"12a rank {rank}: gam_retrieve on the rank's rows differs "
                "from its plain version")
    ulp = max_ulp(k_out.vals.cpu().numpy(), p_out.vals.cpu().numpy())
    fail_unless(ulp <= 4, f"12a rank {rank}: scores {ulp} ulp from plain")
    n_bytes, flops = retrieve_work(torch, args, kw, k_out)
    b_ms, b_by = bound_ms(n_bytes, flops)
    z = users
    t_bytes = BATCH * K * (4 + 1 + 4)
    tb_ms, tb_by = bound_ms(t_bytes, 3 * K * BATCH)
    tess_err = float((tp.tess_project(z)[1] - tp.tess_project_plain(z)[1])
                     .abs().max())
    rows = [{"name": f"gam_retrieve@mesh rank {rank}", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/gam_retrieve.cu",
             "replaces": "src/repro/kernels/gam_retrieve.py:384",
             "launches": launches["gam_retrieve"],
             "max_abs_err": float((k_out.vals - p_out.vals).abs().max()),
             "ms": time_ms(torch, lambda: gr.gam_retrieve(*args, **kw), 20),
             "plain_ms": time_ms(torch, lambda: gr.gam_retrieve_plain(
                 *args, **kw), 3),
             "bound_ms": b_ms, "bound_by": b_by, "library_ms": None},
            {"name": f"tess_project@mesh rank {rank}", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/tess_project.cu",
             "replaces": "src/repro/kernels/tess_project.py:57",
             "launches": launches["tess_project"], "max_abs_err": tess_err,
             "ms": time_ms(torch, lambda: tp.tess_project(z), 20),
             "plain_ms": time_ms(torch, lambda: tp.tess_project_plain(z), 3),
             "bound_ms": tb_ms, "bound_by": tb_by, "library_ms": None}]
    lat_p = [ms for _, ms in got]
    lat_s = [ms for _, ms in want]
    out = {"build_s": build_s, "shards": [base.shard_lo, base.shard_hi],
           "rows": [base.row_lo, base.row_hi], "launches": launches,
           "device_bytes": base.device_bytes(),
           "device_bytes_single": single.base.device_bytes(),
           "p50_ms": float(np.percentile(lat_p, 50)),
           "p99_ms": float(np.percentile(lat_p, 99)),
           "single_p50_ms": float(np.percentile(lat_s, 50)),
           "single_p99_ms": float(np.percentile(lat_s, 99)),
           "kernel_rows": rows, "local_rows": meta.n_rows}
    del placed, single, base, args, k_out, p_out
    torch.cuda.empty_cache()
    return out


def mesh_all_ok(torch, ok: bool) -> bool:
    """Every rank's ``ok``, on every rank (a CPU all-reduce)."""
    import torch.distributed as dist
    flag = torch.tensor([int(ok)])
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    return bool(flag.item())


def mesh_train_part(torch, rank, dev) -> dict:
    """12b: tinyllama-1.1b at published widths, MESH_TRAIN_LAYERS deep,
    trains 4 steps on two 2-rank meshes, (data 2, model 1) and (data 1,
    model 2), through the unchanged ``make_train_step`` on DTensors (the
    first step probes the size and is not timed); and at f32 on the
    2-layer d-256 config, the sharded loss and gradients under the
    published remat against one rank's without."""
    from repro_torch.configs import get_config, get_reduced_config
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.mesh import STAGED, make_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import build_batch
    from repro_torch.models import Model
    from repro_torch.sharding.specs import batch_specs, param_shardings, place
    from repro_torch.training import AdamWConfig, adamw_init
    cfg = get_config(LM_ARCH).with_(n_layers=MESH_TRAIN_LAYERS)
    model = Model(cfg, device=dev)
    step_fn = make_train_step(model, AdamWConfig(
        lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP, total_steps=TRAIN_STEPS))
    torch.cuda.set_per_process_memory_fraction(MESH_MEMORY_SHARE)
    full_bytes = sum(t.numel() for t in leaves(
        Model(cfg, device="meta").init(0)))
    full_bytes = {"params": full_bytes * 2, "moments": full_bytes * 8}
    out = {"meshes": {}}

    def start(mesh, b, s):
        params = model.init(0)
        placed = place(params, param_shardings(mesh, params))
        del params
        torch.cuda.empty_cache()
        return placed, adamw_init(placed), TokenPipeline(
            vocab=cfg.vocab, seq_len=s, batch=b, seed=0)

    def batch_of(mesh, tokens):
        batch = build_batch(cfg, tokens, np.random.default_rng(0))
        return place(batch, batch_specs(cfg, mesh, batch))

    for shape in MESH_TRAIN_MESHES:
        mesh = make_mesh(shape, ("data", "model"))
        name = f"data {shape[0]} x model {shape[1]}"
        # the first step probes the size: the largest that fits
        size = None
        for b, s in MESH_TRAIN_SIZES:
            params = opt = met = None
            try:
                params, opt, pipe = start(mesh, b, s)
                resident = {"params": local_bytes(params),
                            "moments": local_bytes(opt.mu)
                            + local_bytes(opt.nu)}
                torch.cuda.reset_peak_memory_stats()
                staged0 = {k: dict(v) for k, v in STAGED.items()}
                params, opt, met = step_fn(params, opt,
                                           batch_of(mesh, pipe.batch_at(0)))
                torch.cuda.synchronize()
                ok = True
            except torch.cuda.OutOfMemoryError:
                ok = False
            if mesh_all_ok(torch, ok):
                size = (b, s)
                break
            del params, opt, met
            torch.cuda.empty_cache()
            print(f"12b {name}: global batch {b} x seq {s} does not fit "
                  f"{MESH_MEMORY_SHARE} of the card a rank")
        fail_unless(size is not None, f"12b {name}: no size fits")
        b, s = size
        losses, step_ms = [float(met["loss"])], []
        for i in range(1, MESH_TRAIN_STEPS):
            batch = batch_of(mesh, pipe.batch_at(i))
            torch.cuda.synchronize()
            t = time.perf_counter()
            params, opt, met = step_fn(params, opt, batch)
            losses.append(float(met["loss"]))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
        fail_unless(all(np.isfinite(losses)) and losses[-1] < losses[0],
                    f"12b {name}: losses {losses} do not fall")
        after = {"params": local_bytes(params),
                 "moments": local_bytes(opt.mu) + local_bytes(opt.nu)}
        fail_unless(after == resident, f"12b {name}: a rank's resident "
                    f"bytes moved from {resident} to {after}")
        p50 = float(np.percentile(step_ms, 50))
        out["meshes"][name] = {
            "remat": cfg.remat, "layers": cfg.n_layers,
            "batch": b, "seq": s, "losses": losses, "step_ms": step_ms,
            "step_ms_p50": p50, "step_ms_p99": float(np.percentile(step_ms,
                                                                   99)),
            "tokens_per_s": b * s / (p50 / 1e3),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "resident_bytes": resident, "single_rank_bytes": full_bytes,
            "staged_per_step": {
                name: {k: (v - staged0.get(name, {}).get(k, 0))
                       / MESH_TRAIN_STEPS for k, v in st.items()}
                for name, st in STAGED.items()}}
        del params, opt, met, batch
        torch.cuda.empty_cache()
        # f32, 2 layers, d 256: the sharded loss and gradients under the
        # published remat against one rank's without, on the same batch
        small = get_reduced_config(LM_ARCH)
        sm = Model(small, device=dev)
        p1 = sm.init(0)
        tokens = TokenPipeline(vocab=small.vocab, seq_len=64, batch=4,
                               seed=1).batch_at(0)
        b1 = {"tokens": torch.as_tensor(tokens, device=dev)}
        loss1, _, g1 = grads_of(torch, sm, p1, b1)
        pm = place(p1, param_shardings(mesh, p1))
        from repro_torch.models.spmd import replicated_constants
        with replicated_constants(True):
            lossm, _, gm = grads_of(
                torch, Model(small.with_(remat=cfg.remat), device=dev), pm,
                place(b1, batch_specs(small, mesh, b1)))
        lossm = float(lossm.full_tensor())
        rel = abs(lossm - float(loss1)) / abs(float(loss1))
        gerr = max(float((gm[k].full_tensor() - g).abs().max())
                   / max(float(g.abs().max()), 1e-30) for k, g in g1.items())
        fail_unless(rel <= 1e-5 and gerr <= 1e-4, f"12b {name}: f32 loss "
                    f"rel diff {rel}, gradient diff {gerr} of the leaf's "
                    "largest")
        out["meshes"][name].update(f32_loss_rel=rel, f32_grad_rel=gerr)
        del sm, p1, pm, g1, gm
        torch.cuda.empty_cache()
    torch.cuda.set_per_process_memory_fraction(1.0)
    return out


def mesh_serve_part(torch, rank, dev) -> dict:
    """12c: tinyllama-1.1b at published widths serves greedily through the
    unchanged prefill and serve steps on a (data 2, model 1) mesh (the
    cache sharded on batch), ``decode_attention`` launched on each rank's
    sequences, against single-device ``Engine`` in the same process; and
    at f32 on the 2-layer d-256 config, the sharded prefill and decode
    steps against one device's: the same tokens, the cache within 1e-5."""
    from repro_torch.configs import get_config, get_reduced_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import Model
    from repro_torch.serving import Engine, ServeConfig
    from repro_torch.sharding.specs import batch_specs, param_shardings, place
    da = importlib.import_module("repro_torch.kernels.decode_attention")
    cfg = get_config(LM_ARCH).with_(use_decode_kernel=True)
    capacity = MESH_PROMPT + MESH_NEW + 8
    model = Model(cfg, device=dev)
    params = model.init(0)
    prompts = np.random.default_rng(3).integers(
        0, cfg.vocab, (MESH_SERVE_BATCH, MESH_PROMPT)).astype(np.int32)
    want = Engine(cfg, params, ServeConfig(max_new_tokens=MESH_NEW),
                  capacity=capacity, device=dev).generate(
        {"tokens": torch.as_tensor(prompts, device=dev)}).tokens
    mesh = make_mesh((MESH_RANKS, 1), ("data", "model"))
    placed = place(params, param_shardings(mesh, params))
    del params
    torch.cuda.empty_cache()
    batch = {"tokens": torch.as_tensor(prompts, device=dev)}
    batch = place(batch, batch_specs(cfg, mesh, batch))
    prefill = make_prefill_step(model, capacity)
    serve = make_serve_step(model)
    da.decode_attention.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    logits, cache = prefill(placed, batch)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t) * 1e3
    toks, step_ms = [tok], []
    for _ in range(MESH_NEW - 1):
        t = time.perf_counter()
        tok, cache = serve(placed, cache, tok)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        toks.append(tok)
    launches = da.decode_attention.launches
    got = torch.cat([x.full_tensor() for x in toks], dim=1).cpu().numpy()
    fail_unless(launches == cfg.n_layers * (MESH_NEW - 1), f"12c rank "
                f"{rank}: decode_attention launched {launches} times, not "
                f"{cfg.n_layers} x {MESH_NEW - 1}")
    same = got == np.asarray(want)
    held = np.where(same.all(axis=1), MESH_NEW, np.argmin(same, axis=1))
    fail_unless(bool(same[:, 0].all()), f"12c rank {rank}: the first "
                "token differs from single-device Engine's")
    f32 = mesh_serve_f32(torch, rank, dev, mesh, get_reduced_config(
        LM_ARCH).with_(use_decode_kernel=True))
    # the kernel on this rank's sequences: layer 0's local cache
    k_loc = cache["k"].to_local()[0]
    v_loc = cache["v"].to_local()[0]
    b_loc = k_loc.shape[0]
    length = torch.tensor(MESH_PROMPT + MESH_NEW - 2, dtype=torch.int32,
                          device=dev)
    q = torch.randn((b_loc, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads,
                     cfg.hd), generator=torch.Generator(device=dev)
                    .manual_seed(rank), device=dev).to(k_loc.dtype)
    row, _ = decode_row(torch, f"decode_attention@mesh rank {rank}", q,
                        k_loc, v_loc, length, launches, 20, True)
    return {"tokens_held": held.tolist(), "prefill_ms": prefill_ms,
            "step_ms_p50": float(np.percentile(step_ms, 50)),
            "step_ms_p99": float(np.percentile(step_ms, 99)),
            "launches": launches, "local_batch": b_loc, "kernel_row": row,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "f32": f32}


def mesh_serve_f32(torch, rank, dev, mesh, cfg) -> dict:
    """12c's f32 check: prefill of MESH_SERVE_BATCH prompts of 64 and
    MESH_NEW - 1 greedy decode steps, on the mesh (the cache sharded on
    batch, ``decode_attention`` on each rank's sequences) and on one
    device from the same params.  The tokens must be equal at every step
    and every cache leaf within 1e-5."""
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import Model
    from repro_torch.sharding.specs import batch_specs, param_shardings, place
    model = Model(cfg, device=dev)
    params = model.init(0)
    placed = place(params, param_shardings(mesh, params))
    prompts = torch.as_tensor(np.random.default_rng(4).integers(
        0, cfg.vocab, (MESH_SERVE_BATCH, 64)), dtype=torch.int32, device=dev)
    prefill = make_prefill_step(model, 64 + MESH_NEW + 8)
    serve = make_serve_step(model)
    lw, cw = prefill(params, {"tokens": prompts})
    batch = {"tokens": prompts}
    lg, cg = prefill(placed, place(batch, batch_specs(cfg, mesh, batch)))
    tw = torch.argmax(lw, dim=-1).to(torch.int32)
    tg = torch.argmax(lg, dim=-1).to(torch.int32)
    want, got = [tw], [tg.full_tensor()]
    for _ in range(MESH_NEW - 1):
        tw, cw = serve(params, cw, tw)
        tg, cg = serve(placed, cg, tg)
        want.append(tw)
        got.append(tg.full_tensor())
    same = (torch.cat(got, 1) == torch.cat(want, 1)).cpu().numpy()
    held = np.where(same.all(axis=1), MESH_NEW, np.argmin(same, axis=1))
    cache_err = max(
        float((v.full_tensor() if hasattr(v, "full_tensor") else v).float()
              .sub(cw[k].float()).abs().max()) for k, v in cg.items())
    fail_unless(bool(same.all()) and cache_err <= 1e-5, f"12c rank {rank}: "
                f"f32 tokens held {held.tolist()} of {MESH_NEW} steps, cache "
                f"{cache_err} from one device's (limit 1e-5)")
    return {"tokens_held": held.tolist(), "cache_max_abs": cache_err}


def mesh_worker(rank: int, coordinator: str,
                parts: str = "12a,12b,12c") -> int:
    """Phase 12's SPMD body: one of two processes sharing the card in one
    gloo group (both devices' backends gloo; DTensor's all-gather staged
    through host memory, counted), running 12a-c.  Prints its numbers as
    one ``MESH12 {json}`` line."""
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch.mesh import STAGED
    from repro_torch.launch.procs import init_process_group
    init_process_group(coordinator, MESH_RANKS, rank,
                       timeout_s=MESH_GROUP_TIMEOUT,
                       backend="cpu:gloo,cuda:gloo")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    out = {"rank": rank, "seconds": {}}
    for name, part in (("12a", lambda: mesh_index_part(torch, rank, dev)),
                       ("12b", lambda: mesh_train_part(torch, rank, dev)),
                       ("12c", lambda: mesh_serve_part(torch, rank, dev))):
        if name not in parts.split(","):
            continue
        t = time.perf_counter()
        out[name] = part()
        out["seconds"][name] = time.perf_counter() - t
        torch.cuda.empty_cache()
    out["staged"] = STAGED
    print("MESH12 " + json.dumps(out), flush=True)
    return 0


def phase_mesh(torch, report, parts="12a,12b,12c"):
    """Phase 12: two processes on the card as a device mesh (12a the
    mesh-placed index, 12b sharded train steps, 12c a sharded serve
    step; ``parts`` names those to run)."""
    procs = importlib.import_module("repro_torch.launch.procs")
    torch.cuda.empty_cache()
    coordinator = procs.free_coordinator()
    t0 = time.perf_counter()
    codes, outs = procs.run_workers(
        [[sys.executable, str(ROOT / "chip_smoke.py"), "--mesh-worker",
          str(r), coordinator, parts]
         for r in range(MESH_RANKS)],
        timeout=MESH_DEADLINE, capture=True)
    seconds = time.perf_counter() - t0
    ranks = []
    for r, text in enumerate(outs):
        for line in text.splitlines():
            if line.startswith("MESH12 "):
                ranks.append(json.loads(line[7:]))
            else:
                print(f"  [rank {r}] {line}")
    fail_unless(codes == [0] * MESH_RANKS and len(ranks) == MESH_RANKS,
                f"mesh workers exited {codes} (124: past the "
                f"{MESH_DEADLINE} s deadline)")
    rows = []
    for o in ranks:
        if "12a" not in o:
            continue
        a = o["12a"]
        rows += a["kernel_rows"]
        g = a["kernel_rows"][0]
        print(f"12a rank {o['rank']}: shards {a['shards']} rows {a['rows']}"
              f" built in {a['build_s']:.1f} s; {MESH_REQUESTS} requests of "
              f"{BATCH} = single-device sharded bit for bit (ids, scores, "
              f"n_scored); launches {a['launches']}; resident index "
              f"{sum(a['device_bytes'].values())} bytes against "
              f"{sum(a['device_bytes_single'].values())} on one device; "
              f"request p50 {a['p50_ms']:.3f} ms p99 {a['p99_ms']:.3f} ms "
              f"(single-device {a['single_p50_ms']:.3f} / "
              f"{a['single_p99_ms']:.3f} ms, host clock); gam_retrieve on "
              f"its {a['local_rows']} rows {g['ms']:.4f} ms, plain "
              f"{g['plain_ms']:.3f} ms, bound {g['bound_ms']:.5f} ms "
              f"({g['bound_by']})")
    for o in ranks:
        for name, m in o.get("12b", {"meshes": {}})["meshes"].items():
            print(f"12b rank {o['rank']} {name} ({m['layers']} layers, "
                  f"remat {m['remat']}): "
                  f"global batch {m['batch']} x seq {m['seq']}, losses "
                  f"{[round(x, 4) for x in m['losses']]}"
                  f", step p50 {m['step_ms_p50']:.1f} ms p99 "
                  f"{m['step_ms_p99']:.1f} ms, {m['tokens_per_s']:.0f} "
                  f"tokens/s, peak {m['peak_gb']:.2f} GB, resident "
                  f"{m['resident_bytes']} bytes against one rank's "
                  f"{m['single_rank_bytes']}; staged through host memory a "
                  f"step {m['staged_per_step']}; f32 2-layer under remat "
                  f"{m['remat']} against one rank's without: loss rel "
                  f"{m['f32_loss_rel']:.3g}, gradients "
                  f"{m['f32_grad_rel']:.3g} of each leaf's largest")
    for o in ranks:
        if "12c" not in o:
            continue
        c = o["12c"]
        rows.append(c["kernel_row"])
        k = c["kernel_row"]
        print(f"12c rank {o['rank']}: {c['local_batch']} local sequences, "
              f"tokens held against single-device Engine {c['tokens_held']}"
              f" steps; decode_attention launches {c['launches']}; prefill "
              f"{c['prefill_ms']:.1f} ms, decode step p50 "
              f"{c['step_ms_p50']:.2f} ms p99 {c['step_ms_p99']:.2f} ms; "
              f"kernel on the local slice {k['ms']:.4f} ms, plain "
              f"{k['plain_ms']:.4f} ms, sdpa {k['library_ms']:.4f} ms; f32 "
              f"2-layer: tokens held {c['f32']['tokens_held']} steps, cache "
              f"{c['f32']['cache_max_abs']:.3g} from one device's")
    for o in ranks:
        print(f"12 rank {o['rank']}: seconds {o['seconds']}; collectives "
              f"staged through host memory {o['staged']}")
    report["mesh"] = {"seconds": seconds, "ranks": ranks}
    return rows


# ------------------------------------------------- 13. cost analysis

COST_CLI_TIMEOUT = 100         # s: each 13a process (they run together)
COST_DECODE_CALLS = 10         # timed decode steps (one warm-up first)
COST_TRAIN_CALLS = 3           # timed train steps (one warm-up first)
COST_SHARE_MAX = 1.05          # roofline share past this: work left out
COST_PREFILL = 1024            # phase 5's prompt before the timed steps
COST_CLIS = (
    ("dryrun", ["--arch", LM_ARCH, "--shape", "train_4k"]),
    ("dryrun", ["--arch", LM_ARCH, "--shape", "decode_32k"]),
    ("dryrun", ["--arch", LM_ARCH, "--shape", "decode_32k", "--multi-pod"]),
    ("roofline", ["--arch", LM_ARCH, "--shape", "train_4k"]),
    ("perf", ["--arch", "olmoe-1b-7b", "--shape", "decode_32k",
              "--variants", "baseline,cap10,baseline+mesh1"]))


def cost_clis() -> list:
    """13a: the three cost CLIs as processes on the host (meta tensors over
    a fake 256- or 512-rank group; no card), started together.  Each must
    exit 0 and write only records of status ``ok``; returns them."""
    import shutil
    out_dir = ROOT / "build" / "phase13"
    shutil.rmtree(out_dir, ignore_errors=True)     # the CLIs skip cached
    out_dir.mkdir(parents=True)
    runs = []
    for i, (mod, args) in enumerate(COST_CLIS):
        out = out_dir / f"{i}_{mod}.json"
        runs.append((mod, args, out, run_python(
            ["-m", f"repro_torch.launch.{mod}", *args, "--out", str(out)],
            f"13a {mod}", COST_CLI_TIMEOUT)))
    records = []
    for mod, args, out, wait in runs:
        wait()
        recs = json.loads(out.read_text())
        fail_unless(recs and all(r.get("status") == "ok" for r in recs),
                    f"13a {mod} {' '.join(args)}: records not all ok: "
                    f"{recs}")
        for r in recs:
            print(f"13a {mod} record: {json.dumps(r)}")
        records += [dict(r, cli=mod) for r in recs]
    return records


def counted(torch, fn, args) -> dict:
    """One call of ``fn(*args)`` under a fresh cost counter: its record
    (flops by unit, bytes, memory, kernel entries)."""
    from repro_torch.launch.dryrun import Lowered
    return Lowered(fn, args).count().record()


def same_count(a: dict, b: dict, what: str) -> None:
    """The meta count ``a`` and the card's ``b`` must agree exactly."""
    fail_unless(a["flops"] == b["flops"], f"13b {what}: flops by unit on "
                f"meta {a['flops']} != on the card {b['flops']}")
    fail_unless(a["bytes_accessed"] == b["bytes_accessed"],
                f"13b {what}: bytes on meta {a['bytes_accessed']} != on the "
                f"card {b['bytes_accessed']}")
    fail_unless(a["kernels"] == b["kernels"], f"13b {what}: kernel entries "
                f"on meta {a['kernels']} != on the card {b['kernels']}")


def step_share(torch, rec: dict, ms: float, what: str, smi: str) -> dict:
    """The roofline bound of one card (max of the compute and memory
    terms) against the measured p50; fails past COST_SHARE_MAX."""
    from repro_torch.launch.roofline import HBM_BW, compute_seconds
    t_c = compute_seconds(rec["flops"]) * 1e3
    t_m = rec["bytes_accessed"] / HBM_BW * 1e3
    bound = max(t_c, t_m)
    share = bound / ms
    by = "compute" if t_c >= t_m else "memory"
    print(f"13b {what}: bound {bound:.4f} ms ({by}; compute {t_c:.4f} ms, "
          f"memory {t_m:.4f} ms), measured p50 "
          f"{ms:.4f} ms, share {share:.4f} [{smi}]")
    fail_unless(share <= COST_SHARE_MAX, f"13b {what}: roofline share "
                f"{share:.4f} > {COST_SHARE_MAX}: the count left out work")
    return {"bound_ms": bound, "compute_ms": t_c, "memory_ms": t_m,
            "p50_ms": ms, "share": share}


def event_p50(torch, fn, calls: int) -> float:
    """p50 of ``calls`` calls of ``fn`` (CUDA events), after one warm-up."""
    fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(calls):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        fn()
        ev[1].record()
        torch.cuda.synchronize()
        ms.append(ev[0].elapsed_time(ev[1]))
    return float(np.percentile(ms, 50))


def meta_like(torch, tree):
    return tree_map(lambda t: torch.empty_like(t, device="meta"), tree)


def cost_decode(torch, smi: str) -> tuple[dict, dict]:
    """13b decode: phase 5's step (tinyllama-1.1b, bf16, batch 8, capacity
    LM_CAPACITY, decode_attention) counted on meta and on the card, timed
    uncounted.  Returns (its record, the kernels-line row)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import Model
    da = importlib.import_module("repro_torch.kernels.decode_attention")
    dev = torch.device("cuda")
    cfg = get_config(LM_ARCH).with_(use_decode_kernel=True)
    step = make_serve_step(Model(cfg))
    meta_model = Model(cfg, device="meta")
    on_meta = counted(torch, make_serve_step(meta_model), (
        meta_model.init(0), meta_model.init_cache(LM_BATCH, LM_CAPACITY),
        torch.empty((LM_BATCH, 1), dtype=torch.int32, device="meta")))
    model = Model(cfg)
    params = model.init(0)
    prompts = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (LM_BATCH, COST_PREFILL)), device=dev)
    logits, cache = model.prefill(params, {"tokens": prompts}, LM_CAPACITY)
    tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    real = sum(t.numel() * t.element_size()
               for t in leaves(params) + leaves(cache) + [tok])
    da.decode_attention.launches = 0
    on_card = counted(torch, step, (params, cache, tok))
    launches = da.decode_attention.launches
    fail_unless(launches == cfg.n_layers, f"13b decode: decode_attention "
                f"launched {launches} times in the counted step, not "
                f"{cfg.n_layers}")
    same_count(on_meta, on_card, "decode")
    fail_unless(on_card["memory"]["argument"] == real
                and on_meta["memory"]["argument"] == real,
                f"13b decode: counted argument bytes {on_meta['memory']} / "
                f"{on_card['memory']} != the tensors' {real}")
    state = {"cache": cache, "tok": tok}

    def one():
        state["tok"], state["cache"] = step(params, state["cache"],
                                            state["tok"])
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ms = event_p50(torch, one, COST_DECODE_CALLS)
    peak = torch.cuda.max_memory_allocated()
    rec = {"count": on_card, "argument_bytes_real": real,
           "launches": launches,
           "max_memory_allocated": peak, "allocated_before": base,
           **step_share(torch, on_card, ms, "decode step (batch 8, capacity "
                        f"{LM_CAPACITY}, decode_attention)", smi)}
    print(f"13b decode: counted on meta = on the card: flops "
          f"{on_card['flops']}, bytes {on_card['bytes_accessed']}, kernel "
          f"entries {on_card['kernels']}; argument bytes "
          f"{on_card['memory']['argument']} = the tensors'; counted peak "
          f"{on_card['memory']['peak']} bytes beside "
          f"torch.cuda.max_memory_allocated {peak} (what the process held "
          f"before the step: {base}) [{smi}]")
    # the kernel at this step's shape, held to its plain version
    kc = state["cache"]["k"][0].contiguous()
    vc = state["cache"]["v"][0].contiguous()
    b, s, hkv, hd = kc.shape
    q = torch.randn((b, hkv, cfg.n_heads // hkv, hd), device=dev,
                    generator=torch.Generator(dev).manual_seed(13),
                    dtype=torch.bfloat16)
    length = state["cache"]["len"] - 1
    row, _ = decode_row(torch, "decode_attention@cost13b", q, kc, vc, length,
                        launches, 20, graphed=True)
    del params, cache, state, kc, vc
    return rec, row


def cost_train(torch, report, smi: str) -> dict:
    """13b train: phase 11a's step (tinyllama-1.1b, bf16, the published
    remat "full") at REMAT_SIZE counted on meta and on the card, timed
    uncounted; the same step without remat counted on meta, its bound
    against 11a's p50 of it at this size."""
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import build_batch
    from repro_torch.models import Model
    from repro_torch.training import adamw_init
    cfg = get_config(LM_ARCH)
    model = Model(cfg)
    step = make_train_step(model)
    b, s = REMAT_SIZE
    batch = build_batch(cfg, TokenPipeline(vocab=cfg.vocab, seq_len=s,
                                           batch=b, seed=0).batch_at(0),
                        np.random.default_rng(0))
    meta_model = Model(cfg, device="meta")
    meta_params = meta_model.init(0)
    on_meta = counted(torch, make_train_step(meta_model), (
        meta_params, adamw_init(meta_params), meta_like(torch, batch)))
    none_model = Model(cfg.with_(remat="none"), device="meta")
    on_meta_none = counted(torch, make_train_step(none_model), (
        meta_params, adamw_init(meta_params), meta_like(torch, batch)))
    del meta_params
    params = model.init(0)
    opt = adamw_init(params)
    real = sum(t.numel() * t.element_size()
               for t in leaves(params) + list(leaves(opt.mu))
               + list(leaves(opt.nu)) + [opt.step] + leaves(batch))
    on_card = counted(torch, step, (params, opt, batch))
    same_count(on_meta, on_card, "train")
    fail_unless(on_card["memory"]["argument"] == real
                and on_meta["memory"]["argument"] == real,
                f"13b train: counted argument bytes {on_meta['memory']} / "
                f"{on_card['memory']} != the tensors' {real}")
    state = {"params": params, "opt": opt}
    del params, opt

    def one():
        state["params"], state["opt"], _ = step(state["params"],
                                                state["opt"], batch)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ms = event_p50(torch, one, COST_TRAIN_CALLS)
    peak = torch.cuda.max_memory_allocated()
    # what the process held past the step's arguments is not counted
    step_peak = peak - (base - real)
    rec = {"batch": b, "seq": s, "remat": cfg.remat, "count": on_card,
           "argument_bytes_real": real, "max_memory_allocated": peak,
           "allocated_before": base,
           "counted_peak_over_allocated": on_card["memory"]["peak"]
           / step_peak,
           **step_share(torch, on_card, ms, f"train step ({b} x {s}, remat "
                        f"{cfg.remat})", smi)}
    print(f"13b train ({b} x {s}, remat {cfg.remat}): counted on meta = on "
          f"the card: flops {on_card['flops']}, bytes "
          f"{on_card['bytes_accessed']}; argument bytes "
          f"{on_card['memory']['argument']} = the tensors'; counted peak "
          f"{on_card['memory']['peak']} bytes (nothing donated: the old "
          f"params and moments beside the new) beside "
          f"torch.cuda.max_memory_allocated {peak} (held before the step: "
          f"{base}, of it {base - real} past the step's arguments): "
          f"{rec['counted_peak_over_allocated']:.4f} of the step's own "
          f"{step_peak} [{smi}]")
    from repro_torch.launch.roofline import HBM_BW, compute_seconds
    none_ms = (report.get("training", {}).get("11a", {}).get("remat", {})
               .get("none", {}).get("step_ms_p50"))
    t_c = compute_seconds(on_meta_none["flops"]) * 1e3
    t_m = on_meta_none["bytes_accessed"] / HBM_BW * 1e3
    rec["none"] = {"count": on_meta_none, "bound_ms": max(t_c, t_m),
                   "compute_ms": t_c, "memory_ms": t_m, "p50_ms": none_ms,
                   "share": none_ms and max(t_c, t_m) / none_ms}
    print(f"13b train ({b} x {s}) without remat, counted on meta: flops "
          f"{on_meta_none['flops']}, bytes "
          f"{on_meta_none['bytes_accessed']}, "
          f"peak {on_meta_none['memory']['peak']}; bound "
          f"{rec['none']['bound_ms']:.4f} ms (compute {t_c:.4f}, memory "
          f"{t_m:.4f}); 11a's p50 of it "
          + ("not measured (it did not fit)" if none_ms is None else
             f"{none_ms:.2f} ms, share {rec['none']['share']:.4f}")
          + f"; with remat {cfg.remat}: bound {rec['bound_ms']:.4f} ms, "
          f"share {rec['share']:.4f} [{smi}]")
    del state, batch
    return rec


def phase_cost(torch, report):
    """Phase 13: the cost analysis.  13a the three CLIs on the host; 13b
    tinyllama's decode and train steps counted on meta and on the card
    (equal), timed uncounted against the count's roofline bound."""
    import gc
    t0 = time.perf_counter()
    out: dict = {"13a": cost_clis()}
    t1 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    smi = card_name_and_limit()
    out["decode"], row = cost_decode(torch, smi)
    gc.collect()
    torch.cuda.empty_cache()
    out["train"] = cost_train(torch, report, smi)
    gc.collect()
    torch.cuda.empty_cache()
    out["nvidia_smi"] = smi
    out["seconds"] = {"13a": t1 - t0, "13b": time.perf_counter() - t1}
    report["cost"] = out
    print(f"13: seconds 13a {out['seconds']['13a']:.1f}, 13b "
          f"{out['seconds']['13b']:.1f}")
    return [row]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the GPU", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--multihost-worker"]:
        rank, coordinator, bucket = sys.argv[2:5]
        return multihost_worker(int(rank), coordinator, int(bucket))
    if sys.argv[1:2] == ["--mesh-worker"]:
        rank, coordinator, parts = sys.argv[2:5]
        return mesh_worker(int(rank), coordinator, parts)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.checkpoint import load_arrays
    from repro_torch.compress import quantize_int8, score_error_bound
    from repro_torch.core.mapping import GamConfig, sparse_map
    from repro_torch.core.retrieval import (masked_topk, recovery_accuracy,
                                            topk_desc)
    from repro_torch.kernels import _build
    gr = importlib.import_module("repro_torch.kernels.gam_retrieve")
    gs = importlib.import_module("repro_torch.kernels.gam_score")
    tp = importlib.import_module("repro_torch.kernels.tess_project")
    from repro_torch.retriever import RetrieverSpec, open_retriever

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    report: dict = {"device": torch.cuda.get_device_name(0)}

    # ---------------------------------------------------------- 1. build
    t_start = t0 = time.perf_counter()
    libs = _build.build_all()
    for name in libs:
        _build.library(name)
    report["build_s"] = time.perf_counter() - t0
    print(f"build: {len(libs)} kernels in {report['build_s']:.2f} s "
          f"-> {_build.build_dir().relative_to(ROOT)}")

    # ---------------------------------------------------------- data
    t0 = time.perf_counter()
    items, centers = clustered_catalog(N_ITEMS, K, N_CLUSTERS, SIGMA,
                                       seed=N_ITEMS)
    reqs = requests(centers, N_REQUESTS + 1, BATCH, SIGMA, seed=0)
    cfg = GamConfig(k=K, scheme="parse_tree", threshold=THRESHOLD)
    items_t = torch.as_tensor(items, device=dev)
    tau, vals = sparse_map(items_t, cfg)
    nz = (vals != 0).cpu().numpy()
    bucket = int(np.bincount(tau.cpu().numpy()[nz], minlength=cfg.p).max())
    # the service's upserts may lengthen a list by one entry a row
    svc_bucket = bucket + SVC_MUTATE * (SVC_FRESH + SVC_REWRITE) + 64
    spec = RetrieverSpec(cfg=cfg, backend="gam-device",
                         min_overlap=MIN_OVERLAP, kappa=KAPPA, bucket=bucket)
    print(f"data: {N_ITEMS} items, p={cfg.p}, bucket={bucket} "
          f"({time.perf_counter() - t0:.1f} s)")

    # ---------------------------------------------- 2. kernels vs plain
    r0 = open_retriever(spec, items=items, device="cuda")
    fail_unless(r0.stats()["n_spill"] == 0, "bucket sized to the longest "
                "posting list must leave the spill list empty")
    meta = r0._retrieve_meta
    u0 = torch.as_tensor(reqs[1], device=dev)
    q_tau, q_mask = r0._map(u0)
    args = (u0, r0._items_dev, q_tau, q_mask, meta, KAPPA)
    kw = dict(min_overlap=MIN_OVERLAP, bq=spec.bq)
    got = gr.gam_retrieve(*args, **kw)
    torch.cuda.synchronize()
    want = gr.gam_retrieve_plain(*args, **kw)
    torch.cuda.synchronize()
    for name in ("rows", "blk_counts", "skipped"):
        fail_unless(torch.equal(getattr(got, name), getattr(want, name)),
                    f"gam_retrieve {name} differ from the plain version")
    gv, wv = got.vals.cpu().numpy(), want.vals.cpu().numpy()
    fail_unless(max_ulp(gv, wv) <= ULP, "gam_retrieve scores beyond 4 ulp")
    err_retrieve = float(np.abs(gv - wv).max())
    route = gr.retrieve_plan(BATCH, K, meta.words, KAPPA, meta.n_blocks,
                             False, dev)
    print(f"gam_retrieve vs plain ({route['route']} route, {route}): "
          f"rows/counts/skip exact, max ulp {max_ulp(gv, wv)}")
    for width in (KAPPA, WIDE_POOL):           # the fast and the wide route
        way = gr.retrieve_plan(BATCH, K, meta.words, width, meta.n_blocks,
                               False, dev)["route"]
        print(check_segment_sums(
            torch, lambda n, seg: gr.gam_retrieve(
                u0[:n], r0._items_dev, q_tau[:n], q_mask[:n], meta, width,
                segments=seg, **kw),
            BATCH, meta.n_blocks, f"gam_retrieve, kappa {width}, {way}"))

    zt = torch.where(items_t.abs() >= THRESHOLD, items_t, 0.0).contiguous()
    pat, a = tp.tess_project(zt)
    torch.cuda.synchronize()
    pat_p, a_p = tp.tess_project_plain(zt)
    torch.cuda.synchronize()
    diff = (pat != pat_p).any(dim=1).cpu().numpy()
    rows_diff = np.nonzero(diff)[0]
    excused = near_tie_rows(zt[rows_diff].cpu().numpy())
    fail_unless(excused.all(), f"tess_project rows {rows_diff[~excused][:8]} "
                "differ and are not near-ties")
    same = torch.as_tensor(~diff, device=dev)
    err_tess = float((a[same] - a_p[same]).abs().max())
    fail_unless(err_tess == 0.0, "tess_project a differs on equal patterns")
    print(f"tess_project vs plain: {int(diff.sum())} near-tie rows excused "
          f"of {N_ITEMS}")

    masks0 = r0.candidate_masks(reqs[1])
    sc = gs.gam_score(u0, r0._items_dev, masks0)
    torch.cuda.synchronize()
    sc_p = gs.gam_score_plain(u0, r0._items_dev, masks0)
    torch.cuda.synchronize()
    torch.testing.assert_close(sc, sc_p, rtol=1e-6, atol=1e-6)
    err_score = float((sc - sc_p).abs().max())
    differ_score = int((sc != sc_p).sum())
    ub, vb = u0.to(torch.bfloat16), r0._items_dev.to(torch.bfloat16)
    sc_b, sc_bp = gs.gam_score(ub, vb, masks0), gs.gam_score_plain(ub, vb,
                                                                  masks0)
    torch.testing.assert_close(sc_b, sc_bp, rtol=1e-6, atol=1e-6)
    differ_b = int((sc_b != sc_bp).sum())
    torch.cuda.synchronize()
    report["gam_score_elements_differing"] = {"f32": differ_score,
                                              "bf16": differ_b}
    print(f"gam_score vs plain: f32 max abs err {err_score}, {differ_score} "
          f"of {sc.numel()} elements differ at all (the plain version's f64 "
          f"double rounding); bf16 allclose, {differ_b} differ")
    del sc, sc_p, sc_b, sc_bp, r0

    # ------------------------------------------------------- 3. the slice
    for fn in (gr.gam_retrieve, tp.tess_project, gs.gam_score):
        fn.launches = 0
    tess_rows = Spans(torch, tp, "tess_project", sizes=True).__enter__()
    t0 = time.perf_counter()
    r = open_retriever(spec, items=items, device="cuda")
    torch.cuda.synchronize()
    report["build_catalog_s"] = time.perf_counter() - t0
    lat, answers = [], []
    fetched = (gr.fetch_answer.summed, gr.fetch_answer.full)
    for i, users in enumerate(reqs):
        t0 = time.perf_counter()
        res = r.query(users)
        dt = time.perf_counter() - t0
        if i:                                   # request 0 warms up
            lat.append(dt * 1e3)
            answers.append(res)
    fail_unless((gr.fetch_answer.summed, gr.fetch_answer.full)
                == (fetched[0] + len(reqs), fetched[1]),
                "a request without explain copied the (Q, blocks) counts")
    for users, res in zip(reqs[1:], answers):
        fail_unless(res.ids.shape == (BATCH, KAPPA), "result shape")
        fail_unless(np.isfinite(res.scores[res.ids >= 0]).all(),
                    "non-finite scores")
        masks = r.candidate_masks(users)
        o_vals, o_ids = masked_topk(torch.as_tensor(users, device=dev),
                                    r._items_dev, masks, KAPPA)
        o_vals, o_ids = o_vals.cpu().numpy(), o_ids.cpu().numpy()
        empty = o_vals <= gs.NEG / 2
        fail_unless(np.array_equal(res.ids, np.where(empty, -1, o_ids)),
                    "served ids differ from the dense oracle masked_topk")
        fail_unless(max_ulp(np.where(empty, 0, res.scores),
                            np.where(empty, 0, o_vals)) <= ULP,
                    "served scores beyond 4 ulp of the dense oracle")
        fail_unless(np.array_equal(res.n_scored,
                                   masks.sum(dim=1).cpu().numpy()),
                    "n_scored differs from the candidate masks")
    torch.cuda.synchronize()
    launches = {"gam_retrieve": gr.gam_retrieve.launches,
                "tess_project": tp.tess_project.launches,
                "gam_score": gs.gam_score.launches}
    tess_rows.__exit__()
    tess_by_rows = collections.Counter(tess_rows.rows)
    for name, n in launches.items():
        fail_unless(n > 0, f"{name} never launched on the main path")
    fail_unless(sum(tess_by_rows.values()) == launches["tess_project"],
                "tess_project calls and launches disagree")
    print(f"slice: launches {launches}; tess_project by rows "
          f"{dict(tess_by_rows)}")
    with Spans(torch, gr, "gam_retrieve") as spans:
        share = request_share(torch, lambda: r.query(reqs[1]), spans,
                              N_REQUESTS)
    report["gam_retrieve_in_request"] = share
    print(f"slice: gam_retrieve within a request: device "
          f"{share['kernel_device_ms_p50']:.4f} ms of a "
          f"{share['request_ms_p50']:.3f} ms request (CUDA events around "
          f"the launch, host clock around the request, p50 of {N_REQUESTS}),"
          f" share {share['kernel_share_p50']:.3f}")

    brute = open_retriever(RetrieverSpec(cfg=cfg, backend="brute",
                                         kappa=KAPPA), items=items,
                           device="cuda")
    recall, excused_rows = [], 0
    for i, users in enumerate(reqs[1:]):
        b = brute.query(users)
        recall.append(recovery_accuracy(answers[i].ids, b.ids).mean())
        if i < 2:
            ex = r.query(users, exact=True)
            bad = (ex.ids != b.ids).any(axis=1)
            # ids may swap only where the two top-kappa score lists agree
            # within 4 ulp of the unit dot-product scale (a near-tie)
            close = np.abs(ex.scores - b.scores) <= ULP * np.spacing(
                np.float32(1))
            fail_unless(close.all(axis=1)[bad].all(),
                        "exact=True differs from brute beyond a near-tie")
            excused_rows += int(bad.sum())
    exp = r.query(reqs[1], explain=True)
    fail_unless(np.array_equal(exp.ids, answers[0].ids),
                "explain changed the answer")
    scored_tiles = 1.0 - float(np.mean(exp.explain["blocks_skipped"])) / \
        exp.explain["n_blocks"]
    discarded = float(np.mean([res.discarded_frac.mean() for res in answers]))
    report.update(recall=float(np.mean(recall)), discarded_frac=discarded,
                  scored_tile_frac=scored_tiles,
                  p50_ms=float(np.percentile(lat, 50)),
                  p99_ms=float(np.percentile(lat, 99)), latency_ms=lat,
                  exact_vs_brute_near_tie_rows=excused_rows,
                  launches=launches)
    print(f"slice: recall@{KAPPA} vs brute {report['recall']:.4f}, "
          f"discarded {discarded:.4f}, scored tiles {scored_tiles:.4f}, "
          f"request p50 {report['p50_ms']:.3f} ms p99 {report['p99_ms']:.3f} "
          f"ms, exact=True vs brute near-tie rows {excused_rows}")

    snap = _build.build_dir() / "chip_smoke_snapshot.npz"
    r.snapshot(str(snap))
    again = open_retriever(spec, snapshot=str(snap), device="cuda").query(
        reqs[1])
    snap.unlink()
    fail_unless(np.array_equal(again.ids, answers[0].ids)
                and np.array_equal(again.scores, answers[0].scores),
                "snapshot round trip changed the answers")
    print("slice: snapshot round trip bit-identical")

    # ---------------------------------- 3b. the compressed catalog (int8)
    qspec = dataclasses.replace(spec, quantize="int8", rerank_factor=RERANK,
                                compress_postings=True)
    pool = KAPPA * RERANK
    for fn in (gr.gam_retrieve, gr.gam_retrieve_q, tp.tess_project,
               gs.gam_score):
        fn.launches = 0
    t0 = time.perf_counter()
    rq = open_retriever(qspec, items=items, device="cuda")
    torch.cuda.synchronize()
    report["build_catalog_int8_s"] = time.perf_counter() - t0
    lat_q, answers_q = [], []
    for i, users in enumerate(reqs):
        t0 = time.perf_counter()
        res = rq.query(users)
        dt = time.perf_counter() - t0
        if i:                                   # request 0 warms up
            lat_q.append(dt * 1e3)
            answers_q.append(res)
    torch.cuda.synchronize()
    launches_q = {"gam_retrieve_q": gr.gam_retrieve_q.launches,
                  "gam_retrieve": gr.gam_retrieve.launches,
                  "tess_project": tp.tess_project.launches}
    fail_unless(launches_q["gam_retrieve_q"] > 0,
                "gam_retrieve_q never launched on the compressed path")
    fail_unless(launches_q["tess_project"] > 0,
                "tess_project never launched on the compressed path")
    fail_unless(launches_q["gam_retrieve"] == 0,
                "the f32 gam_retrieve kernel ran on the compressed path")
    print(f"int8: launches {launches_q}")
    with Spans(torch, gr, "gam_retrieve_q") as spans:
        share_q = request_share(torch, lambda: rq.query(reqs[1]), spans,
                                N_REQUESTS)
    report["gam_retrieve_q_in_request"] = share_q
    print(f"int8: gam_retrieve_q within a request: device "
          f"{share_q['kernel_device_ms_p50']:.4f} ms of a "
          f"{share_q['request_ms_p50']:.3f} ms request, share "
          f"{share_q['kernel_share_p50']:.3f}")

    qmeta = rq._retrieve_meta
    padded = torch.zeros((qmeta.n_pad, K), dtype=torch.float32)
    padded[:N_ITEMS] = torch.from_numpy(rq.items)
    slab_cpu, scales_cpu = quantize_int8(padded, block=qmeta.bn)
    fail_unless(torch.equal(qmeta.factors_q.cpu(), slab_cpu),
                "the int8 slab built on the card differs from the CPU slab")
    fail_unless(torch.equal(qmeta.scales.cpu().view(torch.int32),
                            scales_cpu.reshape(1, -1).view(torch.int32)),
                "the scales built on the card differ from the CPU scales")
    print(f"int8: slab ({qmeta.n_pad} x {K} int8, {qmeta.n_blocks} scales) "
          "equals the CPU slab byte for byte")

    uq_tau, uq_mask = rq._map(u0)
    qargs = (u0, uq_tau, uq_mask, qmeta, pool)
    got_q = gr.gam_retrieve_q(*qargs, **kw)
    torch.cuda.synchronize()
    want_q = gr.gam_retrieve_q_plain(*qargs, **kw)
    torch.cuda.synchronize()
    for name in ("rows", "blk_counts", "skipped"):
        fail_unless(torch.equal(getattr(got_q, name), getattr(want_q, name)),
                    f"gam_retrieve_q {name} differ from the plain version")
    gv, wv = got_q.vals.cpu().numpy(), want_q.vals.cpu().numpy()
    fail_unless(max_ulp(gv, wv) <= ULP, "gam_retrieve_q scores beyond 4 ulp")
    err_retrieve_q = float(np.abs(gv - wv).max())
    route_q = gr.retrieve_plan(BATCH, K, qmeta.words, pool, qmeta.n_blocks,
                               True, dev)
    print(f"gam_retrieve_q vs plain ({route_q['route']} route, {route_q}): "
          f"rows/counts/skip exact, max ulp {max_ulp(gv, wv)}")
    for width in (pool, WIDE_POOL):            # the fast and the wide route
        way = gr.retrieve_plan(BATCH, K, qmeta.words, width, qmeta.n_blocks,
                               True, dev)["route"]
        print(check_segment_sums(
            torch, lambda n, seg: gr.gam_retrieve_q(
                u0[:n], uq_tau[:n], uq_mask[:n], qmeta, width, segments=seg,
                **kw),
            BATCH, qmeta.n_blocks, f"gam_retrieve_q, pool {width}, {way}"))
    # a pool past the shared-memory lists: kappa-lists in global memory
    wqargs = (u0, uq_tau, uq_mask, qmeta, WIDE_POOL)
    got_w = gr.gam_retrieve_q(*wqargs, **kw)
    torch.cuda.synchronize()
    want_w = gr.gam_retrieve_q_plain(*wqargs, **kw)
    torch.cuda.synchronize()
    for name in ("rows", "blk_counts", "skipped"):
        fail_unless(torch.equal(getattr(got_w, name), getattr(want_w, name)),
                    f"gam_retrieve_q at pool {WIDE_POOL} {name} differ from "
                    "the plain version")
    fail_unless(max_ulp(got_w.vals.cpu().numpy(),
                        want_w.vals.cpu().numpy()) <= ULP,
                f"gam_retrieve_q at pool {WIDE_POOL} scores beyond 4 ulp")
    route_w = gr.retrieve_plan(BATCH, K, qmeta.words, WIDE_POOL,
                               qmeta.n_blocks, True, dev)
    print(f"gam_retrieve_q vs plain at pool {WIDE_POOL} ({route_w['route']} "
          f"route: kappa-lists in global memory): rows/counts/skip exact")
    del got_w, want_w

    wide = gr.GAM_RETRIEVE_SMEM_KAPPA
    pool_miss, wide_miss, agree, recall_q = 0, 0, [], []
    gaps, own_err, both_err = [], [], []
    for i, users in enumerate(reqs[1:]):
        res, res32 = answers_q[i], answers[i]
        u = torch.as_tensor(users, device=dev)
        qt, qm = rq._map(u)
        pres = gr.gam_retrieve_q(u, qt, qm, qmeta, pool, **kw)
        fres = gr.gam_retrieve(u, r._items_dev, qt, qm, r._retrieve_meta,
                               KAPPA, **kw)
        fail_unless(torch.equal(pres.skipped, fres.skipped)
                    and torch.equal(pres.blk_counts, fres.blk_counts)
                    and np.array_equal(res.n_scored, res32.n_scored),
                    "the int8 path's candidates differ from the f32 path's")
        fail_unless(res.ids.shape == (BATCH, KAPPA), "int8 result shape")
        # the dense oracle, as masked_topk computes it, keeping the scores
        sc = gs.gam_score(u, rq._items_dev, rq.candidate_masks(users))
        o_vals, o_ids = topk_desc(sc, KAPPA)
        o_vals, o_ids = o_vals.cpu().numpy(), o_ids.cpu().numpy()
        empty = o_vals <= gs.NEG / 2
        o_ids = np.where(empty, -1, o_ids)

        def covers(prow):
            return ((o_ids[:, :, None] == prow[:, None, :]).any(-1)
                    | empty).all(axis=1)

        prow = pres.rows.cpu().numpy()
        covered = covers(prow)
        pool_miss += int((~covered).sum())
        # on every query: the served answer is the exact top kappa of the
        # pool's rows (scores within 4 ulp: the re-rank's f64-stepped FMA
        # may round one step apart from the kernel's)
        c_vals, c_ids = rerank_choice(torch, pres.rows, sc, KAPPA, topk_desc,
                                      gs.NEG)
        fail_unless(np.array_equal(res.ids, c_ids),
                    "the re-rank served other rows than the exact top kappa "
                    "of the pool")
        fail_unless(max_ulp(np.where(c_ids >= 0, res.scores, 0), c_vals)
                    <= ULP, "a served score is beyond 4 ulp of its exact "
                    "f32 score")
        sc_last = torch.gather(sc, 1, pres.rows[:, -1:].long().clamp(min=0))
        g, own, both = miss_gaps(
            o_vals, o_ids, prow, sc_last[:, 0].cpu().numpy(),
            score_error_bound(qmeta.scales, u).cpu().numpy(), qmeta.bn)
        gaps.append(g)
        own_err.append(own)
        both_err.append(both)
        # the widest pool the kernel takes, for sizing rerank_factor
        wide_miss += int((~covers(gr.gam_retrieve_q(
            u, qt, qm, qmeta, wide, **kw).rows.cpu().numpy())).sum())
        fail_unless(np.array_equal(res.ids[covered], o_ids[covered]),
                    "served ids differ from the dense oracle on a query "
                    "whose pool covers the oracle's top kappa")
        agree.append(float((res.ids == res32.ids).all(axis=1).mean()))
        recall_q.append(recovery_accuracy(res.ids, brute.query(users).ids)
                        .mean())
        del sc
    factor_bytes = rq.stats()["factor_bytes"]
    gaps, own_err, both_err = (np.concatenate(x)
                               for x in (gaps, own_err, both_err))
    missed_rows = {
        "n": int(gaps.size),
        "share_gap_within_own_block_bound": float(np.mean(gaps <= own_err)),
        "share_gap_within_both_blocks_bound": float(np.mean(gaps <= both_err)),
        "gap_median": float(np.median(gaps)),
        "own_block_bound_median": float(np.median(own_err))}
    report.update(int8={
        "recall": float(np.mean(recall_q)),
        "ids_agree_f32": float(np.mean(agree)),
        "pool_miss_rows": pool_miss,
        f"pool_miss_rows_at_pool_{wide}": wide_miss,
        "missed_oracle_rows": missed_rows,
        "factor_bytes": factor_bytes,
        "factor_bytes_f32": N_ITEMS * K * 4,
        "p50_ms": float(np.percentile(lat_q, 50)),
        "p99_ms": float(np.percentile(lat_q, 99)), "latency_ms": lat_q,
        "launches": launches_q})
    print(f"int8: recall@{KAPPA} vs brute {np.mean(recall_q):.4f}, ids agree "
          f"with f32 on {np.mean(agree):.4f} of queries, pool-miss rows "
          f"{pool_miss} of {N_REQUESTS * BATCH} ({wide_miss} at a pool of "
          f"{wide}), factor bytes {factor_bytes} "
          f"(f32 {N_ITEMS * K * 4}), request p50 "
          f"{report['int8']['p50_ms']:.3f} ms p99 "
          f"{report['int8']['p99_ms']:.3f} ms")
    print(f"int8: {missed_rows['n']} oracle rows missed by a pool; their "
          f"exact-score lead over the pool's last row is within their "
          f"block's int8 score-error bound on "
          f"{missed_rows['share_gap_within_own_block_bound']:.4f} of them, "
          f"within the two rows' bounds summed on "
          f"{missed_rows['share_gap_within_both_blocks_bound']:.4f} (median "
          f"lead {missed_rows['gap_median']:.3g}, median bound "
          f"{missed_rows['own_block_bound_median']:.3g})")

    snap_q = _build.build_dir() / "chip_smoke_snapshot_int8.npz"
    rq.snapshot(str(snap_q))
    stored, _ = load_arrays(str(snap_q))
    fail_unless("table_data" in stored and "factors_q" in stored
                and "table" not in stored,
                "the compressed snapshot must hold table_data and factors_q "
                "and no dense table")
    again_q = open_retriever(qspec, snapshot=str(snap_q),
                             device="cuda").query(reqs[1])
    snap_q.unlink()
    fail_unless(np.array_equal(again_q.ids, answers_q[0].ids)
                and np.array_equal(again_q.scores, answers_q[0].scores),
                "compressed snapshot round trip changed the answers")
    print("int8: compressed snapshot round trip bit-identical")

    # ---------------------------------------------------------- 4. timings
    f = 4  # bytes of f32 / int32
    words, bn = meta.words, meta.bn
    cand_rows = int(masks0.any(dim=0).sum())
    blocks = int((~got.skipped).any(dim=0).sum())
    n_cand = int(got.blk_counts.sum())
    nb, qb = meta.n_blocks, got.skipped.shape[0]
    shared_bytes = (BATCH * K * (f + 1 + f) + nb * (words * f + 1)
                    + blocks * bn * (words * f + 2) + BATCH * nb * f + qb * nb)
    retrieve_bytes = shared_bytes + cand_rows * K * f + BATCH * KAPPA * 2 * f
    # int8: k slab bytes per candidate row, one scale per kept block, pool
    # outputs; 2k operations per (query, candidate) pair and one decode
    # multiply per element of a candidate row (it does not depend on the
    # query)
    retrieve_q_bytes = (shared_bytes + cand_rows * K + blocks * f
                        + BATCH * pool * 2 * f)
    n_cand_q = int(got_q.blk_counts.sum())
    launches["gam_retrieve_q"] = launches_q["gam_retrieve_q"]
    score_bytes = BATCH * K * f + N_ITEMS * K * f + BATCH * N_ITEMS * (1 + f)
    tess_bytes = N_ITEMS * K * (f + 1 + f)
    rows = [
        ("gam_retrieve", "src/repro/kernels/gam_retrieve.py:384",
         lambda: gr.gam_retrieve(*args, **kw),
         lambda: gr.gam_retrieve_plain(*args, **kw),
         bound_ms(retrieve_bytes, 2 * K * n_cand), err_retrieve),
        ("gam_retrieve_q", "src/repro/kernels/gam_retrieve.py:444",
         lambda: gr.gam_retrieve_q(*qargs, **kw),
         lambda: gr.gam_retrieve_q_plain(*qargs, **kw),
         bound_ms(retrieve_q_bytes, 2 * K * n_cand_q + K * cand_rows),
         err_retrieve_q),
        ("tess_project", "src/repro/kernels/tess_project.py:57",
         lambda: tp.tess_project(zt), lambda: tp.tess_project_plain(zt),
         bound_ms(tess_bytes, 3 * K * N_ITEMS), err_tess),
        ("gam_score", "src/repro/kernels/gam_score.py:60",
         lambda: gs.gam_score(u0, r._items_dev, masks0),
         lambda: gs.gam_score_plain(u0, r._items_dev, masks0),
         bound_ms(score_bytes, 2 * K * int(masks0.sum())), err_score),
    ]
    # the other floors of the fused kernel, beside its bound: popcounts on
    # the CUDA cores, and the bytes of one pass and of Q / Q_t passes over
    # the kept tiles (the fast route reads each item tile once a query tile)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock = sm_clock_hz()
    kept_rows = blocks * bn
    floors = {}
    for name, width, row_bytes, plan in (
            ("gam_retrieve", KAPPA, 4 * K, route),
            ("gam_retrieve_q", pool, K, route_q)):
        one_pass = kept_rows * (words * f + 2 + row_bytes)
        passes = -(-BATCH // plan["q_tile"]) if plan["q_tile"] else BATCH
        floors[name] = {
            "route": plan,
            "popc_ms": BATCH * kept_rows * words / (16 * sms * clock) * 1e3,
            "one_pass_bytes_ms": one_pass / HBM_BYTES_PER_S * 1e3,
            "q_tile_passes_bytes_ms": passes * one_pass / HBM_BYTES_PER_S
            * 1e3}
        print(f"{name} floors at Q {BATCH}, width {width}: popcounts at 16 "
              f"a clock an SM ({sms} SMs, {clock / 1e9:.2f} GHz) "
              f"{floors[name]['popc_ms']:.4f} ms, one pass over the kept "
              f"tiles {floors[name]['one_pass_bytes_ms']:.4f} ms, {passes} "
              f"passes {floors[name]['q_tile_passes_bytes_ms']:.4f} ms; "
              f"{plan['route']} route {plan}")
    report["gam_retrieve_floors"] = floors
    kernels = []
    launches["tess_project@1M"] = tess_by_rows[N_ITEMS]
    for name, replaces, kern, plain, (b_ms, b_by), err in rows:
        src = "gam_retrieve" if name == "gam_retrieve_q" else name
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}.cu",
            "replaces": replaces,
            "launches": launches["tess_project@1M" if name == "tess_project"
                                 else name],
            "max_abs_err": err, "ms": time_ms(torch, kern, 20),
            "plain_ms": time_ms(torch, plain, 3), "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None})
        if name in ("tess_project", "gam_score"):
            kernels[-1]["graph_ms"] = graph_ms(torch, kern, calls=5, reps=5)
    kernels[-1]["yardstick_ms"] = time_ms(torch, lambda: matmul_where(
        torch, u0, r._items_dev, masks0), 20)
    for row in kernels[2:]:
        print(f"{row['name']} at the slice's shape: {row['launches']} "
              f"launches, {row['ms']:.4f} ms, in a CUDA graph "
              f"{row['graph_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}), plain {row['plain_ms']:.3f} ms"
              + (f", matmul + where (two calls) {row['yardstick_ms']:.4f} ms"
                 if "yardstick_ms" in row else ""))
    # the exact re-rank is torch code, not a kernel: its share of a request
    report["int8"]["rerank_ms"] = time_ms(
        torch, lambda: gr.rerank_pool(got_q, u0, rq._items_dev, KAPPA), 20)
    # the int8 kernel's time against its pool width (kappa-list insertions);
    # past the shared-memory lists (pool > 128) they live in global memory
    report["int8"]["kernel_ms_by_pool"] = {
        w: time_ms(torch, lambda w=w: gr.gam_retrieve_q(
            u0, uq_tau, uq_mask, qmeta, w, **kw), 20)
        for w in (KAPPA, pool, wide, WIDE_POOL)}
    print("int8: gam_retrieve_q ms by pool width: " + ", ".join(
        f"{w}: {ms:.4f}" for w, ms in
        report["int8"]["kernel_ms_by_pool"].items()))
    phase_s = {"1-4": time.perf_counter() - t_start}

    def lap(name):
        phase_s[name] = time.perf_counter() - t_start - sum(phase_s.values())

    # ------------------------------- 3c. the paper's inverted index
    del rq, got, got_q, masks0, items_t, zt
    phase_gam_index(torch, report, items, reqs, spec, answers, brute)
    lap("3c")
    del r, brute
    torch.cuda.empty_cache()

    # ------------------------------------------- 5. / 5b. LM serving
    keep: dict = {}

    kernels += phase_lm(torch, report, keep)
    lap("5")
    kernels += phase_gam_head(torch, report, keep)
    lap("5b")

    # ------------------------------------- 6. / 6b. the service tier
    kernels += phase_service(torch, report, items, centers, cfg, svc_bucket)
    lap("6")
    phase_service_int8(torch, report, items, centers, cfg, svc_bucket)
    lap("6b")

    # ------------------------------------------- 7. the last two kernels
    kernels += phase_new_kernels(torch, report, keep)
    lap("7")
    del keep

    # ---------------------------------------------- 8. the learning loop
    kernels += phase_learning(torch, report)
    lap("8")

    # ------------------------------------------- 9. multi-host serving
    kernels += phase_multihost(torch, report, svc_bucket)
    lap("9")

    # ------------------------------------------ 10. the other LM families
    kernels += phase_families(torch, report)
    lap("10")

    # ------------------------------------------------ 11. LM training
    kernels += phase_training(torch, report)
    lap("11")

    # --------------------------------------- 12. over a device mesh
    kernels += phase_mesh(torch, report)
    lap("12")

    # ------------------------------------------- 13. cost analysis
    kernels += phase_cost(torch, report)
    lap("13")
    report["phase_s"] = phase_s
    print("phase seconds: " + ", ".join(f"{k} {v:.1f}"
                                        for k, v in phase_s.items()))
    report["kernels"] = kernels
    report["nvidia_smi"] = card_name_and_limit()
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(report["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
