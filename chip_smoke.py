"""Smoke test of the PyTorch + CUDA port on one GPU: kernels, then the main path.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py [--seed N]

It builds the hand-written kernels from ``lshrs_tpu_torch/csrc`` with nvcc
(at first use, into ``build/lshrs_tpu_torch/``, one compiler per source),
then runs these phases and prints JSON lines as it goes:

1. the card (nvidia-smi name and power limit) and the kernel build time;
2. each kernel (B1, B2, B3) against its plain PyTorch version on the card,
   bit-exact (``torch.equal``; tolerance 0: every output is an integer
   key), at the main path's shapes (B1 also at the gather rerank's
   C=2**20, Q=256; B2 also at the 1M serving batch, Q=8192, at P=512 with
   group 128, and at 30 bits padded to 32 columns; B3 on random full
   words and on the store's words at ``word_bits`` = rows_per_band, 16 x
   16 and 32 x 8, at Q=1, 17 and 512, streamed at BW=32 and 64, and at
   the packed_4m batch, Q=8192 over 2**22 slots, where it must also equal
   B2 on the same words' planes), ragged query counts, dead slots and
   every template instantiation; and the Hamming tail's kernel
   (hamming_refine_topk: gather, popcount and top-k of the selected
   groups) in hamming and ids, at the benchmark cells' shape (Q=10,000,
   10 groups of 64 slots, 8 narrow words, top-10) with 2**21- and
   2**23-scale ties (int64 keys), at k=1, 100 and 128 (padded), the
   8,192-candidate limit, groups 16 to 128 and 1 to 64 words; the
   plain references of later phases take the plain tail (their paths
   launch the kernel); and the group selection's kernel (group_select:
   the m largest group maxima a row) against ``torch.topk``, its keys bit
   for bit and its indices distinct, at both benchmark cells' widths
   (Q=10,000 over 18,493, 65,536 and 34,464 groups), the cascade's
   128-group pool, m at its limit of 256, Q=1 and 3 and a width below 4;
3. the 100k slice: ``LSHRS(dim=768, num_perm=256, num_bands=16,
   rows_per_band=16)`` indexes 100,000 seeded gaussian vectors and serves
   them through ``serving_fn(top_k=10)`` (collision engine, kernel B1):
   self-match must be 1.0, and the store carried to a ``device="cpu"``
   store must return the same ids for the same query words;
4. the 1M slice: the same constructor over 2**20 clustered vectors, where
   ``engine="auto"`` switches to Hamming ranking (kernel B2), with the
   same checks;
5. the packed_4m slice: ``hamming_storage="packed"`` over 2**22 clustered
   vectors (the largest capacity whose packed key fits int32 at 256
   bits), ranked by kernel B3 with no bitplanes allocated: self-match
   1.0, ids and distances equal to the bitplane path (kernel B2) and to
   the plain versions on the same store words; the peak memory of one
   8,192-query batch at most the planes batch's plus the query operand
   (never a (C, K) array); then 1% of the ids are deleted and none may
   come back;
6. times: each kernel against its plain version (median CUDA-event ms)
   and its bound (the least time the card could take: operations at their
   peak rate or bytes at the HBM rate, whichever is larger; B3 counted
   as the int8 product it runs, 2 * Q * C * K; the refine by the bytes
   it must read), B2 and B3 also against
   ``torch._int_mm`` on the same +-1 operands (the library yardstick,
   never called by the port), B3 beside B2 on the same words' planes,
   serving QPS at 100k, 1M and 4M (packed, and planes on the same
   words), a torch.profiler breakdown of the serving batches (device time
   by kernel, device-busy share), and the 100k build rate;
7. the lifecycle at 100k: ``save_to_disk`` then
   ``load_from_disk(device="cuda")`` returns the same ids, and
   ``delete`` then ``compact`` keeps self-match of the survivors at 1.0;
8. top-p cosine rerank (``store_vectors=True``). At 100k with a float32
   payload (``rerank_engine="auto"`` resolves to the full engine):
   self-match through ``serving_fn(mode="topp")`` (top-1 is the vector,
   its cosine within 1e-5 of 1), 256 queries against the store carried to
   the CPU (ids equal but for swaps of neighbours whose cosines differ by
   < 1e-5, cosines within 1e-5, candidate counts equal),
   ``get_above_p_batch`` equal to serving, ``get_above_p`` /
   ``query(top_k=None)`` one query at a time, and serving QPS of the full
   and the gather engine in turns. At 2**20 clustered vectors
   (the 1M slice's data) with an int8 payload: the full and the gather
   engine (kernel B1) on 1,024 queries — gather equal to full on every
   query it proves exact, both equal to the store carried to the CPU on
   64 of them (256 until phase 18 needed the time), recall@10 of each against exact float32
   cosine at least 0.70 — then serving QPS of each engine at Q=1024 and 8192 in turns and a
   profile of one 8192-query batch each; last, at 100k, delete 1,000 ids
   and compact (no deleted id comes back) and save / load with the
   payload (the same top-p ids);
9. the hash families, multi-probe and ``where=`` filters (phase 2 also
   holds B1 bit-exact at ``probes`` 2 and 4 and at 32 band words, at
   131,072 slots and at the shapes the 2**20-slot paths launch: 256-query
   gather slices with 4 probes and with 32 band words, and the 8,192-query
   top-k batch at 32 band words):
   - hash parity on the card: structured (16 x 16) and cross-polytope
     (32 x 8) words of 65,536 x 768 vectors from ``hash_batch_words``
     (CUDA), the first 16,384 of them (65,536 until phase 18 needed the
     time) == ``hash_batch_words_host`` (the native C FWHT, which must
     have loaded) == the NumPy FWHT; probe words host == device at T=4;
     hash times beside the gaussian matmul's;
   - structured_1m: ``LSHRS(hash_family="structured")`` over the 2**20
     clustered vectors with ``hash_mode="host"`` (planes and packed) and
     ``hash_mode="device"``: build rates, auto -> Hamming on B2 / B3,
     self-match 1.0, ids equal to a CPU copy on 256 queries, the three
     indexes equal to each other, serving QPS at Q=8192;
   - multi-probe: 100k gaussian vectors with ``multiprobe`` 2 and 4 (B1
     launched with that many probes, ids equal to a CPU copy, self-match
     1.0, every T=1 hit's count <= its count under T probes, QPS beside
     T=1), and the 1M int8 top-p gather engine with ``multiprobe=4``
     (recall@10 not below T=1's; top-k and top-p of 64 queries equal to
     a CPU copy: 256 until phase 13 needed the time);
   - cross-polytope: 32 bands x 8 rows at 2**20 slots with an int8 payload
     (collision top-k on B1 at 32 band words, top-p gather, self-match,
     card == CPU copy, recall@10, QPS; ``engine="hamming"`` raises);
   - filters: an allowlist of 10% of the ids minus a denylist of 1,000 at
     100k (B1), 1M planes (B2) and 1M packed (B3): no inadmissible id,
     ids equal to a CPU copy under the same filter (64 queries on the
     packed store, whose filtered B3 keys are also held to the plain
     version on the card) and to brute force over the admitted subset, the
     filter's state cached and recomputed
     after a delete, filtered top-p on both engines, filtered QPS;
   - save / ``load_from_disk(device="cuda")`` of a structured and two
     cross-polytope indexes (``diagonals.npz``; multiprobe 2 and 4).

10. asymmetric ranking and the refinement cascade (phase 2 also holds B2
    bit-exact at both asymmetric wires' packings, offset 32512 / shift 5
    and 1792 / 1, at Q=512 and the 8,192-query serving batch, and at the
    cascade's coarse shape, P=128 at C=2**22 and 2**23, at Q=512 and at
    the store's query slices, and times B2 at the asymmetric and coarse
    shapes beside ``torch._int_mm``; each path must launch B2 at its own
    packing, counted by ``(width, offset, shift)``):
    - asymmetric_1m: ``serving_fn(mode="asymmetric")`` on the 1M planes
      index with both coordinate wires: self-match 1.0, dots and ids ==
      a CPU copy of the store (256 queries) and == the plain B2 plus the
      same refine on the card (64 queries), ``where=`` with phase 9's
      filter (no inadmissible id; == the CPU copy under the same filter;
      against brute force over the admitted subset: equal, or within the
      shifted key's granularity), recall@10
      against the exact-cosine truth of phase 8 beside symmetric Hamming
      (asymmetric must not be lower), QPS per wire and a profile;
    - cascade_4m: ``hamming_cascade=128, hamming_cascade_refine=8192`` fed
      the packed_4m store's words: 0.5 GiB of prefix planes (1 GiB for
      full planes), ids == the plain B2 plus the same refine (64 queries),
      == the exact planes engine when the pool covers a 2**16-slot store,
      planted recall@10 and agreement@10 with the exact planes engine,
      QPS in turns with it;
    - cascade_8m: 2**23 clustered vectors drawn on the card, past the int32
      key ceiling (the refine keys in int64): capacity 2**23, self-match
      1.0, ids == the plain B2 plus the same refine (64 queries), a 1%
      delete (no deleted id returned, survivors' self-match 1.0), planted
      recall@10, build rate, QPS and a profile.

11. the bucketed engine, in-place retuning and MIPS (no new kernel: the
    reference computes the bucket search, the rehash and the augmentation
    in plain ``jnp``):
    - bucket_100k: ``query_mode="bucket"`` over the 100k words, held to
      the scan (kernel B1) on the same words: equal ids and counts when no
      bucket run overflowed (otherwise each rank's count at most the
      scan's), self-match 1.0, ``query_batch`` QPS of both in turns at
      Q=1,024 and 16,384, a profile; the same on the 1M clustered words
      under ``engine="collision"`` (B1 at 2**20 slots), overflows printed;
    - retune_1m_int8: phase 8's 2**20 int8-payload index rehashed to 32 x 8
      (seconds, rows/s), then ``retrain()`` (host fit and rehash seconds):
      top-p gather recall@10 against phase 8's truth beside 16 x 16's,
      self-match 1.0, top-k through Hamming (B2) on the rebuilt planes;
    - mips_100k: ``similarity="dot"`` over 100k vectors with norms in
      [0.5, 2]: top-p scores == float64 inner products (error within 1e-4
      of ``|q| * max_norm``), == a CPU copy on the same words, recall@10
      of top-p and top-k (B1) against the brute-force inner-product
      top-10, QPS beside the cosine 100k top-p in turns;
    - retune_100k: a 100k float32-payload index rehashed to the structured
      family (words == the native C and NumPy FWHT of the vectors; a strict
      closure taken before raises stale, an ``auto_refresh=True`` one
      serves a fresh closure's ids after the rehash and after a 1,000-id
      delete), then to 32 x 8: B1 at ``(32, 1)``, top-k and top-p == a CPU
      copy on the same words, rehash seconds.

12. bulk ingestion and the bucket backends (no new kernel: the reference
    validates, loads, hashes and counts buckets in NumPy and Python; all
    four use ``LSHRS(dim=768, num_perm=256, num_bands=16,
    rows_per_band=16)``, top-10):
    - ingest_1m: phase 4's 2**20 clustered vectors (drawn again from the
      seed) through ``create_signatures(format="numpy", batch_size=65536,
      prefetch=2)`` in turns with ``index()`` of the same batches: build
      seconds and vectors/s, the CPU count and whether the two-stage
      pipeline ran (observed on its worker), equal ``state_arrays()``,
      Hamming ranking through B2 with self-match 1.0 and the ids of phase
      4's index on the same batches, a profiled build (device-busy and
      upload shares); then ``hash_mode="host"`` (the worker hashes), its
      words == ``hash_batch_dense_host`` of the batches appended by
      ``add_signature_batch``;
    - files_100k: phase 3's 100k vectors in a ``.npy`` and in a ``.npz``
      with ids ``7*i + 3`` (a temporary directory), loaded by
      ``create_signatures(format="npy"|"npz")``: each store == ``index()``
      of the same batches, served ids are the file's, B1, self-match 1.0;
    - custom_storage_100k: ``LSHRS(storage=DeviceStore(device="cuda"),
      device="cpu")``: backend "device", the hasher on the store's device,
      ids == files_100k's;
    - memory_100k: ``backend="memory"`` through ``create_signatures``
      against its device twin (``hash_mode="host"``, collision, B1) on 256
      queries: top-10 and ``top_k=None`` in order, under phase 9's
      allowlist, with ``multiprobe=2``, top-p through ``vector_fetch_fn``
      (scores within 1e-6); a 1,000-id delete (none comes back); build
      seconds and ``query_batch`` QPS of both at Q=1,024.
    Parquet, Postgres and Redis are not on the card (no pyarrow, psycopg
    or Redis server there); the CPU tests hold them.

13. sharding: ``ShardedDeviceStore`` over a mesh that repeats the one card
    four times (phase 2 also holds B1 at a 100k store's 32,768-row shard, a
    1M store's 2**18-row gather slices and the 16,384-slot restored
    checkpoint; B2 at a 2**22-row shard for Q=1,024 and 8,192, at both
    asymmetric wires' shifts of a 2**18-row shard, at the coarse pass of
    2**20- and 2**14-row shards; B3 at a 2**20-row shard for Q=256; and
    times B2 at the 2**22-row shard, Q=8,192):
    - sharded_parity_4m, right after cascade_4m: the 100k words in four
      shards (B1), packed_4m's words in four planes shards (B2) and four
      packed shards (B3): ids and counts / distances == the unsharded
      stores (B1, and the B2 and B3 engines), each kernel launched once per
      shard; a four-shard cascade (128-bit prefix, an 8,192-slot pool per
      shard) on the 4M words: agreement@10 with the exact engine and
      planted recall, and == the exact engine where the pool covers each
      shard (2**16 slots); each store == its CPU copy (four CPU shards,
      ``state_arrays()`` carried; 256 queries at 100k, 16 on the 4M planes
      and cascade stores, 4 on the packed one: plain B3 on the CPU takes
      ~1.8 s a query at 2**22 slots);
    - sharded_16m, right after cascade_8m: 2**24 clustered vectors drawn on
      the card into ``LSHRS(storage=ShardedDeviceStore(...))`` (four shards
      of 2**22 rows, ~10 GB; the unsharded single-pass engines stop at
      2**22 slots): self-match 1.0, B2 once per shard per batch, planted
      recall@10 beside cascade_8m's, QPS at Q=8192 in turns with
      cascade_8m's closure, one shard's B2 ms, build rate, a profile, a 1%
      delete (no deleted id returned);
    - sharded_topp_1m: a four-shard copy of phase 8's 1M int8 store: the
      full engine == the unsharded full engine, the gather engine (B1 per
      shard) == it on every query it proves exact, == a CPU copy (16);
    - sharded_asymmetric_1m: a four-shard copy of the 1M planes store, both
      coordinate wires: self-match 1.0 on 8,192 stored rows, B2 once per
      shard at the shard's shift, == a CPU copy (256 queries);
    - sharded_checkpoint, last: ``LSHRS(shards=4, device="cpu")`` over 10,000
      vectors, saved and loaded with ``device="cuda"``: unsharded, with the
      reference's warning, the same ids.

14. the chunked fallbacks (plain PyTorch, no kernel: the reference's are
    plain ``jnp``), which rank what the grouped engines cannot:
    - exact_8m, right after sharded_16m: cascade_8m's 2**23 words (taken
      before its delete) through ``add_signature_batch`` into
      ``LSHRS(engine="auto")`` on planes (B2 in two 2**22-slot blocks,
      merged) and a ``hamming_storage="packed"`` twin (chunked), past the
      int32 key ceiling: self-match 1.0; planes == packed ==
      a two-shard copy (2**22-row shards ranked by B2 / B3, merged exactly)
      on 1,024 planted queries; the chunked cores called on the 1M store's
      tensors == its grouped B2 engine bit for bit; planted recall@10
      beside cascade_8m's and cascade_8m's agreement@10 with exact ranking;
      QPS at Q=8192 in turns with cascade_8m (B2 launched on planes only,
      B3 never); a profile per storage; a 1% delete (no deleted id returned);
      memory;
    - bands128_100k, after topp_lifecycle_100k: that index rehashed to
      128 x 2 = 256 bits (the chunked collision core at 131,072 slots):
      self-match 1.0 of its first 32,768 alive rows (all 99,000 until
      phase 18 needed the time), == a CPU copy on 256 queries, QPS
      at Q=16,384 beside the 16 x 16 B1 cell's; top-p resolves ``auto`` to
      the full engine (a pinned gather raises), its recall@10 against
      exact float32 cosine beside 16 x 16's; then a 16-slot store
      (``chunk_size=16``, ``initial_capacity=16``, below the group): its
      answer, self-match, == a CPU copy.

15. bench_smoke, last: ``bench_cuda.main(["--smoke"])``, the port's
    benchmark at its smoke size on the card (every configuration, its own
    checks: self-match 1.0, packed == planes, each row's kernel launched);
    its exit code must be 0 and its one stdout line is emitted here.

16. recall_capacity_smoke, last: ``benchmarks/torch_capacity_bench.py
    --smoke`` (2**14 and 2**23 slots: the grouped exact engine on B2, the
    chunked exact engine with no kernel, cascade128 and cascade64 on B2's
    coarse packings) and ``benchmarks/torch_recall_bench.py --smoke``
    (16,384 clustered vectors at the five sweep bandings 64 x 4 to 4 x 64:
    B1 at 64, 32, 16 and 8 band words in the ``<64, 1, 1>``, ``<32, 1,
    1>``, ``<16, 1, 1>``, ``<8, 1, 1>`` and ``<8, 2, 1>`` instantiations,
    with 2 probes, B2 on the Hamming and asymmetric columns), each with
    its own checks; both must exit 0 (phase 2 also holds B1 at every
    sweep banding at C=2**20, Q=512, and B2 at the capacity bench's
    coarse packings, P=128 and 64, up to 2**24 slots).

17. profiles_smoke, last: the five stage profiles at ``--smoke``
    (``benchmarks/torch_kernel_profile.py``, ``torch_hamming_profile.py``,
    ``torch_cascade_profile.py``, ``torch_ingest_profile.py``,
    ``torch_gather_rerank_bench.py``), each with its own checks (the
    stages composed == the core == the store's closure, exact launch
    counts per row); all must exit 0, B1 must launch (the collision
    profile, the gather engine) and B2 at 256 columns and at the
    cascade64 coarse packing.

18. serving_benches_smoke, last: the five serving benches at ``--smoke``
    (``benchmarks/torch_asymmetric_bench.py``, ``torch_scale_bench.py``,
    ``torch_rerank_bench.py``, ``torch_auto_engine_bench.py``,
    ``torch_cp_bench.py``), each with its own checks (self-match 1.0 where
    its reference measures it, ids in range, each timed batch's launches
    exact); all must exit 0 and print their row. B1 must launch at 16 and
    32 band words (``<16, 1, 1>``: the scale bench's scan; ``<32, 1, 1>``:
    the cross-polytope collision), B2 at the symmetric key (the default
    index past 2**19 slots) and at the int8 wire's asymmetric packing
    (offset 32,512, shift 5 at 2**20 slots). Phase 2 also holds B1 and B2
    at the shapes these smokes and the scripts' full runs launch.

19. maintenance_benches_smoke, last: the four maintenance benches at
    ``--smoke`` (``benchmarks/torch_rehash_bench.py``: 65,536 rows built
    at 16 x 16, three in-place rehashes ending at 32 x 8, the self-match
    of 1,024 stored rows; ``torch_ingest_bench.py``: 2**17 dense-wire rows
    appended, no kernel; ``torch_sharded_build_bench.py``: one word stream
    into one store and into 8 shards of 8,192 rows on the card, the spot
    check of 4 queries; ``torch_ab_serving.py``: flat against blockwise
    group selection on the 2**17-slot store, 1,024-query batches), each
    with its own checks (self-match 1.0, stored words == the wire's host
    decode, single == sharded ids, flat == blockwise ids, each stage's
    launches exact); all must exit 0 and print their row. B1 must launch
    at 32 band words (``<32, 1, 1>``: the self-match) and at 16 (``<16,
    1, 1>``: the spot check and the A/B). Phase 2 also holds B1 at the
    shapes these smokes and the scripts' full runs launch.

20. bandings, last: the bandings users get past the powers of two, with
    the device hash. ``LSHRS(dim=768, num_perm=384,
    similarity_threshold=0.6)`` (auto-tuned to 48 x 8, ``store_vectors``,
    ``rerank_engine="gather"``) indexes 131,072 seeded gaussian vectors:
    top-k at Q=1,024 through ``query_batch`` and ``serving_fn`` (B1 at 48
    band words), a gather top-p batch; the default ``LSHRS(dim=768,
    multiprobe=2)`` (8 x 16 with two probes) indexes the same vectors:
    top-k. Each index: self-match 1.0 (top-p: cosine 1 within 1e-5), ids
    (and top-p cosines within 1e-5) == the store carried to the CPU on 64
    queries; B1 must launch at ``<48, 1, 1>`` and ``<8, 1, 2>``. Phase 2
    holds B1 at this phase's shapes and times it at the six bandings
    ``benchmarks/torch_b1_probe.py`` measures (48 x 8, 24 x 8, 12 x 16, 8 x
    16 with 2 probes, 16 x 16 with 3, 32 bands of two words) at C=2**20,
    Q=512.

Every launch counter is reset just before each path of phases 3-5 and 7-20
and read just after it; each path must launch its kernel, and its
``launches`` line carries the path's seconds. Then it prints the script's
seconds, the nvidia-smi line, one JSON line with the kernels (launches,
error, ms, plain, bound and library ms; B1 once per timed instantiation
(its launches counted over every phase, phase 19's included),
and per recall-sweep banding at 2**20 slots the main path launched, B2
once more per phase-10 packing, at sharded_16m's shard, on B3's timed
words and at the cascade64 coarse packing (phases 16 and 17), B3 once more at the
packed_4m batch; B2's asymmetric entry counts phase 18's launches at
its packing too), and last ``{"ok": true, "device":
{...}}``. Any failed check raises, so the script
exits non-zero without that last line; it also exits non-zero when no
CUDA device is available.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import itertools
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

DIM, NUM_PERM, NUM_BANDS, ROWS = 768, 256, 16, 16
TOP_K = 10
N_100K = 100_000
N_1M = 1 << 20
N_4M = 1 << 22
N_8M = 1 << 23
INGEST_BATCH = 1 << 16
QPS_BATCH_100K = 16384
QPS_BATCH_1M = 8192
CARRY_QUERIES = 256
TOPP_BATCH_100K = 1024
TOPP_QUERIES = 1024
TOPP_QPS_BATCHES_1M = (1024, 8192)
# recall@10 of top-p against exact float32 cosine on the 1M clustered data
# with an int8 payload: measured 0.7459 for both engines on an H100 (seed 0).
RECALL_FLOOR_1M = 0.70
DEVICE = "cuda"
# Peak rates of one H100 SXM at its 700 W limit, for each kernel's bound:
# int8 tensor cores and HBM from NVIDIA's data sheet; int32 ALU lanes per
# clock per SM at the 1.98 GHz boost clock.
H100_INT8_OPS = 1.979e15
H100_HBM_BYTES = 3.35e12
H100_INT32_OPS = 64 * 132 * 1.98e9
# The kernels' wrappers in lshrs_tpu_torch.ops.group_max: B1, B2, B3.
KERNELS = ("group_max_keys", "hamming_group_max_keys", "hamming_packed_group_max_keys")
B1, B2, B3 = KERNELS
# The Hamming tail's kernel (lshrs_tpu_torch.ops.hamming): the group rows'
# gather, the popcount and the exact top-k of the candidates in one launch.
REFINE = "hamming_refine_topk"
# Its cases (Q, m, group, nw, k, C, tie bits), each held bit for bit to its
# plain version on the card; the named ones are timed, each a line of the
# kernels record. The benchmark cells' shape at glove100.batch's 2**21
# slots and at a wiki6m4.batch block (2**22 slots of the 2**23-slot store's
# ties: int64 keys), ann-benchmarks' k=100, the 8,192-candidate limit and
# word-aligned words.
REFINE_TIMED = {
    (10_000, 10, 64, 8, 10, 1 << 21, 21): REFINE,
    (10_000, 10, 64, 8, 10, 1 << 22, 23): f"{REFINE}@wiki_block",
    (10_000, 100, 64, 8, 100, 1 << 21, 21): f"{REFINE}@k100",
    (2_048, 64, 128, 8, 128, 1 << 21, 21): f"{REFINE}@limit",
    (10_000, 10, 64, 16, 10, 1 << 21, 21): f"{REFINE}@aligned",
}
# The group selection's kernel (lshrs_tpu_torch.ops.scan.group_select,
# counted on select_top_groups): the m largest of a row's group maxima.
SELECT = "group_select"
# Its timed cases (Q, groups, m), each a line of the kernels record and
# held to torch.topk: glove100.batch's selection and wiki6m4.batch's two
# blocks'.
SELECT_TIMED = {
    (10_000, 18_493, 10): SELECT,
    (10_000, 65_536, 10): f"{SELECT}@wiki_block0",
    (10_000, 34_464, 10): f"{SELECT}@wiki_block1",
}
# Checked, not timed: the cascade's 128-group pool at 2**22 slots, m at
# the limit over a ragged last tile, single rows (Q=1 and 3), and a width
# below one 16-byte load.
SELECT_CHECKED = [(2_048, 65_536, 128), (1_000, 3 * 4096 + 5, 256), (1, 65_536, 10),
                  (3, 18_493, 10), (7, 3, 3)]
# Checked, not timed: the 1M serving batch, the cascade's 128-group pool
# at 2**23 slots (int64 keys), k past the candidates (padding), k=1,
# groups of 16 and 32, one word, the widest 64 words, a ragged Q.
REFINE_CHECKED = [
    (QPS_BATCH_1M, 10, 64, 8, 10, N_1M, 20),
    (2_048, 128, 64, 8, 10, 1 << 23, 23),
    (1_000, 1, 64, 8, 128, 1 << 16, 16),
    (1_000, 10, 64, 8, 1, 1 << 16, 16),
    (1_000, 40, 16, 8, 10, 1 << 16, 16),
    (1_000, 20, 32, 1, 10, 1 << 16, 16),
    (300, 100, 64, 64, 100, 1 << 18, 18),
    (777, 10, 64, 8, 10, 1 << 21, 21),
]
# B1's timed multi-probe and 32-word cases (num_bands, words, C, Q, probes),
# each one a line of the kernels record.
B1_VARIANTS = {
    (16, 1, 131072, 1024, 2): "group_max_keys@bw16_probes2",
    (16, 1, 131072, 1024, 4): "group_max_keys@bw16_probes4",
    (32, 1, 131072, 1024, 1): "group_max_keys@bw32_probes1",
    (32, 1, 131072, 1024, 2): "group_max_keys@bw32_probes2",
    (32, 1, 131072, 1024, 4): "group_max_keys@bw32_probes4",
}
# B1 at the shapes the 2**20-slot paths launch it with, timed beside the
# table above: the gather rerank's 256-query slices.
B1_TIMED_1M = {
    (16, 1, N_1M, 256, 1): "group_max_keys@gather_1m",
    (16, 1, N_1M, 256, 4): "group_max_keys@gather_1m_probes4",
    (32, 1, N_1M, 256, 1): "group_max_keys@gather_1m_bw32",
}
# B1 at the recall sweep's bandings at 2**20 slots and its 512-query batch
# (num_bands, words, C, Q, probes): 64 x 4 in the <64, 1, 1> registers, 32
# x 8 (with 4 probes too), 16 x 16, 8 x 32 and 4 x 64 (<8, 2, 1>). Each is
# timed; the instantiations the main path launches are lines of the
# kernels record, by their template <BW, W, P>.
B1_RECALL_1M = {
    (64, 1, N_1M, 512, 1): "group_max_keys@recall_1m_64x4",
    (32, 1, N_1M, 512, 1): "group_max_keys@recall_1m_32x8",
    (32, 1, N_1M, 512, 4): "group_max_keys@recall_1m_32x8_probes4",
    (16, 1, N_1M, 512, 1): "group_max_keys@recall_1m_16x16",
    (8, 1, N_1M, 512, 1): "group_max_keys@recall_1m_8x32",
    (4, 2, N_1M, 512, 1): "group_max_keys@recall_1m_4x64",
}
# B1 at the bandings users get past the powers of two (num_bands, words,
# C, Q, probes): the auto-tuner's 48 x 8 (num_perm=384, t=0.6), 24 x 8 and
# 12 x 16 (num_perm=192 at t=0.7 and 0.5), the default 8 x 16 with
# multiprobe=2, 16 x 16 with multiprobe=3 and 32 bands of two words, at
# 2**20 slots and Q=512. Each is timed; those the main path launches
# (phase 20: 48 x 8 and 8 x 16 with 2 probes) are lines of the kernels
# record, by their shape <BW, W, P>.
B1_BANDINGS_1M = {
    (48, 1, N_1M, 512, 1): "group_max_keys@bandings_48x8",
    (24, 1, N_1M, 512, 1): "group_max_keys@bandings_24x8",
    (12, 1, N_1M, 512, 1): "group_max_keys@bandings_12x16",
    (8, 1, N_1M, 512, 2): "group_max_keys@bandings_8x16_probes2",
    (16, 1, N_1M, 512, 3): "group_max_keys@bandings_16x16_probes3",
    (32, 2, N_1M, 512, 1): "group_max_keys@bandings_32x2words",
}
# Phase 20: vectors per index, its top-k batch and its CPU-copy queries.
N_BANDINGS = 1 << 17
BANDINGS_BATCH = 1024
BANDINGS_CPU_QUERIES = 64
# Plain B1 holds a (Q, C) int32 key matrix: past this many elements it is
# run over slices of the queries.
B1_PLAIN_ELEMENTS = 1 << 28
CP_BANDS, CP_ROWS = 32, 8
HASH_ROWS = 1 << 16
# Rows of hash_parity's host comparisons (the native C and NumPy FWHT;
# the host cross-polytope hash runs ~5k rows/s): all 65,536 until the
# script with phase 18 passed 850 s on a slow host.
HASH_HOST_ROWS = 1 << 14
# Queries of topp_1m's CPU copy (CARRY_QUERIES until phase 18 needed the time).
TOPP_CPU_QUERIES = 64
# Alive rows of bands128_100k's self-match (all of them until phase 18).
BANDS128_SELF_ROWS = 1 << 15
FILTER_DENY = 1000
PACKED_CPU_QUERIES = 64
# The cascade of the reference's 4M bench row: a 128-bit prefix, an
# 8,192-slot refine pool (bench.py's "cascade128:8192").
CASCADE_BITS, CASCADE_REFINE = 128, 8192
PLANTED = 1024
PLAIN_QUERIES = 64
# Queries of probe_and_cp_1m's CPU copies (256 until phase 13 needed the time).
PROBE_CPU_QUERIES = 64
# Queries of phase 13's CPU copies of 2**20- and 2**22-slot sharded stores;
# the packed one takes fewer (plain B3 on the CPU costs ~1.8 s a query there).
SHARDED_CPU_QUERIES = 16
SHARDED_PACKED_CPU_QUERIES = 4
# Phase 13: shards on the one card (the mesh repeats it), the 2**24-slot
# cell, the 100k store's capacity, the full-pool cascade's slots.
SHARDS = 4
N_16M = 1 << 24
N_100K_SHARD = (1 << 17) // SHARDS
SMALL_CASCADE = 1 << 16
B2_SHARDED_16M = "hamming_group_max_keys@sharded_16m"
# B3 at the packed_4m serving batch, B3 on random full 32-bit words (K =
# 512), and B2 on the same store words' planes as B3's timed cases.
B3_PACKED_4M = "hamming_packed_group_max_keys@packed_4m"
B3_FULL_WORDS = "hamming_packed_group_max_keys@full_words_k512"
B2_B3_WORDS = {N_1M: "hamming_group_max_keys@b3_words_1m",
               N_4M: "hamming_group_max_keys@b3_words_4m"}
# B2 at the key packings of phase 10, timed at Q=512: (C, P, qmax or None
# for the cascade's coarse pass) -> the kernels line's name.
B2_TIMED_NEW = {
    (N_1M, NUM_PERM, 127): "hamming_group_max_keys@asymmetric_1m",
    (N_4M, CASCADE_BITS, None): "hamming_group_max_keys@cascade_coarse_4m",
    (N_8M, CASCADE_BITS, None): "hamming_group_max_keys@cascade_coarse_8m",
}
# The capacity bench's cascade64 prefix; its coarse pass at 2**23 slots
# (phase 16) is timed at Q=512 too.
CASCADE64_BITS = 64
B2_CASCADE64_8M = "hamming_group_max_keys@cascade64_coarse_8m"
# The asymmetric serving bench's batch at its defaults (phase 18 runs its
# smoke; phase 2 holds B2 at both).
ASYMMETRIC_BENCH_BATCH = 16384


def b2_packings() -> dict:
    """B2's key packings ``(operand width, offset, shift)`` on phase 10's
    paths: the asymmetric wires on the 1M store (offset ``P * qmax``,
    shift 5 and 1 at 2**20 slots) and the cascade's coarse pass over the
    128-column prefix (the symmetric offset and shift); on phase 13's: the
    symmetric 256-bit key and the asymmetric wires at a 2**18-row shard's
    shift; on phase 16's: the cascade64 coarse pass over the 64-column
    prefix."""
    from lshrs_tpu_torch.ops.group_max import asymmetric_shift

    return {
        "asymmetric_int8": (NUM_PERM, NUM_PERM * 127, asymmetric_shift(NUM_PERM, N_1M)),
        "asymmetric_int4": (NUM_PERM, NUM_PERM * 7, asymmetric_shift(NUM_PERM, N_1M, qmax=7)),
        "cascade_coarse": (CASCADE_BITS, CASCADE_BITS, 1),
        "cascade64_coarse": (CASCADE64_BITS, CASCADE64_BITS, 1),
        "symmetric": (NUM_PERM, NUM_PERM, 1),
        "sharded_asymmetric_int8": (NUM_PERM, NUM_PERM * 127,
                                    asymmetric_shift(NUM_PERM, N_1M // SHARDS)),
        "sharded_asymmetric_int4": (NUM_PERM, NUM_PERM * 7,
                                    asymmetric_shift(NUM_PERM, N_1M // SHARDS, qmax=7)),
    }


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def card_label() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def kernel_bound(name: str, shape: dict) -> tuple[float, str]:
    """The least time (ms) the H100 could take for a kernel's work at
    ``shape``, and what sets it: the larger of the operations at their peak
    rate and the bytes (each input read once, the output written once) at
    the HBM rate."""
    c, q = shape["C"], shape["Q"]
    if name.startswith("group_max_keys"):
        # B1: one compare per band word per probe. Each is an ISETP on the
        # int32 ALU; the count's predicated add issues on the FMA pipe, and
        # the two together take two of a sub-partition's one issue a clock,
        # the same floor as the ALU's 16 lanes.
        bw, probes = shape["bands"], shape["probes"]
        ops, rate = q * c * probes * bw, H100_INT32_OPS
        nbytes = 4 * (bw * c + c + q * probes * bw + q * (c // 64))
    elif name.startswith(REFINE):
        # Every candidate's words and tie, the picked ids, the group
        # indices, the query words and the output, once; a POPC a word, on
        # a quarter of the int32 lanes.
        m, group, nw, k = shape["m"], shape["group"], shape["nw"], shape["k"]
        ops, rate = q * m * group * nw, H100_INT32_OPS / 4
        nbytes = q * (4 * m * group * (nw + 1) + 8 * m + 4 * nw + 12 * k)
    elif name.startswith(SELECT):
        # One compare a key; each key read once, the indices written once
        # ("C" is the row's groups here).
        ops, rate = q * c, H100_INT32_OPS
        nbytes = 4 * q * c + 8 * q * shape["m"]
    elif name.startswith("hamming_group_max_keys"):  # B2: int8 multiply-adds
        from lshrs_tpu_torch.ops.hamming import plane_width

        p, width = shape["P"], plane_width(shape["P"])
        ops, rate = 2 * q * c * p, H100_INT8_OPS
        nbytes = c * width + 4 * c + q * width + 4 * q * (c // shape["group"])
    else:  # B3: the same int8 +-1 product as B2, K = BW * word_bits padded to 32
        from lshrs_tpu_torch.ops.hamming import plane_width

        bw = shape["BW"]
        ops, rate = 2 * q * c * plane_width(bw * shape["word_bits"]), H100_INT8_OPS
        nbytes = 4 * (bw * c + c + q * bw + q * (c // shape["group"]))
    op_ms, byte_ms = ops / rate * 1e3, nbytes / H100_HBM_BYTES * 1e3
    return (op_ms, "operations") if op_ms >= byte_ms else (byte_ms, "bytes")


def median_ms(fn, *, reps: int = 10) -> float:
    """Median CUDA-event time of ``fn()`` after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


class RunningTruth:
    """Exact float32 cosine top-``depth`` of fixed queries over row batches
    on the card (TF32 is off), merged batch by batch; its seconds are kept
    apart so a timed build can leave them out."""

    def __init__(self, q: np.ndarray, depth: int = TOP_K):
        qt = torch.from_numpy(q).to(DEVICE)
        self.qn = qt / torch.linalg.vector_norm(qt, dim=1, keepdim=True)
        self.best = torch.full((len(q), depth), -2.0, device=DEVICE)
        self.ids = torch.zeros((len(q), depth), dtype=torch.int64, device=DEVICE)
        self.seconds = 0.0

    def add(self, x: torch.Tensor, off: int) -> None:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        xn = x / torch.linalg.vector_norm(x, dim=1, keepdim=True)
        depth = self.best.shape[1]
        v, i = torch.topk(self.qn @ xn.T, depth, dim=1)
        v, j = torch.topk(torch.cat([self.best, v], 1), depth, dim=1)
        self.ids = torch.cat([self.ids, i + off], 1).gather(1, j)
        self.best = v
        torch.cuda.synchronize()
        self.seconds += time.perf_counter() - t0

    def truth(self) -> np.ndarray:
        return self.ids.cpu().numpy()


def b1_inputs(rng, *, bw, c, q, probes, dev):
    """Store words from a 4-letter alphabet (so counts spread over 0..B),
    planted full matches, ~10% dead slots; probe t > 0 flips bit t-1 of
    probe 0, keeping a band's probes pairwise distinct."""
    from lshrs_tpu_torch.ops.scan import global_tie_core

    sig = rng.integers(0, 4, (bw, c), dtype=np.int32)
    ids = rng.permutation(c).astype(np.int32)
    ids[rng.random(c) < 0.1] = -1
    q0 = rng.integers(0, 4, (q, bw), dtype=np.int32)
    planted = rng.integers(0, c, q // 4)
    q0[: q // 4] = sig[:, planted].T
    qw = np.concatenate([q0 ^ (np.int32(1) << t) if t else q0 for t in range(probes)], 1)
    sig_t = torch.from_numpy(sig).to(dev)
    tie = global_tie_core(torch.from_numpy(ids).to(dev))
    return sig_t, tie, torch.from_numpy(np.ascontiguousarray(qw)).to(dev)


def b2_inputs(rng, *, c, p, q, asymmetric, dev):
    """+-1 planes and queries (or quantised asymmetric queries), zero-padded
    to the store's plane width, as the store holds them; ~10% dead slots."""
    from lshrs_tpu_torch.ops.hamming import plane_width
    from lshrs_tpu_torch.ops.scan import global_tie_core

    pad = ((0, 0), (0, plane_width(p) - p))
    planes = (2 * rng.integers(0, 2, (c, p), dtype=np.int8) - 1).astype(np.int8)
    ids = rng.permutation(c).astype(np.int32)
    ids[rng.random(c) < 0.1] = -1
    if asymmetric:
        qb = rng.integers(-127, 128, (q, p), dtype=np.int16).astype(np.int8)
    else:
        qb = planes[rng.integers(0, c, q)].copy()
        qb[q // 2 :] *= np.where(rng.random((q - q // 2, p)) < 0.2, -1, 1).astype(np.int8)
    return (
        torch.from_numpy(np.pad(planes, pad)).to(dev),
        global_tie_core(torch.from_numpy(ids).to(dev)),
        torch.from_numpy(np.pad(qb, pad)).to(dev),
    )


def b2_inputs_on_card(gen, *, c, p, q, qmax, dev):
    """B2's operands and key arguments at phase 10's packings, drawn on the
    card: +-1 planes, ~10% dead slots; quantised coordinates in
    ``[-qmax, qmax]`` with the asymmetric offset and shift of a ``c``-slot
    store, or stored rows with ~20% of their bits flipped, under the
    cascade's coarse scale and shifted tie (``qmax=None``) or the symmetric
    key (``qmax=0``)."""
    from lshrs_tpu_torch.ops.group_max import asymmetric_shift, key_scale
    from lshrs_tpu_torch.ops.hamming import cascade_coarse_scale
    from lshrs_tpu_torch.ops.scan import global_tie_core

    # drawn as int8: an int64 draw of 2**24 x 128 would take 16 GiB
    planes = torch.randint(0, 2, (c, p), generator=gen, device=dev, dtype=torch.int8) * 2 - 1
    ids = torch.randperm(c, generator=gen, device=dev).to(torch.int32)
    ids[torch.rand(c, generator=gen, device=dev) < 0.1] = -1
    tie = global_tie_core(ids)
    if not qmax:  # None: the cascade's coarse pass; 0: symmetric Hamming
        pick = torch.randint(0, c, (q,), generator=gen, device=dev)
        flip = torch.rand((q, p), generator=gen, device=dev) < 0.2
        qb = torch.where(flip, -planes[pick], planes[pick]).contiguous()
        kw = dict(group=64, scale=key_scale(c), num_perm=p)
        if qmax is None:
            scale, tie_shift = cascade_coarse_scale(p, c)
            tie = torch.where(tie >= 0, tie >> tie_shift, tie)
            kw["scale"] = scale
    else:
        qb = torch.randint(-qmax, qmax + 1, (q, p), generator=gen, device=dev).to(torch.int8)
        kw = dict(group=64, scale=key_scale(c), num_perm=p, offset=p * qmax,
                  shift=asymmetric_shift(p, c, qmax=qmax))
    return planes, tie, qb, kw


def cascade_path_queries(c: int, batch: int = QPS_BATCH_1M, refine: int = CASCADE_REFINE) -> list[int]:
    """Query counts of the coarse B2 launches that one ``batch``-query
    batch makes on a ``c``-slot cascade store (or shard) with a
    ``refine``-slot pool: its full slices and the ragged last one (the
    store's slicing, with the narrow refine rows it keeps at 16 x 16)."""
    from lshrs_tpu_torch.ops.bitpack import narrow_words_count
    from lshrs_tpu_torch.ops.hamming import cascade_slice_queries

    step = cascade_slice_queries(c, group=64, pool_groups=min(refine, c) // 64,
                                 words=narrow_words_count(NUM_BANDS, ROWS))
    return sorted({min(step, batch), batch % step} - {0})


def b3_inputs(rng, *, bw, c, q, dev):
    """Full 32-bit store words (so num_perm = 32 * BW), ~10% dead slots;
    half the queries are stored slots with ~10% of their bits flipped."""
    from lshrs_tpu_torch.ops.scan import global_tie_core

    sig = rng.integers(-(2**31), 2**31, (bw, c), dtype=np.int64).astype(np.int32)
    ids = rng.permutation(c).astype(np.int32)
    ids[rng.random(c) < 0.1] = -1
    qw = rng.integers(-(2**31), 2**31, (q, bw), dtype=np.int64).astype(np.int32)
    flips = (rng.random((q // 2, bw, 32)) < 0.1).astype(np.int64) << np.arange(32)
    qw[: q // 2] = sig[:, rng.integers(0, c, q // 2)].T ^ flips.sum(-1).astype(np.uint32).view(np.int32)
    return (
        torch.from_numpy(sig).to(dev),
        global_tie_core(torch.from_numpy(ids).to(dev)),
        torch.from_numpy(qw).to(dev),
    )


def b3_words_on_card(gen, *, bw, word_bits, c, q, dev):
    """Store words drawn on the card: ``word_bits`` random low bits per
    word (a band of ``word_bits`` rows; 32: full words), ~10% dead slots;
    half the queries are stored slots with ~10% of those bits flipped."""
    from lshrs_tpu_torch.ops.scan import global_tie_core

    def draw(*shape):
        w = torch.randint(-(2**31), 2**31, shape, generator=gen, device=dev, dtype=torch.int64)
        w = w & ((1 << word_bits) - 1) if word_bits < 32 else w
        return w.to(torch.int32)

    sig_t = draw(bw, c)
    ids = torch.randperm(c, generator=gen, device=dev).to(torch.int32)
    ids[torch.rand(c, generator=gen, device=dev) < 0.1] = -1
    qw = draw(q, bw)
    h = q // 2
    pick = torch.randint(0, c, (h,), generator=gen, device=dev)
    bit = torch.arange(word_bits, device=dev, dtype=torch.int64)
    flip = (torch.rand((h, bw, word_bits), generator=gen, device=dev) < 0.1).to(torch.int64)
    flips = (flip << bit).sum(-1) & 0xFFFFFFFF
    flips = torch.where(flips >= 2**31, flips - 2**32, flips).to(torch.int32)
    qw[:h] = sig_t[:, pick].T ^ flips
    return sig_t.contiguous(), global_tie_core(ids), qw.contiguous()


def check_b2_packings(gen, dev, err: dict, timed: dict) -> None:
    """Phase 2's B2 checks at phase 10's key packings; adds to ``err`` and
    ``timed`` as :func:`phase_kernels` does."""
    from lshrs_tpu_torch.ops.group_max import hamming_group_max_keys, hamming_group_max_keys_ref

    # Phase 10's packings: the asymmetric int8 and int4 wires at 2**20
    # slots, and the cascade's coarse pass at 2**22 and 2**23 slots (drawn
    # on the card: 1 GiB of planes at 2**23), each at the timed Q=512 and at
    # the query counts its path launches: the whole serving batch for the
    # asymmetric wires, the store's query slices (and the last, ragged one)
    # for the coarse pass. Then the capacity bench's coarse passes (phase 16
    # and its full run): P=128 and 64 at 2**17 slots (--smoke at 2**14
    # rows, 256-query batches), 2**22, 2**23 and 2**24 slots (its 12.5M
    # rows; 2 GiB of planes at P=128), at its batches' slices. The plain
    # version runs over query slices of at most 2**31 keys.
    for c, p, qmax, smoke_q in [
        # the asymmetric bench's int8 wire at its smoke batch and its
        # defaults' (phase 18)
        (N_1M, NUM_PERM, 127, [1024, ASYMMETRIC_BENCH_BATCH]), (N_1M, NUM_PERM, 7, None),
        (N_4M, CASCADE_BITS, None, None), (N_8M, CASCADE_BITS, None, 256),
        (1 << 17, CASCADE_BITS, None, 256), (1 << 17, CASCADE64_BITS, None, 256),
        (N_4M, CASCADE64_BITS, None, None), (N_8M, CASCADE64_BITS, None, 256),
        (N_16M, CASCADE_BITS, None, None), (N_16M, CASCADE64_BITS, None, None),
        # phase 17's smoke sizes: the cascade profile's coarse pass and the
        # Hamming profile's symmetric key over 2**16 slots, 1,024 queries
        (1 << 16, CASCADE64_BITS, None, 1024), (1 << 16, NUM_PERM, 0, 1024),
        # phase 18: the default index's smoke, 2**19 slots (auto -> Hamming)
        (1 << 19, NUM_PERM, 0, 1024),
    ]:
        qs = [512, QPS_BATCH_1M] if qmax else [512, *cascade_path_queries(c)]
        if smoke_q:
            qs += smoke_q if isinstance(smoke_q, list) else [smoke_q]
        planes, tie, qb, kw = b2_inputs_on_card(gen, c=c, p=p, q=max(qs), qmax=qmax, dev=dev)
        step = min(256, (1 << 31) // c)
        for q in qs:
            got = hamming_group_max_keys(planes, tie, qb[:q], **kw)
            diff, ok = 0, True
            for s in range(0, q, step):
                want = hamming_group_max_keys_ref(planes, tie, qb[s : min(q, s + step)], **kw)
                diff = max(diff, int((got[s : s + step].long() - want.long()).abs().max()))
                ok = ok and torch.equal(got[s : s + step], want)
            torch.cuda.synchronize()
            err["hamming_group_max_keys"] = max(err["hamming_group_max_keys"], diff)
            emit("kernel_check", kernel="hamming_group_max_keys", C=c, P=p, Q=q, group=64,
                 qmax=qmax, offset=kw.get("offset"), shift=kw.get("shift", 1),
                 scale=kw["scale"], equal=ok, max_abs_err=diff)
            if not ok:
                raise AssertionError(f"B2 kernel != plain at C={c}, P={p}, Q={q}, qmax={qmax}")
            del got, want
        name = B2_TIMED_NEW.get((c, p, qmax))
        if (c, p, qmax) == (N_8M, CASCADE64_BITS, None):
            name = B2_CASCADE64_8M
        if name:
            q512 = qb[:512]
            timed[name] = (
                lambda a=(planes, tie, q512), kw=kw: hamming_group_max_keys(*a, **kw),
                lambda a=(planes, tie, q512), kw=kw: hamming_group_max_keys_ref(*a, **kw),
                dict(C=c, Q=512, P=p, group=64),
                lambda planes=planes, qb=q512: torch._int_mm(qb, planes.t()),
            )
        del planes, tie, qb


def check_b2_shards(gen, dev, err: dict, timed: dict) -> None:
    """Phase 2's B2 checks at phase 13's per-shard shapes (C is one
    shard's rows): sharded_16m's symmetric key at 2**22 rows for its planted
    and serving batches, asymmetric_1m's both wires at the shift of a
    2**18-row shard, the 4M cascade's coarse pass per 2**20-row shard and
    the full-pool cascade's per 2**14-row shard, each at the query counts
    its path launches. Times the 2**22-row shard at Q=8192."""
    from lshrs_tpu_torch.ops.group_max import hamming_group_max_keys, hamming_group_max_keys_ref

    for c, p, qmax, qs in [
        (N_16M // SHARDS, NUM_PERM, 0, [PLANTED, QPS_BATCH_1M]),
        (N_1M // SHARDS, NUM_PERM, 127, [QPS_BATCH_1M]),
        (N_1M // SHARDS, NUM_PERM, 7, [QPS_BATCH_1M]),
        (N_4M // SHARDS, CASCADE_BITS, None, cascade_path_queries(N_4M // SHARDS, PLANTED)),
        (SMALL_CASCADE // SHARDS, CASCADE_BITS, None,
         cascade_path_queries(SMALL_CASCADE // SHARDS, CARRY_QUERIES, SMALL_CASCADE // SHARDS)),
    ]:
        planes, tie, qb, kw = b2_inputs_on_card(gen, c=c, p=p, q=max(qs), qmax=qmax, dev=dev)
        for q in qs:
            got = hamming_group_max_keys(planes, tie, qb[:q], **kw)
            want = hamming_group_max_keys_ref(planes, tie, qb[:q], **kw)
            torch.cuda.synchronize()
            diff = int((got.long() - want.long()).abs().max())
            ok = torch.equal(got, want)
            err[B2] = max(err[B2], diff)
            emit("kernel_check", kernel=B2, C=c, P=p, Q=q, group=64, qmax=qmax,
                 offset=kw.get("offset"), shift=kw.get("shift", 1), scale=kw["scale"],
                 path="sharded", equal=ok, max_abs_err=diff)
            if not ok:
                raise AssertionError(f"B2 kernel != plain at shard C={c}, P={p}, Q={q}, qmax={qmax}")
            del got, want
        if (c, qmax) == (N_16M // SHARDS, 0):
            timed[B2_SHARDED_16M] = (
                lambda a=(planes, tie, qb), kw=kw: hamming_group_max_keys(*a, **kw),
                lambda a=(planes, tie, qb), kw=kw: hamming_group_max_keys_ref(*a, **kw),
                dict(C=c, Q=QPS_BATCH_1M, P=p, group=64), None,
            )
        else:
            del planes, tie, qb


def refine_inputs(gen, *, q, m, group, nw, c, tie_bits, dev):
    """A grouped refine table of ``c`` random ``nw``-word slots on the card
    (distinct ids, ties ``2**tie_bits - 1 - rank`` of the id, ~5% dead),
    ``m`` distinct groups a query, and queries near a slot of their first
    group: ``(qcmp, sig_rows, top_groups)``."""
    ng = c // group
    words = torch.randint(-(2**31), 2**31, (c, nw), dtype=torch.int64, device=dev,
                          generator=gen).to(torch.int32)
    ids = torch.randperm(c, device=dev, generator=gen).to(torch.int32)
    rank = torch.empty_like(ids)
    rank[ids.argsort()] = torch.arange(c, dtype=torch.int32, device=dev)
    tie = (1 << tie_bits) - 1 - rank
    tie = torch.where(torch.rand(c, device=dev, generator=gen) < 0.05, -1, tie)
    rows = torch.cat([words, tie[:, None], ids[:, None]], dim=1)
    rows = rows.reshape(ng, group, nw + 2).transpose(1, 2).reshape(ng, (nw + 2) * group)
    top = torch.rand(q, ng, device=dev, generator=gen).topk(m, dim=1).indices
    slot = top[:, 0] * group + torch.randint(0, group, (q,), device=dev, generator=gen)
    noise = torch.randint(-(2**31), 2**31, (3, q, nw), dtype=torch.int64, device=dev,
                          generator=gen).to(torch.int32)
    qcmp = words[slot] ^ (noise[0] & noise[1] & noise[2])
    return qcmp.contiguous(), rows.contiguous(), top.contiguous()


def check_refine(gen, dev, err: dict, timed: dict) -> None:
    """Phase 2's checks of kernel hamming_refine_topk against its plain
    version at :data:`REFINE_TIMED` and :data:`REFINE_CHECKED`, hamming and
    ids bit for bit; adds to ``err`` and ``timed`` as :func:`phase_kernels`
    does."""
    from lshrs_tpu_torch.ops.hamming import hamming_refine_topk, hamming_refine_topk_ref

    for case in [*REFINE_TIMED, *REFINE_CHECKED]:
        q, m, group, nw, k, c, tie_bits = case
        args = refine_inputs(gen, q=q, m=m, group=group, nw=nw, c=c, tie_bits=tie_bits, dev=dev)
        kw = dict(group=group, p=32 * nw, k=k, scale=1 << tie_bits)
        got = hamming_refine_topk(*args, **kw)
        torch.cuda.synchronize()
        want = hamming_refine_topk_ref(*args, **kw)
        diff = int((got[0].long() - want[0].long()).abs().max())
        ok = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        err[REFINE] = max(err[REFINE], diff)
        emit("kernel_check", kernel=REFINE, Q=q, m=m, group=group, nw=nw, k=k, C=c,
             tie_bits=tie_bits, equal=ok, max_abs_err=diff)
        if not ok:
            raise AssertionError(f"{REFINE} kernel != plain at {case}")
        if case in REFINE_TIMED:
            timed[REFINE_TIMED[case]] = (
                lambda a=args, kw=kw: hamming_refine_topk(*a, **kw),
                lambda a=args, kw=kw: hamming_refine_topk_ref(*a, **kw),
                dict(C=c, Q=q, m=m, group=group, nw=nw, k=k, tie_bits=tie_bits), None,
            )
        del args, got, want


def check_select(gen, dev, err: dict, timed: dict) -> None:
    """Phase 2's checks of kernel group_select against ``torch.topk`` at
    :data:`SELECT_TIMED` and :data:`SELECT_CHECKED`, on B2-shaped keys
    (``scaled * 2**21 + tie``): the keys bit for bit, the indices distinct;
    adds to ``err`` and ``timed`` as :func:`phase_kernels` does."""
    from lshrs_tpu_torch.ops.scan import group_select

    for q, ng, m in [*SELECT_TIMED, *SELECT_CHECKED]:
        scaled = torch.randint(100, 160, (q, ng), dtype=torch.int32, device=dev, generator=gen)
        tie = torch.randint(0, 1 << 21, (q, ng), dtype=torch.int32, device=dev, generator=gen)
        keys = (scaled << 21) + tie
        got = group_select(keys, m)
        torch.cuda.synchronize()
        want = torch.topk(keys, m, dim=1).values
        picked = keys.gather(1, got)
        diff = int((picked.long() - want.long()).abs().max())
        srt = got.sort(dim=1).values
        ok = torch.equal(picked, want) and bool((srt[:, 1:] != srt[:, :-1]).all())
        err[SELECT] = max(err[SELECT], diff)
        emit("kernel_check", kernel=SELECT, Q=q, groups=ng, m=m, equal=ok, max_abs_err=diff)
        if not ok:
            raise AssertionError(f"{SELECT} kernel != torch.topk at {(q, ng, m)}")
        if (q, ng, m) in SELECT_TIMED:
            timed[SELECT_TIMED[q, ng, m]] = (
                lambda keys=keys, m=m: group_select(keys, m),
                lambda keys=keys, m=m: torch.topk(keys, m, dim=1),
                dict(C=ng, Q=q, m=m), lambda keys=keys, m=m: torch.topk(keys, m, dim=1),
            )
        del scaled, tie, got, want, picked


@contextlib.contextmanager
def plain_refine():
    """Inside the block the grouped tail takes its plain stages on the card:
    the selection ``torch.topk`` (kernel group_select's limits refuse every
    call) and the Hamming refine's plain stages (likewise
    hamming_refine_topk's); neither kernel may launch, so a comparison
    counts no launch of the path."""
    from lshrs_tpu_torch.ops import hamming as hamming_mod
    from lshrs_tpu_torch.ops import scan as scan_mod

    real = hamming_mod.refine_kernel_fits, scan_mod.select_kernel_fits
    before = hamming_mod.hamming_refine_topk.launches, scan_mod.select_top_groups.launches
    hamming_mod.refine_kernel_fits = lambda **_: False
    scan_mod.select_kernel_fits = lambda m, ng: False
    try:
        yield
    finally:
        hamming_mod.refine_kernel_fits, scan_mod.select_kernel_fits = real
    after = hamming_mod.hamming_refine_topk.launches, scan_mod.select_top_groups.launches
    assert after == before, f"the plain tail launched a kernel: {before} -> {after}"


def check_b3(sig_t, tie, qw, kw, err: dict) -> float:
    """Kernel B3 against its plain version on the card, bit-exact (the
    plain version over query slices of at most 2**33 / C rows); adds to
    ``err``; returns the plain version's CUDA-event ms over all slices."""
    from lshrs_tpu_torch.ops.group_max import (
        hamming_packed_group_max_keys,
        hamming_packed_group_max_keys_ref,
        packed_width,
    )

    (bw, c), q = sig_t.shape, qw.shape[0]
    got = hamming_packed_group_max_keys(sig_t, tie, qw, **kw)
    step = max(1, (1 << 33) // c)
    diff, ok = 0, True
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for s in range(0, q, step):
        want = hamming_packed_group_max_keys_ref(sig_t, tie, qw[s : s + step], **kw)
        diff = max(diff, int((got[s : s + step].long() - want.long()).abs().max()))
        ok = ok and torch.equal(got[s : s + step], want)
    end.record()
    end.synchronize()
    err[B3] = max(err[B3], diff)
    wb = kw.get("word_bits", 32)
    emit("kernel_check", kernel=B3, BW=bw, C=c, Q=q, group=kw["group"], word_bits=wb,
         K=packed_width(bw, wb), equal=ok, max_abs_err=diff)
    if not ok:
        raise AssertionError(f"B3 kernel != plain at BW={bw}, C={c}, Q={q}, {kw}")
    return start.elapsed_time(end)


def time_b3(name, sig_t, tie, qw, kw, timed: dict, *, b2_name=None, plain_ms=None) -> None:
    """B3's timed entry: the kernel, its plain version (or the ms its check
    took, for a plain version of tens of seconds) and, where the (Q, C)
    int32 product fits (2 GiB at Q=512, C=2**20), ``torch._int_mm`` of the
    two +-1 operands (built before, not timed). With ``b2_name``, also B2
    on the same words' planes (the symmetric key) as its own entry."""
    from lshrs_tpu_torch.ops.group_max import (
        hamming_group_max_keys,
        hamming_group_max_keys_ref,
        hamming_packed_group_max_keys,
        hamming_packed_group_max_keys_ref,
        packed_operand,
    )

    (bw, c), q = sig_t.shape, qw.shape[0]
    wb = kw.get("word_bits", 32)
    qop = packed_operand(qw, word_bits=wb)
    sop = torch.cat([packed_operand(sig_t[:, s : s + (1 << 20)].T, word_bits=wb)
                     for s in range(0, c, 1 << 20)])
    library = None
    if q * c <= 1 << 29:
        library = lambda qop=qop, sop=sop: torch._int_mm(qop, sop.t())  # noqa: E731
    timed[name] = (
        lambda a=(sig_t, tie, qw), kw=kw: hamming_packed_group_max_keys(*a, **kw),
        plain_ms if plain_ms is not None
        else lambda a=(sig_t, tie, qw), kw=kw: hamming_packed_group_max_keys_ref(*a, **kw),
        dict(C=c, Q=q, BW=bw, group=kw["group"], word_bits=wb), library,
    )
    if b2_name:
        # At n = BW * word_bits = P the symmetric B2 key on the planes is
        # B3's key: the two kernels must agree on the same words.
        b2kw = dict(group=kw["group"], scale=kw["scale"], num_perm=kw["num_perm"])
        same = torch.equal(hamming_group_max_keys(sop, tie, qop, **b2kw),
                           hamming_packed_group_max_keys(sig_t, tie, qw, **kw))
        emit("kernel_check", kernel=B2, compared_with=B3, C=c, Q=q, P=kw["num_perm"],
             word_bits=wb, equal=same)
        if not same:
            raise AssertionError(f"B2 on the planes != B3 on the words at C={c}, Q={q}")
        timed[b2_name] = (
            lambda a=(sop, tie, qop), kw=b2kw: hamming_group_max_keys(*a, **kw),
            lambda a=(sop, tie, qop), kw=b2kw: hamming_group_max_keys_ref(*a, **kw),
            dict(C=c, Q=q, P=kw["num_perm"], group=kw["group"]), library,
        )


def phase_kernels(rng, dev) -> dict:
    """Phase 2: every kernel against its plain version, bit-exact; returns
    the worst |kernel - plain| per kernel and the timed cases."""
    from lshrs_tpu_torch.ops.group_max import (
        asymmetric_shift,
        group_max_keys,
        group_max_keys_ref,
        hamming_group_max_keys,
        hamming_group_max_keys_ref,
        key_scale,
    )

    err = {name: 0 for name in (*KERNELS, REFINE, SELECT)}
    timed = {}
    b1_cases = [  # (num_bands, words, C, Q, probes)
        (16, 1, 131072, 1024, 1),
        (16, 1, 131072, 1024, 2),
        (16, 1, 131072, 1000, 1),  # ragged Q: not a multiple of 128
        (4, 3, 16384, 200, 1),     # three-word bands: the generic instantiation
        (16, 1, N_1M, 256, 1),     # the gather rerank's slice at 1M slots
        (16, 1, N_1M, 200, 1),     # ragged
        (16, 1, 131072, 1024, 4),  # multi-probe, registers <16, 1, 4>
        (32, 1, 131072, 1024, 1),  # 32 band words (cross-polytope at dim 768)
        (32, 1, 131072, 1024, 2),
        (32, 1, 131072, 1024, 4),
        (32, 1, 131072, 1000, 4),  # ragged
        (16, 2, 131072, 1024, 4),  # two-word bands, probes over two lanes
        (8, 1, 16384, 200, 5),     # five probes over five lanes
        (16, 1, N_1M, 256, 4),     # multiprobe4_1m: the gather rerank's slice
        (16, 1, N_1M, 200, 4),     # ragged
        (32, 1, N_1M, 256, 1),     # cp_1m: the gather rerank's slice
        (32, 1, N_1M, 200, 1),     # ragged
        (32, 1, N_1M, QPS_BATCH_1M, 1),  # cp_1m: the top-k serving batch
        (16, 1, N_100K_SHARD, CARRY_QUERIES, 1),  # sharded_parity: a 100k store's shard
        (16, 1, N_1M // SHARDS, 256, 1),  # sharded top-p gather: a 1M store's shard
        (16, 1, 16384, CARRY_QUERIES, 1),  # sharded checkpoint restored unsharded
        *B1_RECALL_1M,  # the recall sweep's bandings at 2**20 slots
        *B1_BANDINGS_1M,  # the bandings past the powers of two
        # phase 20: top-k batches, ragged, the CPU copies' queries and the
        # gather engine's 256-query slices at 48 x 8; 8 x 16 with 2 probes
        (48, 1, N_BANDINGS, BANDINGS_BATCH, 1),
        (48, 1, N_BANDINGS, 1000, 1),
        (48, 1, N_BANDINGS, BANDINGS_CPU_QUERIES, 1),
        (48, 1, N_BANDINGS, 256, 1),
        (8, 1, N_BANDINGS, BANDINGS_BATCH, 2),
        (8, 1, N_BANDINGS, BANDINGS_CPU_QUERIES, 2),
        (16, 1, 131072, 256, 1),   # the gather rerank bench's slices (phase 17)
        (16, 1, 1 << 16, 256, 1),  # and at its smoke size
        # the serving benches (phase 18): the scale bench's scan at its
        # smoke size and at its defaults (and the default index's
        # --engine collision there), the cross-polytope collision likewise
        (16, 1, 1 << 16, 1024, 1),
        (16, 1, N_1M, QPS_BATCH_1M, 1),
        (32, 1, 1 << 14, 1024, 1),
        (32, 1, 1 << 17, QPS_BATCH_1M, 1),
        # the maintenance benches (phase 19) at their defaults and smoke
        # sizes: the rehash's 1,024-query self-match at 32 band words, the
        # sharded build's 4-query spot check on the single store and on
        # one of its 8 shards, and the A/B's 16,384-query batches (its
        # smoke's 1,024 are held above)
        (32, 1, N_1M, 1024, 1),
        (32, 1, 1 << 16, 1024, 1),
        (16, 1, N_1M, 4, 1),
        (16, 1, 1 << 17, 4, 1),
        (16, 1, 1 << 16, 4, 1),
        (16, 1, 1 << 13, 4, 1),
        (16, 1, 131072, 16384, 1),
    ]
    # The collision profile's store groups 32 slots (phase 17): its full
    # shape and its smoke size, checked but not timed.
    b1_group32 = [(16, 1, 131072, 1024, 1), (16, 1, 1 << 14, 256, 1)]
    for (nb, w, c, q, probes), group in [*((case, 64) for case in b1_cases),
                                         *((case, 32) for case in b1_group32)]:
        sig_t, tie, qw = b1_inputs(rng, bw=nb * w, c=c, q=q, probes=probes, dev=dev)
        kw = dict(num_bands=nb, words=w, group=group, scale=key_scale(c), probes=probes)
        got = group_max_keys(sig_t, tie, qw, **kw)
        step = max(1, B1_PLAIN_ELEMENTS // c)
        diff, ok = 0, True
        for s in range(0, q, step):
            want = group_max_keys_ref(sig_t, tie, qw[s : s + step], **kw)
            diff = max(diff, int((got[s : s + step].long() - want.long()).abs().max()))
            ok = ok and torch.equal(got[s : s + step], want)
        torch.cuda.synchronize()
        err["group_max_keys"] = max(err["group_max_keys"], diff)
        emit("kernel_check", kernel="group_max_keys", bands=nb, words=w, C=c, Q=q,
             probes=probes, group=group, equal=ok, max_abs_err=diff)
        if not ok:
            raise AssertionError(f"B1 kernel != plain at {(nb, w, c, q, probes)}, group {group}")
        if group != 64:
            continue
        if (nb, w, c, q, probes) in B1_TIMED_1M:
            timed[B1_TIMED_1M[nb, w, c, q, probes]] = (
                lambda sig_t=sig_t, tie=tie, qw=qw, kw=kw: group_max_keys(sig_t, tie, qw, **kw),
                lambda sig_t=sig_t, tie=tie, qw=qw, kw=kw: group_max_keys_ref(sig_t, tie, qw, **kw),
                dict(C=c, Q=q, bands=nb, probes=probes), None,
            )
        variant = (B1_VARIANTS.get((nb, w, c, q, probes)) or B1_RECALL_1M.get((nb, w, c, q, probes))
                   or B1_BANDINGS_1M.get((nb, w, c, q, probes)))
        if variant:
            timed[variant] = (
                lambda sig_t=sig_t, tie=tie, qw=qw, kw=kw: group_max_keys(sig_t, tie, qw, **kw),
                lambda sig_t=sig_t, tie=tie, qw=qw, kw=kw: group_max_keys_ref(sig_t, tie, qw, **kw),
                dict(C=c, Q=q, bands=nb * w, probes=probes), None,
            )
        if (nb, w, c, q, probes) == (16, 1, 131072, 1024, 1):
            timed["group_max_keys"] = (
                lambda sig_t=sig_t, tie=tie, qw=qw, kw=kw: group_max_keys(sig_t, tie, qw, **kw),
                lambda sig_t=sig_t, tie=tie, qw=qw, kw=kw: group_max_keys_ref(sig_t, tie, qw, **kw),
                dict(C=c, Q=q, bands=nb, probes=probes), None,
            )

    c = 1 << 20
    scale = key_scale(c)
    b2_cases = [  # (P, Q, group, asymmetric)
        (NUM_PERM, 512, 64, False),
        (NUM_PERM, 512, 64, True),
        (NUM_PERM, 300, 64, False),   # ragged Q
        (512, 512, 128, False),       # the widest resident planes, group 128
        (30, 300, 16, True),          # padded 30 -> 32 columns
        (NUM_PERM, QPS_BATCH_1M, 64, False),  # the 1M serving batch
        (NUM_PERM, CARRY_QUERIES, 64, False),  # sharded_parity: a 4M store's shard
    ]
    for p, q, group, asym in b2_cases:
        planes, tie, qb = b2_inputs(rng, c=c, p=p, q=q, asymmetric=asym, dev=dev)
        kw = dict(group=group, scale=scale, num_perm=p)
        if asym:
            kw.update(offset=p * 127, shift=asymmetric_shift(p, c))
        got = hamming_group_max_keys(planes, tie, qb, **kw)
        want = hamming_group_max_keys_ref(planes, tie, qb, **kw)
        torch.cuda.synchronize()
        diff = int((got.long() - want.long()).abs().max())
        err["hamming_group_max_keys"] = max(err["hamming_group_max_keys"], diff)
        ok = torch.equal(got, want)
        emit("kernel_check", kernel="hamming_group_max_keys", C=c, P=p, width=planes.shape[1],
             Q=q, group=group, asymmetric=asym, shift=kw.get("shift", 1), equal=ok,
             max_abs_err=diff)
        if not ok:
            raise AssertionError(f"B2 kernel != plain at P={p}, Q={q}, group={group}, "
                                 f"asymmetric={asym}")
        shape = dict(C=c, Q=q, P=p, group=group)
        if (p, q, group, asym) == (NUM_PERM, 512, 64, False):
            # torch._int_mm: the same int8 product, no key and no group
            # max, writing the whole (Q, C) int32 matrix; timed only.
            timed["hamming_group_max_keys"] = (
                lambda planes=planes, tie=tie, qb=qb, kw=kw: hamming_group_max_keys(planes, tie, qb, **kw),
                lambda planes=planes, tie=tie, qb=qb, kw=kw: hamming_group_max_keys_ref(planes, tie, qb, **kw),
                shape, lambda planes=planes, qb=qb: torch._int_mm(qb, planes.t()),
            )
        if q == QPS_BATCH_1M:
            timed["hamming_group_max_keys@serving_1m"] = (
                lambda planes=planes, tie=tie, qb=qb, kw=kw: hamming_group_max_keys(planes, tie, qb, **kw),
                lambda planes=planes, tie=tie, qb=qb, kw=kw: hamming_group_max_keys_ref(planes, tie, qb, **kw),
                shape, None,
            )
        del planes, qb, got, want

    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    check_b2_packings(gen, dev, err, timed)
    check_b2_shards(gen, dev, err, timed)
    check_refine(gen, dev, err, timed)
    check_select(gen, dev, err, timed)

    # B3 on random full 32-bit words (word_bits 32, K = 512 at BW = 16),
    # drawn on the host with NumPy.
    b3_cases = [  # (BW, C, Q, group)
        (16, 1 << 20, 512, 64),
        (16, 1 << 20, 300, 64),  # ragged Q
        (8, 1 << 18, 512, 32),   # BW=8
        (12, 1 << 16, 200, 128), # K = 384: one resident slot buffer
        (16, 1 << 16, 100, 16),
        (16, 1 << 20, CARRY_QUERIES, 64),  # sharded_parity: a 4M store's shard
    ]
    for bw, c, q, group in b3_cases:
        sig_t, tie, qw = b3_inputs(rng, bw=bw, c=c, q=q, dev=dev)
        kw = dict(num_perm=32 * bw, group=group, scale=key_scale(c))
        check_b3(sig_t, tie, qw, kw, err)
        if (bw, c, q) == (16, 1 << 20, 512):
            time_b3(B3_FULL_WORDS, sig_t, tie, qw, kw, timed)
    # B3 on the store's words (word_bits = rows_per_band, as the store
    # passes it), drawn on the card: 16 x 16 and 32 x 8 (K = 256), one and
    # 17 queries, the streamed expansion at 32 bits (K = 1024 and 2048),
    # and the packed_4m serving batch.
    b3_store_cases = [  # (BW, C, Q, group, word_bits)
        (16, N_1M, 512, 64, ROWS),   # timed: the kernels line's B3 row
        (32, N_1M, 512, 64, 8),      # 32 x 8
        (16, N_1M, 1, 64, ROWS),
        (16, N_1M, 17, 64, ROWS),
        (16, N_1M, CARRY_QUERIES, 64, ROWS),  # sharded_parity: a 4M store's shard
        (32, 1 << 18, 512, 64, 32),  # K = 1024: streamed
        (64, 1 << 16, 300, 64, 32),  # K = 2048: streamed, the widest BW
        (16, N_4M, QPS_BATCH_1M, 64, ROWS),  # packed_4m's batch (timed)
    ]
    for bw, c, q, group, word_bits in b3_store_cases:
        sig_t, tie, qw = b3_words_on_card(gen, bw=bw, word_bits=word_bits, c=c, q=q, dev=dev)
        kw = dict(num_perm=bw * word_bits, group=group, scale=key_scale(c), word_bits=word_bits)
        plain_ms = check_b3(sig_t, tie, qw, kw, err)
        if (bw, c, q) == (16, N_1M, 512):
            time_b3(B3, sig_t, tie, qw, kw, timed, b2_name=B2_B3_WORDS[N_1M])
        elif c == N_4M:
            time_b3(B3_PACKED_4M, sig_t, tie, qw, kw, timed, b2_name=B2_B3_WORDS[N_4M],
                    plain_ms=plain_ms)
        del sig_t, tie, qw
    return {"max_abs_err": err, "timed": timed}


def carry_to_cpu(store):
    """A ``device="cpu"`` store loaded from ``store.state_arrays()``."""
    from lshrs_tpu_torch import DeviceStore

    cpu = DeviceStore(
        num_bands=store.num_bands, rows_per_band=store.rows_per_band, dim=store.dim,
        initial_capacity=store._capacity, chunk_size=store.chunk,
        group_size=store.group, dedupe=store.dedupe,
        enable_hamming=store.enable_hamming, hamming_storage=store.hamming_storage,
        store_vectors=store.store_vectors, payload_dtype=store.payload_dtype,
        rerank_engine=store.rerank_engine, rerank_candidates=store.rerank_candidates,
        device="cpu",
    )
    cpu.load_state_arrays(store.state_arrays())
    assert cpu._capacity == store._capacity, (cpu._capacity, store._capacity)
    return cpu


def check_ids(ids: np.ndarray, q: int, n: int) -> None:
    assert ids.shape == (q, TOP_K) and ids.dtype == np.int32, (ids.shape, ids.dtype)
    assert ((ids >= -1) & (ids < n)).all(), "ids out of range"


def self_match(serve, batches, n: int) -> float:
    """Share of stored vectors whose top-1 is their own id (``n`` rows stored)."""
    hits = total = 0
    for ids, x in batches:
        out = serve(x)
        check_ids(out, len(ids), n)
        hits += int((out[:, 0] == ids).sum())
        total += len(ids)
    return hits / total


def serving_qps(serve, queries, *, trials: int = 3) -> float:
    serve(queries[0])  # warm
    rates = []
    for _ in range(trials):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for x in queries:
            serve(x)  # returns host ids: synchronised
        rates.append(sum(len(x) for x in queries) / (time.perf_counter() - t0))
    return float(np.median(rates))


def serving_profile(serve, queries, *, top: int = 8) -> dict:
    """Device time by kernel over the serving batches (torch.profiler):
    per-batch device and wall ms, the device-busy share, the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities):  # warm: the first session starts the tracer
        serve(queries[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=activities) as prof:
        for x in queries:
            serve(x)
    wall_ms = (time.perf_counter() - t0) * 1e3 / len(queries)
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev.sort(key=lambda e: e.self_device_time_total, reverse=True)
    device_ms = sum(e.self_device_time_total for e in dev) / 1e3 / len(queries)
    return {
        "wall_ms_per_batch": wall_ms,
        "device_ms_per_batch": device_ms,
        "device_busy_share": device_ms / wall_ms,
        "top": [
            {"name": e.key[:90], "ms_per_batch": e.self_device_time_total / 1e3 / len(queries),
             "calls_per_batch": e.count / len(queries)}
            for e in dev[:top]
        ],
    }


def phase_100k(seed: int) -> dict:
    from lshrs_tpu_torch import LSHRS
    from lshrs_tpu_torch.ops.group_max import group_max_keys, hamming_group_max_keys

    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N_100K, DIM), dtype=np.float32)
    lsh = LSHRS(dim=DIM, num_perm=NUM_PERM, num_bands=NUM_BANDS, rows_per_band=ROWS,
                device=DEVICE)
    lsh.index(np.arange(INGEST_BATCH), X[:INGEST_BATCH])  # warm-up, untimed
    lsh.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(0, N_100K, INGEST_BATCH):
        lsh.index(np.arange(i, min(i + INGEST_BATCH, N_100K)), X[i : i + INGEST_BATCH])
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0

    serve = lsh.serving_fn(top_k=TOP_K)
    batches = [
        (np.arange(i, min(i + QPS_BATCH_100K, N_100K)), X[i : i + QPS_BATCH_100K])
        for i in range(0, N_100K, QPS_BATCH_100K)
    ]
    sm = self_match(serve, batches, N_100K)
    stats = lsh.stats()
    b1, b2 = group_max_keys.launches, hamming_group_max_keys.launches
    emit("slice_100k", capacity=stats["index"]["capacity"], ranking=stats["ranking"],
         engine_resolved=stats["engine_resolved"], self_match=sm,
         b1_launches=b1, b2_launches=b2)
    assert sm == 1.0, f"self-match {sm} at 100k"
    assert stats["engine_resolved"] is None and stats["ranking"] == "collision"
    assert b1 > 0 and b2 == 0, (b1, b2)

    # The same query words through the card and through a CPU copy.
    qx = X[:CARRY_QUERIES] + 0.5 * rng.standard_normal((CARRY_QUERIES, DIM), dtype=np.float32)
    qwords = lsh._hasher.hash_batch_words(qx)
    counts_gpu, ids_gpu = lsh._storage.query_topk(qwords, TOP_K)
    cpu = carry_to_cpu(lsh._storage)
    counts_cpu, ids_cpu = cpu.query_topk(qwords.cpu(), TOP_K)
    equal = bool(np.array_equal(ids_gpu, ids_cpu) and np.array_equal(counts_gpu, counts_cpu))
    emit("carry_100k", queries=CARRY_QUERIES, equal=equal,
         nonzero_counts=int((counts_gpu > 0).sum()))
    assert equal, "100k: card and CPU ids differ on the same words"

    queries = [rng.standard_normal((QPS_BATCH_100K, DIM), dtype=np.float32) for _ in range(6)]
    return {"lsh": lsh, "serve": serve, "queries": queries, "X": X,
            "build_vectors_per_s": N_100K / build_s, "build_s": build_s}


def clustered_1m(seed: int):
    """The 1M slice's data: 2**20 vectors around 4096 gaussian centres
    (0.35 noise; a Gaussian mixture, as the reference's 1M bench row),
    drawn on the host in index batches. Returns ``(rng, centers,
    batches)``; the same seed gives the same vectors."""
    rng = np.random.default_rng(seed + 1)
    centers = rng.standard_normal((4096, DIM), dtype=np.float32)

    def batches():
        for off in range(0, N_1M, INGEST_BATCH):
            xb = centers[rng.integers(0, 4096, INGEST_BATCH)]
            xb += 0.35 * rng.standard_normal((INGEST_BATCH, DIM), dtype=np.float32)
            yield off, xb

    return rng, centers, batches()


def phase_1m(seed: int) -> dict:
    from lshrs_tpu_torch import LSHRS
    from lshrs_tpu_torch.ops.group_max import hamming_group_max_keys

    rng, _, batches = clustered_1m(seed)
    lsh = LSHRS(dim=DIM, num_perm=NUM_PERM, num_bands=NUM_BANDS, rows_per_band=ROWS,
                device=DEVICE)
    keep = None
    for off, xb in batches:
        if keep is None:
            keep = xb[:QPS_BATCH_1M].copy()
        lsh.index(np.arange(off, off + INGEST_BATCH), xb)
    b2_before = hamming_group_max_keys.launches
    serve = lsh.serving_fn(top_k=TOP_K)
    stats = lsh.stats()
    sm = self_match(serve, [(np.arange(QPS_BATCH_1M), keep)], N_1M)
    b2 = hamming_group_max_keys.launches - b2_before
    emit("slice_1m", capacity=stats["index"]["capacity"], alive=stats["index"]["alive"],
         ranking=stats["ranking"], engine_resolved=stats["engine_resolved"],
         self_match=sm, b2_launches=b2)
    assert stats["index"]["alive"] == N_1M
    assert stats["engine_resolved"] == "hamming", stats["engine_resolved"]
    assert b2 > 0 and sm == 1.0, (b2, sm)

    qx = keep[:CARRY_QUERIES] + 0.5 * rng.standard_normal((CARRY_QUERIES, DIM), dtype=np.float32)
    qwords = lsh._hasher.hash_batch_words(qx)
    ham_gpu, ids_gpu = lsh._storage.query_hamming(qwords, TOP_K)
    cpu = carry_to_cpu(lsh._storage)
    ham_cpu, ids_cpu = cpu.query_hamming(qwords.cpu(), TOP_K)
    equal = bool(np.array_equal(ids_gpu, ids_cpu) and np.array_equal(ham_gpu, ham_cpu))
    emit("carry_1m", queries=CARRY_QUERIES, equal=equal)
    assert equal, "1M: card and CPU ids differ on the same words"
    queries = [rng.standard_normal((QPS_BATCH_1M, DIM), dtype=np.float32) for _ in range(4)]
    # Phase 12 rebuilds this index through create_signatures and must
    # serve these ids for these batches.
    answers = {name: (q, serve(q)) for name, q in (("stored", keep), ("random", queries[0]))}
    return {"lsh": lsh, "serve": serve, "queries": queries, "keep": keep, "answers": answers}


def _assert_same_topk(name, got, want) -> None:
    """``(hamming, ids)`` pairs of two paths, equal element for element."""
    equal = bool(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]))
    emit("packed_vs", other=name, queries=int(got[1].shape[0]), equal=equal)
    assert equal, f"4M: packed path != {name} on the same words"


def draw_clustered(lsh, n: int, seed: int, *, planted_depth: int) -> tuple:
    """Index ``n`` clustered vectors (4096 centres, 0.35 noise, as the 1M
    slice) drawn on the card in ``INGEST_BATCH`` batches, through the host
    as a user's batches would come. Returns the first ``QPS_BATCH_1M``
    rows, the build seconds, and the planted queries (``PLANTED`` stored
    rows moved to ~0.8 cosine) with their exact-cosine top
    ``planted_depth`` over all ``n`` rows."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    centers = torch.randn((4096, DIM), generator=gen, device=DEVICE)
    keep = exact = queries = None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for off in range(0, n, INGEST_BATCH):
        pick = torch.randint(0, 4096, (INGEST_BATCH,), generator=gen, device=DEVICE)
        xd = centers[pick] + 0.35 * torch.randn((INGEST_BATCH, DIM), generator=gen, device=DEVICE)
        xb = xd.cpu().numpy()
        if keep is None:
            keep = xb[:QPS_BATCH_1M].copy()
            queries = planted_queries(keep[:PLANTED], np.random.default_rng(seed))
            exact = RunningTruth(queries, depth=planted_depth)
        exact.add(xd, off)
        lsh.index(np.arange(off, off + INGEST_BATCH), xb)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0 - exact.seconds
    return keep, build_s, (queries, exact.truth())


def phase_packed_4m(seed: int) -> dict:
    """The packed-Hamming slice at 2**22 slots (kernel B3, no bitplanes)."""
    from lshrs_tpu_torch import LSHRS
    from lshrs_tpu_torch.ops.group_max import (
        hamming_group_max_keys,
        hamming_group_max_keys_ref,
        hamming_packed_group_max_keys,
        hamming_packed_group_max_keys_ref,
        key_scale,
    )
    from lshrs_tpu_torch.ops.hamming import _select_refine, hamming_topk_core

    lsh = LSHRS(dim=DIM, num_perm=NUM_PERM, num_bands=NUM_BANDS, rows_per_band=ROWS,
                hamming_storage="packed", device=DEVICE)
    # Clustered data as in the 1M slice (4096 centres, 0.35 noise), drawn
    # on the card: 12 GB of float32 would take minutes on the host.
    # Phase 10 holds the cascade to the exact cosine of planted queries on
    # these vectors: their truth is merged as the batches are drawn (and
    # left out of the build time). Deeper than 10: the ids deleted below
    # drop out of it.
    keep, build_s, planted = draw_clustered(lsh, N_4M, seed + 2, planted_depth=2 * TOP_K)

    store = lsh._storage
    serve = lsh.serving_fn(top_k=TOP_K)
    b2_0, b3_0 = hamming_group_max_keys.launches, hamming_packed_group_max_keys.launches
    sm = self_match(serve, [(np.arange(QPS_BATCH_1M), keep)], N_4M)
    b2 = hamming_group_max_keys.launches - b2_0
    b3 = hamming_packed_group_max_keys.launches - b3_0
    stats = lsh.stats()
    emit("slice_packed_4m", capacity=stats["index"]["capacity"], alive=stats["index"]["alive"],
         ranking=stats["ranking"], engine_resolved=stats["engine_resolved"],
         hamming_storage=stats["index"]["hamming_storage"],
         hamming_plane_bytes=stats["index"]["hamming_plane_bytes"],
         self_match=sm, b3_launches=b3, b2_launches=b2, build_s=build_s)
    assert stats["index"]["capacity"] == N_4M and stats["index"]["alive"] == N_4M
    assert stats["engine_resolved"] == "hamming", stats["engine_resolved"]
    assert stats["index"]["hamming_plane_bytes"] == 0 and store._planes is None
    assert b3 > 0 and b2 == 0 and sm == 1.0, (b3, b2, sm)

    # The bitplane path (kernel B2) and the plain versions on the same words.
    planes = store._materialize_planes()
    p, group, narrow_r = NUM_PERM, store._group(), store._refine_narrow_r

    def packed_topk(qw):
        with store._lock:
            return store._query_hamming_dev(qw, TOP_K)

    def planes_topk(qw):
        with store._lock:
            store._ensure_ranks()
            return hamming_topk_core(
                planes, store._tie, store._planes_rows(qw), qw, store._refine_rows(),
                k=TOP_K, group=group, narrow_r=narrow_r, num_perm=p,
            )

    def plain_topk(qw, *, packed):
        with store._lock:
            store._ensure_ranks()
            scale = key_scale(store._capacity)
            if packed:
                gmax = hamming_packed_group_max_keys_ref(
                    store._sig_t, store._tie, qw, num_perm=p, group=group, scale=scale)
            else:
                gmax = hamming_group_max_keys_ref(planes, store._tie, store._planes_rows(qw),
                                                  group=group, scale=scale, num_perm=p)
            with plain_refine():
                return _select_refine(gmax, qw, store._refine_rows(), p=p, k=TOP_K,
                                      group=group, narrow_r=narrow_r)

    rng = np.random.default_rng(seed + 3)
    qx = keep[:CARRY_QUERIES] + 0.5 * rng.standard_normal((CARRY_QUERIES, DIM), dtype=np.float32)
    qwords = lsh._hasher.hash_batch_words(qx)

    def check_paths():
        got = packed_topk(qwords)
        _assert_same_topk("planes (B2)", got, planes_topk(qwords))
        _assert_same_topk("plain B3", packed_topk(qwords[:64]), plain_topk(qwords[:64], packed=True))
        _assert_same_topk("plain B2", packed_topk(qwords[:64]), plain_topk(qwords[:64], packed=False))

    check_paths()

    # Peak memory of one QPS_BATCH_1M-query batch over what is allocated
    # before it, on each engine (the planes, materialised above, are not
    # part of a batch): the packed batch needs at most its query operand
    # (Q * K bytes) more than the planes batch, whose peak is what the
    # packed batch needed before B3 took an operand (the group-max keys and
    # the selection's temporaries), so it never holds a (C, K) array; the
    # store holds no planes after serving.
    from lshrs_tpu_torch.ops.group_max import packed_width

    qw_batch = lsh._hasher.hash_batch_words(keep)
    peak = {}
    for name, topk in (("packed", packed_topk), ("planes", planes_topk)):
        topk(qw_batch)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        topk(qw_batch)
        torch.cuda.synchronize()
        peak[name] = torch.cuda.max_memory_allocated() - base
    k_cols = packed_width(NUM_BANDS, store._packed_word_bits())
    operand, c_by_k = QPS_BATCH_1M * k_cols, N_4M * k_cols
    emit("memory_packed_4m", batch=QPS_BATCH_1M, K=k_cols, packed_batch_peak_bytes=peak["packed"],
         planes_batch_peak_bytes=peak["planes"], query_operand_bytes=operand,
         c_by_k_bytes=c_by_k, store_planes_allocated=store._planes is not None)
    assert peak["packed"] <= peak["planes"] + operand and store._planes is None, peak
    del qw_batch

    deleted = rng.choice(N_4M, N_4M // 100, replace=False)
    lsh.delete(deleted.tolist())
    serve = lsh.serving_fn(top_k=TOP_K)
    out = serve(keep)
    kept = ~np.isin(np.arange(QPS_BATCH_1M), deleted)
    leaked = int(np.isin(out, deleted).sum())
    sm_after = float((out[kept, 0] == np.arange(QPS_BATCH_1M)[kept]).mean())
    stats = lsh.stats()
    emit("delete_packed_4m", deleted=int(deleted.size), deleted_queried=int((~kept).sum()),
         tombstones=stats["index"]["tombstones"], alive=stats["index"]["alive"],
         deleted_ids_returned=leaked, survivor_self_match=sm_after)
    assert leaked == 0 and sm_after == 1.0 and stats["index"]["tombstones"] == deleted.size
    check_paths()

    def serve_planes(x):
        qw = lsh._hasher.hash_batch_words(np.asarray(x, dtype=np.float32))
        return planes_topk(qw)[1].cpu().numpy()

    queries = [rng.standard_normal((QPS_BATCH_1M, DIM), dtype=np.float32) for _ in range(2)]
    return {"lsh": lsh, "serve": serve, "serve_planes": serve_planes, "queries": queries,
            "build_s": build_s, "keep": keep, "deleted": deleted, "planted": planted,
            "planes_topk": planes_topk}


def phase_lifecycle(s100: dict, seed: int) -> None:
    """Save/load and delete/compact on the 100k collision index."""
    from lshrs_tpu_torch import LSHRS

    lsh, X = s100["lsh"], s100["X"]
    rng = np.random.default_rng(seed + 4)
    ckpt = Path(__file__).resolve().parent / "build" / "chip_smoke_checkpoint"
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        lsh.save_to_disk(ckpt)
        back = LSHRS.load_from_disk(ckpt, device=DEVICE)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    qx = X[:CARRY_QUERIES] + 0.5 * rng.standard_normal((CARRY_QUERIES, DIM), dtype=np.float32)
    want = lsh.query_batch(qx, top_k=TOP_K)
    equal = back.query_batch(qx, top_k=TOP_K) == want
    emit("save_load_100k", queries=CARRY_QUERIES, equal=equal,
         capacity=back.stats()["index"]["capacity"], device=back.stats()["device"])
    assert equal, "100k: the loaded index returns other ids"
    assert back.stats()["index"]["capacity"] == lsh.stats()["index"]["capacity"]
    del back

    deleted = rng.choice(N_100K, 1000, replace=False)
    lsh.delete(deleted.tolist())
    reclaimed = lsh.compact()
    serve = lsh.serving_fn(top_k=TOP_K)
    survivors = np.setdiff1d(np.arange(N_100K), deleted)
    hits = leaked = 0
    for i in range(0, survivors.size, QPS_BATCH_100K):
        ids = survivors[i : i + QPS_BATCH_100K]
        out = serve(X[ids])
        hits += int((out[:, 0] == ids).sum())
        leaked += int(np.isin(out, deleted).sum())
    sm = hits / survivors.size
    stats = lsh.stats()["index"]
    emit("delete_compact_100k", deleted=int(deleted.size), reclaimed=reclaimed,
         alive=stats["alive"], tombstones=stats["tombstones"], survivor_self_match=sm,
         deleted_ids_returned=leaked)
    assert reclaimed == deleted.size and stats["tombstones"] == 0
    assert stats["alive"] == survivors.size and sm == 1.0 and leaked == 0


def compare_rankings(got, want, *, depth: int = TOP_K, tie: float = 1e-5) -> dict:
    """Two ``(ids, cosines, n)`` top-p results of the same queries: ``n``
    equal, and over each row's first ``min(n, depth)`` entries the ids
    equal except where the two cosines at a position differ by < ``tie``
    (a swap of near-tied neighbours); returns the counts and the largest
    cosine difference."""
    g_ids, g_sims, g_n = (np.asarray(x) for x in got)
    w_ids, w_sims, w_n = (np.asarray(x) for x in want)
    equal = swapped = bad = 0
    max_err = 0.0
    for r in range(len(w_n)):
        k = min(int(w_n[r]), depth)
        diff = np.abs(g_sims[r, :k].astype(np.float64) - w_sims[r, :k])
        max_err = max(max_err, float(diff.max(initial=0.0)))
        same = g_ids[r, :k] == w_ids[r, :k]
        if g_n[r] != w_n[r] or not (same | (diff < tie)).all():
            bad += 1
        elif same.all():
            equal += 1
        else:
            swapped += 1
    return {"rows_equal": equal, "rows_near_tie_swaps": swapped, "rows_bad": bad,
            "max_abs_cos_err": max_err}


def topp_self_match(serve, X, batch: int) -> tuple[float, float]:
    """Share of stored rows whose top-1 is themselves, and the worst
    |cosine - 1| of those top-1s."""
    hits, worst = 0, 0.0
    for i in range(0, len(X), batch):
        ids, sims, _ = serve(X[i : i + batch])
        hits += int((ids[:, 0] == np.arange(i, i + len(ids))).sum())
        worst = max(worst, float(np.abs(sims[:, 0].astype(np.float64) - 1.0).max()))
    return hits / len(X), worst


def phase_topp_100k(s100: dict, seed: int) -> dict:
    """Top-p at 100k, float32 payload: auto resolves to the full engine."""
    from lshrs_tpu_torch import LSHRS

    X = s100["X"]
    rng = np.random.default_rng(seed + 5)
    lsh = LSHRS(dim=DIM, num_perm=NUM_PERM, num_bands=NUM_BANDS, rows_per_band=ROWS,
                store_vectors=True, payload_dtype="float32", device=DEVICE)
    for i in range(0, N_100K, INGEST_BATCH):
        lsh.index(np.arange(i, min(i + INGEST_BATCH, N_100K)), X[i : i + INGEST_BATCH])
    store = lsh._storage
    engine = store.stats()["rerank_engine"]
    serve = lsh.serving_fn(top_k=TOP_K, mode="topp", batch_hint=TOPP_BATCH_100K)
    sm, worst = topp_self_match(serve, X, TOPP_BATCH_100K)
    emit("topp_100k_self_match", engine=engine, payload=store.stats()["payload_bytes"],
         self_match=sm, max_abs_cos_minus_1=worst)
    assert engine == "full", engine
    assert sm == 1.0 and worst < 1e-5, (sm, worst)

    qx = X[:CARRY_QUERIES] + 0.5 * rng.standard_normal((CARRY_QUERIES, DIM), dtype=np.float32)
    got = serve(qx)
    qwords = lsh._hasher.hash_batch_words(qx)
    cpu = carry_to_cpu(store)
    want = cpu.query_topp_batch(qwords.cpu(), qx, TOP_K)
    agree = compare_rankings(got, want)
    emit("topp_100k_card_vs_cpu", queries=CARRY_QUERIES, **agree)
    assert agree["rows_bad"] == 0 and agree["max_abs_cos_err"] < 1e-5, agree
    del cpu

    def as_arrays(rows, n):
        ids = np.full((len(rows), TOP_K), -1, np.int32)
        sims = np.zeros((len(rows), TOP_K), np.float32)
        for r, row in enumerate(rows):
            ids[r, : len(row[:TOP_K])] = [i for i, _ in row[:TOP_K]]
            sims[r, : len(row[:TOP_K])] = [c for _, c in row[:TOP_K]]
        return ids, sims, np.asarray(n)

    # The batch entry point runs the same device rerank as serving.
    batch = as_arrays(lsh.get_above_p_batch(qx, p=1.0, top_k=TOP_K), got[2])
    agree = compare_rankings(batch, got, tie=0.0)
    emit("topp_100k_batch_vs_serving", queries=CARRY_QUERIES, **agree)
    assert agree["rows_bad"] == 0 and agree["max_abs_cos_err"] < 1e-6, agree

    # One query at a time: get_above_p (device rerank of a single query)
    # and candidate enumeration (top_k=None: the nnz probe, then kernel B1).
    n_enum = [len(lsh.query(x, top_k=None)) for x in qx[:16]]
    single = as_arrays([lsh.get_above_p(x, p=1.0) for x in qx[:16]], n_enum)
    agree = compare_rankings(single, [x[:16] for x in got])
    emit("topp_100k_single_and_enumeration", queries=16, **agree)
    assert agree["rows_bad"] == 0 and agree["max_abs_cos_err"] < 1e-5, agree
    queries = [rng.standard_normal((TOPP_BATCH_100K, DIM), dtype=np.float32) for _ in range(8)]
    return {"lsh": lsh, "serve": serve, "queries": queries, "X": X}


def phase_topp_1m(seed: int) -> dict:
    """Top-p at 2**20 clustered vectors, int8 payload: the full and the
    gather engine in turn; gather == full on every exact query, recall@10
    of each against exact float32 cosine."""
    from lshrs_tpu_torch import LSHRS
    from lshrs_tpu_torch.ops.group_max import group_max_keys

    rng, centers, batches = clustered_1m(seed)
    kw = dict(dim=DIM, num_perm=NUM_PERM, store_vectors=True, payload_dtype="int8", device=DEVICE)
    lsh = LSHRS(num_bands=NUM_BANDS, rows_per_band=ROWS, **kw)
    # The same vectors under multiprobe=4 and under the cross-polytope
    # family (32 x 8; never Hamming), both on the gather engine: phase 9.
    others = {
        "multiprobe4": LSHRS(num_bands=NUM_BANDS, rows_per_band=ROWS, multiprobe=4,
                             rerank_engine="gather", **kw),
        "crosspolytope": LSHRS(num_bands=CP_BANDS, rows_per_band=CP_ROWS,
                               hash_family="crosspolytope", rerank_engine="gather", **kw),
    }
    build_s = dict.fromkeys(others, 0.0)
    keep = None
    exact_x = torch.empty((N_1M, DIM), dtype=torch.float32, device=DEVICE)
    for off, xb in batches:
        if keep is None:
            keep = xb[:QPS_BATCH_1M].copy()
        lsh.index(np.arange(off, off + INGEST_BATCH), xb)
        exact_x[off : off + INGEST_BATCH] = torch.from_numpy(xb).to(DEVICE)
        for name, other in others.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            other.index(np.arange(off, off + INGEST_BATCH), xb)
            torch.cuda.synchronize()
            build_s[name] += time.perf_counter() - t0
    store = lsh._storage
    qx = centers[rng.integers(0, 4096, TOPP_QUERIES)]
    qx += 0.35 * rng.standard_normal((TOPP_QUERIES, DIM), dtype=np.float32)

    # Exact float32 cosine top-10 over the 2**20 vectors (TF32 is off).
    exact = RunningTruth(qx)
    for s in range(0, N_1M, 1 << 18):
        exact.add(exact_x[s : s + (1 << 18)], s)
    truth = exact.truth()
    del exact_x, exact

    # Each engine pinned through the store's batch entry point.
    qw = lsh._hasher.hash_batch_words(qx)
    mc = store.rerank_candidates
    out, result, b1 = {}, {}, {}
    truncations = store.stats()["rerank_truncations"]
    for eng in ("full", "gather"):
        before = group_max_keys.launches
        out[eng] = store.query_topp_batch(qw, qx, TOP_K, engine=eng)
        b1[eng] = group_max_keys.launches - before
    truncations = store.stats()["rerank_truncations"] - truncations
    full, gather = out["full"], out["gather"]
    # A query the gather engine could not cover has n >= max_candidates,
    # so n < max_candidates proves its ranking exact.
    exact = gather[2] < mc
    agree = compare_rankings([x[exact] for x in gather], [x[exact] for x in full], tie=1e-6)
    for eng, res in (("full", full), ("gather", gather)):
        hits = [len(set(res[0][r][res[0][r] >= 0]) & set(truth[r])) for r in range(TOPP_QUERIES)]
        result[eng] = {"recall_at_10": float(np.mean(hits)) / TOP_K,
                       "mean_candidates": float(res[2].mean())}

    # The card against the same store carried to the CPU (full engine,
    # plain torch) on the first TOPP_CPU_QUERIES queries.
    t0 = time.perf_counter()
    cpu = carry_to_cpu(store)
    want = cpu.query_topp_batch(qw[:TOPP_CPU_QUERIES].cpu(), qx[:TOPP_CPU_QUERIES], TOP_K,
                                engine="full")
    cpu_s = time.perf_counter() - t0
    del cpu
    sub = exact[:TOPP_CPU_QUERIES]
    vs_cpu = {"full": compare_rankings([x[:TOPP_CPU_QUERIES] for x in full], want),
              "gather_on_exact": compare_rankings([x[:TOPP_CPU_QUERIES][sub] for x in gather],
                                                  [x[sub] for x in want])}

    # The user's entry point on the gather engine: the same ids, through B1.
    store.rerank_engine = "gather"
    before = group_max_keys.launches
    served = lsh.serving_fn(top_k=TOP_K, mode="topp", batch_hint=TOPP_QUERIES)(qx)
    b1["serving_gather"] = group_max_keys.launches - before
    served_equal = bool(np.array_equal(served[0], gather[0])
                        and np.array_equal(served[2], gather[2]))
    emit("topp_1m_int8", queries=TOPP_QUERIES, payload_bytes=store.stats()["payload_bytes"],
         gather_exact=int(exact.sum()), gather_truncations=truncations,
         gather_vs_full_on_exact=agree, card_vs_cpu=vs_cpu, cpu_queries=TOPP_CPU_QUERIES,
         cpu_seconds=cpu_s, serving_equals_gather=served_equal, b1_launches=b1, **result)
    assert agree["rows_bad"] == 0 and agree["max_abs_cos_err"] < 1e-5, agree
    for name, a in vs_cpu.items():
        assert a["rows_bad"] == 0 and a["max_abs_cos_err"] < 1e-5, (name, a)
    assert exact.sum() > 0 and truncations <= int((~exact).sum()) and served_equal
    assert b1["full"] == 0 and b1["gather"] > 0 and b1["serving_gather"] > 0, b1
    assert all(RECALL_FLOOR_1M <= r["recall_at_10"] <= 1.0 for r in result.values()), result
    queries = {q: [centers[rng.integers(0, 4096, q)]
                   + 0.35 * rng.standard_normal((q, DIM), dtype=np.float32) for _ in range(2)]
               for q in TOPP_QPS_BATCHES_1M}
    return {"lsh": lsh, "queries": queries, "recall": result, "others": others,
            "others_build_s": build_s, "qx": qx, "truth": truth, "keep": keep, "rng": rng}


def phase_topp_lifecycle(t100: dict, seed: int) -> None:
    """Delete 1,000 ids and compact, then save and load with the payload:
    no deleted id comes back from top-p, and the loaded index returns the
    same top-p ids."""
    from lshrs_tpu_torch import LSHRS

    lsh, X = t100["lsh"], t100["X"]
    rng = np.random.default_rng(seed + 6)
    deleted = rng.choice(N_100K, 1000, replace=False)
    lsh.delete(deleted.tolist())
    reclaimed = lsh.compact()
    serve = lsh.serving_fn(top_k=TOP_K, mode="topp", batch_hint=TOPP_BATCH_100K)
    qx = X[deleted]  # the deleted vectors themselves, and noisy neighbours
    qx = np.concatenate([qx, qx + 0.1 * rng.standard_normal(qx.shape, dtype=np.float32)])
    leaked = 0
    for i in range(0, len(qx), TOPP_BATCH_100K):
        leaked += int(np.isin(serve(qx[i : i + TOPP_BATCH_100K])[0], deleted).sum())
    enumerated = sum(int(np.isin(lsh.query(x, top_k=None), deleted).sum()) for x in qx[:16])
    stats = lsh.stats()["index"]
    emit("topp_delete_compact_100k", deleted=int(deleted.size), reclaimed=reclaimed,
         tombstones=stats["tombstones"], alive=stats["alive"], queries=len(qx),
         deleted_ids_returned=leaked, deleted_ids_enumerated=enumerated)
    assert reclaimed == deleted.size and stats["tombstones"] == 0
    assert leaked == 0 and enumerated == 0

    ckpt = Path(__file__).resolve().parent / "build" / "chip_smoke_topp_checkpoint"
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        lsh.save_to_disk(ckpt)
        back = LSHRS.load_from_disk(ckpt, device=DEVICE)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    qx = X[:CARRY_QUERIES] + 0.5 * rng.standard_normal((CARRY_QUERIES, DIM), dtype=np.float32)
    want = serve(qx)
    got = back.serving_fn(top_k=TOP_K, mode="topp", batch_hint=TOPP_BATCH_100K)(qx)
    equal = bool(np.array_equal(got[0], want[0]) and np.array_equal(got[2], want[2]))
    emit("topp_save_load_100k", queries=CARRY_QUERIES, equal=equal,
         payload_bytes=back.stats()["index"]["payload_bytes"], device=back.stats()["device"])
    assert equal, "100k: the loaded index returns other top-p ids"


# ---------------------------------------------------------------------------
# phase 9: hash families, multi-probe, where= filters
# ---------------------------------------------------------------------------

def host_seconds(fn) -> tuple[float, object]:
    t0 = time.perf_counter()
    out = fn()
    return time.perf_counter() - t0, out


def phase_hash_parity(seed: int, label: str) -> None:
    """CUDA == native C == NumPy FWHT words for the structured and the
    cross-polytope family on 65,536 x 768 vectors; probe words host ==
    device at T=4; hash times beside the gaussian matmul's."""
    from lshrs_tpu_torch.hash.crosspolytope import cp_dims_for
    from lshrs_tpu_torch.hash.fwht import _structured_coords_numpy
    from lshrs_tpu_torch.hash.hasher import LSHHasher
    from lshrs_tpu_torch.native import load_fwht_library, native_status
    from lshrs_tpu_torch.ops.bitpack import pack_bits_to_words_np, words_to_numpy

    lib = load_fwht_library()
    emit("native_fwht", status=native_status())
    assert lib is not None, f"the native C FWHT did not load: {native_status()}"
    rng = np.random.default_rng(seed + 7)
    x = rng.standard_normal((HASH_ROWS, DIM), dtype=np.float32)
    x[:256] = rng.integers(-2, 3, (256, DIM))  # exact magnitude ties
    xd = torch.from_numpy(x).to(DEVICE)
    numpy_rows = {"structured": HASH_HOST_ROWS, "crosspolytope": HASH_ROWS // 32}
    probe_rows = HASH_ROWS // 8
    for family, nb, r in (("structured", NUM_BANDS, ROWS), ("crosspolytope", CP_BANDS, CP_ROWS),
                          ("gaussian", NUM_BANDS, ROWS)):
        h = LSHHasher(nb, r, DIM, seed=42, hash_family=family, device=DEVICE)
        dev_words = h.hash_batch_words(xd)
        device_ms = median_ms(lambda h=h: h.hash_batch_words(xd), reps=5)
        host_s, host_words = host_seconds(lambda h=h: h.hash_batch_words_host(x[:HASH_HOST_ROWS]))
        fields = dict(card=label, family=family, bands=nb, rows_per_band=r, rows=HASH_ROWS,
                      device_ms=device_ms, device_vectors_per_s=HASH_ROWS / device_ms * 1e3,
                      host_rows=HASH_HOST_ROWS, host_s=host_s,
                      host_vectors_per_s=HASH_HOST_ROWS / host_s)
        if family == "gaussian":
            # A host sgemm and the card's matmul round differently: no
            # parity is claimed; the times stand beside the FWHT's.
            emit("hash", **fields)
            continue
        equal_c = bool(np.array_equal(words_to_numpy(dev_words)[:HASH_HOST_ROWS], host_words))
        n = numpy_rows[family]
        if family == "structured":
            bits = _structured_coords_numpy(x[:n], h.diagonals, nb * r) > 0
        else:
            dpad, cp_d = h.diagonals.shape[2], cp_dims_for(r)
            y = _structured_coords_numpy(x[:n], h.diagonals, nb * dpad)
            y = y.reshape(n, nb, dpad)[:, :, :cp_d]
            i = np.argmax(np.abs(y), axis=2)
            sym = 2 * i + (np.take_along_axis(y, i[:, :, None], axis=2)[:, :, 0] < 0)
            bits = ((sym[..., None] >> np.arange(r)) & 1).astype(bool).reshape(n, -1)
        numpy_words = pack_bits_to_words_np(bits, num_bands=nb, rows_per_band=r)
        equal_np = bool(np.array_equal(numpy_words, host_words[:n]))
        pw_dev = words_to_numpy(h.hash_batch_probe_words(xd[:probe_rows], 4))
        pw_host = h.hash_batch_probe_words_host(x[:probe_rows], 4)
        equal_probe = bool(np.array_equal(pw_dev, pw_host))
        emit("hash", cuda_equals_c=equal_c, c_equals_numpy=equal_np, numpy_rows=n,
             probe_words_equal=equal_probe, probe_rows=probe_rows, **fields)
        assert equal_c, f"{family}: CUDA words != native C words"
        assert equal_np, f"{family}: native C words != NumPy FWHT words"
        assert equal_probe, f"{family}: probe words host != device"


def phase_structured_1m(seed: int, label: str) -> dict:
    """The structured family at 2**20 clustered vectors: host hash (planes
    and packed) and device hash, auto -> Hamming."""
    from lshrs_tpu_torch import LSHRS

    rng, _, batches = clustered_1m(seed)
    kw = dict(dim=DIM, num_perm=NUM_PERM, num_bands=NUM_BANDS, rows_per_band=ROWS,
              hash_family="structured", device=DEVICE)
    idx = {
        "host": LSHRS(hash_mode="host", **kw),
        "device": LSHRS(hash_mode="device", **kw),
        "host_packed": LSHRS(hash_mode="host", hamming_storage="packed", **kw),
    }
    build_s = dict.fromkeys(idx, 0.0)
    keep = None
    for off, xb in batches:
        if keep is None:
            keep = xb[:QPS_BATCH_1M].copy()
        for name, lsh in idx.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lsh.index(np.arange(off, off + INGEST_BATCH), xb)
            torch.cuda.synchronize()
            build_s[name] += time.perf_counter() - t0
    serves = {name: lsh.serving_fn(top_k=TOP_K) for name, lsh in idx.items()}
    qx = keep[:CARRY_QUERIES] + 0.5 * rng.standard_normal((CARRY_QUERIES, DIM), dtype=np.float32)
    want = None
    for name, lsh in idx.items():
        stats = lsh.stats()
        sm = self_match(serves[name], [(np.arange(QPS_BATCH_1M), keep)], N_1M)
        out = serves[name](qx)
        emit("slice_structured_1m", hash_mode=name, card=label, capacity=stats["index"]["capacity"],
             ranking=stats["ranking"], engine_resolved=stats["engine_resolved"],
             hamming_storage=stats["index"]["hamming_storage"], self_match=sm,
             build_vectors_per_s=N_1M / build_s[name], build_s=build_s[name])
        assert stats["engine_resolved"] == "hamming" and stats["hash_family"] == "structured"
        assert sm == 1.0, f"structured_1m {name}: self-match {sm}"
        # Host- and device-hashed words are identical, so all three agree.
        if want is None:
            want = out
        assert np.array_equal(out, want), f"structured_1m: {name} != host"
    host = idx["host"]
    qwords = host._hasher.hash_batch_words_host(qx)
    ham_gpu, ids_gpu = host._storage.query_hamming(qwords, TOP_K)
    cpu = carry_to_cpu(host._storage)
    ham_cpu, ids_cpu = cpu.query_hamming(qwords, TOP_K)
    equal = bool(np.array_equal(ids_gpu, ids_cpu) and np.array_equal(ham_gpu, ham_cpu))
    emit("carry_structured_1m", queries=CARRY_QUERIES, equal=equal,
         serving_equals_query=bool(np.array_equal(ids_gpu, want)))
    assert equal and np.array_equal(ids_gpu, want)
    queries = [rng.standard_normal((QPS_BATCH_1M, DIM), dtype=np.float32) for _ in range(3)]
    return {"idx": idx, "serves": serves, "queries": queries, "keep": keep, "cpu": cpu,
            "rng": rng}


def phase_multiprobe_100k(seed: int, label: str) -> None:
    """multiprobe 2 and 4 on 100k gaussian vectors (kernel B1 with probes)."""
    from lshrs_tpu_torch import LSHRS
    from lshrs_tpu_torch.ops.group_max import group_max_keys

    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N_100K, DIM), dtype=np.float32)
    qx = X[:CARRY_QUERIES] + 0.5 * rng.standard_normal((CARRY_QUERIES, DIM), dtype=np.float32)
    queries = [rng.standard_normal((QPS_BATCH_100K, DIM), dtype=np.float32) for _ in range(4)]
    counts_t1 = None
    for probes in (1, 2, 4):
        lsh = LSHRS(dim=DIM, num_perm=NUM_PERM, num_bands=NUM_BANDS, rows_per_band=ROWS,
                    engine="collision", multiprobe=probes, device=DEVICE)
        for i in range(0, N_100K, INGEST_BATCH):
            lsh.index(np.arange(i, min(i + INGEST_BATCH, N_100K)), X[i : i + INGEST_BATCH])
        serve = lsh.serving_fn(top_k=TOP_K)
        before = group_max_keys.launches_by_shape[NUM_BANDS, probes]
        sm = self_match(serve, [(np.arange(QPS_BATCH_100K), X[:QPS_BATCH_100K])], N_100K)
        launched = group_max_keys.launches_by_shape[NUM_BANDS, probes] - before
        pw = lsh._hash_query_words(qx)
        counts, ids = lsh._storage.query_topk(pw, TOP_K)
        cpu = carry_to_cpu(lsh._storage)
        counts_cpu, ids_cpu = cpu.query_topk(pw.cpu(), TOP_K)
        equal = bool(np.array_equal(ids, ids_cpu) and np.array_equal(counts, counts_cpu))
        served_equal = bool(np.array_equal(serve(qx), ids))
        if probes == 1:
            counts_t1, ids_t1, store_t1 = counts, ids, lsh._storage
            grew = None
        else:
            # Every T=1 hit keeps at least its count under T probes: count
            # the T=1 hits' slots again with the probe words.
            full, slot_ids = lsh._storage.query_counts(pw[:32])
            pos = {int(i): s for s, i in enumerate(slot_ids) if i >= 0}
            grew = all(
                full[r, pos[int(i)]] >= c
                for r in range(32) for i, c in zip(ids_t1[r], counts_t1[r]) if c > 0
            )
        qps = serving_qps(serve, queries, trials=2)
        emit("multiprobe_100k", card=label, probes=probes, self_match=sm,
             b1_launches_with_these_probes=launched, card_equals_cpu=equal,
             serving_equals_query=served_equal, counts_kept_or_grew=grew,
             mean_top1_count=float(counts[:, 0].mean()), qps=qps, batch=QPS_BATCH_100K)
        assert sm == 1.0 and launched > 0 and equal and served_equal and grew is not False


def build_profiles(seed: int, label: str) -> None:
    """One 65,536-vector ``index()`` batch with the device hash, by family:
    where the structured build's time goes (FWHT passes) beside the
    gaussian build's (one matmul)."""
    from lshrs_tpu_torch import LSHRS

    rng = np.random.default_rng(seed + 11)
    xb = rng.standard_normal((INGEST_BATCH, DIM), dtype=np.float32)
    for family, nb, r in (("gaussian", NUM_BANDS, ROWS), ("structured", NUM_BANDS, ROWS),
                          ("crosspolytope", CP_BANDS, CP_ROWS)):
        lsh = LSHRS(dim=DIM, num_perm=NUM_PERM, num_bands=nb, rows_per_band=r, hash_family=family,
                    initial_capacity=4 * INGEST_BATCH, device=DEVICE)
        batch_no = itertools.count()

        def build(x, lsh=lsh, batch_no=batch_no):  # fresh ids each call: appends, no upserts
            i = next(batch_no)
            lsh.index(np.arange(i * INGEST_BATCH, (i + 1) * INGEST_BATCH), x)

        prof = serving_profile(build, [xb, xb], top=6)
        emit("build_profile", card=label, hash_family=family, hash_mode="device",
             batch=INGEST_BATCH, vectors_per_s=INGEST_BATCH / prof["wall_ms_per_batch"] * 1e3,
             **prof)


def recall_at_10(ids: np.ndarray, truth: np.ndarray) -> float:
    hits = [len(set(ids[r][ids[r] >= 0]) & set(truth[r])) for r in range(len(truth))]
    return float(np.mean(hits)) / TOP_K


def phase_probe_and_cp_1m(t1m: dict, label: str) -> None:
    """multiprobe=4 and the cross-polytope family on the 1M int8 data of
    phase 8 (same queries, same exact-cosine truth)."""
    from lshrs_tpu_torch import LSHRS
    from lshrs_tpu_torch.ops.group_max import group_max_keys

    qx, truth, keep, rng = t1m["qx"], t1m["truth"], t1m["keep"], t1m["rng"]
    t1 = t1m["lsh"]
    t1._storage.rerank_engine = "gather"
    recall = {"multiprobe1": t1m["recall"]["gather"]["recall_at_10"]}
    queries = t1m["queries"][TOPP_QPS_BATCHES_1M[0]]
    qps = {"multiprobe1": serving_qps(
        t1.serving_fn(top_k=TOP_K, mode="topp", batch_hint=TOPP_QUERIES), queries, trials=2)}
    noisy = keep[:PROBE_CPU_QUERIES] + 0.2 * rng.standard_normal((PROBE_CPU_QUERIES, DIM), dtype=np.float32)
    held_by_cpu = {}
    for name, bw, probes in (("multiprobe4", NUM_BANDS, 4), ("crosspolytope", CP_BANDS, 1)):
        lsh = t1m["others"][name]
        store = lsh._storage
        stats = lsh.stats()
        assert stats["index"]["alive"] == N_1M, stats["index"]
        serve = lsh.serving_fn(top_k=TOP_K, mode="topp", batch_hint=TOPP_QUERIES)
        before = group_max_keys.launches_by_shape[bw, probes]
        ids, sims, n = serve(qx)
        launched = group_max_keys.launches_by_shape[bw, probes] - before
        recall[name] = recall_at_10(ids, truth)
        # Self-match through top-p: the vector first, cosine ~1 (int8 payload).
        ids_s, sims_s, _ = serve(keep[:TOPP_QUERIES])
        sm = float((ids_s[:, 0] == np.arange(TOPP_QUERIES)).mean())
        qps[name] = serving_qps(serve, queries, trials=2)
        emit("topp_1m_" + name, card=label, queries=TOPP_QUERIES, recall_at_10=recall[name],
             mean_candidates=float(n.mean()), truncated=int((n >= store.rerank_candidates).sum()),
             self_match=sm, max_abs_cos_minus_1=float(np.abs(sims_s[:, 0] - 1.0).max()),
             b1_launches_at_this_shape=launched, qps=qps[name], batch=TOPP_QPS_BATCHES_1M[0],
             build_vectors_per_s=N_1M / t1m["others_build_s"][name])
        assert launched > 0 and sm == 1.0, (name, launched, sm)
        # The card against the store carried to the CPU: collision top-k
        # and top-p gather (B1 at this (BW, probes) over 2**20 slots).
        qw = lsh._hash_query_words(noisy)
        counts, ids = store.query_topk(qw, TOP_K)
        topp = store.query_topp_batch(qw, noisy, TOP_K)
        cpu_s, cpu = host_seconds(lambda store=store: carry_to_cpu(store))
        qw_cpu = qw.cpu() if isinstance(qw, torch.Tensor) else qw
        query_s, (counts_cpu, ids_cpu) = host_seconds(lambda: cpu.query_topk(qw_cpu, TOP_K))
        topp_cpu = cpu.query_topp_batch(qw_cpu, noisy, TOP_K)
        del cpu
        held_by_cpu[name] = dict(
            equal=bool(np.array_equal(ids, ids_cpu) and np.array_equal(counts, counts_cpu)),
            agree=compare_rankings(topp, topp_cpu), counts=counts, cpu_copy_s=cpu_s)
        emit("card_vs_cpu_1m_" + name, card=label, queries=PROBE_CPU_QUERIES, bands=bw, probes=probes,
             topk_card_equals_cpu=held_by_cpu[name]["equal"],
             topp_card_vs_cpu=held_by_cpu[name]["agree"],
             colliding_top1=int((counts[:, 0] > 0).sum()), cpu_copy_s=cpu_s,
             cpu_topk_s=query_s)
        assert held_by_cpu[name]["equal"], f"{name}: card != CPU copy"
        agree = held_by_cpu[name]["agree"]
        assert agree["rows_bad"] == 0 and agree["max_abs_cos_err"] < 1e-5, (name, agree)
    emit("topp_1m_recall", card=label, **{f"recall_{k}": v for k, v in recall.items()},
         **{f"qps_{k}": v for k, v in qps.items()})
    assert recall["multiprobe4"] >= recall["multiprobe1"], recall

    # Cross-polytope collision top-k (kernel B1 at 32 band words, 2**20 slots).
    cp = t1m["others"]["crosspolytope"]
    store = cp._storage
    assert store._use_grouped() and store.words == CP_BANDS
    serve = cp.serving_fn(top_k=TOP_K)
    before = group_max_keys.launches_by_shape[CP_BANDS, 1]
    sm = self_match(serve, [(np.arange(QPS_BATCH_1M), keep)], N_1M)
    launched = group_max_keys.launches_by_shape[CP_BANDS, 1] - before
    held = held_by_cpu["crosspolytope"]
    equal, agree, counts, cpu_s = (held[k] for k in ("equal", "agree", "counts", "cpu_copy_s"))
    served = serve(qx)
    qps_topk = serving_qps(
        serve, [rng.standard_normal((QPS_BATCH_1M, DIM), dtype=np.float32) for _ in range(2)],
        trials=2)
    emit("slice_cp_1m", card=label, capacity=store._capacity, bands=CP_BANDS, rows_per_band=CP_ROWS,
         self_match=sm, b1_launches_bw32=launched, card_equals_cpu=equal, topp_card_vs_cpu=agree,
         colliding_top1=int((counts[:, 0] > 0).sum()), queries=PROBE_CPU_QUERIES,
         topk_recall_at_10=recall_at_10(served, truth), topk_qps=qps_topk, batch=QPS_BATCH_1M,
         cpu_copy_s=cpu_s)
    assert sm == 1.0 and launched > 0 and equal, (sm, launched, equal)
    assert agree["rows_bad"] == 0 and agree["max_abs_cos_err"] < 1e-5, agree
    for bad in (dict(engine="hamming"), dict(enable_hamming=True)):
        try:
            LSHRS(dim=DIM, num_perm=NUM_PERM, num_bands=CP_BANDS, rows_per_band=CP_ROWS,
                  hash_family="crosspolytope", device=DEVICE, **bad)
        except ValueError:
            continue
        raise AssertionError(f"cross-polytope accepted {bad}")


def make_filter(n: int, rng):
    """An allowlist of 10% of the ids minus a denylist of 1,000 of them
    (and 1,000 ids outside it)."""
    from lshrs_tpu_torch import IdFilter

    allow = rng.choice(n, n // 10, replace=False)
    deny = np.concatenate([allow[: FILTER_DENY // 2], rng.choice(n, FILTER_DENY // 2)])
    return IdFilter(allowed_ids=allow, disallowed_ids=deny)


def subset_store(store, flt):
    """A store on the card holding only the ids ``flt`` admits (brute
    force over the admitted subset = its unfiltered answers)."""
    from lshrs_tpu_torch import DeviceStore

    state = store.state_arrays()
    keep = flt.admits(state["ids"]) & (state["ids"] >= 0)
    sub = DeviceStore(
        num_bands=store.num_bands, rows_per_band=store.rows_per_band, dim=store.dim,
        initial_capacity=store._capacity, chunk_size=store.chunk, group_size=store.group,
        enable_hamming=store.enable_hamming, hamming_storage=store.hamming_storage,
        device=DEVICE,
    )
    sub.add_signature_batch(state["ids"][keep], state["sig"][keep])
    return sub, int(keep.sum())


def phase_filters(s1m: dict, t1m: dict, seed: int, label: str) -> None:
    """where= at 100k (B1), 1M planes (B2) and 1M packed (B3), and on the
    1M top-p engines."""
    from lshrs_tpu_torch import LSHRS
    from lshrs_tpu_torch.ops import group_max

    rng = np.random.default_rng(seed + 8)
    X = np.random.default_rng(seed).standard_normal((N_100K, DIM), dtype=np.float32)
    lsh100 = LSHRS(dim=DIM, num_perm=NUM_PERM, num_bands=NUM_BANDS, rows_per_band=ROWS,
                   engine="collision", device=DEVICE)
    for i in range(0, N_100K, INGEST_BATCH):
        lsh100.index(np.arange(i, min(i + INGEST_BATCH, N_100K)), X[i : i + INGEST_BATCH])
    # One filter and one set of queries for the two 1M indexes: they hold
    # the same words, so their filtered answers must be equal too.
    flt_1m = make_filter(N_1M, rng)
    noise = 0.5 * rng.standard_normal((CARRY_QUERIES, DIM), dtype=np.float32)
    cases = [
        ("100k_collision", B1, lsh100, N_100K, X[:QPS_BATCH_100K], QPS_BATCH_100K,
         make_filter(N_100K, rng), None),
        ("1m_planes", B2, s1m["idx"]["host"], N_1M, s1m["keep"], QPS_BATCH_1M, flt_1m,
         s1m["cpu"]),
        ("1m_packed", B3, s1m["idx"]["host_packed"], N_1M, s1m["keep"], QPS_BATCH_1M, flt_1m,
         None),
    ]
    planes_answer = None
    for name, kernel, lsh, n, stored, batch, flt, cpu in cases:
        store = lsh._storage
        wrapper = getattr(group_max, kernel)
        serve = lsh.serving_fn(top_k=TOP_K, where=flt)
        before = wrapper.launches
        out = serve(stored)
        launched = wrapper.launches - before
        got = out[out >= 0]
        inadmissible = int((~flt.admits(got)).sum())
        # An admitted stored vector is its own best match among the admitted.
        adm = flt.admits(np.arange(batch))
        sm = float((out[adm, 0] == np.arange(batch)[adm]).mean())
        # The cached columns are the same tensors as long as nothing
        # recomputed them.
        state = flt.device_state(store)[0]
        serve(stored[:CARRY_QUERIES])
        reused = flt.device_state(store)[0] is state

        qx = stored[:CARRY_QUERIES] + noise
        qw = lsh._hash_words(qx)
        query = store.query_topk if kernel == B1 else store.query_hamming
        score, ids = query(qw, TOP_K, where=flt)
        sub, admitted = subset_store(store, flt)
        sub_query = sub.query_topk if kernel == B1 else sub.query_hamming
        score_sub, ids_sub = sub_query(qw, TOP_K)
        del sub
        brute = bool(np.array_equal(ids, ids_sub) and np.array_equal(score, score_sub))
        if cpu is None:
            cpu = carry_to_cpu(store)
        # The packed plain version runs seconds per query batch on the CPU:
        # fewer queries there, and all of them against it on the card below.
        n_cpu = PACKED_CPU_QUERIES if kernel == B3 else CARRY_QUERIES
        qw_cpu = (qw.cpu() if isinstance(qw, torch.Tensor) else qw)[:n_cpu]
        cpu_query = cpu.query_topk if kernel == B1 else cpu.query_hamming
        cpu_s, (score_cpu, ids_cpu) = host_seconds(lambda: cpu_query(qw_cpu, TOP_K, where=flt))
        del cpu
        cpu_equal = bool(np.array_equal(ids[:n_cpu], ids_cpu)
                         and np.array_equal(score[:n_cpu], score_cpu))
        extra = {}
        if kernel == B3:
            # Kernel B3 on the filtered tie column against its plain version
            # on the card, and the packed index against the planes index
            # (same words, same filter, same queries).
            ids_f, tie_f = flt.device_state(store)
            qw_np = qw.cpu().numpy() if isinstance(qw, torch.Tensor) else np.asarray(qw)
            qw_dev = torch.from_numpy(
                np.ascontiguousarray(qw_np).view(np.int32).reshape(CARRY_QUERIES, -1)).to(DEVICE)
            kw = dict(num_perm=NUM_PERM, group=store._group(),
                      scale=group_max.key_scale(store._capacity),
                      word_bits=store._packed_word_bits())
            counted = wrapper.launches  # a comparison launch is no launch of the path
            keys = group_max.hamming_packed_group_max_keys(store._sig_t, tie_f, qw_dev, **kw)
            wrapper.launches = counted
            plain = group_max.hamming_packed_group_max_keys_ref(store._sig_t, tie_f, qw_dev, **kw)
            extra = dict(
                filtered_keys_equal_plain_on_card=torch.equal(keys, plain),
                dead_under_filter=int((tie_f < 0).sum()),
                equals_planes_index=bool(np.array_equal(ids, planes_answer[1])
                                         and np.array_equal(score, planes_answer[0])))
            del keys, plain
            assert all(v for v in extra.values()), extra
        if kernel == B2:
            planes_answer = (score, ids)
        queries = [rng.standard_normal((batch, DIM), dtype=np.float32) for _ in range(2)]
        qps_f = serving_qps(serve, queries, trials=2)
        qps_u = serving_qps(lsh.serving_fn(top_k=TOP_K), queries, trials=2)
        profile = serving_profile(serve, queries[:1]) if kernel == B2 else None

        # A delete bumps the store's generation: the state is recomputed and
        # the deleted id is gone even though the filter admits it.
        victim = int(np.flatnonzero(adm)[0])
        lsh.delete([victim])
        after = lsh.serving_fn(top_k=TOP_K, where=flt)(stored[:CARRY_QUERIES])
        recomputed = flt.device_state(store)[0] is not state
        gone = victim not in after
        emit("filter_" + name, card=label, kernel=kernel, admitted=admitted, rows=n,
             launches_under_filter=launched, inadmissible_ids_returned=inadmissible,
             admitted_self_match=sm, state_reused=reused, recomputed_after_delete=recomputed,
             deleted_id_gone=gone, equals_brute_force_over_admitted=brute, equals_cpu_copy=cpu_equal,
             cpu_queries=n_cpu, cpu_seconds=cpu_s, queries=CARRY_QUERIES, **extra, qps_filtered=qps_f, qps_unfiltered=qps_u,
             batch=batch)
        if profile:
            emit("profile", card=label, rows=n, batch=batch, engine="hamming", filtered=True,
                 **profile)
        assert launched > 0 and inadmissible == 0 and sm == 1.0, (name, launched, inadmissible, sm)
        assert reused and recomputed and gone and brute and cpu_equal, (
            name, reused, recomputed, gone, brute, cpu_equal)

    # Filtered top-p on the 1M int8 index, both engines.
    lsh, qx = t1m["lsh"], t1m["qx"]
    store = lsh._storage
    flt = make_filter(N_1M, rng)
    qw = lsh._hasher.hash_batch_words(qx)
    out = {eng: store.query_topp_batch(qw, qx, TOP_K, engine=eng, where=flt)
           for eng in ("full", "gather")}
    exact = out["gather"][2] < store.rerank_candidates
    agree = compare_rankings([x[exact] for x in out["gather"]], [x[exact] for x in out["full"]],
                             tie=1e-6)
    ids = out["full"][0]
    inadmissible = int((~flt.admits(ids[ids >= 0])).sum())
    n_unfiltered = store.query_topp_batch(qw, qx, TOP_K, engine="gather")[2]
    qps = {}
    queries = t1m["queries"][TOPP_QPS_BATCHES_1M[0]]
    for eng in ("full", "gather"):
        store.rerank_engine = eng
        for tag, where in (("filtered", flt), ("unfiltered", None)):
            serve = lsh.serving_fn(top_k=TOP_K, mode="topp", batch_hint=TOPP_QUERIES, where=where)
            qps[f"qps_{eng}_{tag}"] = serving_qps(serve, queries, trials=2)
    emit("filter_topp_1m", card=label, queries=TOPP_QUERIES, gather_exact=int(exact.sum()),
         gather_vs_full_on_exact=agree, inadmissible_ids_returned=inadmissible,
         mean_candidates=float(out["full"][2].mean()),
         mean_candidates_unfiltered=float(n_unfiltered.mean()), batch=TOPP_QPS_BATCHES_1M[0], **qps)
    assert agree["rows_bad"] == 0 and inadmissible == 0 and exact.sum() > 0, (agree, inadmissible)
    assert (out["full"][2] <= n_unfiltered).all()


def phase_family_lifecycle(seed: int) -> None:
    """save / load_from_disk(device="cuda") of a structured and a
    cross-polytope index (diagonals.npz), identical ids before and after."""
    from lshrs_tpu_torch import LSHRS

    rng = np.random.default_rng(seed + 10)
    X = rng.standard_normal((N_100K, DIM), dtype=np.float32)
    qx = X[:CARRY_QUERIES] + 0.5 * rng.standard_normal((CARRY_QUERIES, DIM), dtype=np.float32)
    for family, nb, r, probes in (("structured", NUM_BANDS, ROWS, 2),
                                  ("crosspolytope", CP_BANDS, CP_ROWS, 2),
                                  ("crosspolytope", CP_BANDS, CP_ROWS, 4)):
        lsh = LSHRS(dim=DIM, num_perm=NUM_PERM, num_bands=nb, rows_per_band=r, seed=7,
                    hash_family=family, multiprobe=probes, device=DEVICE)
        for i in range(0, N_100K, INGEST_BATCH):
            lsh.index(np.arange(i, min(i + INGEST_BATCH, N_100K)), X[i : i + INGEST_BATCH])
        ckpt = Path(__file__).resolve().parent / "build" / f"chip_smoke_{family}{probes}_checkpoint"
        shutil.rmtree(ckpt, ignore_errors=True)
        try:
            lsh.save_to_disk(ckpt)
            files = sorted(f.name for f in ckpt.iterdir())
            back = LSHRS.load_from_disk(ckpt, device=DEVICE)
        finally:
            shutil.rmtree(ckpt, ignore_errors=True)
        want = lsh.query_batch(qx, top_k=TOP_K)
        equal = back.query_batch(qx, top_k=TOP_K) == want
        same_diags = bool(np.array_equal(back._hasher.diagonals, lsh._hasher.diagonals))
        emit("save_load_family", family=family, files=files, equal=equal, same_diagonals=same_diags,
             multiprobe=back.stats()["multiprobe"], device=back.stats()["device"],
             nonempty=sum(1 for row in want if row))
        assert equal and same_diags and "diagonals.npz" in files and "projections.npz" not in files
        assert back.stats()["multiprobe"] == probes and back.stats()["hash_family"] == family


# ---------------------------------------------------------------------------
# phase 10: asymmetric ranking, the refinement cascade
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def plain_b2(*modules):
    """Inside the block the given modules call kernel B2's plain version on
    the same tensors on the card: the rest of their path is unchanged."""
    from lshrs_tpu_torch.ops.group_max import hamming_group_max_keys_ref

    saved = [m.hamming_group_max_keys for m in modules]
    for m in modules:
        m.hamming_group_max_keys = hamming_group_max_keys_ref
    try:
        yield
    finally:
        for m, f in zip(modules, saved):
            m.hamming_group_max_keys = f


def planted_queries(x: np.ndarray, rng) -> np.ndarray:
    """Stored vectors moved to ~0.8 cosine: ``0.8 x^ + 0.6 n^`` (the
    reference's capacity-bench probe)."""
    noise = rng.standard_normal(x.shape, dtype=np.float32)
    xn = x / np.linalg.norm(x, axis=1, keepdims=True)
    return (0.8 * xn + 0.6 * noise / np.linalg.norm(noise, axis=1, keepdims=True)).astype(
        np.float32)


def planted_recall(ids: np.ndarray, planted: np.ndarray) -> float:
    return float((ids == planted[:, None]).any(axis=1).mean())


def planted_quality(got: np.ndarray, planted, alive=None) -> dict:
    """Planted recall@10 of ``got`` beside that of the exact cosine ranking
    (the ceiling: on clustered data a 0.8-cosine plant can trail its own
    cluster's points), and recall@10 against the exact top-10. ``alive``
    drops deleted ids from the exact ranking and their queries."""
    queries, ranked = planted
    ids = np.arange(len(queries))
    keep = np.ones(len(ids), bool) if alive is None else alive(ids)
    truth = np.array([row[alive(row)][:TOP_K] if alive else row[:TOP_K] for row in ranked])
    return {"planted_recall_at_10": planted_recall(got[keep], ids[keep]),
            "exact_cosine_planted_recall_at_10": planted_recall(truth[keep], ids[keep]),
            "recall_at_10_vs_exact_cosine": recall_at_10(got[keep], truth[keep]),
            "planted_queries": int(keep.sum())}


def agreement_at_10(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.mean([len(set(x[x >= 0]) & set(y[y >= 0])) / TOP_K for x, y in zip(a, b)]))


def brute_asymmetric(store, qc: np.ndarray, flt) -> tuple[np.ndarray, np.ndarray]:
    """Exact (dots desc, id asc) top-10 over the slots ``flt`` admits: every
    admitted slot's dot on the card (a float32 product of small integers,
    exact), one int64 key per (dot, id)."""
    p = NUM_PERM
    ids = store._ids.cpu().numpy()
    slots = np.flatnonzero((ids >= 0) & flt.admits(ids))
    sel = torch.from_numpy(slots).to(DEVICE)
    planes = store._planes[sel, :p].to(torch.float32)
    q = torch.from_numpy(qc).to(DEVICE, torch.float32)
    dots = (q @ planes.T).to(torch.int64)
    key = (-dots << 32) | store._ids[sel].to(torch.int64)[None, :]
    top = torch.topk(key, TOP_K, dim=1, largest=False).values
    return (-(top >> 32)).to(torch.int32).cpu().numpy(), (top & 0xFFFFFFFF).to(torch.int32).cpu().numpy()


def phase_asymmetric_1m(s1m: dict, t1m: dict, seed: int, label: str) -> dict:
    """Asymmetric ranking on the 1M planes index (kernel B2 at offset P*127,
    shift 5, and at the int4 wire's P*7, shift 1)."""
    from lshrs_tpu_torch.ops import asymmetric as asym_mod
    from lshrs_tpu_torch.ops.asymmetric import asymmetric_shift, quantize_coords_np

    lsh, keep = s1m["lsh"], s1m["keep"]
    store = lsh._storage
    rng = np.random.default_rng(seed + 12)
    assert lsh.stats()["engine_resolved"] == "hamming" and store.hamming_storage == "planes"
    shift = asymmetric_shift(NUM_PERM, store._capacity)
    serves = {w: lsh.serving_fn(top_k=TOP_K, mode="asymmetric", coords_wire=w)
              for w in ("int8", "int4")}
    sm = {w: self_match(serves[w], [(np.arange(QPS_BATCH_1M), keep)], N_1M) for w in serves}

    # The card against a CPU copy of the store, and kernel B2 against its
    # plain version under the same refine, on the same coordinates.
    qx = keep[:CARRY_QUERIES] + 0.5 * rng.standard_normal((CARRY_QUERIES, DIM), dtype=np.float32)
    qc = quantize_coords_np(lsh._hasher.hash_batch_coords_host(qx))[0]
    dots, ids = store.query_asymmetric(qc, TOP_K)
    cpu_s, cpu = host_seconds(lambda: carry_to_cpu(store))
    query_s, (dots_c, ids_c) = host_seconds(lambda: cpu.query_asymmetric(qc, TOP_K))
    card_eq_cpu = bool(np.array_equal(ids, ids_c) and np.array_equal(dots, dots_c))
    with plain_b2(asym_mod):
        plain = store.query_asymmetric(qc[:PLAIN_QUERIES], TOP_K)
    kernel_eq_plain = bool(np.array_equal(ids[:PLAIN_QUERIES], plain[1])
                           and np.array_equal(dots[:PLAIN_QUERIES], plain[0]))

    # where=: phase 9's allowlist, equal to the CPU copy under the same
    # filter, and against brute force over the admitted subset. The
    # shifted key selects groups at 2**shift granularity, so a row may
    # swap a slot for one whose dot is within 2**shift of it.
    flt = make_filter(N_1M, rng)
    served_f = lsh.serving_fn(top_k=TOP_K, mode="asymmetric", where=flt)(qx)
    inadmissible = int((~flt.admits(served_f[served_f >= 0])).sum())
    dots_f, ids_f = store.query_asymmetric(qc, TOP_K, where=flt)
    dots_fc, ids_fc = cpu.query_asymmetric(qc, TOP_K, where=flt)
    del cpu
    filtered_eq_cpu = bool(np.array_equal(ids_f, ids_fc) and np.array_equal(dots_f, dots_fc))
    bf_dots, bf_ids = brute_asymmetric(store, qc, flt)
    rows_equal = int(((ids_f == bf_ids) & (dots_f == bf_dots)).all(axis=1).sum())
    within = bool((np.abs(bf_dots.astype(np.int64) - dots_f) < (1 << shift)).all())

    # Quality: recall@10 against phase 8's exact-cosine truth, beside
    # symmetric Hamming on the same data and queries.
    qt, truth = t1m["qx"], t1m["truth"]
    recall = {"asymmetric_int8": recall_at_10(serves["int8"](qt), truth),
              "asymmetric_int4": recall_at_10(serves["int4"](qt), truth),
              "hamming": recall_at_10(s1m["serve"](qt), truth)}
    qps = {w: serving_qps(serves[w], s1m["queries"][:2], trials=2) for w in serves}
    qps["hamming"] = serving_qps(s1m["serve"], s1m["queries"][:2], trials=2)
    emit("slice_asymmetric_1m", card=label, capacity=store._capacity, shift=shift,
         self_match=sm, card_equals_cpu=card_eq_cpu, cpu_queries=CARRY_QUERIES,
         cpu_copy_s=cpu_s, cpu_query_s=query_s, kernel_equals_plain=kernel_eq_plain,
         plain_queries=PLAIN_QUERIES, inadmissible_ids_returned=inadmissible,
         filtered_equals_cpu=filtered_eq_cpu, filtered_rows_equal_brute_force=rows_equal, filtered_rows=CARRY_QUERIES,
         filtered_within_granularity=within, served_filtered_equals_query=bool(
             np.array_equal(served_f, ids_f)),
         recall_queries=len(qt), **{f"recall_{k}": v for k, v in recall.items()},
         **{f"qps_{k}": v for k, v in qps.items()}, batch=QPS_BATCH_1M)
    assert sm["int8"] == 1.0 and sm["int4"] == 1.0, sm
    assert card_eq_cpu and kernel_eq_plain, (card_eq_cpu, kernel_eq_plain)
    assert inadmissible == 0 and filtered_eq_cpu and within and np.array_equal(served_f, ids_f)
    assert recall["asymmetric_int8"] >= recall["hamming"], recall
    emit("profile", card=label, rows=N_1M, batch=QPS_BATCH_1M, mode="asymmetric",
         coords_wire="int8", **serving_profile(serves["int8"], s1m["queries"][:2]))
    return {"recall": recall, "qps": qps}


def cascade_lsh(capacity: int):
    from lshrs_tpu_torch import LSHRS

    return LSHRS(dim=DIM, num_perm=NUM_PERM, num_bands=NUM_BANDS, rows_per_band=ROWS,
                 engine="hamming", hamming_cascade=CASCADE_BITS,
                 hamming_cascade_refine=CASCADE_REFINE, initial_capacity=capacity,
                 device=DEVICE)


def cascade_checks(lsh, qwords) -> bool:
    """Ids and distances of the cascade through kernels B2 and
    hamming_refine_topk == through their plain versions, on the card. The store must slice
    a batch as phase 2 assumed when it held B2 at the path's shapes."""
    from lshrs_tpu_torch.ops import hamming as hamming_mod
    from lshrs_tpu_torch.ops.bitpack import narrow_words_count

    store = lsh._storage
    nw = store._refine_rows().shape[1] // store._group() - 2
    assert (store._group(), store._cascade_groups(TOP_K), nw) == (
        64, CASCADE_REFINE // 64, narrow_words_count(NUM_BANDS, ROWS)), (store._group(), nw)
    got = store.query_hamming(qwords, TOP_K)
    with plain_b2(hamming_mod), plain_refine():
        plain = store.query_hamming(qwords, TOP_K)
    return bool(np.array_equal(got[0], plain[0]) and np.array_equal(got[1], plain[1]))


def phase_cascade_4m(s4m: dict, seed: int, label: str) -> dict:
    """The cascade on the packed_4m store's words (no second hash), beside
    the exact planes engine on the same words."""
    from lshrs_tpu_torch import DeviceStore
    from lshrs_tpu_torch.ops.hamming import plane_width

    src = s4m["lsh"]._storage
    rng = np.random.default_rng(seed + 13)
    alive = torch.nonzero(src._ids[:N_4M] >= 0).flatten()
    ids_alive = src._ids[alive].cpu().numpy()
    lsh = cascade_lsh(N_4M)
    for s in range(0, alive.numel(), N_1M):
        pick = alive[s : s + N_1M]
        lsh._storage.add_signature_batch(ids_alive[s : s + N_1M], src._sig_rows[pick])
    store = lsh._storage
    keep, deleted = s4m["keep"], s4m["deleted"]
    stored = np.setdiff1d(np.arange(QPS_BATCH_1M), deleted)
    serve = lsh.serving_fn(top_k=TOP_K)
    sm = self_match(serve, [(stored, keep[stored])], N_4M)
    stats = lsh.stats()["index"]

    # Kernel vs plain on 64 noisy queries; planted queries against the exact
    # planes engine on the same words.
    qx = keep[:PLAIN_QUERIES] + 0.5 * rng.standard_normal((PLAIN_QUERIES, DIM), dtype=np.float32)
    plain_eq = cascade_checks(lsh, lsh._hasher.hash_batch_words(qx))
    pq = s4m["planted"][0]
    got, exact = serve(pq), s4m["serve_planes"](pq)
    not_deleted = lambda x: ~np.isin(x, deleted)  # noqa: E731
    quality = {name: planted_quality(out, s4m["planted"], not_deleted)
               for name, out in (("cascade", got), ("planes", exact))}
    agree = agreement_at_10(got, exact)

    # Where the pool covers every group, the cascade is the exact engine
    # (2**16 slots of the same words, a pool of all 1,024 groups).
    small = 1 << 16
    kw = dict(num_bands=NUM_BANDS, rows_per_band=ROWS, initial_capacity=small,
              enable_hamming=True, device=DEVICE)
    full = DeviceStore(hamming_cascade=CASCADE_BITS, hamming_cascade_refine=small, **kw)
    exact_small = DeviceStore(**kw)
    for st in (full, exact_small):
        st.add_signature_batch(ids_alive[:small], src._sig_rows[alive[:small]])
    qw = lsh._hasher.hash_batch_words(pq[:CARRY_QUERIES])
    a, b = full.query_hamming(qw, TOP_K), exact_small.query_hamming(qw, TOP_K)
    full_pool_exact = bool(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]))
    del full, exact_small

    planes_bytes = N_4M * plane_width(NUM_PERM)
    emit("slice_cascade_4m", card=label, capacity=stats["capacity"], alive=stats["alive"],
         hamming_cascade=stats["hamming_cascade"], refine=CASCADE_REFINE,
         prefix_plane_bytes=stats["hamming_plane_bytes"], full_plane_bytes=planes_bytes,
         self_match=sm, kernel_equals_plain=plain_eq, plain_queries=PLAIN_QUERIES,
         full_pool_equals_exact=full_pool_exact, full_pool_slots=small,
         cascade=quality["cascade"], planes=quality["planes"],
         agreement_at_10_with_planes=agree)
    assert stats["capacity"] == N_4M and stats["hamming_plane_bytes"] == N_4M * CASCADE_BITS
    assert stats["hamming_plane_bytes"] * 2 == planes_bytes
    assert sm == 1.0 and plain_eq and full_pool_exact, (sm, plain_eq, full_pool_exact)
    qps = {}
    for name in ("cascade", "planes", "planes", "cascade"):  # in turns
        fn = serve if name == "cascade" else s4m["serve_planes"]
        qps.setdefault(name, []).append(serving_qps(fn, s4m["queries"], trials=2))
    emit("serving", card=label, rows=N_4M, batch=QPS_BATCH_1M, engine="hamming",
         qps_cascade=qps["cascade"], qps_planes=qps["planes"])
    return {"lsh": lsh, "quality": quality, "agreement": agree, "qps": qps}


def phase_cascade_8m(seed: int, label: str) -> dict:
    """2**23 clustered vectors drawn on the card, served by the cascade:
    past the single-pass engines' int32 key ceiling."""
    from lshrs_tpu_torch.ops.hamming import supports_hamming_grouped

    lsh = cascade_lsh(N_8M)
    keep, build_s, planted = draw_clustered(lsh, N_8M, seed + 14, planted_depth=TOP_K)
    rng = np.random.default_rng(seed + 15)
    stats = lsh.stats()["index"]
    assert not supports_hamming_grouped(NUM_PERM, stats["capacity"])  # past the ceiling
    serve = lsh.serving_fn(top_k=TOP_K)
    t0 = time.perf_counter()
    sm = self_match(serve, [(np.arange(QPS_BATCH_1M), keep)], N_8M)
    first_s = time.perf_counter() - t0  # builds the prefix planes and refine table
    qx = keep[:PLAIN_QUERIES] + 0.5 * rng.standard_normal((PLAIN_QUERIES, DIM), dtype=np.float32)
    plain_eq = cascade_checks(lsh, lsh._hasher.hash_batch_words(qx))
    planted_ids = serve(planted[0])
    quality = planted_quality(planted_ids, planted)
    queries = [rng.standard_normal((QPS_BATCH_1M, DIM), dtype=np.float32) for _ in range(2)]
    qps = serving_qps(serve, queries, trials=2)
    stats = lsh.stats()["index"]
    # Phase 14 serves these words by exact ranking: taken before the delete.
    words = lsh._storage._sig_rows[:N_8M].clone()
    emit("slice_cascade_8m", card=label, capacity=stats["capacity"], alive=stats["alive"],
         hamming_cascade=stats["hamming_cascade"], refine=CASCADE_REFINE,
         prefix_plane_bytes=stats["hamming_plane_bytes"], self_match=sm,
         kernel_equals_plain=plain_eq, plain_queries=PLAIN_QUERIES, **quality,
         qps=qps, batch=QPS_BATCH_1M,
         build_vectors_per_s=N_8M / build_s, build_s=build_s, first_batch_s=first_s)
    assert stats["capacity"] == N_8M and stats["alive"] == N_8M
    assert sm == 1.0 and plain_eq, (sm, plain_eq)
    emit("profile", card=label, rows=N_8M, batch=QPS_BATCH_1M, engine="hamming",
         hamming_cascade=CASCADE_BITS, **serving_profile(serve, queries[:1]))

    deleted = rng.choice(N_8M, N_8M // 100, replace=False)
    lsh.delete(deleted.tolist())
    out = lsh.serving_fn(top_k=TOP_K)(keep)
    kept = ~np.isin(np.arange(QPS_BATCH_1M), deleted)
    leaked = int(np.isin(out, deleted).sum())
    sm_after = float((out[kept, 0] == np.arange(QPS_BATCH_1M)[kept]).mean())
    stats = lsh.stats()["index"]
    emit("delete_cascade_8m", deleted=int(deleted.size), deleted_queried=int((~kept).sum()),
         tombstones=stats["tombstones"], deleted_ids_returned=leaked,
         survivor_self_match=sm_after)
    assert leaked == 0 and sm_after == 1.0 and stats["tombstones"] == deleted.size
    return {"quality": quality, "qps": qps, "build_s": build_s, "queries": queries,
            "serve": lsh.serving_fn(top_k=TOP_K), "words": words, "keep": keep,
            "planted": planted, "planted_ids": planted_ids}


# ---------------------------------------------------------------------------
# phase 11: the bucketed engine, in-place retuning, MIPS
# ---------------------------------------------------------------------------

BUCKET_BATCHES = (1024, 16384)
RETUNE_DELETE = 1000


def bucket_vs_scan(bucket, scan, queries) -> dict:
    """``query_batch`` ids of a bucketed and a scan index on the same
    words: equal when no bucket run overflowed; otherwise each rank's
    count is at most the scan's (the scan's is the exact top-k) and the
    ids agree at ``agreement_at_10``."""
    store = bucket._storage
    before = store.stats()["bucket_overflows"]
    qw = bucket._hash_query_words(queries)
    bc, bi = store.query_topk(qw, TOP_K)
    overflows = store.stats()["bucket_overflows"] - before
    sc, si = scan._storage.query_topk(qw, TOP_K)
    out = {"queries": len(queries), "overflows": overflows,
           "equal": bool(np.array_equal(bi, si) and np.array_equal(bc, sc)),
           "counts_bounded_by_scan": bool((bc <= sc).all()),
           "agreement_at_10": agreement_at_10(bi, si)}
    if overflows == 0:
        assert out["equal"], out
    assert out["counts_bounded_by_scan"], out
    return out


def bucket_turns(pair: dict, queries: dict, rows: int, label: str) -> dict:
    """Bucket and scan in turns at each batch size: ``query_batch`` QPS
    (the user's entry point, host lists included) and the engine's own ms
    per batch (CUDA events around ``query_topk_ids`` on the batch's device
    words: the bucket engine's overflow count synchronises, the scan's
    launch does not)."""
    out = {}
    for q, batch in queries.items():
        for name in ("bucket", "scan", "scan", "bucket"):
            lsh = pair[name]
            rate = serving_qps(lambda x, lsh=lsh: lsh.query_batch(x, top_k=TOP_K), batch,
                               trials=2)
            qw = lsh._hash_query_words(batch[0])
            engine_ms = median_ms(lambda lsh=lsh, qw=qw: lsh._storage.query_topk_ids(qw, TOP_K),
                                  reps=5)
            out.setdefault(f"{name}_q{q}", []).append({"qps": rate, "engine_ms": engine_ms})
            emit("serving", card=label, rows=rows, batch=q, engine="collision", query_mode=name,
                 entry="query_batch", qps=rate, engine_ms_per_batch=engine_ms)
    return out


def phase_bucket(s100: dict, s1m: dict, seed: int, label: str) -> None:
    """query_mode="bucket" beside the scan (kernel B1) on the 100k words
    and on the 1M clustered words under engine="collision"."""
    from lshrs_tpu_torch import LSHRS

    rng = np.random.default_rng(seed + 11)
    kw = dict(dim=DIM, num_perm=NUM_PERM, num_bands=NUM_BANDS, rows_per_band=ROWS, device=DEVICE)
    X = s100["X"]
    bucket = LSHRS(query_mode="bucket", **kw)
    for i in range(0, N_100K, INGEST_BATCH):
        bucket.index(np.arange(i, min(i + INGEST_BATCH, N_100K)), X[i : i + INGEST_BATCH])
    pair = {"bucket": bucket, "scan": s100["lsh"]}
    assert torch.equal(bucket._storage._sig_t, pair["scan"]._storage._sig_t)
    noisy = X[:CARRY_QUERIES] + 0.5 * rng.standard_normal((CARRY_QUERIES, DIM), dtype=np.float32)
    held = {"noisy": bucket_vs_scan(bucket, pair["scan"], noisy),
            "random": bucket_vs_scan(bucket, pair["scan"], s100["queries"][0])}
    sm = float(np.mean([row[:1] == [i] for i, row in
                        enumerate(bucket.query_batch(X[:QPS_BATCH_100K], top_k=TOP_K))]))
    emit("bucket_100k", card=label, rows=N_100K, self_match=sm, held_to_scan=held,
         bucket_cap=bucket._storage.bucket_cap)
    assert sm == 1.0, sm
    queries = {q: [rng.standard_normal((q, DIM), dtype=np.float32) for _ in range(2)]
               for q in BUCKET_BATCHES}
    turns = bucket_turns(pair, queries, N_100K, label)
    emit("profile", card=label, rows=N_100K, batch=BUCKET_BATCHES[-1], engine="collision",
         query_mode="bucket", entry="query_batch",
         **serving_profile(lambda x: bucket.query_batch(x, top_k=TOP_K),
                           queries[BUCKET_BATCHES[-1]][:1]))
    del bucket, pair

    # The 1M clustered words (phase 4's store) under collision ranking.
    words = s1m["lsh"]._storage.state_arrays()
    pair = {}
    for mode in ("bucket", "scan"):
        lsh = LSHRS(engine="collision", query_mode=mode, **kw)
        lsh._storage.load_state_arrays(words)
        pair[mode] = lsh
    del words
    keep = s1m["keep"]
    noisy = keep[:CARRY_QUERIES] + 0.2 * rng.standard_normal((CARRY_QUERIES, DIM), dtype=np.float32)
    held = bucket_vs_scan(pair["bucket"], pair["scan"], noisy)
    out = pair["bucket"].query_batch(keep[:QPS_BATCH_1M], top_k=TOP_K)
    sm = float(np.mean([row[:1] == [i] for i, row in enumerate(out)]))
    queries = {q: [keep[rng.integers(0, len(keep), q)]
                   + 0.2 * rng.standard_normal((q, DIM), dtype=np.float32) for _ in range(2)]
               for q in BUCKET_BATCHES}
    turns_1m = bucket_turns(pair, queries, N_1M, label)
    emit("bucket_1m", card=label, rows=N_1M, capacity=pair["bucket"]._storage._capacity,
         held_to_scan=held, self_match_top1=sm,
         bucket_overflows_total=pair["bucket"].stats()["index"]["bucket_overflows"])
    emit("bucket_turns", card=label, at_100k=turns, at_1m=turns_1m)
    assert sm > 0.99, sm  # a run of identical words past the window can hide the vector


def retune_serving_checks(lsh, queries) -> dict:
    """Closures around a rehash and a delete: a strict closure taken
    before the rehash raises stale; an ``auto_refresh=True`` one serves
    the ids of a fresh closure after the rehash and after the delete."""
    strict = lsh.serving_fn(top_k=TOP_K)
    auto = lsh.serving_fn(top_k=TOP_K, auto_refresh=True)
    strict(queries)
    auto(queries)
    seconds, _ = host_seconds(lambda: (lsh.rehash(hash_family="structured"),
                                       torch.cuda.synchronize()))
    try:
        strict(queries)
        stale = False
    except RuntimeError as e:
        stale = "stale" in str(e)
    after_rehash = bool(np.array_equal(auto(queries), lsh.serving_fn(top_k=TOP_K)(queries)))
    deleted = np.random.default_rng(3).choice(N_100K, RETUNE_DELETE, replace=False)
    lsh.delete(deleted.tolist())
    served = auto(queries)
    after_delete = bool(np.array_equal(served, lsh.serving_fn(top_k=TOP_K)(queries)))
    out = {"strict_closure_stale": stale, "auto_refresh_equals_fresh_after_rehash": after_rehash,
           "auto_refresh_equals_fresh_after_delete": after_delete,
           "deleted_ids_returned": int(np.isin(served, deleted).sum()),
           "structured_rehash_s": seconds}
    assert stale and after_rehash and after_delete and out["deleted_ids_returned"] == 0, out
    return out


def phase_retune_100k(seed: int, label: str) -> dict:
    """rehash on a 100k x 768 float32-payload index: to the structured
    family (words == the native C and NumPy FWHT of the same vectors),
    serving closures around it, then to 32 x 8 (B1 at 32 band words;
    top-k and top-p == a CPU copy on the same words)."""
    from lshrs_tpu_torch import LSHRS
    from lshrs_tpu_torch.hash.fwht import _structured_coords_numpy
    from lshrs_tpu_torch.ops.bitpack import pack_bits_to_words_np, words_to_numpy

    rng = np.random.default_rng(seed + 12)
    X = rng.standard_normal((N_100K, DIM), dtype=np.float32)
    lsh = LSHRS(dim=DIM, num_perm=NUM_PERM, num_bands=NUM_BANDS, rows_per_band=ROWS,
                store_vectors=True, device=DEVICE)
    for i in range(0, N_100K, INGEST_BATCH):
        lsh.index(np.arange(i, min(i + INGEST_BATCH, N_100K)), X[i : i + INGEST_BATCH])
    queries = X[:QPS_BATCH_100K] + 0.3 * rng.standard_normal((QPS_BATCH_100K, DIM),
                                                           dtype=np.float32)
    closures = retune_serving_checks(lsh, queries)
    store = lsh._storage
    words = words_to_numpy(store._sig_rows[:N_100K])
    # deleted slots keep their words: the rebuild covers every slot
    host_words = lsh._hasher.hash_batch_words_host(X)
    n_np = HASH_ROWS // 4
    bits = _structured_coords_numpy(X[:n_np], lsh._hasher.diagonals, NUM_PERM) > 0
    numpy_words = pack_bits_to_words_np(bits, num_bands=NUM_BANDS, rows_per_band=ROWS)
    parity = {"words_equal_native_c": bool(np.array_equal(words, host_words)),
              "words_equal_numpy_fwht": bool(np.array_equal(words[:n_np], numpy_words)),
              "numpy_rows": n_np}
    assert parity["words_equal_native_c"] and parity["words_equal_numpy_fwht"], parity

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lsh.rehash(num_bands=CP_BANDS, rows_per_band=CP_ROWS)
    torch.cuda.synchronize()
    rehash_s = time.perf_counter() - t0
    assert store.words == CP_BANDS and lsh.stats()["hash_family"] == "structured"
    from lshrs_tpu_torch.ops.group_max import group_max_keys

    before = group_max_keys.launches_by_shape[CP_BANDS, 1]
    served = lsh.serving_fn(top_k=TOP_K)(queries)
    launched = group_max_keys.launches_by_shape[CP_BANDS, 1] - before
    qx = queries[:CARRY_QUERIES]
    qw = lsh._hasher.hash_batch_words(qx)
    counts, ids = store.query_topk(qw, TOP_K)
    topp = store.query_topp_batch(qw, qx, TOP_K)
    cpu = carry_to_cpu(store)
    counts_cpu, ids_cpu = cpu.query_topk(qw.cpu(), TOP_K)
    topp_cpu = cpu.query_topp_batch(qw.cpu(), qx, TOP_K)
    del cpu
    agree = compare_rankings(topp, topp_cpu)
    out = {"b1_launches_32x1": launched, "rehash_32x8_s": rehash_s,
           "rehash_32x8_rows_per_s": store._capacity / rehash_s,
           "topk_card_equals_cpu": bool(np.array_equal(ids, ids_cpu)
                                        and np.array_equal(counts, counts_cpu)),
           "topp_card_vs_cpu": agree, "served_equals_store": bool(np.array_equal(served[:CARRY_QUERIES], ids)),
           "colliding_top1": int((counts[:, 0] > 0).sum())}
    emit("retune_100k", card=label, rows=N_100K, capacity=store._capacity, **closures, **parity,
         **out)
    assert launched > 0 and out["topk_card_equals_cpu"] and out["served_equals_store"], out
    assert agree["rows_bad"] == 0 and agree["max_abs_cos_err"] < 1e-5, agree
    return out


def phase_retune_1m_int8(t1m: dict, label: str) -> dict:
    """rehash to 32 x 8, then retrain, on phase 8's 2**20 int8-payload
    index: seconds and rows/s; top-p gather recall@10 against phase 8's
    exact-cosine truth beside 16 x 16's; self-match; top-k through
    Hamming (kernel B2) on the rebuilt planes."""
    import lshrs_tpu_torch.core.main as core

    lsh, qx, truth, keep = t1m["lsh"], t1m["qx"], t1m["truth"], t1m["keep"]
    store = lsh._storage
    store.rerank_engine = "gather"
    alive = np.array([i for i in range(TOPP_QUERIES) if i in store._slot_of])
    recall = {"16x16": t1m["recall"]["gather"]["recall_at_10"]}
    seconds = {}

    def quality(name: str) -> None:
        serve = lsh.serving_fn(top_k=TOP_K, mode="topp", batch_hint=TOPP_QUERIES)
        recall[name] = recall_at_10(serve(qx)[0], truth)
        ids = serve(keep[alive])[0]
        sm = float((ids[:, 0] == alive).mean())
        topk = lsh.serving_fn(top_k=TOP_K)(keep[alive])
        emit("retune_1m_" + name, card=label, recall_at_10=recall[name], self_match=sm,
             topk_self_match=float((topk[:, 0] == alive).mean()),
             ranking=lsh.stats()["ranking"], hash_family=lsh.stats()["hash_family"],
             planes=list(store._planes.shape) if store._planes is not None else None)
        assert sm == 1.0 and float((topk[:, 0] == alive).mean()) == 1.0, name

    torch.cuda.synchronize()
    seconds["rehash_32x8_s"], _ = host_seconds(
        lambda: (lsh.rehash(num_bands=CP_BANDS, rows_per_band=CP_ROWS), torch.cuda.synchronize()))
    assert store.words == CP_BANDS and store._planes is None
    quality("32x8")

    fit = core.fit_itq_projection
    rehash = store.rehash
    clock = {"fit_s": 0.0, "rehash_s": 0.0}

    def timed(key, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            clock[key] += time.perf_counter() - t0
            return out
        return run

    core.fit_itq_projection = timed("fit_s", fit)
    store.rehash = timed("rehash_s", rehash)
    try:
        seconds["retrain_s"], info = host_seconds(lambda: lsh.retrain())
    finally:
        core.fit_itq_projection = fit
        del store.rehash
    seconds.update(retrain_fit_s=clock["fit_s"], retrain_rehash_s=clock["rehash_s"])
    assert lsh.stats()["hash_family"] == "learned"
    quality("retrained")
    out = {**seconds, "rows_per_s_32x8": N_1M / seconds["rehash_32x8_s"],
           "rows_per_s_retrain_rehash": N_1M / clock["rehash_s"],
           **{f"recall_{k}": v for k, v in recall.items()},
           "fit_sample_rows": info["sample_rows"]}
    emit("retune_1m_int8", card=label, rows=N_1M, **out)
    return out


def phase_mips_100k(t100: dict, seed: int, label: str) -> dict:
    """similarity="dot" on 100k x 768 vectors with norms in [0.5, 2], a
    float32 payload: top-p scores == float64 host inner products within
    1e-4 relative, top-p == a CPU copy on the same words, recall@10 of
    top-p and top-k (B1) against the brute-force inner-product top-10,
    QPS beside the cosine 100k top-p."""
    from lshrs_tpu_torch import LSHRS
    from lshrs_tpu_torch.ops.group_max import group_max_keys

    rng = np.random.default_rng(seed + 13)
    X = rng.standard_normal((N_100K, DIM), dtype=np.float32)
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    X *= rng.uniform(0.5, 2.0, (N_100K, 1)).astype(np.float32)
    max_norm = float(np.linalg.norm(X, axis=1).max()) * 1.001
    lsh = LSHRS(dim=DIM, num_perm=NUM_PERM, num_bands=NUM_BANDS, rows_per_band=ROWS,
                similarity="dot", max_norm=max_norm, store_vectors=True, device=DEVICE)
    for i in range(0, N_100K, INGEST_BATCH):
        lsh.index(np.arange(i, min(i + INGEST_BATCH, N_100K)), X[i : i + INGEST_BATCH])
    store = lsh._storage
    assert store.dim == DIM + 1 and lsh.stats()["similarity"] == "dot"
    # Stored vectors plus noise of norm ~0.3 (the vectors' norms are 0.5-2).
    noise = 0.3 / np.sqrt(DIM)
    qx = X[:CARRY_QUERIES] + noise * rng.standard_normal((CARRY_QUERIES, DIM), dtype=np.float32)
    serve = lsh.serving_fn(top_k=TOP_K, mode="topp", batch_hint=TOPP_BATCH_100K)
    ids, sims, n = serve(qx)
    exact = np.einsum("qd,qkd->qk", qx.astype(np.float64), X[np.maximum(ids, 0)].astype(np.float64))
    live = ids >= 0
    # The error relative to the score's scale |q| * max_norm (a score is
    # an augmented cosine times it): exact dots near 0 have no relative
    # digits of their own.
    scale = np.linalg.norm(qx.astype(np.float64), axis=1, keepdims=True) * max_norm
    rel = (np.abs(sims - exact) / scale)[live]
    dots = torch.from_numpy(qx).to(DEVICE).double() @ torch.from_numpy(X).to(DEVICE).double().T
    truth = torch.topk(dots, TOP_K, dim=1).indices.cpu().numpy()
    del dots
    qa = lsh._augment_query(qx)
    qw = lsh._hash_query_words(qa)
    cpu = carry_to_cpu(store)
    want = cpu.query_topp_batch(qw.cpu(), qa, TOP_K)
    del cpu
    got = store.query_topp_batch(qw, qa, TOP_K)
    agree = compare_rankings(got, want)
    before = group_max_keys.launches
    topk = np.array([row + [-1] * (TOP_K - len(row)) for row in lsh.query_batch(qx, top_k=TOP_K)])
    b1 = group_max_keys.launches - before
    queries = [X[:TOPP_BATCH_100K] + noise * rng.standard_normal((TOPP_BATCH_100K, DIM),
                                                               dtype=np.float32) for _ in range(4)]
    qps = {}
    for name, fn in (("dot", serve), ("cosine", t100["serve"]), ("cosine", t100["serve"]),
                     ("dot", serve)):
        qps.setdefault(name, []).append(serving_qps(fn, queries, trials=2))
    out = {"max_score_err_rel_to_q_norm_x_max_norm": float(rel.max()),
           "max_abs_score_err": float(np.abs(sims - exact)[live].max()), "scored": int(live.sum()),
           "topp_recall_at_10": recall_at_10(ids, truth),
           "topk_recall_at_10": recall_at_10(topk, truth), "b1_launches_topk": b1,
           "topp_card_vs_cpu": agree, "mean_candidates": float(n.mean()),
           "rerank_engine": store.stats()["rerank_engine"], "max_norm": max_norm,
           "qps_topp_dot": qps["dot"], "qps_topp_cosine": qps["cosine"],
           "batch": TOPP_BATCH_100K}
    emit("mips_100k", card=label, rows=N_100K, queries=CARRY_QUERIES, **out)
    assert live.sum() > 0 and out["max_score_err_rel_to_q_norm_x_max_norm"] < 1e-4, out
    assert agree["rows_bad"] == 0 and agree["max_abs_cos_err"] < 1e-5, agree
    assert b1 > 0, b1
    return out


# ---------------------------------------------------------------------------
# phase 12: bulk ingestion (create_signatures) and the bucket backends
# ---------------------------------------------------------------------------

INGEST_PREFETCH = 2
MEMORY_DELETE = 1000
MEMORY_QPS_BATCH = 1024


def lshrs_16x16(**kw):
    from lshrs_tpu_torch import LSHRS

    kw.setdefault("device", DEVICE)
    return LSHRS(dim=DIM, num_perm=NUM_PERM, num_bands=NUM_BANDS, rows_per_band=ROWS, **kw)


def states_equal(a, b) -> bool:
    """``state_arrays()`` of two stores equal bit for bit, key for key."""
    sa, sb = a._storage.state_arrays(), b._storage.state_arrays()
    return set(sa) == set(sb) and all(np.array_equal(sa[k], sb[k]) for k in sa)


def timed_build(build) -> tuple[float, object]:
    """Seconds of ``build()`` with the card synchronised on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = build()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def watch_pipeline(lsh) -> list:
    """Record, for each batch ``lsh`` prepares, whether a thread other than
    this one prepared it (the pipeline's worker)."""
    import threading

    main_thread, seen = threading.get_ident(), []
    prepare = lsh._prepare_index_batch

    def recording(*a):
        seen.append(threading.get_ident() != main_thread)
        return prepare(*a)

    lsh._prepare_index_batch = recording
    return seen


def build_profile(build) -> dict:
    """torch.profiler over one build: wall and device ms, the device-busy
    share, and the host-to-device upload's share of the device time and of
    the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_s, _ = timed_build(build)
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in dev) / 1e3
    upload_ms = sum(e.self_device_time_total for e in dev if "HtoD" in e.key) / 1e3
    dev.sort(key=lambda e: e.self_device_time_total, reverse=True)
    return {"wall_ms": wall_s * 1e3, "device_ms": device_ms,
            "device_busy_share": device_ms / (wall_s * 1e3), "upload_ms": upload_ms,
            "upload_share_of_device": upload_ms / device_ms if device_ms else None,
            "upload_share_of_wall": upload_ms / (wall_s * 1e3),
            "top": [{"name": e.key[:90], "ms": e.self_device_time_total / 1e3, "calls": e.count}
                    for e in dev[:6]]}


def clustered_1m_array(seed: int) -> np.ndarray:
    """Phase 4's 2**20 clustered vectors as one host array, drawn again
    from the seed (``clustered_1m``: the same batches, the same values)."""
    _, _, batches = clustered_1m(seed)
    X = np.empty((N_1M, DIM), np.float32)
    for off, xb in batches:
        X[off : off + INGEST_BATCH] = xb
    return X


def phase_ingest_1m(ref1m: dict, seed: int, label: str) -> dict:
    """``create_signatures(format="numpy")`` over phase 4's 2**20 clustered
    vectors in 65,536-row batches, in turns with ``index()`` of the same
    batches: equal stores, Hamming ranking through B2 with the ids of
    phase 4's index; a profiled build; then ``hash_mode="host"``, whose
    words must equal ``hash_batch_dense_host`` of the batches appended by
    ``add_signature_batch``."""
    import os

    X = clustered_1m_array(seed)
    ids = np.arange(N_1M)
    cpus = len(os.sched_getaffinity(0))

    def create(lsh):
        lsh.create_signatures(format="numpy", vectors=X, batch_size=INGEST_BATCH,
                              prefetch=INGEST_PREFETCH)
        return lsh

    def index(lsh):
        for off in range(0, N_1M, INGEST_BATCH):
            lsh.index(ids[off : off + INGEST_BATCH], X[off : off + INGEST_BATCH])
        return lsh

    builds, kept, pipelined = {}, {}, []
    for how in ("create_signatures", "index", "index", "create_signatures"):
        lsh = lshrs_16x16()
        if how == "create_signatures":
            pipelined = watch_pipeline(lsh)
        seconds, lsh = timed_build(lambda: (create if how == "create_signatures" else index)(lsh))
        builds.setdefault(how, []).append(seconds)
        kept.setdefault(how, lsh)
        del lsh
    equal = states_equal(kept["create_signatures"], kept["index"])
    del kept["index"]
    lsh = kept.pop("create_signatures")
    stats = lsh.stats()
    serve = lsh.serving_fn(top_k=TOP_K)
    sm = self_match(serve, [(ids[:QPS_BATCH_1M], X[:QPS_BATCH_1M])], N_1M)
    same_as_phase4 = {name: bool(np.array_equal(serve(q), want))
                      for name, (q, want) in ref1m.items()}
    prof = build_profile(lambda: create(lshrs_16x16()))

    # hash_mode="host": the worker thread hashes on the host.
    host = lshrs_16x16(hash_mode="host")
    host_pipelined = watch_pipeline(host)
    host_s, _ = timed_build(lambda: create(host))
    plain = lshrs_16x16(hash_mode="host")

    def append_dense():
        for off in range(0, N_1M, INGEST_BATCH):
            xb = X[off : off + INGEST_BATCH]
            plain._storage.add_signature_batch(ids[off : off + INGEST_BATCH],
                                               plain._hasher.hash_batch_dense_host(xb))

    plain_s, _ = timed_build(append_dense)
    host_equal = states_equal(host, plain)
    host_sm = self_match(host.serving_fn(top_k=TOP_K), [(ids[:QPS_BATCH_1M], X[:QPS_BATCH_1M])],
                         N_1M)
    out = {"cpus": cpus, "pipeline_ran": bool(pipelined) and all(pipelined),
           "batches": len(pipelined), "prefetch": INGEST_PREFETCH,
           "create_signatures_s": builds["create_signatures"], "index_s": builds["index"],
           "create_signatures_vectors_per_s": [N_1M / s for s in builds["create_signatures"]],
           "index_vectors_per_s": [N_1M / s for s in builds["index"]],
           "states_equal": equal, "ranking": stats["ranking"],
           "engine_resolved": stats["engine_resolved"], "capacity": stats["index"]["capacity"],
           "self_match": sm, "ids_equal_phase4": same_as_phase4, "profile": prof,
           "host": {"create_signatures_s": host_s, "vectors_per_s": N_1M / host_s,
                    "pipeline_ran": bool(host_pipelined) and all(host_pipelined),
                    "dense_append_s": plain_s, "states_equal": host_equal,
                    "self_match": host_sm}}
    emit("ingest_1m", card=label, rows=N_1M, batch=INGEST_BATCH, **out)
    assert equal and host_equal, (equal, host_equal)
    assert out["pipeline_ran"] == out["host"]["pipeline_ran"] == (cpus >= 2), out
    assert stats["ranking"] == "hamming" and stats["index"]["alive"] == N_1M, stats
    assert sm == 1.0 and host_sm == 1.0, (sm, host_sm)
    assert all(same_as_phase4.values()), same_as_phase4
    return out


def phase_files_100k(tmp: Path, seed: int, label: str) -> dict:
    """Phase 3's 100k vectors saved as ``.npy`` (ids 0..n-1) and as
    ``.npz`` with ids ``7*i + 3``, loaded by ``create_signatures(format=
    "npy" | "npz", source=path)``: each store equals ``index()`` of the
    same batches and serves the file's ids through B1, self-match 1.0."""
    X = np.random.default_rng(seed).standard_normal((N_100K, DIM), dtype=np.float32)
    files = {"npy": (tmp / "x100k.npy", np.arange(N_100K)),
             "npz": (tmp / "x100k.npz", 7 * np.arange(N_100K) + 3)}
    np.save(files["npy"][0], X)
    np.savez(files["npz"][0], vectors=X, indices=files["npz"][1])
    out, served = {}, {}
    batches = [(i, min(i + QPS_BATCH_100K, N_100K)) for i in range(0, N_100K, QPS_BATCH_100K)]
    for fmt, (path, ids) in files.items():
        lsh = lshrs_16x16()
        seconds, _ = timed_build(lambda: lsh.create_signatures(
            format=fmt, source=path, batch_size=INGEST_BATCH, prefetch=INGEST_PREFETCH))
        plain = lshrs_16x16()
        for i in range(0, N_100K, INGEST_BATCH):
            plain.index(ids[i : i + INGEST_BATCH], X[i : i + INGEST_BATCH])
        serve = lsh.serving_fn(top_k=TOP_K)
        hits = 0
        for lo, hi in batches:
            got = serve(X[lo:hi])
            hits += int((got[:, 0] == ids[lo:hi]).sum())
            served.setdefault(fmt, []).append(got)
        out[fmt] = {"seconds": seconds, "vectors_per_s": N_100K / seconds,
                    "states_equal": states_equal(lsh, plain), "self_match": hits / N_100K,
                    "ids_are_the_files": bool(np.isin(np.concatenate(served[fmt]).ravel(),
                                                      np.append(ids, -1)).all()),
                    "ranking": lsh.stats()["ranking"]}
    emit("files_100k", card=label, rows=N_100K, **out)
    for fmt, r in out.items():
        assert r["states_equal"] and r["self_match"] == 1.0 and r["ids_are_the_files"], (fmt, r)
        assert r["ranking"] == "collision", r
    return {"X": X, "files": files, "served_npy": np.concatenate(served["npy"])}


def phase_custom_storage_100k(f100: dict, label: str) -> None:
    """``LSHRS(storage=DeviceStore(device="cuda"))``: the store's device
    wins over ``device=``, and the ids served equal files_100k's."""
    from lshrs_tpu_torch import DeviceStore

    store = DeviceStore(num_bands=NUM_BANDS, rows_per_band=ROWS, dim=DIM, device=DEVICE)
    lsh = lshrs_16x16(storage=store, device="cpu")  # the store's device wins
    path, _ = f100["files"]["npy"]
    seconds, _ = timed_build(lambda: lsh.create_signatures(format="npy", source=path,
                                                           batch_size=INGEST_BATCH))
    serve = lsh.serving_fn(top_k=TOP_K)
    X = f100["X"]
    got = np.concatenate([serve(X[i : i + QPS_BATCH_100K])
                          for i in range(0, N_100K, QPS_BATCH_100K)])
    stats = lsh.stats()
    out = {"backend": stats["backend"], "device": stats["device"],
           "hasher_device": str(lsh._hasher.device), "seconds": seconds,
           "ids_equal_files_100k": bool(np.array_equal(got, f100["served_npy"]))}
    emit("custom_storage_100k", card=label, rows=N_100K, **out)
    assert out["backend"] == "device" and lsh._hasher.device == store.device, out
    assert store.device == torch.device(DEVICE) and out["ids_equal_files_100k"], out


def phase_memory_100k(f100: dict, seed: int, label: str) -> dict:
    """``backend="memory"`` over the 100k vectors through
    ``create_signatures``, against its device twin (``hash_mode="host"``,
    ``engine="collision"``: the same host words, served by B1) on 256
    queries: top-10 and ``top_k=None``, under phase 9's allowlist, with
    ``multiprobe=2`` (each a ``storage=`` view of the same stores) and top-p
    through ``vector_fetch_fn``; then a 1,000-id delete and
    ``query_batch`` QPS of both at Q=1,024."""
    X = f100["X"]
    rng = np.random.default_rng(seed + 17)

    def fetch(idx):
        return X[np.asarray(idx, dtype=np.int64)]

    mem = lshrs_16x16(backend="memory", vector_fetch_fn=fetch)
    twin = lshrs_16x16(hash_mode="host", engine="collision", vector_fetch_fn=fetch)
    build = {}
    for name, lsh in (("memory", mem), ("twin", twin)):
        build[name], _ = timed_build(lambda lsh=lsh: lsh.create_signatures(
            format="numpy", vectors=X, batch_size=INGEST_BATCH, prefetch=INGEST_PREFETCH))
    mem2 = lshrs_16x16(storage=mem._storage, multiprobe=2)
    twin2 = lshrs_16x16(storage=twin._storage, hash_mode="host", engine="collision",
                        multiprobe=2)
    flt = make_filter(N_100K, rng)
    qx = X[:CARRY_QUERIES] + 0.5 * rng.standard_normal((CARRY_QUERIES, DIM), dtype=np.float32)
    checks = {"top10": 0, "all": 0, "filtered_top10": 0, "filtered_all": 0,
              "multiprobe2_top10": 0, "multiprobe2_all": 0, "topp_ids": 0}
    worst, candidates = 0.0, []
    for q in qx:
        checks["top10"] += mem.query(q, top_k=TOP_K) == twin.query(q, top_k=TOP_K)
        every = mem.query(q, top_k=None)
        candidates.append(len(every))
        checks["all"] += every == twin.query(q, top_k=None)
        checks["filtered_top10"] += (mem.query(q, top_k=TOP_K, where=flt)
                                     == twin.query(q, top_k=TOP_K, where=flt))
        checks["filtered_all"] += (mem.query(q, top_k=None, where=flt)
                                   == twin.query(q, top_k=None, where=flt))
        checks["multiprobe2_top10"] += (mem2.query(q, top_k=TOP_K)
                                        == twin2.query(q, top_k=TOP_K))
        checks["multiprobe2_all"] += mem2.query(q, top_k=None) == twin2.query(q, top_k=None)
        a, b = mem.query(q, top_p=0.5), twin.query(q, top_p=0.5)
        checks["topp_ids"] += [i for i, _ in a] == [i for i, _ in b]
        if a and len(a) == len(b):
            worst = max(worst, float(np.abs(np.subtract([s for _, s in a],
                                                        [s for _, s in b])).max()))
    gone = rng.choice(N_100K, MEMORY_DELETE, replace=False)
    mem.delete(gone.tolist())
    twin.delete(gone.tolist())
    probe = np.concatenate([X[gone[:CARRY_QUERIES]], qx])
    returned = equal_after = 0
    for q in probe:
        a, b = mem.query(q, top_k=None), twin.query(q, top_k=None)
        returned += len(set(a) & set(gone.tolist())) + len(set(b) & set(gone.tolist()))
        equal_after += a == b
    batches = [X[rng.integers(0, N_100K, MEMORY_QPS_BATCH)]
               + 0.5 * rng.standard_normal((MEMORY_QPS_BATCH, DIM), dtype=np.float32)
               for _ in range(2)]
    qps = {}
    for name in ("memory", "twin", "twin", "memory"):
        lsh = mem if name == "memory" else twin
        qps.setdefault(name, []).append(serving_qps(
            lambda x, lsh=lsh: lsh.query_batch(x, top_k=TOP_K), batches, trials=1))
    out = {"build_s": build, "build_vectors_per_s": {k: N_100K / v for k, v in build.items()},
           "queries": CARRY_QUERIES, "equal": checks, "max_abs_topp_score_diff": worst,
           "mean_candidates": float(np.mean(candidates)), "deleted": MEMORY_DELETE,
           "deleted_returned": returned, "equal_after_delete": equal_after,
           "queries_after_delete": len(probe), "query_batch_qps": qps,
           "qps_batch": MEMORY_QPS_BATCH, "backend": mem.stats()["backend"],
           "memory_device": mem.stats()["device"]}
    emit("memory_100k", card=label, rows=N_100K, **out)
    assert all(v == CARRY_QUERIES for v in checks.values()), checks
    assert worst <= 1e-6 and returned == 0 and equal_after == len(probe), out
    assert out["backend"] == "memory" and out["memory_device"] is None, out
    return out


# ---------------------------------------------------------------------------
# phase 14: the chunked fallbacks (past the int32 key ceiling, past 64 bands,
# below the group)
# ---------------------------------------------------------------------------

EXACT_CHECK_QUERIES = 1024
BANDS128 = (128, 2)


def exact_lsh(capacity: int, **kw):
    """The 16 x 16 index with the reference's ``engine="auto"``: Hamming
    ranking past 2**19 slots."""
    from lshrs_tpu_torch import LSHRS

    return LSHRS(dim=DIM, num_perm=NUM_PERM, num_bands=NUM_BANDS, rows_per_band=ROWS,
                 engine="auto", initial_capacity=capacity, device=DEVICE, **kw)


def fill_words(store, words: torch.Tensor, ids: np.ndarray) -> None:
    for s in range(0, len(ids), N_1M):
        store.add_signature_batch(ids[s : s + N_1M], words[s : s + N_1M])


def chunked_equals_grouped_1m(s1m: dict, qx: np.ndarray) -> tuple[bool, int]:
    """The planes and packed chunked cores called on the 1M store's own
    tensors (2**20 slots, below the ceiling) == its grouped B2 engine, bit
    for bit (the reference's ``test_grouped_and_chunked_agree``, on the
    card). Returns ``(equal, B2 launches of the grouped run)``."""
    from lshrs_tpu_torch.ops.group_max import hamming_group_max_keys
    from lshrs_tpu_torch.ops.hamming import (
        hamming_topk_chunked_core,
        hamming_topk_packed_chunked_core,
    )
    from lshrs_tpu_torch.ops.scan import compute_chunk_ranks

    lsh = s1m["lsh"]
    store = lsh._storage
    qw = lsh._hasher.hash_batch_words(qx)
    grouped, b2 = launched(hamming_group_max_keys, lambda: store.query_hamming(qw, TOP_K))
    ranks = compute_chunk_ranks(store._ids, chunk=store.chunk)
    outs = [
        hamming_topk_chunked_core(store._planes, store._ids, ranks, store._planes_rows(qw),
                                  k=TOP_K, chunk=store.chunk, num_perm=NUM_PERM),
        hamming_topk_packed_chunked_core(store._sig_t, store._ids, ranks, qw,
                                         num_perm=NUM_PERM, k=TOP_K, chunk=store.chunk),
    ]
    return all(same(grouped, [t.cpu().numpy() for t in out]) for out in outs), b2


def phase_exact_8m(c8m: dict, s1m: dict, seed: int, label: str) -> dict:
    """cascade_8m's 2**23 words (taken before its delete) in an
    ``engine="auto"`` planes index and a packed twin: past the int32 key
    ceiling the planes rank exactly by B2 in two blocks and the packed
    words through the chunked fallback (no kernel), held to a two-shard
    copy whose 2**22-row shards rank by B2 / B3."""
    from lshrs_tpu_torch.ops.group_max import hamming_group_max_keys, hamming_packed_group_max_keys
    from lshrs_tpu_torch.ops.hamming import supports_hamming_grouped
    from lshrs_tpu_torch.parallel import ShardedDeviceStore, make_mesh

    kernels = (hamming_group_max_keys, hamming_packed_group_max_keys)
    rng = np.random.default_rng(seed + 70)
    ids = np.arange(N_8M)
    lshs = {"planes": exact_lsh(N_8M), "packed": exact_lsh(N_8M, hamming_storage="packed")}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for lsh in lshs.values():
        fill_words(lsh._storage, c8m["words"], ids)
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    serves = {name: lsh.serving_fn(top_k=TOP_K) for name, lsh in lshs.items()}
    for name, lsh in lshs.items():
        st = lsh.stats()
        idx = st["index"]
        assert idx["capacity"] == N_8M and idx["alive"] == N_8M, (name, idx)
        assert st["engine_resolved"] == "hamming" and idx["hamming_storage"] == name, (name, st)
        assert not supports_hamming_grouped(NUM_PERM, idx["capacity"])
    first_s, sm = {}, {}
    for name, serve in serves.items():
        t0 = time.perf_counter()  # the first batch builds the ranks (and the planes)
        sm[name] = self_match(serve, [(np.arange(QPS_BATCH_1M), c8m["keep"])], N_8M)
        first_s[name] = time.perf_counter() - t0

    # 1,024 planted queries: planes == packed == a two-shard copy (2**22-row
    # shards, B2 / B3 and PR 9's exact merge), ids and distances.
    pq = c8m["planted"][0][:EXACT_CHECK_QUERIES]
    qw = lshs["planes"]._hasher.hash_batch_words(pq)
    res = {name: lsh._storage.query_hamming(qw, TOP_K) for name, lsh in lshs.items()}
    planes_eq_packed = same(res["planes"], res["packed"])
    oracle = {}
    for name, kernel in (("planes", hamming_group_max_keys), ("packed", hamming_packed_group_max_keys)):
        two = ShardedDeviceStore(mesh=make_mesh(devices=[DEVICE] * 2), num_bands=NUM_BANDS,
                                 rows_per_band=ROWS, enable_hamming=True, hamming_storage=name,
                                 initial_capacity=N_8M, dedupe=False)
        fill_words(two, c8m["words"], ids)
        assert two._use_grouped() and two._local_rows() == N_4M
        got, n = launched(kernel, lambda: two.query_hamming(qw, TOP_K))
        oracle[name] = {"equal": same(got, res[name]), "kernel_launches": n}
        del two
    grouped_eq, grouped_b2 = chunked_equals_grouped_1m(
        s1m, s1m["keep"][:EXACT_CHECK_QUERIES]
        + 0.5 * rng.standard_normal((EXACT_CHECK_QUERIES, DIM), dtype=np.float32))

    # Quality: planted recall beside cascade_8m's on the same queries and
    # truth, and the cascade's agreement@10 with exact ranking at 2**23.
    exact_ids = serves["planes"](c8m["planted"][0])
    quality = planted_quality(exact_ids, c8m["planted"])
    agree = agreement_at_10(c8m["planted_ids"], exact_ids)

    # QPS at Q=8192 in turns with cascade_8m (two trials of one batch: a
    # chunked batch takes seconds); B2 / B3 launches over the timed serving
    # of the blocked and the chunked route.
    queries = c8m["queries"][:1]
    qps, timed = {}, {}
    for name in ("planes", "packed", "cascade_8m", "cascade_8m", "packed", "planes"):
        fn = serves.get(name, c8m["serve"])
        before = [k.launches for k in kernels]
        qps.setdefault(name, []).append(serving_qps(fn, queries, trials=2))
        if name in serves:
            n = [k.launches - b for k, b in zip(kernels, before)]
            timed[name] = [a + b for a, b in zip(timed.get(name, [0, 0]), n)]
    profiles = {name: serving_profile(serve, queries[:1]) for name, serve in serves.items()}

    deleted = rng.choice(N_8M, N_8M // 100, replace=False)
    kept = ~np.isin(np.arange(QPS_BATCH_1M), deleted)
    after = {}
    for name, lsh in lshs.items():
        lsh.delete(deleted.tolist())
        out = lsh.serving_fn(top_k=TOP_K)(c8m["keep"])
        after[name] = {"deleted_ids_returned": int(np.isin(out, deleted).sum()),
                       "survivor_self_match": float((out[kept, 0] == np.arange(QPS_BATCH_1M)[kept]).mean()),
                       "tombstones": lsh.stats()["index"]["tombstones"]}
    emit("slice_exact_8m", card=label, capacity=N_8M, alive=N_8M,
         supports_hamming_grouped=False, fill_s=fill_s, self_match=sm, first_batch_s=first_s,
         check_queries=EXACT_CHECK_QUERIES, planes_equal_packed=planes_eq_packed,
         two_shard_oracle=oracle, chunked_equals_grouped_b2_1m=grouped_eq,
         grouped_b2_launches_1m=grouped_b2, **quality, cascade_8m_planted=c8m["quality"],
         cascade_8m_agreement_at_10_with_exact=agree, qps=qps, batch=QPS_BATCH_1M,
         timed_b2_b3_launches=timed, delete=after, deleted=int(deleted.size),
         hamming_plane_bytes=lshs["planes"].stats()["index"]["hamming_plane_bytes"],
         memory_allocated_gb=torch.cuda.memory_allocated() / 1e9,
         max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    for name, prof in profiles.items():
        emit("profile", card=label, rows=N_8M, batch=QPS_BATCH_1M, engine="hamming",
             hamming_storage=name, route="blocked" if name == "planes" else "chunked", **prof)
    assert sm == {"planes": 1.0, "packed": 1.0}, sm
    assert planes_eq_packed and grouped_eq and grouped_b2 > 0, (planes_eq_packed, grouped_eq)
    assert all(o["equal"] and o["kernel_launches"] > 0 for o in oracle.values()), oracle
    assert timed["planes"][0] > 0 and timed["planes"][1] == 0 and timed["packed"] == [0, 0], timed
    for name, a in after.items():
        assert a["deleted_ids_returned"] == 0 and a["survivor_self_match"] == 1.0, (name, a)
        assert a["tombstones"] == deleted.size, (name, a)
    return {"qps": qps, "quality": quality}


def phase_bands128_100k(t100: dict, qps_16x16: float, seed: int, label: str) -> None:
    """The topp_100k index (after its lifecycle's 1,000-id delete) rehashed
    to 128 x 2 = 256 bits: top-k through the chunked collision core at 128
    bands (131,072 slots, below the auto switch), top-p on the full engine;
    then a 16-slot store, below the group."""
    from lshrs_tpu_torch import LSHRS

    lsh, X = t100["lsh"], t100["X"]
    store = lsh._storage
    rng = np.random.default_rng(seed + 80)
    alive = store._ids[: store._size]
    alive = alive[alive >= 0].cpu().numpy()
    # Top-p recall@10 against exact float32 cosine over the alive rows, at
    # 16 x 16 and after the rehash, on the same queries.
    qx = X[rng.choice(alive, TOPP_QUERIES, replace=False)]
    qx = qx + 0.5 * rng.standard_normal(qx.shape, dtype=np.float32)
    exact = RunningTruth(qx)
    exact.add(torch.from_numpy(X[alive]).to(DEVICE), 0)
    truth = alive[exact.truth()]
    del exact
    topp = lambda: lsh.serving_fn(top_k=TOP_K, mode="topp", batch_hint=TOPP_BATCH_100K)  # noqa: E731
    recall = {"16x16": recall_at_10(topp()(qx)[0], truth)}
    t0 = time.perf_counter()
    lsh.rehash(num_bands=BANDS128[0], rows_per_band=BANDS128[1])
    torch.cuda.synchronize()
    rehash_s = time.perf_counter() - t0
    stats = lsh.stats()
    assert store.num_bands == BANDS128[0] and store.words == BANDS128[0], store.words
    assert not stats["index"]["fast_path"] and stats["ranking"] == "collision", stats
    engine = store._resolve_rerank_engine(None, None)[0]
    try:
        store._resolve_rerank_engine("gather", None)
        gather_raises = False
    except RuntimeError:
        gather_raises = True
    recall["128x2"] = recall_at_10(topp()(qx)[0], truth)

    serve = lsh.serving_fn(top_k=TOP_K)
    t0 = time.perf_counter()
    rows = alive[:BANDS128_SELF_ROWS]
    batches = [(rows[s : s + QPS_BATCH_100K], X[rows[s : s + QPS_BATCH_100K]])
               for s in range(0, rows.size, QPS_BATCH_100K)]
    sm = self_match(serve, batches, N_100K)
    sm_s = time.perf_counter() - t0
    qw = lsh._hasher.hash_batch_words(qx[:CARRY_QUERIES])
    cpu = carry_to_cpu(store)
    t0 = time.perf_counter()
    cpu_eq = same(store.query_topk(qw, TOP_K), cpu.query_topk(qw.cpu(), TOP_K))
    cpu_s = time.perf_counter() - t0
    del cpu
    queries = [rng.standard_normal((QPS_BATCH_100K, DIM), dtype=np.float32) for _ in range(2)]
    qps = serving_qps(serve, queries, trials=2)
    emit("slice_bands128_100k", card=label, bands=BANDS128[0], rows_per_band=BANDS128[1],
         words=store.words, capacity=stats["index"]["capacity"], alive=int(alive.size),
         fast_path=stats["index"]["fast_path"], rehash_s=rehash_s, self_match=sm,
         self_match_s=sm_s, self_match_rows=int(rows.size), cpu_queries=CARRY_QUERIES,
         equals_cpu=cpu_eq, cpu_s=cpu_s,
         qps=qps, batch=QPS_BATCH_100K, qps_16x16_b1=qps_16x16, topp_engine=engine,
         topp_gather_raises=gather_raises, topp_recall_at_10=recall, topp_queries=TOPP_QUERIES)
    assert sm == 1.0 and cpu_eq and engine == "full" and gather_raises, (sm, cpu_eq, engine)

    # 16 slots (chunk_size=16, initial_capacity=16), below the group of 32.
    tiny = LSHRS(dim=DIM, num_perm=NUM_PERM, num_bands=NUM_BANDS, rows_per_band=ROWS,
                 initial_capacity=16, chunk_size=16, device=DEVICE)
    xt = rng.standard_normal((12, DIM), dtype=np.float32)
    tiny.index(np.arange(12), xt)
    out = tiny.serving_fn(top_k=TOP_K)(xt)
    qt = tiny._hasher.hash_batch_words(xt)
    tiny_eq = same(tiny._storage.query_topk(qt, TOP_K), carry_to_cpu(tiny._storage).query_topk(qt.cpu(), TOP_K))
    tstats = tiny.stats()["index"]
    emit("slice_tiny_16", capacity=tstats["capacity"], group_size=tiny._storage.group,
         fast_path=tstats["fast_path"], self_match=float((out[:, 0] == np.arange(12)).mean()),
         equals_cpu=tiny_eq, answer=out[:2].tolist())
    assert tstats["capacity"] == 16 and not tstats["fast_path"] and tiny_eq
    assert (out[:, 0] == np.arange(12)).all(), out


# ---------------------------------------------------------------------------
# phase 13: sharding (four shards on the one card)
# ---------------------------------------------------------------------------


def sharded_store(**kw):
    """A ShardedDeviceStore of SHARDS shards, all on the card (the mesh
    repeats it), at 16 x 16 bands."""
    from lshrs_tpu_torch.parallel import ShardedDeviceStore, make_mesh

    return ShardedDeviceStore(mesh=make_mesh(devices=[DEVICE] * SHARDS), num_bands=NUM_BANDS,
                              rows_per_band=ROWS, **kw)


def carry_sharded_to_cpu(store):
    """The sharded store carried to SHARDS CPU shards through ``state_arrays()``."""
    from lshrs_tpu_torch.parallel import ShardedDeviceStore, make_mesh

    cpu = ShardedDeviceStore(
        mesh=make_mesh(devices=["cpu"] * store.n_shards), num_bands=store.num_bands,
        rows_per_band=store.rows_per_band, dim=store.dim, initial_capacity=store._capacity,
        chunk_size=store.chunk, group_size=store.group, enable_hamming=store.enable_hamming,
        hamming_storage=store.hamming_storage, hamming_cascade=store.hamming_cascade,
        hamming_cascade_refine=store.hamming_cascade_refine, store_vectors=store.store_vectors,
        payload_dtype=store.payload_dtype, rerank_engine=store.rerank_engine,
        rerank_candidates=store.rerank_candidates,
    )
    cpu.load_state_arrays(store.state_arrays())
    assert cpu._capacity == store._capacity, (cpu._capacity, store._capacity)
    return cpu


def copy_alive(dst, src, *, limit: int | None = None, payload: bool = False) -> None:
    """Append ``src``'s alive slots (at most ``limit``) to ``dst`` on the
    card: ids, signature rows and, with ``payload``, the dequantized rows
    (an int8 row re-quantizes to itself)."""
    alive = torch.nonzero(src._ids[: src._size] >= 0).flatten()[:limit]
    ids = src._ids[alive].cpu().numpy()
    step = (1 << 18) if payload else N_1M
    for s in range(0, alive.numel(), step):
        pick = alive[s : s + step]
        rows = None
        if payload:
            rows = src._payload[pick].to(torch.float32)
            if src._pscale is not None:
                rows *= src._pscale[pick][:, None]
        dst.add_signature_batch(ids[s : s + step], src._sig_rows[pick], rows)


def same(a, b) -> bool:
    """Two ``(values, ids)`` results, equal element for element."""
    return all(np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(a, b))


def launched(kernel, fn):
    """``(fn(), launches of kernel during it)``."""
    before = kernel.launches
    out = fn()
    return out, kernel.launches - before


def phase_sharded_parity_4m(s100: dict, s4m: dict, seed: int, label: str) -> dict:
    """Four-shard stores fed the words of earlier cells, on the card:
    collision (the 100k words, B1) == the unsharded store; planes (B2) and
    packed (B3) on packed_4m's words == the unsharded planes and packed
    engines; the cascade on the 4M words beside the exact engine, and == it
    where the pool covers each shard; each == a CPU copy of itself."""
    from lshrs_tpu_torch import DeviceStore
    from lshrs_tpu_torch.ops.group_max import (
        group_max_keys,
        hamming_group_max_keys,
        hamming_packed_group_max_keys,
    )

    rng = np.random.default_rng(seed + 40)
    out = {}
    # Collision on the 100k words: 4 shards of 32,768 rows.
    src = s100["lsh"]._storage
    col = sharded_store(initial_capacity=src._capacity)
    copy_alive(col, src)
    X = s100["X"]
    qw = s100["lsh"]._hasher.hash_batch_words(
        X[:CARRY_QUERIES] + 0.5 * rng.standard_normal((CARRY_QUERIES, DIM), dtype=np.float32))
    got, b1 = launched(group_max_keys, lambda: col.query_topk(qw, TOP_K))
    cpu_s, cpu_got = host_seconds(lambda: carry_sharded_to_cpu(col).query_topk(qw.cpu(), TOP_K))
    out["collision_100k"] = {"equals_unsharded": same(got, src.query_topk(qw, TOP_K)),
                             "equals_cpu_copy": same(got, cpu_got), "cpu_queries": CARRY_QUERIES,
                             "cpu_s": cpu_s, "b1_launches": b1,
                             "rows_per_shard": col._local_rows()}
    del col

    # Planes (B2) and packed (B3) on packed_4m's words (its 1% delete
    # dropped): 4 shards of 2**20 rows.
    src = s4m["lsh"]._storage
    qx = s4m["keep"][:CARRY_QUERIES] + 0.5 * rng.standard_normal((CARRY_QUERIES, DIM), dtype=np.float32)
    qw = s4m["lsh"]._hasher.hash_batch_words(qx)
    want_b3 = src.query_hamming(qw, TOP_K)
    want_b2 = tuple(t.cpu().numpy() for t in s4m["planes_topk"](qw))
    stores = {}
    for storage, kernel in (("planes", hamming_group_max_keys), ("packed", hamming_packed_group_max_keys)):
        st = sharded_store(initial_capacity=N_4M, enable_hamming=True, hamming_storage=storage)
        copy_alive(st, src)
        st.query_hamming(qw[:1], TOP_K)  # builds the bitplanes
        got, n = launched(kernel, lambda st=st: st.query_hamming(qw, TOP_K))
        nq = SHARDED_PACKED_CPU_QUERIES if storage == "packed" else SHARDED_CPU_QUERIES
        cpu_s, cpu_got = host_seconds(
            lambda st=st, nq=nq: carry_sharded_to_cpu(st).query_hamming(qw[:nq].cpu(), TOP_K))
        out[f"{storage}_4m"] = {
            "equals_unsharded_b2": same(got, want_b2), "equals_unsharded_b3": same(got, want_b3),
            "equals_cpu_copy": same([x[:nq] for x in got], cpu_got),
            "cpu_queries": nq, "cpu_s": cpu_s, "kernel_launches": n,
            "plane_bytes": st.stats()["hamming_plane_bytes"]}
        stores[storage] = st

    # The cascade, its refine pool per shard: 4x the union pool of
    # cascade_4m's at the same settings.
    cas = sharded_store(initial_capacity=N_4M, enable_hamming=True, hamming_cascade=CASCADE_BITS,
                        hamming_cascade_refine=CASCADE_REFINE)
    copy_alive(cas, src)
    pq = s4m["lsh"]._hasher.hash_batch_words(s4m["planted"][0])
    got, b2 = launched(hamming_group_max_keys, lambda: cas.query_hamming(pq, TOP_K))
    exact = stores["planes"].query_hamming(pq, TOP_K)
    not_deleted = lambda x: ~np.isin(x, s4m["deleted"])  # noqa: E731
    cpu_s, cpu_got = host_seconds(
        lambda: carry_sharded_to_cpu(cas).query_hamming(pq[:SHARDED_CPU_QUERIES].cpu(), TOP_K))
    # Where the pool covers each shard (2**16 slots, 4 x 2**14, a 2**14-slot
    # pool) the cascade is the exact engine.
    full = sharded_store(initial_capacity=SMALL_CASCADE, enable_hamming=True,
                         hamming_cascade=CASCADE_BITS, hamming_cascade_refine=SMALL_CASCADE // SHARDS)
    exact_small = DeviceStore(num_bands=NUM_BANDS, rows_per_band=ROWS, initial_capacity=SMALL_CASCADE,
                              enable_hamming=True, device=DEVICE)
    for st in (full, exact_small):
        copy_alive(st, src, limit=SMALL_CASCADE)
    a = full.query_hamming(pq[:CARRY_QUERIES], TOP_K)
    out["cascade_4m"] = {
        "refine_per_shard": CASCADE_REFINE, "b2_launches": b2,
        "prefix_plane_bytes": cas.stats()["hamming_plane_bytes"],
        "agreement_at_10_with_exact": agreement_at_10(got[1], exact[1]),
        "planted": planted_quality(got[1], s4m["planted"], not_deleted),
        "equals_cpu_copy": same([x[:SHARDED_CPU_QUERIES] for x in got], cpu_got), "cpu_s": cpu_s,
        "full_pool_equals_exact": same(a, exact_small.query_hamming(pq[:CARRY_QUERIES], TOP_K)),
        "full_pool_equals_cpu_copy": same(a, carry_sharded_to_cpu(full).query_hamming(
            pq[:CARRY_QUERIES].cpu(), TOP_K)),
    }
    emit("sharded_parity_4m", card=label, shards=SHARDS, **out)
    for name, res in out.items():
        for key, val in res.items():
            if "equals" in key:
                assert val, (name, key)
    assert out["collision_100k"]["b1_launches"] == SHARDS
    assert out["planes_4m"]["kernel_launches"] == out["packed_4m"]["kernel_launches"] == SHARDS
    assert out["cascade_4m"]["b2_launches"] >= SHARDS
    return out


def phase_sharded_topp_1m(t1m: dict, label: str) -> None:
    """A four-shard copy of the 1M int8-payload store: the full engine ==
    the unsharded full engine; the gather engine (B1 per shard, the budget
    per shard) == unsharded full on every query it proves exact; == a CPU
    copy."""
    from lshrs_tpu_torch.ops.group_max import group_max_keys

    src = t1m["lsh"]._storage
    st = sharded_store(dim=DIM, initial_capacity=N_1M, store_vectors=True, payload_dtype="int8")
    copy_alive(st, src, payload=True)
    qx = t1m["qx"]
    qw = t1m["lsh"]._hasher.hash_batch_words(qx)
    want = src.query_topp_batch(qw, qx, TOP_K, engine="full")
    full = st.query_topp_batch(qw, qx, TOP_K, engine="full")
    gather, b1 = launched(group_max_keys, lambda: st.query_topp_batch(qw, qx, TOP_K, engine="gather"))
    exact = gather[2] < st.rerank_candidates  # each shard's set covered
    cpu_s, cpu_got = host_seconds(lambda: carry_sharded_to_cpu(st).query_topp_batch(
        qw[:SHARDED_CPU_QUERIES].cpu(), qx[:SHARDED_CPU_QUERIES], TOP_K, engine="gather"))
    res = {"full_vs_unsharded_full": compare_rankings(full, want),
           "gather_vs_unsharded_full_on_exact": compare_rankings(
               [x[exact] for x in gather], [x[exact] for x in want]),
           "gather_vs_cpu_copy": compare_rankings([x[:SHARDED_CPU_QUERIES] for x in gather], cpu_got)}
    emit("sharded_topp_1m_int8", card=label, shards=SHARDS, queries=len(qx),
         gather_exact=int(exact.sum()), b1_launches=b1, cpu_queries=SHARDED_CPU_QUERIES,
         cpu_s=cpu_s, payload_bytes=st.stats()["payload_bytes"], **res)
    for name, r in res.items():
        assert r["rows_bad"] == 0 and r["max_abs_cos_err"] < 1e-5, (name, r)
    assert exact.sum() > 0 and b1 > 0 and st.stats()["payload_bytes"] == src.stats()["payload_bytes"]


def phase_sharded_asymmetric_1m(s1m: dict, label: str) -> None:
    """A four-shard copy of the 1M planes store ranked asymmetrically (B2
    at a 2**18-row shard's shift), both wires: self-match 1.0, == a CPU copy."""
    from lshrs_tpu_torch.ops.asymmetric import QMAX4, pack_coords_int4_np, quantize_coords_np
    from lshrs_tpu_torch.ops.group_max import hamming_group_max_keys

    st = sharded_store(initial_capacity=N_1M, enable_hamming=True)
    copy_alive(st, s1m["lsh"]._storage)
    keep = s1m["keep"]
    coords = s1m["lsh"]._hasher.hash_batch_coords_host(keep)
    cpu = carry_sharded_to_cpu(st)
    res = {}
    for wire, q in (("words", quantize_coords_np(coords)[0]),
                    ("coords4", pack_coords_int4_np(quantize_coords_np(coords, qmax=QMAX4)[0]))):
        serve = st.snapshot_query_fn(TOP_K, mode="asymmetric", wire=wire)
        ids, b2 = launched(hamming_group_max_keys, lambda: serve(q).cpu().numpy())
        cpu_ids = cpu.snapshot_query_fn(TOP_K, mode="asymmetric", wire=wire)(q[:CARRY_QUERIES])
        res[wire] = {"self_match": float((ids[:, 0] == np.arange(len(keep))).mean()),
                     "equals_cpu_copy": bool(np.array_equal(ids[:CARRY_QUERIES], cpu_ids.numpy())),
                     "b2_launches": b2}
    emit("sharded_asymmetric_1m", card=label, shards=SHARDS, rows_per_shard=st._local_rows(),
         queries=len(keep), cpu_queries=CARRY_QUERIES, **res)
    for wire, r in res.items():
        assert r["self_match"] == 1.0 and r["equals_cpu_copy"] and r["b2_launches"] == SHARDS, (wire, r)


def phase_sharded_16m(c8m: dict, seed: int, label: str) -> dict:
    """2**24 clustered vectors over four 2**22-row shards on the one card,
    served through LSHRS by exact Hamming (B2 once per shard per batch):
    past the unsharded single-pass engines' int32 key ceiling."""
    from lshrs_tpu_torch import LSHRS
    from lshrs_tpu_torch.ops.group_max import hamming_group_max_keys, key_scale
    from lshrs_tpu_torch.ops.hamming import supports_hamming_grouped

    assert not supports_hamming_grouped(NUM_PERM, N_16M)  # the unsharded engine could not serve it
    store = sharded_store(dim=DIM, initial_capacity=N_16M, enable_hamming=True)
    lsh = LSHRS(dim=DIM, num_perm=NUM_PERM, num_bands=NUM_BANDS, rows_per_band=ROWS, storage=store)
    keep, build_s, planted = draw_clustered(lsh, N_16M, seed + 41, planted_depth=TOP_K)
    rng = np.random.default_rng(seed + 42)
    serve = lsh.serving_fn(top_k=TOP_K)
    stats = lsh.stats()
    t0 = time.perf_counter()
    sm, b2 = launched(hamming_group_max_keys,
                      lambda: self_match(serve, [(np.arange(QPS_BATCH_1M), keep)], N_16M))
    first_s = time.perf_counter() - t0  # builds the bitplanes, tie keys and refine tables
    quality = planted_quality(serve(planted[0]), planted)
    queries = [rng.standard_normal((QPS_BATCH_1M, DIM), dtype=np.float32) for _ in range(2)]
    qps = {}
    for name in ("sharded_16m", "cascade_8m", "cascade_8m", "sharded_16m"):  # in turns
        fn = serve if name == "sharded_16m" else c8m["serve"]
        qps.setdefault(name, []).append(serving_qps(fn, queries, trials=2))
    # One shard's B2 on the store's own planes, Q=8192 (CUDA events).
    shard = store._shards[0]
    qbits = shard._planes_rows(lsh._hasher.hash_batch_words(queries[0]))
    shard_ms = median_ms(lambda: hamming_group_max_keys(
        shard._planes, shard._tie, qbits, group=64, scale=key_scale(shard._capacity),
        num_perm=NUM_PERM), reps=5)
    idx = stats["index"]
    emit("slice_sharded_16m", card=label, capacity=idx["capacity"], alive=idx["alive"],
         n_shards=idx["n_shards"], rows_per_shard=idx["rows_per_shard"],
         ranking=stats["ranking"], engine_resolved=stats["engine_resolved"],
         plane_bytes=lsh.stats()["index"]["hamming_plane_bytes"],
         signature_bytes=idx["signature_bytes"], self_match=sm, b2_launches_per_batch=b2,
         **quality, cascade_8m_planted=c8m["quality"], qps=qps, batch=QPS_BATCH_1M,
         b2_ms_per_shard=shard_ms, build_vectors_per_s=N_16M / build_s, build_s=build_s,
         first_batch_s=first_s, memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    assert idx["capacity"] == N_16M and idx["alive"] == N_16M and idx["n_shards"] == SHARDS
    assert idx["rows_per_shard"] == N_16M // SHARDS and stats["engine_resolved"] == "hamming"
    assert sm == 1.0 and b2 == SHARDS, (sm, b2)
    emit("profile", card=label, rows=N_16M, batch=QPS_BATCH_1M, engine="hamming",
         shards=SHARDS, **serving_profile(serve, queries[:1]))

    deleted = rng.choice(N_16M, N_16M // 100, replace=False)
    lsh.delete(deleted.tolist())
    out = lsh.serving_fn(top_k=TOP_K)(keep)
    kept = ~np.isin(np.arange(QPS_BATCH_1M), deleted)
    leaked = int(np.isin(out, deleted).sum())
    sm_after = float((out[kept, 0] == np.arange(QPS_BATCH_1M)[kept]).mean())
    stats = lsh.stats()["index"]
    emit("delete_sharded_16m", deleted=int(deleted.size), deleted_queried=int((~kept).sum()),
         tombstones=stats["tombstones"], deleted_ids_returned=leaked,
         survivor_self_match=sm_after)
    assert leaked == 0 and sm_after == 1.0 and stats["tombstones"] == deleted.size
    return {"build_s": build_s, "qps": qps, "quality": quality}


def phase_sharded_checkpoint(seed: int, label: str) -> None:
    """A checkpoint saved with shards=4 on CPU stand-ins loads on this
    one-card host unsharded, with the reference's warning, and serves the
    same ids (host hash on both sides; B1 on the card)."""
    import logging

    from lshrs_tpu_torch import LSHRS

    rng = np.random.default_rng(seed + 43)
    X = rng.standard_normal((10_000, DIM), dtype=np.float32)
    src = LSHRS(dim=DIM, num_perm=NUM_PERM, num_bands=NUM_BANDS, rows_per_band=ROWS, shards=SHARDS,
                hash_mode="host", device="cpu")
    src.index(np.arange(10_000), X)
    ckpt = Path(__file__).resolve().parent / "build" / "chip_smoke_sharded_checkpoint"
    shutil.rmtree(ckpt, ignore_errors=True)
    warned = []
    handler = logging.Handler()
    handler.emit = lambda record: warned.append(record.getMessage())
    log = logging.getLogger("lshrs_tpu_torch.core.main")
    log.addHandler(handler)
    try:
        src.save_to_disk(ckpt)
        back = LSHRS.load_from_disk(ckpt, device=DEVICE)
    finally:
        log.removeHandler(handler)
        shutil.rmtree(ckpt, ignore_errors=True)
    qx = X[:CARRY_QUERIES] + 0.5 * rng.standard_normal((CARRY_QUERIES, DIM), dtype=np.float32)
    equal = back.query_batch(qx, top_k=TOP_K) == src.query_batch(qx, top_k=TOP_K)
    idx = back.stats()["index"]
    emit("sharded_checkpoint", card=label, saved_shards=src.stats()["index"]["n_shards"],
         restored_backend=idx["backend"], restored_device=back.stats()["device"],
         warning=warned[:1], equal=equal, queries=CARRY_QUERIES)
    assert equal and "n_shards" not in idx and back.stats()["device"].startswith(DEVICE)
    assert any("restoring unsharded" in w for w in warned), warned


def phase_bench_smoke() -> dict:
    """``bench_cuda.py`` at its smoke size on the card: exit code 0 and
    exactly one stdout line, which is emitted (parsed)."""
    import bench_cuda

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench_cuda.main(["--smoke"])
    lines = out.getvalue().splitlines()
    assert rc == 0 and len(lines) == 1, f"bench_cuda --smoke: exit {rc}, {len(lines)} stdout lines"
    line = json.loads(lines[0])
    emit("bench_smoke", line=line)
    return line


def load_benchmark(name: str):
    """The script ``benchmarks/<name>.py`` as a module."""
    path = Path(__file__).resolve().parent / "benchmarks" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_smoke(phase: str, name: str, label: str) -> list[dict]:
    """``benchmarks/<name>.py --smoke`` on the card, which runs its own
    checks: it must exit 0 and print rows; they are emitted and returned."""
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = load_benchmark(name).main(["--smoke"])
    lines = [json.loads(line) for line in out.getvalue().splitlines()]
    assert rc == 0 and lines, f"{name} --smoke: exit {rc}, {len(lines)} stdout lines"
    emit(phase, card=label, script=name, seconds=time.perf_counter() - t0, rows=lines)
    return lines


def phase_recall_capacity_smoke(label: str) -> dict:
    """Phase 16: ``torch_capacity_bench.py --smoke`` and
    ``torch_recall_bench.py --smoke`` on the card. Each runs its own checks
    (self-match, ids in range, each column's kernel launched, none on the
    chunked route) and must exit 0; their rows are emitted here and must
    cover every route and banding."""
    rows = {
        name: [line for line in run_smoke("recall_capacity_smoke", name, label)
               if "summary" not in line]
        for name in ("torch_capacity_bench", "torch_recall_bench")
    }
    routes = [(r["slots"], r["engine"], r["route"]) for r in rows["torch_capacity_bench"]]
    assert routes == [
        (slots, engine, route)
        for slots, exact in ((1 << 14, "grouped"), (N_8M, "blocked"))
        for engine, route in (("exact", exact), ("cascade128:8192", "cascade"),
                              ("cascade64:8192", "cascade"))
    ], routes
    bands = [r["bands"] for r in rows["torch_recall_bench"]]
    assert bands == ["64x4", "32x8", "16x16", "8x32", "4x64"], bands
    return rows


PROFILE_SCRIPTS = ("torch_kernel_profile", "torch_hamming_profile", "torch_cascade_profile",
                   "torch_ingest_profile", "torch_gather_rerank_bench")


def phase_profiles_smoke(label: str) -> dict:
    """Phase 17: the stage profiles at ``--smoke`` on the card. Each runs
    its own checks (its stages composed == its core == the store's closure,
    every row's launches exact) and must exit 0; their rows are emitted."""
    return {name: run_smoke("profiles_smoke", name, label) for name in PROFILE_SCRIPTS}


SERVING_SCRIPTS = ("torch_asymmetric_bench", "torch_scale_bench", "torch_rerank_bench",
                   "torch_auto_engine_bench", "torch_cp_bench")


def phase_serving_benches_smoke(label: str) -> dict:
    """Phase 18: the serving benches at ``--smoke`` on the card. Each runs
    its own checks (self-match, ids in range, each timed batch's launches
    exact) and must exit 0 and print its one row, which is emitted here."""
    rows = {}
    for name in SERVING_SCRIPTS:
        (rows[name],) = run_smoke("serving_benches_smoke", name, label)
    assert rows["torch_asymmetric_bench"]["b2_packing"] == list(b2_packings()["asymmetric_int8"])
    assert rows["torch_auto_engine_bench"]["ranking"] == "hamming"
    assert rows["torch_cp_bench"]["banding"] == f"{CP_BANDS}x{CP_ROWS}"
    return rows


MAINTENANCE_SCRIPTS = ("torch_rehash_bench", "torch_ingest_bench", "torch_sharded_build_bench",
                       "torch_ab_serving")


def phase_maintenance_benches_smoke(label: str) -> dict:
    """Phase 19: the maintenance benches at ``--smoke`` on the card. Each
    runs its own checks (self-match, equal ids of the single and sharded
    stores and of both selections, stored words, each stage's launches
    exact) and must exit 0 and print its one row, which is emitted here."""
    rows = {}
    for name in MAINTENANCE_SCRIPTS:
        (rows[name],) = run_smoke("maintenance_benches_smoke", name, label)
    rehash = rows["torch_rehash_bench"]
    assert (rehash["banding"], rehash["self_match"]) == (f"{CP_BANDS}x{CP_ROWS}", 1.0), rehash
    assert rows["torch_sharded_build_bench"]["capacity"]["rows_per_shard"] == 1 << 13
    assert rows["torch_ab_serving"]["wide_route"].startswith("hierarchy"), rows["torch_ab_serving"]
    return rows


def phase_bandings(seed: int, label: str) -> dict:
    """Phase 20: the auto-tuner's 48 x 8 (``num_perm=384``, t=0.6; top-k
    and a gather top-p batch) and the default index with ``multiprobe=2``
    (8 x 16, two probes; top-k) over 131,072 gaussian vectors, device hash:
    self-match 1.0 and ids == the store carried to the CPU on 64 queries."""
    from lshrs_tpu_torch import LSHRS

    rng = np.random.default_rng(seed + 20)
    X = rng.standard_normal((N_BANDINGS, DIM), dtype=np.float32)
    xq = X[:BANDINGS_BATCH]
    qx = X[:BANDINGS_CPU_QUERIES] + 0.5 * rng.standard_normal(
        (BANDINGS_CPU_QUERIES, DIM), dtype=np.float32)
    out = {}
    for name, kw, banding in (
        ("48x8", dict(num_perm=384, similarity_threshold=0.6, store_vectors=True,
                      rerank_engine="gather"), (48, 8, 1)),
        ("8x16_probes2", dict(multiprobe=2), (8, 16, 2)),
    ):
        t0 = time.perf_counter()
        lsh = LSHRS(dim=DIM, device=DEVICE, **kw)
        for i in range(0, N_BANDINGS, INGEST_BATCH):
            lsh.index(np.arange(i, min(i + INGEST_BATCH, N_BANDINGS)), X[i : i + INGEST_BATCH])
        st = lsh.stats()
        assert (st["num_bands"], st["rows_per_band"], st["multiprobe"]) == banding, st
        serve = lsh.serving_fn(top_k=TOP_K)
        sm = self_match(serve, [(np.arange(BANDINGS_BATCH), xq)], N_BANDINGS)
        assert st["ranking"] == "collision", st["ranking"]
        batch = lsh.query_batch(xq, top_k=TOP_K)
        batch_equal = all(row == [int(i) for i in ids if i >= 0]
                          for row, ids in zip(batch, serve(xq)))
        pw = lsh._hash_query_words(qx)
        counts, ids = lsh._storage.query_topk(pw, TOP_K)
        cpu = carry_to_cpu(lsh._storage)
        counts_cpu, ids_cpu = cpu.query_topk(pw.cpu(), TOP_K)
        equal = bool(np.array_equal(ids, ids_cpu) and np.array_equal(counts, counts_cpu))
        row = {"self_match": sm, "query_batch_equals_serving": batch_equal,
               "card_equals_cpu": equal, "qps": serving_qps(serve, [xq] * 4, trials=2),
               "batch": BANDINGS_BATCH}
        ok = sm == 1.0 and batch_equal and equal
        if kw.get("store_vectors"):
            tserve = lsh.serving_fn(top_k=TOP_K, mode="topp", batch_hint=BANDINGS_BATCH)
            tsm, worst = topp_self_match(tserve, xq, BANDINGS_BATCH)
            want = cpu.query_topp_batch(pw.cpu(), qx, TOP_K, engine="gather")
            agree = compare_rankings(tserve(qx), want)
            row.update(topp_engine=lsh._storage.stats()["rerank_engine"], topp_self_match=tsm,
                       topp_max_abs_cos_minus_1=worst, topp_card_vs_cpu=agree)
            ok = ok and tsm == 1.0 and worst < 1e-5 and agree["rows_bad"] == 0 \
                and agree["max_abs_cos_err"] < 1e-5
        del cpu
        row["seconds"] = time.perf_counter() - t0
        emit("bandings", card=label, banding=name, rows=N_BANDINGS, **row)
        assert ok, (name, row)
        out[name] = row
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if torch.backends.cuda.matmul.allow_tf32 is not False:
        print("chip_smoke: TF32 matmuls must be off for hashing", file=sys.stderr)
        return 1

    from lshrs_tpu_torch.ops import _build

    start = time.perf_counter()
    dev = torch.device(DEVICE)
    label = card_label()
    kind = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    emit("card", nvidia_smi=label, kind=kind, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda, kernel_build_s=build_s)

    kern = phase_kernels(np.random.default_rng(args.seed), dev)

    # Each path of the main path: counters from zero, read right after.
    from lshrs_tpu_torch.ops import group_max, hamming, scan

    wrappers = {name: getattr(group_max, name) for name in KERNELS}
    wrappers[REFINE] = hamming.hamming_refine_topk
    wrappers[SELECT] = scan.select_top_groups
    launches = {name: 0 for name in wrappers}

    b1_by_shape = {}
    b1_by_template = {}
    b2_by_packing = {}
    b3_by_shape = {}
    refine_by_shape = {}
    packings = b2_packings()

    def drive(path: str, kernel, run, *, b1_shapes=(), b1_templates=(), b2_packings=()):
        """Run one path with every launch counter at 0 just before it and
        read just after: each kernel named (one name or several) must have
        been launched, B1 at each ``(BW, probes)`` of ``b1_shapes`` and in
        each ``<BW, W, P>`` of ``b1_templates``, and B2 at each ``(width,
        offset, shift)`` of ``b2_packings``."""
        for w in wrappers.values():
            w.launches = 0
        wrappers[B1].launches_by_shape.clear()
        wrappers[B1].launches_by_template.clear()
        wrappers[B2].launches_by_packing.clear()
        wrappers[B3].launches_by_shape.clear()
        wrappers[REFINE].launches_by_shape.clear()
        t0 = time.perf_counter()
        out = run()
        seconds = time.perf_counter() - t0
        counts = {name: w.launches for name, w in wrappers.items()}
        shapes = dict(wrappers[B1].launches_by_shape)
        templates = dict(wrappers[B1].launches_by_template)
        by_packing = dict(wrappers[B2].launches_by_packing)
        b3_shapes = dict(wrappers[B3].launches_by_shape)
        refine_shapes = dict(wrappers[REFINE].launches_by_shape)
        emit("launches", path=path, seconds=seconds, **counts,
             b1_by_bw_probes={f"{bw}x{t}": n for (bw, t), n in sorted(shapes.items())},
             b1_by_template={f"{bw}x{w}x{t}": n for (bw, w, t), n in sorted(templates.items())},
             b2_by_width_offset_shift={f"{w}/{o}/{h}": n for (w, o, h), n in sorted(by_packing.items())},
             b3_by_bw_word_bits={f"{bw}x{wb}": n for (bw, wb), n in sorted(b3_shapes.items())},
             refine_by_nw_group={f"{nw}x{g}": n for (nw, g), n in sorted(refine_shapes.items())})
        b3_by_shape[path] = b3_shapes
        for shape, n in refine_shapes.items():
            refine_by_shape[shape] = refine_by_shape.get(shape, 0) + n
        for name in ([kernel] if isinstance(kernel, str) else kernel):
            if counts[name] == 0:
                raise AssertionError(f"{name} was not launched on the {path} path")
        for shape in b1_shapes:
            if shapes.get(shape, 0) == 0:
                raise AssertionError(f"B1 was not launched at (BW, probes)={shape} on the {path} path")
        for template in b1_templates:
            if templates.get(template, 0) == 0:
                raise AssertionError(f"B1 was not launched in <BW, W, P>={template} on the {path} path")
        for packing in b2_packings:
            if by_packing.get(packing, 0) == 0:
                raise AssertionError(f"B2 was not launched at (width, offset, shift)={packing} "
                                     f"on the {path} path")
            b2_by_packing[path, packing] = by_packing[packing]
        for name, n in counts.items():
            launches[name] += n
        for shape, n in shapes.items():
            b1_by_shape[shape] = b1_by_shape.get(shape, 0) + n
        for template, n in templates.items():
            b1_by_template[template] = b1_by_template.get(template, 0) + n
        return out

    s100 = drive("100k", "group_max_keys", lambda: phase_100k(args.seed))
    # The Hamming paths' tails launch hamming_refine_topk: the 1M serving
    # batch (the benchmark cells' shape), the packed store and the cascade.
    s1m = drive("1m", (B2, SELECT, REFINE), lambda: phase_1m(args.seed))
    ref1m = s1m["answers"]
    s4m = drive("packed_4m", (B3, REFINE), lambda: phase_packed_4m(args.seed),
                b2_packings=[packings["symmetric"]])
    if b3_by_shape["packed_4m"].get((NUM_BANDS, ROWS), 0) == 0:
        raise AssertionError("B3 was not launched at (BW, word_bits)=(16, 16) on packed_4m")

    times = {}
    for name, (run, plain, shape, library) in kern["timed"].items():
        bound_ms, bound_by = kernel_bound(name, shape)
        # A plain version past 2**33 key elements takes ~1 s a call: timed
        # thrice; B3's at packed_4m (tens of seconds) was timed once, in
        # its phase-2 check.
        plain_reps = 3 if shape["C"] * shape["Q"] > 1 << 33 else 10
        plain_ms = plain if isinstance(plain, float) else median_ms(plain, reps=plain_reps)
        times[name] = {"ms": median_ms(run), "plain_ms": plain_ms,
                       "library_ms": median_ms(library) if library else None,
                       "bound_ms": bound_ms, "bound_by": bound_by, **shape}
        emit("kernel_time", card=label, kernel=name, **times[name])
    kern["timed"].clear()  # the timed operands (group_select's are 4.8 GB)
    qps_100k = serving_qps(s100["serve"], s100["queries"])
    emit("serving", card=label, rows=N_100K, batch=QPS_BATCH_100K, engine="collision",
         qps=qps_100k)
    qps_1m = serving_qps(s1m["serve"], s1m["queries"])
    emit("serving", card=label, rows=N_1M, batch=QPS_BATCH_1M, engine="hamming",
         qps=qps_1m)
    # Packed (B3) and planes (B2) on the same 4M store words, in turns.
    for name in ("packed", "planes", "planes", "packed"):
        serve = s4m["serve"] if name == "packed" else s4m["serve_planes"]
        emit("serving", card=label, rows=N_4M, batch=QPS_BATCH_1M, engine="hamming",
             hamming_storage=name, qps=serving_qps(serve, s4m["queries"], trials=2))
    assert s4m["lsh"]._storage._planes is None, "the packed store built planes"
    emit("profile", card=label, rows=N_100K, batch=QPS_BATCH_100K, engine="collision",
         **serving_profile(s100["serve"], s100["queries"][:3]))
    emit("profile", card=label, rows=N_1M, batch=QPS_BATCH_1M, engine="hamming",
         **serving_profile(s1m["serve"], s1m["queries"][:3]))
    for name in ("packed", "planes"):
        serve = s4m["serve"] if name == "packed" else s4m["serve_planes"]
        emit("profile", card=label, rows=N_4M, batch=QPS_BATCH_1M, engine="hamming",
             hamming_storage=name, **serving_profile(serve, s4m["queries"]))
    emit("build", card=label, rows=N_100K, batch=INGEST_BATCH,
         vectors_per_s=s100["build_vectors_per_s"], seconds=s100["build_s"],
         note="after one warm-up batch; includes host-to-device copies")
    emit("build", card=label, rows=N_4M, batch=INGEST_BATCH, vectors_per_s=N_4M / s4m["build_s"],
         seconds=s4m["build_s"], note="packed store; includes drawing the data on the card "
         "and its round trip through the host")

    # Phase 10 (the cascade half): the 4M words, then 2**23 slots.
    c4m = drive("cascade_4m", (B2, REFINE), lambda: phase_cascade_4m(s4m, args.seed, label),
                b2_packings=[packings["cascade_coarse"]])
    # Phase 13 (sharding), on the words of the 100k and 4M cells.
    drive("sharded_parity_4m", KERNELS, lambda: phase_sharded_parity_4m(s100, s4m, args.seed, label),
          b2_packings=[packings["symmetric"], packings["cascade_coarse"]])
    del s4m, c4m
    c8m = drive("cascade_8m", B2, lambda: phase_cascade_8m(args.seed, label),
                b2_packings=[packings["cascade_coarse"]])
    emit("build", card=label, rows=N_8M, batch=INGEST_BATCH, vectors_per_s=N_8M / c8m["build_s"],
         seconds=c8m["build_s"], note="cascade store; includes drawing the data on the card "
         "and its round trip through the host")
    # Phase 13: 2**24 slots over four shards, served in turns with cascade_8m.
    s16m = drive("sharded_16m", B2, lambda: phase_sharded_16m(c8m, args.seed, label),
                 b2_packings=[packings["symmetric"]])
    emit("build", card=label, rows=N_16M, batch=INGEST_BATCH, vectors_per_s=N_16M / s16m["build_s"],
         seconds=s16m["build_s"], note="four shards on the card; includes drawing the data on the "
         "card and its round trip through the host")
    del s16m
    # Phase 14: cascade_8m's words ranked exactly through the chunked
    # fallbacks, in turns with cascade_8m; the oracles launch B2 / B3.
    drive("exact_8m", (B2, B3), lambda: phase_exact_8m(c8m, s1m, args.seed, label))
    del c8m

    # Phase 11 (the bucketed engine): the 100k and 1M words, before the
    # lifecycle mutates the 100k index.
    drive("bucket_100k", B1, lambda: phase_bucket(s100, s1m, args.seed, label))
    drive("lifecycle_100k", "group_max_keys", lambda: phase_lifecycle(s100, args.seed))

    # Phase 8: top-p rerank.
    t100 = drive("topp_100k", "group_max_keys", lambda: phase_topp_100k(s100, args.seed))
    del s100
    t1m = drive("topp_1m", "group_max_keys", lambda: phase_topp_1m(args.seed))
    # Both engines at 100k too (auto takes full there): with the 1M pair
    # they bracket the full-vs-gather crossover on this card.
    store100 = t100["lsh"]._storage
    for eng in ("full", "gather", "gather", "full"):
        store100.rerank_engine = eng
        serve = t100["lsh"].serving_fn(top_k=TOP_K, mode="topp", batch_hint=TOPP_BATCH_100K)
        emit("serving", card=label, rows=N_100K, batch=TOPP_BATCH_100K, mode="topp",
             engine=eng, payload_dtype="float32", qps=serving_qps(serve, t100["queries"]))
    store100.rerank_engine = "auto"
    lsh1m, store1m = t1m["lsh"], t1m["lsh"]._storage
    serves = {}
    for q in TOPP_QPS_BATCHES_1M:
        for eng in ("full", "gather", "gather", "full"):  # in turns
            store1m.rerank_engine = eng
            serves[eng, q] = lsh1m.serving_fn(top_k=TOP_K, mode="topp", batch_hint=q)
            emit("serving", card=label, rows=N_1M, batch=q, mode="topp", engine=eng,
                 payload_dtype="int8", qps=serving_qps(serves[eng, q], t1m["queries"][q], trials=2))
    for eng in ("full", "gather"):
        emit("profile", card=label, rows=N_1M, batch=TOPP_QPS_BATCHES_1M[-1], mode="topp",
             engine=eng, payload_dtype="int8",
             **serving_profile(serves[eng, TOPP_QPS_BATCHES_1M[-1]],
                               t1m["queries"][TOPP_QPS_BATCHES_1M[-1]][:1]))
    del lsh1m, store1m, serves
    drive("sharded_topp_1m", B1, lambda: phase_sharded_topp_1m(t1m, label))
    # Phase 10 (the asymmetric half): the 1M planes index, scored against
    # phase 8's exact-cosine truth on the same data.
    drive("asymmetric_1m", B2, lambda: phase_asymmetric_1m(s1m, t1m, args.seed, label),
          b2_packings=[packings["asymmetric_int8"], packings["asymmetric_int4"]])
    drive("sharded_asymmetric_1m", B2, lambda: phase_sharded_asymmetric_1m(s1m, label),
          b2_packings=[packings["sharded_asymmetric_int8"], packings["sharded_asymmetric_int4"]])
    del s1m

    # Phase 9: hash families, multi-probe, filters.
    drive("hash_parity", (), lambda: phase_hash_parity(args.seed, label))
    st1m = drive("structured_1m", (B2, B3), lambda: phase_structured_1m(args.seed, label))
    for name in ("host", "device", "device", "host", "host_packed"):
        emit("serving", card=label, rows=N_1M, batch=QPS_BATCH_1M, engine="hamming",
             hash_family="structured", hash_mode=name,
             qps=serving_qps(st1m["serves"][name], st1m["queries"], trials=2))
    emit("profile", card=label, rows=N_1M, batch=QPS_BATCH_1M, engine="hamming",
         hash_family="structured", hash_mode="device",
         **serving_profile(st1m["serves"]["device"], st1m["queries"][:2]))
    build_profiles(args.seed, label)
    drive("multiprobe_100k", B1, lambda: phase_multiprobe_100k(args.seed, label),
          b1_shapes=[(NUM_BANDS, 2), (NUM_BANDS, 4)])
    drive("probe_and_cp_1m", B1, lambda: phase_probe_and_cp_1m(t1m, label),
          b1_shapes=[(NUM_BANDS, 4), (CP_BANDS, 1)])
    drive("filters", KERNELS, lambda: phase_filters(st1m, t1m, args.seed, label))
    del st1m
    # Phase 11 (retuning and MIPS): phase 8's 1M index is rehashed last.
    drive("retune_1m_int8", (B1, B2), lambda: phase_retune_1m_int8(t1m, label),
          b1_shapes=[(CP_BANDS, 1)])
    del t1m
    drive("mips_100k", B1, lambda: phase_mips_100k(t100, args.seed, label))
    drive("topp_lifecycle_100k", "group_max_keys", lambda: phase_topp_lifecycle(t100, args.seed))
    # Phase 14: the same index rehashed past 64 bands, and a 16-slot store.
    drive("bands128_100k", (), lambda: phase_bands128_100k(t100, qps_100k, args.seed, label))
    del t100
    drive("family_lifecycle_100k", B1, lambda: phase_family_lifecycle(args.seed),
          b1_shapes=[(NUM_BANDS, 2), (CP_BANDS, 2), (CP_BANDS, 4)])
    drive("retune_100k", B1, lambda: phase_retune_100k(args.seed, label),
          b1_shapes=[(CP_BANDS, 1)])

    # Phase 12: bulk ingestion and the bucket backends.
    drive("ingest_1m", B2, lambda: phase_ingest_1m(ref1m, args.seed, label))
    del ref1m
    with tempfile.TemporaryDirectory() as tmp:
        f100 = drive("files_100k", B1, lambda: phase_files_100k(Path(tmp), args.seed, label))
        drive("custom_storage_100k", B1, lambda: phase_custom_storage_100k(f100, label))
    drive("memory_100k", B1, lambda: phase_memory_100k(f100, args.seed, label))
    drive("sharded_checkpoint", B1, lambda: phase_sharded_checkpoint(args.seed, label))
    emit("not_on_the_card", paths=["parquet", "postgres", "redis"],
         why="no pyarrow, no psycopg and no Redis server on the GPU host; the CPU tests "
             "(tests/test_torch_io.py, tests/test_torch_bucket_backends.py) hold them to "
             "lshrs_tpu")
    del f100
    # Phase 15: the port's benchmark at its smoke size, every row.
    drive("bench_smoke", KERNELS, phase_bench_smoke)
    # Phase 16: the capacity and recall benches at their smoke sizes: B1 in
    # the sweep's register instantiations, B2 symmetric and at both
    # cascade prefixes' coarse packings.
    drive("recall_capacity_smoke", (B1, B2), lambda: phase_recall_capacity_smoke(label),
          b1_shapes=[(64, 1), (32, 1), (16, 1), (8, 1), (32, 2)],
          b1_templates=[(64, 1, 1), (8, 1, 1), (8, 2, 1)],
          b2_packings=[packings["symmetric"], packings["cascade_coarse"],
                       packings["cascade64_coarse"]])
    # Phase 17: the stage profiles at their smoke sizes: B1 in the collision
    # profile and the gather engine, B2 at 256 columns and the cascade64
    # coarse packing.
    drive("profiles_smoke", (B1, B2), lambda: phase_profiles_smoke(label),
          b2_packings=[packings["symmetric"], packings["cascade64_coarse"]])
    # Phase 18: the serving benches at their smoke sizes: B1 at 16 and 32
    # band words, B2 at the symmetric key and the int8 wire's packing.
    drive("serving_benches_smoke", (B1, B2), lambda: phase_serving_benches_smoke(label),
          b1_shapes=[(NUM_BANDS, 1), (CP_BANDS, 1)],
          b1_templates=[(NUM_BANDS, 1, 1), (CP_BANDS, 1, 1)],
          b2_packings=[packings["symmetric"], packings["asymmetric_int8"]])
    # Phase 19: the maintenance benches at their smoke sizes: B1 at 32 band
    # words (the rehash's self-match) and at 16 (the sharded build's spot
    # check and both selections of the A/B).
    drive("maintenance_benches_smoke", B1, lambda: phase_maintenance_benches_smoke(label),
          b1_shapes=[(CP_BANDS, 1), (NUM_BANDS, 1)],
          b1_templates=[(CP_BANDS, 1, 1), (NUM_BANDS, 1, 1)])
    # Phase 20: the bandings past the powers of two, through LSHRS: B1 at 48
    # band words and at 8 with two probes.
    drive("bandings", B1, lambda: phase_bandings(args.seed, label),
          b1_templates=[(48, 1, 1), (8, 1, 2)])

    sources = {
        "group_max_keys": ("lshrs_tpu_torch/csrc/collision_group_max.cu",
                           "lshrs_tpu/ops/pallas_scan.py:378"),
        "hamming_group_max_keys": ("lshrs_tpu_torch/csrc/hamming_group_max.cu",
                                   "lshrs_tpu/ops/pallas_scan.py:314"),
        "hamming_packed_group_max_keys": ("lshrs_tpu_torch/csrc/hamming_packed_group_max.cu",
                                          "lshrs_tpu/ops/pallas_scan.py:267"),
        # the reference's tail is plain XLA (no Pallas kernel): _select_refine
        REFINE: ("lshrs_tpu_torch/csrc/hamming_refine_topk.cu", "lshrs_tpu/ops/hamming.py:202"),
        # nor is the reference's selection (lax.top_k): select_top_groups
        SELECT: ("lshrs_tpu_torch/csrc/group_select.cu", "lshrs_tpu/ops/scan.py:408"),
    }
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": kern["max_abs_err"][name],
         **{key: times[name][key] for key in
            ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}
        for name, (src, rep) in sources.items()
    ]
    # B2 once more per phase-10 packing: its launches at that packing on
    # that path (not the symmetric launches the path makes to compare),
    # the asymmetric one with phase 18's at the same packing.
    src, rep = sources[B2]
    for (c, p, qmax), variant in B2_TIMED_NEW.items():
        path = variant.split("@")[1].replace("_coarse", "")
        packing = packings["cascade_coarse" if qmax is None else "asymmetric_int8"]
        n = b2_by_packing[path, packing]
        if qmax is not None:
            n += b2_by_packing["serving_benches_smoke", packing]
        kernels.append(
            {"name": variant, "route": "cuda", "source": src, "replaces": rep,
             "launches": n, "max_abs_err": kern["max_abs_err"][B2],
             **{key: times[variant][key] for key in
                ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}})
    # B2 once more at sharded_16m's shard: its symmetric launches there.
    kernels.append(
        {"name": B2_SHARDED_16M, "route": "cuda", "source": src, "replaces": rep,
         "launches": b2_by_packing["sharded_16m", packings["symmetric"]],
         "max_abs_err": kern["max_abs_err"][B2],
         **{key: times[B2_SHARDED_16M][key] for key in
            ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}})
    # B3 once more at packed_4m's batch (its launches there), and B2 on the
    # same words' planes as B3's two timed entries (B2's symmetric
    # launches on the packed_4m path, which holds the two engines equal).
    src, rep = sources[B3]
    kernels.append(
        {"name": B3_PACKED_4M, "route": "cuda", "source": src, "replaces": rep,
         "launches": b3_by_shape["packed_4m"][NUM_BANDS, ROWS],
         "max_abs_err": kern["max_abs_err"][B3],
         **{key: times[B3_PACKED_4M][key] for key in
            ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}})
    src, rep = sources[B2]
    for variant in B2_B3_WORDS.values():
        kernels.append(
            {"name": variant, "route": "cuda", "source": src, "replaces": rep,
             "launches": b2_by_packing["packed_4m", packings["symmetric"]],
             "max_abs_err": kern["max_abs_err"][B2],
             **{key: times[variant][key] for key in
                ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}})
    # B1 once more per timed multi-probe / 32-word instantiation: the same
    # source, its launches on the main path at that (BW, probes).
    src, rep = sources[B1]
    for variant in B1_VARIANTS.values():
        t = times[variant]
        kernels.append(
            {"name": variant, "route": "cuda", "source": src, "replaces": rep,
             "launches": b1_by_shape[t["bands"], t["probes"]],
             "max_abs_err": kern["max_abs_err"][B1],
             **{key: t[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}})
    # B1 once more per recall-sweep and phase-20 banding the main path
    # launched (by its shape <BW, W, P>: 8 x 32 and 4 x 64 share the
    # band-word count), and B2 at the cascade64 coarse packing (its
    # phase-16 and phase-17 launches).
    for (nb, w, _, _, probes), variant in {**B1_RECALL_1M, **B1_BANDINGS_1M}.items():
        n = b1_by_template.get((nb * w, w, probes), 0)
        if n:
            t = times[variant]
            kernels.append(
                {"name": variant, "route": "cuda", "source": src, "replaces": rep,
                 "launches": n, "max_abs_err": kern["max_abs_err"][B1],
                 **{key: t[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}})
    src, rep = sources[B2]
    kernels.append(
        {"name": B2_CASCADE64_8M, "route": "cuda", "source": src, "replaces": rep,
         "launches": sum(b2_by_packing[path, packings["cascade64_coarse"]]
                         for path in ("recall_capacity_smoke", "profiles_smoke")),
         "max_abs_err": kern["max_abs_err"][B2],
         **{key: times[B2_CASCADE64_8M][key] for key in
            ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}})
    # hamming_refine_topk once more per timed case its (nw, group) the main
    # path launched: its launches there.
    src, rep = sources[REFINE]
    for (_, _, group, nw, _, _, _), variant in REFINE_TIMED.items():
        n = refine_by_shape.get((nw, group), 0)
        if n and variant != REFINE:
            kernels.append(
                {"name": variant, "route": "cuda", "source": src, "replaces": rep,
                 "launches": n, "max_abs_err": kern["max_abs_err"][REFINE],
                 **{key: times[variant][key] for key in
                    ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}})
    # group_select once more at each wiki6m4.batch block's width: its
    # launches on the whole main path (the wrapper counts no shapes).
    src, rep = sources[SELECT]
    for variant in SELECT_TIMED.values():
        if variant != SELECT:
            kernels.append(
                {"name": variant, "route": "cuda", "source": src, "replaces": rep,
                 "launches": launches[SELECT], "max_abs_err": kern["max_abs_err"][SELECT],
                 **{key: times[variant][key] for key in
                    ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}})
    emit("done", script_s=time.perf_counter() - start)
    print(label)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
