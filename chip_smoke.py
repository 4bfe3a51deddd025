#!/usr/bin/env python3
"""Drive deequ_tpu_torch's main path on one CUDA card and hold every kernel
of that path against its plain PyTorch version.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py [--rows N] [--seed S]

Phases, each printed as one JSON line on stdout:

1. ``device``  — the card (torch) and its name and power limit (nvidia-smi);
2. ``build``   — compile the CUDA kernels from the checkout's sources, one
   ``nvcc`` each, all at once, and the native host kernels
   (``deequ_tpu_torch/native/kernels.cpp``) with ``g++``;
3. ``kernel_parity`` — every kernel against its plain version on the card,
   bit-exact, over edge cases, both sides of each regime boundary, 10^7
   Zipf and single-hot-bin ids in every regime that can take their width,
   and weights whose per-block partial sums leave int32; and K7, the
   kernel's multi-input entry (``fused_bincount``, the counterpart of the
   reference's cross-set grouping fusion), against ``fused_bincount_plain``
   bit for bit: K = 1–4 inputs on both sides of the shared/partition
   boundary, the partition regime's narrow and wide inputs alone and
   together, 70 inputs, inputs of one row and of none, a wholly dropped
   input, ids past their own keyspace, the main path's shape (10^7 Zipf ids
   over each of 1,078,737, 9 and 5,001 bins), the partition route's edges
   (narrow ids past their keyspace in a wide input's bins, every wide id in
   one bucket, wide only, narrow only, the summed keyspace on both sides of
   sms << 13, 70 wide and narrow inputs), and a refusal past the partition
   regime's width; and K6, the one-hot variant of the histogram tier
   (``csrc/onehot.cu``, ``bincount_onehot``), against both its plain
   versions (``bincount_onehot_plain``, ``bincount_plain``) bit for bit:
   int32 and int64 ids at 1 to 2^17 bins (each side of its narrow route's
   edge, 2,048, and of a wide tile's) over 0 to 3 rows, both sides of a
   step of 32 rows, a group of 64 and a partition chunk; ids off a 16-byte
   boundary; negative ids, ids past m and past the tiles, int64 ids past
   2^31, all rows dropped; 10^7 Zipf and single-bin ids, 2^22 bins;
   negative, INT32_MAX, wrapping and all-ones weights each side of the
   weighted edges, to 2^20 bins; its multi-input entry on both routes
   against ``fused_bincount_plain``; its refusals past its widths;
3b. ``k1_parity`` — K1, the fused scan's masked reductions
   (``csrc/masked_reduce.cu``), against its plain versions on the card:
   counts, min and max exact (NaN included), sums within 1e-13 · Σ|x|,
   m2 and the co-moments within 1e-12 relative (ck of sqrt(x_mk · y_mk)),
   each centred sum plus its means' rounding floor; over ±inf, NaN, -0.0
   and subnormals, all-masked tasks, one row, a constant column, a column
   of mean 1e8 and spread 1e-3, sizes on both sides of a warp's, a
   block's and a tile's rows (the kernel's ``deequ_k1_geometry``), one to
   three masks and int32 lengths, a task of no rows among others, sources
   past their caps of masks and combos, identical tasks, and 10^7 rows;
   the same bits for a column at another alignment, a column and a mask
   off a 16-byte boundary, a batch in another order and a task alone in
   its batch; the fold merge bit for bit (every task of the main check's
   resident chunk is held in phase 12);
4. ``main_path`` — ``VerificationSuite.on_data(table).add_check(check).run()``
   on a 10^7-row table (20 float64 columns with 1% nulls, the repo's
   profiling config 2 in BASELINE.md, plus an all-distinct int64 id, a
   Zipf-skewed int64 customer id with ~10^6 distinct values, and string
   columns of 8 and 5,000 values), every metric checked against numpy;
   the kernel launch counts are read around the run and the run is
   watched for any torch operation computing on a CPU tensor; the dense
   grouping sets customer_id, status and region fuse into one K7 launch
   and no K5 launch (``id`` is sparse and takes its own pass): three fused
   passes among the four grouping passes;
4b. ``fusion_path`` (after ``resident_path``'s ``main`` part, over the main
   path's table in memory) — cross-set grouping fusion: the main suite with
   fusion on and with ``DEEQU_TORCH_PLAN_FUSION=0``, each checked once
   (counts set to 0 just before, read just after, watched for CPU ops,
   every K5 and K7 launch held against its plain version): one K7 launch
   and no K5 launch fused, three K5 launches and no K7 launch unfused, the
   same grouping passes, the same 113 metrics bit for bit; then each side
   timed three times in turns, the first side alternating (the checked
   runs warm them), every run the same bits;
   an injected ``DeviceOOMException`` at the fused dispatch demotes the
   group (one ``fusion_demote`` event: 3 passes, the summed keyspace) to
   three K5 launches with the same bits; the resident main run made no
   fused pass (status and region count from resident codes, customer_id
   is alone in its group); the sparse ``id`` set's preparation, which the
   fused pre-pass drops and its own pass makes again, timed; and
   ``kernel_timing`` of K7 at the fused group's shape (the kernel alone
   and the three K5 launches it replaces, in turns, each with
   torch.profiler's time by kernel; a wrapper call, its plain version,
   ``torch.bincount`` over the host-concatenated keys, its bound, and the
   grouping layer's one fused dispatch against three, keys copied and
   counts fetched; ``tools/time_k7.py --parent`` times another checkout's
   entry in the same turns);
4c. ``hist_variant_path`` (after ``fusion_path``, over the main path's
   table) — the histogram kernel-variant tier: the main suite with
   ``DEEQU_TORCH_HIST_VARIANT`` forced to onehot, scatter and pallas, one
   checked run each in memory (every metric bit for bit main_path's) and
   one each persisted (bit for bit the unforced persisted run's, which is
   held against main_path's within the contract); each run's K6 launches
   equal the census's one-hot dispatches, above 0 under onehot only, and
   a forced run counts no other variant; the policy's default route of
   each of the main path's dispatches; K6 at status's and region's shapes
   and its multi-input entry at the fused group's beside K7, in turns; and
   the sweep: K6 and K5 in its regime in turns, and torch.bincount, at
   10^7 int64 Zipf ids and 9 to 2^22 bins (K6's narrow edge and K5's
   shared edge among them), each with the histogram's bound (its bytes
   over the memory rate) and, apart, K6's own traffic and the one-hot
   product's operations over the part's dense INT8 rate; the sweep sets
   the card's one-hot cap (``device_policy.HIST_ONEHOT_MXU_MAX_SEGMENTS``:
   ``cap_from_sweep``, the widest width up to which K6 was no slower at
   every swept width), and the phase fails when the default cap is not
   the rule's;
5. ``kernel_timing`` — each kernel at the shapes the main path gave it:
   the kernel alone (``kernel_ms``: 100 queued launches into preallocated
   buffers, CUDA events; the same in every other regime that can take the
   width, ``regime_ms``; torch.profiler's device time beside it), one
   wrapper call as a caller pays it (``call_ms``), its plain version, the
   PyTorch library call computing the same function, and its bound; and
   every regime on both sides of each regime boundary (``boundaries``);
6. ``hll_parity`` (run after phase 3) — the HLL kernel against its plain
   version on the card, bit-exact: the float64 split's edge values (NaN
   payloads and signs, ±inf, ±0.0, f32-subnormal magnitudes, past the f32
   range, ±2^31, 2^53 + 1), boolean and string-LUT inputs, an all-invalid
   column, one row, sizes around a block's and the grid's rows, and 10^7
   rows of each input mode;
6b. ``select_parity`` (run after phase 6) — K4's kernel
   (``csrc/select.cu``) against its plain version on the card, bit for bit
   (the summary with the remainder in the same row order, and
   ``select_ranks``' keys, tie ranks and each pass's prefix and rank left,
   at the summary's targets and at ranks in any order), and against K3
   (the remainder sorted): tests/select_cases.py's adversarial columns at
   k = 256, 2,048 and 16,384, the kernel's tile edges at K = 1 and 50, and
   a constant column at the resident sketch chunk's rows;
7. ``sketch_path`` — a second ``run()`` at BASELINE.md config 3's width
   (10^7 rows: 48 float64 columns, an int64 column within int32 and one
   beyond it, a boolean and a 5,000-value string column): ApproxQuantile at
   four quantiles on the 50 numeric columns, one KLLSketch,
   ApproxCountDistinct on all 52 columns and one Correlation; it checks one
   fetch, one batched sort a chunk, no torch op on a CPU tensor, one HLL
   launch per column and chunk, every column's registers against the plain
   version, every estimate and quantile against numpy, and the card's KLL
   states against the CPU's on a 10^6-row slice; then the run's wall time
   and its pieces;
8. ``kernel_timing`` of the HLL kernel at that table's shape;
9. ``check_api_path`` (run after phase 4, over its table) — a second
   ``run()`` of one check holding the check methods of the frequency
   tables and the string analyzers: has_histogram_values(status),
   has_number_of_distinct_values(region) with a binning UDF,
   has_mutual_information(status, region) (dense, 9 x 5,001 slots: the
   one dense grouping set, so nothing fuses) and
   (customer_id, status) (about 9.7M slots: the sparse device route),
   has_min_length / has_max_length / has_pattern / contains_email(region),
   has_data_type(status) and a Histogram of the float64 f0; every metric
   against numpy (exact; MutualInformation relative 1e-12), four K5
   launches and no K7 launch, one fused scan with one fetch, no torch op
   on a CPU tensor;
10. ``frequency_path`` — BASELINE config 4 (benchmarks/run_configs.py:
   config4) at 10^7 rows: ApproxCountDistinct, Histogram (1,000 detail
   bins) and Uniqueness over one string column of 3,333,333 distinct
   labels; the Distribution (its tied boundary included) and Uniqueness
   exactly against numpy, the estimate within 0.15, one K5 launch a
   count, no torch op on a CPU tensor, no lookup table built by a second
   run, and the card's Distribution equal to the CPU's over 10^6 rows;
   then the run's wall time and its pieces;
11. ``kernel_timing`` of K5 at the frequency path's two shapes and at
   config 4's own width (10^8 ids over 33,333,334 slots, made on the
   card), and of the packed-key top-k there;
12. ``resident_path`` — ``persist()`` and the resident scan, in three
   parts run over the tables above before each is dropped (each runs its
   suite once checked, counts set to 0 just before and read just after,
   watched for CPU ops, then once warm and three times timed, and shows
   ``unpersist()`` dropping ``torch.cuda.memory_allocated()`` by at least
   the resident bytes): ``main`` (after phase 5) — every metric equal to
   the streaming run's (exact, or within PERF.md §2's bounds), no bytes
   packed, ``status`` and ``region`` counted from resident codes by K5,
   ``trace`` (one whole resident ``run()`` under torch.profiler: the
   device's busy and idle share of its window, its kernels, the host
   time between launches), and ``k1_fused_scan``: the fused scan's
   device kernels under torch.profiler, K1's and any torch reduce kernel
   left apart, every K1 task of the resident chunk against its plain
   version, K1 alone on that batch (its sources and combos, kernel,
   wrapper call, plain and library times, its bound), its fold merge
   alone on the pass's state vector (kernel and plain times, its bound,
   bit for bit), beside the old bound of the whole pass: the
   resident planes of the columns it reads, read once; and,
   inside it, ``encoded`` — two low-cardinality numeric columns made
   from the main table, encoded and persisted, bit-identical to their
   decoded twin with at most half its resident bytes; ``sketch`` (after
   phase 8) — the select (K4) in place of every sort
   (``device_select_passes`` > 0, ``device_sort_passes`` = 0), every KLL
   state bit-identical to a ``select_kernel=False`` scan of the same
   resident chunks, one K4 kernel launch a select pass, quantiles within
   the rank bound, HLL estimates equal to the streaming run's, the run's
   pieces (``host_fold_summaries`` among them), then a ``kernel_timing``
   line of K4 at the resident chunk's shape (the kernel alone and each of
   its stages, a wrapper call and its working set, its plain version,
   ``torch.sort`` of the same keys, K3 whole, the bound; the same for
   constant columns), and a ``select_shapes`` line: K4 against K3 at
   resident chunk shapes (1, 8 and 50 columns, 2^16 to 2^25 rows, k =
   2^8, 2^11 and 2^14);
   ``frequency`` (after phase 11) — Histogram's top-k and Uniqueness's
   count statistics from resident codes, equal to the streaming run's,
   Uniqueness fetching four scalars (32 bytes). Each part runs its suite
   once more with every K5 launch held against ``bincount_plain`` on the
   same ids (``bincount_vs_plain``: the shapes checked);

13. ``partition_path`` (after ``resident_path``'s ``main`` part, over the
   main path's table) — deequ's partitioned workflow: the table cut by row
   range into 10 daily partitions of 10^6 rows, each verified on the card
   (the main check plus ApproxCountDistinct(customer_id) and
   ApproxQuantiles of f0–f3 at 0.1/0.5/0.9) with its states saved to a
   ``FileSystemStateProvider`` under a temporary directory the phase
   removes; then ``VerificationSuite.run_on_aggregated_states`` over the
   10 directories, held against a whole-table run of the same suite
   (counts, completeness, compliance, min/max, uniqueness, distinctness,
   CountDistinct, the merged frequency tables and the HLL registers
   exact; sums and means within 1e-12, standard deviation, correlation
   and entropy within 1e-10; each quantile's rank within relative_error
   · n); then partition 3 regenerated from ``seed + 1``, rerun alone and
   aggregated again against a whole-table run over the updated table;
   each partition run's four grouping sets (``id`` is dense at 10^6 rows)
   fused into one K7 launch and no K5 launch; every K5, K7 and K2 launch
   of the partition runs held against its plain version; a subnormal column cut into partitions and aggregated,
   against numpy. Prints the partition and aggregate walls, the state
   bytes written and the largest state file, the launches, the peak
   device bytes and the CPU-op watch;
14. ``stream_path`` — ``IncrementalVerificationStream`` (window 8) over
   32 batches of 2^18 rows of the same schema (the main path's
   scan-shareable constraints, has_distinctness(status),
   ApproxCountDistinct(customer_id)), states carried in an in-memory
   provider, against a serial loop of ``do_verification_run`` with the
   same providers: every batch's metrics and every saved state's bytes
   identical; 4 groups, one fetch a group, the host-to-device copies a
   group scan makes, both walls, both runs' peak device bytes, K1 batches
   a group, K2 one launch a batch, every K5 and K2 launch against its
   plain version;
15. ``repository_path`` (after ``stream_path``, over the main path's
   table) — the metrics repository, anomaly checks and the monitor, in
   three parts. First the Holt-Winters fit (K9, ``csrc/holt_winters.cu``):
   the plain autograd fit of 17 series on the host's CPU (spawned worker
   processes, all shut down after), the kernel within 1e-12 of each with
   the same flagged points (a weekly series at 2p, 28, 36, 365 and 730
   points, a monthly one at 24, 28, 36, 365 and 730, the block edges
   2p + 1 at both periodicities and 358 weekly points, a constant series
   and one near 10^9), the kernel at forced block lengths (one block to
   the default) on the weekly 365 and monthly 730 points against the
   same plain fits, a 10-step fit against the plain version on the card,
   and a ``kernel_timing`` line (the kernel alone at 365 and 730 weekly
   and 730 monthly points with its blocks, a wrapper
   call, the plain version's 10 steps on the card scaled to 300, the
   bound and the point-by-point chain). ``daily_run``: a year of
   tenant-0's history (Size, Completeness(f1) with a weekly pattern,
   Mean(f0)) in a
   ``FileSystemMetricsRepository`` under a temporary directory the phase
   removes, then today's ``run()`` (the main check, CountDistinct and
   ApproxCountDistinct(customer_id)) saving under ResultKey(365) with
   three anomaly checks — OnlineNormal on Size, RelativeRateOfChange on
   Mean(f0) (scripted to fire), Holt-Winters on Completeness(f1): every
   metric against numpy, each check's status against the strategy
   recomputed here (Holt-Winters with the plain fit on the host's CPU),
   one K9 launch, one K7 launch and no K5 launch (the main suite's
   fused sets), no torch op on a CPU tensor, today's result read back
   through a fresh repository, and a second run reusing today's key with
   no scan and no launch. ``fleet_history``: 50 tables × 365 days × the
   main run's 113 scalar metrics and Completeness(f1), 2,080,500 history
   rows (cut from 100 tables to keep the script in its time),
   seeded by ``save()`` into a ``ColumnarMetricsRepository`` that a
   ``QualityMonitor`` watches (Holt-Winters on tenant-0's Completeness(f1),
   a weekly pattern that steps after its first week, armed by one K9
   launch on the card within 1e-12 of the plain fit on the host's CPU,
   one scripted drop on the last day; OnlineNormal on its Size, one
   scripted drop on day 250: exactly one alert each), ``compact()``-ed,
   then two queries
   on the card (cross-tenant Completeness(f1) over days 30–330, and every
   row): one fetch each, count/min/max exact and sum/mean within 1e-12,
   stddev within 1e-10 of numpy, bit for bit the decoded query and the
   loader-side baseline, the encoded query staging at most half the
   decoded one's bytes; the save, compact, history-build, query and
   loader-side walls;
16. ``profile_path`` (after ``repository_path``, over the main path's
   table with one more column, ``zip``: 10^7 five-digit numeric strings
   from 40,000 codes, 1% null; BASELINE.md config 2's ColumnProfiler
   workload, 25 columns) — ``ColumnProfilerRunner.on_data(table)
   .with_kll_profiling().run()``, counts set to 0 just before and read
   just after, watched for CPU ops: every profile field against numpy
   (size, completeness, type counts, min/max and the histogram of
   ``status`` exact; sum and mean within 1e-12, standard deviation
   within 1e-10; ``zip`` inferred Integral), both passes' scans resident
   with no bytes packed and pass 3's histogram counted from resident
   codes, K2, K4 and K5 launched, the table and its cast twin persisted
   and freed (``torch.cuda.memory_allocated`` falling by at least their
   resident bytes); then three timed profiles (each pass and each
   ``persist()`` timed), every ApproxCountDistinct bit for bit a streaming
   ``do_analysis_run``'s and every KLL profile bit for bit a streaming
   scan (K3) of the cast table cut at the resident chunk's rows. Then
   ``ConstraintSuggestionRunner`` (``Rules.DEFAULT`` and
   UniqueIfApproximatelyUniqueRule, a held-out tenth): the suggestions,
   their code and the held-out statuses over the first 10^6 rows on the
   card equal to the port's run on the CPU, then two timed runs over all
   10^7; ``RowLevelSchemaValidator`` over a 10^5-row raw string table
   with its valid rows verified on the card against numpy;
   ``Applicability`` of the main check, the card's verdict the CPU's;
   and the ``deequ_migration_example.py`` flow (a legacy repository JSON
   imported, an anomaly check reading it, once quiet and once firing);

17. ``out_of_core_path`` (after ``profile_path``) — ``StreamingTable`` runs,
   each part printed as a line of its own with the card's name and power
   limit: ``config2_stream`` — the main suite over the main table as a
   stream of 2^20-row batches (``stream_table``), every metric against
   numpy and the in-memory run (PERF.md §2), and a stream cut at the
   in-memory run's chunk rows bit for bit the in-memory run; one fetch of
   the fused scan, the double buffer's issue order
   (``ingest_overlap_frac``), no torch op on a CPU tensor; walls (median
   of 3 after a warm run) streamed and in memory, peak device bytes, the
   host RSS growth (``/proc/self/statm`` sampled on a thread), K1, K2 and
   K5 launches, and one streamed run under torch.profiler (``trace``: the
   card's busy share, and the share of the host-to-device copies' device
   time during which a kernel ran too); ``config3_stream`` — BASELINE.md
   config 3's check (the sketch path's, with size, completeness, min, max,
   sum and mean of every numeric column) over 7·10^7 rows (seven times
   ``--rows``: 535 chunks, one drain of the fold; cut from 10^8 to keep
   the script in its time, ``tools/run_out_of_core.py`` runs 10^8)
   from a ``GeneratorBatchSource`` whose batch b of 2^17 rows
   is made from (seed, b) on six threads and dropped after its use:
   counts, completeness, min and max exact against numpy's answer
   accumulated batch by batch, sums and means within 1e-12 (per-batch
   sums folded by math.fsum), the correlation within 1e-10 (Chan's merge
   of per-batch co-moments), each quantile's rank within relative_error
   + 5/sqrt(n) under the generating distribution (exact counts for cust),
   every ApproxCountDistinct's registers bit for bit those of K2's plain
   version run on each batch on the card and max-merged, and its estimate
   within 0.2 of the distinct count (a sanity check); one HLL launch a
   column and chunk, two KLL sorts a chunk, the fold's drains with KLL
   compaction there, and the host RSS growth under a tenth of the bytes
   streamed; ``profile_stream`` — ``ColumnProfilerRunner`` with KLL over
   the main table with ``zip`` as a stream: against numpy and the
   in-memory profile, each KLL percentile's rank within 0.01, nothing
   persisted; ``parquet`` — where pyarrow imports, the main table's first
   half (``OOC_PARQUET_CUT``) written by ``write_parquet_stream`` (row
   groups of 2^20) to a temporary directory and the main suite over
   ``stream_parquet`` bit for bit the same rows' table stream, else the
   line says it did not run;
18. ``spill_path`` (after ``out_of_core_path``) — group memory budgets,
   checkpoints and quarantine, each part a line of its own with the
   card's name and power limit: ``config4_spill`` — ``frequency_path``'s
   config 4 table at half ``--rows`` (cut from ``--rows`` to keep the
   script in its time) streamed in 2^20-row batches with
   ``build_config4_check()`` under a quarter of the unbudgeted stream's
   Histogram state bytes (``spill/store.py:state_nbytes``): at least 4
   spill runs; the Histogram's 1,000 bins, Uniqueness and the state's row
   count equal numpy's ``bincount`` of the codes; all three metrics bit
   for bit the unbudgeted stream's and the in-memory run's; the HLL
   registers K2's plain version's over the codes; the spill counters, the
   spill directories' peak bytes (sampled every 20 ms), wall, rows/s,
   host RSS growth, K5 and K2 launches; no spill directory left;
   ``config2_spill`` — the main suite as a stream under a 32 MiB budget
   (the id grouping's batch states spill) bit for bit
   ``config2_stream``'s run, and the table in memory under that budget
   with its states saved (the ``budget_batch_rows`` slices) bit for bit
   the in-memory run; ``config2_resume`` — the main suite as a stream
   checkpointed every 2 batches into a temporary directory: uninterrupted
   (one fused scan a batch, its fetches at most the checkpoint boundaries
   + 1, the save walls and file bytes), then a run whose source dies at
   batch 7, then the resume, which must read from batch 6 and equal the
   uninterrupted run bit for bit in every metric and leave no checkpoint;
   ``config2_quarantine`` — the main suite through ``FlakyBatchSource``
   with batches 3 and 8 unreadable past a 2-retry policy and transient
   faults on 1, 5 and 9, ``on_batch_error="skip"``: ``skipped_batches``
   exactly [3, 8], every metric against numpy over the rows that remain
   (counts exact, sums within 1e-12), and the transient faults alone
   retried to the uninterrupted run's bits;
19. ``device_fault_path`` (after ``spill_path``, over the main path's
   table) — the device fault ladder and run governance, each part a line
   of its own with the card's name and power limit, every part's checked
   run watched for CPU ops (on the watchdog's worker threads too):
   ``real_oom`` — the table persisted and the main suite run clean (its
   and the fused scan's working sets measured), then a ballast tensor
   sized from ``torch.cuda.mem_get_info`` and pieces of ballast down to
   1 MiB take the card's free memory and the allocator's free blocks, and
   the suite runs again: at least one
   ``oom_bisect`` caused by a real ``torch.cuda.OutOfMemoryError``, the
   first evicting the residency (``evicted_bytes`` from
   ``torch.cuda.memory_allocated``), every metric against numpy and bit
   for bit a clean run at the final chunk rows; the ballast freed, a
   clean run gives main_path's bits; ``injected_oom_mid_fold`` — the suite
   at 2^21-row chunks with chunk 3 of attempt 0 OOMing: one bisection, the
   fused scan's one fetch and the run's fetches a clean run's at 2^20,
   every metric and fused-scan leaf bit for bit that clean run's; a
   persistent OOM on a 2^16-row slice down to the 64-row floor, failing
   the fused-scan analyzers with ``DeviceOOMException`` under "fail" and
   ``DeviceFallbackRefusedException`` under "fallback"; ``hang`` — a host
   stall of 3.5 s at the execute seam under a 2 s ``device_deadline``: the
   fused-scan analyzers fail with ``DeviceHangException`` (deadline 2 s),
   and once the stalled worker wakes, no K1 launch and no fetch of it
   (the run's fetches a clean run's less one); the next run main_path's
   bits; under "fallback" three such hangs open ``DEVICE_HEALTH``, the
   next suite is refused ("unhealthy_backend") with no step and no K1
   launch, and the half-open probe runs on the card against numpy; a
   0.5 s ``run_deadline`` and no hook abandons the fused scan's attempt
   in its host packing: the fused-scan analyzers fail with
   ``DeviceHangException``, and once the pack in flight returns the
   worker steps no chunk, launches no kernel and counts no fetch; the
   main run's wall with the deadline armed and not, three each in turns;
   ``budget_degrade`` — the main suite streamed in 2^20-row batches with a
   persistent injected OOM from batch 6 and ``max_total_attempts=4``,
   ``on_budget_exhausted="degrade"``: ``unverified_row_ranges`` exactly
   [(6 · 2^20, rows)], the ledger five bisections and exhausted, every
   metric against numpy over the rows before, ``retry_stats`` reported;
   under "raise" a ``RunBudgetExhaustedException``;
20. ``mesh_path`` (after ``device_fault_path``, over the main path's table
   at its full 10^7 rows, not cut): the row-sharded mesh
   (``deequ_tpu_torch/parallel/``) on a virtual mesh of 4 members on the
   one card, one line a part. ``sharded`` — the main suite in memory and
   persisted over the mesh: all 113 metrics against main_path's
   single-device result (exact, or within ``_REL``); every member
   launched K1 and K7 (in memory) or K1 and K5 (persisted) in the checked
   run, each K1 batch held against its plain versions (``k1_hold``), each
   K5 and K7 launch against its plain version (``PlainCheck``), each K8
   merge (``scan_engine.mesh_merge``: the members' vectors folded on the
   lead by ``k1_merge``) bit for bit against ``merge_tags_plain`` in
   member order (K8's ``k1_merge`` launches counted at the launch under
   the caller ``"mesh"``); one timed run each; K8 alone on the main chunk's
   vectors and the 4-member int64 count sum of ``customer_id``'s bins
   beside their bounds; ``reshard`` — member 2 lost mid-scan over the
   persisted table: one ``mesh_reshard`` 4 -> 3, the residency evicted,
   metrics bit for bit a healthy 3-member run's, and the next scan
   leaving member 2 out up front (``mesh_quarantine``, no injection);
   ``straggler`` — member 2 stalled 3.5 s under a 2 s shard deadline: the
   fused-scan analyzers fail with ``DeviceHangException``, one
   ``mesh_straggler``, and once the worker wakes no K1 or merge launch
   (K8's included); ``all_lost`` — every member lost under "fallback": three
   reshards, then ``DeviceFallbackRefusedException`` from a
   ``MeshDegradedException``; ``processes`` — two processes on the card
   over a gloo group (``tools/multiprocess_merge.py``), each persisting
   its ``host_row_range`` half: their merged scan metrics, exactly the set
   of main_path's scan-shareable analyzers (the grouping sets' frequency
   tables are not merged across processes), against main_path's; and
   with rank 1 killed, the survivor's suite through the builder's
   ``.on_peer_loss("degrade")`` (over 10^6 rows: the hold is the report):
   every metric computed and exactly rows [n / 2, n) on the result's
   ``unverified_row_ranges``; ``cards`` — the in-memory
   run over the default mesh of every card where there are several, else
   skipped with the count;
21. ``serve_path`` (after ``mesh_path``) — the in-process serving tier
   (``deequ_tpu_torch/serve``, ``obs``): Load A, the reference's serving
   load (its ``bench.py:measure_serving_load``): 1,000 tenants of 256 rows
   (``x`` f64 with 5% nulls, ``i`` integral), 8 repeat suite shapes, 20
   fresh tenants reading a column of their own, the reference's check,
   ``max_batch`` 256, submitted all at once to a service whose worker is
   watched for CPU ops, once cold and three times sustained: a sample of
   32 tenants bit for bit its serial ``VerificationSuite.run`` on the
   card; the device fetches, K1 batches and fold merges (under the caller
   ``"coalesced"``) each equal the coalesced batches; a sustained pass
   builds no program and counts 1,000 plan-cache hits; the serial suites/s
   of 64 tenants (min of 3), the cold and sustained suites/s, p50 and p99
   submit->resolve from ``SERVE_LATENCY``, members a batch; then
   ``stop(drain=False)`` after a pass's first resolution and ``resume()``
   on a fresh service: every future resolved once, the sample bit for
   bit. Traced: a pass on a service with a recorder, the Chrome trace
   written and parsed, the batches' ``coalesce_assembly``, ``transfer``,
   ``execute`` and ``fetch`` spans one each a batch on the worker's track
   inside the tenants' ``serve_request`` spans, their walls against
   ``dispatch_seconds`` and ``drain_wait_seconds``; the armed and disarmed
   walls reported. Load B, main_path's width: 64 tenants of 2^17 rows (one
   chunk), cut from main_path's table, on the scan-shareable constraints of the main check in one
   coalesced batch, each bit for bit its serial run, the first against
   numpy, one K1 batch, the batch's and one serial run's peak device
   bytes; 4 tenants on the whole check served serially,
   against numpy. Isolation: a poison tenant (``FaultInjectingScanHook``'s
   ``tenant_faults``: an OOM that follows it) in a batch of 8 bisects it
   (3 ``coalesce_bisect`` events) and ends typed on its serial rung, the 7
   others bit for bit; a second such batch quarantines it and a healthy
   run readmits it; a member with no budget under an injected OOM
   degrades alone. Then K1 and its fold merge at Load A's largest
   coalesced batch, alone: kernel, plain and library ms, the bound, every
   task held against its plain version;
22. ``fleet_path`` (after ``serve_path``) — the serving fleet
   (``serve/fleet.py``, ``router.py``, ``membership.py``, ``ledger.py``),
   every worker on the card, after the reference's probe
   (``bench.py:measure_fleet_failover``). Every serial reference is run
   first, before the counts are zeroed, so the phase's launches are its
   fleets' own (the 4-worker fleets and the 1-worker baselines).
   ``healthy`` — Load A again over 4 workers from 4 submitter threads,
   cold and then timed in turns with a 1-worker fleet: every future
   resolved once, 64 sampled members and every member of the busiest
   worker bit for bit their serial runs, one K1 batch, one fold merge and
   one fetch a coalesced batch summed over the workers, no grouping count
   on the host, tenants per worker, suites/s of both, p50/p99
   submit->resolve, and at least half the 1-worker rate; ``death`` — the
   probe's 144 tenants over 12 row counts, which spread over the ring,
   timed on the 4 workers and on a 1-worker fleet in turns from one
   submitter (the probe's no-collapse gate: at least half the 1-worker
   rate) and from 4 (reported), then the busiest warm worker wedged, the
   load submitted with a run budget each, the worker killed: exactly its
   tenants re-dispatched, each charged ``worker_failover`` once, all bit
   for bit; ``monitor_and_rejoin`` — a 1.5 s stall found by the heartbeat
   monitor (0.05 s, stall timeout 0.5 s): one loss recorded, its requests
   failed over bit for bit, no woken worker's resolution reaching a
   future; a warm rejoin whose joiner builds no serve plan (and the fleet
   no program) and serves; every worker dead, typed; ``quarantine`` — a
   poison tenant quarantined by its home worker is quarantined on all,
   served serially by another, and that success readmits it everywhere;
   ``ledger`` — 200 accepted requests stopped undrained, replayed by a
   fresh fleet on the same directory onto their futures, once and bit for
   bit, with accepts/s with and without the ledger's fsync;
   ``whole_check`` — two tenants of 2^17 rows on main_path's whole check,
   served serially by a worker (or the nearest count below whose digest
   lands off Load A's busiest worker) while the workers run Load A: bit
   for bit, against numpy, one K7 launch each and no K5. Then K1 and its
   fold merge at the fleet's largest batch held against their plain
   versions;

then the ``kernels`` summary line (each kernel's launches summed over the
paths, and by path; K1's fold merge, K7, the fused group counts, and K6,
the one-hot variant (its launches by path and by forced variant, its
shapes and the sweep), each their own entry, K8's merges as a part of the
fold merge's and the mesh's count sums beside K5; K1's and its merge's
coalesced-batch shapes beside their resident ones), the nvidia-smi line, and the result line
``{"ok": true, "device": {...}}`` last. Each path runs with the launch
counts set to 0 just before it and read just after. Any failure exits
non-zero without the result line. The script imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

#: the hand-written kernels of the port's path, each built from
#: deequ_tpu_torch/csrc/<name>.cu
KERNELS = ("bincount", "onehot", "hll", "select", "holt_winters", "masked_reduce")

#: the script's config 3 stream rows over ``--rows`` (seven: past one drain
#: of the stream fold's 512 chunks; ``tools/run_out_of_core.py`` runs ten).
#: This and the cuts below keep the script inside its 1,200 s: with every
#: path at its full size it ran 1,213 s on an H100 80GB HBM3 at 700 W, and
#: with hist_variant_path added 1,000.9 s (PERF.md §4)
OOC_CONFIG3_RUN_SCALE = 7
#: the script's config 4 spill rows are ``--rows`` over this
#: (``tools/run_spill.py`` streams all 10^8)
SPILL_CONFIG4_CUT = 2
#: out_of_core_path's Parquet part reads the main table's first rows over
#: this (``tools/run_out_of_core.py`` reads all of them): with serve_path the
#: script ran 1,140 s of its 1,200 on a slow host, the Parquet read 77 s
OOC_PARQUET_CUT = 2

#: timed runs after a warm one of the sketch, check-API, stream, profile
#: and streamed config 2 walls (three until device_fault_path joined the
#: script; one keeps it inside its time, main_path keeps three)
TIMED_REPEATS = 1

# memory rate of each H100 part (NVIDIA data sheets), bytes/s
_HBM_RATE = {"PCIe": 2.0e12, "NVL": 3.9e12, "SXM": 3.35e12}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def hbm_rate(name: str) -> float:
    for key in ("PCIe", "NVL"):
        if key in name:
            return _HBM_RATE[key]
    return _HBM_RATE["SXM"]


def time_cuda(fn, reps: int = 15, warmup: int = 3) -> float:
    """Median milliseconds of ``fn`` over ``reps`` CUDA-event-timed calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


# -- phase 3: kernel parity --------------------------------------------------


def zipf_ids(rng, n: int, m: int, exponent: float = 0.7):
    """n ids over [1, m) drawn with Zipf weights k^-exponent (the main
    path's customer_id exponent) by inverse transform, ranks scattered over
    the key space, 1% null (-1)."""
    import numpy as np

    u = rng.random(n)
    top = (m - 1) ** (1.0 - exponent)
    ranks = np.floor((u * (top - 1.0) + 1.0) ** (1.0 / (1.0 - exponent))).astype(np.int64)
    keys = 1 + rng.permutation(m - 1)[np.clip(ranks, 1, m - 1) - 1]
    keys[rng.random(n) < 0.01] = -1
    return keys


def kernel_parity(device) -> dict:
    """The kernel against its plain version, bit for bit: the edge cases of
    tests/test_torch_histogram.py, both sides of every regime boundary the
    rule reports, K4's 65,536-bin width, 10^7-row Zipf and single-hot-bin
    inputs in every regime that can take their width, and weights whose
    per-block partial sums leave int32 while each bin's total does not."""
    import numpy as np
    import torch

    from deequ_tpu_torch.ops import histogram_device
    from deequ_tpu_torch.ops.histogram_device import (
        REGIMES,
        bincount,
        bincount_plain,
        regime,
        regime_widths,
    )

    rng = np.random.default_rng(7)
    cases = 0
    max_err = 0

    def check(seg_np, m, weights_np=None, dtype=torch.int64, regimes=(None,)):
        """bincount (regime None: the rule's, through the wrapper) or a
        launch in each named regime, against the plain version."""
        nonlocal cases, max_err
        seg = torch.from_numpy(seg_np).to(device=device, dtype=dtype)
        w = None if weights_np is None else torch.from_numpy(weights_np).to(device)
        want = bincount_plain(seg, m, weights=w)
        for name in regimes:
            if name is None:
                got = bincount(seg, m, weights=w)
            else:
                bufs = histogram_device._buffers(seg, m, w, name)
                histogram_device._launch(seg, m, w, *bufs, regime_name=name)
                got = bufs[-1]
            torch.cuda.synchronize()
            err = int((got - want).abs().max()) if m else 0
            max_err = max(max_err, err)
            if not torch.equal(got, want):
                fail(f"bincount != plain (n={len(seg_np)}, m={m}, regime={name}, "
                     f"weighted={weights_np is not None}, dtype={dtype}): max err {err}")
            cases += 1

    widths = regime_widths()

    def takers(m):
        """Every regime that can take width m (each takes any width up to
        its widest)."""
        return [r for r in REGIMES if widths[r] is None or m <= widths[r]]

    for dtype in (torch.int32, torch.int64):
        for m in (1, 7, 511, 512, 513, 4097):
            for n in (0, 1, 1023, 1024, 1025, 5000):
                # ids in [-3, m + 3): negatives and ids >= m must be dropped
                seg = rng.integers(-3, m + 3, size=n)
                check(seg, m, dtype=dtype)
                check(seg, m, rng.integers(-50, 1000, size=n).astype(np.int32), dtype)

    # both sides of every boundary of the rule, and K4's first-pass width
    boundaries = {}
    for i, name in enumerate(REGIMES):
        widest = widths[name]
        if widest is None:
            continue
        got = {widest: regime(widest), widest + 1: regime(widest + 1)}
        if got != {widest: name, widest + 1: REGIMES[i + 1]}:
            fail(f"regime boundary of {name} not at {widest}: {got}")
        boundaries[name] = widest
    for m in sorted({8, 5001, 65_536, 1_000_001, 4_194_305}
                    | {w + d for w in boundaries.values() for d in (0, 1)}):
        seg = rng.integers(-1, m + 1, size=2_000_000)
        for dtype in (torch.int32, torch.int64):
            check(seg, m, dtype=dtype)
        check(seg, m, rng.integers(-5, 100, size=len(seg)).astype(np.int32))

    # skew at 10^7 rows: Zipf and one hot bin, in every regime that can
    # take the width, int32 and int64 ids
    rows = 10_000_000
    skew_widths = (9, 5001, 65_536, 1_078_737, boundaries["partition"] + 1)
    for m in skew_widths:
        hot = np.full(rows, m // 2, dtype=np.int64)
        zipf = zipf_ids(rng, rows, m)
        for seg in (zipf, hot):
            for dtype in (torch.int32, torch.int64):
                check(seg, m, dtype=dtype, regimes=takers(m))
    check(zipf_ids(rng, rows, 65_536), 65_536)  # K4's width, by the rule

    # weights: per-block partials leave int32, each bin's total does not
    # (the second half repeats the first half's ids with negated weights),
    # and then totals past int32 (taken mod 2^32 by both)
    half = rng.integers(0, 8, size=2_000_000)
    seg = np.concatenate([half, half, rng.integers(0, 8, size=1000)])
    big = np.int32(2**30 + 12345)
    inside = np.concatenate([np.full(len(half), big, np.int32),
                             np.full(len(half), -big, np.int32),
                             rng.integers(-100, 100, size=1000).astype(np.int32)])
    totals = np.bincount(seg, weights=inside.astype(np.float64), minlength=8)
    partial = np.bincount(half, minlength=8).max() * int(big)
    if np.abs(totals).max() >= 2**31 or partial < 2**31:
        fail("weighted edge case is not at the edge")
    beyond = np.full(len(seg), big, np.int32)
    for m in (9, 5001, 65_536):
        for weights in (inside, beyond):
            check(seg, m, weights, regimes=takers(m))
    fused = fused_parity(device, rng, boundaries)
    t0 = time.perf_counter()
    onehot = onehot_parity(device, rng)
    return {"cases": cases, "max_abs_err": max_err, "boundaries": boundaries,
            "skew_widths": {m: takers(m) for m in skew_widths},
            "fused": fused, "onehot": onehot, "onehot_parity_s": time.perf_counter() - t0}


def fused_parity(device, rng, boundaries: dict) -> dict:
    """K7, the kernel's multi-input entry (``fused_bincount``), against
    ``fused_bincount_plain``, bit for bit, one launch counted a call: K =
    1–4 inputs on both sides of the shared/partition boundary, narrow and
    wide inputs of the partition regime alone and together, 70 inputs (past
    one launch's 64), inputs of one row and of none, a wholly dropped
    input, ids past their own keyspace, the main path's shape (10^7 Zipf
    ids over 1,078,737 bins beside 10^7 ids over 9 and over 5,001), and
    the partition route's own edges: narrow ids past their keyspace in a
    wide input's bins, every wide id in one bucket, a wide input only,
    narrow inputs only past the shared width, the summed keyspace on both
    sides of sms << 13, 70 wide and narrow inputs; past the partition
    regime's width the entry refuses."""
    import numpy as np
    import torch

    from deequ_tpu_torch.ops import histogram_device
    from deequ_tpu_torch.ops.histogram_device import (
        fused_bincount,
        fused_bincount_plain,
        regime,
    )

    cases, seen = 0, {}

    def check(keys_np, spaces, label):
        nonlocal cases
        keys = [torch.from_numpy(np.asarray(k, dtype=np.int64)).to(device) for k in keys_np]
        before = histogram_device.FUSED_LAUNCHES
        got = fused_bincount(keys, spaces)
        want = fused_bincount_plain(keys, spaces)
        torch.cuda.synchronize()
        if histogram_device.FUSED_LAUNCHES != before + 1:
            fail(f"K7 {label}: {histogram_device.FUSED_LAUNCHES - before} launches, want 1")
        if not torch.equal(got, want):
            err = int((got - want).abs().max())
            fail(f"K7 != plain ({label}: rows {[len(k) for k in keys_np]}, keyspaces "
                 f"{list(spaces)}, regime {regime(sum(spaces))}): max err {err}")
        name = regime(sum(spaces))
        seen[name] = seen.get(name, 0) + 1
        cases += 1

    def split(total, k):
        cuts = np.sort(rng.choice(np.arange(1, total), size=k - 1, replace=False))
        return [int(x) for x in np.diff(np.concatenate([[0], cuts, [total]]))]

    def ids(n, space):
        # -1 drops a row; ids up to space + 1 land past the input's own bins
        return rng.integers(-1, space + 2, size=n)

    shared = boundaries["shared"]
    for total in (shared, shared + 1):
        for k in (1, 2, 3, 4):
            spaces = split(total, k)
            check([ids(int(rng.integers(1, 300_000)), sp) for sp in spaces], spaces,
                  f"K={k}, {total} bins")
    # the partition regime's routes: wide alone, narrow alone, both
    check([ids(2_000_000, 1_000_001)], [1_000_001], "one wide input")
    check([ids(500_000, 40_000), ids(500_000, 40_000)], [40_000, 40_000],
          "two narrow inputs past the shared width together")
    check([ids(1, 9), ids(2_000_000, 1_000_001), np.zeros(0, np.int64), ids(1, 1)],
          [9, 1_000_001, 7, 1], "one-row and empty inputs beside a wide one")
    check([np.full(300_000, -1), ids(300_000, 70_000), np.full(5, -3)], [12, 70_000, 5],
          "wholly dropped inputs")
    many = [int(x) for x in rng.integers(1, 3_000, 70)]
    check([ids(int(rng.integers(0, 20_000)), sp) for sp in many], many, "70 inputs")
    # the main path's shape
    rows = 10_000_000
    check([zipf_ids(rng, rows, 1_078_737), zipf_ids(rng, rows, 9), zipf_ids(rng, rows, 5001)],
          [1_078_737, 9, 5001], "the main path's shape, 10^7 Zipf ids each")
    # the partition route's two launches: narrow ids past their own keyspace
    # (added into out by launch 1) landing in a wide input's bins (added by
    # launch 2), every wide id in one bucket (one cluster takes all rows),
    # no narrow input, no wide one (no launch 2), the summed keyspace on
    # both sides of sms << 13 (where launch 2's bucket width steps), and 70
    # wide and narrow inputs in two launches
    check([rng.integers(-1, 200_000, size=1_000_000), ids(1_000_000, 150_000)],
          [9, 150_000], "narrow ids past their keyspace into a wide input's bins")
    check([(12_152 * 64) + rng.integers(0, 64, size=4_000_000), ids(100_000, 9)],
          [1_000_000, 9], "every wide id in one bucket")
    check([ids(3_000_000, 2_000_000)], [2_000_000], "a wide input only")
    check([ids(1_000_000, 15_000) for _ in range(5)], [15_000] * 5,
          "narrow inputs only, past the shared width")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for total in ((sms << 13) - 1, (sms << 13) + 1):
        check([zipf_ids(rng, 2_000_000, total - 5_010), ids(1_000_000, 9),
               ids(1_000_000, 5_001)], [total - 5_010, 9, 5_001],
              f"{total} bins, sms << 13 {total - (sms << 13):+d}")
    mixed = [int(rng.integers(16_385, 40_000)) if j % 2 else int(rng.integers(1, 3_000))
             for j in range(70)]
    check([ids(int(rng.integers(0, 50_000)), sp) for sp in mixed], mixed,
          "70 wide and narrow inputs")
    # past the partition regime's width: refused, no launch
    before = histogram_device.FUSED_LAUNCHES
    wide = boundaries["partition"] + 1
    try:
        fused_bincount([torch.zeros(4, dtype=torch.int64, device=device)] * 2,
                       [wide - 1, 1])
    except ValueError:
        refused = True
    else:
        refused = False
    if not refused or histogram_device.FUSED_LAUNCHES != before:
        fail(f"K7 took {wide} bins, past the partition regime's width")
    return {"cases": cases, "by_regime": seen, "max_abs_err": 0,
            "refused_past_partition": wide}


# -- phase 3: K6, the histogram tier's one-hot variant -------------------------

#: the widths K6 is held at against its plain versions: each side of the
#: narrow route's radix steps and its edge (2,048), of a wide tile's edge
#: (4,096), of the wide route's radix step (2^21), region's width, a select
#: pass's and the sweep's
ONEHOT_WIDTHS = (1, 8, 9, 127, 128, 129, 2047, 2048, 2049, 4095, 4096, 4097, 5001,
                 1 << 16, 1 << 17, 1 << 21, (1 << 21) + 1)
#: the weighted edges: the narrow route's (512) and the wide route's
#: second tile (1,024) each side, and the widest
ONEHOT_WEIGHTED_WIDTHS = (9, 511, 512, 513, 1023, 1024, 1025, 5001, 1 << 16, 1 << 17, 1 << 20)


def onehot_parity(device, rng) -> dict:
    """K6 (``csrc/onehot.cu``, ``bincount_onehot``) against both its plain
    versions (``bincount_onehot_plain``, the reference's formulation, and
    ``bincount_plain``), bit for bit, one launch counted a call: int32 and
    int64 ids at every width of :data:`ONEHOT_WIDTHS` (both routes and
    their edges) over 0 to 3 rows, both sides of a step of 32 rows, a group
    of 64, a partition chunk, and 300,000 rows; ids off a 16-byte boundary
    on both routes; negative ids, ids >= m, int64 ids past 2^31, all rows
    dropped; 10^7 Zipf ids and 10^7 ids in one bin (at 2^17 bins a hot tile
    spread over every multiplying block), and 2^22 bins; weights at every
    width of :data:`ONEHOT_WEIGHTED_WIDTHS`: negative, INT32_MAX (totals
    past int32), per-block partials past int32, 255 in every byte (-1) with
    10^7 rows in one bin; the multi-input entry
    (``fused_bincount(..., "onehot")``) against ``fused_bincount_plain``
    with sets on both routes, more than 32 inputs on both, and ids past
    their own keyspace; and the refusals past its widths."""
    import numpy as np
    import torch

    from deequ_tpu_torch.ops import histogram_device
    from deequ_tpu_torch.ops.histogram_device import (
        bincount_onehot,
        bincount_onehot_plain,
        bincount_plain,
        fused_bincount,
        fused_bincount_plain,
        onehot_plan,
        onehot_widest,
    )

    saved = histogram_device.ONEHOT_LAUNCHES
    cases = 0
    routes = {}

    def check_tensor(seg, m, w=None, label=""):
        nonlocal cases
        before = histogram_device.ONEHOT_LAUNCHES
        got = bincount_onehot(seg, m, weights=w)
        launched = histogram_device.ONEHOT_LAUNCHES - before
        for plain in (bincount_onehot_plain, bincount_plain):
            want = plain(seg, m, weights=w)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                err = int((got - want).abs().max())
                fail(f"K6 != {plain.__name__} ({label} n={seg.numel()}, m={m}, "
                     f"weighted={w is not None}, {seg.dtype}): max err {err}")
        if launched != (1 if seg.numel() else 0):
            fail(f"K6 {label}: {launched} launches for {seg.numel()} rows")
        routes[f"{m}{' weighted' if w is not None else ''}"] = (
            "wide" if onehot_plan(m, max(seg.numel(), 1), w is not None)["wide"] else "narrow")
        cases += 1

    def check(seg_np, m, weights_np=None, dtype=torch.int64, label=""):
        seg = torch.from_numpy(np.asarray(seg_np)).to(device=device, dtype=dtype)
        w = None if weights_np is None else torch.from_numpy(weights_np).to(device)
        check_tensor(seg, m, w, label)

    chunk = onehot_plan(1 << 17, 1_000_000)["chunk_rows"]
    for dtype in (torch.int32, torch.int64):
        for m in ONEHOT_WIDTHS:
            for n in sorted({0, 1, 2, 3, 31, 32, 33, 63, 64, 65, 257, chunk - 1, chunk,
                             chunk + 1, 300_000}):
                check(rng.integers(-3, m + 3, size=n), m, dtype=dtype, label="rows")
        # off a 16-byte boundary: the narrow route's head and tail rows
        for m in (9, 2048, 4097, 1 << 17):
            base = torch.from_numpy(rng.integers(-1, m + 1, size=100_003)).to(device, dtype)
            for k in (1, 2, 3):
                check_tensor(base[k:], m, label=f"offset {k}")
                check_tensor(base[k:k + 5], m, label=f"offset {k}, 5 rows")
    for m in (9, 2049, 5001, 1 << 17, 1 << 22):
        plan = onehot_plan(m, 200_000)
        span = plan["tiles"] * plan["tile_bins"]
        seg = np.concatenate([
            rng.integers(-5, m + 5, size=200_000), rng.integers(m, span + 100, size=2_000),
            np.array([span - 1, span, span + 1, 2**31 - 1, 2**31, 2**31 + m // 2,
                      2**32 + 3, 2**40, 2**62, -(2**31), -(2**40)], dtype=np.int64)])
        seg = rng.permutation(seg)
        check(seg, m, label="out of range")
        check(seg[(seg >= -(2**31)) & (seg < 2**31)], m, dtype=torch.int32,
              label="out of range")
        check(np.full(100_000, -1), m, label="all dropped")
        check(np.full(100_000, m), m, label="all dropped")
        check(np.full(100_000, 2**31 + 1), m, label="all dropped")
    rows = 10_000_000
    t0 = time.perf_counter()
    for m in (9, 5001, 1 << 16, 1 << 17):
        for seg in (zipf_ids(rng, rows, m), np.full(rows, m // 2, dtype=np.int64)):
            for dtype in (torch.int32, torch.int64):
                check(seg, m, dtype=dtype, label="10^7 rows")
    check(zipf_ids(rng, 1_000_000, 1 << 22), 1 << 22, label="the widest")
    check(rng.integers(-1, (1 << 22) + 1, size=1_000_000), 1 << 22, label="the widest")
    ten_million_s = time.perf_counter() - t0
    # weights: negative and any int32; INT32_MAX (totals past int32); per-
    # block partials past int32 whose totals stay inside (the second half
    # repeats the first half's ids with negated weights)
    for m in ONEHOT_WEIGHTED_WIDTHS:
        half = rng.integers(0, min(m, 8), size=2_000_000)
        seg = np.concatenate([half, half, rng.integers(0, m, size=1000)])
        big = np.int32(2**30 + 12345)
        inside = np.concatenate([np.full(len(half), big, np.int32),
                                 np.full(len(half), -big, np.int32),
                                 rng.integers(-100, 100, size=1000).astype(np.int32)])
        anyw = rng.integers(-(2**31), 2**31, size=len(seg), dtype=np.int64).astype(np.int32)
        for weights in (inside, anyw, np.full(len(seg), np.iinfo(np.int32).max, np.int32)):
            check(seg, m, weights, label="weighted")
        wide = zipf_ids(rng, 3_000_000, m)
        check(wide, m, rng.integers(-(2**31), 2**31, size=len(wide)).astype(np.int32),
              label="weighted Zipf")
        if m in (9, 512, 513, 1 << 20):  # 255 in every byte, every row in one bin
            check(np.full(rows, m - 1, dtype=np.int64), m, np.full(rows, -1, np.int32),
                  label="weights of -1, one bin")

    # the multi-input entry
    multi = 0

    def check_multi(keys_np, spaces, label):
        nonlocal multi
        keys = [torch.from_numpy(np.asarray(k, dtype=np.int64)).to(device) for k in keys_np]
        before = histogram_device.ONEHOT_LAUNCHES
        got = fused_bincount(keys, spaces, "onehot")
        want = fused_bincount_plain(keys, spaces)
        torch.cuda.synchronize()
        if histogram_device.ONEHOT_LAUNCHES != before + 1:
            fail(f"K6 multi {label}: {histogram_device.ONEHOT_LAUNCHES - before} launches")
        if not torch.equal(got, want):
            err = int((got - want).abs().max())
            fail(f"K6 multi != fused_bincount_plain ({label}: rows "
                 f"{[len(k) for k in keys_np]}, keyspaces {list(spaces)}): max err {err}")
        routes[f"multi {sum(spaces)}"] = "wide" if onehot_plan(
            sum(spaces), max(sum(len(k) for k in keys_np), 1))["wide"] else "narrow"
        multi += 1

    def ids(n, space):
        return rng.integers(-1, space + 2, size=n)

    for k in (1, 2, 3, 4):
        spaces = [int(x) for x in rng.integers(1, 40_000, k)]
        check_multi([ids(int(rng.integers(1, 300_000)), sp) for sp in spaces], spaces,
                    f"K={k}")
        narrow = [int(x) for x in rng.integers(1, 2048 // k, k)]
        check_multi([ids(int(rng.integers(1, 300_000)), sp) for sp in narrow], narrow,
                    f"K={k}, the narrow route")
    check_multi([ids(1, 9), ids(2_000_000, 100_001), np.zeros(0, np.int64), ids(1, 1)],
                [9, 100_001, 7, 1], "one-row and empty inputs")
    check_multi([np.full(300_000, -1), ids(300_000, 70_000), np.full(5, -3)], [12, 70_000, 5],
                "wholly dropped inputs")
    check_multi([rng.integers(-1, 200_000, size=1_000_000), ids(1_000_000, 150_000)],
                [9, 150_000], "ids past their keyspace into a later input's bins")
    check_multi([rng.integers(-1, 2_000, size=1_000_000), ids(1_000_000, 40)],
                [9, 40], "ids past their keyspace, the narrow route")
    many = [int(x) for x in rng.integers(1, 3_000, 40)]
    check_multi([ids(int(rng.integers(0, 20_000)), sp) for sp in many], many,
                "40 inputs (two rounds of the entry's 32)")
    few = [int(x) for x in rng.integers(1, 50, 40)]
    check_multi([ids(int(rng.integers(0, 20_000)), sp) for sp in few], few,
                "40 inputs, the narrow route")
    check_multi([zipf_ids(rng, rows, 1_078_737), zipf_ids(rng, rows, 9),
                 zipf_ids(rng, rows, 5001)], [1_078_737, 9, 5001],
                "the main path's fused group, 10^7 Zipf ids each")

    # refusals: no launch past the widths
    refused = {}
    for label, call in (
            ("unweighted", lambda: bincount_onehot(
                torch.zeros(4, dtype=torch.int64, device=device), onehot_widest() + 1)),
            ("weighted", lambda: bincount_onehot(
                torch.zeros(4, dtype=torch.int64, device=device), onehot_widest(True) + 1,
                weights=torch.ones(4, dtype=torch.int32, device=device))),
            ("multi", lambda: fused_bincount(
                [torch.zeros(4, dtype=torch.int64, device=device)] * 2,
                [onehot_widest(), 1], "onehot"))):
        before = histogram_device.ONEHOT_LAUNCHES
        try:
            call()
        except ValueError:
            refused[label] = True
        if not refused.get(label) or histogram_device.ONEHOT_LAUNCHES != before:
            fail(f"K6 took a width past its widest ({label})")
    histogram_device.ONEHOT_LAUNCHES = saved  # parity launches are not a path's
    narrow_edge = {w: onehot_plan(1, 1, w)["narrow_widest"] for w in (False, True)}
    return {"cases": cases, "multi_cases": multi, "max_abs_err": 0,
            "widths": list(ONEHOT_WIDTHS), "weighted_widths": list(ONEHOT_WEIGHTED_WIDTHS),
            "narrow_widest": {"unweighted": narrow_edge[False], "weighted": narrow_edge[True]},
            "routes": routes,
            "widest": {"unweighted": onehot_widest(), "weighted": onehot_widest(True)},
            "refused": refused, "ten_million_rows_s": ten_million_s}


# -- phase 3b: K1, the fused scan's masked reductions ------------------------

#: f64 operations a task does a valid row (a sum, a compare, the
#: deviations and their squares and products)
K1_OPS = {"count": 0, "sum": 1, "min": 1, "max": 1, "moments": 4, "comoments": 10}
#: the card's f64 rate outside the tensor cores (H100 SXM data sheet)
F64_RATE = 34e12
#: the two-pass centred sums' rounding floor: the kernel's mean and the
#: plain version's come from sums of ~100 dependent adds (64 a thread, the
#: block's and the tiles' trees) in two orders, so they may round up to
#: 128 ulps of the largest |x| apart (10 were seen on a constant column of
#: 10^6 rows, whose plain m2 is 0); the centred sums then differ by
#: n times that offset squared
K1_MEAN_ULPS = 128 * 2.0 ** -52


def k1_zero() -> None:
    from deequ_tpu_torch.ops import masked_reduce

    masked_reduce.LAUNCHES = masked_reduce.MERGE_LAUNCHES = 0
    masked_reduce.MERGE_LAUNCHES_BY_CALLER.clear()


def k1_counts() -> dict:
    from deequ_tpu_torch.ops import masked_reduce

    return {"k1": masked_reduce.LAUNCHES, "k1_merge": masked_reduce.MERGE_LAUNCHES}


def k1_require(launches: dict, label: str) -> None:
    """Fails unless K1 and its fold merge launched in the path's run."""
    if launches["k1"] < 1 or launches["k1_merge"] < 1:
        fail(f"{label}: K1 launched {launches['k1']} times and its merge "
             f"{launches['k1_merge']} (want both >= 1)")


class K1Spy:
    """Records every batch ``masked_reduce.reduce_into`` is called with
    (``batches``: (flat, tasks, offsets)) and every fold merge
    (``merges``: ``merge_tags``' arguments), launching as usual."""

    def __enter__(self):
        from deequ_tpu_torch.ops import masked_reduce

        self._mod = masked_reduce
        self._orig = masked_reduce.reduce_into
        self._orig_merge = masked_reduce.merge_tags
        self.batches = []
        self.merges = []

        def spy(flat, tasks, offsets):
            self.batches.append((flat, list(tasks), [tuple(o) for o in offsets]))
            return self._orig(flat, tasks, offsets)

        def spy_merge(*args, **kwargs):
            self.merges.append(args)
            return self._orig_merge(*args, **kwargs)

        masked_reduce.reduce_into = spy
        masked_reduce.merge_tags = spy_merge
        return self

    def __exit__(self, *exc):
        self._mod.reduce_into = self._orig
        self._mod.merge_tags = self._orig_merge


def k1_offsets(tasks):
    offsets, off = [], 0
    for t in tasks:
        offsets.append(tuple(range(off, off + t.n_outputs)))
        off += t.n_outputs
    return offsets, off


def k1_hold(tasks, label: str) -> dict:
    """K1 over ``tasks`` against their plain versions on the same card
    tensors: counts, min and max exact (NaN equal to NaN); sums and means
    within 1e-13 · Σ|x|; m2, x_mk and y_mk within 1e-12 relative and ck
    within 1e-12 · sqrt(x_mk · y_mk), each plus the centred sums' floor
    n · (128 ulp · max|x|)^2 (:data:`K1_MEAN_ULPS`: the kernel's means and
    the plain version's round apart). Fails on any other result; returns the worst errors."""
    import torch

    from deequ_tpu_torch.ops import masked_reduce

    offsets, size = k1_offsets(tasks)
    flat = torch.full((size,), float("nan"), dtype=torch.float64, device=tasks[0].device)
    masked_reduce.reduce_into(flat, tasks, offsets)
    torch.cuda.synchronize()
    got = flat.cpu().tolist()
    worst = {"sum": 0.0, "centred": 0.0, "ck": 0.0}  # the largest err / bound
    max_abs = 0.0

    def same(a, b):
        return a == b or (a != a and b != b)

    for t, offs in zip(tasks, offsets):
        want = [float(v) for v in t.plain()]
        have = [got[o] for o in offs]
        names = masked_reduce.OUTPUTS[t.kind]
        ok = None
        for m in t.masks:
            ok = m if ok is None else ok & m
        if ok is None:
            ok = torch.ones(t.n, dtype=torch.bool, device=t.device)
        stats = []
        for x in t.data:
            x = x.to(torch.float64)
            fin = ok & torch.isfinite(x)
            stats.append((float(torch.where(ok, x.abs(), 0.0).sum()),
                          float(torch.where(fin, x.abs(), 0.0).amax()) if t.n else 0.0))
        n = max(float(ok.sum()), 1.0)
        for name, h, w in zip(names, have, want):
            if name in ("n", "value") or not (math.isfinite(h) and math.isfinite(w)):
                if not same(h, w):
                    fail(f"k1_parity {label}: {t.kind} {name} kernel {h!r} plain {w!r}")
                continue
            err = abs(h - w)
            max_abs = max(max_abs, err)
            if name in ("sum", "mean", "x_avg", "y_avg"):
                sx = stats[1 if name == "y_avg" else 0][0]
                bound, kind = 1e-13 * sx / (1.0 if name == "sum" else n), "sum"
            else:
                mx = [s[1] for s in stats]
                ulps = K1_MEAN_ULPS * max(mx)
                floor = n * ulps * ulps
                if name == "ck":
                    bound, kind = 1e-12 * math.sqrt(abs(want[4] * want[5])) + floor, "ck"
                else:
                    bound, kind = 1e-12 * abs(w) + floor, "centred"
            if err:
                worst[kind] = max(worst[kind], err / bound if bound else math.inf)
            if err > bound:
                fail(f"k1_parity {label}: {t.kind} {name} kernel {h!r} plain {w!r}, "
                     f"err {err:.3g} > {bound:.3g}")
    return {"tasks": len(tasks), "worst_share_of_bound": worst, "max_abs_err": max_abs}


def k1_tasks_over(x, y, masks, lengths=None):
    """Every kind over one column (and a second for the co-moments), under
    each prefix of ``masks``; with ``lengths`` (int32), their min, max and
    moments and their co-moments with ``x``."""
    from deequ_tpu_torch.ops import masked_reduce as k1

    tasks = []
    for j in range(len(masks) + 1):
        ms = masks[:j]
        tasks += [k1.count(*ms, n=x.numel(), device=x.device), k1.total(x, *ms),
                  k1.extremum(x, "min", *ms), k1.extremum(x, "max", *ms),
                  k1.moments(x, *ms), k1.comoments(x, y, *ms)]
        if lengths is not None:
            tasks += [k1.extremum(lengths, "min", *ms), k1.extremum(lengths, "max", *ms),
                      k1.moments(lengths, *ms), k1.comoments(lengths, x, *ms)]
    return tasks


def k1_bits(tasks, offsets=None):
    """K1 over ``tasks`` (one batch) as int64 bits, one row a task's outputs."""
    import torch

    from deequ_tpu_torch.ops import masked_reduce as k1

    if offsets is None:
        offsets, size = k1_offsets(tasks)
    else:
        size = 1 + max(o for offs in offsets for o in offs)
    flat = torch.full((size,), float("nan"), dtype=torch.float64, device=tasks[0].device)
    k1.reduce_into(flat, tasks, offsets)
    bits = flat.view(torch.int64).cpu().tolist()
    return [[bits[o] for o in offs] for offs in offsets]


def k1_parity(device) -> dict:
    """K1 against its plain version on the card (:func:`k1_hold`): ±inf,
    NaN, -0.0 and subnormals; all-masked tasks, one row, a constant
    column, a column of mean 1e8 and spread 1e-3; sizes on both sides of a
    warp's, a block's and a tile's rows (the kernel's own geometry); one,
    two and three masks and int32 lengths; a task of no rows among others;
    a source past its caps of masks and combos; identical tasks; 10^7
    rows. The bits of a result depend on the task's rows alone: the same
    column at another alignment, a column and a mask an odd number of
    elements off a 16-byte boundary, the batch reversed, and each task
    alone in a batch give the same bits. The fold merge bit for bit
    against its plain version. (The main check's resident chunk, every
    task, is held in ``resident_path``.)"""
    import numpy as np
    import torch

    from deequ_tpu_torch.ops import masked_reduce as k1

    rng = np.random.default_rng(11)
    cases = {}
    geometry = k1.geometry()
    tile, threads = geometry["tile_rows"], geometry["threads"]

    def column(n, kind="normal"):
        if kind == "edges":
            x = rng.normal(0.0, 1.0, n)
            special = np.array([np.inf, -np.inf, np.nan, -0.0, 0.0, 5e-324, -1e-310,
                                2.2e-308, np.nan, 1e10])
            idx = rng.choice(n, size=min(n, 4 * len(special)), replace=False)
            x[idx] = np.resize(special, idx.size)
            return torch.from_numpy(x).to(device)
        if kind == "constant":
            return torch.full((n,), 3.7, dtype=torch.float64, device=device)
        if kind == "ill":
            return torch.from_numpy(1e8 + 1e-3 * rng.standard_normal(n)).to(device)
        return torch.from_numpy(rng.normal(10.0, 3.0, n)).to(device)

    def masks(n, k=3, p=0.1):
        return [torch.from_numpy(rng.random(n) >= p).to(device) for _ in range(k)]

    def lengths(n):
        return torch.from_numpy(rng.integers(0, 200, n).astype(np.int32)).to(device)

    n = 100_003
    cases["edges"] = k1_hold(
        k1_tasks_over(column(n, "edges"), column(n), masks(n), lengths(n)), "edges")
    # NaN that a mask drops must not count; a column of NaN gives NaN
    nan = torch.full((1000,), float("nan"), dtype=torch.float64, device=device)
    some = torch.from_numpy(rng.random(1000) < 0.5).to(device)
    cases["nan"] = k1_hold(k1_tasks_over(nan, column(1000), [some]) +
                           k1_tasks_over(torch.where(some, nan, 1.0), column(1000),
                                         [~some]), "nan")
    cases["all_masked"] = k1_hold(
        k1_tasks_over(column(5000), column(5000),
                      [torch.zeros(5000, dtype=torch.bool, device=device)]), "all_masked")
    cases["one_row"] = k1_hold(
        k1_tasks_over(column(1), column(1), masks(1, p=0.0), lengths(1)), "one_row")
    cases["constant"] = k1_hold(
        k1_tasks_over(column(1_000_000, "constant"), column(1_000_000), masks(1_000_000)),
        "constant")
    m = 1_000_003
    ill_x = column(m, "ill")
    ill_y = 0.5 * (ill_x - 1e8) - 3e7 + torch.from_numpy(1e-3 * rng.standard_normal(m)).to(device)
    cases["ill_conditioned"] = k1_hold(k1_tasks_over(ill_x, ill_y, masks(m)), "ill-conditioned")
    # a task of no rows, in a batch with others
    empty = torch.zeros(0, dtype=torch.float64, device=device)
    none = torch.zeros(0, dtype=torch.bool, device=device)
    cases["no_rows"] = k1_hold(k1_tasks_over(empty, empty, [none]) +
                               k1_tasks_over(column(3000), column(3000), masks(3000)),
                               "no rows among others")
    edges, edge_err = [], 0.0
    for m in (31, 32, 33, threads - 1, threads, threads + 1, tile - 1, tile, tile + 1,
              2 * tile - 1, 2 * tile, 2 * tile + 1, 7 * tile + threads + 5):
        held = k1_hold(k1_tasks_over(column(m, "edges"), column(m), masks(m), lengths(m)),
                       f"rows {m}")
        edges.append(m)
        edge_err = max(edge_err, held["max_abs_err"])
    cases["tile_edges"] = {"rows": edges, "tile_rows": tile, "threads": threads,
                           "max_abs_err": edge_err}

    # a source past its caps splits; identical tasks are one combo
    m = 50_001
    x, y, many = column(m, "edges"), column(m), masks(m, k=geometry["source_masks"] + 3)
    past_masks = [k1.total(x, mk) for mk in many] + [k1.moments(x, mk) for mk in many]
    pairs = [(i, j) for i in range(geometry["source_masks"])
             for j in range(i + 1, geometry["source_masks"])]
    past_combos = [k1.extremum(x, "max", many[i], many[j]) for i, j in pairs] + \
        [k1.count(many[i], many[j], n=m, device=device) for i, j in pairs] + \
        [k1.moments(y, many[i], many[j]) for i, j in pairs]
    once = k1_tasks_over(x, y, many[:2])
    twice = once + k1_tasks_over(x, y, many[:2])
    split = {}
    for label, tasks in (("masks", past_masks), ("combos", past_combos), ("identical", twice)):
        batch = k1.group(tasks, k1_offsets(tasks)[0])
        split[label] = {"tasks": len(tasks), "sources": len(batch.sources),
                        "combos": len(batch.combos),
                        "held": k1_hold(tasks, f"past the caps: {label}")["max_abs_err"]}
    if split["masks"]["sources"] < 2 or split["combos"]["sources"] < 2:
        fail(f"k1_parity: a source past its caps did not split: {split}")
    half = len(twice) // 2
    bits = k1_bits(twice)
    if bits[:half] != bits[half:] or \
            split["identical"]["combos"] != len(k1.group(once, k1_offsets(once)[0]).combos):
        fail("k1_parity: identical tasks were not one combo with the same bits at each offset")
    cases["caps_and_identical"] = split
    max_abs = max(c["max_abs_err"] for c in cases.values() if "max_abs_err" in c)

    big = 10_000_000
    x, y, ms, ln = column(big), column(big), masks(big, p=0.01), lengths(big)
    cases["rows_1e7"] = k1_hold(k1_tasks_over(x, y, ms, ln), "1e7 rows")
    max_abs = max(max_abs, cases["rows_1e7"]["max_abs_err"])

    # bits depend on a task's rows alone: another alignment, another order,
    # the task alone in its batch
    tasks = k1_tasks_over(x, y, ms[:2], ln)
    first = k1_bits(tasks)
    shifted = torch.empty(big + 3, dtype=torch.float64, device=device)[3:]
    shifted.copy_(x)
    moved = [k1.Reduction(t.kind, [shifted if d is x else d for d in t.data], t.masks,
                          t.n, t.device) for t in tasks]
    offsets, _ = k1_offsets(tasks)
    again = k1_bits(moved[::-1], offsets[::-1])[::-1]
    if first != again:
        fail("k1_parity: the bits moved with the data's alignment or the batch's order")
    # a column, a mask and int32 lengths an odd number of elements off a
    # 16-byte boundary (8, 3 and 4 bytes)
    odd_x = torch.empty(big + 1, dtype=torch.float64, device=device)[1:]
    odd_x.copy_(x)
    odd_m = torch.empty(big + 3, dtype=torch.bool, device=device)[3:]
    odd_m.copy_(ms[0])
    odd_l = torch.empty(big + 1, dtype=torch.int32, device=device)[1:]
    odd_l.copy_(ln)
    swap = {id(x): odd_x, id(ms[0]): odd_m, id(ln): odd_l}
    odd = [k1.Reduction(t.kind, [swap.get(id(d), d) for d in t.data],
                        [swap.get(id(mk), mk) for mk in t.masks], t.n, t.device) for t in tasks]
    if k1_bits(odd) != first:
        fail("k1_parity: the bits moved with a column and a mask off a 16-byte boundary")
    alone = [k1_bits([t])[0] for t in tasks]
    if alone != first:
        fail("k1_parity: a task alone in its batch and the same task sharing its source "
             "gave other bits")
    cases["bits_alignment_order_alone"] = {
        "tasks": len(tasks), "sources_in_batch": len(k1.group(tasks, offsets).sources)}

    # the fold merge, bit for bit (NaN payloads, signed zeros, infinities)
    m = 100_000
    special = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 5e-324, 1.0, -1.0])
    pick = rng.random(m) < 0.5
    acc = torch.from_numpy(np.where(pick, rng.choice(special, m), rng.normal(size=m))).to(device)
    flat = torch.from_numpy(np.where(rng.random(m + 7) < 0.5, rng.choice(special, m + 7),
                                     rng.normal(size=m + 7))).to(device)
    tag = rng.integers(0, 3, m)
    is_sum = torch.from_numpy(tag == 0).to(device)
    is_min = torch.from_numpy(tag == 1).to(device)
    src = torch.from_numpy(rng.permutation(m + 7)[:m]).to(device)
    got = k1.merge_tags(is_sum, is_min, acc, flat, src)
    want = k1.merge_tags_plain(is_sum, is_min, acc, flat, src)
    if not torch.equal(got.view(torch.int64), want.view(torch.int64)):
        fail("k1_parity: the fold merge differs from its plain version in its bits")
    cases["merge_bits"] = m
    return {"cases": cases, "max_abs_err": max_abs}


# -- phase 4: the main path ---------------------------------------------------


def make_table(rows: int, seed: int):
    """The chip-smoke schema at ``rows`` rows, from ``seed``, built from
    numpy arrays (string columns from codes plus a dictionary)."""
    import numpy as np

    from deequ_tpu_torch.data.table import Column, ColumnarTable, DType

    rng = np.random.default_rng(seed)
    cols = []
    for j in range(20):
        if j == 19:
            # a column with a large mean and unit spread: a raw
            # sum-of-squares variance would lose it
            values = 1e6 + rng.standard_normal(rows)
        elif j == 1:
            values = 0.5 * cols[0].values + rng.normal(loc=3.0, scale=2.0, size=rows)
        else:
            values = rng.normal(loc=10.0 * j + 5.0, scale=1.0 + j, size=rows)
        mask = rng.random(rows) >= 0.01
        cols.append(Column(f"f{j}", DType.FRACTIONAL, values=values, mask=mask))
    cols.append(Column("id", DType.INTEGRAL, values=rng.permutation(rows).astype(np.int64)))
    n_cust = 1_100_000
    p = np.arange(1, n_cust + 1, dtype=np.float64) ** -0.7
    ranks = rng.choice(n_cust, size=rows, p=p / p.sum())
    cust = 1000 + 3 * rng.permutation(n_cust)[ranks].astype(np.int64)
    cols.append(Column("customer_id", DType.INTEGRAL, values=cust,
                       mask=rng.random(rows) >= 0.01))
    status_p = np.array([30, 20, 15, 12, 10, 7, 4, 2], dtype=np.float64)
    status = rng.choice(8, size=rows, p=status_p / status_p.sum()).astype(np.int32)
    cols.append(Column("status", DType.STRING, codes=status,
                       dictionary=np.array([f"S{i}" for i in range(8)], dtype=object)))
    region = rng.integers(0, 5000, size=rows).astype(np.int32)
    region[rng.random(rows) < 0.005] = -1
    cols.append(Column("region", DType.STRING, codes=region,
                       dictionary=np.array([f"R{i:04d}" for i in range(5000)], dtype=object)))
    return ColumnarTable(cols)


def build_scan_check():
    """The scan-shareable constraints of :func:`build_check`, in its order:
    every analyzer they need rides the fused scan."""
    from deequ_tpu_torch import Check, CheckLevel

    check = Check(CheckLevel.ERROR, "chip smoke").has_size(lambda n: n > 0)
    check = check.is_complete("id").has_completeness("f0", lambda v: v > 0.9)
    for j in range(20):
        c = f"f{j}"
        check = (check.has_min(c, lambda v: True).has_max(c, lambda v: True)
                 .has_mean(c, lambda v: True).has_sum(c, lambda v: True)
                 .has_standard_deviation(c, lambda v: v > 0))
    return (
        check.has_correlation("f0", "f1", lambda v: -1.0 <= v <= 1.0)
        .is_non_negative("f5", lambda v: v > 0)
        .is_contained_in("status", [f"S{i}" for i in range(7)], lambda v: v > 0.9)
        .satisfies("f3 > -20", "f3 above -20", lambda v: v > 0.5)
        .where("status = 'S1'")
    )


#: the metrics of build_check()'s grouping constraints (the rest are
#: build_scan_check()'s)
GROUPING_METRICS = {("Uniqueness", "id"), ("Uniqueness", "customer_id"),
                    ("UniqueValueRatio", "customer_id"), ("Distinctness", "status"),
                    ("Entropy", "region")}


def build_check():
    return (
        build_scan_check()
        .is_unique("id")
        .has_uniqueness(["customer_id"], lambda v: 0 < v < 1)
        .has_distinctness(["status"], lambda v: v > 0)
        .has_entropy("region", lambda v: v > 0)
        .has_unique_value_ratio(["customer_id"], lambda v: 0 < v < 1)
    )


def build_suite(table):
    from deequ_tpu_torch import VerificationSuite
    from deequ_tpu_torch.analyzers import CountDistinct

    return (
        VerificationSuite.on_data(table)
        .add_check(build_check())
        .add_required_analyzer(CountDistinct(["customer_id"]))
    )


def expected_metrics(table) -> dict:
    """Every metric of the suite, computed with numpy: {(name, instance): value}."""
    import numpy as np

    n = table.num_rows
    exp = {("Size", "*"): float(n)}
    exp[("Completeness", "id")] = float(table["id"].mask.sum()) / n
    exp[("Completeness", "f0")] = float(table["f0"].mask.sum()) / n
    for j in range(20):
        c = f"f{j}"
        v = table[c].values[table[c].mask]
        exp[("Minimum", c)] = float(v.min())
        exp[("Maximum", c)] = float(v.max())
        exp[("Sum", c)] = float(v.sum())
        exp[("Mean", c)] = float(v.mean())
        exp[("StandardDeviation", c)] = float(v.std())
    both = table["f0"].mask & table["f1"].mask
    x, y = table["f0"].values[both], table["f1"].values[both]
    dx, dy = x - x.mean(), y - y.mean()
    exp[("Correlation", "f0,f1")] = float(
        (dx * dy).sum() / (math.sqrt((dx * dx).sum()) * math.sqrt((dy * dy).sum()))
    )
    f5 = table["f5"]
    exp[("Compliance", "f5 is non-negative")] = float(
        (np.where(f5.mask, f5.values, 0.0) >= 0).sum()
    ) / n
    st = table["status"].codes
    exp[("Compliance", "status contained in " + ",".join(f"S{i}" for i in range(7)))] = (
        float(((st < 0) | (st < 7)).sum()) / n
    )
    where = st == 1
    f3 = table["f3"]
    exp[("Compliance", "f3 above -20")] = float(
        (where & f3.mask & (f3.values > -20)).sum()
    ) / float(where.sum())

    def count_stats(codes_or_values, valid):
        _, counts = np.unique(codes_or_values[valid], return_counts=True)
        rows = int(valid.sum())
        p = counts / rows
        return rows, len(counts), int((counts == 1).sum()), float(-(p * np.log(p)).sum())

    rows, groups, singles, _ = count_stats(table["id"].values, table["id"].mask)
    exp[("Uniqueness", "id")] = singles / rows
    cu = table["customer_id"]
    rows, groups, singles, _ = count_stats(cu.values, cu.mask)
    exp[("Uniqueness", "customer_id")] = singles / rows
    exp[("UniqueValueRatio", "customer_id")] = singles / groups
    exp[("CountDistinct", "customer_id")] = float(groups)
    rows, groups, _, _ = count_stats(st, st >= 0)
    exp[("Distinctness", "status")] = groups / rows
    rg = table["region"].codes
    _, _, _, ent = count_stats(rg, rg >= 0)
    exp[("Entropy", "region")] = ent
    return exp


#: relative bounds per metric (tests/test_torch_*.py state the same)
_EXACT = {"Size", "Completeness", "Compliance", "Minimum", "Maximum",
          "Uniqueness", "UniqueValueRatio", "Distinctness", "CountDistinct"}
_REL = {"Sum": 1e-12, "Mean": 1e-12, "Entropy": 1e-12,
        "StandardDeviation": 1e-10, "Correlation": 1e-10}


def check_metrics(result, expected: dict) -> float:
    """Every metric of the run against numpy; returns the worst relative
    error seen on the toleranced metrics."""
    got = {}
    for metric in result.metrics.values():
        if not metric.value.is_success:
            fail(f"metric failed: {metric}")
        got[(metric.name, metric.instance)] = metric.value.get()
    if set(got) != set(expected):
        fail(f"metric sets differ: only run {set(got) - set(expected)}, "
             f"only numpy {set(expected) - set(got)}")
    worst = 0.0
    for key, want in expected.items():
        have = got[key]
        if not math.isfinite(have):
            fail(f"{key} is not finite: {have}")
        if key[0] in _EXACT:
            if have != want:
                fail(f"{key}: {have!r} != numpy {want!r}")
        else:
            rel = abs(have - want) / max(abs(want), 1e-300)
            worst = max(worst, rel)
            if rel > _REL[key[0]]:
                fail(f"{key}: {have!r} vs numpy {want!r}, rel {rel:.3g} > {_REL[key[0]]}")
    return worst


def watch_cpu_ops():
    """A dispatch mode that records every torch operation computing on a
    CPU tensor. Copies between host and card (and reading a scalar back)
    are transport, not computation, and are allowed."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    # schema names (no overload): an allocation computes nothing, so
    # "aten::empty" (K1's pinned staging of its source tables) is
    # transport too
    transport = {
        "aten::_to_copy", "aten::copy_", "aten::_local_scalar_dense",
        "aten::lift_fresh", "aten::lift_fresh_copy", "aten::detach",
        "aten::alias", "aten::empty", "aten::empty_strided",
    }

    class Watch(TorchDispatchMode):
        """``cpu_ops``: computations on CPU tensors by op name;
        ``h2d_copies``: host-to-device copies, and ``h2d_marked`` those
        made while ``marked`` is set."""

        def __init__(self):
            super().__init__()
            self.cpu_ops = {}
            self.h2d_copies = 0
            self.h2d_marked = 0
            self.marked = False

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func._schema.name
            if name in ("aten::_to_copy", "aten::copy_"):
                src = args[1] if name == "aten::copy_" else args[0]
                dst = args[0] if name == "aten::copy_" else out
                if src.device.type == "cpu" and dst.device.type == "cuda":
                    self.h2d_copies += 1
                    self.h2d_marked += self.marked
            if name not in transport:
                tensors = [
                    t for t in tree_flatten((args, kwargs or {}, out))[0]
                    if isinstance(t, torch.Tensor)
                ]
                if any(t.device.type == "cpu" and t.dim() > 0 for t in tensors):
                    self.cpu_ops[name] = self.cpu_ops.get(name, 0) + 1
            return out

    return Watch()


#: the main suite's dense grouping sets, which fuse into one K7 launch
#: (``id`` is sparse at 10^7 rows and takes its own pass)
FUSED_SETS = ("customer_id", "status", "region")


def hold_fused_main(k5: int, k7: int, stats: dict, label: str) -> None:
    """The main suite over its table in memory with fusion on: one K7
    launch for customer_id, status and region, no K5 launch, three fused
    passes among the four grouping passes, one kernel dispatch."""
    want = (0, 1, len(FUSED_SETS), 4, 1)
    got = (k5, k7, stats["fused_group_passes"], stats["grouping_passes"],
           stats["hist_kernel_dispatches"])
    if got != want:
        fail(f"{label}: K5 {k5}, K7 {k7}, fused passes {got[2]}, grouping passes "
             f"{got[3]}, kernel dispatches {got[4]}; want {want}")


def main_path(rows: int, seed: int, device) -> dict:
    import torch

    from deequ_tpu_torch.ops import histogram_device, hll
    from deequ_tpu_torch.ops.scan_engine import SCAN_STATS

    t0 = time.perf_counter()
    table = make_table(rows, seed)
    t_table = time.perf_counter() - t0
    t0 = time.perf_counter()
    expected = expected_metrics(table)
    t_numpy = time.perf_counter() - t0
    suite = build_suite(table)

    # the checked run: counts set to 0 just before, read just after
    torch.cuda.reset_peak_memory_stats(device)
    SCAN_STATS.reset()
    histogram_device.LAUNCHES = histogram_device.FUSED_LAUNCHES = 0
    histogram_device.ONEHOT_LAUNCHES = 0
    hll.LAUNCHES = 0
    k1_zero()
    watch = watch_cpu_ops()
    t0 = time.perf_counter()
    with watch:
        result = suite.run()
    t_first = time.perf_counter() - t0
    launches = histogram_device.LAUNCHES
    fused_launches = histogram_device.FUSED_LAUNCHES
    onehot_launches = histogram_device.ONEHOT_LAUNCHES
    k1_launches = k1_counts()
    k1_require(k1_launches, "main_path")
    if hll.LAUNCHES:
        fail(f"the main path has no sketch, yet the hll kernel launched {hll.LAUNCHES} times")
    stats = SCAN_STATS.snapshot()
    peak = torch.cuda.max_memory_allocated(device)

    if result.device != str(device):
        fail(f"run executed on {result.device}, expected {device}")
    if watch.cpu_ops:
        fail(f"torch operations computed on CPU tensors during run(): {watch.cpu_ops}")
    hold_fused_main(launches, fused_launches, stats, "main_path")
    if stats["scan_passes"] != 1 or stats["last_scan_fetches"] != 1:
        fail(f"fused scan: {stats['scan_passes']} passes, "
             f"{stats['last_scan_fetches']} fetches (want 1 and 1)")
    if stats["hist_plain_dispatches"] != 0 or stats["hist_host_dispatches"] != 0:
        fail("a dense grouping count ran off the kernel on the card path: "
             f"{stats['hist_plain_dispatches']} plain, "
             f"{stats['hist_host_dispatches']} host")
    worst = check_metrics(result, expected)

    walls = []
    for _ in range(4):  # one warm run, then three timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        suite.run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    phases = phase_times(table, device)
    return {
        "phase": "main_path",
        "rows": rows,
        "columns": len(table.column_names),
        "metrics_checked": len(expected),
        "worst_rel_err": worst,
        "kernel_launches": launches,
        "fused_launches": fused_launches,
        "onehot_launches": onehot_launches,
        "k1_launches": k1_launches,
        "scan_stats": stats,
        "first_run_s_watched": t_first,
        "warm_run_s": walls[0],
        "run_wall_s_median_of_3": statistics.median(walls[1:]),
        "run_wall_s": walls[1:],
        "phase_s": phases,
        "peak_device_bytes": peak,
        "table_build_s": t_table,
        "numpy_reference_s": t_numpy,
    }, table, result


def phase_times(table, device) -> dict:
    """Host-clock seconds of the run's pieces, each ending in a fetch."""
    from deequ_tpu_torch.analyzers.base import ScanShareableAnalyzer
    from deequ_tpu_torch.analyzers.runner import AnalysisRunner
    from deequ_tpu_torch.ops.segment import group_count_stats

    scanning = list(dict.fromkeys(
        a for a in build_check().required_analyzers()
        if isinstance(a, ScanShareableAnalyzer)
    ))
    out = {}
    t0 = time.perf_counter()
    AnalysisRunner._run_scanning_analyzers(table, scanning, device)
    out["fused_scan"] = time.perf_counter() - t0
    for cols in (["id"], ["customer_id"], ["status"], ["region"]):
        t0 = time.perf_counter()
        group_count_stats(table, cols, device)
        out[f"grouping_{cols[0]}"] = time.perf_counter() - t0
    return out


# -- phase 4b: fusion_path ----------------------------------------------------

#: timed runs a side in fusion_path's A/B (fused and unfused in turns,
#: the checked runs before them the warm ones)
FUSION_TIMED = 3


class plan_fusion:
    """Sets ``DEEQU_TORCH_PLAN_FUSION`` for the block, restoring it after."""

    def __init__(self, on: bool):
        self.value = "1" if on else "0"

    def __enter__(self):
        self.saved = os.environ.get("DEEQU_TORCH_PLAN_FUSION")
        os.environ["DEEQU_TORCH_PLAN_FUSION"] = self.value
        return self

    def __exit__(self, *exc):
        if self.saved is None:
            os.environ.pop("DEEQU_TORCH_PLAN_FUSION", None)
        else:
            os.environ["DEEQU_TORCH_PLAN_FUSION"] = self.saved


def fusion_checked_run(suite, want: dict, label: str, fused: bool) -> tuple:
    """One run of the main suite with fusion on or off, counts set to 0
    just before and read just after, watched for CPU ops, every K5 and K7
    launch held against its plain version; its metrics must be ``want``'s
    bits. Returns (launches, scan stats, the result)."""
    from deequ_tpu_torch.ops.scan_engine import SCAN_STATS

    kernel_counts_zero()
    watch = watch_cpu_ops()
    with plan_fusion(fused), watch, PlainCheck(label) as plain:
        result = suite.run()
    launches = kernel_counts()
    stats = SCAN_STATS.snapshot()
    if watch.cpu_ops:
        fail(f"{label}: torch operations computed on CPU tensors: {watch.cpu_ops}")
    if (sum(x["calls"] for x in plain.shapes), plain.fused_calls) != (
            launches["bincount"], launches["fused_bincount"]):
        fail(f"{label}: {plain.shapes} / {plain.fused_calls} launches held against plain, "
             f"the run made {launches}")
    differ = differing_bits(want, metric_values(result))
    if differ:
        fail(f"{label}: the metrics differ from main_path's in the bits of {differ}")
    return launches, stats, result


def k7_turns(keys, spaces, libs: dict, reps: int = 20, unheld=()) -> dict:
    """K7 alone at one shape from each build of ``bincount.cu`` in ``libs``
    ({name: loaded library}, bound as the package binds it) and the K5
    launches it replaces, one a set (the package's library), in turns: every build
    and then the K5 launches, then the same in reverse order. Each time is
    ``time_queued`` over ``reps`` launches into fresh buffers (as
    ``fused_bincount`` allocates them for that build); each build's count
    is held bit for bit against ``fused_bincount_plain`` and timed by
    torch.profiler, by kernel (a probe build named in ``unheld`` computes
    something else and is timed only). Returns {name: {"kernel_ms": [two turns],
    "profiler_ms": ...}} with "k5" beside the builds. Launch counts
    are the caller's to restore."""
    import torch

    from deequ_tpu_torch.ops import cuda_build
    from deequ_tpu_torch.ops import histogram_device as hd

    package = hd._library()
    name = hd.regime(sum(spaces))
    want = hd.fused_bincount_plain(keys, spaces)

    def k7(lib):
        cuda_build._LIBS["bincount"] = lib
        bufs = [hd._fused_buffers(keys, spaces, name) for _ in range(reps)]
        return bufs, lambda i: hd._fused_launch(keys, spaces, *bufs[i % reps], name)

    def k5_launches():
        cuda_build._LIBS["bincount"] = package
        bufs = [[hd._buffers(k, sp) for k, sp in zip(keys, spaces)] for _ in range(reps)]

        def launch(i):
            for k, sp, b in zip(keys, spaces, bufs[i % reps]):
                hd._launch(k, sp, None, *b)
        return bufs, launch

    out = {n: {"kernel_ms": []} for n in [*libs, "k5"]}
    order = [*libs, "k5"]
    try:
        for label in order + order[::-1]:
            bufs, launch = k5_launches() if label == "k5" else k7(libs[label])
            out[label]["kernel_ms"].append(time_queued(launch, reps))
            if "profiler_ms" not in out[label]:
                prof = profiled_ms(launch, reps=reps)
                out[label]["profiler_ms"] = prof if prof is not None else "no device time"
            if label != "k5" and label not in unheld:
                got = bufs[0][1].zero_()  # the entry adds into its zeroed output
                launch(0)
                if not torch.equal(got, want):
                    err = int((got - want).abs().max())
                    fail(f"K7 ({label}) at {[k.numel() for k in keys]} ids over {spaces} "
                         f"bins differs from its plain version: max err {err}")
            del bufs, launch
    finally:
        cuda_build._LIBS["bincount"] = package
    return out


def fused_dispatch_timing(table, device, rate: float, reps: int = 20) -> dict:
    """K7 at the main path's shape — the keys of customer_id, status and
    region as ``_prepare_grouping`` makes them, 3·10^7 int64 ids over their
    summed keyspace — the kernel alone and the three K5 launches it
    replaces, in turns (``k7_turns``: fresh buffers a launch, as
    ``fused_bincount`` allocates them; torch.profiler's time by kernel),
    one wrapper call, the plain version, ``torch.bincount`` over the vector
    the reference concatenates on the host (the library call), and the
    bound: each key read once and each count written once, over the card's
    memory rate. Then the grouping layer's two dispatches as a caller pays
    them (keys copied to the card, counted, fetched):
    ``_fused_device_bincount`` once against ``_device_bincount`` three
    times, in turns."""
    import numpy as np
    import torch

    from deequ_tpu_torch.ops import histogram_device as hd
    from deequ_tpu_torch.ops import segment

    preps = [segment._prepare_grouping(table, [c], device) for c in FUSED_SETS]
    spaces = [p.keyspace for p in preps]
    total = sum(spaces)
    keys = [torch.from_numpy(p.keys).to(device) for p in preps]
    saved = (hd.LAUNCHES, hd.FUSED_LAUNCHES)
    name = hd.regime(total)
    turns = k7_turns(keys, spaces, {"tree": hd._library()}, reps)
    kernel_ms = statistics.median(turns["tree"]["kernel_ms"])
    k5_ms = statistics.median(turns["k5"]["kernel_ms"])
    prof = turns["tree"]["profiler_ms"]
    call_ms = time_cuda(lambda: hd.fused_bincount(keys, spaces))
    plain_ms = time_queued(lambda i: hd.fused_bincount_plain(keys, spaces), reps)
    offsets = np.cumsum([0] + spaces[:-1])
    combined = np.concatenate([np.where(p.keys >= 0, p.keys + off, -1)
                               for p, off in zip(preps, offsets)])
    slots = torch.from_numpy(np.where(combined >= 0, combined, total)).to(device)
    library_ms = time_queued(lambda i: torch.bincount(slots, minlength=total + 1), reps,
                             waits=True)
    got = hd.fused_bincount(keys, spaces)
    want = hd.fused_bincount_plain(keys, spaces)
    per_set = torch.cat([hd.bincount(k, sp) for k, sp in zip(keys, spaces)])
    err = int((got - want).abs().max())
    if not torch.equal(got, want) or not torch.equal(got, per_set):
        fail(f"K7 at the main path's shape differs from its plain version (max err {err}) "
             "or from the three K5 counts")
    host_keys = [p.keys for p in preps]
    fused_s, unfused_s = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        segment._fused_device_bincount(host_keys, spaces, device)
        fused_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        for k, sp in zip(host_keys, spaces):
            segment._device_bincount(k, sp, device)
        unfused_s.append(time.perf_counter() - t0)
    hd.LAUNCHES, hd.FUSED_LAUNCHES = saved  # timing launches are not the path's
    n = sum(k.numel() for k in keys)
    bound_ms = (n * 8 + total * 8) / rate * 1e3
    return {
        "column": "customer_id+status+region",
        "rows_per_input": [k.numel() for k in keys],
        "keyspaces": spaces,
        "num_segments": total,
        "regime": name,
        "kernel_ms": kernel_ms,
        "kernel_ms_turns": turns["tree"]["kernel_ms"],
        "profiler_ms": prof,
        "call_ms": call_ms,
        "plain_ms": plain_ms,
        "library_ms": library_ms,
        "library_call": "torch.bincount of the host-offset, concatenated keys",
        "three_k5_ms": k5_ms,
        "three_k5_ms_turns": turns["k5"]["kernel_ms"],
        "three_k5_profiler_ms": turns["k5"]["profiler_ms"],
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "bound_share": bound_ms / kernel_ms,
        "max_abs_err": err,
        "fused_dispatch_s": fused_s,
        "three_dispatches_s": unfused_s,
    }


def fusion_path(table, main_result, res_main: dict, device, smi: str, rate: float) -> dict:
    """Phase ``fusion_path`` (module doc)."""
    import torch

    from deequ_tpu_torch.exceptions import DeviceOOMException
    from deequ_tpu_torch.ops import segment

    label = "fusion_path"
    suite = build_suite(table)
    want = metric_values(main_result)

    # fused and unfused, checked: one K7 launch against three K5 launches
    launches, stats, _ = fusion_checked_run(suite, want, f"{label}/fused", True)
    hold_fused_main(launches["bincount"], launches["fused_bincount"], stats, label)
    off_launches, off_stats, _ = fusion_checked_run(suite, want, f"{label}/unfused", False)
    got = (off_launches["bincount"], off_launches["fused_bincount"],
           off_stats["fused_group_passes"], off_stats["grouping_passes"],
           off_stats["hist_kernel_dispatches"])
    if got != (len(FUSED_SETS), 0, 0, 4, len(FUSED_SETS)):
        fail(f"{label}/unfused: K5, K7, fused passes, grouping passes, kernel dispatches "
             f"{got}; want (3, 0, 0, 4, 3)")

    # the walls, in turns, the checked runs above being the warm ones; the
    # side that goes first alternates, as the walls drift down run by run
    walls = {"fused": [], "unfused": []}
    for turn in range(FUSION_TIMED):
        for side in (("fused", "unfused") if turn % 2 == 0 else ("unfused", "fused")):
            with plan_fusion(side == "fused"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                result = suite.run()
                torch.cuda.synchronize()
                walls[side].append(time.perf_counter() - t0)
            differ = differing_bits(want, metric_values(result))
            if differ:
                fail(f"{label}: a timed {side} run differs in the bits of {differ}")

    timing = fused_dispatch_timing(table, device, rate)

    # the demotion rung: an OOM at the fused dispatch
    def oom(keys, keyspaces, *variant):
        raise DeviceOOMException("injected at the fused dispatch")

    real = segment.fused_bincount
    segment.fused_bincount = oom
    try:
        kernel_counts_zero()
        with plan_fusion(True):
            demoted = suite.run()
        demote_launches = kernel_counts()
        events = [e for e in demoted.device_events if e["kind"] == "fusion_demote"]
        demote_stats = segment.SCAN_STATS.snapshot()
    finally:
        segment.fused_bincount = real
    differ = differing_bits(want, metric_values(demoted))
    if (len(events) != 1 or events[0]["passes"] != len(FUSED_SETS)
            or events[0]["keyspace"] != timing["num_segments"]
            or "injected at the fused dispatch" not in events[0]["reason"]):
        fail(f"{label}/demotion: events {demoted.device_events}")
    if ((demote_launches["bincount"], demote_launches["fused_bincount"],
         demote_stats["fused_group_passes"], demote_stats["grouping_passes"])
            != (len(FUSED_SETS), 0, 0, 4) or differ):
        fail(f"{label}/demotion: launches {demote_launches}, fused passes "
             f"{demote_stats['fused_group_passes']}, differing bits {differ}")

    # the resident run (resident_main): status and region count from their
    # resident codes, customer_id is alone in its group
    resident = {"fused_launches": res_main["kernel_launches"]["fused_bincount"],
                "k5_launches": res_main["kernel_launches"]["bincount"],
                "fused_group_passes": res_main["scan_stats"]["fused_group_passes"]}
    if resident["fused_launches"] or resident["fused_group_passes"]:
        fail(f"{label}: the resident main run fused {resident}")

    # what the sparse id set's dropped preparation costs (prepared again by
    # its own pass, as in the reference)
    prepare_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        segment._prepare_grouping(table, ["id"], device)
        prepare_s.append(time.perf_counter() - t0)
    return {
        "phase": label, "card": smi, "rows": table.num_rows,
        "metrics_bit_identical": len(want),
        "fused": {"kernel_launches": launches, "scan_stats_grouping": {
            k: stats[k] for k in ("grouping_passes", "fused_group_passes",
                                  "hist_kernel_dispatches", "device_fetches",
                                  "device_sort_passes")}},
        "unfused": {"kernel_launches": off_launches, "scan_stats_grouping": {
            k: off_stats[k] for k in ("grouping_passes", "fused_group_passes",
                                      "hist_kernel_dispatches", "device_fetches",
                                      "device_sort_passes")}},
        "run_wall_s_fused": walls["fused"],
        "run_wall_s_unfused": walls["unfused"],
        "run_wall_s_median_fused": statistics.median(walls["fused"]),
        "run_wall_s_median_unfused": statistics.median(walls["unfused"]),
        "demotion": {"event": events[0], "kernel_launches": demote_launches},
        "resident": resident,
        "sparse_id_prepare_s": prepare_s,
        "kernel_timing": timing,
        "kernel_launches": {k: launches[k] + off_launches[k] + demote_launches[k]
                            for k in launches},
    }


# -- phase 5: kernel timing at the main path's shapes ------------------------


def time_queued(fn, reps: int = 100, waits: bool = False) -> float:
    """Milliseconds of one ``fn(i)`` on the card, the kernel alone: CUDA
    events around ``reps`` back-to-back calls, divided by ``reps``. The
    calls are enqueued behind a spin on the card that outlasts their
    enqueueing, so the window holds the card's work and none of the host's.
    A call that waits for the card itself (``waits``: ``torch.bincount``
    reads its ids' maximum back) would only wait the spin out, however
    long, so it runs with none: its window holds the host's gaps too."""
    import torch

    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    cycles = 0 if waits else 20_000_000
    while True:
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        marks[0].record()
        if cycles:
            torch.cuda._sleep(cycles)
        marks[1].record()
        t0 = time.perf_counter()
        for i in range(reps):
            fn(i)
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        marks[2].record()
        marks[2].synchronize()
        if waits or marks[0].elapsed_time(marks[1]) > enqueue_ms or cycles > 10**10:
            return marks[1].elapsed_time(marks[2]) / reps
        cycles *= 4


def profiled_ms(fn, reps: int = 10, match: str = "bincount"):
    """Device milliseconds per ``fn(i)`` as torch.profiler sees them, by
    kernel (the kernels whose name holds ``match`` and, in some regimes,
    the output's memset): each kernel's mean over the events the profiler
    kept (``events``: it may keep fewer than ``reps``), or None where the
    profiler shows no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            fn(i)
        torch.cuda.synchronize()
    by_kernel, events = {}, {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", getattr(ev, "self_cuda_time_total", 0.0))
        if us > 0 and (match in ev.key or ev.key.startswith("Memset")):
            # kernels of an anonymous namespace name it in their parameters too
            key = ev.key.replace("(anonymous namespace)::", "")
            name = key.split("(")[0].split("::")[-1].removeprefix("void ")
            by_kernel[name] = by_kernel.get(name, 0.0) + us / max(ev.count, 1) / 1e3
            events[name] = events.get(name, 0) + ev.count
    if not by_kernel:
        return None
    return {"total": sum(by_kernel.values()), "by_kernel": by_kernel, "events": events,
            "launches": reps}


def bincount_shape_timing(label: str, seg, m: int, rate: float, reps: int = 100,
                          fresh_buffers: bool = True) -> dict:
    """K5 at one shape a path gave it: the kernel alone in the rule's
    regime and in every other regime that can take the width (buffers
    preallocated as the wrapper makes them, one set a launch, or one set
    reused where ``reps`` sets would not fit: the partition regime writes
    its output whole), torch.profiler's device time, one wrapper call, the
    plain version, torch.bincount, and the bound: each id read once and
    each count written once, over the card's memory rate."""
    import torch

    from deequ_tpu_torch.ops import histogram_device
    from deequ_tpu_torch.ops.histogram_device import bincount, bincount_plain

    slots = torch.where(seg >= 0, seg, m).long()  # torch.bincount refuses negatives
    saved = histogram_device.LAUNCHES
    name = histogram_device.regime(m)
    regime_ms = {}
    prof_ms = None
    for other in histogram_device.REGIMES:
        try:
            bufs = [histogram_device._buffers(seg, m, None, other)
                    for _ in range(reps if fresh_buffers else 1)]
        except ValueError:
            continue  # this regime cannot take the width
        launch = lambda i: histogram_device._launch(seg, m, None, *bufs[i % len(bufs)],
                                                    regime_name=other)
        regime_ms[other] = time_queued(launch, reps)
        if other == name:
            prof_ms = profiled_ms(launch)
        del bufs
    kernel_ms = regime_ms[name]
    call_ms = time_cuda(lambda: bincount(seg, m))
    plain_ms = time_queued(lambda i: bincount_plain(seg, m), reps)
    library_ms = time_queued(lambda i: torch.bincount(slots, minlength=m + 1), reps,
                             waits=True)
    got, want = bincount(seg, m), bincount_plain(seg, m)
    histogram_device.LAUNCHES = saved  # timing launches are not the path's
    err = int((got - want).abs().max())
    if not torch.equal(got, want):
        fail(f"bincount != plain at the {label} shape (n={seg.numel()}, m={m}): "
             f"max err {err}")
    bound_ms = (seg.numel() * seg.element_size() + m * 8) / rate * 1e3
    return {
        "column": label,
        "n": seg.numel(),
        "num_segments": m,
        "ids": str(seg.dtype).replace("torch.", ""),
        "regime": name,
        "kernel_ms": kernel_ms,
        "regime_ms": regime_ms,
        "profiler_ms": prof_ms if prof_ms is not None else "no device time",
        "call_ms": call_ms,
        "plain_ms": plain_ms,
        "library_ms": library_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "bound_share": bound_ms / kernel_ms,
        "max_abs_err": err,
    }


def kernel_timing(table, device, rate: float) -> list:
    """K5 at the three dense grouping shapes of the main path."""
    import torch

    from deequ_tpu_torch.ops.segment import _prepare_grouping

    shapes = []
    for col in ("customer_id", "region", "status"):
        prep = _prepare_grouping(table, [col], device)
        seg = torch.from_numpy(prep.keys).to(device)
        shapes.append(bincount_shape_timing(col, seg, prep.keyspace, rate))
    return shapes


def boundary_timing(device, rate: float, rows: int = 10_000_000, reps: int = 20) -> list:
    """The kernel alone on uniform ids on both sides of each boundary of
    the regime rule, in every regime that can take the width: what the
    rule's choice rests on, measured on this card."""
    import numpy as np
    import torch

    from deequ_tpu_torch.ops import histogram_device

    rng = np.random.default_rng(11)
    out = []
    for name, widest in histogram_device.regime_widths().items():
        if widest is None:
            continue
        for m in (widest, widest + 1):
            seg = torch.from_numpy(rng.integers(0, m, size=rows)).to(device)
            regime_ms = {}
            for other in histogram_device.REGIMES:
                try:
                    bufs = histogram_device._buffers(seg, m, None, other)
                except ValueError:
                    continue  # this regime cannot take the width
                regime_ms[other] = time_queued(
                    lambda i: histogram_device._launch(seg, m, None, *bufs, regime_name=other),
                    reps)
            out.append({"num_segments": m, "regime": histogram_device.regime(m),
                        "regime_ms": regime_ms,
                        "bound_ms": (rows * 8 + m * 8) / rate * 1e3})
    return out


# -- the HLL kernel: parity ---------------------------------------------------

#: f64 bit patterns the canonical split treats apart: ±0.0, NaNs with and
#: without payloads and signs, ±inf, the f32 maximum and just past its
#: rounding edge, ±2^128, the f64 maximum, the smallest f64 subnormal
_HLL_EDGE_BITS = (
    0x0000000000000000, 0x8000000000000000, 0x7FF8000000000000, 0xFFF8000000000000,
    0x7FF4000000000000, 0x7FF0000000000123, 0xFFFC00000000ABCD, 0x7FFFFFFFFFFFFFFF,
    0x7FF0000000000000, 0xFFF0000000000000, 0x47EFFFFFE0000000, 0x47EFFFFFF0000000,
    0x47F0000000000000, 0xC7F0000000000000, 0x7FEFFFFFFFFFFFFF, 0x0000000000000001,
)


def hll_edge_values(rng, normals: int = 5000):
    """The edge values of the HLL split: the bit patterns above, magnitudes
    whose f32 rounding is subnormal, the integer edges (±2^31, 2^31 - 1,
    2^53 + 1), and normals at several scales."""
    import numpy as np

    return np.concatenate([
        np.array(_HLL_EDGE_BITS, dtype=np.uint64).view(np.float64),
        [2.0 ** -149, -(2.0 ** -149), 2.0 ** -140 * 1.25, 1e-40, -1e-39, 2.0 ** -126 * 0.999],
        [2.0 ** 31, -(2.0 ** 31), 2.0 ** 31 - 1, -(2.0 ** 31) + 1, 2.0 ** 53 + 1,
         -(2.0 ** 53) - 1, 2.0 ** 24 + 1, 0.0, 1.0, -1.0],
        rng.normal(size=normals) * 1e3, rng.normal(size=normals),
        1e6 + rng.standard_normal(normals),
    ])


def hll_parity(device) -> dict:
    """The HLL kernel against its plain version on the card, bit for bit:
    the split's edge values (and the card's plain version against the
    host's there), boolean and string-LUT inputs, an all-invalid column,
    one row, sizes around a block's and the grid's rows, and 10^7 rows of
    each input mode."""
    import numpy as np
    import torch

    from deequ_tpu_torch.ops import hll

    rng = np.random.default_rng(13)
    cases = 0

    def check(x_np, valid_np=None, lut_np=None):
        nonlocal cases
        x = torch.from_numpy(np.ascontiguousarray(x_np)).to(device)
        valid = None if valid_np is None else torch.from_numpy(valid_np).to(device)
        lut = None if lut_np is None else torch.from_numpy(lut_np).to(device)
        got = hll.registers(x, valid, 9, lut)
        want = hll.registers_plain(x, valid, 9, lut)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"hll kernel != plain (n={len(x_np)}, dtype={x_np.dtype}, "
                 f"masked={valid_np is not None}): "
                 f"{int((got != want).sum())} registers differ")
        cases += 1
        return got

    edges = hll_edge_values(rng)
    got = check(edges)
    if not torch.equal(got.cpu(), hll.registers_plain(torch.from_numpy(edges))):
        fail("hll registers on the card != the plain version on the host at the edges")
    check(edges, rng.random(len(edges)) >= 0.3)
    if check(edges, np.zeros(len(edges), bool)).any():
        fail("hll: an all-invalid column set a register")
    dictionary = np.array([f"R{i:04d}" for i in range(5000)], dtype=object)
    lut = hll.string_idx_rank_lut(dictionary, 9)
    codes = rng.integers(-1, 5000, 20_000).astype(np.int32)
    flags = rng.random(20_000) < 0.3
    for valid in (None, rng.random(20_000) >= 0.1):
        check(codes, valid, lut)
        check(flags, valid)
    check(edges[:1])
    check(flags[:1])
    check(codes[:1], None, lut)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    block = 512 * 4          # hll.cu: kThreads rows, kUnroll deep
    grid = 4 * sms * block   # kBlocksPerSm blocks an SM
    sizes = (511, 512, 513, block - 1, block, block + 1, grid - 1, grid, grid + 1)
    for n in sizes:
        check(np.resize(edges, n), rng.random(n) >= 0.01)
    rows = 10_000_000
    mask = rng.random(rows) >= 0.01
    check(rng.normal(size=rows) * 1e3, mask)
    check(rng.random(rows) < 0.5, mask)
    big_codes = zipf_ids(rng, rows, 5001).astype(np.int32) - 1
    check(big_codes, None, lut)
    return {"cases": cases, "max_abs_err": 0, "sizes": list(sizes), "rows": rows}


# -- the sketch path ------------------------------------------------------------


def make_sketch_table(rows: int, seed: int):
    """BASELINE.md config 3's width at ``rows`` rows: 48 float64 columns with
    1% nulls (the last with mean 1e6 and unit spread), an int64 column
    within int32 (Zipf 0.7 over ~1.1M keys, 1% null), an int64 column
    beyond int32, a boolean with 1% nulls, and ``region`` (5,000 strings,
    0.5% null)."""
    import numpy as np

    from deequ_tpu_torch.data.table import Column, ColumnarTable, DType

    rng = np.random.default_rng(seed + 1)
    cols = []
    for j in range(48):
        values = (1e6 + rng.standard_normal(rows) if j == 47
                  else rng.normal(loc=10.0 * j + 5.0, scale=1.0 + j, size=rows))
        cols.append(Column(f"q{j}", DType.FRACTIONAL, values=values,
                           mask=rng.random(rows) >= 0.01))
    keys = zipf_ids(rng, rows, 1_100_001)
    cols.append(Column("cust", DType.INTEGRAL, values=1000 + 3 * np.maximum(keys, 0),
                       mask=keys >= 0))
    cols.append(Column("wide", DType.INTEGRAL,
                       values=rng.integers(-(2 ** 40), 2 ** 40, rows)))
    cols.append(Column("flag", DType.BOOLEAN, values=rng.random(rows) < 0.3,
                       mask=rng.random(rows) >= 0.01))
    region = rng.integers(0, 5000, size=rows).astype(np.int32)
    region[rng.random(rows) < 0.005] = -1
    cols.append(Column("region", DType.STRING, codes=region,
                       dictionary=np.array([f"R{i:04d}" for i in range(5000)], dtype=object)))
    return ColumnarTable(cols)


SKETCH_QUANTILES = (0.1, 0.5, 0.9, 0.99)
SKETCH_RELATIVE_ERROR = 0.01


def sketch_columns(table):
    numeric = [c for c in table.column_names if table[c].dtype.is_numeric]
    return numeric, table.column_names


def build_sketch_check(table):
    from deequ_tpu_torch import Check, CheckLevel

    numeric, every = sketch_columns(table)
    check = Check(CheckLevel.ERROR, "sketch smoke")
    for c in numeric:
        for q in SKETCH_QUANTILES:
            check = check.has_approx_quantile(c, q, lambda v: True,
                                              relative_error=SKETCH_RELATIVE_ERROR)
    check = check.kll_sketch_satisfies("q0", lambda d: len(d.buckets) == 100)
    for c in every:
        check = check.has_approx_count_distinct(c, lambda v: v > 0)
    return check.has_correlation("q0", "q1", lambda v: -1.0 <= v <= 1.0)


def check_sketch_metrics(table, result, sorted_cols=None) -> dict:
    """Each HLL estimate within 0.2 of numpy's exact distinct count (the
    reference's own test bound) and each quantile's rank among numpy's
    valid values within relative_error * m of q * m; the KLL metric has
    its 100 buckets holding every valid row. ``sorted_cols`` keeps each
    column's sorted valid values for a later call."""
    import numpy as np

    if sorted_cols is None:
        sorted_cols = {}

    got = {}
    for analyzer, metric in result.metrics.items():
        if not metric.value.is_success:
            fail(f"metric failed: {metric}")
        got[(metric.name, metric.instance, getattr(analyzer, "quantile", None))] = (
            metric.value.get())
    numeric, every = sketch_columns(table)
    worst_hll, worst_rank = 0.0, 0.0
    for c in every:
        if c not in sorted_cols:
            col = table[c]
            if col.dtype.value == "string":
                sorted_cols[c] = np.sort(col.codes[col.codes >= 0])
            else:
                sorted_cols[c] = np.sort(col.values[col.mask])
        s = sorted_cols[c]
        distinct = int(len(s) > 0) + int(np.count_nonzero(s[1:] != s[:-1]))
        est = got[("ApproxCountDistinct", c, None)]
        rel = abs(est - distinct) / distinct
        worst_hll = max(worst_hll, rel)
        if rel > 0.2:
            fail(f"ApproxCountDistinct({c}) = {est} vs exact {distinct}: rel {rel:.3g} > 0.2")
        if c not in numeric:
            continue
        m = len(s)
        for q in SKETCH_QUANTILES:
            v = got[("ApproxQuantile", c, q)]
            lo, hi = np.searchsorted(s, v, "left"), np.searchsorted(s, v, "right")
            target = q * m
            err = 0.0 if lo <= target <= hi else min(abs(lo - target), abs(hi - target)) / m
            worst_rank = max(worst_rank, err)
            if err > SKETCH_RELATIVE_ERROR:
                fail(f"ApproxQuantile({c}, {q}) = {v}: rank error {err:.4g} > "
                     f"{SKETCH_RELATIVE_ERROR}")
        if c == "q0":
            dist = got[("KLL", "q0", None)]
            if sum(b.count for b in dist.buckets) != m or len(dist.buckets) != 100:
                fail("KLLSketch(q0): buckets do not hold every valid row")
    corr = got[("Correlation", "q0,q1", None)]
    if not -1.0 <= corr <= 1.0:
        fail(f"Correlation(q0, q1) = {corr}")
    return {"worst_hll_rel_err": worst_hll, "worst_quantile_rank_err": worst_rank,
            "metrics_checked": len(got)}


def registers_against_plain(table, device, result) -> int:
    """Every column's registers from the fused scan against the plain
    version run on the same device tensors, chunk by chunk, folded by max;
    the estimate of the folded plain registers equals the checked run's
    metric. Returns the columns checked."""
    import numpy as np
    import torch

    from deequ_tpu_torch.analyzers import ApproxCountDistinct
    from deequ_tpu_torch.ops import hll
    from deequ_tpu_torch.ops.scan_engine import (
        _auto_chunk_rows,
        _ChunkPacker,
        _device_luts,
        run_scan,
    )

    _, every = sketch_columns(table)
    analyzers = [ApproxCountDistinct(c) for c in every]
    ops = [a.scan_op(table) for a in analyzers]
    scanned = run_scan(table, ops, device)
    cols = {c: table[c] for c in sorted(every)}
    chunk = min(_auto_chunk_rows(cols), table.num_rows)
    packer = _ChunkPacker(cols)
    luts = _device_luts(ops, cols, device)
    folded = {c: torch.zeros(512, dtype=torch.int32, device=device) for c in every}
    for start in range(0, table.num_rows, chunk):
        stop = min(start + chunk, table.num_rows)
        planes = packer.to_device(packer.pack(start, stop), device)
        row_valid = torch.ones(stop - start, dtype=torch.bool, device=device)
        vals = packer.unpack_vals(*planes, row_valid, luts)
        for c in every:
            v = vals[c]
            lut = v.lut("hll_ir_p9") if v.kind == "str" else None
            valid = None if v.kind == "str" or v.mask is row_valid else v.mask
            kernel = hll.registers(v.data, valid, 9, lut)
            plain = hll.registers_plain(v.data, valid, 9, lut)
            if not torch.equal(kernel, plain):
                fail(f"hll registers of {c}, rows {start}:{stop}: kernel != plain")
            folded[c] = torch.maximum(folded[c], plain)
    metrics = {m.instance: m.value.get() for m in result.metrics.values()
               if m.name == "ApproxCountDistinct"}
    for c, res in zip(every, scanned):
        plain = folded[c].cpu().numpy()
        if not np.array_equal(np.asarray(res["registers"]).astype(np.int32), plain):
            fail(f"hll registers of {c} from the fused scan != the plain version's")
        if hll.estimate_cardinality(plain) != metrics[c]:
            fail(f"ApproxCountDistinct({c}) of the run != the plain registers' estimate")
    return len(every)


def kll_states_card_vs_cpu(table, device, rows: int = 1_000_000) -> dict:
    """A rows-row slice of four columns: the KLL states the card builds
    (one batched op of four columns, and one k = 2048 single-column op)
    equal the port's CPU states bit for bit."""
    import numpy as np
    import torch

    from deequ_tpu_torch.analyzers import ApproxQuantile, KLLSketch
    from deequ_tpu_torch.analyzers.runner import AnalysisRunner
    from deequ_tpu_torch.data.table import Column, ColumnarTable
    from deequ_tpu_torch.ops.scan_engine import run_scan

    names = ("q0", "q47", "cust", "wide")
    rows = min(rows, table.num_rows)
    sub = ColumnarTable([
        Column(c, table[c].dtype, values=table[c].values[:rows], mask=table[c].mask[:rows])
        for c in names
    ])
    analyzers = [ApproxQuantile(c, 0.5) for c in names] + [KLLSketch("q0")]
    exec_ops, plan = AnalysisRunner._coalesce_scan_ops([a.scan_op(sub) for a in analyzers])
    states = {}
    for dev in (device, torch.device("cpu")):
        results = run_scan(sub, exec_ops, dev)
        states[str(dev)] = [
            a.state_from_scan_result(ex(results[i]) if ex else results[i])
            for a, (i, ex) in zip(analyzers, plan)
        ]
    for a, card, cpu in zip(analyzers, states[str(device)], states["cpu"]):
        same = (
            (card.global_min, card.global_max) == (cpu.global_min, cpu.global_max)
            and (card.sketch.count, card.sketch.rng_count) == (cpu.sketch.count,
                                                               cpu.sketch.rng_count)
            and len(card.sketch.compactors) == len(cpu.sketch.compactors)
            and all(np.array_equal(x.view(np.uint64), y.view(np.uint64))
                    for x, y in zip(card.sketch.compactors, cpu.sketch.compactors))
        )
        if not same:
            fail(f"KLL state of {a!r} on the card != on the CPU")
    return {"rows": rows, "columns": list(names), "states": len(analyzers)}


def sketch_pieces(table, device, check) -> dict:
    """Host-clock seconds of the sketch run's pieces: the fused scan, the
    batched sort (the coalesced op's sort and summary of one full chunk's
    (50, rows) stack, once per chunk), the host fold of every KLL
    analyzer's summaries, and the string LUT build."""
    import numpy as np
    import torch

    from deequ_tpu_torch.analyzers.base import ScanShareableAnalyzer
    from deequ_tpu_torch.analyzers.runner import AnalysisRunner
    from deequ_tpu_torch.analyzers.sketches import _sketch_size_for_error
    from deequ_tpu_torch.ops import hll
    from deequ_tpu_torch.ops.kll_device import chunk_summary_batched
    from deequ_tpu_torch.ops.scan_engine import _auto_chunk_rows, run_scan

    scanning = list(dict.fromkeys(
        a for a in check.required_analyzers() if isinstance(a, ScanShareableAnalyzer)))
    out = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    AnalysisRunner._run_scanning_analyzers(table, scanning, device)
    out["fused_scan"] = time.perf_counter() - t0

    numeric, every = sketch_columns(table)
    chunk = min(_auto_chunk_rows({c: table[c] for c in every}), table.num_rows)
    chunks = -(-table.num_rows // chunk)
    X = torch.stack([torch.from_numpy(table[c].values[:chunk].astype(np.float64))
                     for c in numeric]).to(device)
    M = torch.stack([torch.from_numpy(table[c].mask[:chunk]) for c in numeric]).to(device)
    k = _sketch_size_for_error(SKETCH_RELATIVE_ERROR)
    chunk_summary_batched(X, M, k, chunk)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(chunks):
        chunk_summary_batched(X, M, k, chunk)
    torch.cuda.synchronize()
    out["batched_sort"] = time.perf_counter() - t0
    del X, M

    kll = [a for a in scanning if type(a).__name__ in ("ApproxQuantile", "KLLSketch")]
    exec_ops, plan = AnalysisRunner._coalesce_scan_ops([a.scan_op(table) for a in kll])
    results = run_scan(table, exec_ops, device)
    t0 = time.perf_counter()
    for a, (i, ex) in zip(kll, plan):
        a.state_from_scan_result(ex(results[i]) if ex else results[i])
    out["host_fold_summaries"] = time.perf_counter() - t0
    out["kll_analyzers_folded"] = len(kll)

    t0 = time.perf_counter()
    hll.string_idx_rank_lut(table["region"].dictionary, 9)
    out["string_lut_build"] = time.perf_counter() - t0
    return out


def sketch_path(rows: int, seed: int, device) -> tuple:
    import torch

    from deequ_tpu_torch import VerificationSuite
    from deequ_tpu_torch.ops import histogram_device, hll
    from deequ_tpu_torch.ops.scan_engine import SCAN_STATS

    t0 = time.perf_counter()
    table = make_sketch_table(rows, seed)
    t_table = time.perf_counter() - t0
    check = build_sketch_check(table)
    suite = VerificationSuite.on_data(table).add_check(check)
    numeric, every = sketch_columns(table)

    # the checked run: counts set to 0 just before, read just after
    torch.cuda.reset_peak_memory_stats(device)
    SCAN_STATS.reset()
    hll.LAUNCHES = 0
    histogram_device.LAUNCHES = histogram_device.FUSED_LAUNCHES = 0
    k1_zero()
    watch = watch_cpu_ops()
    t0 = time.perf_counter()
    with watch:
        result = suite.run()
    t_first = time.perf_counter() - t0
    launches = {"hll": hll.LAUNCHES, "bincount": histogram_device.LAUNCHES,
                "fused_bincount": histogram_device.FUSED_LAUNCHES, **k1_counts()}
    k1_require(launches, "sketch_path")
    if launches["fused_bincount"]:
        fail(f"sketch_path: no grouping set, yet K7 launched {launches['fused_bincount']} times")
    stats = SCAN_STATS.snapshot()
    peak = torch.cuda.max_memory_allocated(device)

    chunks = stats["chunks_processed"]
    if result.device != str(device):
        fail(f"sketch run executed on {result.device}, expected {device}")
    if watch.cpu_ops:
        fail(f"torch operations computed on CPU tensors during run(): {watch.cpu_ops}")
    if stats["scan_passes"] != 1 or stats["last_scan_fetches"] != 1:
        fail(f"sketch scan: {stats['scan_passes']} passes, "
             f"{stats['last_scan_fetches']} fetches (want 1 and 1)")
    if launches["hll"] != len(every) * chunks:
        fail(f"hll kernel launched {launches['hll']} times, want "
             f"{len(every)} columns x {chunks} chunks")
    # per chunk: one batched sort of the 50 quantile columns, one KLLSketch
    if (stats["kll_sort_passes"], stats["kll_sorted_columns"]) != (
            2 * chunks, (len(numeric) + 1) * chunks):
        fail(f"KLL sorts: {stats['kll_sort_passes']} passes over "
             f"{stats['kll_sorted_columns']} columns in {chunks} chunks, want one batched "
             f"sort of {len(numeric)} columns and one of KLLSketch's a chunk")
    t0 = time.perf_counter()
    sorted_cols = {}
    checked = check_sketch_metrics(table, result, sorted_cols)
    t_numpy = time.perf_counter() - t0

    walls = timed_runs(suite, 1 + TIMED_REPEATS)
    pieces = sketch_pieces(table, device, check)
    registers_checked = registers_against_plain(table, device, result)
    kll_card_cpu = kll_states_card_vs_cpu(table, device)
    return {
        "phase": "sketch_path",
        "rows": rows,
        "reduced": {"rows": "BASELINE.md config 3's 10^8 rows cut to 10^7 for the "
                            "script's time limit"},
        "columns": len(every),
        "quantile_columns": len(numeric),
        "analyzers": len(result.metrics),
        "chunks": chunks,
        "kernel_launches": launches,
        "scan_stats": stats,
        **checked,
        "registers_equal_plain_columns": registers_checked,
        "kll_card_equals_cpu": kll_card_cpu,
        "first_run_s_watched": t_first,
        "warm_run_s": walls[0],
        "run_wall_s_median": statistics.median(walls[1:]),
        "run_wall_s": walls[1:],
        "piece_s": pieces,
        "peak_device_bytes": peak,
        "table_build_s": t_table,
        "numpy_check_s": t_numpy,
    }, table, {"result": result, "sorted": sorted_cols}


def hll_timing(table, device, rate: float, launches: int) -> dict:
    """The HLL kernel at the sketch table's shape: 10^7 rows of one f64
    column with a mask. The kernel alone (100 launches queued behind a
    device spin into preallocated zeroed registers, CUDA events), one
    wrapper call, the plain version, and scatter_reduce_ amax over
    precomputed (idx, rank) — the one PyTorch call for the fold; no single
    call hashes too."""
    import torch

    from deequ_tpu_torch.ops import hll

    reps = 100
    col = table["q0"]
    x = torch.from_numpy(col.values).to(device)
    valid = torch.from_numpy(col.mask).to(device)
    saved = hll.LAUNCHES
    bufs = [torch.zeros(512, dtype=torch.int32, device=device) for _ in range(reps)]
    launch = lambda i: hll._launch(x, valid, 9, None, bufs[i % reps])
    kernel_ms = time_queued(launch, reps)
    prof = profiled_ms(launch, match="hll")
    call_ms = time_cuda(lambda: hll.registers(x, valid))
    plain_ms = time_queued(lambda i: hll.registers_plain(x, valid), 20)
    idx, rank, _ = hll.idx_rank(x, 9)
    rank = torch.where(valid, rank, 0)
    library_ms = time_queued(
        lambda i: torch.zeros(512, dtype=torch.int64, device=device).scatter_reduce_(
            0, idx, rank, "amax"), reps)
    got, want = hll.registers(x, valid), hll.registers_plain(x, valid)
    hll.LAUNCHES = saved  # timing launches are not the path's
    if not torch.equal(got, want):
        fail("hll kernel != plain at the sketch table's shape")
    nbytes = x.numel() * 8 + valid.numel() + 512 * 4
    bound_ms = nbytes / rate * 1e3
    return {
        "column": "q0",
        "n": x.numel(),
        "masked": True,
        "kernel_ms": kernel_ms,
        "profiler_ms": prof if prof is not None else "no device time",
        "call_ms": call_ms,
        "plain_ms": plain_ms,
        "library_ms": library_ms,
        "library_call": "scatter_reduce_(amax) over precomputed (idx, rank): the fold "
                        "alone; no single PyTorch call hashes too",
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "bound_share": bound_ms / kernel_ms,
        "launches_in_sketch_path": launches,
        "max_abs_err": 0,
    }



# -- the check-method path: frequency tables and string analyzers ------------


def _stringify(value) -> str:
    """A group value as the Histogram metric labels it (null: NullValue)."""
    if value is None:
        return "NullValue"
    if isinstance(value, float) and value.is_integer():
        return f"{value:.1f}"
    return str(value)


def numpy_histogram(slot_counts, label, k: int, n: int):
    """The Histogram metric by numpy: slot_counts over slots (slot 0 =
    null), the top k by count, the lower slot first on equal counts;
    ({label: (count, ratio)}, number_of_bins)."""
    import numpy as np

    order = np.argsort(-slot_counts, kind="stable")[:k]
    return ({label(int(i)): (int(slot_counts[i]), int(slot_counts[i]) / n)
             for i in order if slot_counts[i] > 0},
            int((slot_counts > 0).sum()))


def distribution_of(metric):
    if not metric.value.is_success:
        fail(f"metric failed: {metric}")
    dist = metric.value.get()
    return ({k: (v.absolute, v.ratio) for k, v in dist.values.items()},
            dist.number_of_bins)


def numpy_mutual_information(a, a_valid, b, b_valid) -> float:
    """MI by numpy with the reference's rule: the rows with either value
    present are the total, the marginals count those rows, the joint only
    the rows with both."""
    import numpy as np

    rows = a_valid | b_valid
    total = int(rows.sum())
    _, ai = np.unique(np.where(a_valid, a, a[a_valid][0]), return_inverse=True)
    _, bi = np.unique(np.where(b_valid, b, b[b_valid][0]), return_inverse=True)
    both = a_valid & b_valid
    ma = np.bincount(ai[a_valid & rows]).astype(np.float64)
    mb = np.bincount(bi[b_valid & rows]).astype(np.float64)
    pair = ai[both].astype(np.int64) * (int(bi.max()) + 1) + bi[both]
    keys, joint = np.unique(pair, return_counts=True)
    ka, kb = keys // (int(bi.max()) + 1), keys % (int(bi.max()) + 1)
    pxy = joint / total
    return float(np.sum(pxy * np.log(pxy / ((ma[ka] / total) * (mb[kb] / total)))))


def build_check_api(table):
    from deequ_tpu_torch import Check, CheckLevel, ConstrainableDataTypes

    yes = lambda v: True  # noqa: E731 — the metrics are checked against numpy
    return (
        Check(CheckLevel.ERROR, "check api")
        .has_histogram_values("status", yes)
        .has_number_of_distinct_values("region", yes, binning_udf=lambda s: s[:3])
        .has_mutual_information("status", "region", yes)
        .has_mutual_information("customer_id", "status", yes)
        .has_min_length("region", yes)
        .has_max_length("region", yes)
        .has_pattern("region", r"^R00\d\d$", yes)
        .contains_email("region", yes)
        .has_data_type("status", ConstrainableDataTypes.STRING, yes)
        .has_histogram_values("f0", yes)
    )


def expected_check_api(table) -> dict:
    """Every metric of the check-method path by numpy: {(name, instance,
    histogram binned?): value}."""
    import numpy as np

    n = table.num_rows
    st, rg = table["status"].codes, table["region"].codes
    status_dict, region_dict = table["status"].dictionary, table["region"].dictionary
    exp = {}
    counts = np.bincount(st + 1, minlength=len(status_dict) + 1)
    exp[("Histogram", "status", False)] = numpy_histogram(
        counts, lambda i: "NullValue" if i == 0 else status_dict[i - 1], 1000, n)
    labels = np.array([s[:3] for s in region_dict])
    uniq, inv = np.unique(labels, return_inverse=True)
    binned = np.where(rg >= 0, inv[np.maximum(rg, 0)] + 1, 0)
    counts = np.bincount(binned, minlength=len(uniq) + 1)
    exp[("Histogram", "region", True)] = numpy_histogram(
        counts, lambda i: "NullValue" if i == 0 else str(uniq[i - 1]), 1000, n)
    exp[("MutualInformation", "status,region", None)] = numpy_mutual_information(
        st, st >= 0, rg, rg >= 0)
    cu = table["customer_id"]
    exp[("MutualInformation", "customer_id,status", None)] = numpy_mutual_information(
        cu.values, cu.mask, st, st >= 0)
    lengths = np.array([len(s) for s in region_dict])[rg[rg >= 0]]
    exp[("MinLength", "region", None)] = float(lengths.min())
    exp[("MaxLength", "region", None)] = float(lengths.max())
    exp[("PatternMatch", "region", "R00")] = float(((rg >= 0) & (rg < 100)).sum()) / n
    exp[("PatternMatch", "region", "email")] = 0.0
    exp[("DataType", "status", None)] = (
        {"Unknown": (int((st < 0).sum()), float((st < 0).sum()) / n),
         "Fractional": (0, 0.0), "Integral": (0, 0.0), "Boolean": (0, 0.0),
         "String": (int((st >= 0).sum()), float((st >= 0).sum()) / n)}, 5)
    f0 = table["f0"]
    uniq, counts = np.unique(f0.values[f0.mask], return_counts=True)
    counts = np.concatenate([[int((~f0.mask).sum())], counts])
    exp[("Histogram", "f0", False)] = numpy_histogram(
        counts, lambda i: _stringify(None if i == 0 else float(uniq[i - 1])), 1000, n)
    return exp


def check_api_path(table, device) -> dict:
    """A second run() over the main path's table holding the check methods
    of the frequency tables and the string analyzers; every metric against
    numpy: exact for counts, bins, lengths and fractions, relative 1e-12
    for MutualInformation."""
    import torch

    from deequ_tpu_torch import VerificationSuite
    from deequ_tpu_torch.ops import histogram_device, hll, lut_cache
    from deequ_tpu_torch.ops.scan_engine import SCAN_STATS

    t0 = time.perf_counter()
    expected = expected_check_api(table)
    t_numpy = time.perf_counter() - t0
    suite = VerificationSuite.on_data(table).add_check(build_check_api(table))

    SCAN_STATS.reset()
    histogram_device.LAUNCHES = histogram_device.FUSED_LAUNCHES = 0
    hll.LAUNCHES = 0
    k1_zero()
    builds = lut_cache.BUILDS
    watch = watch_cpu_ops()
    t0 = time.perf_counter()
    with watch:
        result = suite.run()
    t_first = time.perf_counter() - t0
    launches = histogram_device.LAUNCHES
    k1_launches = k1_counts()
    k1_require(k1_launches, "check_api_path")
    stats = SCAN_STATS.snapshot()
    builds = lut_cache.BUILDS - builds
    if watch.cpu_ops:
        fail(f"torch operations computed on CPU tensors during run(): {watch.cpu_ops}")
    # Histogram(status), the binned Histogram(region), the dense
    # MI(status, region) and Histogram(f0) count on K5; MI(customer_id,
    # status) has 9.7M slots, so it takes the sparse device route, and
    # (region, status) is the one dense grouping set: nothing to fuse it
    # with, so it counts on K5 alone
    fused_launches = histogram_device.FUSED_LAUNCHES
    if (launches, fused_launches, stats["hist_kernel_dispatches"],
            stats["fused_group_passes"]) != (4, 0, 4, 0):
        fail(f"check api path: {launches} K5 and {fused_launches} K7 launches, "
             f"{stats['hist_kernel_dispatches']} kernel dispatches, "
             f"{stats['fused_group_passes']} fused passes (want 4, 0, 4, 0)")
    if hll.LAUNCHES or stats["hist_plain_dispatches"] or stats["hist_host_dispatches"]:
        fail(f"check api path: unexpected routes {stats}")
    if stats["scan_passes"] != 1 or stats["last_scan_fetches"] != 1:
        fail(f"check api scan: {stats['scan_passes']} passes, "
             f"{stats['last_scan_fetches']} fetches (want 1 and 1)")

    worst_mi = 0.0
    checked = 0
    for analyzer, metric in result.metrics.items():
        name = type(analyzer).__name__
        if name == "Histogram":
            key = (name, metric.instance, analyzer.binning_udf is not None)
            if distribution_of(metric) != expected[key]:
                fail(f"{analyzer!r}: the Distribution differs from numpy's")
        elif name == "DataType":
            if distribution_of(metric) != expected[(name, metric.instance, None)]:
                fail(f"{analyzer!r}: the Distribution differs from numpy's")
        else:
            if not metric.value.is_success:
                fail(f"metric failed: {metric}")
            have = metric.value.get()
            tag = None
            if name == "PatternMatch":
                tag = "R00" if analyzer.pattern.startswith("^R00") else "email"
            want = expected[(name, metric.instance, tag)]
            if name == "MutualInformation":
                rel = abs(have - want) / abs(want)
                worst_mi = max(worst_mi, rel)
                if rel > 1e-12:
                    fail(f"{analyzer!r}: {have!r} vs numpy {want!r}, rel {rel:.3g}")
            elif have != want:
                fail(f"{analyzer!r}: {have!r} != numpy {want!r}")
        checked += 1
    if checked != len(expected):
        fail(f"check api path: {checked} metrics, numpy has {len(expected)}")

    walls = timed_runs(suite, 1 + TIMED_REPEATS)
    return {
        "phase": "check_api_path",
        "rows": table.num_rows,
        "metrics_checked": checked,
        "worst_mi_rel_err": worst_mi,
        "kernel_launches": launches,
        "fused_launches": fused_launches,
        "k1_launches": k1_launches,
        "lut_builds": builds,
        "scan_stats": stats,
        "first_run_s_watched": t_first,
        "warm_run_s": walls[0],
        "run_wall_s_median": statistics.median(walls[1:]),
        "run_wall_s": walls[1:],
        "numpy_reference_s": t_numpy,
    }


# -- the frequency path: BASELINE config 4 -----------------------------------


def make_config4_table(rows: int, seed: int):
    """BASELINE config 4 (benchmarks/run_configs.py:config4) at ``rows``
    rows: one dictionary-encoded string column ``key`` of rows // 3
    distinct labels ``id_{i:09d}``, uniform int32 codes."""
    import numpy as np

    from deequ_tpu_torch.data.table import Column, ColumnarTable, DType

    rng = np.random.default_rng(43 + seed)
    cardinality = max(rows // 3, 1)
    codes = rng.integers(0, cardinality, rows).astype(np.int32)
    dictionary = np.array([f"id_{i:09d}" for i in range(cardinality)], dtype=object)
    return ColumnarTable([Column("key", DType.STRING, codes=codes, dictionary=dictionary)])


def build_config4_check():
    from deequ_tpu_torch import Check, CheckLevel

    yes = lambda v: True  # noqa: E731 — the metrics are checked against numpy
    return (
        Check(CheckLevel.ERROR, "config 4")
        .has_approx_count_distinct("key", yes)
        .has_histogram_values("key", yes, max_bins=1000)
        .has_uniqueness(["key"], yes)
    )


def frequency_pieces(table, device) -> dict:
    """Host-clock seconds of the config 4 run's pieces, each ending in a
    synchronisation: the Histogram's key codes on the host, their copy to
    the card, K5 over card + 1 slots, the packed-key top-k and its fetch,
    the host decode and stringify of the top 1,000; Uniqueness's count;
    the fused scan of ApproxCountDistinct (its LUT memoized); and the
    string LUT built cold (xxHash64 of every label, native)."""
    import numpy as np
    import torch

    from deequ_tpu_torch.analyzers import ApproxCountDistinct
    from deequ_tpu_torch.analyzers.grouping import _stringify as label
    from deequ_tpu_torch.analyzers.runner import AnalysisRunner
    from deequ_tpu_torch.ops import histogram_device, hll
    from deequ_tpu_torch.ops.scan_engine import fetch
    from deequ_tpu_torch.ops.segment import _packed_topk, _unpack_topk, group_count_stats

    col = table["key"]
    m = len(col.dictionary) + 1
    out = {}
    saved = histogram_device.LAUNCHES
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    codes = col.codes + np.int32(1)
    out["key_codes_host"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    seg = torch.from_numpy(codes).to(device)
    torch.cuda.synchronize()
    out["h2d_copy"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    counts = histogram_device.bincount(seg, m)
    torch.cuda.synchronize()
    out["k5_call"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    keys, groups = _packed_topk(counts, 1000)
    groups, keys = fetch(groups, keys)
    out["topk_and_fetch"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    slots, cnts = _unpack_topk(keys)
    _ = {label(col.dictionary[i - 1]): int(c) for i, c in zip(slots.tolist(), cnts.tolist())}
    out["host_decode_stringify"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    group_count_stats(table, ["key"], device)
    out["uniqueness_count_stats"] = time.perf_counter() - t0
    histogram_device.LAUNCHES = saved
    t0 = time.perf_counter()
    AnalysisRunner._run_scanning_analyzers(table, [ApproxCountDistinct("key")], device)
    torch.cuda.synchronize()
    out["fused_scan_acd"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    hll.string_idx_rank_lut(col.dictionary, 9)
    out["string_lut_build_cold"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    hll.hash_strings_plain(col.dictionary[:100_000])
    out["string_hash_plain_python_1e5"] = time.perf_counter() - t0
    return out


def frequency_path(rows: int, seed: int, device) -> dict:
    """A run() at BASELINE config 4 (ApproxCountDistinct, Histogram with
    1,000 detail bins and Uniqueness over one n/3-cardinality string
    column); every metric against numpy, one K5 launch a count, no torch
    op on a CPU tensor, no LUT built by a second run, and the card's
    Distribution equal to the CPU's over a 10^6-row slice."""
    import numpy as np
    import torch

    from deequ_tpu_torch import VerificationSuite
    from deequ_tpu_torch.analyzers import Histogram
    from deequ_tpu_torch.analyzers.runner import AnalysisRunner
    from deequ_tpu_torch.data.table import Column, ColumnarTable, DType
    from deequ_tpu_torch.ops import histogram_device, hll, lut_cache
    from deequ_tpu_torch.ops.scan_engine import SCAN_STATS

    t0 = time.perf_counter()
    table = make_config4_table(rows, seed)
    t_table = time.perf_counter() - t0
    col = table["key"]
    t0 = time.perf_counter()
    counts = np.bincount(col.codes + 1, minlength=len(col.dictionary) + 1)
    want_hist = numpy_histogram(
        counts, lambda i: "NullValue" if i == 0 else col.dictionary[i - 1], 1000, rows)
    distinct = int((counts > 0).sum())
    want_unique = float((counts == 1).sum()) / rows
    t_numpy = time.perf_counter() - t0
    suite = VerificationSuite.on_data(table).add_check(build_config4_check())

    torch.cuda.reset_peak_memory_stats(device)
    SCAN_STATS.reset()
    histogram_device.LAUNCHES = histogram_device.FUSED_LAUNCHES = 0
    hll.LAUNCHES = 0
    k1_zero()
    watch = watch_cpu_ops()
    t0 = time.perf_counter()
    with watch:
        result = suite.run()
    t_first = time.perf_counter() - t0
    launches = histogram_device.LAUNCHES
    k1_launches = k1_counts()
    if histogram_device.FUSED_LAUNCHES or SCAN_STATS.fused_group_passes:
        fail("config 4: one grouping set, yet a fused dispatch ran")
    stats = SCAN_STATS.snapshot()
    peak = torch.cuda.max_memory_allocated(device)
    if watch.cpu_ops:
        fail(f"torch operations computed on CPU tensors during run(): {watch.cpu_ops}")
    if launches != 2 or stats["hist_kernel_dispatches"] != 2:
        fail(f"config 4: {launches} bincount launches, {stats['hist_kernel_dispatches']} "
             "kernel dispatches (want one each for the top-k and Uniqueness counts)")
    if hll.LAUNCHES != stats["chunks_processed"]:
        fail(f"config 4: {hll.LAUNCHES} hll launches over {stats['chunks_processed']} chunks")
    fused_launches = histogram_device.FUSED_LAUNCHES
    got = {m.name: (a, m) for a, m in result.metrics.items()}
    if distribution_of(got["Histogram"][1]) != want_hist:
        fail("config 4: the Histogram's Distribution differs from numpy's")
    if got["Uniqueness"][1].value.get() != want_unique:
        fail(f"config 4: Uniqueness {got['Uniqueness'][1].value.get()} != {want_unique}")
    est = got["ApproxCountDistinct"][1].value.get()
    hll_rel = abs(est - distinct) / distinct
    if hll_rel > 0.15:
        fail(f"config 4: ApproxCountDistinct {est} vs exact {distinct}: rel {hll_rel:.3g}")
    boundary = sorted(want_hist[0].values())[0][0]
    tied = int((counts[1:] == boundary).sum())

    walls = []
    builds = lut_cache.BUILDS
    for _ in range(4):  # one warm run, then three timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        suite.run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    if lut_cache.BUILDS != builds:
        fail(f"config 4: a second run() built {lut_cache.BUILDS - builds} lookup tables")

    # the card's Distribution against the port's own CPU run, 10^6 rows
    cut = min(rows, 1_000_000)
    sub = ColumnarTable([Column("key", DType.STRING, codes=col.codes[:cut],
                                dictionary=col.dictionary)])
    hist = Histogram("key")
    card, cpu = (distribution_of(AnalysisRunner.do_analysis_run(sub, [hist], d).metric(hist))
                 for d in (device, "cpu"))
    if card != cpu:
        fail("config 4: the card's Distribution over 10^6 rows != the CPU's")
    return {
        "phase": "frequency_path",
        "rows": rows,
        "cardinality": len(col.dictionary),
        "reduced": {"rows": "BASELINE config 4's 10^8 rows cut to 10^7 for the "
                            "script's time limit"},
        "kernel_launches": launches,
        "fused_launches": fused_launches,
        "k1_launches": k1_launches,
        "hll_launches": stats["chunks_processed"],
        "number_of_bins": want_hist[1],
        "boundary_count": boundary,
        "groups_tied_at_boundary": tied,
        "hll_rel_err": hll_rel,
        "uniqueness": want_unique,
        "second_run_lut_builds": 0,
        "card_equals_cpu_rows": cut,
        "scan_stats": stats,
        "first_run_s_watched": t_first,
        "warm_run_s": walls[0],
        "run_wall_s_median_of_3": statistics.median(walls[1:]),
        "run_wall_s": walls[1:],
        "piece_s": frequency_pieces(table, device),
        "peak_device_bytes": peak,
        "table_build_s": t_table,
        "numpy_reference_s": t_numpy,
    }, table, result


def config4_timing(table, device, rate: float, full_rows: int = 100_000_000) -> dict:
    """K5 and the packed-key top-k at the shapes of the frequency path
    (the Histogram's int32 codes and Uniqueness's int64 keys over card + 1
    slots), and at config 4's own width: 10^8 uniform ids over
    10^8 // 3 + 1 slots, made on the card."""
    import torch

    from deequ_tpu_torch.ops import histogram_device
    from deequ_tpu_torch.ops.segment import _packed_topk, _prepare_grouping

    col = table["key"]
    m = len(col.dictionary) + 1
    shapes = [bincount_shape_timing(
        "key (top-k)", torch.from_numpy(col.codes + 1).to(device), m, rate)]
    prep = _prepare_grouping(table, ["key"], device)
    shapes.append(bincount_shape_timing(
        "key (Uniqueness)", torch.from_numpy(prep.keys).to(device), prep.keyspace, rate))
    full_m = full_rows // 3 + 1
    gen = torch.Generator(device=device).manual_seed(7)
    seg = torch.randint(1, full_m, (full_rows,), dtype=torch.int32, device=device,
                        generator=gen)
    shapes.append(bincount_shape_timing(
        "config 4 width", seg, full_m, rate, reps=20, fresh_buffers=False))

    topk = []
    saved = histogram_device.LAUNCHES
    for label, s, width in (("key", torch.from_numpy(col.codes + 1).to(device), m),
                            ("config 4 width", seg, full_m)):
        counts = histogram_device.bincount(s, width)
        ms = time_queued(lambda i: _packed_topk(counts, 1000), 20)
        sort_ms = time_queued(lambda i: torch.sort(counts, descending=True, stable=True), 20)
        keys, _ = _packed_topk(counts, 1000)
        want = torch.sort(counts, descending=True, stable=True).indices[:1000]
        got = 0xFFFFFFFF - (keys & 0xFFFFFFFF)
        if not torch.equal(got, want):
            fail(f"packed top-k at {label} != a stable descending sort's first 1,000")
        # the function reads the counts once; its 1,000 keys out are noise
        bound_ms = width * 8 / rate * 1e3
        topk.append({"column": label, "num_segments": width, "k": 1000, "ms": ms,
                     "stable_sort_ms": sort_ms, "bound_ms": bound_ms,
                     "bound_by": "bytes", "bound_share": bound_ms / ms})
    histogram_device.LAUNCHES = saved
    return {"bincount": shapes, "packed_topk": topk}


# -- the resident path: persist(), resident grouping, K4, encoded columns ----


class ResidentSpy:
    """Counts the grouping counts taken from resident codes
    (``segment._resident_string_bincount`` returning a tensor) while
    active."""

    def __init__(self):
        self.calls = 0

    def __enter__(self):
        from deequ_tpu_torch.ops import segment

        self._orig = segment._resident_string_bincount

        def spy(*args, **kwargs):
            out = self._orig(*args, **kwargs)
            self.calls += out is not None
            return out

        segment._resident_string_bincount = spy
        return self

    def __exit__(self, *exc):
        from deequ_tpu_torch.ops import segment

        segment._resident_string_bincount = self._orig


class PlainCheck:
    """While active, every histogram launch of the grouping counts
    (``segment``'s ``bincount_variant``: K5, or K6 under "onehot"; K4
    launches its own kernel) is held against ``bincount_plain`` on the
    same ids with ``torch.equal``, and every multi-input launch (K7, or
    K6's entry) against ``fused_bincount_plain``; a mismatch fails.
    ``shapes`` lists the single-input calls checked: ids, bins, calls and
    the least and most ids inside the bins (the rest are dropped);
    ``fused_shapes`` the multi-input calls (each input's rows, the
    keyspaces) and ``fused_calls`` their number."""

    def __init__(self, label: str):
        self.label = label
        self.seen = {}
        self.fused_seen = {}
        self.fused_calls = 0

    def __enter__(self):
        from deequ_tpu_torch.ops import histogram_device, segment

        self._orig = histogram_device.bincount_variant
        self._orig_fused = histogram_device.fused_bincount

        def fused_checked(keys, keyspaces, variant="scatter"):
            import torch

            out = self._orig_fused(keys, keyspaces, variant)
            want = histogram_device.fused_bincount_plain(keys, keyspaces)
            if not torch.equal(out, want):
                fail(f"{self.label}: K7 != fused_bincount_plain at inputs of "
                     f"{[k.numel() for k in keys]} rows over keyspaces {list(keyspaces)}")
            key = (tuple(k.numel() for k in keys), tuple(int(x) for x in keyspaces))
            self.fused_seen[key] = self.fused_seen.get(key, 0) + 1
            self.fused_calls += 1
            return out

        def checked(variant, seg, num_segments, *args, **kwargs):
            import torch

            out = self._orig(variant, seg, num_segments, *args, **kwargs)
            want = histogram_device.bincount_plain(seg, num_segments, *args, **kwargs)
            if not torch.equal(out, want):
                fail(f"{self.label}: the {variant} kernel != bincount_plain at "
                     f"{seg.numel()} ids, {num_segments} bins")
            if seg.numel() == 0 or num_segments == 0:
                return out  # the wrapper launches nothing
            inside = int(want.sum())
            key = (seg.numel(), int(num_segments))
            lo, hi, calls = self.seen.get(key, (inside, inside, 0))
            self.seen[key] = (min(lo, inside), max(hi, inside), calls + 1)
            return out

        segment.bincount_variant = checked
        segment.fused_bincount = fused_checked
        return self

    def __exit__(self, *exc):
        from deequ_tpu_torch.ops import segment

        segment.bincount_variant = self._orig
        segment.fused_bincount = self._orig_fused

    @property
    def shapes(self) -> list:
        return [{"ids": ids, "bins": bins, "calls": calls,
                 "ids_in_range_min": lo, "ids_in_range_max": hi}
                for (ids, bins), (lo, hi, calls) in sorted(self.seen.items())]

    @property
    def fused_shapes(self) -> list:
        return [{"rows": list(rows), "keyspaces": list(spaces), "calls": calls}
                for (rows, spaces), calls in sorted(self.fused_seen.items())]


def metric_values(result) -> dict:
    """{(name, instance, quantile): value} of a run; a failed metric fails."""
    got = {}
    for analyzer, metric in result.metrics.items():
        if not metric.value.is_success:
            fail(f"metric failed: {metric}")
        got[(metric.name, metric.instance, getattr(analyzer, "quantile", None))] = (
            metric.value.get())
    return got


def resident_runs(suite, table, device, label: str) -> dict:
    """The checked run of ``suite`` over the persisted ``table`` (counts
    set to 0 just before, read just after, watched for CPU ops), then one
    warm and three timed runs. Fails unless the runs read the resident
    chunks and packed nothing."""
    import torch

    from deequ_tpu_torch.ops import histogram_device, hll, select_device
    from deequ_tpu_torch.ops.scan_engine import SCAN_STATS

    torch.cuda.reset_peak_memory_stats(device)
    SCAN_STATS.reset()
    histogram_device.LAUNCHES = histogram_device.FUSED_LAUNCHES = 0
    hll.LAUNCHES = 0
    select_device.LAUNCHES = 0
    k1_zero()
    watch = watch_cpu_ops()
    t0 = time.perf_counter()
    with watch, ResidentSpy() as spy:
        result = suite.run()
    t_first = time.perf_counter() - t0
    launches = {"bincount": histogram_device.LAUNCHES,
                "fused_bincount": histogram_device.FUSED_LAUNCHES, "hll": hll.LAUNCHES,
                "select": select_device.LAUNCHES, **k1_counts()}
    stats = SCAN_STATS.snapshot()
    peak = torch.cuda.max_memory_allocated(device)
    if watch.cpu_ops:
        fail(f"{label}: torch operations computed on CPU tensors: {watch.cpu_ops}")
    if stats["resident_passes"] != stats["scan_passes"] or stats["bytes_packed"] != 0:
        fail(f"{label}: {stats['resident_passes']} of {stats['scan_passes']} scans "
             f"resident, {stats['bytes_packed']} bytes packed (want all and 0)")
    walls = []
    with ResidentSpy() as later:
        for _ in range(4):  # one warm run, then three timed
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            suite.run()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    if later.calls != 4 * spy.calls:
        fail(f"{label}: later runs took {later.calls} resident counts, want 4 x {spy.calls}")
    with PlainCheck(label) as plain:  # every K5/K7 launch of a further run against plain
        suite.run()
    checked = sum(s["calls"] for s in plain.shapes)
    if (checked, plain.fused_calls) != (launches["bincount"], launches["fused_bincount"]):
        fail(f"{label}: {checked} K5 and {plain.fused_calls} K7 launches held against "
             f"plain, the run made {launches['bincount']} and {launches['fused_bincount']}")
    return {
        "result": result,
        "kernel_launches": launches,
        "bincount_vs_plain": plain.shapes,
        "resident_string_counts": spy.calls,
        "scan_stats": stats,
        "first_run_s_watched": t_first,
        "warm_run_s": walls[0],
        "run_wall_s_median_of_3": statistics.median(walls[1:]),
        "run_wall_s": walls[1:],
        "peak_device_bytes": peak,
    }


def compare_runs(streamed: dict, resident: dict, label: str) -> float:
    """Every metric of a resident run against the streaming run's: exact
    where PERF.md §2 says exact, within its relative bound elsewhere
    (the runs cut chunks differently). Returns the worst relative error."""
    if set(streamed) != set(resident):
        fail(f"{label}: metric sets differ")
    worst = 0.0
    for key, want in streamed.items():
        have = resident[key]
        if key[0] in _REL:
            rel = abs(have - want) / max(abs(want), 1e-300)
            worst = max(worst, rel)
            if rel > _REL[key[0]]:
                fail(f"{label}: {key} resident {have!r} vs streamed {want!r}, "
                     f"rel {rel:.3g} > {_REL[key[0]]}")
        elif have != want:
            fail(f"{label}: {key} resident {have!r} != streamed {want!r}")
    return worst


def persist_timed(table, device, **kwargs):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    table.persist(device, **kwargs)
    return table._device_cache, time.perf_counter() - t0


def unpersist_frees(table, device, label: str) -> dict:
    """unpersist() must drop torch.cuda.memory_allocated() by at least the
    resident bytes."""
    import torch

    from deequ_tpu_torch.ops.scan_engine import total_resident_bytes

    nbytes = table._device_cache.nbytes
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(device)
    table.unpersist()
    torch.cuda.synchronize()
    freed = before - torch.cuda.memory_allocated(device)
    if freed < nbytes or table.is_persisted or total_resident_bytes() != 0:
        fail(f"{label}: unpersist() freed {freed} bytes of {nbytes} resident")
    return {"resident_bytes": nbytes, "freed_bytes": freed}


def make_encoded_table(table, encode: bool):
    """Two low-cardinality numeric columns made from the main table's
    (customer_id mod 1,000 with its nulls; f5 rounded to 0.1, about 600
    values) beside status, encoded or not."""
    import numpy as np

    from deequ_tpu_torch.data.table import Column, ColumnarTable, DType

    cu, f5 = table["customer_id"], table["f5"]
    out = ColumnarTable([
        Column("cbucket", DType.INTEGRAL, values=cu.values % 1000, mask=cu.mask),
        Column("f5r", DType.FRACTIONAL, values=np.round(f5.values, 1), mask=f5.mask),
        table["status"],
    ])
    if encode and out.encode(["cbucket", "f5r"])["cbucket"].encoding is None:
        fail("encoded: cbucket did not take an encoding")
    return out


def build_encoded_check():
    from deequ_tpu_torch import Check, CheckLevel

    yes = lambda v: True  # noqa: E731 — compared bit for bit between two runs
    check = Check(CheckLevel.ERROR, "encoded")
    for c in ("cbucket", "f5r"):
        check = (check.has_min(c, yes).has_max(c, yes).has_mean(c, yes).has_sum(c, yes)
                 .has_standard_deviation(c, yes).has_completeness(c, yes)
                 .has_approx_quantile(c, 0.5, yes).has_approx_count_distinct(c, yes))
    return (check.has_correlation("f5r", "cbucket", yes).satisfies("f5r > 55", "f5r above 55", yes)
            .has_uniqueness(["cbucket"], yes).has_entropy("status", yes))


def planes_read_bytes(cache, columns) -> int:
    """The bytes of a persisted table's resident planes that a scan of
    ``columns`` reads: each column's row of the values, masks, codes and
    encoded planes, in every chunk."""
    total = 0
    for planes in cache.device_chunks:
        for names, plane in zip(cache.packer.layout(), planes):
            rows = sum(1 for name in names if name in columns)
            total += rows * plane.shape[1] * plane.element_size()
    return total


def k1_valid_rows(task) -> int:
    ok = None
    for m in task.masks:
        ok = m if ok is None else ok & m
    return task.n if ok is None else int(ok.sum())


def k1_bound(tasks, offsets, rate: float) -> dict:
    """The least time the card could take for a batch: the distinct
    tensors its tasks read (by pointer), each read once, and its outputs
    written once, over the memory rate; the f64 operations of its valid
    rows (:data:`K1_OPS`) over the card's f64 rate; the larger of the two."""
    seen = {}
    for t in tasks:
        for x in t.data + t.masks:
            seen[x.data_ptr()] = x.numel() * x.element_size()
    nbytes = sum(seen.values()) + 8 * sum(1 for offs in offsets for o in offs if o >= 0)
    ops = sum(K1_OPS[t.kind] * k1_valid_rows(t) for t in tasks)
    bytes_ms, ops_ms = nbytes / rate * 1e3, ops / F64_RATE * 1e3
    return {"bytes": nbytes, "distinct_tensors": len(seen), "f64_ops": ops,
            "bytes_ms": bytes_ms, "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def k1_library(tasks) -> None:
    """One torch.sum / amin / amax a task over its column (a count's first
    mask, any other task's first data column), with no mask applied."""
    import torch

    for t in tasks:
        col = t.data[0] if t.data else (t.masks[0] if t.masks else None)
        if col is None:
            continue
        if t.kind == "min":
            torch.amin(col)
        elif t.kind == "max":
            torch.amax(col)
        else:
            torch.sum(col)


def k1_merge_timing(args, rate: float) -> dict:
    """The fold merge (``masked_reduce.merge_tags``) alone on the arguments
    a pass gave it: ``kernel_ms`` (CUDA events around 100 queued calls),
    ``empty_launch_ms`` (an empty kernel, ``torch.cuda._sleep(0)``, timed
    alike), the plain version's time, bit for bit its result, and the bound: its
    tags, accumulator, gather indices and gathered entries read once and
    its output written once, over the memory rate (a compare or an add a
    state entry is far below the f64 rate)."""
    import torch

    from deequ_tpu_torch.ops import masked_reduce

    is_sum, is_min, acc, flat, src = args
    got = masked_reduce.merge_tags(*args)
    want = masked_reduce.merge_tags_plain(*args)
    if not torch.equal(got.view(torch.int64), want.view(torch.int64)):
        fail("k1_merge_timing: the fold merge differs from its plain version in its bits")
    m = acc.numel()
    nbytes = 2 * m + 8 * m + (0 if src is None else 8 * m) + 8 * m + 8 * m
    bound_ms = nbytes / rate * 1e3
    kernel_ms = time_queued(lambda i: masked_reduce.merge_tags(*args))
    # an empty launch timed alike: the floor a launch costs on the card
    empty_launch_ms = time_queued(lambda i: torch.cuda._sleep(0))
    plain_ms = time_cuda(lambda: masked_reduce.merge_tags_plain(*args))
    return {"entries": m, "flat_entries": flat.numel(), "kernel_ms": kernel_ms,
            "empty_launch_ms": empty_launch_ms, "plain_ms": plain_ms, "library_ms": None, "bytes": nbytes, "bound_ms": bound_ms,
            "bound_by": "bytes", "bound_share": bound_ms / kernel_ms, "max_abs_err": 0.0}


def fused_scan_timing(table, device, rate: float) -> dict:
    """K1 in the fused scan of the main check's scan-shareable analyzers
    over the persisted table.

    - The pass (one after a warm one) under torch.profiler: every device
      kernel's time and count, K1's own kernels apart, and torch's reduce
      kernels apart (the scan ops' reductions are K1's tasks now: any
      left is named), the pass's wall and K1's launches in it.
    - Every task of the pass's batch (its one resident chunk) held against
      its plain version (:func:`k1_hold`).
    - K1 alone on that batch: ``kernel_ms`` (CUDA events around 20
      queued calls behind a device spin: its kernels and its tables'
      copy), one wrapper call as a caller pays it (``call_ms``),
      the plain versions of the same tasks on the card (``plain_ms``), and
      ``library_ms``: one torch.sum / amin / amax a task over its column,
      summed (:func:`k1_library`: the reductions as single library calls,
      no mask applied).
    - The bound (:func:`k1_bound`) of the batch, and the old bound of the
      whole pass: the resident planes of the columns the analyzers read
      (:func:`planes_read_bytes`), read once at the memory rate."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from deequ_tpu_torch.analyzers.base import ScanShareableAnalyzer
    from deequ_tpu_torch.analyzers.runner import AnalysisRunner
    from deequ_tpu_torch.ops import masked_reduce

    scanning = list(dict.fromkeys(
        a for a in build_check().required_analyzers()
        if isinstance(a, ScanShareableAnalyzer)
    ))
    columns = sorted({c for a in scanning for c in a.scan_op(table).columns})
    nbytes = planes_read_bytes(table._device_cache, columns)
    with K1Spy() as spy:
        AnalysisRunner._run_scanning_analyzers(table, scanning, device)  # warm
    torch.cuda.synchronize()
    if len(spy.batches) != len(table._device_cache.device_chunks):
        fail(f"fused_scan_timing: {len(spy.batches)} K1 batches over "
             f"{len(table._device_cache.device_chunks)} chunks, want one a chunk")
    k1_zero()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        AnalysisRunner._run_scanning_analyzers(table, scanning, device)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    pass_launches = k1_counts()
    total_us = reduce_us = k1_us = 0.0
    launches = reduce_launches = k1_kernels = 0
    reduce_names, k1_by_kernel = [], {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", getattr(ev, "self_cuda_time_total", 0.0))
        if us <= 0 or ev.key.startswith(("Memcpy", "Memset")) or ev.key.startswith("aten::"):
            continue
        total_us += us
        launches += ev.count
        if "k1_" in ev.key:
            k1_us += us
            k1_kernels += ev.count
            name = next((k for k in ("k1_tiles", "k1_fold", "k1_merge") if k in ev.key), ev.key)
            k1_by_kernel[name] = {"launches": ev.count, "ms": us / 1e3}
        elif "reduce" in ev.key.lower():
            reduce_us += us
            reduce_launches += ev.count
            reduce_names.append(ev.key[:120])
    if launches == 0:
        fail("fused_scan_timing: the profiler showed no device kernel in the fused scan")

    _, tasks, offsets = spy.batches[0]
    batch = masked_reduce.group(tasks, offsets)
    held = k1_hold(tasks, "main chunk")
    out = torch.empty(sum(t.n_outputs for t in tasks), dtype=torch.float64, device=device)
    kernel_ms = time_queued(lambda i: masked_reduce.reduce_into(out, tasks, offsets), reps=20)
    calls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        masked_reduce.reduce_into(out, tasks, offsets)
        torch.cuda.synchronize()
        calls.append((time.perf_counter() - t1) * 1e3)
    plain_ms = time_cuda(lambda: [t.plain() for t in tasks], reps=5, warmup=1)
    library_ms = time_cuda(lambda: k1_library(tasks), reps=5, warmup=1)
    bound = k1_bound(tasks, offsets, rate)
    merge = k1_merge_timing(spy.merges[0], rate)
    pass_bound_ms = nbytes / rate * 1e3
    kinds = {}
    for t in tasks:
        kinds[t.kind] = kinds.get(t.kind, 0) + 1
    return {"analyzers": len(scanning), "chunks": len(table._device_cache.device_chunks),
            "columns_read": len(columns), "bytes_read": nbytes,
            "resident_bytes": table._device_cache.nbytes, "device_kernels": launches,
            "device_ms": total_us / 1e3, "reduce_kernels": reduce_launches,
            "reduce_ms": reduce_us / 1e3, "reduce_kernel_names": reduce_names,
            "pass_wall_ms": wall_ms, "pass_bound_ms": pass_bound_ms, "pass_bound_by": "bytes",
            "pass_bound_share_of_device_ms": pass_bound_ms / (total_us / 1e3),
            "k1": {"tasks": len(tasks), "kinds": kinds, "sources": len(batch.sources),
                   "combos": len(batch.combos), "outputs": len(batch.outs),
                   "stage_bytes": masked_reduce.stage_bytes(
                       batch, masked_reduce.geometry()["tile_rows"]),
                   "batches_a_pass": pass_launches["k1"],
                   "merges_a_pass": pass_launches["k1_merge"],
                   "kernel_launches_a_pass": k1_kernels, "profiler_ms": k1_us / 1e3,
                   "profiler_by_kernel": k1_by_kernel,
                   "kernel_ms": kernel_ms, "call_ms": statistics.median(calls),
                   "plain_ms": plain_ms, "library_ms": library_ms,
                   "library_call": "one torch.sum / amin / amax a task over its column, "
                                   "summed (no mask)",
                   **bound, "bound_share": bound["bound_ms"] / kernel_ms,
                   "vs_plain": held},
            "k1_merge": merge}


#: host-side calls that put work on the card's stream
LAUNCH_CALLS = {"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync"}


def merged_spans(spans) -> list:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out = []
    for lo, hi in sorted(spans):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def overlap_us(a, b) -> float:
    """The length of the intersection of two unions of sorted disjoint
    intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def trace_run(fn) -> dict:
    """One call of ``fn`` (a whole run) under torch.profiler, ended by a
    device synchronisation: the device's busy share of the window (the
    union of every kernel's, copy's and set's interval on the card, over
    the span from the first host event to the last event of either side)
    and its idle share, the device kernels and their busy ms, the host's
    launch calls and the host time between consecutive ones (median and
    mean), the window beside the host-clock wall around it (the
    profiler's own cost is in both), the eight kernels that kept the
    card busiest (``top_kernels``: name, launches, device ms), and the
    host-to-device copies from pinned memory (a stream's staging) with the
    share of their device time during which a kernel also ran
    (``pinned_h2d_under_kernels_share``: how far those copies overlapped
    compute on the card)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, host, starts, h2d, computing = [], [], [], [], []
    kernels = 0
    by_name = {}
    for ev in prof.events():
        lo, hi = float(ev.time_range.start), float(ev.time_range.end)
        if ev.device_type == DeviceType.CUDA:
            spans.append((lo, hi))
            kernel = not ev.name.startswith(("Memcpy", "Memset"))
            kernels += kernel
            if kernel:
                computing.append((lo, hi))
            elif ev.name.startswith("Memcpy HtoD (Pinned"):
                h2d.append((lo, hi))
            name = ev.name[:100]
            count, us = by_name.get(name, (0, 0.0))
            by_name[name] = (count + 1, us + hi - lo)
        else:
            host.append((lo, hi))
            if ev.name in LAUNCH_CALLS:
                starts.append(lo)
    if not spans:
        return {"device_busy_share": "not measured (the profiler showed no device event)",
                "traced_wall_s": wall}
    window_lo = min(lo for lo, _ in host + spans)
    window_hi = max(hi for _, hi in host + spans)
    busy = sum(hi - lo for lo, hi in merged_spans(spans))
    copy_us = sum(hi - lo for lo, hi in merged_spans(h2d))
    copy_under_us = overlap_us(merged_spans(h2d), merged_spans(computing))
    window = window_hi - window_lo
    starts.sort()
    gaps = [b - a for a, b in zip(starts, starts[1:])]
    return {"window_ms": window / 1e3, "traced_wall_s": wall,
            "device_busy_ms": busy / 1e3, "device_busy_share": busy / window,
            "device_idle_share": 1.0 - busy / window, "device_kernels": kernels,
            "device_events": len(spans), "launch_calls": len(starts),
            "host_gap_median_us": statistics.median(gaps) if gaps else None,
            "host_gap_mean_us": statistics.mean(gaps) if gaps else None,
            "pinned_h2d_ms": copy_us / 1e3, "pinned_h2d_under_kernels_ms": copy_under_us / 1e3,
            "pinned_h2d_under_kernels_share": copy_under_us / copy_us if copy_us else None,
            "top_kernels": [[name, count, us / 1e3] for name, (count, us) in
                            sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]]}


def resident_main(table, device, streamed_result, streamed_report) -> dict:
    """(a) the main path over its persisted table, with K1's counterpart
    (the fused scan's reductions) profiled, and (d) encoded columns."""
    import torch

    from deequ_tpu_torch import VerificationSuite
    from deequ_tpu_torch.ops.scan_engine import SCAN_STATS

    cache, persist_s = persist_timed(table, device)
    n_chunks = len(cache.device_chunks)
    suite = build_suite(table)
    runs = resident_runs(suite, table, device, "resident main")
    k1_require(runs["kernel_launches"], "resident main")
    trace = trace_run(suite.run)
    k1 = fused_scan_timing(table, device, hbm_rate(torch.cuda.get_device_name(device)))
    result = runs.pop("result")
    worst = compare_runs(metric_values(streamed_result), metric_values(result), "resident main")
    stats = runs["scan_stats"]
    if runs["resident_string_counts"] != 2:
        fail(f"resident main: {runs['resident_string_counts']} grouping counts from "
             "resident codes, want 2 (status and region)")
    if runs["kernel_launches"]["bincount"] < 2 * n_chunks + 1:
        fail(f"resident main: {runs['kernel_launches']['bincount']} K5 launches")
    # status and region count from resident codes, and customer_id is left
    # alone in its group (id is sparse): fusion has nothing to fuse
    if runs["kernel_launches"]["fused_bincount"] or stats["fused_group_passes"]:
        fail(f"resident main: {runs['kernel_launches']['fused_bincount']} K7 launches, "
             f"{stats['fused_group_passes']} fused passes (want none)")
    if stats["hist_plain_dispatches"] or stats["hist_host_dispatches"]:
        fail("resident main: a grouping count ran off the kernel")
    freed = unpersist_frees(table, device, "resident main")

    # (d) encoded columns against their decoded twin, both persisted
    t0 = time.perf_counter()
    enc, dec = make_encoded_table(table, True), make_encoded_table(table, False)
    enc_cache, enc_persist_s = persist_timed(enc, device)
    dec_cache, _ = persist_timed(dec, device)
    check = build_encoded_check()
    SCAN_STATS.reset()
    got_enc = metric_values(VerificationSuite.on_data(enc).add_check(check).run())
    enc_stats = SCAN_STATS.snapshot()
    got_dec = metric_values(VerificationSuite.on_data(dec).add_check(check).run())
    if enc_stats["encoded_scan_passes"] < 1 or enc_stats["bytes_packed"] != 0:
        fail(f"encoded: {enc_stats['encoded_scan_passes']} encoded passes, "
             f"{enc_stats['bytes_packed']} bytes packed")
    for key, want in got_dec.items():
        have = got_enc[key]
        if not (have == want or (have != have and want != want)):
            fail(f"encoded: {key} encoded {have!r} != decoded {want!r}")
    if enc_cache.nbytes * 2 > dec_cache.nbytes:
        fail(f"encoded: {enc_cache.nbytes} resident bytes, decoded {dec_cache.nbytes}")
    encoded = {
        "columns": list(enc_cache.packer.enc_names),
        "metrics_bit_identical": len(got_dec),
        "resident_bytes_encoded": enc_cache.nbytes,
        "resident_bytes_decoded": dec_cache.nbytes,
        "persist_s_encoded": enc_persist_s,
        "scan_stats": enc_stats,
        "seconds": time.perf_counter() - t0,
    }
    enc.unpersist()
    dec.unpersist()
    return {
        "phase": "resident_path", "part": "main",
        "rows": table.num_rows, "chunks": n_chunks,
        "persist_s": persist_s, **freed,
        "streaming_run_wall_s_median_of_3": streamed_report["run_wall_s_median_of_3"],
        "worst_rel_err_vs_streaming": worst,
        **runs,
        "trace": trace,
        "k1_fused_scan": k1,
        "encoded": encoded,
    }


def kll_states_select_vs_sort(table, device, check) -> dict:
    """K4 against K3 on the same resident chunks: every KLL state of the
    sketch check from a resident scan with the select and one without,
    bit for bit; the select scan sorts nothing."""
    import numpy as np

    from deequ_tpu_torch.analyzers.runner import AnalysisRunner
    from deequ_tpu_torch.ops.scan_engine import SCAN_STATS, run_scan

    kll = list(dict.fromkeys(a for a in check.required_analyzers()
                             if type(a).__name__ in ("ApproxQuantile", "KLLSketch")))
    exec_ops, plan = AnalysisRunner._coalesce_scan_ops([a.scan_op(table) for a in kll])
    states = {}
    for select in (True, False):
        SCAN_STATS.reset()
        results = run_scan(table, exec_ops, device, select_kernel=select)
        stats = SCAN_STATS.snapshot()
        if stats["resident_passes"] != 1:
            fail("select vs sort: the scan did not read the resident chunks")
        if select and (stats["device_sort_passes"] or not stats["device_select_passes"]):
            fail(f"select scan: {stats['device_sort_passes']} sorts, "
                 f"{stats['device_select_passes']} selects")
        states[select] = [a.state_from_scan_result(ex(results[i]) if ex else results[i])
                          for a, (i, ex) in zip(kll, plan)]
    for a, sel, srt in zip(kll, states[True], states[False]):
        same = (
            (sel.global_min, sel.global_max) == (srt.global_min, srt.global_max)
            and (sel.sketch.count, sel.sketch.rng_count) == (srt.sketch.count,
                                                             srt.sketch.rng_count)
            and len(sel.sketch.compactors) == len(srt.sketch.compactors)
            and all(np.array_equal(x.view(np.uint64), y.view(np.uint64))
                    for x, y in zip(sel.sketch.compactors, srt.sketch.compactors))
        )
        if not same:
            fail(f"KLL state of {a!r}: the select (K4) != the sort (K3) on the same chunks")
    return {"states": len(kll), "batched_ops": len(exec_ops)}


def resident_sketch_pieces(table, device, check) -> dict:
    """Host-clock seconds of the resident sketch run's pieces: the whole
    resident scan with its fetch and fold, the scan of the KLL ops alone
    (K4 a chunk and op, one fetch), and the host fold of every KLL
    analyzer's fetched summaries (``kll_device.fold_summaries`` through
    ``state_from_scan_result``)."""
    import torch

    from deequ_tpu_torch.analyzers.base import ScanShareableAnalyzer
    from deequ_tpu_torch.analyzers.runner import AnalysisRunner
    from deequ_tpu_torch.ops.scan_engine import run_scan

    scanning = list(dict.fromkeys(
        a for a in check.required_analyzers() if isinstance(a, ScanShareableAnalyzer)))
    out = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    AnalysisRunner._run_scanning_analyzers(table, scanning, device)
    out["fused_scan"] = time.perf_counter() - t0
    kll = [a for a in scanning if type(a).__name__ in ("ApproxQuantile", "KLLSketch")]
    exec_ops, plan = AnalysisRunner._coalesce_scan_ops([a.scan_op(table) for a in kll])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = run_scan(table, exec_ops, device)
    out["kll_scan_select"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for a, (i, ex) in zip(kll, plan):
        a.state_from_scan_result(ex(results[i]) if ex else results[i])
    out["host_fold_summaries"] = time.perf_counter() - t0
    out["kll_analyzers_folded"] = len(kll)
    return out


def resident_sketch(table, device, streamed: dict, streamed_report) -> dict:
    """(b) the sketch path over its persisted table: the select (K4's
    kernel) replaces every sort, K4 = K3 on the same chunks, quantiles
    within the rank bound, HLL estimates equal to the streaming run's."""
    from deequ_tpu_torch import VerificationSuite

    cache, persist_s = persist_timed(table, device)
    check = build_sketch_check(table)
    runs = resident_runs(VerificationSuite.on_data(table).add_check(check), table,
                         device, "resident sketch")
    result = runs.pop("result")
    k1_require(runs["kernel_launches"], "resident sketch")
    stats = runs["scan_stats"]
    if stats["device_select_passes"] <= 0 or stats["device_sort_passes"] != 0 or (
            stats["kll_sort_passes"] != 0):
        fail(f"resident sketch: {stats['device_select_passes']} select passes, "
             f"{stats['device_sort_passes']} sort passes (want > 0 and 0)")
    if runs["kernel_launches"]["select"] != stats["device_select_passes"]:
        fail(f"resident sketch: {runs['kernel_launches']['select']} K4 kernel launches for "
             f"{stats['device_select_passes']} select passes")
    if stats["last_scan_fetches"] != 1:
        fail(f"resident sketch: {stats['last_scan_fetches']} fetches")
    checked = check_sketch_metrics(table, result, streamed["sorted"])
    got, want = metric_values(result), metric_values(streamed["result"])
    for key, value in want.items():
        if key[0] == "ApproxCountDistinct" and got[key] != value:
            fail(f"resident sketch: {key} {got[key]} != streamed {value}")
    select_vs_sort = kll_states_select_vs_sort(table, device, check)
    return {
        "phase": "resident_path", "part": "sketch",
        "rows": table.num_rows, "chunks": len(cache.device_chunks), "chunk_rows": cache.chunk,
        "persist_s": persist_s, "resident_bytes": cache.nbytes,
        "streaming_run_wall_s_median": streamed_report["run_wall_s_median"],
        **checked, "kll_select_equals_sort": select_vs_sort,
        **runs,
        "piece_s": resident_sketch_pieces(table, device, check),
    }


def _same_values(a, b) -> bool:
    """Equal as values, any NaN equal to any NaN (min and max)."""
    import torch

    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def _summaries_agree(got: dict, want: dict, k: int, exact_order: bool) -> bool:
    """Two summaries agree: count and weights equal, min and max as values,
    the strata items bit for bit and the remainder's items bit for bit in
    the same order (``exact_order``: the kernel against its plain version)
    or as a multiset (against K3, which sorts it)."""
    import torch

    if not (torch.equal(got["count"], want["count"])
            and torch.equal(got["weights"], want["weights"])
            and _same_values(got["min"], want["min"]) and _same_values(got["max"], want["max"])):
        return False
    a, b = got["items"].view(torch.int64), want["items"].view(torch.int64)
    if exact_order:
        return torch.equal(a, b)
    return torch.equal(a[:, :k], b[:, :k]) and torch.equal(
        a[:, k:].sort(1).values, b[:, k:].sort(1).values)


def select_case(X, M, k: int, label: str) -> None:
    """K4's kernel on one (K, n) case against its plain version on the
    same card tensors, bit for bit: the summary, and ``select_ranks``'
    keys, tie ranks and every pass's prefix and rank left, at the
    summary's targets and at 37 ranks a column in any order; the summary
    against K3 too."""
    import torch

    from deequ_tpu_torch.ops import select_device as sd
    from deequ_tpu_torch.ops.kll_device import chunk_summary_batched

    capacity = X.shape[1]
    got = sd.chunk_summary_select_batched(X, M, k, capacity)
    if not _summaries_agree(got, sd.chunk_summary_select_batched_plain(X, M, k, capacity), k,
                            exact_order=True):
        fail(f"select parity ({label}): the kernel's summary != its plain version's")
    if not _summaries_agree(got, chunk_summary_batched(X, M, k, capacity), k,
                            exact_order=False):
        fail(f"select parity ({label}): the kernel's summary != K3's")
    Xp, Mp = sd._padded(X, M)
    gen = torch.Generator(device=X.device).manual_seed(37)
    n = Xp.shape[1]
    for ranks in (sd._targets(Mp.sum(-1), k)[0],
                  torch.randint(-3, n + 3, (Xp.shape[0], 37), generator=gen, device=X.device)):
        a = sd.select_ranks(Xp, Mp, ranks, trace=True)
        b = sd.select_ranks_plain(Xp, Mp, ranks, trace=True)
        if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                and torch.equal(a[2][0], b[2][0]) and torch.equal(a[2][1], b[2][1])):
            fail(f"select parity ({label}): select_ranks' keys, ties or passes != plain")


def select_parity(device) -> dict:
    """K4's kernel against its plain version and K3 on the card
    (:func:`select_case`): tests/select_cases.py's adversarial columns (the
    CPU tests' generator and seed; each with its reverse, K = 2) at k = 256,
    2,048 and 16,384; the kernel's tile edges (1, 8,191, 8,192, 8,193 and
    20,000 rows) at K = 1 and 50, normal columns and columns of few tied
    values (both zeros, NaN payloads, +inf, nulls); a constant column at
    the resident sketch chunk's rows."""
    import numpy as np
    import torch

    from deequ_tpu_torch.ops import histogram_device, select_device

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from select_cases import adversarial_cases

    saved = (select_device.LAUNCHES, histogram_device.LAUNCHES)
    _, nan_bits, cases = adversarial_cases()
    checked = []
    for name, (values, mask) in sorted(cases.items()):
        mask = np.ones(len(values), dtype=bool) if mask is None else mask
        X = torch.from_numpy(np.stack([values, values[::-1].copy()])).to(device)
        M = torch.from_numpy(np.stack([mask, mask[::-1].copy()])).to(device)
        for k in (256, 2048, 16384):
            select_case(X, M, k, f"{name}, k={k}")
        checked.append(name)
    rng = np.random.default_rng(8192)
    pool = np.array([-0.0, 0.0, 1.5, -2.0, np.inf, nan_bits[1].view(np.float64), 2.0 ** 60])
    edges = []
    for n in (1, 8191, 8192, 8193, 20_000):
        for K in (1, 50):
            for kind in ("normal", "ties"):
                if kind == "normal":
                    values = rng.normal(100, 10, (K, n))
                else:
                    values = rng.choice(pool, (K, n))
                X = torch.from_numpy(values).to(device)
                M = torch.from_numpy(rng.random((K, n)) > 0.05).to(device)
                select_case(X, M, 256, f"{kind}, K={K}, n={n}")
                edges.append(f"{kind} {K}x{n}")
    chunk_rows = 4_761_604  # the resident sketch chunk (resident_path)
    X = torch.full((1, chunk_rows), 2.5, dtype=torch.float64, device=device)
    select_case(X, torch.ones_like(X, dtype=torch.bool), 256, "constant column")
    select_device.LAUNCHES, histogram_device.LAUNCHES = saved
    return {"adversarial": checked, "ks": [256, 2048, 16384], "tile_edges": edges,
            "constant_column_rows": chunk_rows, "max_abs_err": 0,
            "parity": "bit-exact against the plain version; K3's summary"}


def select_timing(table, device, rate: float) -> dict:
    """K4 for one batched summary at the resident sketch chunk's shape
    (50 columns x chunk rows, k = 256): the kernel alone (CUDA events
    around a launch into preallocated buffers, median of 3 after a warm
    launch) and each of its stages (``select_device.STAGES``, events
    between them, median of 3), one wrapper call, its plain version (the
    previous route: eight K5 launches and torch passes), torch.sort of the
    same (K, n) keys (the library call), K3 whole, and the bound: one read
    of the values and validity and one write of the summary. The same for
    a constant column at that shape. The kernel's summary is held against
    its plain version (bit for bit) and K3 at both."""
    import torch

    from deequ_tpu_torch.analyzers.sketches import _sketch_size_for_error
    from deequ_tpu_torch.ops import histogram_device, select_device as sd
    from deequ_tpu_torch.ops.kll_device import chunk_summary_batched, strata_capacity

    cache = table._device_cache
    numeric, _ = sketch_columns(table)
    planes = cache.device_chunks[0]
    n = planes[0].shape[1]
    row_valid = torch.ones(n, dtype=torch.bool, device=device)
    vals = cache.packer.unpack_vals(*planes, row_valid, names=numeric)
    X = torch.stack([vals[c].data for c in numeric])
    M = torch.stack([vals[c].mask for c in numeric])
    del vals
    k = _sketch_size_for_error(SKETCH_RELATIVE_ERROR)
    cap = cache.chunk
    saved = (sd.LAUNCHES, histogram_device.LAUNCHES)
    K = X.shape[0]
    W = strata_capacity(cap, k)
    bound_ms = (K * n * 9 + K * (k + W) * 16 + K * 24) / rate * 1e3

    def measure(X, M, label):
        bufs = sd.summary_buffers(X, k, cap)
        kernel_ms = time_cuda(lambda: sd.launch_summary(X, M, k, bufs), reps=3, warmup=1)
        stages = [sd.launch_summary(X, M, k, bufs, stage_ms=True) for _ in range(4)][1:]
        got = {key: bufs[key] for key in ("items", "weights", "count", "min", "max")}
        if not _summaries_agree(got, sd.chunk_summary_select_batched_plain(X, M, k, cap), k,
                                exact_order=True):
            fail(f"select timing ({label}): the kernel's summary != its plain version's")
        if not _summaries_agree(got, chunk_summary_batched(X, M, k, cap), k,
                                exact_order=False):
            fail(f"select timing ({label}): the kernel's summary != K3's")
        del bufs, got
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        call_ms = time_cuda(lambda: sd.chunk_summary_select_batched(X, M, k, cap),
                            reps=3, warmup=1)
        working = torch.cuda.max_memory_allocated(device) - base
        plain_ms = time_cuda(lambda: sd.chunk_summary_select_batched_plain(X, M, k, cap),
                             reps=3, warmup=1)
        key = torch.where(M, X, math.inf)
        key = torch.where(key == 0, 0.0, key)
        sort_ms = time_cuda(lambda: torch.sort(key, dim=-1, stable=True), reps=3, warmup=1)
        del key
        k3_ms = time_cuda(lambda: chunk_summary_batched(X, M, k, cap), reps=3, warmup=1)
        return {
            "column": label,
            "shape": {"columns": K, "rows": n, "k": k, "targets": k + 2, "W": W},
            "kernel_ms": kernel_ms,
            "stage_ms_median_of_3": {name: statistics.median(s[name] for s in stages)
                                     for name in sd.STAGES},
            "call_ms": call_ms,
            "working_set_bytes": working,
            "plain_ms": plain_ms,
            "torch_sort_ms": sort_ms,
            "k3_summary_ms": k3_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes",
            "bound_share": bound_ms / kernel_ms,
            "max_abs_err": 0,
        }

    out = measure(X, M, "resident sketch chunk")
    const = torch.full_like(X, 2.5)
    out["constant_column"] = measure(const, torch.ones_like(M), "constant columns")
    del const, X, M
    sd.LAUNCHES, histogram_device.LAUNCHES = saved
    out["name"] = "select (K4)"
    out["peak_device_bytes_after"] = torch.cuda.max_memory_allocated(device)
    return out


#: the resident chunk rule's bytes (scan_engine.persist_table: 2 GiB a
#: chunk, 9 bytes a row of an f64 column with its validity)
_CHUNK_ROWS_9B = (2 << 30) // 9


def select_shapes(device, rate: float) -> dict:
    """K4's kernel (alone, into preallocated buffers) against K3 whole at
    resident chunk shapes: batch widths 1, 8 and 50, rows 2^16 to 2^25,
    k = 2^8, 2^11 and 2^14, CUDA events, median of 3 after a warm call.
    Shapes whose chunk would pass the resident chunk rule's 2 GiB are not
    resident chunks and are listed as skipped. Normal(100, 10) values, 1%
    null, made on the card from a seed; the kernel's summary is held
    against K3's at every shape."""
    import torch

    from deequ_tpu_torch.ops import select_device as sd
    from deequ_tpu_torch.ops.kll_device import chunk_summary_batched

    saved = sd.LAUNCHES
    gen = torch.Generator(device=device).manual_seed(3)
    cells, skipped = [], []
    for K in (1, 8, 50):
        for n in (1 << 16, 1 << 19, 1 << 22, 1 << 24, 1 << 25):
            if K * n > _CHUNK_ROWS_9B:
                skipped.append({"columns": K, "rows": n})
                continue
            X = torch.randn((K, n), generator=gen, dtype=torch.float64, device=device) * 10 + 100
            M = torch.rand((K, n), generator=gen, device=device) > 0.01
            for k in (1 << 8, 1 << 11, 1 << 14):
                bufs = sd.summary_buffers(X, k, n)
                k4 = time_cuda(lambda: sd.launch_summary(X, M, k, bufs), reps=3, warmup=1)
                got = {key: bufs[key] for key in ("items", "weights", "count", "min", "max")}
                if not _summaries_agree(got, chunk_summary_batched(X, M, k, n), k,
                                        exact_order=False):
                    fail(f"select shapes: K4 != K3 at K={K}, n={n}, k={k}")
                del bufs, got
                k3 = time_cuda(lambda: chunk_summary_batched(X, M, k, n), reps=3, warmup=1)
                cells.append({"columns": K, "rows": n, "k": k, "k4_ms": k4, "k3_ms": k3,
                              "k4_over_k3": k4 / k3,
                              "bound_ms": K * n * 9 / rate * 1e3})
            del X, M
            torch.cuda.empty_cache()
    sd.LAUNCHES = saved
    return {"cells": cells, "skipped_past_the_chunk_rule": skipped,
            "k4_faster_everywhere": all(c["k4_ms"] < c["k3_ms"] for c in cells)}


def resident_frequency(table, device, streamed_result, streamed_report) -> dict:
    """(c) config 4 over its persisted table: Histogram's top-k and
    Uniqueness's count statistics from resident codes, equal to the
    streaming run's; Uniqueness fetches four scalars."""
    from deequ_tpu_torch import VerificationSuite
    from deequ_tpu_torch.ops.scan_engine import SCAN_STATS
    from deequ_tpu_torch.ops.segment import group_count_stats

    cache, persist_s = persist_timed(table, device)
    n_chunks = len(cache.device_chunks)
    runs = resident_runs(VerificationSuite.on_data(table).add_check(build_config4_check()),
                         table, device, "resident frequency")
    result = runs.pop("result")
    if runs["resident_string_counts"] != 2:
        fail(f"resident frequency: {runs['resident_string_counts']} resident counts, "
             "want 2 (Histogram and Uniqueness)")
    got = {m.name: m for m in result.metrics.values()}
    want = {m.name: m for m in streamed_result.metrics.values()}
    if distribution_of(got["Histogram"]) != distribution_of(want["Histogram"]):
        fail("resident frequency: the Histogram differs from the streaming run's")
    for name in ("Uniqueness", "ApproxCountDistinct"):
        if got[name].value.get() != want[name].value.get():
            fail(f"resident frequency: {name} {got[name].value.get()} != "
                 f"{want[name].value.get()}")
    before = SCAN_STATS.snapshot()
    with ResidentSpy() as spy:
        group_count_stats(table, ["key"], device)
    fetched = SCAN_STATS.bytes_fetched - before["bytes_fetched"]
    fetches = SCAN_STATS.device_fetches - before["device_fetches"]
    if spy.calls != 1 or fetches != 1 or fetched != 32:
        fail(f"resident Uniqueness: {fetches} fetches of {fetched} bytes (want 1 of 32)")
    freed = unpersist_frees(table, device, "resident frequency")
    return {
        "phase": "resident_path", "part": "frequency",
        "rows": table.num_rows, "chunks": n_chunks,
        "persist_s": persist_s, **freed,
        "uniqueness_fetch_bytes": fetched,
        "streaming_run_wall_s_median_of_3": streamed_report["run_wall_s_median_of_3"],
        **runs,
    }


# -- partition_path and stream_path: saved, merged and streamed states -------

#: the partition path's cut: daily partitions of the main table
PARTITIONS = 10
PARTITION_QUANTILES = (0.1, 0.5, 0.9)
#: the stream path: batches of 2^18 rows in groups of 8
STREAM_BATCHES = 32
STREAM_BATCH_ROWS = 1 << 18
STREAM_WINDOW = 8
#: metrics compared exactly between an aggregated and a whole-table run
_MERGE_EXACT = _EXACT | {"ApproxCountDistinct"}
#: the subnormal column held on the card against numpy
SUBNORMALS = (5e-324, 1e-310, -1e-310, 1.0, -2.0, 1e-40, 3e-39, 1e-38)


class HllPlainCheck:
    """While active, every K2 launch (``hll.registers`` on a card tensor)
    is held against ``hll.registers_plain`` on the same inputs with
    ``torch.equal``; a mismatch fails. ``checked`` counts the launches."""

    def __init__(self, label: str):
        self.label = label
        self.checked = 0

    def __enter__(self):
        from deequ_tpu_torch.ops import hll

        self._orig = hll.registers

        def checked(x, valid=None, p=9, lut=None):
            import torch

            out = self._orig(x, valid, p, lut)
            if x.is_cuda:
                if not torch.equal(out, hll.registers_plain(x, valid, p, lut)):
                    fail(f"{self.label}: K2 != registers_plain at {x.numel()} rows")
                self.checked += 1
            return out

        hll.registers = checked
        return self

    def __exit__(self, *exc):
        from deequ_tpu_torch.ops import hll

        hll.registers = self._orig


def kernel_counts_zero() -> None:
    from deequ_tpu_torch.ops import histogram_device, hll, holt_winters
    from deequ_tpu_torch.ops.scan_engine import SCAN_STATS

    SCAN_STATS.reset()
    histogram_device.LAUNCHES = histogram_device.FUSED_LAUNCHES = 0
    histogram_device.ONEHOT_LAUNCHES = 0
    hll.LAUNCHES = 0
    holt_winters.LAUNCHES = 0
    k1_zero()


def kernel_counts() -> dict:
    from deequ_tpu_torch.ops import histogram_device, hll, holt_winters

    return {"bincount": histogram_device.LAUNCHES,
            "fused_bincount": histogram_device.FUSED_LAUNCHES,
            "onehot": histogram_device.ONEHOT_LAUNCHES, "hll": hll.LAUNCHES,
            "holt_winters": holt_winters.LAUNCHES, **k1_counts()}


def slice_rows(table, start: int, stop: int):
    import numpy as np

    from deequ_tpu_torch.data.table import ColumnarTable

    idx = np.arange(start, stop)
    return ColumnarTable([c.take(idx) for c in table.columns.values()])


def replace_rows(table, start: int, part):
    """``table`` with rows [start, start + len(part)) taken from ``part``
    (same schema; string columns of equal dictionaries)."""
    import numpy as np

    from deequ_tpu_torch.data.table import Column, ColumnarTable, DType

    stop = start + part.num_rows
    cols = []
    for name, col in table.columns.items():
        new = part[name]
        if col.dtype == DType.STRING:
            if not np.array_equal(col.dictionary.astype(str), new.dictionary.astype(str)):
                fail(f"replace_rows: {name} dictionaries differ")
            codes = col.codes.copy()
            codes[start:stop] = new.codes
            cols.append(Column(name, col.dtype, codes=codes, dictionary=col.dictionary))
        else:
            values, mask = col.values.copy(), col.mask.copy()
            values[start:stop], mask[start:stop] = new.values, new.mask
            cols.append(Column(name, col.dtype, values=values, mask=mask))
    return ColumnarTable(cols)


def partition_required():
    from deequ_tpu_torch.analyzers import ApproxCountDistinct, ApproxQuantiles, CountDistinct

    return ([CountDistinct(["customer_id"]), ApproxCountDistinct("customer_id")]
            + [ApproxQuantiles(f"f{j}", PARTITION_QUANTILES) for j in range(4)])


def run_partition(part, provider, device):
    """One partition's checked run on the card, its states saved."""
    import torch

    from deequ_tpu_torch import VerificationSuite

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = (VerificationSuite.on_data(part, device).add_check(build_check())
              .add_required_analyzers(partition_required())
              .save_states_with(provider).run())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for metric in result.metrics.values():
        if not metric.value.is_success:
            fail(f"partition run: metric failed: {metric}")
    return wall


def canonical_frequencies(state):
    """A frequency state's (key columns, nulls, counts) in key order."""
    import numpy as np

    order = np.lexsort(tuple(
        a for v, m in reversed(list(zip(state.key_values, state.key_nulls)))
        for a in (np.where(m, v.dtype.type(0), v), m)))
    return ([v[order] for v in state.key_values], [m[order] for m in state.key_nulls],
            state.counts[order], state.num_rows)


def frequencies_equal(a, b) -> bool:
    import numpy as np

    ka, na, ca, ra = canonical_frequencies(a)
    kb, nb, cb, rb = canonical_frequencies(b)
    return (ra == rb and np.array_equal(ca, cb)
            and all(np.array_equal(x[~m], y[~m]) for x, y, m in zip(ka, kb, na))
            and all(np.array_equal(x, y) for x, y in zip(na, nb)))


def compare_aggregated(agg, agg_states, whole, whole_states, table, label: str) -> dict:
    """An aggregated run against the whole-table run of the same suite:
    exact where PERF.md §2 says exact, sums and means within 1e-12,
    standard deviation, correlation and entropy within 1e-10, HLL
    registers and frequency tables identical, each quantile's rank among
    numpy's valid values within relative_error · n."""
    import numpy as np

    from deequ_tpu_torch.analyzers import ApproxCountDistinctState, FrequenciesAndNumRows

    worst = worst_rank = 0.0
    freq_checked = hll_checked = 0
    for analyzer, want in whole.metrics.items():
        have = agg.metrics[analyzer]
        if not (have.value.is_success and want.value.is_success):
            fail(f"{label}: {analyzer!r} failed: {have} / {want}")
        w_state, h_state = whole_states.load(analyzer), agg_states.load(analyzer)
        if isinstance(w_state, FrequenciesAndNumRows):
            if not frequencies_equal(h_state, w_state):
                fail(f"{label}: {analyzer!r}: merged frequency table != whole table's")
            freq_checked += 1
        if isinstance(w_state, ApproxCountDistinctState):
            if h_state != w_state:
                fail(f"{label}: {analyzer!r}: merged HLL registers != whole table's")
            hll_checked += 1
        if want.name == "ApproxQuantiles":
            col = table[analyzer.column]
            s = np.sort(col.values[col.mask])
            m = len(s)
            for q, v in have.value.get().items():
                lo, hi = np.searchsorted(s, v, "left"), np.searchsorted(s, v, "right")
                t = float(q) * m
                err = 0.0 if lo <= t <= hi else min(abs(lo - t), abs(hi - t)) / m
                worst_rank = max(worst_rank, err)
                if err > analyzer.relative_error:
                    fail(f"{label}: {analyzer!r} at {q}: rank error {err:.4g}")
            continue
        a, b = have.value.get(), want.value.get()
        if want.name in _MERGE_EXACT:
            if a != b:
                fail(f"{label}: {analyzer!r}: aggregated {a!r} != whole {b!r}")
        else:
            rel = abs(a - b) / max(abs(b), 1e-300)
            worst = max(worst, rel)
            if rel > _REL[want.name]:
                fail(f"{label}: {analyzer!r}: aggregated {a!r} vs whole {b!r}, "
                     f"rel {rel:.3g} > {_REL[want.name]}")
    return {"metrics_compared": len(whole.metrics), "frequency_tables_identical": freq_checked,
            "hll_states_identical": hll_checked, "worst_rel_err": worst,
            "worst_quantile_rank_err": worst_rank}


def aggregate_and_compare(table, providers, device, label: str) -> dict:
    """run_on_aggregated_states over the partitions' providers, timed, and
    the whole-table run it is held against."""
    import torch

    from deequ_tpu_torch import VerificationSuite
    from deequ_tpu_torch.states import InMemoryStateProvider

    agg_states, whole_states = InMemoryStateProvider(), InMemoryStateProvider()
    t0 = time.perf_counter()
    agg = VerificationSuite.run_on_aggregated_states(
        table.schema, [build_check()], providers,
        required_analyzers=partition_required(), save_states_with=agg_states)
    t_agg = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    whole = (VerificationSuite.on_data(table, device).add_check(build_check())
             .add_required_analyzers(partition_required())
             .save_states_with(whole_states).run())
    torch.cuda.synchronize()
    t_whole = time.perf_counter() - t0
    if agg.status != whole.status:
        fail(f"{label}: aggregated status {agg.status} != whole-table {whole.status}")
    return {"aggregate_wall_s": t_agg, "whole_table_run_wall_s": t_whole,
            **compare_aggregated(agg, agg_states, whole, whole_states, table, label)}


def subnormal_partitions(device, root: str) -> dict:
    """The subnormal column cut into four partitions of two rows, each run
    on the card with its states saved, then aggregated: Minimum -2, the
    least positive value (Minimum where f > 0) 5e-324, Compliance(f > 0)
    0.75 and Compliance(f = 0) 0, each equal to numpy."""
    import numpy as np

    from deequ_tpu_torch.analyzers import Compliance, Minimum
    from deequ_tpu_torch.analyzers.runner import AnalysisRunner
    from deequ_tpu_torch.data.table import Column, ColumnarTable, DType
    from deequ_tpu_torch.states import FileSystemStateProvider

    f = np.array(SUBNORMALS)
    analyzers = [Minimum("f"), Minimum("f", where="f > 0"),
                 Compliance("f > 0", "f > 0"), Compliance("f = 0", "f = 0")]
    providers = []
    for i in range(4):
        part = ColumnarTable([Column("f", DType.FRACTIONAL, values=f[2 * i:2 * i + 2])])
        providers.append(FileSystemStateProvider(os.path.join(root, f"subnormal-{i}")))
        AnalysisRunner.do_analysis_run(part, analyzers, device, save_states_with=providers[-1])
    schema = ColumnarTable([Column("f", DType.FRACTIONAL, values=f)]).schema
    ctx = AnalysisRunner.run_on_aggregated_states(schema, analyzers, providers)
    got = [ctx.metric(a).value.get() for a in analyzers]
    want = [float(f.min()), float(f[f > 0].min()), float(np.mean(f > 0)),
            float(np.mean(f == 0))]
    if got != want or want != [-2.0, 5e-324, 0.75, 0.0]:
        fail(f"subnormals: aggregated {got} != numpy {want}")
    return {"minimum": got[0], "minimum_where_positive": got[1],
            "compliance_gt_0": got[2], "compliance_eq_0": got[3]}


def partition_path(table, seed: int, device) -> dict:
    """Phase ``partition_path`` (module doc)."""
    import shutil
    import tempfile

    import torch

    from deequ_tpu_torch.states import FileSystemStateProvider

    n = table.num_rows
    bounds = [(i * n // PARTITIONS, (i + 1) * n // PARTITIONS) for i in range(PARTITIONS)]
    parts = [slice_rows(table, a, b) for a, b in bounds]
    root = tempfile.mkdtemp(prefix="deequ_partition_path_")
    try:
        providers = [FileSystemStateProvider(os.path.join(root, f"part-{i}"))
                     for i in range(PARTITIONS)]
        torch.cuda.reset_peak_memory_stats(device)
        kernel_counts_zero()
        watch = watch_cpu_ops()
        with watch:
            watched = [run_partition(part, prov, device) for part, prov in zip(parts, providers)]
        launches = kernel_counts()
        k1_require(launches, "partition_path")
        peak = torch.cuda.max_memory_allocated(device)
        # the walls: the same runs again, unwatched (each rewrites its files)
        walls = [run_partition(part, prov, device) for part, prov in zip(parts, providers)]
        if watch.cpu_ops:
            fail(f"partition_path: torch operations computed on CPU tensors: {watch.cpu_ops}")
        # each partition's four grouping sets (id is dense at 10^6 rows) fuse
        # into one K7 launch; no set is left to K5
        if (launches["bincount"] != 0 or launches["fused_bincount"] != PARTITIONS
                or launches["hll"] < PARTITIONS):
            fail(f"partition_path: launches {launches}, want 0 K5, one K7 and >= 1 K2 "
                 "a partition")
        files = [os.path.join(dp, f) for dp, _, fs in os.walk(root) for f in fs]
        sizes = [os.path.getsize(f) for f in files]
        first = aggregate_and_compare(table, providers, device, "partition_path")

        # the partition update: partition 3 regenerated, rerun alone
        update_part = make_table(bounds[3][1] - bounds[3][0], seed + 1)
        kernel_counts_zero()
        watch2 = watch_cpu_ops()
        with watch2:
            update_wall = run_partition(update_part, providers[3], device)
        update_launches = kernel_counts()
        if (update_launches["bincount"], update_launches["fused_bincount"]) != (0, 1):
            fail(f"partition update: launches {update_launches}, want 0 K5 and 1 K7")
        if watch2.cpu_ops:
            fail(f"partition update: torch operations computed on CPU tensors: {watch2.cpu_ops}")
        updated = replace_rows(table, bounds[3][0], update_part)
        second = aggregate_and_compare(updated, providers, device, "partition update")
        del updated

        # every K5 and K2 launch of the partition runs against its plain version
        from deequ_tpu_torch.states import InMemoryStateProvider

        kernel_counts_zero()
        with PlainCheck("partition_path") as plain, HllPlainCheck("partition_path") as hplain:
            for part in parts:
                run_partition(part, InMemoryStateProvider(), device)
        k5_checked = sum(s["calls"] for s in plain.shapes)
        if (k5_checked, plain.fused_calls, hplain.checked) != (
                launches["bincount"], launches["fused_bincount"], launches["hll"]):
            fail(f"partition_path: held {k5_checked} K5 / {plain.fused_calls} K7 / "
                 f"{hplain.checked} K2 launches against plain, the runs made {launches}")
        subnormal = subnormal_partitions(device, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {
        "phase": "partition_path",
        "rows": n, "partitions": PARTITIONS, "partition_rows": bounds[0][1] - bounds[0][0],
        "analyzers": len(build_check().required_analyzers()) + len(partition_required()),
        "partition_run_wall_s_median": statistics.median(walls),
        "partition_run_wall_s": walls,
        "partition_run_wall_s_watched": watched,
        "state_files": len(files), "state_bytes_written": sum(sizes),
        "largest_state_file_bytes": max(sizes),
        "kernel_launches": {k: launches[k] + update_launches[k] for k in launches},
        "kernel_launches_partitions": launches,
        "kernel_launches_update": update_launches,
        "k5_vs_plain": plain.shapes, "k7_vs_plain": plain.fused_shapes,
        "k2_vs_plain_launches": hplain.checked,
        "peak_device_bytes": peak,
        "cpu_ops": watch.cpu_ops,
        "aggregated": first,
        "update_run_wall_s": update_wall,
        "updated": second,
        "subnormals": subnormal,
    }


def build_stream_check():
    """main_path's scan-shareable constraints and has_distinctness(status)."""
    from deequ_tpu_torch import Check, CheckLevel

    check = Check(CheckLevel.ERROR, "stream").has_size(lambda n: n > 0)
    check = check.is_complete("id").has_completeness("f0", lambda v: v > 0.9)
    for j in range(20):
        c = f"f{j}"
        check = (check.has_min(c, lambda v: True).has_max(c, lambda v: True)
                 .has_mean(c, lambda v: True).has_sum(c, lambda v: True)
                 .has_standard_deviation(c, lambda v: v > 0))
    return (
        check.has_correlation("f0", "f1", lambda v: -1.0 <= v <= 1.0)
        .is_non_negative("f5", lambda v: v > 0)
        .is_contained_in("status", [f"S{i}" for i in range(7)], lambda v: v > 0.9)
        .satisfies("f3 > -20", "f3 above -20", lambda v: v > 0.5)
        .where("status = 'S1'")
        .has_distinctness(["status"], lambda v: v > 0)
    )


def stream_path(seed: int, device) -> dict:
    """Phase ``stream_path`` (module doc)."""
    import torch

    from deequ_tpu_torch import VerificationSuite
    from deequ_tpu_torch.analyzers import ApproxCountDistinct
    from deequ_tpu_torch.ops import scan_engine
    from deequ_tpu_torch.ops.scan_engine import SCAN_STATS
    from deequ_tpu_torch.states import InMemoryStateProvider
    from deequ_tpu_torch.states.serde import serialize_state
    from deequ_tpu_torch.verification import IncrementalVerificationStream

    class Recording(InMemoryStateProvider):
        """Keeps the bytes of every state saved, in order."""

        def __init__(self):
            super().__init__()
            self.saved = []

        def persist(self, analyzer, state):
            self.saved.append((repr(analyzer), serialize_state(state)))
            super().persist(analyzer, state)

    source = make_table(STREAM_BATCHES * STREAM_BATCH_ROWS, seed + 2)
    batches = [slice_rows(source, b * STREAM_BATCH_ROWS, (b + 1) * STREAM_BATCH_ROWS)
               for b in range(STREAM_BATCHES)]
    del source
    required = [ApproxCountDistinct("customer_id")]

    def run_stream(provider, watch=None):
        stream = IncrementalVerificationStream(
            [build_stream_check()], required, aggregate_with=provider,
            save_states_with=provider, window=STREAM_WINDOW, device=device)
        done = []
        for b, batch in enumerate(batches):
            done.extend(stream.submit(batch, result_key=b))
        done.extend(stream.close())
        return dict(done)

    def serial_loop(provider):
        return {b: VerificationSuite.do_verification_run(
            batch, [build_stream_check()], required, device,
            aggregate_with=provider, save_states_with=provider)
            for b, batch in enumerate(batches)}

    orig_group = scan_engine.run_scan_group

    def marked_group(*args, **kwargs):  # copies inside the group scan, counted apart
        watch.marked = True
        try:
            return orig_group(*args, **kwargs)
        finally:
            watch.marked = False

    stream_states = Recording()
    kernel_counts_zero()
    watch = watch_cpu_ops()
    scan_engine.run_scan_group = marked_group
    try:
        with watch:
            piped = run_stream(stream_states)
    finally:
        scan_engine.run_scan_group = orig_group
    launches = kernel_counts()
    k1_require(launches, "stream_path")
    stats = SCAN_STATS.snapshot()
    if watch.cpu_ops:
        fail(f"stream_path: torch operations computed on CPU tensors: {watch.cpu_ops}")
    groups = stats["group_scan_passes"]
    if groups != STREAM_BATCHES // STREAM_WINDOW:
        fail(f"stream_path: {groups} groups dispatched, want {STREAM_BATCHES // STREAM_WINDOW}")
    if stats["group_fetches"] != groups:
        fail(f"stream_path: {stats['group_fetches']} fetches over {groups} groups, want one a group")
    if launches["hll"] != STREAM_BATCHES:
        fail(f"stream_path: {launches['hll']} K2 launches, want one a batch")

    serial_states = Recording()
    serial = serial_loop(serial_states)

    # a group holds its batches' K1 partials until its K1 batch: each run's
    # peak device bytes above what it starts with, the stream's beside the
    # serial loop's, which holds one batch's at a time
    peaks = {"stream": 0, "serial": 0}

    def timed(fn, name) -> float:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        t0 = time.perf_counter()
        fn(InMemoryStateProvider())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peaks[name] = max(peaks[name], torch.cuda.max_memory_allocated(device) - base)
        return wall

    # the walls, unwatched, the two alternating
    walls = {"stream": [], "serial": []}
    for _ in range(TIMED_REPEATS):
        walls["stream"].append(timed(run_stream, "stream"))
        walls["serial"].append(timed(serial_loop, "serial"))

    compared = 0
    for b in range(STREAM_BATCHES):
        want = {repr(a): m.value.get() for a, m in serial[b].metrics.items()}
        got = {repr(a): m.value.get() for a, m in piped[b].metrics.items()}
        if want.keys() != got.keys():
            fail(f"stream_path: batch {b}: metric sets differ")
        for key, w in want.items():
            g = got[key]
            if not (g == w or (g != g and w != w)):
                fail(f"stream_path: batch {b}: {key} stream {g!r} != serial {w!r}")
            compared += 1
        if piped[b].status != serial[b].status:
            fail(f"stream_path: batch {b}: status differs")
    if stream_states.saved != serial_states.saved:
        fail("stream_path: the saved states' bytes differ from the serial loop's")

    kernel_counts_zero()
    with PlainCheck("stream_path") as plain, HllPlainCheck("stream_path") as hplain:
        run_stream(InMemoryStateProvider())
    k5_checked = sum(s["calls"] for s in plain.shapes)
    if k5_checked != launches["bincount"] or hplain.checked != launches["hll"]:
        fail(f"stream_path: held {k5_checked} K5 / {hplain.checked} K2 launches against "
             f"plain, the stream made {launches}")
    # one grouping set a batch (status): nothing to fuse
    if launches["fused_bincount"] or plain.fused_calls:
        fail(f"stream_path: K7 launched {launches['fused_bincount']} times")
    return {
        "phase": "stream_path",
        "batches": STREAM_BATCHES, "batch_rows": STREAM_BATCH_ROWS, "window": STREAM_WINDOW,
        "groups_dispatched": groups,
        "fetches_a_group": stats["group_fetches"] / groups,
        "h2d_copies_a_group_in_group_scan": watch.h2d_marked / groups,
        "h2d_copies_stream_total": watch.h2d_copies,
        "stream_wall_s_median": statistics.median(walls["stream"]),
        "serial_loop_wall_s_median": statistics.median(walls["serial"]),
        "stream_wall_s": walls["stream"], "serial_loop_wall_s": walls["serial"],
        "peak_device_bytes": peaks, "group_k1_rows": scan_engine.GROUP_K1_ROWS,
        "k1_launches_a_group": launches["k1"] / groups,
        "metrics_bit_identical": compared,
        "states_bytes_identical": len(serial_states.saved),
        "kernel_launches": launches,
        "k5_vs_plain": plain.shapes, "k2_vs_plain_launches": hplain.checked,
        "scan_stats": stats,
    }


# -- phase 15: the metrics repository, anomaly checks and the monitor --------

#: the daily history one table keeps before today's run, and the fleet
HISTORY_DAYS = 365
FLEET_TABLES = 50
TENANT = {"tenant": "tenant-0"}
#: the Holt-Winters parity lengths: 2p (the monitor's warmup), then 28,
#: 36 (the milk series' training span), a year and two years
HW_PARITY_LENGTHS = (0, 28, 36, 365, 730)
#: block edges of K9's blocked evaluation, (kind, p, n): 2p + 1 (two
#: blocks of p and a last block of one point), and 358 = 17 x 21 + 1 (one
#: point past a multiple of the default block length at p = 7)
HW_BLOCK_EDGES = (("weekly", 7, 15), ("monthly", 12, 25), ("weekly", 7, 358))
#: K9 at forced block lengths, held to the plain fit: {case: lengths},
#: B from the default down to one block (the last lengths leave a last
#: block of one point, then none)
HW_BLOCK_SWEEP = {"weekly_n365": (21, 49, 98, 182, 364, 371),
                  "monthly_n730": (48, 96, 240, 372, 732)}
#: the shapes K9 is timed at
HW_TIMED = ("weekly_n365", "weekly_n730", "monthly_n730")
#: K9's computed chain figures (the point-by-point chain, the bound's
#: cycles): printed on its kernel_timing line only, not on the kernels line
HW_CHAIN_KEYS = ("serial_chain_ms", "kernel_over_serial_chain", "bound_cycles_a_step")
#: kernel against plain version: the fitted parameters' bound (both take
#: exact gradients; the roundings differ in the last bits)
HW_TOL = 1e-12


def _plain_fit_job(job):
    """One plain (autograd) fit on the host's CPU, in a worker process."""
    series, p, steps = job
    import torch

    from deequ_tpu_torch.ops import holt_winters

    torch.set_num_threads(1)
    return holt_winters.fit_plain(torch.tensor(series, dtype=torch.float64), p, steps).tolist()


class plain_fits_on_host:
    """The plain (autograd) fit of every job {name: (series, p, steps)} on
    the host's CPU, one worker process a core but one (spawned, so none
    shares this process's CUDA context), started on entry, the longest
    first, so the card's work of the phase runs beside them; ``get(name)``
    waits for one fit's (alpha, beta, gamma), ``all()`` for every one. The
    workers are shut down on exit."""

    def __init__(self, jobs: dict):
        self.jobs = jobs

    def __enter__(self):
        import concurrent.futures
        import multiprocessing

        workers = max(1, min(len(self.jobs), (os.cpu_count() or 2) - 1))
        self.pool = concurrent.futures.ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn"))
        self.t0 = time.perf_counter()
        # longest first, so the two-year fits do not start last
        order = sorted(self.jobs, key=lambda k: -len(self.jobs[k][0]))
        self.futures = {name: self.pool.submit(_plain_fit_job, self.jobs[name])
                        for name in order}
        return self

    def get(self, name: str) -> tuple:
        return tuple(self.futures[name].result())

    def all(self) -> dict:
        return {name: self.get(name) for name in self.futures}

    def __exit__(self, *exc):
        self.pool.shutdown(wait=True, cancel_futures=True)


def hw_series(kind: str, n: int, seed: int):
    """The parity series: ``weekly`` (a completeness-like ratio with a
    weekly pattern and noise), ``monthly`` (a level with a yearly pattern
    and a trend), ``constant`` (1.0) and ``big`` (values near 10^9, the
    scale of test_anomaly.py's BIG)."""
    import numpy as np

    rng = np.random.default_rng([seed, n, len(kind)])
    t = np.arange(n)
    if kind == "weekly":
        return 0.97 + 0.01 * np.sin(2 * np.pi * t / 7) + 0.002 * rng.standard_normal(n)
    if kind == "monthly":
        return 1000 + 50 * np.sin(2 * np.pi * t / 12) + 3 * t + 5 * rng.standard_normal(n)
    if kind == "big":
        return 1e9 + 1e6 * np.sin(2 * np.pi * t / 7) + 1e5 * rng.standard_normal(n)
    return np.ones(n)


def hw_flags(series, n: int, p: int, abg) -> list:
    """Indices in [n, len(series)) that Holt-Winters with parameters abg,
    trained on series[:n], flags (seasonal.py's rule, host numpy)."""
    import numpy as np

    from deequ_tpu_torch.anomaly.seasonal import additive_holt_winters

    test = series[n:]
    forecasts, residuals = additive_holt_winters(series[:n], p, len(test), *abg)
    sd = float(np.abs(residuals).std(ddof=1))
    return [n + i for i, (o, f) in enumerate(zip(test, forecasts)) if abs(o - f) > 1.96 * sd]


def hw_parity_cases(seed: int) -> dict:
    """{name: (series of n + p points, n, p)}: the kernel's parity cases."""
    cases = {}
    for kind, p in (("weekly", 7), ("monthly", 12)):
        for n in HW_PARITY_LENGTHS:
            n = n or 2 * p
            cases[f"{kind}_n{n}"] = (hw_series(kind, n + p, seed), n, p)
    for kind, p, n in HW_BLOCK_EDGES:
        cases[f"{kind}_n{n}"] = (hw_series(kind, n + p, seed), n, p)
    cases["constant_n14"] = (hw_series("constant", 21, seed), 14, 7)
    cases["big_n365"] = (hw_series("big", 372, seed), 365, 7)
    return cases


def daily_history(seed: int) -> dict:
    """Tenant-0's 365 days before today: Size near 10^7, Completeness(f1)
    with a weekly pattern (today, day 365, at the pattern's middle),
    Mean(f0) near 10 (today's table has mean 5: a halving)."""
    import numpy as np

    rng = np.random.default_rng([seed, 365])
    d = np.arange(HISTORY_DAYS)
    return {
        "size": 1e7 + rng.integers(-5000, 5001, HISTORY_DAYS).astype(np.float64),
        "completeness_f1": (0.99 + 0.001 * np.sin(2 * np.pi * (d - 1) / 7)
                            + 0.0002 * rng.standard_normal(HISTORY_DAYS)),
        "mean_f0": 10.0 + 0.01 * rng.standard_normal(HISTORY_DAYS),
    }


def online_normal_flags(series, start: int, factor: float = 3.0, skip: float = 0.1) -> list:
    """OnlineNormal's flagged indices from ``start`` on, written here from
    its definition (a Welford running mean and variance including the
    point, the first ``skip`` share of the series ignored, a flagged point
    kept out of the running statistics)."""
    mean = var_sum = 0.0
    flagged = []
    for i, x in enumerate(series):
        last = (mean, var_sum)
        mean = x if i == 0 else mean + (x - mean) / (i + 1)
        var_sum += (x - last[0]) * (x - mean)
        std = math.sqrt(var_sum / (i + 1))
        if i >= max(start, len(series) * skip) and \
                not (mean - factor * std <= x <= mean + factor * std):
            flagged.append(i)
            mean, var_sum = last
    return flagged


def _record_fits():
    """Wrap the port's Holt-Winters fit to record each (n, p, abg, device)."""
    from deequ_tpu_torch.anomaly import seasonal
    from deequ_tpu_torch.device import resolve_device

    seen = []
    orig = seasonal._fit_parameters

    def recording(series, p, device=None):
        abg = orig(series, p, device)
        seen.append((len(series), p, abg, str(resolve_device(device))))
        return abg

    seasonal._fit_parameters = recording
    return seen, lambda: setattr(seasonal, "_fit_parameters", orig)


def daily_run(table, history: dict, hw_plain, seed: int, device) -> dict:
    """Part ``daily_run`` of ``repository_path`` (module doc)."""
    import shutil
    import tempfile
    from types import SimpleNamespace

    import numpy as np
    import torch

    from deequ_tpu_torch import CheckLevel
    from deequ_tpu_torch.analyzers import ApproxCountDistinct, Completeness, Mean, Size
    from deequ_tpu_torch.anomaly import (
        HoltWinters,
        MetricInterval,
        OnlineNormalStrategy,
        RelativeRateOfChangeStrategy,
        SeriesSeasonality,
    )
    from deequ_tpu_torch.analyzers.runner import AnalyzerContext
    from deequ_tpu_torch.metrics import DoubleMetric, Entity
    from deequ_tpu_torch.ops.scan_engine import SCAN_STATS
    from deequ_tpu_torch.repository import AnalysisResult, FileSystemMetricsRepository, ResultKey
    from deequ_tpu_torch.tryresult import Success
    from deequ_tpu_torch.verification import AnomalyCheckConfig

    root = tempfile.mkdtemp(prefix="chip_smoke_repo_")
    try:
        path = os.path.join(root, "metrics.json")
        repo = FileSystemMetricsRepository(path)
        t0 = time.perf_counter()
        for day in range(HISTORY_DAYS):
            repo.save(AnalysisResult(ResultKey(day, TENANT), AnalyzerContext({
                Size(): DoubleMetric(Entity.DATASET, "Size", "*",
                                     Success(float(history["size"][day]))),
                Completeness("f1"): DoubleMetric(Entity.COLUMN, "Completeness", "f1",
                                                 Success(float(history["completeness_f1"][day]))),
                Mean("f0"): DoubleMetric(Entity.COLUMN, "Mean", "f0",
                                         Success(float(history["mean_f0"][day]))),
            })))
        seed_s = time.perf_counter() - t0

        today = ResultKey(HISTORY_DAYS, TENANT)
        strategies = {
            "online_normal_size": (OnlineNormalStrategy(), Size()),
            "relative_rate_mean_f0": (
                RelativeRateOfChangeStrategy(max_rate_decrease=0.9, max_rate_increase=1.1),
                Mean("f0")),
            "holt_winters_completeness_f1": (
                HoltWinters(MetricInterval.DAILY, SeriesSeasonality.WEEKLY), Completeness("f1")),
        }
        suite = (build_suite(table).add_required_analyzer(ApproxCountDistinct("customer_id"))
                 .use_repository(repo).save_or_append_result(today))
        for name, (strategy, analyzer) in strategies.items():
            suite = suite.add_anomaly_check(strategy, analyzer, AnomalyCheckConfig(
                CheckLevel.WARNING, name, with_tag_values=dict(TENANT)))

        fits, restore = _record_fits()
        kernel_counts_zero()
        watch = watch_cpu_ops()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            with watch:
                result = suite.run()
            torch.cuda.synchronize()
        finally:
            restore()
        run_s = time.perf_counter() - t0
        launches = kernel_counts()
        k1_require(launches, "repository_path daily_run")
        stats = SCAN_STATS.snapshot()
        if watch.cpu_ops:
            fail(f"daily_run: torch operations computed on CPU tensors: {watch.cpu_ops}")
        if launches["holt_winters"] != 1 or len(fits) != 1 or fits[0][3] != str(device):
            fail(f"daily_run: {launches['holt_winters']} K9 launches and fits {fits}, "
                 f"want one fit on {device}")
        # the main suite's three dense sets fuse into one K7 launch
        hold_fused_main(launches["bincount"], launches["fused_bincount"], stats, "daily_run")
        if launches["hll"] < 1:
            fail(f"daily_run: kernel launches {launches}")

        # every metric against numpy
        expected = expected_metrics(table)
        f1 = table["f1"]
        expected[("Completeness", "f1")] = float(f1.mask.sum()) / table.num_rows
        acd = [m for a, m in result.metrics.items() if isinstance(a, ApproxCountDistinct)]
        cu = table["customer_id"]
        exact = len(np.unique(cu.values[cu.mask]))
        estimate = acd[0].value.get()
        if abs(estimate - exact) > 0.2 * exact:
            fail(f"daily_run: ApproxCountDistinct {estimate} vs {exact} distinct")

        worst = check_metrics(SimpleNamespace(metrics={
            a: m for a, m in result.metrics.items() if not isinstance(a, ApproxCountDistinct)
        }), expected)

        # each anomaly check against the strategy recomputed here
        n = table.num_rows
        mean_f0 = float(table["f0"].values[table["f0"].mask].mean())
        sizes = list(history["size"]) + [float(n)]
        ratio = result.metrics[Mean("f0")].value.get() / history["mean_f0"][-1]
        (n_fit, p_fit, abg_kernel, _), = fits
        abg_err = max(abs(a - b) for a, b in zip(abg_kernel, hw_plain))
        if (n_fit, p_fit) != (HISTORY_DAYS, 7) or abg_err > HW_TOL:
            fail(f"daily_run: kernel fit {abg_kernel} vs plain {hw_plain} (err {abg_err})")
        completeness = np.append(history["completeness_f1"], expected[("Completeness", "f1")])
        hw_kernel = hw_flags(completeness, HISTORY_DAYS, 7, abg_kernel)
        hw_plain_flags = hw_flags(completeness, HISTORY_DAYS, 7, hw_plain)
        if hw_kernel != hw_plain_flags:
            fail(f"daily_run: Holt-Winters flags {hw_kernel} (kernel fit) vs "
                 f"{hw_plain_flags} (plain fit)")
        want = {
            "online_normal_size": HISTORY_DAYS in online_normal_flags(sizes, HISTORY_DAYS),
            "relative_rate_mean_f0": not (0.9 <= ratio <= 1.1),
            "holt_winters_completeness_f1": bool(hw_plain_flags),
        }
        got = {check.description: r.status.value for check, r in result.check_results.items()}
        for name, anomalous in want.items():
            if got[name] != ("Warning" if anomalous else "Success"):
                fail(f"daily_run: {name} is {got[name]}, numpy says anomalous={anomalous}")
        if not want["relative_rate_mean_f0"]:
            fail(f"daily_run: today's Mean(f0) {mean_f0} was scripted to be anomalous")

        # a fresh repository on the same file reads back today's result
        stored = FileSystemMetricsRepository(path).load_by_key(today)
        if stored is None:
            fail("daily_run: today's result was not saved")
        back = stored.analyzer_context.metric_map
        if set(back) != set(result.metrics):
            fail("daily_run: the saved result's analyzers differ from the run's")
        for analyzer, metric in result.metrics.items():
            if back[analyzer].value.get() != metric.value.get():
                fail(f"daily_run: read back {analyzer}: {back[analyzer].value.get()!r} "
                     f"!= {metric.value.get()!r}")

        # a second run reusing today's key computes nothing
        reuse = (build_suite(table).add_required_analyzer(ApproxCountDistinct("customer_id"))
                 .use_repository(repo).reuse_existing_results_for_key(today, True))
        kernel_counts_zero()
        t0 = time.perf_counter()
        again = reuse.run()
        reuse_s = time.perf_counter() - t0
        reuse_launches = kernel_counts()
        if SCAN_STATS.scan_passes or SCAN_STATS.grouping_passes or any(reuse_launches.values()):
            fail(f"daily_run: the reusing run scanned ({SCAN_STATS.scan_passes} passes) or "
                 f"launched {reuse_launches}")
        for analyzer, metric in again.metrics.items():
            if metric.value.get() != result.metrics[analyzer].value.get():
                fail(f"daily_run: reused {analyzer} differs")
        return {
            "part": "daily_run",
            "history_days": HISTORY_DAYS,
            "history_seed_s": seed_s,
            "run_wall_s": run_s,
            "reuse_run_wall_s": reuse_s,
            "metrics_checked": len(expected) + 1,
            "worst_rel_err": worst,
            "anomaly_status": got,
            "relative_rate_mean_f0": ratio,
            "holt_winters_fit": {"kernel": abg_kernel, "plain_cpu": list(hw_plain),
                                 "max_abs_err": abg_err, "flags": hw_kernel},
            "status": result.status.value,
            "kernel_launches": launches,
            "reuse_kernel_launches": reuse_launches,
            "scan_stats": stats,
            "read_back_metrics": len(back),
        }
    finally:
        shutil.rmtree(root, ignore_errors=True)


def fleet_completeness_f1():
    """Tenant-0's Completeness(f1) in ``fleet_history``: a weekly pattern
    0.985 + 0.002·sin(2πd/7), 5·10^-4 higher in the first week (the step
    gives the monitor's two-week warmup fit a real gradient and leaves
    the envelope room; with no step or with noise the 1.96-sigma rule
    fires on other days), and a drop of 0.01 on the last day."""
    import numpy as np

    d = np.arange(HISTORY_DAYS)
    values = 0.985 + 0.002 * np.sin(2 * np.pi * d / 7)
    values[:7] += 5e-4
    values[-1] -= 0.01
    return values


def fleet_values(series: list, seed: int):
    """(tables, days, series) values: each series' base times 1 + k·10^-4,
    k uniform in [-50, 50] (a daily wobble of at most 0.5% on a grid, so
    the history's value plane takes a dictionary); tenant-0's
    Completeness(f1) is :func:`fleet_completeness_f1`, its Size halves on
    day 250."""
    import numpy as np

    rng = np.random.default_rng([seed, FLEET_TABLES])
    base = np.array([b for *_, b in series])
    k = rng.integers(-50, 51, size=(FLEET_TABLES, HISTORY_DAYS, len(series)))
    values = base[None, None, :] * (1.0 + k * 1e-4)
    names = [(a, name) for a, _, name, _, _ in series]
    f1 = next(i for i, (a, n) in enumerate(names) if repr(a) == "Completeness(column='f1', where=None)")
    size = next(i for i, (a, n) in enumerate(names) if n == "Size")
    values[0, :, f1] = fleet_completeness_f1()
    values[0, 250, size] = 0.5 * base[size]
    return values, f1, size


def fleet_history(main_result, hw_plain, seed: int, device) -> dict:
    """Part ``fleet_history`` of ``repository_path`` (module doc);
    ``hw_plain`` is the plain fit of the monitor's warmup on the host's
    CPU."""
    import numpy as np
    import torch

    from deequ_tpu_torch import use_device
    from deequ_tpu_torch.analyzers import Completeness, Size
    from deequ_tpu_torch.analyzers.runner import AnalyzerContext
    from deequ_tpu_torch.anomaly import (
        HoltWinters,
        MetricInterval,
        OnlineNormalStrategy,
        SeriesSeasonality,
    )
    from deequ_tpu_torch.metrics import DoubleMetric, Entity
    from deequ_tpu_torch.ops.scan_engine import SCAN_STATS
    from deequ_tpu_torch.repository import (
        AnalysisResult,
        ColumnarMetricsRepository,
        QualityMonitor,
        RepositoryQuery,
        ResultKey,
    )
    from deequ_tpu_torch.repository.query import loader_side_aggregates, run_repository_query
    from deequ_tpu_torch.tryresult import Success

    series = [(a, m.entity, m.name, m.instance, m.value.get())
              for a, m in main_result.metrics.items()
              if isinstance(m, DoubleMetric) and m.value.is_success]
    series.append((Completeness("f1"), Entity.COLUMN, "Completeness", "f1", 0.99))
    values, f1_idx, size_idx = fleet_values(series, seed)

    monitor = QualityMonitor()
    monitor.watch(HoltWinters(MetricInterval.DAILY, SeriesSeasonality.WEEKLY),
                  analyzer=Completeness("f1"), tags=TENANT, name="hw_completeness_f1")
    monitor.watch(OnlineNormalStrategy(), analyzer=Size(), tags=TENANT,
                  name="online_normal_size", warmup=30)
    repo = ColumnarMetricsRepository(monitor=monitor)
    tags = [{"tenant": f"tenant-{t}"} for t in range(FLEET_TABLES)]
    kernel_counts_zero()
    t0 = time.perf_counter()
    with use_device(device):  # where the monitor's Holt-Winters series arm
        for day in range(HISTORY_DAYS):
            for t in range(FLEET_TABLES):
                row = values[t, day].tolist()
                repo.save(AnalysisResult(ResultKey(day, tags[t]), AnalyzerContext({
                    a: DoubleMetric(entity, name, inst, Success(v))
                    for (a, entity, name, inst, _), v in zip(series, row)
                })))
    torch.cuda.synchronize()
    save_s = time.perf_counter() - t0
    launches = kernel_counts()
    alerts = [(a.rule, a.time) for a in monitor.alerts]
    if alerts != [("online_normal_size", 250), ("hw_completeness_f1", HISTORY_DAYS - 1)]:
        fail(f"fleet_history: monitor alerts {alerts}, want one at day 250 on Size and "
             f"one at day {HISTORY_DAYS - 1} on Completeness(f1)")
    if launches["holt_winters"] != 1:
        fail(f"fleet_history: {launches['holt_winters']} K9 launches arming the monitor, want 1")
    hw_state, = [entry["blob"] for key, entry in monitor.state_blob()["states"].items()
                 if key.startswith("hw_completeness_f1\x00")]
    abg_armed = [float.fromhex(v) for v in hw_state["abg"]]
    abg_err = max(abs(a - b) for a, b in zip(abg_armed, hw_plain))
    if abg_err > HW_TOL:
        fail(f"fleet_history: the monitor armed with {abg_armed}, the plain fit on the "
             f"host's CPU gives {list(hw_plain)} (err {abg_err})")
    t0 = time.perf_counter()
    dropped = repo.compact()
    compact_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    history = repo.history_table()
    build_s = time.perf_counter() - t0
    rows = history.num_rows
    if rows != values.size or dropped:
        fail(f"fleet_history: {rows} history rows (want {values.size}), {dropped} dropped")

    queries = {
        "cross_tenant_completeness_f1": (
            RepositoryQuery(metric_name="Completeness", instance="f1", after=30, before=330,
                            aggregates=("count", "mean", "min", "max", "sum", "stddev")),
            values[:, 30:331, f1_idx].ravel()),
        "all_rows": (RepositoryQuery(aggregates=("count", "mean", "min", "max")),
                     values.ravel()),
    }
    bounds = {"count": 0.0, "min": 0.0, "max": 0.0, "sum": 1e-12, "mean": 1e-12,
              "stddev": 1e-10}
    out = {}
    for name, (query, want_rows) in queries.items():
        want = {"count": float(len(want_rows)), "mean": float(want_rows.mean()),
                "min": float(want_rows.min()), "max": float(want_rows.max()),
                "sum": float(want_rows.sum()), "stddev": float(want_rows.std())}
        kernel_counts_zero()
        t0 = time.perf_counter()
        enc = run_repository_query(repo, query, device=device)
        enc_s = time.perf_counter() - t0
        enc_stats = SCAN_STATS.snapshot()
        kernel_counts_zero()
        t0 = time.perf_counter()
        dec = run_repository_query(repo, query, encoded_ingest=False, device=device)
        dec_s = time.perf_counter() - t0
        dec_stats = SCAN_STATS.snapshot()
        t0 = time.perf_counter()
        loader = loader_side_aggregates(repo, query, device=device)
        loader_s = time.perf_counter() - t0
        if enc_stats["device_fetches"] != 1 or dec_stats["device_fetches"] != 1:
            fail(f"fleet_history: {name}: {enc_stats['device_fetches']} / "
                 f"{dec_stats['device_fetches']} fetches, want one each")
        if enc_stats["encoded_scan_passes"] != 1 or \
                2 * enc_stats["bytes_packed"] > dec_stats["bytes_packed"]:
            fail(f"fleet_history: {name}: encoded query staged {enc_stats['bytes_packed']} "
                 f"bytes, decoded {dec_stats['bytes_packed']}")
        if enc.rows != len(want_rows) or set(enc.aggregates) != set(query.aggregates):
            fail(f"fleet_history: {name}: {enc.rows} rows, aggregates {enc.aggregates}")
        for agg, value in enc.aggregates.items():
            for other, label in ((dec, "decoded"), (loader, "loader-side")):
                if struct_bits(other.aggregates[agg]) != struct_bits(value):
                    fail(f"fleet_history: {name}.{agg}: {value!r} != {label} "
                         f"{other.aggregates[agg]!r}")
            err = abs(value - want[agg]) / max(abs(want[agg]), 1e-300)
            if err > bounds[agg]:
                fail(f"fleet_history: {name}.{agg}: {value!r} vs numpy {want[agg]!r}")
        out[name] = {"rows": enc.rows, "aggregates": enc.aggregates,
                     "query_wall_s": enc_s, "decoded_query_wall_s": dec_s,
                     "loader_side_wall_s": loader_s,
                     "bytes_packed": enc_stats["bytes_packed"],
                     "decoded_bytes_packed": dec_stats["bytes_packed"]}
    return {
        "part": "fleet_history",
        "tables": FLEET_TABLES, "days": HISTORY_DAYS, "series": len(series),
        "history_rows": rows,
        "save_wall_s": save_s, "saves": FLEET_TABLES * HISTORY_DAYS,
        "compact_wall_s": compact_s, "segments": repo.num_segments,
        "history_build_wall_s": build_s,
        "monitor_alerts": alerts,
        "monitor_fit": {"kernel": abg_armed, "plain_cpu": list(hw_plain),
                        "max_abs_err": abg_err},
        "kernel_launches": launches,
        "queries": out,
    }


def struct_bits(x: float) -> bytes:
    import struct

    return struct.pack("<d", float(x))


def holt_winters_parity(cases: dict, plain: dict, device) -> dict:
    """Part ``holt_winters_parity`` (module doc): the kernel against the
    plain fit on the host's CPU, at its default blocks and at the forced
    block lengths of HW_BLOCK_SWEEP, and a 10-step fit against the plain
    version on the card."""
    import torch

    from deequ_tpu_torch.ops import holt_winters

    rows, worst = [], 0.0
    for name, (series, n, p) in cases.items():
        got = holt_winters.fit(torch.tensor(series[:n], device=device), p).tolist()
        err = max(abs(a - b) for a, b in zip(got, plain[name]))
        flags = hw_flags(series, n, p, got)
        plain_flags = hw_flags(series, n, p, plain[name])
        if err > HW_TOL or flags != plain_flags:
            fail(f"holt_winters_parity: {name}: kernel {got} vs plain {plain[name]} "
                 f"(err {err}), flags {flags} vs {plain_flags}")
        worst = max(worst, err)
        rows.append({"case": name, "n": n, "p": p, "blocks": holt_winters.blocking(n, p),
                     "max_abs_err": err, "flags": flags})
    for name, lengths in HW_BLOCK_SWEEP.items():
        series, n, p = cases[name]
        x = torch.tensor(series[:n], device=device)
        out = torch.empty(3, dtype=torch.float64, device=device)
        for block_len in lengths:
            holt_winters._launch(x, p, holt_winters.STEPS, out, block_len)
            got = out.tolist()
            err = max(abs(a - b) for a, b in zip(got, plain[name]))
            if err > HW_TOL:
                fail(f"holt_winters_parity: {name} in blocks of {block_len}: kernel {got} vs "
                     f"plain {plain[name]} (err {err})")
            worst = max(worst, err)
            rows.append({"case": f"{name}_blocks_of_{block_len}", "n": n, "p": p,
                         "blocks": holt_winters.blocking(n, p, block_len), "max_abs_err": err})
    for name in sorted(cases, key=lambda k: cases[k][1])[-2:]:  # the two longest
        series, n, p = cases[name]
        x = torch.tensor(series[:n], device=device)
        got = holt_winters.fit(x, p, steps=10)
        want = holt_winters.fit_plain(x, p, steps=10)
        err = (got - want).abs().max().item()
        if err > HW_TOL:
            fail(f"holt_winters_parity: {name}, 10 steps: kernel {got.tolist()} vs plain "
                 f"on the card {want.tolist()}")
        worst = max(worst, err)
        rows.append({"case": f"{name}_10_steps_plain_on_card", "n": n, "p": p,
                     "max_abs_err": err})
    return {"cases": rows, "max_abs_err": worst}


def holt_winters_timing(cases: dict, device) -> list:
    """K9 at HW_TIMED's shapes: the kernel alone (CUDA events, the median of
    25 after a warm launch) at its default blocks, one wrapper call with
    its fetch, the plain version's 10 steps on the card scaled to 300,
    and two chains at the f64 latencies
    measured here and the card's top SM clock: ``bound_ms``, the least any
    evaluation needs (per step, ceil(log2 n) dependent operations to
    combine the n points into the last state, one to join its residual
    term to the gradient, and the update's sqrt, divide and exp;
    csrc/holt_winters.cu), and ``serial_chain_ms``, a point-by-point
    evaluation's (one dependent FMA a point and step). Fails if the kernel
    beats its bound."""
    import torch

    from deequ_tpu_torch.ops import holt_winters

    cycles = holt_winters.op_cycles(device)
    clock_hz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60).stdout.split()[0]) * 1e6
    card = nvidia_smi_line()
    steps = holt_winters.STEPS
    out = []
    for name in HW_TIMED:
        series, n, p = cases[name]
        x = torch.tensor(series[:n], device=device)
        buf = torch.empty(3, dtype=torch.float64, device=device)
        kernel_ms = time_cuda(lambda: holt_winters._launch(x, p, steps, buf), reps=25, warmup=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        holt_winters.fit(x, p).cpu()
        call_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        holt_winters.fit_plain(x, p, steps=10)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3 * steps / 10
        step_cycles = ((math.ceil(math.log2(n)) + 1) * cycles["fma"]
                       + cycles["sqrt"] + cycles["div"] + cycles["exp"])
        bound_ms = steps * step_cycles / clock_hz * 1e3
        serial_chain_ms = n * steps * cycles["fma"] / clock_hz * 1e3
        if bound_ms > kernel_ms:
            fail(f"holt_winters_timing: {name}: the kernel ({kernel_ms} ms) beats its "
                 f"bound ({bound_ms} ms): the bound is wrong")
        block_len, blocks = holt_winters.blocking(n, p)
        out.append({"column": name, "n": n, "p": p, "steps": steps,
                    "block_len": block_len, "blocks": blocks,
                    "kernel_ms": kernel_ms, "call_ms": call_ms, "plain_ms": plain_ms,
                    "plain_ms_from": "10 steps on the card, x 30",
                    "bound_ms": bound_ms, "bound_by": "operations",
                    "bound_share": bound_ms / kernel_ms,
                    "bound_cycles_a_step": step_cycles,
                    "serial_chain_ms": serial_chain_ms,
                    "kernel_over_serial_chain": kernel_ms / serial_chain_ms,
                    "latency_cycles": cycles, "sm_clock_max_hz": clock_hz,
                    "card": card, "library_ms": None})
    return out


def repository_path(table, main_result, seed: int, device) -> dict:
    """Phase ``repository_path`` (module doc): the plain Holt-Winters fits
    on the host's CPU (the parity cases', the daily run's and the fleet
    monitor's) started first; the fleet's repository and the daily run
    while the long fits finish; then the kernel held against them and
    timed. ``plain_cpu_wall_s`` is the fits' wall from their start, beside
    the card's work."""
    from deequ_tpu_torch.ops import holt_winters

    history = daily_history(seed)
    cases = hw_parity_cases(seed)
    jobs = {name: (list(s[:n]), p, holt_winters.STEPS) for name, (s, n, p) in cases.items()}
    jobs["daily_run"] = (list(history["completeness_f1"]), 7, holt_winters.STEPS)
    jobs["fleet_monitor"] = (list(fleet_completeness_f1()[:14]), 7, holt_winters.STEPS)
    with plain_fits_on_host(jobs) as fits:
        # the fleet and the daily run need one short fit each: they run
        # on the card while the parity cases' long fits finish
        t0 = time.perf_counter()
        fleet = fleet_history(main_result, fits.get("fleet_monitor"), seed, device)
        fleet["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        daily = daily_run(table, history, fits.get("daily_run"), seed, device)
        daily["seconds"] = time.perf_counter() - t0
        plain = fits.all()
        plain_s = time.perf_counter() - fits.t0
    t0 = time.perf_counter()
    parity = holt_winters_parity(cases, plain, device)
    timing = holt_winters_timing(cases, device)
    hw_s = time.perf_counter() - t0
    return {
        "phase": "repository_path",
        "holt_winters_parity": {**parity, "plain_cpu_fits": len(jobs),
                                "plain_cpu_wall_s": plain_s, "kernel_side_s": hw_s,
                                "plain_fits_beside": ["fleet_history", "daily_run"]},
        "daily_run": daily,
        "fleet_history": fleet,
        "kernel_launches": {
            "holt_winters": (daily["kernel_launches"]["holt_winters"]
                             + fleet["kernel_launches"]["holt_winters"]),
            "bincount": daily["kernel_launches"]["bincount"],
            "fused_bincount": daily["kernel_launches"]["fused_bincount"],
            "hll": daily["kernel_launches"]["hll"],
            **{k: daily["kernel_launches"][k] + fleet["kernel_launches"][k]
               for k in ("k1", "k1_merge")},
        },
    }, timing


# -- phase 16: profile_path --------------------------------------------------

#: zip codes of the profile's table: five-digit numeric strings
PROFILE_ZIPS = 40_000
#: rows of the suggestion run held against the CPU's
SUGGEST_CPU_ROWS = 1_000_000
SUGGEST_TEST_RATIO = 0.1
SCHEMA_ROWS = 100_000
#: relative bounds of the profile's floating fields (PERF.md §2)
_PROFILE_REL = {"sum": 1e-12, "mean": 1e-12, "std_dev": 1e-10}


def with_zip_column(table, seed: int):
    """The main table with ``zip``: five-digit numeric strings from a
    dictionary of 40,000 codes, 1% null, which the profile infers
    integral and casts."""
    import numpy as np

    from deequ_tpu_torch.data.table import Column, DType

    rng = np.random.default_rng(seed + 10)
    zips = np.sort(rng.choice(100_000, PROFILE_ZIPS, replace=False))
    codes = rng.integers(0, PROFILE_ZIPS, size=table.num_rows).astype(np.int32)
    codes[rng.random(table.num_rows) < 0.01] = -1
    return table.with_column(Column("zip", DType.STRING, codes=codes, dictionary=np.array(
        [f"{z:05d}" for z in zips], dtype=object)))


def profile_numpy(table) -> dict:
    """What the profile must hold, computed with numpy: {column: fields}."""
    import numpy as np

    from deequ_tpu_torch.data.table import DType

    n = table.num_rows
    out = {}
    for name in table.column_names:
        col = table[name]
        want = {"completeness": float(col.mask.sum()) / n}
        if col.dtype == DType.STRING:
            valid = col.codes >= 0
            if name == "zip":
                lut = np.array([float(v) for v in col.dictionary])
                v = lut[col.codes[valid]]
                want["type_counts"] = {"Unknown": int((~valid).sum()), "Fractional": 0,
                                       "Integral": int(valid.sum()), "Boolean": 0,
                                       "String": 0}
            else:
                v = None
                want["type_counts"] = {"Unknown": int((~valid).sum()), "Fractional": 0,
                                       "Integral": 0, "Boolean": 0,
                                       "String": int(valid.sum())}
            if name == "status":
                counts = np.bincount(col.codes[valid], minlength=len(col.dictionary))
                want["histogram"] = {str(col.dictionary[i]): (int(c), int(c) / n)
                                     for i, c in enumerate(counts) if c}
                if not valid.all():
                    want["histogram"]["NullValue"] = (int((~valid).sum()),
                                                      int((~valid).sum()) / n)
        else:
            v = col.values[col.mask].astype(np.float64)
        if v is not None:
            want.update(minimum=float(v.min()), maximum=float(v.max()), sum=float(v.sum()),
                        mean=float(v.mean()), std_dev=float(v.std()))
        out[name] = want
    return out


def check_profile(profiles, want: dict, label: str = "profile_path") -> float:
    """The profile against numpy (module doc); returns the worst relative
    error of the toleranced fields. ``label`` names the phase in a failure."""
    from deequ_tpu_torch.profiles import NumericColumnProfile

    if set(profiles.profiles) != set(want):
        fail(f"{label}: profiled {sorted(profiles.profiles)}")
    worst = 0.0
    for name, w in want.items():
        p = profiles.profiles[name]
        if p.completeness != w["completeness"]:
            fail(f"{label}: {name} completeness {p.completeness} != {w['completeness']}")
        if "type_counts" in w and p.type_counts != w["type_counts"]:
            fail(f"{label}: {name} type counts {p.type_counts} != {w['type_counts']}")
        hist = None if p.histogram is None else {
            k: (v.absolute, v.ratio) for k, v in p.histogram.values.items()}
        if hist != w.get("histogram"):
            fail(f"{label}: {name} histogram {hist} != numpy {w.get('histogram')}")
        numeric = "minimum" in w
        if numeric != isinstance(p, NumericColumnProfile):
            fail(f"{label}: {name} profiled as {type(p).__name__}")
        if not numeric:
            continue
        if (p.minimum, p.maximum) != (w["minimum"], w["maximum"]):
            fail(f"{label}: {name} min/max {p.minimum}, {p.maximum} != numpy "
                 f"{w['minimum']}, {w['maximum']}")
        for field, bound in _PROFILE_REL.items():
            have, exp = getattr(p, field), w[field]
            rel = abs(have - exp) / max(abs(exp), 1e-300)
            worst = max(worst, rel)
            if not rel <= bound:
                fail(f"{label}: {name} {field} {have!r} vs numpy {exp!r}, rel {rel:.3g}")
        if p.kll is None or len(p.approx_percentiles) != 100:
            fail(f"{label}: {name} has no KLL profile")
    zip_type = profiles.profiles["zip"].data_type.value
    if zip_type != "Integral" or not profiles.profiles["zip"].is_data_type_inferred:
        fail(f"{label}: zip inferred {zip_type}, want Integral")
    return worst


class PersistSpy:
    """While active, times every ``persist_table`` (wall to a device
    synchronisation, resident bytes, chunk rows) and measures what each
    eviction frees (``torch.cuda.memory_allocated`` before and after)."""

    def __init__(self, device):
        self.device = device
        self.persists = []
        self.evictions = []

    def __enter__(self):
        from deequ_tpu_torch.ops import scan_engine

        self._persist, self._evict = scan_engine.persist_table, scan_engine._evict_device_cache

        def persist(table, device=None, **kwargs):
            import torch

            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cache = self._persist(table, device, **kwargs)
            self.persists.append({"wall_s": time.perf_counter() - t0, "bytes": cache.nbytes,
                                  "chunk_rows": cache.chunk,
                                  "chunks": len(cache.device_chunks)})
            return cache

        def evict(table):
            import torch

            if not table.is_persisted:
                return self._evict(table)
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated(self.device)
            nbytes = self._evict(table)
            torch.cuda.synchronize()
            self.evictions.append({"bytes": nbytes, "freed_bytes":
                                   before - torch.cuda.memory_allocated(self.device)})
            return nbytes

        scan_engine.persist_table, scan_engine._evict_device_cache = persist, evict
        return self

    def __exit__(self, *exc):
        from deequ_tpu_torch.ops import scan_engine

        scan_engine.persist_table, scan_engine._evict_device_cache = self._persist, self._evict


class TimedRuns:
    """The profiler's default pass executor, each pass timed to a device
    synchronisation and its AnalyzerContext kept."""

    def __init__(self, device):
        from deequ_tpu_torch.profiles import OfflineProfileRuns

        self.inner = OfflineProfileRuns({"device": device})
        self.walls = []
        self.contexts = []

    def run(self, table, analyzers):
        import torch

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ctx = self.inner.run(table, analyzers)
        torch.cuda.synchronize()
        self.walls.append(time.perf_counter() - t0)
        self.contexts.append(ctx)
        return ctx


def _same_bits(a, b) -> bool:
    import numpy as np

    return all(np.array_equal(np.asarray(x, np.float64).view(np.uint64),
                              np.asarray(y, np.float64).view(np.uint64))
               for x, y in zip(a, b)) and len(a) == len(b)


def profile_sketches_vs_streaming(table, profiles, pass1, resident_chunk: int, device) -> dict:
    """Every ApproxCountDistinct of the profile bit for bit a streaming
    ``do_analysis_run`` of the same analyzers, and every KLL profile bit
    for bit a streaming scan (K3, the sort) of the cast table cut at the
    resident chunk's rows."""
    from deequ_tpu_torch.analyzers import ApproxCountDistinct, KLLSketch
    from deequ_tpu_torch.analyzers.runner import AnalysisRunner
    from deequ_tpu_torch.data.cast import cast_string_column
    from deequ_tpu_torch.data.table import DType
    from deequ_tpu_torch.ops.scan_engine import SCAN_STATS, run_scan

    acd = [ApproxCountDistinct(c) for c in table.column_names]
    SCAN_STATS.reset()
    streamed = AnalysisRunner.do_analysis_run(table, acd, device)
    if SCAN_STATS.resident_passes or table.is_persisted:
        fail("profile_path: the streaming comparison read resident chunks")
    for a in acd:
        want = streamed.metric_map[a].value.get()
        have = pass1.metric_map[a].value.get()
        if have != want or profiles.profiles[a.column].approximate_num_distinct_values != int(
                round(want)):
            fail(f"profile_path: {a!r} {have!r} != streamed {want!r}")
    casted = table.with_column(cast_string_column(table["zip"], DType.INTEGRAL))
    kll = [KLLSketch(c) for c, p in profiles.profiles.items() if getattr(p, "kll", None)]
    exec_ops, plan = AnalysisRunner._coalesce_scan_ops([a.scan_op(casted) for a in kll])
    SCAN_STATS.reset()
    results = run_scan(casted, exec_ops, device, chunk_rows=resident_chunk)
    if SCAN_STATS.resident_passes or SCAN_STATS.device_select_passes:
        fail("profile_path: the K3 comparison did not stream and sort")
    for a, (i, ex) in zip(kll, plan):
        want = a.compute_metric_from(
            a.state_from_scan_result(ex(results[i]) if ex else results[i])).value.get()
        have = profiles.profiles[a.column].kll
        same = (have.parameters == want.parameters and _same_bits(have.data, want.data)
                and [(b.low_value, b.high_value, b.count) for b in have.buckets]
                == [(b.low_value, b.high_value, b.count) for b in want.buckets])
        if not same:
            fail(f"profile_path: the KLL profile of {a.column} (K4, resident) != K3 streamed")
    return {"approx_count_distinct_checked": len(acd), "kll_checked": len(kll),
            "kll_sort_chunk_rows": resident_chunk}


def suggest(table, device, seed: int):
    from deequ_tpu_torch.suggestions import (
        ConstraintSuggestionRunner,
        Rules,
        UniqueIfApproximatelyUniqueRule,
    )

    return (ConstraintSuggestionRunner.on_data(table, device)
            .add_constraint_rules(Rules.DEFAULT)
            .add_constraint_rule(UniqueIfApproximatelyUniqueRule())
            .use_train_test_split_with_test_set_ratio(SUGGEST_TEST_RATIO, seed)
            .run())


def suggestion_runs(table, seed: int, device) -> dict:
    """Suggestions over the table's first 10^6 rows on the card, equal as
    text to the port's own run on the CPU (suggestions, code and the
    held-out statuses), then over the whole table, timed."""
    import torch

    head = slice_rows(table, 0, min(SUGGEST_CPU_ROWS, table.num_rows))
    t0 = time.perf_counter()
    card = suggest(head, device, seed)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = suggest(head, "cpu", seed)
    cpu_s = time.perf_counter() - t0
    if (card.suggestions_as_json(), card.evaluation_as_json()) != (
            cpu.suggestions_as_json(), cpu.evaluation_as_json()):
        fail("suggestions: the card's run at 10^6 rows != the CPU's")
    if card.verification_result.device != str(device) or not card.all_suggestions:
        fail("suggestions: the held-out run did not run on the card")
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        full = suggest(table, device, seed)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    statuses = json.loads(full.evaluation_as_json())["constraint_suggestions"]
    return {
        "cpu_check_rows": head.num_rows, "card_equals_cpu": True,
        "suggestions_at_cpu_check_rows": len(card.all_suggestions),
        "card_wall_s_at_cpu_check_rows": card_s, "cpu_wall_s": cpu_s,
        "rows": table.num_rows, "suggestions": len(full.all_suggestions),
        "codes": [s.code_for_constraint for s in full.all_suggestions],
        "held_out_statuses": {k: sum(s["evaluation_status"] == k for s in statuses)
                              for k in ("Success", "Failure")},
        "suggest_wall_s": walls,
    }


def schema_flow(seed: int, device) -> dict:
    """A 10^5-row raw string table through ``RowLevelSchemaValidator``;
    the valid rows verified on the card against numpy."""
    import numpy as np

    from deequ_tpu_torch import Check, CheckLevel, CheckStatus, VerificationSuite
    from deequ_tpu_torch.data.table import ColumnarTable
    from deequ_tpu_torch.schema import RowLevelSchema, RowLevelSchemaValidator

    rng = np.random.default_rng(seed + 20)
    n = SCHEMA_ROWS
    ids = rng.integers(-50, 5000, size=n).astype(str).astype(object)
    ids[rng.random(n) < 0.03] = "n/a"
    ids[rng.random(n) < 0.01] = None
    amounts = np.char.mod("%.3f", rng.normal(100, 80, size=n)).astype(object)
    days = np.char.add(np.char.add("2024-", np.char.zfill(
        rng.integers(1, 13, size=n).astype(str), 2)), np.char.add("-", np.char.zfill(
            rng.integers(1, 32, size=n).astype(str), 2))).astype(object)
    raw = ColumnarTable.from_pydict({"id": list(ids), "amount": list(amounts),
                                     "day": list(days)})
    schema = (RowLevelSchema()
              .with_int_column("id", is_nullable=False, min_value=0, max_value=4000)
              .with_decimal_column("amount", precision=6, scale=3)
              .with_timestamp_column("day", mask="yyyy-MM-dd"))
    t0 = time.perf_counter()
    split = RowLevelSchemaValidator.validate(raw, schema)
    validate_s = time.perf_counter() - t0
    valid = split.valid_rows
    if split.num_valid_rows + split.num_invalid_rows != n or not 0 < split.num_valid_rows < n:
        fail(f"schema: {split.num_valid_rows} valid and {split.num_invalid_rows} invalid rows")
    v = valid["id"].values
    check = (Check(CheckLevel.ERROR, "quarantined")
             .has_size(lambda s: s == valid.num_rows).is_complete("id")
             .has_min("id", lambda m: m == float(v.min()))
             .has_max("id", lambda m: m == float(v.max()))
             .has_sum("amount", lambda s: abs(s - float(valid["amount"].values.sum()))
                      <= 1e-12 * abs(float(valid["amount"].values.sum()))))
    result = VerificationSuite.on_data(valid, device).add_check(check).run()
    if result.device != str(device) or result.status != CheckStatus.SUCCESS:
        fail(f"schema: the valid rows' check ran on {result.device}: {result.status}")
    return {"rows": n, "valid_rows": split.num_valid_rows, "validate_s": validate_s}


def applicability_flow(table, device) -> dict:
    """``Applicability`` on the main check over random data of the main
    table's schema: on the card, the same verdict, failures and
    constraint verdicts as on the CPU."""
    from deequ_tpu_torch import VerificationSuite

    from deequ_tpu_torch import use_device

    got = {}
    for dev in (device, "cpu"):
        with use_device(dev):
            res = VerificationSuite.is_check_applicable_to_data(build_check(), table.schema)
        got[str(dev)] = (res.is_applicable, [(a, type(e).__name__) for a, e in res.failures],
                         res.constraint_applicabilities)
    card, cpu = got[str(device)], got["cpu"]
    if card != cpu:
        fail(f"applicability: the card's verdict {card[:2]} != the CPU's {cpu[:2]}")
    return {"is_applicable": card[0], "failures": card[1],
            "constraints": len(card[2]), "applicable_constraints": sum(card[2].values())}


def migration_flow(device) -> dict:
    """examples/deequ_migration_example.py on the card: a legacy
    repository JSON imported, a run whose anomaly check reads it."""
    import numpy as np

    from deequ_tpu_torch import CheckLevel, CheckStatus, VerificationSuite
    from deequ_tpu_torch.analyzers import Size
    from deequ_tpu_torch.anomaly import RelativeRateOfChangeStrategy
    from deequ_tpu_torch.data.table import ColumnarTable
    from deequ_tpu_torch.interop import import_repository_json
    from deequ_tpu_torch.repository import InMemoryMetricsRepository, ResultKey
    from deequ_tpu_torch.verification import AnomalyCheckConfig

    legacy = [{"resultKey": {"dataSetDate": day, "tags": {"dataset": "orders"}},
               "analyzerContext": {"metricMap": [{
                   "analyzer": {"analyzerName": "Size", "where": None},
                   "metric": {"metricName": "DoubleMetric", "entity": "Dataset",
                              "instance": "*", "name": "Size", "value": 1000.0 + day}}]}}
              for day in range(1, 5)]
    repository = InMemoryMetricsRepository()
    imported = import_repository_json(json.dumps(legacy), repository)
    statuses = {}
    for rows, label in ((1005, "continuous"), (10, "collapsed")):
        result = (VerificationSuite.on_data(
            ColumnarTable.from_pydict({"v": list(np.arange(float(rows)))}), device)
            .use_repository(repository)
            .add_anomaly_check(RelativeRateOfChangeStrategy(max_rate_decrease=0.5,
                                                            max_rate_increase=2.0),
                               Size(), AnomalyCheckConfig(CheckLevel.WARNING, "size"))
            .run())
        if result.device != str(device):
            fail(f"migration: ran on {result.device}")
        statuses[label] = result.status.value
    if imported != 4 or statuses != {"continuous": CheckStatus.SUCCESS.value,
                                     "collapsed": CheckStatus.WARNING.value}:
        fail(f"migration: {imported} results imported, statuses {statuses}")
    return {"imported_results": imported, "anomaly_status": statuses}


def profile_path(table, seed: int, device) -> dict:
    """Phase ``profile_path`` (module doc): the column profiler over the
    main table with ``zip``, then the suggestions and the small flows."""
    import torch

    from deequ_tpu_torch.ops import histogram_device, hll, select_device
    from deequ_tpu_torch.ops.scan_engine import SCAN_STATS, total_resident_bytes
    from deequ_tpu_torch.profiles import ColumnProfilerRunner

    t0 = time.perf_counter()
    ptable = with_zip_column(table, seed)
    want = profile_numpy(ptable)
    numpy_s = time.perf_counter() - t0

    # the checked profile: counts set to 0 just before, read just after
    torch.cuda.reset_peak_memory_stats(device)
    SCAN_STATS.reset()
    histogram_device.LAUNCHES = hll.LAUNCHES = select_device.LAUNCHES = 0
    histogram_device.FUSED_LAUNCHES = 0
    k1_zero()
    watch = watch_cpu_ops()
    t0 = time.perf_counter()
    with watch, PersistSpy(device) as persist, ResidentSpy() as resident_counts:
        profiles = ColumnProfilerRunner.on_data(ptable, device).with_kll_profiling().run()
    first_s = time.perf_counter() - t0
    launches = {"bincount": histogram_device.LAUNCHES,
                "fused_bincount": histogram_device.FUSED_LAUNCHES, "hll": hll.LAUNCHES,
                "select": select_device.LAUNCHES, **k1_counts()}
    k1_require(launches, "profile_path")
    if launches["fused_bincount"]:
        fail(f"profile_path: the profiler groups no sets, yet K7 launched "
             f"{launches['fused_bincount']} times")
    stats = SCAN_STATS.snapshot()
    peak = torch.cuda.max_memory_allocated(device)
    if watch.cpu_ops:
        fail(f"profile_path: torch operations computed on CPU tensors: {watch.cpu_ops}")
    if stats["scan_passes"] != 2 or stats["resident_passes"] != 2 or stats["bytes_packed"]:
        fail(f"profile_path: {stats['resident_passes']} of {stats['scan_passes']} scans "
             f"resident, {stats['bytes_packed']} bytes packed (want 2 of 2 and 0)")
    if resident_counts.calls < 1:
        fail("profile_path: pass 3's histogram did not count from resident codes")
    if min(v for k, v in launches.items() if k != "fused_bincount") < 1:
        fail(f"profile_path: a kernel of the path did not launch: {launches}")
    if len(persist.persists) != 2 or len(persist.evictions) != 2 or any(
            e["freed_bytes"] < e["bytes"] for e in persist.evictions) or (
            total_resident_bytes() != 0 or ptable.is_persisted):
        fail(f"profile_path: persisted {persist.persists}, freed {persist.evictions}")
    worst = check_profile(profiles, want)

    walls, pass_walls, persist_walls = [], [], []
    for _ in range(TIMED_REPEATS):
        runs = TimedRuns(device)
        with PersistSpy(device) as spy:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            again = (ColumnProfilerRunner.on_data(ptable, device).with_kll_profiling()
                     .with_runs(runs).run())
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        pass_walls.append(runs.walls)
        persist_walls.append([p["wall_s"] for p in spy.persists])
    if again.to_json() != profiles.to_json():
        fail("profile_path: a later profile differs from the checked one")
    sketches = profile_sketches_vs_streaming(ptable, profiles, runs.contexts[0],
                                             persist.persists[1]["chunk_rows"], device)
    t0 = time.perf_counter()
    suggestions = suggestion_runs(ptable, seed, device)
    suggestions["seconds"] = time.perf_counter() - t0
    return {
        "phase": "profile_path", "rows": ptable.num_rows, "columns": len(ptable.column_names),
        "numeric_profiles": sum(bool(getattr(p, "kll", None))
                                for p in profiles.profiles.values()),
        "histograms": sorted(k for k, p in profiles.profiles.items() if p.histogram),
        "worst_rel_err": worst, "kernel_launches": launches, "scan_stats": stats,
        "resident_string_counts": resident_counts.calls,
        "persist": persist.persists, "unpersist": persist.evictions,
        "peak_device_bytes": peak, "first_profile_s_watched": first_s,
        "profile_wall_s_median": statistics.median(walls), "profile_wall_s": walls,
        "pass_wall_s": pass_walls, "persist_wall_s": persist_walls,
        "sketches_vs_streaming": sketches, "numpy_reference_s": numpy_s,
        "suggestions": suggestions, "schema": schema_flow(seed, device),
        "applicability": applicability_flow(table, device),
        "migration": migration_flow(device),
    }


# -- phase 17: out_of_core_path ------------------------------------------------

#: part 1's stream batch rows, and part 4's Parquet row groups
OOC_BATCH_ROWS = 1 << 20
#: part 2: BASELINE.md config 3's full rows, made a batch at a time
SKETCH_STREAM_ROWS = 100_000_000
SKETCH_STREAM_BATCH_ROWS = 1 << 17
#: host threads making a generated batch's columns (numpy releases the
#: interpreter lock while it draws and reduces)
SKETCH_STREAM_THREADS = 6
#: part 2's sampling allowance on a quantile's rank, in standard errors of
#: an empirical CDF (5 / sqrt(valid rows))
RANK_SAMPLING_SIGMAS = 5.0
#: the host memory a stream may grow by: a tenth of the bytes it streams
RSS_SHARE_OF_STREAM = 0.1


class RssSampler:
    """The host's resident set size, sampled from /proc/self/statm every
    5 ms on a thread while active; ``growth`` is the peak less the size at
    entry."""

    def __enter__(self):
        import threading

        self._page = os.sysconf("SC_PAGE_SIZE")
        self.base = self.peak = self._read()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _read(self) -> int:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * self._page

    def _run(self) -> None:
        while not self._stop.wait(0.005):
            self.peak = max(self.peak, self._read())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self._read())

    @property
    def growth(self) -> int:
        return self.peak - self.base


def bits_of(values: dict) -> dict:
    """Each value of ``metric_values`` by its bits (a float) or its repr."""
    import struct

    return {k: struct.pack("<d", v) if isinstance(v, float) else repr(v)
            for k, v in values.items()}


def differing_bits(want: dict, have: dict) -> list:
    """The metrics of two runs whose values differ in their bits."""
    want, have = bits_of(want), bits_of(have)
    return sorted(str(k) for k in set(want) | set(have) if want.get(k) != have.get(k))


def scan_chunk_rows(table, analyzers) -> int:
    """The chunk rows an in-memory run of ``analyzers`` cuts ``table`` at:
    the engine's rule over the columns its fused scan reads."""
    from deequ_tpu_torch.analyzers.base import ScanShareableAnalyzer
    from deequ_tpu_torch.ops.scan_engine import _auto_chunk_rows

    needed = set()
    for a in analyzers:
        if isinstance(a, ScanShareableAnalyzer):
            needed |= set(a.scan_op(table).columns)
    return min(_auto_chunk_rows({n: table[n] for n in needed}), table.num_rows)


def timed_runs(suite, count: int = 4) -> list:
    """Walls of ``count`` runs of ``suite`` (the first one warm), each to a
    device synchronisation."""
    import torch

    walls = []
    for _ in range(count):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        suite.run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return walls


def ooc_config2(table, main_result, device, smi: str):
    """Part 1: the main suite over config 2's table as a stream of 2^20-row
    batches, against numpy and the in-memory run; a stream cut at the
    in-memory run's chunk rows bit for bit that run. Returns (the part's
    line, the streamed result)."""
    import torch

    from deequ_tpu_torch import stream_table
    from deequ_tpu_torch.analyzers import CountDistinct
    from deequ_tpu_torch.ops.scan_engine import SCAN_STATS

    label = "out_of_core_path/config2_stream"
    t0 = time.perf_counter()
    expected = expected_metrics(table)
    numpy_s = time.perf_counter() - t0
    suite = build_suite(stream_table(table, batch_rows=OOC_BATCH_ROWS))

    # the checked run: counts set to 0 just before, read just after
    torch.cuda.reset_peak_memory_stats(device)
    kernel_counts_zero()
    watch = watch_cpu_ops()
    t0 = time.perf_counter()
    with watch, RssSampler() as rss:
        result = suite.run()
    first_s = time.perf_counter() - t0
    launches = kernel_counts()
    stats = SCAN_STATS.snapshot()
    peak = torch.cuda.max_memory_allocated(device)
    k1_require(launches, label)
    if launches["bincount"] < 1:
        fail(f"{label}: the groupings' batch counts never launched K5")
    if launches["fused_bincount"]:
        fail(f"{label}: a stream's grouping sets fuse nothing, yet K7 launched "
             f"{launches['fused_bincount']} times")
    if watch.cpu_ops:
        fail(f"{label}: torch operations computed on CPU tensors: {watch.cpu_ops}")
    if result.device != str(device):
        fail(f"{label}: ran on {result.device}, expected {device}")
    chunks = -(-table.num_rows // OOC_BATCH_ROWS)
    if stats["scan_passes"] != 1 or stats["last_scan_fetches"] != 1:
        fail(f"{label}: {stats['scan_passes']} scans, {stats['last_scan_fetches']} fetches "
             f"of the fused scan (want 1 and 1)")
    if stats["chunks_staged"] != chunks or stats["ingest_overlap_frac"] != (chunks - 1) / chunks:
        fail(f"{label}: {stats['chunks_staged']} chunks staged, overlap "
             f"{stats['ingest_overlap_frac']} (want {chunks}, {(chunks - 1) / chunks})")
    worst = check_metrics(result, expected)
    worst_vs_memory = compare_runs(metric_values(main_result), metric_values(result),
                                   f"{label} (the stream against the in-memory run)")

    # bit for bit: a stream cut at the in-memory run's chunk rows
    chunk = scan_chunk_rows(
        table, [CountDistinct(["customer_id"])] + build_check().required_analyzers())
    at_chunk = build_suite(stream_table(table, batch_rows=chunk)).run()
    differ = differing_bits(metric_values(main_result), metric_values(at_chunk))
    if differ:
        fail(f"{label}: a stream at the in-memory chunk rows ({chunk}) differs from the "
             f"in-memory run in the bits of {differ}")

    stream_walls = timed_runs(suite, 1 + TIMED_REPEATS)
    memory_walls = timed_runs(build_suite(table), 1 + TIMED_REPEATS)
    # the double buffer on the card: whether chunk k+1's copy ran while
    # chunk k's kernels did (ingest_overlap_frac counts only issue order)
    trace = trace_run(suite.run)
    return {
        "part": "config2_stream", "card": smi, "rows": table.num_rows,
        "batch_rows": OOC_BATCH_ROWS, "metrics_checked": len(expected),
        "worst_rel_err_vs_numpy": worst, "worst_rel_err_vs_in_memory": worst_vs_memory,
        "bit_for_bit_at_chunk_rows": {"chunk_rows": chunk, "metrics": len(expected)},
        "kernel_launches": launches, "chunks": stats["chunks_staged"],
        "fused_scan_fetches": stats["last_scan_fetches"],
        "device_fetches": stats["device_fetches"],
        "ingest_overlap_frac": stats["ingest_overlap_frac"],
        "bytes_staged": stats["bytes_staged"], "peak_device_bytes": peak,
        "host_rss_growth_bytes": rss.growth, "first_run_s_watched": first_s,
        "stream_warm_run_s": stream_walls[0],
        "stream_run_wall_s_median": statistics.median(stream_walls[1:]),
        "stream_run_wall_s": stream_walls[1:],
        "in_memory_warm_run_s": memory_walls[0],
        "in_memory_run_wall_s_median": statistics.median(memory_walls[1:]),
        "in_memory_run_wall_s": memory_walls[1:], "numpy_reference_s": numpy_s,
        "trace": trace,
    }, result


def chan_merge(a, b):
    """Chan's merge of two (n, mean_x, mean_y, m2x, m2y, cxy) co-moments."""
    na, mxa, mya, m2xa, m2ya, ca = a
    nb, mxb, myb, m2xb, m2yb, cb = b
    n = na + nb
    dx, dy = mxb - mxa, myb - mya
    return (n, mxa + dx * nb / n, mya + dy * nb / n,
            m2xa + m2xb + dx * dx * na * nb / n, m2ya + m2yb + dy * dy * na * nb / n,
            ca + cb + dx * dy * na * nb / n)


class SketchStream:
    """BASELINE.md config 3's width (make_sketch_table's columns) at
    ``rows`` rows from a GeneratorBatchSource: batch b is made from
    (seed, b, column) by ``threads`` host threads and dropped after its use,
    and numpy's answer accumulates as each batch passes — a column's f64
    sum a batch (folded with math.fsum at the end), counts, minima and
    maxima, the q0/q1 co-moments (Chan's merge), and exact counts of cust,
    flag and region by a bincount a batch — beside the batches' bytes.
    Each column's HLL registers also accumulate a batch, from K2's plain
    version on the card (:meth:`_plain_registers`, max-merged: registers
    are a max-monoid), so the run's registers can be held to them bit for
    bit."""

    #: numeric columns whose plain registers one scatter computes
    PLAIN_GROUP = 10

    N_CUST = 1_100_001

    def __init__(self, rows: int, batch_rows: int, seed: int, threads: int, device):
        import concurrent.futures
        import threading

        import numpy as np
        import torch

        from deequ_tpu_torch.ops import hll

        self.rows, self.batch_rows, self.seed = rows, batch_rows, seed
        self.device = device
        self.pool = concurrent.futures.ThreadPoolExecutor(threads)
        self._lock = threading.Lock()
        # one scattering of the Zipf ranks over cust's keys for the stream
        self.cust_keys = 1 + np.random.default_rng([seed, 1 << 20]).permutation(
            self.N_CUST - 1)
        self.region_dictionary = np.array([f"R{i:04d}" for i in range(5000)], dtype=object)
        self.names = [f"q{j}" for j in range(48)] + ["cust", "wide", "flag", "region"]
        self.numeric = self.names[:50]
        self.count = dict.fromkeys(self.names, 0)
        self.sums = {c: [] for c in self.numeric}
        self.mins = dict.fromkeys(self.numeric, math.inf)
        self.maxs = dict.fromkeys(self.numeric, -math.inf)
        self.cust_counts = np.zeros(self.N_CUST, dtype=np.int64)
        self.flag_counts = np.zeros(2, dtype=np.int64)
        self.region_counts = np.zeros(5000, dtype=np.int64)
        self.comoments = None  # (n, mean_x, mean_y, m2x, m2y, cxy) of q0, q1
        self.hll_p = hll.precision_from_relative_sd()
        self.hll_registers = {c: torch.zeros(1 << self.hll_p, dtype=torch.int32, device=device)
                              for c in self.names}
        # the plain version runs beside the scan, not queued behind it
        self.plain_stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        self.region_lut = torch.from_numpy(
            hll.string_idx_rank_lut(self.region_dictionary, self.hll_p)).to(device)
        self.stream_bytes = 0
        self.batches_made = 0
        # wall seconds the reader thread spent making batches, and running
        # K2's plain version over them
        self.make_seconds = 0.0
        self.plain_seconds = 0.0

    def source(self):
        from deequ_tpu_torch.data.source import GeneratorBatchSource
        from deequ_tpu_torch.data.table import DType, Field, Schema

        types = [DType.FRACTIONAL] * 48 + [DType.INTEGRAL, DType.INTEGRAL, DType.BOOLEAN,
                                           DType.STRING]
        schema = Schema([Field(n, t) for n, t in zip(self.names, types)])
        return GeneratorBatchSource(schema, self._batches, num_rows=self.rows)

    def _batches(self):
        for b, start in enumerate(range(0, self.rows, self.batch_rows)):
            yield self._batch(b, min(self.batch_rows, self.rows - start))

    def _plain_registers(self, cols) -> None:
        """K2's plain version over one batch on the card, max-merged into
        each column's registers. The numeric columns go as the scan packs
        them (f64, their masks) in groups of :data:`PLAIN_GROUP`: one
        ``hll.idx_rank`` over a group's rows and one
        ``hll.registers_from_idx_rank`` with each column's indices moved
        to a register file of its own — ``registers_plain``'s two steps,
        a call a group instead of a column, because a call costs ~100
        small launches whatever its rows; ``flag`` and ``region`` by
        ``registers_plain`` itself."""
        import contextlib

        import numpy as np
        import torch

        from deequ_tpu_torch.ops import hll

        p, dev, regs = self.hll_p, self.device, self.hll_registers
        numeric = [c for c in cols if c.name in self.numeric]
        other = {c.name: c for c in cols if c.name not in self.numeric}
        on = (torch.cuda.stream(self.plain_stream) if self.plain_stream is not None
              else contextlib.nullcontext())
        with on:
            for g in range(0, len(numeric), self.PLAIN_GROUP):
                group = numeric[g:g + self.PLAIN_GROUP]
                k, n = len(group), len(group[0].values)
                x = torch.from_numpy(np.stack([c.values.astype(np.float64, copy=False)
                                               for c in group])).to(dev)
                valid = torch.from_numpy(np.stack([c.mask for c in group])).to(dev)
                idx, rank, _ = hll.idx_rank(x.reshape(-1), p)
                idx = idx + (torch.arange(k, device=dev) << p).repeat_interleave(n)
                # a power-of-two register file with room for k columns
                files = hll.registers_from_idx_rank(idx, rank, valid.reshape(-1),
                                                    p + (k - 1).bit_length())
                for j, c in enumerate(group):
                    regs[c.name] = torch.maximum(regs[c.name], files[j << p:(j + 1) << p])
            flag = other["flag"]
            regs["flag"] = torch.maximum(regs["flag"], hll.registers_plain(
                torch.from_numpy(flag.values).to(dev), torch.from_numpy(flag.mask).to(dev), p))
            region = other["region"]
            regs["region"] = torch.maximum(regs["region"], hll.registers_plain(
                torch.from_numpy(region.codes).to(dev), None, p, self.region_lut))

    def _column(self, j: int, b: int, n: int):
        import numpy as np

        from deequ_tpu_torch.data.table import Column, DType

        name = self.names[j]
        rng = np.random.default_rng([self.seed, b, j])
        if name == "region":  # 0.5% null
            codes = rng.integers(0, 5000, size=n, dtype=np.int32)
            codes[rng.integers(0, 200, size=n, dtype=np.uint8) == 0] = -1
            valid = codes >= 0
            counts = np.bincount(codes[valid], minlength=5000)
            with self._lock:
                self.region_counts += counts
                self.count[name] += int(valid.sum())
                self.stream_bytes += codes.nbytes
            return Column(name, DType.STRING, codes=codes, dictionary=self.region_dictionary)
        mask = rng.integers(0, 100, size=n, dtype=np.uint8) != 0  # 1% null
        if name == "flag":
            values = rng.integers(0, 10, size=n, dtype=np.uint8) < 3
            valid, ones = int(mask.sum()), int(np.count_nonzero(values & mask))
            with self._lock:
                self.flag_counts += [valid - ones, ones]
                self.count[name] += valid
                self.stream_bytes += values.nbytes + mask.nbytes
            return Column(name, DType.BOOLEAN, values=values, mask=mask)
        counts = None
        if name == "cust":  # Zipf 0.7 ranks by inverse transform (zipf_ids)
            top = (self.N_CUST - 1) ** 0.3
            ranks = np.floor((rng.random(n) * (top - 1.0) + 1.0) ** (1.0 / 0.3)).astype(np.int64)
            keys = self.cust_keys[np.clip(ranks, 1, self.N_CUST - 1) - 1]
            values, dtype = 1000 + 3 * keys, DType.INTEGRAL
            counts = np.bincount(keys[mask], minlength=self.N_CUST)
        elif name == "wide":
            values, dtype = rng.integers(-(2 ** 40), 2 ** 40, size=n), DType.INTEGRAL
            mask = np.ones(n, dtype=bool)
        else:
            k = int(name[1:])
            values = (1e6 + rng.standard_normal(n) if k == 47
                      else rng.normal(10.0 * k + 5.0, 1.0 + k, size=n))
            dtype = DType.FRACTIONAL
        valid = values[mask]
        total, lo, hi = float(valid.sum()), float(valid.min()), float(valid.max())
        with self._lock:
            self.sums[name].append(total)
            self.mins[name] = min(self.mins[name], lo)
            self.maxs[name] = max(self.maxs[name], hi)
            self.count[name] += len(valid)
            self.stream_bytes += values.nbytes + mask.nbytes
            if counts is not None:
                self.cust_counts += counts
        return Column(name, dtype, values=values, mask=mask)

    def _batch(self, b: int, n: int):
        from deequ_tpu_torch.data.table import ColumnarTable

        t0 = time.perf_counter()
        cols = list(self.pool.map(lambda j: self._column(j, b, n), range(len(self.names))))
        both = cols[0].mask & cols[1].mask
        x, y = cols[0].values[both], cols[1].values[both]
        dx, dy = x - x.mean(), y - y.mean()
        part = (len(x), x.mean(), y.mean(), float(dx @ dx), float(dy @ dy), float(dx @ dy))
        self.comoments = part if self.comoments is None else chan_merge(self.comoments, part)
        self.batches_made += 1
        self.make_seconds += time.perf_counter() - t0
        t0 = time.perf_counter()
        self._plain_registers(cols)
        self.plain_seconds += time.perf_counter() - t0
        return ColumnarTable(cols)

    def close(self) -> None:
        self.pool.shutdown(wait=True)
        if self.plain_stream is not None:
            self.plain_stream.synchronize()

    def quantile_rank(self, column: str, v: float):
        """(low, high) of a value's rank share among the column's valid
        values: under the generating distribution for the normal columns and
        the uniform ``wide``, from the exact counts for ``cust``."""
        import numpy as np

        if column == "wide":
            k = math.floor(v)
            return (k + 2 ** 40) / 2 ** 41, (k + 1 + 2 ** 40) / 2 ** 41
        if column == "cust":
            cum = np.cumsum(self.cust_counts)
            key = (v - 1000) / 3
            k = math.floor(key)
            below = int(cum[k - 1]) if k >= 1 else 0
            upto = int(cum[k]) if key == k else below
            return below / cum[-1], upto / cum[-1]
        k = int(column[1:])
        mu, sigma = (1e6, 1.0) if k == 47 else (10.0 * k + 5.0, 1.0 + k)
        r = 0.5 * (1.0 + math.erf((v - mu) / (sigma * math.sqrt(2.0))))
        return r, r


def build_sketch_stream_check(table):
    """The sketch path's check (quantiles of every numeric column, the
    KLLSketch of q0, ApproxCountDistinct of every column, the correlation
    of q0 and q1) with the size and, on every numeric column, its
    completeness, min, max, sum and mean."""
    check = build_sketch_check(table).has_size(lambda n: n > 0)
    numeric, _ = sketch_columns(table)
    for c in numeric:
        check = (check.has_completeness(c, lambda v: v > 0.9).has_min(c, lambda v: True)
                 .has_max(c, lambda v: True).has_sum(c, lambda v: True)
                 .has_mean(c, lambda v: True))
    return check


def check_sketch_stream(stream: SketchStream, result, label: str) -> dict:
    """The 10^8-row run against numpy's answer (module doc, part 2)."""
    import numpy as np

    got = {}
    for analyzer, metric in result.metrics.items():
        if not metric.value.is_success:
            fail(f"{label}: metric failed: {metric}")
        got[(metric.name, metric.instance, getattr(analyzer, "quantile", None))] = (
            metric.value.get())
    rows = stream.rows
    if got[("Size", "*", None)] != float(rows):
        fail(f"{label}: Size {got[('Size', '*', None)]} != {rows}")
    worst_rel, worst_rank, worst_hll, worst_hll_column = 0.0, 0.0, 0.0, None
    for c in stream.numeric:
        m = stream.count[c]
        exact = {("Completeness", c, None): m / rows, ("Minimum", c, None): stream.mins[c],
                 ("Maximum", c, None): stream.maxs[c]}
        for key, want in exact.items():
            if got[key] != want:
                fail(f"{label}: {key} {got[key]!r} != numpy {want!r}")
        total = math.fsum(stream.sums[c])
        for key, want in ((("Sum", c, None), total), (("Mean", c, None), total / m)):
            rel = abs(got[key] - want) / max(abs(want), 1e-300)
            worst_rel = max(worst_rel, rel)
            if rel > 1e-12:
                fail(f"{label}: {key} {got[key]!r} vs numpy {want!r}, rel {rel:.3g} > 1e-12")
        allowance = SKETCH_RELATIVE_ERROR + RANK_SAMPLING_SIGMAS / math.sqrt(m)
        for q in SKETCH_QUANTILES:
            lo, hi = stream.quantile_rank(c, got[("ApproxQuantile", c, q)])
            err = 0.0 if lo <= q <= hi else min(abs(lo - q), abs(hi - q))
            worst_rank = max(worst_rank, err)
            if err > allowance:
                fail(f"{label}: ApproxQuantile({c}, {q}): rank {lo}..{hi}, error {err:.4g} "
                     f"> {allowance:.4g}")
    dist = got[("KLL", "q0", None)]
    if sum(b.count for b in dist.buckets) != stream.count["q0"] or len(dist.buckets) != 100:
        fail(f"{label}: KLLSketch(q0): buckets do not hold every valid row")
    distinct = {c: stream.count[c] for c in stream.names[:48]}
    # uniform draws over 2^41 integers: n^2 / 2^42 expected collisions
    distinct["wide"] = stream.count["wide"] - stream.count["wide"] ** 2 / 2 ** 42
    distinct["cust"] = int(np.count_nonzero(stream.cust_counts))
    distinct["flag"] = int(np.count_nonzero(stream.flag_counts))
    distinct["region"] = int(np.count_nonzero(stream.region_counts))
    for c, want in distinct.items():
        est = got[("ApproxCountDistinct", c, None)]
        rel = abs(est - want) / want
        if rel > worst_hll:
            worst_hll, worst_hll_column = rel, c
        if rel > 0.2:
            fail(f"{label}: ApproxCountDistinct({c}) = {est} vs {want}: rel {rel:.3g} > 0.2")
    _, _, _, m2x, m2y, cxy = stream.comoments
    corr = cxy / math.sqrt(m2x * m2y)
    corr_err = abs(got[("Correlation", "q0,q1", None)] - corr)
    if corr_err > 1e-10:
        fail(f"{label}: Correlation(q0, q1) {got[('Correlation', 'q0,q1', None)]!r} vs "
             f"numpy {corr!r}: {corr_err:.3g} > 1e-10")
    return {"metrics_checked": len(got), "worst_sum_mean_rel_err": worst_rel,
            "worst_quantile_rank_err": worst_rank,
            "quantile_rank_allowance": (f"relative_error {SKETCH_RELATIVE_ERROR} + "
                                        f"{RANK_SAMPLING_SIGMAS} / sqrt(valid rows)"),
            "worst_hll_rel_err": worst_hll, "worst_hll_column": worst_hll_column,
            "correlation_abs_err": corr_err}


def hold_sketch_registers(stream: SketchStream, result, states, label: str) -> int:
    """Each ApproxCountDistinct's saved registers bit for bit the plain
    version's, accumulated a batch by ``stream``; returns the columns held."""
    import numpy as np

    from deequ_tpu_torch.analyzers import ApproxCountDistinct

    held = 0
    for analyzer in result.metrics:
        if not isinstance(analyzer, ApproxCountDistinct):
            continue
        state = states.load(analyzer)
        want = stream.hll_registers[analyzer.column].cpu().numpy().astype(np.int64)
        got = None if state is None else np.asarray(state.registers, dtype=np.int64)
        if got is None or not np.array_equal(got, want):
            differ = None if got is None else int(np.count_nonzero(got != want))
            fail(f"{label}: ApproxCountDistinct({analyzer.column})'s registers differ from "
                 f"the plain version's a batch ({differ} of {want.size} registers)")
        held += 1
    if held != len(stream.names):
        fail(f"{label}: {held} HLL register files held, want {len(stream.names)}")
    return held


def ooc_config3(seed: int, device, smi: str, rows: int = SKETCH_STREAM_ROWS) -> dict:
    """Part 2: config 3's check at its full rows from a generator source;
    the host never holds the table."""
    import torch

    from deequ_tpu_torch import StreamingTable, VerificationSuite
    from deequ_tpu_torch.ops.scan_engine import SCAN_STATS, STREAM_FOLD_CAPACITY
    from deequ_tpu_torch.states import InMemoryStateProvider

    label = "out_of_core_path/config3_stream"
    stream = SketchStream(rows, SKETCH_STREAM_BATCH_ROWS, seed, SKETCH_STREAM_THREADS, device)
    table = StreamingTable(stream.source())
    states = InMemoryStateProvider()
    suite = (VerificationSuite.on_data(table).add_check(build_sketch_stream_check(table))
             .save_states_with(states))
    torch.cuda.reset_peak_memory_stats(device)
    kernel_counts_zero()
    try:
        with RssSampler() as rss:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = suite.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        stream.close()
    launches = kernel_counts()
    stats = SCAN_STATS.snapshot()
    peak = torch.cuda.max_memory_allocated(device)
    k1_require(launches, label)
    chunks = -(-rows // SKETCH_STREAM_BATCH_ROWS)
    if launches["hll"] != 52 * chunks:
        fail(f"{label}: {launches['hll']} HLL launches, want 52 columns x {chunks} chunks")
    if stats["kll_sort_passes"] != 2 * chunks:
        fail(f"{label}: {stats['kll_sort_passes']} KLL sorts, want 2 a chunk")
    drains = (chunks - 1) // STREAM_FOLD_CAPACITY
    if stats["fold_drains"] != drains or stats["device_fetches"] != drains + 1:
        fail(f"{label}: {stats['fold_drains']} drains, {stats['device_fetches']} fetches "
             f"(want {drains} and {drains + 1})")
    if drains and stats["kll_midscan_compactions"] < 1:
        fail(f"{label}: no KLL compaction at the fold's drains")
    if stream.batches_made != chunks or stats["rows_scanned"] != rows:
        fail(f"{label}: {stream.batches_made} batches, {stats['rows_scanned']} rows scanned")
    if rss.growth > RSS_SHARE_OF_STREAM * stream.stream_bytes:
        fail(f"{label}: host RSS grew {rss.growth} bytes, more than a tenth of the "
             f"{stream.stream_bytes} bytes streamed")
    held = check_sketch_stream(stream, result, label)
    held["hll_registers_bit_for_bit"] = hold_sketch_registers(stream, result, states, label)
    return {
        "part": "config3_stream", "card": smi, "rows": rows,
        "batch_rows": SKETCH_STREAM_BATCH_ROWS, "columns": len(stream.names),
        "generator_threads": SKETCH_STREAM_THREADS, **held,
        "run_wall_s": wall, "rows_per_s": rows / wall,
        "batch_making_s": stream.make_seconds, "plain_hll_s": stream.plain_seconds,
        "stream_bytes": stream.stream_bytes, "host_rss_growth_bytes": rss.growth,
        "host_rss_growth_share_of_stream": rss.growth / stream.stream_bytes,
        "peak_device_bytes": peak, "chunks": stats["chunks_staged"],
        "fold_capacity": STREAM_FOLD_CAPACITY, "fold_drains": stats["fold_drains"],
        "kll_midscan_compactions": stats["kll_midscan_compactions"],
        "kll_compactions": stats["kll_compactions"],
        "device_fetches": stats["device_fetches"],
        "ingest_overlap_frac": stats["ingest_overlap_frac"],
        "bytes_staged": stats["bytes_staged"],
        "kernel_launches": {**launches, "k3_kll_sorts": stats["kll_sort_passes"]},
    }


def ooc_profile(table, seed: int, device, smi: str) -> dict:
    """Part 3: the profiler over config 2's table with ``zip`` as a stream,
    against the in-memory profile and numpy, with nothing persisted."""
    import numpy as np
    import torch

    from deequ_tpu_torch import stream_table
    from deequ_tpu_torch.ops.scan_engine import SCAN_STATS, total_resident_bytes
    from deequ_tpu_torch.profiles import ColumnProfilerRunner

    label = "out_of_core_path/profile_stream"
    ptable = with_zip_column(table, seed)
    want = profile_numpy(ptable)
    in_memory = ColumnProfilerRunner.on_data(ptable, device).with_kll_profiling().run()
    stream = stream_table(ptable, batch_rows=OOC_BATCH_ROWS)
    torch.cuda.reset_peak_memory_stats(device)
    kernel_counts_zero()
    with PersistSpy(device) as persist:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        profiles = ColumnProfilerRunner.on_data(stream, device).with_kll_profiling().run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = kernel_counts()
    stats = SCAN_STATS.snapshot()
    peak = torch.cuda.max_memory_allocated(device)
    k1_require(launches, label)
    if launches["hll"] < 1 or launches["bincount"] < 1:
        fail(f"{label}: a kernel of the path did not launch: {launches}")
    if persist.persists or total_resident_bytes() != 0 or stats["resident_passes"]:
        fail(f"{label}: a stream was persisted: {persist.persists}, "
             f"{total_resident_bytes()} resident bytes")
    worst = check_profile(profiles, want, label)
    for name, p in profiles.profiles.items():
        m = in_memory.profiles[name]
        if (p.data_type, p.completeness, p.approximate_num_distinct_values) != (
                m.data_type, m.completeness, m.approximate_num_distinct_values):
            fail(f"{label}: {name} differs from the in-memory profile in its type, "
                 f"completeness or approximate distinct values")
    # each KLL percentile's rank among numpy's values (sorted on the card)
    worst_rank = 0.0
    for name, p in profiles.profiles.items():
        if not getattr(p, "kll", None):
            continue
        col = ptable[name]
        if col.dtype.value == "string":
            values = np.array([float(v) for v in col.dictionary])[col.codes[col.codes >= 0]]
        else:
            values = col.values[col.mask].astype(np.float64)
        ordered = torch.sort(torch.from_numpy(values).to(device)).values
        probe = torch.tensor(p.approx_percentiles, dtype=torch.float64, device=device)
        lo = torch.searchsorted(ordered, probe).cpu().numpy() / len(values)
        hi = torch.searchsorted(ordered, probe, right=True).cpu().numpy() / len(values)
        qs = np.arange(1, len(lo) + 1) / 100.0
        err = np.where((lo <= qs) & (qs <= hi), 0.0,
                       np.minimum(np.abs(lo - qs), np.abs(hi - qs)))
        worst_rank = max(worst_rank, float(err.max()))
    if worst_rank > SKETCH_RELATIVE_ERROR:
        fail(f"{label}: a KLL percentile's rank is {worst_rank:.4g} off, more than "
             f"{SKETCH_RELATIVE_ERROR}")
    return {"part": "profile_stream", "card": smi, "rows": ptable.num_rows,
            "columns": len(ptable.column_names), "batch_rows": OOC_BATCH_ROWS,
            "profile_wall_s": wall, "worst_rel_err_vs_numpy": worst,
            "worst_kll_percentile_rank_err": worst_rank,
            "kll_percentile_rank_bound": SKETCH_RELATIVE_ERROR,
            "persists": len(persist.persists), "resident_bytes": total_resident_bytes(),
            "kernel_launches": launches, "scan_passes": stats["scan_passes"],
            "chunks_staged": stats["chunks_staged"], "peak_device_bytes": peak}


def ooc_parquet(table, streamed_result, device, smi: str, cut: int = OOC_PARQUET_CUT) -> dict:
    """Part 4: config 2's table (its first rows over ``cut``) written by
    write_parquet_stream and read back by stream_parquet, bit for bit the
    same rows' table stream (part 1's when ``cut`` is 1) — where this host
    has pyarrow."""
    import shutil
    import tempfile

    import torch

    try:
        import pyarrow  # noqa: F401
    except ImportError:
        return {"part": "parquet", "card": smi,
                "parquet": "not run: no pyarrow on this machine"}
    from deequ_tpu_torch import stream_table
    from deequ_tpu_torch.data.io import stream_parquet, write_parquet_stream

    label = "out_of_core_path/parquet"
    if cut > 1:
        table = slice_rows(table, 0, table.num_rows // cut)
        streamed_result = build_suite(stream_table(table, OOC_BATCH_ROWS)).run()
    root = tempfile.mkdtemp(prefix="ooc_parquet_")
    try:
        path = os.path.join(root, "config2.parquet")
        t0 = time.perf_counter()
        written = write_parquet_stream(stream_table(table, OOC_BATCH_ROWS).batches(), path)
        write_s = time.perf_counter() - t0
        file_bytes = os.path.getsize(path)
        if written != table.num_rows:
            fail(f"{label}: wrote {written} rows of {table.num_rows}")
        kernel_counts_zero()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = build_suite(stream_parquet(path, batch_rows=OOC_BATCH_ROWS)).run()
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t0
        launches = kernel_counts()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    k1_require(launches, label)
    differ = differing_bits(metric_values(streamed_result), metric_values(result))
    if differ:
        fail(f"{label}: the Parquet stream differs from the table's stream in {differ}")
    return {"part": "parquet", "card": smi, "rows": written, "cut": cut,
            "row_group_rows": OOC_BATCH_ROWS, "file_bytes": file_bytes, "write_wall_s": write_s, "read_run_wall_s": read_s,
            "bit_for_bit_metrics": len(metric_values(result)), "kernel_launches": launches}


def out_of_core_path(table, main_result, seed: int, device, smi: str,
                     sketch_rows: int = SKETCH_STREAM_ROWS,
                     parquet_cut: int = OOC_PARQUET_CUT) -> dict:
    """Phase ``out_of_core_path`` (module doc): its four parts, each
    printed as a line of its own, each with the launch counts set to 0
    just before its checked run and read just after; returns (the launches
    summed over the parts and by part, config2_stream's result)."""
    parts = {}
    t0 = time.perf_counter()
    config2, streamed = ooc_config2(table, main_result, device, smi)
    emit({"phase": "out_of_core_path", **config2, "seconds": time.perf_counter() - t0})
    parts["config2_stream"] = config2
    for name, run in (("config3_stream", lambda: ooc_config3(seed, device, smi, sketch_rows)),
                      ("profile_stream", lambda: ooc_profile(table, seed, device, smi)),
                      ("parquet", lambda: ooc_parquet(table, streamed, device, smi,
                                                      parquet_cut))):
        t0 = time.perf_counter()
        part = run()
        emit({"phase": "out_of_core_path", **part, "seconds": time.perf_counter() - t0})
        parts[name] = part
    launches = {}
    for part in parts.values():
        for k, v in part.get("kernel_launches", {}).items():
            launches[k] = launches.get(k, 0) + v
    return {"kernel_launches": launches,
            "by_part": {k: p.get("kernel_launches") for k, p in parts.items()}}, streamed


# -- phase 18: spill_path ----------------------------------------------------

#: part 1: config 4's frequency_path table, streamed in batches of 2^20 rows
SPILL_BATCH_ROWS = 1 << 20
#: part 2: the group memory budget config 2 streams under (past its half,
#: the id grouping set's 2^20-group batch states spill at once)
CONFIG2_BUDGET = 32 << 20
#: parts 3 and 4: a checkpoint every 2 batches, a kill at batch 7
RESUME_EVERY = 2
RESUME_KILL_AT = 7
#: part 4: batches that stay unreadable past a 2-retry policy, and
#: transient faults (reads that fail this many times, then succeed)
QUARANTINED = (3, 8)
TRANSIENT = {1: 1, 5: 2, 9: 2}


class SpillDirSampler:
    """The bytes of the spill directories (``deequ_spill_*`` under the
    temporary directory) that are new since entry, sampled every 20 ms on
    a thread: ``peak`` their largest total; ``left`` the directories new
    since entry that are still there at exit."""

    def __enter__(self):
        import tempfile
        import threading

        self.root = tempfile.gettempdir()
        self.before = set(self._dirs())
        self.peak = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _dirs(self):
        try:
            return [n for n in os.listdir(self.root) if n.startswith("deequ_spill_")]
        except OSError:
            return []

    def _bytes(self) -> int:
        total = 0
        for name in self._dirs():
            if name in self.before:
                continue
            path = os.path.join(self.root, name)
            try:
                for entry in os.scandir(path):
                    total += entry.stat().st_size
            except OSError:
                pass  # a directory removed while it was read
        return total

    def _run(self) -> None:
        while not self._stop.wait(0.02):
            self.peak = max(self.peak, self._bytes())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self._bytes())

    def left(self) -> list:
        import gc

        gc.collect()
        return sorted(set(self._dirs()) - self.before)


def spill_counters() -> dict:
    from deequ_tpu_torch.ops.scan_engine import SCAN_STATS

    return {k: getattr(SCAN_STATS, k) for k in (
        "spill_runs", "spill_bytes_written", "spill_bytes_read", "spill_merge_passes",
        "peak_group_state_bytes")}


def spill_config4(seed: int, device, smi: str, rows: int) -> dict:
    """Part 1, ``config4_spill`` (module doc)."""
    import numpy as np
    import torch

    from deequ_tpu_torch import VerificationSuite, stream_table
    from deequ_tpu_torch.analyzers import ApproxCountDistinct, Histogram
    from deequ_tpu_torch.ops import hll
    from deequ_tpu_torch.spill.store import state_nbytes
    from deequ_tpu_torch.states import InMemoryStateProvider

    label = "spill_path/config4_spill"
    table = make_config4_table(rows, seed)
    col = table["key"]
    counts = np.bincount(col.codes + 1, minlength=len(col.dictionary) + 1)
    want_hist = numpy_histogram(
        counts, lambda i: "NullValue" if i == 0 else col.dictionary[i - 1], 1000, rows)
    want_unique = float((counts == 1).sum()) / rows
    check = build_config4_check()
    in_memory = metric_values(VerificationSuite.on_data(table).add_check(check).run())

    plain_states = InMemoryStateProvider()
    t0 = time.perf_counter()
    unbudgeted = (VerificationSuite.on_data(stream_table(table, batch_rows=SPILL_BATCH_ROWS))
                  .add_check(check).save_states_with(plain_states).run())
    unbudgeted_s = time.perf_counter() - t0
    hist_bytes = state_nbytes(plain_states.load(Histogram("key", max_detail_bins=1000)))
    del plain_states
    budget = hist_bytes // 4

    states = InMemoryStateProvider()
    suite = (VerificationSuite.on_data(stream_table(table, batch_rows=SPILL_BATCH_ROWS))
             .add_check(check).save_states_with(states).with_group_memory_budget(budget))
    kernel_counts_zero()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with RssSampler() as rss, SpillDirSampler() as disk:
        result = suite.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernel_counts()
        spill = spill_counters()
        got = {m.name: m for m in result.metrics.values()}
        if distribution_of(got["Histogram"]) != want_hist:
            fail(f"{label}: the Histogram's 1,000 bins differ from numpy's bincount")
        if got["Uniqueness"].value.get() != want_unique:
            fail(f"{label}: Uniqueness {got['Uniqueness'].value.get()} != {want_unique}")
        num_rows = states.load(Histogram("key", max_detail_bins=1000)).num_rows
        if num_rows != rows:
            fail(f"{label}: the spilled Histogram state counts {num_rows} rows, not {rows}")
        differ = differing_bits(metric_values(unbudgeted), metric_values(result))
        differ += differing_bits(in_memory, metric_values(result))
        if differ:
            fail(f"{label}: the budgeted stream differs from the unbudgeted stream or the "
                 f"in-memory run in the bits of {sorted(set(differ))}")
        lut = torch.from_numpy(hll.string_idx_rank_lut(col.dictionary, 9)).to(device)
        codes = torch.from_numpy(col.codes).to(device)
        plain = hll.registers_plain(codes, None, 9, lut).cpu().numpy().astype(np.int64)
        registers = np.asarray(states.load(ApproxCountDistinct("key")).registers, np.int64)
        if not np.array_equal(registers, plain):
            fail(f"{label}: the HLL registers differ from K2's plain version")
        del states, suite, result, got  # the saved spilled states go with them
    left = disk.left()
    if left:
        fail(f"{label}: spill directories left behind: {left}")
    if spill["spill_runs"] < 4:
        fail(f"{label}: {spill['spill_runs']} spill runs under a budget of {budget} bytes "
             f"(a quarter of the Histogram state's {hist_bytes}; want >= 4)")
    if launches["bincount"] < 1 or launches["hll"] < 1:
        fail(f"{label}: K5 launched {launches['bincount']} times, K2 {launches['hll']} "
             f"(want both >= 1)")
    return {
        "part": "config4_spill", "card": smi, "rows": rows,
        "cardinality": len(col.dictionary), "batch_rows": SPILL_BATCH_ROWS,
        "reduced": {"rows": f"BASELINE config 4's 10^8 rows cut to {rows} "
                            "(tools/run_spill.py streams all 10^8)"},
        "histogram_state_bytes_unbudgeted": hist_bytes, "budget_bytes": budget,
        **spill, "spill_dir_peak_bytes": disk.peak, "spill_dirs_left": 0,
        "holds": ["Histogram 1,000 bins, Uniqueness, num_rows == numpy bincount",
                  "3 metrics bit for bit the unbudgeted stream and the in-memory run",
                  "HLL registers == K2's plain version"],
        "kernel_launches": launches, "run_wall_s": wall, "rows_per_s": rows / wall,
        "unbudgeted_stream_wall_s": unbudgeted_s, "host_rss_growth_bytes": rss.growth,
    }


def spill_config2(table, main_result, streamed, device, smi: str) -> dict:
    """Part 2, ``config2_spill`` (module doc)."""
    import torch

    from deequ_tpu_torch import stream_table
    from deequ_tpu_torch.states import InMemoryStateProvider

    label = "spill_path/config2_spill"
    stream_suite = (build_suite(stream_table(table, batch_rows=OOC_BATCH_ROWS))
                    .with_group_memory_budget(CONFIG2_BUDGET))
    kernel_counts_zero()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with RssSampler() as rss, SpillDirSampler() as disk:
        result = stream_suite.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernel_counts()
        spill = spill_counters()
        if spill["spill_runs"] < 1:
            fail(f"{label}: nothing spilled under a budget of {CONFIG2_BUDGET} bytes")
        differ = differing_bits(metric_values(streamed), metric_values(result))
        if differ:
            fail(f"{label}: the budgeted stream differs from config2_stream's run in "
                 f"the bits of {differ}")
        del result
    if disk.left():
        fail(f"{label}: spill directories left behind: {disk.left()}")
    k1_require(launches, label)
    if launches["bincount"] < 1:
        fail(f"{label}: the groupings' batch counts never launched K5")

    # in memory under the same budget: saving the states takes the
    # frequency-table route, cut into budget_batch_rows slices
    kernel_counts_zero()
    t0 = time.perf_counter()
    with SpillDirSampler() as disk_mem:
        mem = (build_suite(table).with_group_memory_budget(CONFIG2_BUDGET)
               .save_states_with(InMemoryStateProvider()).run())
        torch.cuda.synchronize()
        mem_wall = time.perf_counter() - t0
        mem_launches = kernel_counts()
        mem_spill = spill_counters()
        differ = differing_bits(metric_values(main_result), metric_values(mem))
        if differ:
            fail(f"{label}: the budgeted in-memory run differs from the in-memory run in "
                 f"the bits of {differ}")
        del mem
    if disk_mem.left():
        fail(f"{label}: spill directories left behind: {disk_mem.left()}")
    if mem_spill["spill_runs"] < 1:
        fail(f"{label}: the budgeted in-memory run spilled nothing")
    if mem_launches["fused_bincount"]:
        fail(f"{label}: a group memory budget stands fusion aside, yet K7 launched "
             f"{mem_launches['fused_bincount']} times")
    from deequ_tpu_torch.spill import budget_batch_rows

    return {
        "part": "config2_spill", "card": smi, "rows": table.num_rows,
        "batch_rows": OOC_BATCH_ROWS, "budget_bytes": CONFIG2_BUDGET,
        "stream": {**spill, "spill_dir_peak_bytes": disk.peak, "run_wall_s": wall,
                   "rows_per_s": table.num_rows / wall, "host_rss_growth_bytes": rss.growth,
                   "bit_for_bit": "config2_stream's 113 metrics"},
        "in_memory": {**mem_spill, "slice_rows": budget_batch_rows(CONFIG2_BUDGET),
                      "spill_dir_peak_bytes": disk_mem.peak, "run_wall_s": mem_wall,
                      "kernel_launches": mem_launches,
                      "bit_for_bit": "main_path's in-memory 113 metrics"},
        "kernel_launches": {k: launches[k] + mem_launches[k] for k in launches},
    }


class _Killed(BaseException):
    """The kill of a run midway: not an Exception, so no failure-as-data
    layer turns it into metrics."""


class KillingSource:
    """A batch source that dies at batch ``kill_at`` (None: never) and
    records where every read started."""

    def __init__(self, inner, kill_at=None):
        self.inner = inner
        self.kill_at = kill_at
        self.starts = []

    @property
    def schema(self):
        return self.inner.schema

    @property
    def num_rows(self):
        return self.inner.num_rows

    @property
    def _batch_rows(self):
        return self.inner._batch_rows

    def batches(self, columns=None, batch_rows=None):
        yield from self.batches_from(0, columns=columns, batch_rows=batch_rows)

    def batches_from(self, start=0, columns=None, batch_rows=None):
        self.starts.append(start)
        for idx, batch in enumerate(self.inner.batches_from(start, columns, batch_rows), start):
            if idx == self.kill_at:
                raise _Killed(f"killed at batch {idx}")
            yield batch


def timed_checkpointer(directory: str):
    """A StreamCheckpointer that records each save's wall and file bytes."""
    from deequ_tpu_torch.resilience import StreamCheckpointer

    class Timed(StreamCheckpointer):
        def save(self, fingerprint, ckpt):
            t0 = time.perf_counter()
            ok = super().save(fingerprint, ckpt)
            self.walls.append(time.perf_counter() - t0)
            path = self._path(ckpt.batch_index)
            self.file_bytes.append(os.path.getsize(path) if ok else 0)
            return ok

    ck = Timed(directory, every_batches=RESUME_EVERY)
    ck.walls, ck.file_bytes = [], []
    return ck


def spill_resume(table, device, smi: str, root: str) -> tuple:
    """Part 3, ``config2_resume`` (module doc). Returns (the part's line,
    the uninterrupted run's metric values)."""
    import torch

    from deequ_tpu_torch import StreamingTable
    from deequ_tpu_torch.data.source import TableBatchSource
    from deequ_tpu_torch.ops.scan_engine import SCAN_STATS

    label = "spill_path/config2_resume"
    batches = -(-table.num_rows // OOC_BATCH_ROWS)
    boundaries = batches // RESUME_EVERY

    def stream(kill_at=None):
        source = KillingSource(TableBatchSource(table, OOC_BATCH_ROWS), kill_at)
        return source, StreamingTable(source)

    # the uninterrupted checkpointed run (the counts read over this run)
    ck = timed_checkpointer(os.path.join(root, "uninterrupted"))
    _, data = stream()
    kernel_counts_zero()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with RssSampler() as rss:
        full = build_suite(data).with_checkpoint(ck).run()
        torch.cuda.synchronize()
    full_wall = time.perf_counter() - t0
    launches = kernel_counts()
    fetches = SCAN_STATS.deferred_fetches
    scans = SCAN_STATS.scan_passes
    k1_require(launches, label)
    if launches["bincount"] < 1:
        fail(f"{label}: the groupings' batch counts never launched K5")
    if ck.saves != boundaries or ck.save_failures:
        fail(f"{label}: {ck.saves} checkpoints saved, {ck.save_failures} failed "
             f"(want {boundaries} and 0)")
    if scans != batches or fetches > boundaries + 1:
        fail(f"{label}: {scans} fused scans and {fetches} fetches of them over {batches} "
             f"batches (want {batches} scans, at most {boundaries + 1} fetches)")
    if os.listdir(ck.directory):
        fail(f"{label}: a completed run left checkpoints: {os.listdir(ck.directory)}")

    # killed at batch RESUME_KILL_AT, then resumed from the same directory
    directory = os.path.join(root, "killed")
    _, data = stream(RESUME_KILL_AT)
    t0 = time.perf_counter()
    try:
        build_suite(data).with_checkpoint(directory, every_batches=RESUME_EVERY).run()
        fail(f"{label}: the run meant to die at batch {RESUME_KILL_AT} completed")
    except _Killed:
        pass
    killed_wall = time.perf_counter() - t0
    kept = sorted(os.listdir(directory))
    source, data = stream()
    t0 = time.perf_counter()
    resumed = build_suite(data).with_checkpoint(directory, every_batches=RESUME_EVERY).run()
    torch.cuda.synchronize()
    resume_wall = time.perf_counter() - t0
    want_start = (RESUME_KILL_AT // RESUME_EVERY) * RESUME_EVERY
    if source.starts != [want_start]:
        fail(f"{label}: the resumed run read from batches {source.starts}, want "
             f"[{want_start}] (the last checkpoint before the kill)")
    full_values = metric_values(full)
    differ = differing_bits(full_values, metric_values(resumed))
    if differ:
        fail(f"{label}: the resumed run differs from the uninterrupted one in the bits "
             f"of {differ}")
    if os.listdir(directory):
        fail(f"{label}: the resumed run left checkpoints: {os.listdir(directory)}")
    return {
        "part": "config2_resume", "card": smi, "rows": table.num_rows,
        "batches": batches, "every_batches": RESUME_EVERY, "killed_at": RESUME_KILL_AT,
        "checkpoints_left_by_the_kill": kept, "resumed_from": want_start,
        "bit_for_bit": f"{len(full_values)} metrics",
        "checkpoint_file_bytes": ck.file_bytes, "save_wall_s": ck.walls,
        "fused_scans": scans, "fused_scan_fetches": fetches,
        "fetch_bound": boundaries + 1, "kernel_launches": launches,
        "uninterrupted_run_wall_s": full_wall, "killed_run_wall_s": killed_wall,
        "resumed_run_wall_s": resume_wall, "host_rss_growth_bytes": rss.growth,
    }, full_values


def spill_quarantine(table, clean: dict, device, smi: str) -> dict:
    """Part 4, ``config2_quarantine`` (module doc): ``clean`` is part 3's
    uninterrupted run."""
    import numpy as np
    import torch

    from deequ_tpu_torch import StreamingTable
    from deequ_tpu_torch.data.source import TableBatchSource
    from deequ_tpu_torch.data.table import ColumnarTable
    from deequ_tpu_torch.resilience import FaultSchedule, FlakyBatchSource, RetryPolicy

    label = "spill_path/config2_quarantine"
    policy = RetryPolicy(max_attempts=3, base_delay=0.001, max_delay=0.01, jitter=0.0)
    fail_at = {("batch", b): FaultSchedule.PERMANENT for b in QUARANTINED}
    fail_at.update({("batch", b): n for b, n in TRANSIENT.items()})
    schedule = FaultSchedule(fail=fail_at)
    data = StreamingTable(FlakyBatchSource(TableBatchSource(table, OOC_BATCH_ROWS), schedule))
    kernel_counts_zero()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = build_suite(data).with_retry_policy(policy).on_batch_error("skip").run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_counts()
    k1_require(launches, label)
    if result.skipped_batches != list(QUARANTINED):
        fail(f"{label}: skipped batches {result.skipped_batches}, want {list(QUARANTINED)}")
    injected = [k for kind, k, _ in schedule.injected if kind == "ioerror"]
    for b, n in TRANSIENT.items():
        if injected.count(("batch", b)) != n:
            fail(f"{label}: batch {b} failed {injected.count(('batch', b))} times, want {n}")
    keep = np.ones(table.num_rows, dtype=bool)
    for b in QUARANTINED:
        keep[b * OOC_BATCH_ROWS:(b + 1) * OOC_BATCH_ROWS] = False
    idx = np.nonzero(keep)[0]
    remaining = ColumnarTable([c.take(idx) for c in table.columns.values()])
    worst = check_metrics(result, expected_metrics(remaining))
    del remaining

    # transient faults alone retry to the clean checkpointed run's bits
    schedule = FaultSchedule(fail={("batch", b): n for b, n in TRANSIENT.items()})
    data = StreamingTable(FlakyBatchSource(TableBatchSource(table, OOC_BATCH_ROWS), schedule))
    t0 = time.perf_counter()
    retried = build_suite(data).with_retry_policy(policy).on_batch_error("skip").run()
    retried_wall = time.perf_counter() - t0
    if retried.skipped_batches:
        fail(f"{label}: transient faults quarantined {retried.skipped_batches}")
    differ = differing_bits(clean, metric_values(retried))
    if differ:
        fail(f"{label}: the retried run differs from the clean run in the bits of {differ}")
    return {
        "part": "config2_quarantine", "card": smi, "rows": table.num_rows,
        "skipped_batches": result.skipped_batches, "transient_failures": TRANSIENT,
        "retry_policy_attempts": policy.max_attempts,
        "rows_verified": int(keep.sum()), "worst_rel_err_vs_numpy": worst,
        "retried_bit_for_bit": f"{len(clean)} metrics", "kernel_launches": launches,
        "quarantine_run_wall_s": wall, "retried_run_wall_s": retried_wall,
    }


def spill_path(table, main_result, streamed, seed: int, device, smi: str,
               config4_rows: int) -> dict:
    """Phase ``spill_path`` (module doc): its four parts, each printed as a
    line of its own, the launch counts set to 0 just before each part's
    checked run and read just after; returns the launches summed over the
    parts and by part."""
    import tempfile

    parts = {}
    runs = (
        ("config4_spill", lambda: spill_config4(seed, device, smi, config4_rows)),
        ("config2_spill", lambda: spill_config2(table, main_result, streamed, device, smi)),
    )
    for name, run in runs:
        t0 = time.perf_counter()
        part = run()
        emit({"phase": "spill_path", **part, "seconds": time.perf_counter() - t0})
        parts[name] = part
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        t0 = time.perf_counter()
        part, clean = spill_resume(table, device, smi, root)
        emit({"phase": "spill_path", **part, "seconds": time.perf_counter() - t0})
        parts["config2_resume"] = part
    finally:
        import shutil

        shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    part = spill_quarantine(table, clean, device, smi)
    emit({"phase": "spill_path", **part, "seconds": time.perf_counter() - t0})
    parts["config2_quarantine"] = part
    launches = {}
    for part in parts.values():
        for k, v in part["kernel_launches"].items():
            launches[k] = launches.get(k, 0) + v
    return {"kernel_launches": launches,
            "by_part": {k: p["kernel_launches"] for k, p in parts.items()}}


#: device_fault_path: the watchdog's deadline in the hang part and the host
#: stall the hook injects past it; the fixed chunk rows of the injected
#: mid-fold OOM (the main table in five chunks: chunk 3 finds a fold of
#: three); the slice a persistent OOM bisects down to the floor; the batch
#: from which a budgeted stream OOMs for good, and its attempt budget
FAULT_DEADLINE_S = 2.0
FAULT_STALL_S = 3.5
FAULT_CHUNK_ROWS = 1 << 21
FAULT_SLICE_ROWS = 1 << 16
FAULT_FROM_BATCH = 6
FAULT_ATTEMPTS = 4
#: the armed and unarmed main runs in turns (five until mesh_path joined
#: the script; three keep it inside its time)
FAULT_TIMED_RUNS = 3
#: the run budget's wall in ``hang``'s abandoned attempt: less than the
#: host packing of the main table's chunks
FAULT_RUN_DEADLINE_S = 0.5
#: what the first ballast tensor of ``real_oom`` leaves free on the card
#: (the allocator rounds a request up; pieces of ballast then take the rest)
FAULT_OOM_MARGIN = 64 << 20


class scan_hook:
    """The scan engine's fault hook installed for the block."""

    def __init__(self, hook):
        self.hook = hook

    def __enter__(self):
        from deequ_tpu_torch.ops.scan_engine import install_scan_fault_hook

        self._prev = install_scan_fault_hook(self.hook)
        return self.hook

    def __exit__(self, *exc):
        from deequ_tpu_torch.ops.scan_engine import install_scan_fault_hook

        install_scan_fault_hook(self._prev)


class forced_chunk_rows:
    """In-memory scans cut at ``rows`` for the block: the engine's chunk
    rule (``scan_engine._auto_chunk_rows``) answers ``rows``."""

    def __init__(self, rows: int):
        self.rows = rows

    def __enter__(self):
        from deequ_tpu_torch.ops import scan_engine

        self._orig = scan_engine._auto_chunk_rows
        scan_engine._auto_chunk_rows = lambda *args, **kwargs: self.rows
        return self

    def __exit__(self, *exc):
        from deequ_tpu_torch.ops import scan_engine

        scan_engine._auto_chunk_rows = self._orig


class watched_workers:
    """``watch`` (``watch_cpu_ops``) carried onto the watchdog's worker
    threads: torch's dispatch modes are per thread, and an armed deadline
    runs each chunk's step on a worker. Each worker call runs under a
    watch of its own, merged into ``watch`` when it ends."""

    def __init__(self, watch):
        self.watch = watch

    def __enter__(self):
        from deequ_tpu_torch.ops import device_policy

        self._orig = orig = device_policy.on_callers_stream
        outer = self.watch

        def on_stream_watched(fn, device):
            inner = orig(fn, device)

            def watched():
                w = watch_cpu_ops()
                try:
                    with w:
                        return inner()
                finally:
                    for name, count in w.cpu_ops.items():
                        outer.cpu_ops[name] = outer.cpu_ops.get(name, 0) + count
                    outer.h2d_copies += w.h2d_copies

            return watched

        device_policy.on_callers_stream = on_stream_watched
        return self.watch

    def __exit__(self, *exc):
        from deequ_tpu_torch.ops import device_policy

        device_policy.on_callers_stream = self._orig


def suite_scan_ops(table):
    """The main suite's fused-scan ops over ``table``, built and coalesced
    as the runner builds them."""
    from deequ_tpu_torch.analyzers import CountDistinct
    from deequ_tpu_torch.analyzers.base import ScanShareableAnalyzer
    from deequ_tpu_torch.analyzers.runner import AnalysisRunner
    from deequ_tpu_torch.verification import _required

    analyzers = _required([build_check()], [CountDistinct(["customer_id"])])
    scanning = [a for a in analyzers if isinstance(a, ScanShareableAnalyzer)]
    ops, _, failures = AnalysisRunner._build_scan_ops(table, scanning)
    if failures:
        fail(f"suite_scan_ops: ops failed to build: {failures}")
    exec_ops, _ = AnalysisRunner._coalesce_scan_ops(ops)
    return exec_ops, len(scanning)


def leaves_bit_equal(got, want) -> bool:
    """Two fused scans' leaves, every leaf the same dtype, shape and bytes."""
    import numpy as np

    if len(got) != len(want):
        return False
    for g, w in zip(got, want):
        if g.keys() != w.keys():
            return False
        for key in w:
            a, b = np.ascontiguousarray(g[key]), np.ascontiguousarray(w[key])
            if a.dtype != b.dtype or a.shape != b.shape or a.tobytes() != b.tobytes():
                return False
    return True


def scan_failures(result, scanned: int, kind, label: str) -> list:
    """The run's failed metrics: exactly the ``scanned`` fused-scan
    analyzers', each failing with ``kind``; the others succeeded."""
    failed = [m for m in result.metrics.values() if m.value.is_failure]
    if len(failed) != scanned:
        fail(f"{label}: {len(failed)} failed metrics, want the {scanned} fused-scan ones")
    for m in failed:
        if not isinstance(m.value.exception, kind):
            fail(f"{label}: {m.name}({m.instance}) failed with "
                 f"{type(m.value.exception).__name__}, want {kind.__name__}")
    return [m.value.exception for m in failed]


def fault_real_oom(table, expected: dict, main_result, device, smi: str) -> dict:
    """Part 1, ``real_oom`` (module doc)."""
    import torch

    from deequ_tpu_torch import scan_execution_report
    from deequ_tpu_torch.ops.device_policy import current_scan_fault_hook
    from deequ_tpu_torch.ops.scan_engine import run_scan

    label = "device_fault_path/real_oom"
    if current_scan_fault_hook() is not None:
        fail(f"{label}: a fault hook is installed; the OOM must be the allocator's")
    suite = build_suite(table)
    t0 = time.perf_counter()
    table.persist()
    torch.cuda.synchronize()
    persist_s = time.perf_counter() - t0
    resident = table._device_cache.nbytes
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    clean = suite.run()
    torch.cuda.synchronize()
    suite_peak = torch.cuda.max_memory_allocated(device) - base
    check_metrics(clean, expected)
    exec_ops, scanned = suite_scan_ops(table)
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    run_scan(table, exec_ops, device)
    torch.cuda.synchronize()
    scan_peak = torch.cuda.max_memory_allocated(device) - base
    del exec_ops

    # other work takes the card: a ballast leaves it FAULT_OOM_MARGIN free,
    # and pieces of ballast, halving from 256 MiB to 1 MiB, take that and
    # the free blocks the allocator keeps inside its live segments
    # (``slack``, which it would hand the scan without asking the card):
    # the resident scan's first large tensor fails; evicting the residency
    # leaves a bisected attempt room
    torch.cuda.empty_cache()
    slack = torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
    free_before, total = torch.cuda.mem_get_info(device)
    ballast = [torch.empty(free_before - FAULT_OOM_MARGIN, dtype=torch.uint8, device=device)]
    piece = 256 << 20
    while piece >= 1 << 20:
        try:
            ballast.append(torch.empty(piece, dtype=torch.uint8, device=device))
        except torch.cuda.OutOfMemoryError:
            piece //= 2
    ballast_bytes = sum(b.numel() for b in ballast)
    free_with_ballast = torch.cuda.mem_get_info(device)[0]
    reserved_with_ballast = torch.cuda.memory_reserved(device)
    kernel_counts_zero()
    watch = watch_cpu_ops()
    torch.cuda.reset_peak_memory_stats(device)
    ooms_before = torch.cuda.memory_stats(device).get("num_ooms", 0)
    t0 = time.perf_counter()
    try:
        with watch:
            result = suite.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernel_counts()
        report = scan_execution_report()
        allocator = {
            "num_ooms": torch.cuda.memory_stats(device).get("num_ooms", 0) - ooms_before,
            "peak_allocated_bytes": torch.cuda.max_memory_allocated(device),
            "peak_reserved_bytes": torch.cuda.max_memory_reserved(device),
            "reserved_with_ballast_bytes": reserved_with_ballast,
            "ballast_bytes": ballast_bytes,
        }
    finally:
        del ballast
        torch.cuda.empty_cache()
    bisects = [e for e in report["degradation_events"] if e["kind"] == "oom_bisect"]
    real = [e for e in bisects
            if "OutOfMemoryError: CUDA out of memory" in e["error"] and "injected" not in e["error"]]
    if not real:
        failed = [(m.name, m.instance, str(m.value.exception)[:200])
                  for m in result.metrics.values() if m.value.is_failure]
        fail(f"{label}: no oom_bisect from a real torch.cuda.OutOfMemoryError "
             f"(events {report['degradation_events']}; resident {resident}, scan working "
             f"set {scan_peak}, suite working set {suite_peak}, slack {slack}, free "
             f"{free_before} -> {free_with_ballast} of {total}; allocator {allocator}; "
             f"failed metrics {len(failed)}: {failed[:3]})")
    if bisects[0]["evicted_bytes"] <= 0:
        fail(f"{label}: the first OOM evicted {bisects[0]['evicted_bytes']} bytes")
    if table._device_cache is not None:
        fail(f"{label}: the residency survived the OOM")
    if watch.cpu_ops:
        fail(f"{label}: torch operations computed on CPU tensors: {watch.cpu_ops}")
    k1_require(launches, label)
    worst = check_metrics(result, expected)
    final_chunk = bisects[-1]["chunk_to"]
    with forced_chunk_rows(final_chunk):
        at_final = suite.run()
    differ = differing_bits(metric_values(at_final), metric_values(result))
    if differ:
        fail(f"{label}: the bisected run differs from a clean run at chunk {final_chunk} "
             f"in the bits of {differ}")
    # the ballast gone, the card is usable: main_path's metrics, bit for bit
    after = suite.run()
    check_metrics(after, expected)
    differ = differing_bits(metric_values(main_result), metric_values(after))
    if differ:
        fail(f"{label}: the run after the OOM differs from main_path in {differ}")
    return {
        "part": "real_oom", "card": smi, "rows": table.num_rows,
        "resident_bytes": resident, "persist_s": persist_s,
        "suite_working_set_bytes": suite_peak, "scan_working_set_bytes": scan_peak,
        "allocator_slack_bytes": slack, "card_free_bytes_before_ballast": free_before,
        "card_free_bytes_with_ballast": free_with_ballast, "card_total_bytes": total,
        "oom_bisects": [{k: e[k] for k in ("chunk_from", "chunk_to", "depth", "evicted_bytes")}
                        for e in bisects],
        "first_oom_error": real[0]["error"][:240],
        "final_chunk_rows": final_chunk, "device_faults": report["device_faults"],
        "worst_rel_err_vs_numpy": worst,
        "bit_for_bit": f"a clean run at chunk {final_chunk}; after it, main_path",
        "allocator": allocator, "oom_run_wall_s": wall, "kernel_launches": launches,
    }


def fault_mid_fold(table, expected: dict, device, smi: str) -> dict:
    """Part 2, ``injected_oom_mid_fold`` (module doc)."""
    import torch

    from deequ_tpu_torch import scan_execution_report
    from deequ_tpu_torch.exceptions import DeviceFallbackRefusedException, DeviceOOMException
    from deequ_tpu_torch.ops.device_policy import DEVICE_HEALTH
    from deequ_tpu_torch.ops.scan_engine import SCAN_STATS, run_scan
    from deequ_tpu_torch.resilience import FaultInjectingScanHook

    label = "device_fault_path/injected_oom_mid_fold"
    suite = build_suite(table)
    halved = FAULT_CHUNK_ROWS // 2
    exec_ops, scanned = suite_scan_ops(table)
    with forced_chunk_rows(halved):
        kernel_counts_zero()
        clean = suite.run()
        clean_fetches = scan_execution_report()["device_fetches"]
        clean_leaves = run_scan(table, exec_ops, device)

    def at_chunk_3(hook_obj):
        return lambda boundary, ctx: (
            hook_obj(boundary, ctx) if ctx.get("chunk_index") == 3 else None)

    hook_obj = FaultInjectingScanHook(faults={0: ("oom", 1)})
    kernel_counts_zero()
    watch = watch_cpu_ops()
    t0 = time.perf_counter()
    with forced_chunk_rows(FAULT_CHUNK_ROWS), scan_hook(at_chunk_3(hook_obj)), watch:
        result = suite.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_counts()
    report = scan_execution_report()
    if hook_obj.injected != [("oom", 0, 0)]:
        fail(f"{label}: injected {hook_obj.injected}")
    if report["oom_bisections"] != 1:
        fail(f"{label}: {report['oom_bisections']} bisections, want 1")
    (event,) = [e for e in report["degradation_events"] if e["kind"] == "oom_bisect"]
    if (event["chunk_from"], event["chunk_to"]) != (FAULT_CHUNK_ROWS, halved):
        fail(f"{label}: bisected {event['chunk_from']} -> {event['chunk_to']}")
    if report["last_scan_fetches"] != 1 or report["device_fetches"] != clean_fetches:
        fail(f"{label}: fused scan {report['last_scan_fetches']} fetches, the run "
             f"{report['device_fetches']} (a clean run at chunk {halved}: {clean_fetches})")
    if watch.cpu_ops:
        fail(f"{label}: torch operations computed on CPU tensors: {watch.cpu_ops}")
    k1_require(launches, label)
    worst = check_metrics(result, expected)
    differ = differing_bits(metric_values(clean), metric_values(result))
    if differ:
        fail(f"{label}: differs from a clean run at chunk {halved} in {differ}")
    SCAN_STATS.reset()
    with scan_hook(at_chunk_3(FaultInjectingScanHook(faults={0: ("oom", 1)}))):
        leaves = run_scan(table, exec_ops, device, chunk_rows=FAULT_CHUNK_ROWS)
    if not leaves_bit_equal(leaves, clean_leaves):
        fail(f"{label}: a leaf of the bisected fused scan differs from the clean scan's "
             f"at chunk {halved}")

    # a persistent OOM on a slice bottoms out at the 64-row floor (each
    # policy on a closed breaker: the first run's faults would open it)
    part = slice_rows(table, 0, min(FAULT_SLICE_ROWS, table.num_rows))
    floor = {}
    for policy, kind in (("fail", DeviceOOMException),
                         ("fallback", DeviceFallbackRefusedException)):
        DEVICE_HEALTH.reset()
        SCAN_STATS.reset()
        with scan_hook(FaultInjectingScanHook(faults={0: ("oom", math.inf)})):
            res = build_suite(part).on_device_error(policy).run()
        errors = scan_failures(res, scanned, kind, f"{label}/floor/{policy}")
        rep = scan_execution_report()
        last = [e for e in rep["degradation_events"] if e["kind"] == "oom_bisect"][-1]
        if last["chunk_to"] != 64:
            fail(f"{label}/floor/{policy}: the last bisection reached {last['chunk_to']}")
        if policy == "fallback" and not isinstance(errors[0].__cause__, DeviceOOMException):
            fail(f"{label}/floor: the refusal's cause is {type(errors[0].__cause__).__name__}")
        floor[policy] = {"bisections": rep["oom_bisections"], "raised": kind.__name__,
                         "fallback_refused": rep["fallback_refused"]}
    DEVICE_HEALTH.reset()
    return {
        "part": "injected_oom_mid_fold", "card": smi, "chunk_rows": FAULT_CHUNK_ROWS,
        "halved_chunk_rows": halved, "oom_bisections": report["oom_bisections"],
        "fused_scan_fetches": report["last_scan_fetches"],
        "run_fetches": report["device_fetches"], "worst_rel_err_vs_numpy": worst,
        "bit_for_bit": f"every metric and fused-scan leaf of a clean run at chunk {halved}",
        "floor": {"rows": part.num_rows, **floor}, "run_wall_s": wall,
        "kernel_launches": launches,
    }


def fault_hang(table, expected: dict, main_result, device, smi: str) -> dict:
    """Part 3, ``hang`` (module doc)."""
    import torch

    from deequ_tpu_torch import scan_execution_report
    from deequ_tpu_torch.exceptions import (
        DeviceFallbackRefusedException,
        DeviceHangException,
    )
    from deequ_tpu_torch.ops.device_policy import DEVICE_HEALTH
    from deequ_tpu_torch.ops.scan_engine import run_scan
    from deequ_tpu_torch.resilience import FaultInjectingScanHook

    label = "device_fault_path/hang"
    suite = build_suite(table)
    exec_ops, scanned = suite_scan_ops(table)
    kernel_counts_zero()
    suite.run()
    clean_launches = kernel_counts()
    clean_fetches = scan_execution_report()["device_fetches"]

    def stall():
        return FaultInjectingScanHook(faults={0: ("hang", 1)}, hang_seconds=FAULT_STALL_S)

    DEVICE_HEALTH.reset()
    kernel_counts_zero()
    watch = watch_cpu_ops()
    t0 = time.perf_counter()
    with scan_hook(stall()), watched_workers(watch), watch:
        hung = build_suite(table).with_device_deadline(FAULT_DEADLINE_S).run()
    hung_wall = time.perf_counter() - t0
    # the stalled worker wakes, finds itself abandoned, and launches nothing
    time.sleep(FAULT_STALL_S - FAULT_DEADLINE_S + 0.25)
    torch.cuda.synchronize()
    launches = kernel_counts()
    report = scan_execution_report()
    errors = scan_failures(hung, scanned, DeviceHangException, label)
    if errors[0].deadline != FAULT_DEADLINE_S:
        fail(f"{label}: the hang's deadline {errors[0].deadline}")
    if launches["k1"] or launches["k1_merge"]:
        fail(f"{label}: the abandoned scan launched K1 {launches['k1']} and its merge "
             f"{launches['k1_merge']} times")
    if report["device_fetches"] != clean_fetches - 1 or report["watchdog_timeouts"] != 1:
        fail(f"{label}: {report['device_fetches']} fetches (a clean run "
             f"{clean_fetches}, less the fused scan's one), "
             f"{report['watchdog_timeouts']} watchdog timeouts")
    if watch.cpu_ops:
        fail(f"{label}: torch operations computed on CPU tensors: {watch.cpu_ops}")
    nxt = suite.run()
    check_metrics(nxt, expected)
    differ = differing_bits(metric_values(main_result), metric_values(nxt))
    if differ:
        fail(f"{label}: the run after the hang differs from main_path in {differ}")

    # under "fallback": three hangs open the breaker
    for i in range(DEVICE_HEALTH.threshold):
        with scan_hook(stall()):
            run = (build_suite(table).on_device_error("fallback")
                   .with_device_deadline(FAULT_DEADLINE_S).run())
        for err in scan_failures(run, scanned, DeviceFallbackRefusedException,
                                 f"{label}/fallback {i}"):
            if not isinstance(err.__cause__, DeviceHangException):
                fail(f"{label}/fallback {i}: refused for {type(err.__cause__).__name__}")
    time.sleep(FAULT_STALL_S - FAULT_DEADLINE_S + 0.25)
    kernel_counts_zero()
    with scan_hook(FaultInjectingScanHook()) as watcher:
        refused = build_suite(table).on_device_error("fallback").run()
    refused_launches = kernel_counts()
    for err in scan_failures(refused, scanned, DeviceFallbackRefusedException, label):
        if err.reason != "unhealthy_backend":
            fail(f"{label}: the open breaker refused for {err.reason!r}")
    if watcher.calls or refused_launches["k1"]:
        fail(f"{label}: the refused scan stepped {len(watcher.calls)} chunks, "
             f"K1 {refused_launches['k1']} launches")
    for _ in range(DEVICE_HEALTH.probe_interval - 2):
        try:
            run_scan(table, exec_ops, device, on_device_error="fallback")
            fail(f"{label}: the breaker let a scan through before its probe")
        except DeviceFallbackRefusedException:
            pass
    kernel_counts_zero()
    probe_watch = watch_cpu_ops()
    with probe_watch:
        probe = build_suite(table).on_device_error("fallback").run()
    probe_launches = kernel_counts()
    k1_require(probe_launches, f"{label}/probe")
    check_metrics(probe, expected)
    if probe_watch.cpu_ops or DEVICE_HEALTH.consecutive_faults:
        fail(f"{label}/probe: CPU ops {probe_watch.cpu_ops}, "
             f"{DEVICE_HEALTH.consecutive_faults} faults left on the breaker")

    # a run deadline and no hook: the run budget's watchdog abandons the
    # fused scan's attempt in its host packing (the table is not resident
    # here, so its chunks are packed and copied); when the pack in flight
    # returns, the worker steps no further chunk, launches nothing and
    # counts no fetch
    if table._device_cache is not None:
        fail(f"{label}/run_deadline: the table is resident, its scan would not pack")
    kernel_counts_zero()
    gov_watch = watch_cpu_ops()
    t0 = time.perf_counter()
    with watched_workers(gov_watch), gov_watch:
        governed = build_suite(table).with_run_budget(run_deadline=FAULT_RUN_DEADLINE_S).run()
    governed_wall = time.perf_counter() - t0
    at_return = (kernel_counts(), scan_execution_report())
    time.sleep(FAULT_STALL_S - FAULT_DEADLINE_S)  # several chunks' packing
    torch.cuda.synchronize()
    after = (kernel_counts(), scan_execution_report())
    scan_failures(governed, scanned, DeviceHangException, f"{label}/run_deadline")
    moved = {k: (at_return[1][k], after[1][k])
             for k in ("chunks_processed", "device_fetches")
             if at_return[1][k] != after[1][k]}
    if after[0] != at_return[0] or moved:
        fail(f"{label}/run_deadline: the abandoned attempt went on after the run "
             f"returned: launches {at_return[0]} -> {after[0]}, {moved}")
    if at_return[1]["watchdog_timeouts"] != 1:
        fail(f"{label}/run_deadline: {at_return[1]['watchdog_timeouts']} watchdog timeouts")
    if gov_watch.cpu_ops:
        fail(f"{label}/run_deadline: torch operations computed on CPU tensors: "
             f"{gov_watch.cpu_ops}")
    governed_part = {"run_deadline_s": FAULT_RUN_DEADLINE_S, "run_wall_s": governed_wall,
                     "chunks_stepped": at_return[1]["chunks_processed"],
                     "bytes_packed": at_return[1]["bytes_packed"],
                     "launches_at_return": at_return[0]}

    # the main run's wall, the deadline armed and not, in turns; an armed
    # run steps its chunks on watchdog workers, on the caller's stream: its
    # metrics are main_path's bits
    unarmed, armed = [], []
    timed = (build_suite(table), build_suite(table).with_device_deadline(FAULT_DEADLINE_S))
    for _ in range(FAULT_TIMED_RUNS):
        for suite_i, walls in zip(timed, (unarmed, armed)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            last = suite_i.run()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    differ = differing_bits(metric_values(main_result), metric_values(last))
    if differ:
        fail(f"{label}: an armed run differs from main_path in {differ}")
    launches_all = {k: launches[k] + refused_launches[k] + probe_launches[k]
                    + at_return[0][k] for k in launches}
    return {
        "part": "hang", "card": smi, "deadline_s": FAULT_DEADLINE_S, "stall_s": FAULT_STALL_S,
        "hung_run_wall_s": hung_wall, "clean_launches": clean_launches,
        "hung_launches_after_wake": launches, "run_fetches_after_wake": report["device_fetches"],
        "clean_run_fetches": clean_fetches,
        "breaker": {"threshold": DEVICE_HEALTH.threshold,
                    "probe_interval": DEVICE_HEALTH.probe_interval,
                    "refused_launches": refused_launches, "probe_launches": probe_launches},
        "abandoned_attempt": governed_part,
        "run_wall_s_unarmed_median_of_3": statistics.median(unarmed),
        "run_wall_s_armed_median_of_3": statistics.median(armed),
        "run_wall_s_unarmed": unarmed, "run_wall_s_armed": armed,
        "kernel_launches": launches_all,
    }


def fault_budget(table, device, smi: str) -> dict:
    """Part 4, ``budget_degrade`` (module doc)."""
    import torch

    from deequ_tpu_torch import stream_table
    from deequ_tpu_torch.exceptions import RunBudgetExhaustedException
    from deequ_tpu_torch.ops.device_policy import DEVICE_HEALTH
    from deequ_tpu_torch.resilience import FaultInjectingScanHook, FaultSchedule

    label = "device_fault_path/budget_degrade"
    n = table.num_rows
    n_batches = -(-n // OOC_BATCH_ROWS)
    if n_batches < 2:
        fail(f"{label}: {n} rows make one batch; the part needs two")
    first_bad = min(FAULT_FROM_BATCH, n_batches - 1)
    boundary = first_bad * OOC_BATCH_ROWS

    def dead_from_batch():
        return FaultInjectingScanHook(
            faults={b: ("oom", FaultSchedule.PERMANENT) for b in range(first_bad, n_batches)})

    def budgeted(mode):
        return (build_suite(stream_table(table, batch_rows=OOC_BATCH_ROWS))
                .on_batch_error("skip")
                .with_run_budget(max_total_attempts=FAULT_ATTEMPTS, on_budget_exhausted=mode))

    DEVICE_HEALTH.reset()
    kernel_counts_zero()
    watch = watch_cpu_ops()
    t0 = time.perf_counter()
    with scan_hook(dead_from_batch()), watch:
        result = budgeted("degrade").run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_counts()
    k1_require(launches, label)
    if watch.cpu_ops:
        fail(f"{label}: torch operations computed on CPU tensors: {watch.cpu_ops}")
    if result.unverified_row_ranges != [(boundary, n)]:
        fail(f"{label}: unverified {result.unverified_row_ranges}, want {[(boundary, n)]}")
    ledger = result.run_budget
    if ledger.get("exhausted") != "max_total_attempts" or ledger.get("charges") != {
            "oom_bisect": FAULT_ATTEMPTS + 1}:
        fail(f"{label}: the budget's ledger {ledger}")
    if set(result.retry_stats) < {"invocations", "attempts", "retries", "exhausted"}:
        fail(f"{label}: retry_stats {result.retry_stats}")
    prefix = slice_rows(table, 0, boundary)
    worst = check_metrics(result, expected_metrics(prefix))
    del prefix
    DEVICE_HEALTH.reset()
    t0 = time.perf_counter()
    try:
        with scan_hook(dead_from_batch()):
            budgeted("raise").run()
        fail(f"{label}: on_budget_exhausted='raise' did not raise")
    except RunBudgetExhaustedException as e:
        raised = {"reason": e.reason, "degraded": e.degraded, "charges": e.ledger["charges"]}
    raise_wall = time.perf_counter() - t0
    DEVICE_HEALTH.reset()
    return {
        "part": "budget_degrade", "card": smi, "rows": n, "batch_rows": OOC_BATCH_ROWS,
        "first_dead_batch": first_bad, "max_total_attempts": FAULT_ATTEMPTS,
        "unverified_row_ranges": result.unverified_row_ranges, "run_budget": ledger,
        "retry_stats": result.retry_stats, "rows_verified": boundary,
        "worst_rel_err_vs_numpy": worst, "raise_mode": raised,
        "degrade_run_wall_s": wall, "raise_run_wall_s": raise_wall,
        "device_events": len(result.device_events), "kernel_launches": launches,
    }


def device_fault_path(table, main_result, device, smi: str) -> dict:
    """Phase ``device_fault_path`` (module doc): its four parts, each printed
    as a line of its own, the launch counts set to 0 just before each
    part's checked run and read just after; returns the launches summed
    over the parts and by part."""
    t0 = time.perf_counter()
    expected = expected_metrics(table)
    numpy_s = time.perf_counter() - t0
    parts = {}
    runs = (
        ("real_oom", lambda: fault_real_oom(table, expected, main_result, device, smi)),
        ("injected_oom_mid_fold", lambda: fault_mid_fold(table, expected, device, smi)),
        ("hang", lambda: fault_hang(table, expected, main_result, device, smi)),
        ("budget_degrade", lambda: fault_budget(table, device, smi)),
    )
    for name, run in runs:
        t0 = time.perf_counter()
        part = run()
        emit({"phase": "device_fault_path", **part, "seconds": time.perf_counter() - t0})
        parts[name] = part
    launches = {}
    for part in parts.values():
        for k, v in part["kernel_launches"].items():
            launches[k] = launches.get(k, 0) + v
    return {"kernel_launches": launches, "numpy_reference_s": numpy_s,
            "by_part": {k: p["kernel_launches"] for k, p in parts.items()}}


# -- phase: mesh_path ---------------------------------------------------------

#: the virtual mesh mesh_path drives on the one card: 4 members on cuda:0
MESH_MEMBERS = 4
#: the member mesh_path loses, and the one it stalls
MESH_LOST = 2
#: timed runs of each sharded main suite run after the checked one (one,
#: as ``TIMED_REPEATS``, keeps the script inside its time)
MESH_TIMED = 1
#: rows of the two-process run that loses a peer (its hold is the report)
MESH_PEER_LOST_ROWS = 1_000_000


class MeshMergeSpy:
    """Records every K8 merge (``scan_engine.mesh_merge``: its arguments and
    its result) while active, launching as usual."""

    def __enter__(self):
        from deequ_tpu_torch.ops import scan_engine

        self._orig = orig = scan_engine.mesh_merge
        self.calls = []

        def spy(is_sum, is_min, flats, src):
            out = orig(is_sum, is_min, flats, src)
            self.calls.append(((is_sum, is_min, list(flats), src), out))
            return out

        scan_engine.mesh_merge = spy
        return self

    def __exit__(self, *exc):
        from deequ_tpu_torch.ops import scan_engine

        scan_engine.mesh_merge = self._orig


def mesh_merge_plain(is_sum, is_min, flats, src):
    """K8's plain version: the members folded in order by ``merge_tags_plain``."""
    from deequ_tpu_torch.ops import masked_reduce

    acc = flats[0][src]
    for flat in flats[1:]:
        acc = masked_reduce.merge_tags_plain(is_sum, is_min, acc, flat, src)
    return acc


def mesh_counts() -> dict:
    """The kernels' counts, and ``k1_merge_in_k8``: the part of
    ``k1_merge``'s launches that K8 (``scan_engine.mesh_merge``) made,
    counted at the launch under its caller."""
    from deequ_tpu_torch.ops import masked_reduce

    return {**kernel_counts(),
            "k1_merge_in_k8": masked_reduce.MERGE_LAUNCHES_BY_CALLER.get("mesh", 0)}


def hold_against_main(result, main_result, label: str) -> dict:
    """Every metric of ``result`` against ``main_path``'s single-device
    result under the contract: exact where ``_EXACT`` says so, else within
    ``_REL``; returns the worst relative difference a name saw."""
    want = metric_values(main_result)
    have = metric_values(result)
    if set(have) != set(want):
        fail(f"{label}: metric sets differ from main_path's: {set(have) ^ set(want)}")
    worst = {}
    for key, w in want.items():
        h = have[key]
        name = key[0]
        if name in _EXACT:
            if h != w:
                fail(f"{label}: {key} {h!r}, main_path {w!r} (exact)")
            continue
        rel = abs(h - w) / max(abs(w), 1e-300)
        worst[name] = max(worst.get(name, 0.0), rel)
        if rel > _REL[name]:
            fail(f"{label}: {key} {h!r} vs main_path {w!r}, rel {rel:.3g} > {_REL[name]}")
    return {"metrics_held": len(want), "worst_rel_by_name": worst}


def member_launches_held(stats: dict, mesh, kernels, label: str) -> dict:
    """Each member's launches of ``kernels`` in the checked run: every
    member launched each at least once."""
    by_member = {int(m): dict(c) for m, c in stats["member_launches"].items()}
    for member in mesh.device_ids:
        got = by_member.get(member, {})
        for kernel in kernels:
            if got.get(kernel, 0) < 1:
                fail(f"{label}: member {member} launched {kernel} {got.get(kernel, 0)} times")
    return by_member


def mesh_k8_timing(call, rate: float) -> dict:
    """K8 alone on a merge the resident run made (the 4 members' flat
    vectors of the main chunk): CUDA events around 100 queued calls, its
    plain version on the same card tensors, and the bound: each member's
    elementwise entries, the gather indices and the tags read once and the
    merged vector written once, over the memory rate."""
    import torch

    from deequ_tpu_torch.ops import scan_engine

    (is_sum, is_min, flats, src), out = call
    m, n = src.numel(), len(flats)
    nbytes = n * 8 * m + 8 * m + 2 * m + 8 * m
    bound_ms = nbytes / rate * 1e3
    kernel_ms = time_queued(lambda i: scan_engine.mesh_merge(is_sum, is_min, flats, src))
    plain_ms = time_cuda(lambda: mesh_merge_plain(is_sum, is_min, flats, src))
    return {"members": n, "entries": m, "flat_entries": flats[0].numel(),
            "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": None,
            "bytes": nbytes, "bound_ms": bound_ms, "bound_by": "bytes",
            "bound_share": bound_ms / kernel_ms, "max_abs_err": 0.0}


def mesh_count_sum_timing(table, mesh, device, rate: float) -> dict:
    """The count sum of ``customer_id``'s members (each member's K5 counts
    copied to the lead and added in int64, ``segment._member_counts``)
    alone: the sum's time, its bound (the members' counts read once and the
    sum written once over the memory rate), and ``torch.stack(...).sum(0)``,
    one library call computing the same."""
    import numpy as np
    import torch

    from deequ_tpu_torch.ops import histogram_device
    from deequ_tpu_torch.ops.segment import _prepare_grouping

    prep = _prepare_grouping(table, ["customer_id"], device, True)
    keys = prep.keys
    local = -(-len(keys) // mesh.size)
    parts = [histogram_device.bincount(
        torch.from_numpy(np.ascontiguousarray(keys[i * local:(i + 1) * local])).to(dev),
        prep.keyspace) for i, (_, dev) in enumerate(mesh.members)]

    def summed(i):
        total = parts[0]
        for p in parts[1:]:
            total = total + p.to(device, non_blocking=True)
        return total

    got = summed(0)
    want = histogram_device.bincount_plain(
        torch.from_numpy(keys).to(device), prep.keyspace)
    if not torch.equal(got, want):
        fail("mesh_path: the members' summed counts differ from one count of every key")
    nbytes = (len(parts) + 1) * 8 * prep.keyspace
    bound_ms = nbytes / rate * 1e3
    sum_ms = time_queued(summed)
    library_ms = time_queued(lambda i: torch.stack(parts).sum(0))
    return {"column": "customer_id", "members": len(parts), "bins": prep.keyspace,
            "sum_ms": sum_ms, "library_ms": library_ms, "library_call":
            "torch.stack(counts).sum(0)", "bytes": nbytes, "bound_ms": bound_ms,
            "bound_by": "bytes", "bound_share": bound_ms / sum_ms}


def mesh_sharded(table, main_result, device, smi: str, rate: float) -> dict:
    """Part 1, ``sharded`` (module doc)."""
    import torch

    from deequ_tpu_torch.ops.scan_engine import SCAN_STATS, persist_table
    from deequ_tpu_torch.parallel.mesh import use_mesh, virtual_mesh

    label = "mesh_path/sharded"
    mesh = virtual_mesh(MESH_MEMBERS, device)
    table.unpersist()
    out = {"members": MESH_MEMBERS, "device": str(device)}
    runs = {}
    for mode in ("in_memory", "resident"):
        if mode == "resident":
            t0 = time.perf_counter()
            persist_table(table, device, mesh=mesh)
            torch.cuda.synchronize()
            out["persist_s"] = time.perf_counter() - t0
            cache = table._device_cache
            out["resident_shard_rows"] = [cache.shard(0, i)[0].shape[1]
                                          for i in range(MESH_MEMBERS)]
        torch.cuda.reset_peak_memory_stats(device)
        kernel_counts_zero()
        watch = watch_cpu_ops()
        with use_mesh(mesh), K1Spy() as spy, MeshMergeSpy() as k8, \
                PlainCheck(f"{label}/{mode}") as plain, watch:
            t0 = time.perf_counter()
            result = build_suite(table).run()
            first_s = time.perf_counter() - t0
        launches = mesh_counts()
        stats = SCAN_STATS.snapshot()
        peak = torch.cuda.max_memory_allocated(device)
        if watch.cpu_ops:
            fail(f"{label}/{mode}: torch operations computed on CPU tensors: {watch.cpu_ops}")
        held = hold_against_main(result, main_result, f"{label}/{mode}")
        kernels = ("K1", "K7") if mode == "in_memory" else ("K1", "K5")
        by_member = member_launches_held(stats, mesh, kernels, f"{label}/{mode}")
        if stats["resident_passes"] != (mode == "resident"):
            fail(f"{label}/{mode}: {stats['resident_passes']} resident passes")
        # each launch against its plain version (launches that compare do
        # not count: the run's counts are read above)
        k1 = [k1_hold(tasks, f"{label}/{mode} batch {i}")
              for i, (_, tasks, _) in enumerate(spy.batches)]
        if len(spy.batches) != MESH_MEMBERS * stats["chunks_processed"]:
            fail(f"{label}/{mode}: {len(spy.batches)} K1 batches over "
                 f"{stats['chunks_processed']} chunks, want one a member a chunk")
        if len(k8.calls) != stats["chunks_processed"] or launches["k1_merge_in_k8"] < 1:
            fail(f"{label}/{mode}: {len(k8.calls)} K8 merges ({launches['k1_merge_in_k8']} "
                 f"k1_merge launches) over {stats['chunks_processed']} chunks")
        for call, got in k8.calls:
            want = mesh_merge_plain(*call)
            if not torch.equal(got.view(torch.int64), want.view(torch.int64)):
                fail(f"{label}/{mode}: a K8 merge differs from merge_tags_plain in its bits")
        walls = []
        with use_mesh(mesh):
            for _ in range(MESH_TIMED):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                build_suite(table).run()
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
        runs[mode] = {
            **held, "kernel_launches": launches, "member_launches": by_member,
            "k1_holds": len(k1), "k1_max_abs_err": max(h["max_abs_err"] for h in k1),
            "k8_holds": len(k8.calls), "k5_held": plain.shapes, "k7_held": plain.fused_shapes,
            "first_run_s": first_s, "run_wall_s": walls, "peak_device_bytes": peak,
            "grouping_passes": stats["grouping_passes"],
            "hist_kernel_dispatches": stats["hist_kernel_dispatches"],
        }
        if mode == "resident":
            out["k8_timing"] = mesh_k8_timing(k8.calls[0], rate)
    out["count_sum_timing"] = mesh_count_sum_timing(table, mesh, device, rate)
    out["runs"] = runs
    out["kernel_launches"] = {
        k: runs["in_memory"]["kernel_launches"][k] + runs["resident"]["kernel_launches"][k]
        for k in runs["in_memory"]["kernel_launches"]}
    return out


def mesh_reshard(table, device, smi: str) -> dict:
    """Part 2, ``reshard`` (module doc)."""
    from deequ_tpu_torch.ops.device_policy import DEVICE_HEALTH, MESH_HEALTH
    from deequ_tpu_torch.ops.scan_engine import persist_table
    from deequ_tpu_torch.parallel.mesh import mesh_excluding, use_mesh, virtual_mesh
    from deequ_tpu_torch.resilience import FaultInjectingScanHook, FaultSchedule

    label = "mesh_path/reshard"
    mesh = virtual_mesh(MESH_MEMBERS, device)
    three = mesh_excluding(mesh, {MESH_LOST})
    table.unpersist()
    DEVICE_HEALTH.reset()
    MESH_HEALTH.reset()
    with use_mesh(three):
        t0 = time.perf_counter()
        healthy3 = build_suite(table).run()
        healthy_s = time.perf_counter() - t0
    persist_table(table, device, mesh=mesh)
    hook = FaultInjectingScanHook(
        faults={i: ("lost", FaultSchedule.PERMANENT, MESH_LOST) for i in range(2)})
    kernel_counts_zero()
    with use_mesh(mesh), scan_hook(hook):
        t0 = time.perf_counter()
        degraded = build_suite(table).run()
        degraded_s = time.perf_counter() - t0
        launches = mesh_counts()
        reshards = [e for e in degraded.mesh_events if e["kind"] == "mesh_reshard"]
        if (not degraded.resharded or len(reshards) != 1
                or (reshards[0]["mesh_from"], reshards[0]["mesh_to"]) != (4, 3)
                or reshards[0]["lost_devices"] != [MESH_LOST]):
            fail(f"{label}: mesh events {degraded.mesh_events}, want one reshard 4 -> 3")
        if reshards[0]["evicted_bytes"] <= 0 or table.is_persisted:
            fail(f"{label}: the residency over the old mesh was not evicted")
        differ = differing_bits(metric_values(healthy3), metric_values(degraded))
        if differ:
            fail(f"{label}: the resharded run differs from a healthy 3-member run in {differ}")
        injected = len(hook.injected)
        # the next scan leaves the quarantined member out up front
        again = build_suite(table).run()
        kinds = [e["kind"] for e in again.mesh_events]
        if len(hook.injected) != injected or kinds != ["mesh_quarantine"]:
            fail(f"{label}: the next scan's mesh events {kinds}, {len(hook.injected) - injected} "
                 "new injections; want one mesh_quarantine and none")
        if differing_bits(metric_values(healthy3), metric_values(again)):
            fail(f"{label}: the quarantined run differs from a healthy 3-member run")
    MESH_HEALTH.reset()
    return {"mesh_events": degraded.mesh_events, "next_scan_events": again.mesh_events,
            "injected": [list(i) for i in hook.injected], "healthy3_s": healthy_s,
            "resharded_run_s": degraded_s, "kernel_launches": launches,
            "bit_identical_to_healthy3": True}


def mesh_straggler(table, device, smi: str) -> dict:
    """Part 3, ``straggler`` (module doc)."""
    import torch

    from deequ_tpu_torch.exceptions import DeviceHangException
    from deequ_tpu_torch.ops.device_policy import DEVICE_HEALTH, MESH_HEALTH
    from deequ_tpu_torch.parallel.mesh import use_mesh, virtual_mesh
    from deequ_tpu_torch.resilience import FaultInjectingScanHook

    label = "mesh_path/straggler"
    mesh = virtual_mesh(MESH_MEMBERS, device)
    table.unpersist()
    DEVICE_HEALTH.reset()
    MESH_HEALTH.reset()
    hook = FaultInjectingScanHook(faults={0: ("hang", 1, MESH_LOST)},
                                  hang_seconds=FAULT_STALL_S)
    _, scanned = suite_scan_ops(table)
    kernel_counts_zero()
    with use_mesh(mesh), scan_hook(hook):
        t0 = time.perf_counter()
        hung = build_suite(table).with_shard_deadline(FAULT_DEADLINE_S).run()
        hung_s = time.perf_counter() - t0
    errors = scan_failures(hung, scanned, DeviceHangException, label)
    stragglers = [e for e in hung.mesh_events if e["kind"] == "mesh_straggler"]
    if (len(stragglers) != 1 or stragglers[0]["deadline"] != FAULT_DEADLINE_S
            or stragglers[0]["mesh_size"] != MESH_MEMBERS or errors[0].deadline != FAULT_DEADLINE_S):
        fail(f"{label}: mesh events {hung.mesh_events}")
    # the stalled member's worker wakes, finds its call abandoned, and
    # launches nothing
    time.sleep(FAULT_STALL_S - FAULT_DEADLINE_S + 0.25)
    torch.cuda.synchronize()
    launches = mesh_counts()
    if launches["k1"] or launches["k1_merge"]:
        fail(f"{label}: the abandoned step launched K1 {launches['k1']} and its merge "
             f"{launches['k1_merge']} times (K8's included)")
    DEVICE_HEALTH.reset()
    MESH_HEALTH.reset()
    return {"mesh_events": hung.mesh_events, "hung_run_s": hung_s,
            "deadline_s": FAULT_DEADLINE_S, "stall_s": FAULT_STALL_S,
            "kernel_launches": launches}


def mesh_all_lost(table, device, smi: str) -> dict:
    """Part 4, ``all_lost`` (module doc)."""
    from deequ_tpu_torch.exceptions import DeviceFallbackRefusedException, MeshDegradedException
    from deequ_tpu_torch.ops.device_policy import DEVICE_HEALTH, MESH_HEALTH
    from deequ_tpu_torch.parallel.mesh import use_mesh, virtual_mesh
    from deequ_tpu_torch.resilience import FaultInjectingScanHook, FaultSchedule

    label = "mesh_path/all_lost"
    mesh = virtual_mesh(MESH_MEMBERS, device)
    hooks = [FaultInjectingScanHook(faults={0: ("lost", FaultSchedule.PERMANENT, m)})
             for m in mesh.device_ids]

    def all_dead(boundary, ctx):
        for h in hooks:
            h(boundary, ctx)

    DEVICE_HEALTH.reset()
    MESH_HEALTH.reset()
    _, scanned = suite_scan_ops(table)
    kernel_counts_zero()
    with use_mesh(mesh), scan_hook(all_dead):
        run = build_suite(table).on_device_error("fallback").run()
    launches = mesh_counts()
    for err in scan_failures(run, scanned, DeviceFallbackRefusedException, label):
        if not isinstance(err.__cause__, MeshDegradedException):
            fail(f"{label}: refused for {type(err.__cause__).__name__}")
    reshards = [e for e in run.mesh_events if e["kind"] == "mesh_reshard"]
    if len(reshards) != MESH_MEMBERS - 1:
        fail(f"{label}: {len(reshards)} reshards before the refusal, want {MESH_MEMBERS - 1}")
    DEVICE_HEALTH.reset()
    MESH_HEALTH.reset()
    return {"mesh_events": run.mesh_events,
            "refused": [e for e in run.device_events if e["kind"] == "cpu_fallback_refused"],
            "kernel_launches": launches}


def mesh_processes(main_result, rows: int, seed: int, device, smi: str) -> dict:
    """Part 5, ``processes`` (module doc): two processes on ``device``
    through ``tools/multiprocess_merge.py``."""
    from deequ_tpu_torch.analyzers.base import ScanShareableAnalyzer
    from deequ_tpu_torch.analyzers.runner import _is_grouping_shared

    here = os.path.dirname(os.path.abspath(__file__))
    tool = os.path.join(here, "tools", "multiprocess_merge.py")
    out_dir = os.path.join(here, "build", "mesh_path")
    os.makedirs(out_dir, exist_ok=True)
    label = "mesh_path/processes"
    want = {repr(a): m.value.get() for a, m in main_result.metrics.items()
            if m.value.is_success}
    names = {repr(a): type(a).__name__ for a in main_result.metrics}
    # the states a row-range split merges: the scan-shareable analyzers'
    # (the grouping sets' frequency tables are not merged across processes)
    scan_keys = {repr(a) for a in main_result.metrics
                 if isinstance(a, ScanShareableAnalyzer) and not _is_grouping_shared(a)}
    out = {}
    for mode, n, extra in (("merge", rows, []),
                           ("peer_lost", MESH_PEER_LOST_ROWS,
                            ["--kill-rank", "1", "--peer-timeout", "5"])):
        path = os.path.join(out_dir, f"{mode}.json")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, tool, "--spawn", "2", "--rows", str(n), "--seed", str(seed),
             "--device", str(device), "--persist", "--timeout", "240", "--out", path, *extra],
            capture_output=True, text=True, timeout=300,
        )
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"{label}/{mode}: the processes failed: {proc.stdout[-4000:]}{proc.stderr[-4000:]}")
        got = json.loads(proc.stdout.strip().splitlines()[-1])
        half = [0, n // 2]
        if got["shard"] != half:
            fail(f"{label}/{mode}: rank 0 held rows {got['shard']}, want {half}")
        entry = {"rows": n, "wall_s": wall, "times": got["times"]}
        if mode == "merge":
            if set(got["metrics"]) != scan_keys:
                fail(f"{label}: merged {len(got['metrics'])} metrics, want main_path's "
                     f"{len(scan_keys)} scan metrics: {set(got['metrics']) ^ scan_keys}")
            entry["metrics"] = len(got["metrics"])
            worst = {}
            for key, h in got["metrics"].items():
                if key not in want or isinstance(h, str):
                    fail(f"{label}: {key} merged {h!r}, main_path {want.get(key)!r}")
                w, name = want[key], names[key]
                if name in _EXACT:
                    if h != w:
                        fail(f"{label}: {key} merged {h!r}, main_path {w!r} (exact)")
                    continue
                rel = abs(h - w) / max(abs(w), 1e-300)
                worst[name] = max(worst.get(name, 0.0), rel)
                if rel > _REL[name]:
                    fail(f"{label}: {key} merged {h!r} vs main_path {w!r}, rel {rel:.3g}")
            entry["worst_rel_by_name"] = worst
        else:
            # the survivor's run through the builder's on_peer_loss("degrade")
            lost_half = [[n // 2, n]]
            events = [[e["start"], e["stop"]] for e in got["peer_lost_events"]]
            if got["unverified_row_ranges"] != lost_half or events != lost_half:
                fail(f"{label}/{mode}: unverified rows {got['unverified_row_ranges']}, "
                     f"peer_lost events {got['peer_lost_events']}; want rows {lost_half}")
            if got["failed_metrics"] or got["metrics"] != len(main_result.metrics):
                fail(f"{label}/{mode}: {got['metrics']} metrics, failed: "
                     f"{got['failed_metrics']}")
            entry.update({k: got[k] for k in ("status", "unverified_row_ranges",
                                              "peer_lost_events", "metrics")})
        out[mode] = entry
    return {**out, "kernel_launches": {}}


def mesh_cards(table, main_result, device, smi: str) -> dict:
    """Part 6, ``cards`` (module doc): step 1's in-memory run over the
    default mesh of every visible card, where there are several."""
    import torch

    from deequ_tpu_torch.parallel.mesh import default_mesh, use_mesh

    count = torch.cuda.device_count()
    mesh = default_mesh()
    if mesh is None:
        return {"skipped": f"torch.cuda.device_count() is {count}: no mesh of cards",
                "device_count": count, "kernel_launches": {}}
    table.unpersist()
    kernel_counts_zero()
    with use_mesh(mesh):
        result = build_suite(table).run()
    return {"device_count": count, "members": mesh.size,
            **hold_against_main(result, main_result, "mesh_path/cards"),
            "kernel_launches": mesh_counts()}


def mesh_path(table, main_result, rows: int, seed: int, device, smi: str, rate: float,
              parts=None) -> dict:
    """Phase ``mesh_path`` (module doc): its six parts (or those named in
    ``parts``), each printed as a line of its own; returns the launches
    summed over the parts and by part, and the K8 and count-sum timings."""
    from deequ_tpu_torch.ops.device_policy import DEVICE_HEALTH, MESH_HEALTH

    wanted = parts
    parts = {}
    runs = (
        ("sharded", lambda: mesh_sharded(table, main_result, device, smi, rate)),
        ("reshard", lambda: mesh_reshard(table, device, smi)),
        ("straggler", lambda: mesh_straggler(table, device, smi)),
        ("all_lost", lambda: mesh_all_lost(table, device, smi)),
        ("processes", lambda: mesh_processes(main_result, rows, seed, device, smi)),
        ("cards", lambda: mesh_cards(table, main_result, device, smi)),
    )
    try:
        for name, run in runs:
            if wanted is not None and name not in wanted:
                continue
            t0 = time.perf_counter()
            part = run()
            emit({"phase": "mesh_path", "part": name, "card": smi, **part,
                  "seconds": time.perf_counter() - t0})
            parts[name] = part
    finally:
        table.unpersist()
        DEVICE_HEALTH.reset()
        MESH_HEALTH.reset()
    launches = {}
    for part in parts.values():
        for k, v in part["kernel_launches"].items():
            launches[k] = launches.get(k, 0) + v
    sharded = parts.get("sharded", {"runs": {}})
    return {"kernel_launches": launches,
            "by_part": {k: p["kernel_launches"] for k, p in parts.items()},
            "k8_timing": sharded.get("k8_timing"),
            "count_sum_timing": sharded.get("count_sum_timing")}


# -- phase: hist_variant_path, the histogram kernel-variant tier ---------------

#: the variants the main suite runs under, forced one after the other
HIST_FORCED = ("onehot", "scatter", "pallas")
#: the sweep's widths, at 10^7 int64 Zipf ids, beside the two the card
#: gives (:func:`sweep_widths`: K6's narrow edge and K5's shared edge)
SWEEP_WIDTHS = (9, 128, 1024, 5001, 1 << 14, 1 << 16, 1 << 17, 1 << 20, 1 << 22)
SWEEP_ROWS = 10_000_000
#: K6 and K5 are timed in turns at each width, the first side alternating
SWEEP_TURNS = 3
# dense INT8 tensor rate of each H100 part (NVIDIA data sheets), ops/s
_INT8_RATE = {"PCIe": 1513e12, "NVL": 1671e12, "SXM": 1979e12}


def int8_rate(name: str) -> float:
    for key in ("PCIe", "NVL"):
        if key in name:
            return _INT8_RATE[key]
    return _INT8_RATE["SXM"]


class forced_hist_variant:
    """``DEEQU_TORCH_HIST_VARIANT`` set to ``variant`` (None: unset) for
    the block, the caller's value restored after."""

    def __init__(self, variant):
        self.variant = variant

    def __enter__(self):
        self.saved = os.environ.pop("DEEQU_TORCH_HIST_VARIANT", None)
        if self.variant is not None:
            os.environ["DEEQU_TORCH_HIST_VARIANT"] = self.variant

    def __exit__(self, *exc):
        os.environ.pop("DEEQU_TORCH_HIST_VARIANT", None)
        if self.saved is not None:
            os.environ["DEEQU_TORCH_HIST_VARIANT"] = self.saved


def census_of(stats: dict) -> dict:
    from deequ_tpu_torch.ops.histogram_device import HIST_VARIANTS

    return {v: stats[f"hist_{v}_dispatches"] for v in HIST_VARIANTS}


def variant_run(suite, variant, label: str) -> tuple:
    """One checked run of ``suite`` with the variant forced (None: the
    policy's): counts set to 0 just before, read just after, watched for
    CPU ops. K6's launches must equal the census's one-hot dispatches, be
    above 0 forced to "onehot" and 0 under the other forces, and a forced
    run must count no dispatch under another variant."""
    import torch

    from deequ_tpu_torch.ops.scan_engine import SCAN_STATS

    kernel_counts_zero()
    watch = watch_cpu_ops()
    with forced_hist_variant(variant):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with watch:
            result = suite.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = kernel_counts()
    stats = SCAN_STATS.snapshot()
    census = census_of(stats)
    if watch.cpu_ops:
        fail(f"{label}: torch operations computed on CPU tensors: {watch.cpu_ops}")
    if census["onehot"] != launches["onehot"]:
        fail(f"{label}: {census['onehot']} one-hot dispatches, {launches['onehot']} K6 launches")
    if variant == "onehot" and launches["onehot"] < 1:
        fail(f"{label}: forced to onehot, K6 never launched")
    if variant not in (None, "onehot") and launches["onehot"]:
        fail(f"{label}: forced to {variant}, K6 launched {launches['onehot']} times")
    if variant is not None and any(n for v, n in census.items() if v != variant):
        fail(f"{label}: forced to {variant}, the census counted {census}")
    return result, {"run_wall_s_watched": wall, "kernel_launches": launches,
                    "census": census, "hist_kernel_dispatches": stats["hist_kernel_dispatches"],
                    "grouping_passes": stats["grouping_passes"]}


def sweep_widths() -> list:
    """:data:`SWEEP_WIDTHS` and the two widths the card gives: K6's narrow
    edge (``onehot_plan``'s ``narrow_widest``) and K5's shared edge
    (``regime_widths()["shared"]``)."""
    from deequ_tpu_torch.ops.histogram_device import onehot_plan, regime_widths

    return sorted({*SWEEP_WIDTHS, onehot_plan(1, 1)["narrow_widest"],
                   regime_widths()["shared"]})


def cap_from_sweep(rows) -> int:
    """The card's one-hot cap from a sweep: the widest swept width such
    that K6 was no slower than K5 at every swept width up to it (0 when it
    was slower at the narrowest). A band of wins past a loss does not
    count: routing every width under a lone far win to K6 would route the
    widths of the loss to the slower kernel."""
    cap = 0
    for row in sorted(rows, key=lambda r: r["num_segments"]):
        if row["kernel_ms"] > row["k5_ms"]:
            break
        cap = row["num_segments"]
    return cap


def in_turns(fns: dict, reps: int, turns: int = SWEEP_TURNS) -> dict:
    """Each of ``fns`` (name -> fn(i)) timed alone (``time_queued``) in
    ``turns`` rounds, the order reversed every other round so each side
    goes first as often; returns name -> the times."""
    names = list(fns)
    times = {name: [] for name in names}
    for r in range(turns):
        for name in (names if r % 2 == 0 else names[::-1]):
            times[name].append(time_queued(fns[name], reps))
    return times


def k6_traffic(plan: dict, n: int, id_bytes: int, m: int) -> dict:
    """The bytes K6 moves and the product's operations at ``plan`` over
    ``n`` ids: the narrow route reads the ids once; the wide route reads
    them twice and writes and reads each kept row's u16 digit once. The
    product is n · 16 · B · 2 operations on both routes."""
    reads = n * id_bytes * (2 if plan["wide"] else 1)
    digits = 2 * n * 2 if plan["wide"] else 0
    return {"route": "wide" if plan["wide"] else "narrow", "ids_read_bytes": reads,
            "digit_bytes": digits, "out_bytes": m * 8,
            "product_ops": n * plan["tile_bins"] * 2}


def k6_shape_timing(label: str, seg, m: int, rate: float, ops_rate: float,
                    plain_reps: int = 3, reps: int = 20) -> dict:
    """K6 at one shape: the kernel alone and K5 in its regime, each
    (CUDA events around ``reps`` launches queued behind a spin, as K5's
    rows) in :data:`SWEEP_TURNS` turns, the first side alternating, their
    medians; one wrapper call; its plain version
    (``bincount_onehot_plain``); and torch.bincount. The bound is the
    histogram's: each id read once, each count written once, over the
    memory rate. K6's own traffic and the one-hot product's operations
    (n · 16 · B · 2 over the dense INT8 rate, ``formulation_ops_ms``) are
    reported beside it: a histogram needs none of them."""
    import torch

    from deequ_tpu_torch.ops import histogram_device
    from deequ_tpu_torch.ops.histogram_device import (
        bincount_onehot,
        bincount_onehot_plain,
        bincount_plain,
        onehot_plan,
    )

    saved = (histogram_device.LAUNCHES, histogram_device.ONEHOT_LAUNCHES)
    n = seg.numel()
    plan = onehot_plan(m, n)
    scratch, out = histogram_device._onehot_buffers(n, m, False, seg.device)
    name = histogram_device.regime(m)
    bufs = histogram_device._buffers(seg, m, None, name)
    turns = in_turns({
        "k6": lambda i: histogram_device._onehot_launch(seg, m, None, scratch, out),
        "k5": lambda i: histogram_device._launch(seg, m, None, *bufs, regime_name=name),
    }, reps)
    kernel_ms = statistics.median(turns["k6"])
    k5_ms = statistics.median(turns["k5"])
    prof = profiled_ms(lambda i: histogram_device._onehot_launch(seg, m, None, scratch, out),
                       match="onehot")
    call_ms = time_cuda(lambda: bincount_onehot(seg, m), reps=5)
    # one cold repeat past 2^17 bins, where a call takes seconds
    plain_ms = time_cuda(lambda: bincount_onehot_plain(seg, m), reps=plain_reps,
                         warmup=1 if plain_reps > 1 else 0)
    slots = torch.where(seg >= 0, seg, m).long()  # torch.bincount refuses negatives
    library_ms = time_queued(lambda i: torch.bincount(slots, minlength=m + 1), reps,
                             waits=True)
    got, want = bincount_onehot(seg, m), bincount_plain(seg, m)
    histogram_device.LAUNCHES, histogram_device.ONEHOT_LAUNCHES = saved
    if not torch.equal(got, want):
        fail(f"K6 != plain at the {label} shape (n={n}, m={m})")
    traffic = k6_traffic(plan, n, seg.element_size(), m)
    bound_ms = (n * seg.element_size() + m * 8) / rate * 1e3
    own_ms = (traffic["ids_read_bytes"] + traffic["digit_bytes"] + m * 8) / rate * 1e3
    return {
        "column": label, "n": n, "num_segments": m,
        "ids": str(seg.dtype).replace("torch.", ""),
        "radix_b": 1 << plan["log2_b"], "plan": plan, **traffic,
        "kernel_ms": kernel_ms, "k5_ms": k5_ms, "k5_regime": name,
        "turns_ms": turns,
        "profiler_ms": prof if prof is not None else "no device time",
        "call_ms": call_ms, "plain_ms": plain_ms, "plain_reps": plain_reps,
        "library_ms": library_ms, "library_call": "torch.bincount",
        "bound_ms": bound_ms, "bound_by": "bytes", "own_traffic_ms": own_ms,
        "formulation_ops_ms": traffic["product_ops"] / ops_rate * 1e3,
        "bound_share": bound_ms / kernel_ms, "k6_over_k5": kernel_ms / k5_ms,
        "max_abs_err": 0,
    }


def hist_variant_sweep(device, rate: float, ops_rate: float, seed: int) -> dict:
    """K6 against K5 (its regime), in turns, and torch.bincount at
    :data:`SWEEP_ROWS` int64 Zipf ids and each width of
    :func:`sweep_widths` (the plain version timed three times up to 2^17
    bins, once past it); the card's cap is :func:`cap_from_sweep`'s."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed + 20)
    rows = []
    for m in sweep_widths():
        seg = torch.from_numpy(zipf_ids(rng, SWEEP_ROWS, m)).to(device)
        rows.append(k6_shape_timing(f"Zipf, {m} bins", seg, m, rate, ops_rate,
                                    plain_reps=3 if m <= 1 << 17 else 1))
        del seg
    wins = [r["num_segments"] for r in rows if r["kernel_ms"] <= r["k5_ms"]]
    cap = cap_from_sweep(rows)
    return {"rows": rows, "k6_no_slower_at": wins, "cap_from_sweep": cap,
            "band_past_the_cap": [w for w in wins if w > cap]}


def hist_variant_path(table, main_result, device, smi: str, rate: float, seed: int) -> dict:
    """The main suite over main_path's table under each forced variant
    (``DEEQU_TORCH_HIST_VARIANT``: onehot, scatter, pallas), one checked run
    each in memory and one each persisted: in memory every metric bit for
    bit main_path's, persisted bit for bit the unforced persisted run's
    (held within the contract against main_path's); K6 launched, and
    counted by the census, under "onehot" only. Then K6 at the main
    path's narrow shapes, its multi-input entry at the fused group's, the
    sweep and the cap it sets, and the policy's default routes."""
    import torch

    from deequ_tpu_torch.ops import histogram_device
    from deequ_tpu_torch.ops.device_policy import hist_accel_cap, resolve_hist_variant
    from deequ_tpu_torch.ops.histogram_device import fused_bincount_plain
    from deequ_tpu_torch.ops.segment import _prepare_grouping

    ops_rate = int8_rate(torch.cuda.get_device_name(device))
    suite = build_suite(table)
    want = bits_of(metric_values(main_result))
    runs, by_variant = {}, {}
    t0 = time.perf_counter()
    for variant in HIST_FORCED:
        result, report = variant_run(suite, variant, f"in memory, {variant}")
        diff = differing_bits(metric_values(main_result), metric_values(result))
        if diff:
            fail(f"hist_variant_path: in memory under {variant}, {len(diff)} metrics differ "
                 f"from main_path's bits: {diff[:5]}")
        runs[f"in_memory_{variant}"] = report
        by_variant[variant] = report["kernel_launches"]["onehot"]
    in_memory_s = time.perf_counter() - t0
    cache, persist_s = persist_timed(table, device)
    base, base_report = variant_run(suite, None, "persisted, the policy's")
    held = hold_against_main(base, main_result, "hist_variant_path persisted")
    runs["persisted_default"] = base_report
    for variant in HIST_FORCED:
        result, report = variant_run(suite, variant, f"persisted, {variant}")
        diff = differing_bits(metric_values(base), metric_values(result))
        if diff:
            fail(f"hist_variant_path: persisted under {variant}, {len(diff)} metrics differ "
                 f"from the unforced persisted run: {diff[:5]}")
        runs[f"persisted_{variant}"] = report
        by_variant[variant] += report["kernel_launches"]["onehot"]
    freed = unpersist_frees(table, device, "hist_variant_path")

    # the default routes of the main path's dispatches (the reference's
    # widths: the counted bins plus a trailing slot)
    n = table.num_rows
    preps = {c: _prepare_grouping(table, [c], device) for c in FUSED_SETS}
    spaces = [preps[c].keyspace for c in FUSED_SETS]
    routes = {f"{c} ({preps[c].keyspace} bins)": resolve_hist_variant(
        (preps[c].keyspace + 1,), rows=n, platform="cuda") for c in FUSED_SETS}
    routes[f"the fused group ({sum(spaces)} bins)"] = resolve_hist_variant(
        (sum(spaces) + 1,), rows=n * len(FUSED_SETS), platform="cuda")

    # K6 at the main path's narrow dispatch shapes, and its multi-input
    # entry at the fused group's beside K7
    shapes = []
    for col in ("status", "region"):
        seg = torch.from_numpy(preps[col].keys).to(device)
        shapes.append(k6_shape_timing(col, seg, preps[col].keyspace, rate, ops_rate))
    keys = [torch.from_numpy(preps[c].keys).to(device) for c in FUSED_SETS]
    rows_all = n * len(FUSED_SETS)
    k6_scratch, out = histogram_device._onehot_buffers(rows_all, sum(spaces), False, device)
    name = histogram_device.regime(sum(spaces))
    scratch, k7_out = histogram_device._fused_buffers(keys, spaces, name)
    saved = histogram_device.ONEHOT_LAUNCHES
    turns = in_turns({
        "k6": lambda i: histogram_device._onehot_multi_launch(keys, spaces, k6_scratch, out),
        "k7": lambda i: histogram_device._fused_launch(keys, spaces, scratch, k7_out, name),
    }, 20)
    prof = profiled_ms(lambda i: histogram_device._onehot_multi_launch(keys, spaces, k6_scratch,
                                                                       out), match="onehot")
    got = histogram_device.fused_bincount(keys, spaces, "onehot")
    histogram_device.ONEHOT_LAUNCHES = saved
    if not torch.equal(got, fused_bincount_plain(keys, spaces)):
        fail("K6's multi-input entry != fused_bincount_plain at the fused group's shape")
    multi_ms, k7_ms = statistics.median(turns["k6"]), statistics.median(turns["k7"])
    plan = histogram_device.onehot_plan(sum(spaces), rows_all)
    traffic = k6_traffic(plan, rows_all, 8, sum(spaces))
    bytes_ms = (rows_all * 8 + sum(spaces) * 8) / rate * 1e3
    fused = {"column": "main_path's fused group: " + ", ".join(FUSED_SETS),
             "n": rows_all, "num_segments": sum(spaces), "plan": plan, **traffic,
             "kernel_ms": multi_ms, "k7_ms": k7_ms, "turns_ms": turns,
             "profiler_ms": prof if prof is not None else "no device time",
             "bound_ms": bytes_ms, "bound_by": "bytes",
             "formulation_ops_ms": traffic["product_ops"] / ops_rate * 1e3,
             "bound_share": bytes_ms / multi_ms, "max_abs_err": 0}
    del keys, out, k6_scratch, scratch, k7_out

    sweep = hist_variant_sweep(device, rate, ops_rate, seed)
    if "DEEQU_TORCH_HIST_ACCEL_CAP" not in os.environ \
            and hist_accel_cap() != sweep["cap_from_sweep"]:
        fail(f"hist_variant_path: the card's default one-hot cap is {hist_accel_cap()}, "
             f"the sweep's rule gives {sweep['cap_from_sweep']} (K6 no slower than K5 "
             f"at {sweep['k6_no_slower_at']})")
    return {
        "phase": "hist_variant_path", "card": smi,
        "runs": runs, "metrics_bit_for_bit": len(want), "persisted_vs_main": held,
        "in_memory_s": in_memory_s, "persist_s": persist_s, **freed,
        "k6_launches_by_variant": by_variant,
        "kernel_launches": {"onehot": sum(by_variant.values())},
        "default_routes": routes, "accel_cap": hist_accel_cap(),
        "k6_shapes": shapes, "k6_fused_group": fused, "sweep": sweep,
    }


# -- phase 21: serve_path -----------------------------------------------------

#: Load A, the reference's serving load (bench.py:measure_serving_load):
#: tenants of 256 rows, 8 repeat suite shapes, 2% fresh tenants with an
#: extra column of their own, taken 256 a batch
SERVE_TENANTS = 1000
SERVE_ROWS = 256
SERVE_SHAPES = 8
SERVE_FRESH_FRAC = 0.02
SERVE_MAX_BATCH = 256
#: tenants held bit for bit against their serial runs, and the serial
#: baseline's tenants (min of 3 passes after a warm one)
SERVE_SAMPLE = 32
SERVE_SERIAL_TENANTS = 64
SERVE_SUSTAINED_PASSES = 3
#: Load B, main_path's width: tenants of 2^17 rows (one chunk: the chunk
#: rule gives at least 2^18) on the scan-shareable constraints, and
#: tenants on the whole check (served serially, as grouping suites are)
SERVE_WIDE_TENANTS = 64
SERVE_WIDE_ROWS = 1 << 17
SERVE_WIDE_SERIAL = 4
#: the isolation batch and its poison tenant
SERVE_POISON_BATCH = 8
SERVE_POISON = "iso-3"


def serve_load(seed: int) -> list:
    """Load A: (tenant, table, checks) for each of SERVE_TENANTS tenants,
    made from ``seed``: ``x`` f64 with 5% nulls and ``i`` integral; the
    reference's check (has_size, is_complete, has_completeness, has_mean);
    a fresh tenant reads an extra column of its own, so its plan key is its
    own."""
    import numpy as np

    from deequ_tpu_torch import Check, CheckLevel
    from deequ_tpu_torch.data.table import Column, ColumnarTable, DType

    n = SERVE_ROWS

    def table(shape: int, t: int, fresh: bool):
        r = np.random.default_rng([seed, t])
        cols = [Column("x", DType.FRACTIONAL, values=r.normal(100 + shape, 5, n),
                       mask=r.random(n) > 0.05),
                Column("i", DType.INTEGRAL, values=r.integers(0, 40 + shape, n).astype(np.float64),
                       mask=np.ones(n, dtype=bool))]
        if fresh:
            cols.append(Column(f"f{t}", DType.FRACTIONAL, values=r.normal(0, 1, n),
                               mask=np.ones(n, dtype=bool)))
        return ColumnarTable(cols)

    def check(shape: int, fresh_id=None):
        c = (Check(CheckLevel.ERROR, f"suite-{shape}").has_size(lambda k: k == n)
             .is_complete("i").has_completeness("x", lambda v: v > 0.5)
             .has_mean("x", lambda m, s=shape: 90 + s < m < 110 + s))
        if fresh_id is not None:
            c = c.has_completeness(f"f{fresh_id}", lambda v: v == 1.0)
        return c

    n_fresh = max(1, int(SERVE_TENANTS * SERVE_FRESH_FRAC))
    load = []
    for t in range(SERVE_TENANTS):
        if t < n_fresh:
            load.append((f"fresh-{t}", table(0, t, True), [check(0, t)]))
        else:
            shape = t % SERVE_SHAPES
            load.append((f"tenant-{t}", table(shape, t, False), [check(shape)]))
    return load


def same_result(want, got, label: str) -> None:
    """Fails unless ``got`` is ``want`` bit for bit: the status and every
    metric (a failure the same failure type)."""
    if want.status != got.status:
        fail(f"{label}: status {got.status} against the serial run's {want.status}")
    if set(want.metrics) != set(got.metrics):
        fail(f"{label}: the analyzers differ from the serial run's")
    for a, m1 in want.metrics.items():
        m2 = got.metrics[a]
        if m1.value.is_success != m2.value.is_success:
            fail(f"{label}: {a} succeeded on one side only")
        if m1.value.is_success:
            v1, v2 = m1.value.get(), m2.value.get()
            if (struct_bits(v1) != struct_bits(v2)) if isinstance(v1, float) else v1 != v2:
                fail(f"{label}: {a} {m2.value.get()!r} against the serial run's "
                     f"{m1.value.get()!r}")
        elif type(m1.value.exception) is not type(m2.value.exception):
            fail(f"{label}: {a} failed as {type(m2.value.exception).__name__}, the serial "
                 f"run as {type(m1.value.exception).__name__}")


def watched_service(watch=None, **knobs):
    """A VerificationService whose worker serves each batch under its
    ``watch`` attribute while one is set: dispatch modes are per thread, so
    the watch is entered on the worker, and a watch costs every torch op a
    Python call, so the timed passes run with none."""
    from deequ_tpu_torch.serve import VerificationService

    class Watched(VerificationService):
        def _serve_batch(self, batch):
            if self.watch is None:
                return super()._serve_batch(batch)
            with self.watch:
                return super()._serve_batch(batch)

    start = knobs.pop("start", True)
    svc = Watched(start=False, **knobs)
    svc.watch = watch
    if start:
        svc.start()
    return svc


def run_load(service, load, timeout: float = 600.0) -> tuple:
    """Submit every (tenant, table, checks) of ``load`` at once and wait
    for all: (wall seconds, futures, results)."""
    t0 = time.perf_counter()
    futures = [service.submit(table, checks, tenant=tenant) for tenant, table, checks in load]
    results = [f.result(timeout=timeout) for f in futures]
    return time.perf_counter() - t0, futures, results


def serve_counters() -> dict:
    from deequ_tpu_torch.ops import masked_reduce
    from deequ_tpu_torch.ops.scan_engine import SCAN_STATS

    return {"batches": SCAN_STATS.coalesced_batches, "tenants": SCAN_STATS.coalesced_tenants,
            "fetches": SCAN_STATS.device_fetches, "built": SCAN_STATS.programs_built,
            "hits": SCAN_STATS.plan_cache_hits, "misses": SCAN_STATS.plan_cache_misses,
            "k1": masked_reduce.LAUNCHES,
            "merges": masked_reduce.MERGE_LAUNCHES_BY_CALLER.get("coalesced", 0),
            "dispatch_s": SCAN_STATS.dispatch_seconds, "drain_s": SCAN_STATS.drain_wait_seconds}


def serve_delta(before: dict) -> dict:
    now = serve_counters()
    return {k: now[k] - before[k] for k in now}


def hold_coalesced(delta: dict, label: str, tenants: int, built=None) -> None:
    """Every tenant of the pass coalesced; one fetch, one K1 batch and one
    fold merge a coalesced batch, whatever its members."""
    if delta["tenants"] != tenants:
        fail(f"{label}: {delta['tenants']} of {tenants} tenants coalesced")
    if delta["fetches"] != delta["batches"]:
        fail(f"{label}: {delta['fetches']} fetches for {delta['batches']} coalesced batches")
    if delta["k1"] != delta["batches"] or delta["merges"] != delta["batches"]:
        fail(f"{label}: {delta['k1']} K1 batches and {delta['merges']} fold merges for "
             f"{delta['batches']} coalesced batches (want one each)")
    if built is not None and delta["built"] != built:
        fail(f"{label}: {delta['built']} programs built, want {built}")


def serve_load_a(load, device, smi: str) -> dict:
    """Load A: the serial baseline, the cold and sustained passes, the
    latency and occupancy, kill-and-resume, and the coalesced batch's K1
    and fold merge captured for their timing."""
    import numpy as np

    from deequ_tpu_torch import VerificationSuite
    from deequ_tpu_torch.obs.registry import REGISTRY, SERVE_LATENCY
    from deequ_tpu_torch.serve import VerificationService

    sample = load[:: max(1, len(load) // SERVE_SAMPLE)][:SERVE_SAMPLE]
    serial_sample = {tenant: VerificationSuite.run(table, checks)
                     for tenant, table, checks in sample}
    baseline = load[:SERVE_SERIAL_TENANTS]
    for _, table, checks in baseline:  # warm
        VerificationSuite.run(table, checks)
    serial_walls = []
    for _ in range(3):
        import torch

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _, table, checks in baseline:
            VerificationSuite.run(table, checks)
        torch.cuda.synchronize()
        serial_walls.append(time.perf_counter() - t0)
    serial_per_s = len(baseline) / min(serial_walls)

    watch = watch_cpu_ops()
    svc = watched_service(max_batch=SERVE_MAX_BATCH)
    try:
        before = serve_counters()
        cold_s, _, cold = run_load(svc, load)
        cold_delta = serve_delta(before)
        hold_coalesced(cold_delta, "serve_path cold", len(load))
        if cold_delta["built"] < 1 or cold_delta["hits"] + cold_delta["misses"] != len(load):
            fail(f"serve_path cold: {cold_delta['built']} programs built, "
                 f"{cold_delta['hits']} hits and {cold_delta['misses']} misses")
        by_tenant = {tenant: r for (tenant, _, _), r in zip(load, cold)}
        for tenant, want in serial_sample.items():
            same_result(want, by_tenant[tenant], f"serve_path cold {tenant}")
        SERVE_LATENCY.reset()
        sustained, deltas, latencies = [], [], []
        for p in range(SERVE_SUSTAINED_PASSES):
            before = serve_counters()
            wall, futures, results = run_load(svc, load)
            delta = serve_delta(before)
            hold_coalesced(delta, f"serve_path sustained {p}", len(load), built=0)
            if delta["hits"] != len(load) or delta["misses"]:
                fail(f"serve_path sustained {p}: {delta['hits']} plan-cache hits, "
                     f"{delta['misses']} misses (want {len(load)} and 0)")
            by_tenant = {tenant: r for (tenant, _, _), r in zip(load, results)}
            for tenant, want in serial_sample.items():
                same_result(want, by_tenant[tenant], f"serve_path sustained {tenant}")
            sustained.append(wall)
            deltas.append(delta)
            latencies += [f.latency_seconds for f in futures]
        serve_section = REGISTRY.snapshot()["serve"]
        # one more sustained pass with every batch watched for CPU ops
        svc.watch = watch
        before = serve_counters()
        watched_s, _, _ = run_load(svc, load)
        hold_coalesced(serve_delta(before), "serve_path watched", len(load), built=0)
    finally:
        svc.stop(drain=False)
    if watch.cpu_ops:
        fail(f"serve_path: torch operations computed on CPU tensors: {watch.cpu_ops}")

    # kill-and-resume: stop a pass after its first resolution, resume the
    # pending requests on a fresh service
    first = VerificationService(max_batch=SERVE_MAX_BATCH)
    futures = [first.submit(table, checks, tenant=tenant) for tenant, table, checks in load]
    while not any(f.done() for f in futures):
        time.sleep(0.0005)
    pending = first.stop(drain=False)
    served_before = sum(f.done() for f in futures)
    second = VerificationService(max_batch=SERVE_MAX_BATCH)
    try:
        second.resume(pending)
        resumed = [f.result(timeout=600) for f in futures]
    finally:
        second.stop()
    if not pending or served_before + len(pending) != len(load):
        fail(f"serve_path kill-and-resume: {served_before} served before the stop and "
             f"{len(pending)} pending of {len(load)}")
    if any(f.resolve_count != 1 or f.late_resolutions for f in futures):
        fail("serve_path kill-and-resume: a future resolved other than exactly once")
    by_tenant = {tenant: r for (tenant, _, _), r in zip(load, resumed)}
    for tenant, want in serial_sample.items():
        same_result(want, by_tenant[tenant], f"serve_path resumed {tenant}")

    lat = np.array(latencies)
    sustained_s = min(sustained)
    return {
        "tenants": len(load), "rows_a_tenant": SERVE_ROWS, "shapes": SERVE_SHAPES,
        "fresh_tenants": sum(t.startswith("fresh-") for t, _, _ in load),
        "max_batch": SERVE_MAX_BATCH, "sample_bit_for_bit": len(serial_sample),
        "cold_s": cold_s, "cold_suites_per_s": len(load) / cold_s,
        "cold": cold_delta, "sustained_s": sustained,
        "sustained_suites_per_s": len(load) / sustained_s,
        "sustained": deltas,
        "serial_tenants": len(baseline), "serial_walls_s": serial_walls,
        "serial_suites_per_s": serial_per_s,
        "sustained_over_serial": len(load) / sustained_s / serial_per_s,
        "latency_p50_s": serve_section["latency"]["p50"],
        "latency_p99_s": serve_section["latency"]["p99"],
        "latency_histogram": serve_section["latency"],
        "latency_futures_p50_s": float(np.percentile(lat, 50)),
        "latency_futures_p99_s": float(np.percentile(lat, 99)),
        "members_a_batch": deltas[0]["tenants"] / max(deltas[0]["batches"], 1),
        "batch_occupancy_of_max_batch": deltas[0]["tenants"] / max(deltas[0]["batches"], 1)
        / SERVE_MAX_BATCH,
        "coalesce_occupancy": serve_section["coalesce_occupancy"],
        "cpu_ops": watch.cpu_ops, "watched_pass_s": watched_s,
        "kill_resume": {"served_before_stop": served_before, "pending": len(pending),
                        "resolved_once": len(futures)},
        "card": smi,
    }


def serve_trace(load, device) -> dict:
    """Load A once on a traced service (its plans warm first) and once on an
    untraced one, in turns: the exported Chrome trace parses, each batch's
    ``coalesce_assembly``, ``execute`` and ``fetch`` spans lie on the
    worker's track inside the tenants' ``serve_request`` spans, and their
    counts and walls reconcile with ScanStats. The armed and disarmed walls
    are reported, with no hold on speed."""
    import tempfile

    from deequ_tpu_torch.obs import FlightRecorder, write_chrome_trace
    from deequ_tpu_torch.serve import VerificationService

    rec = FlightRecorder(capacity=1 << 20)
    traced = VerificationService(trace=rec, max_batch=SERVE_MAX_BATCH)
    plain = VerificationService(max_batch=SERVE_MAX_BATCH)
    try:
        run_load(traced, load)
        run_load(plain, load)
        rec.clear()
        disarmed_s, _, _ = run_load(plain, load)
        before = serve_counters()
        armed_s, _, _ = run_load(traced, load)
        delta = serve_delta(before)
        disarmed_s2, _, _ = run_load(plain, load)
    finally:
        traced.stop()
        plain.stop()
    hold_coalesced(delta, "serve_path traced", len(load), built=0)
    with tempfile.TemporaryDirectory() as tmp:
        path = write_chrome_trace(rec, os.path.join(tmp, "serve.json"))
        trace_bytes = os.path.getsize(path)
        with open(path) as fh:
            trace = json.load(fh)
    spans = {}
    for r in rec.records():
        if r.kind == "span":
            spans.setdefault(r.name, []).append(r)
    coalesced = {name: [r for r in spans.get(name, [])
                        if name == "coalesce_assembly" or "coalesced" in r.args.get("what", "")]
                 for name in ("coalesce_assembly", "transfer", "execute", "fetch")}
    requests = spans.get("serve_request", [])
    counts = {name: len(v) for name, v in coalesced.items()}
    if any(c != delta["batches"] for c in counts.values()) or len(requests) != len(load):
        fail(f"serve_path trace: spans {counts} and {len(requests)} requests for "
             f"{delta['batches']} coalesced batches and {len(load)} tenants")
    tracks = {r.track for v in coalesced.values() for r in v}
    if tracks != {"deequ-torch-serve"}:
        fail(f"serve_path trace: the batches' spans lie on tracks {tracks}")
    starts = sorted(r.t_start for r in requests)
    ends = sorted(r.t_end for r in requests)
    for r in coalesced["coalesce_assembly"] + coalesced["fetch"]:
        if not (starts[0] <= r.t_start and r.t_end <= ends[-1]):
            fail(f"serve_path trace: a {r.name} span lies outside every serve_request span")
    execute_s = sum(r.duration for r in coalesced["execute"])
    fetch_s = sum(r.duration for r in coalesced["fetch"])
    if not (execute_s <= delta["dispatch_s"] + 1e-3 * delta["batches"]
            and execute_s >= 0.9 * delta["dispatch_s"] - 5e-3):
        fail(f"serve_path trace: the execute spans' {execute_s:.6f} s against ScanStats' "
             f"dispatch_seconds {delta['dispatch_s']:.6f}")
    if not (fetch_s <= delta["drain_s"] + 1e-3 * delta["batches"]
            and fetch_s >= 0.9 * delta["drain_s"] - 5e-3):
        fail(f"serve_path trace: the fetch spans' {fetch_s:.6f} s against ScanStats' "
             f"drain_wait_seconds {delta['drain_s']:.6f}")
    return {"spans": counts, "requests": len(requests), "trace_events": len(trace["traceEvents"]),
            "trace_bytes": trace_bytes, "dropped": rec.dropped,
            "execute_span_s": execute_s, "dispatch_seconds": delta["dispatch_s"],
            "fetch_span_s": fetch_s, "drain_wait_seconds": delta["drain_s"],
            "armed_s": armed_s, "disarmed_s": [disarmed_s, disarmed_s2],
            "armed_over_disarmed": armed_s / min(disarmed_s, disarmed_s2)}


def serve_load_b(table, device, smi: str) -> dict:
    """Load B at main_path's width: SERVE_WIDE_TENANTS tenants of 2^17 rows
    cut from main_path's table, on the scan-shareable constraints, one
    coalesced batch, each tenant bit for bit its serial run (and the first
    against numpy), one K1 batch; then SERVE_WIDE_SERIAL more tenants on
    the whole check, served serially, against numpy."""
    from deequ_tpu_torch import VerificationSuite

    t0 = time.perf_counter()
    tenants = SERVE_WIDE_TENANTS + SERVE_WIDE_SERIAL
    if tenants * SERVE_WIDE_ROWS > table.num_rows:
        fail(f"serve_path Load B: {tenants} tenants of {SERVE_WIDE_ROWS} rows need more "
             f"than the table's {table.num_rows}")
    tables = [slice_rows(table, k * SERVE_WIDE_ROWS, (k + 1) * SERVE_WIDE_ROWS)
              for k in range(tenants)]
    table_s = time.perf_counter() - t0
    scan_tables, whole_tables = tables[:SERVE_WIDE_TENANTS], tables[SERVE_WIDE_TENANTS:]
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serial = [VerificationSuite.run(t, [build_scan_check()]) for t in scan_tables]
    torch.cuda.synchronize()
    serial_runs_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    VerificationSuite.run(scan_tables[0], [build_scan_check()])
    torch.cuda.synchronize()
    serial_peak = torch.cuda.max_memory_allocated(device) - base
    watch = watch_cpu_ops()
    svc = watched_service(watch, start=False, max_batch=SERVE_MAX_BATCH)
    try:
        futures = [svc.submit(t, [build_scan_check()], tenant=f"wide-{k}")
                   for k, t in enumerate(scan_tables)]
        before = serve_counters()
        t0 = time.perf_counter()
        svc.start()
        served = [f.result(timeout=600) for f in futures]
        coalesced_s = time.perf_counter() - t0
        delta = serve_delta(before)
        hold_coalesced(delta, "serve_path Load B", len(scan_tables))
        if delta["batches"] != 1:
            fail(f"serve_path Load B: {delta['batches']} coalesced batches, want 1")
        for k, (want, got) in enumerate(zip(serial, served)):
            same_result(want, got, f"serve_path Load B tenant {k}")
        want = {key: v for key, v in expected_metrics(scan_tables[0]).items()
                if key not in GROUPING_METRICS and key[0] != "CountDistinct"}
        worst_coalesced = check_metrics(served[0], want)
        # the same batch again, its plan built and no watch: the wall, and
        # the device memory the batch allocates at its peak (its members'
        # K1 partials are held until its one K1 batch)
        svc.watch = None
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        again_s, _, again = run_load(svc, [(f"wide-{k}", t, [build_scan_check()])
                                           for k, t in enumerate(scan_tables)])
        torch.cuda.synchronize()
        batch_peak = torch.cuda.max_memory_allocated(device) - base
        for k, (want_k, got) in enumerate(zip(serial, again)):
            same_result(want_k, got, f"serve_path Load B again, tenant {k}")
        svc.watch = watch
        before_serial = serve_counters()
        t0 = time.perf_counter()
        whole = [svc.submit(t, [build_check()], tenant=f"whole-{k}")
                 for k, t in enumerate(whole_tables)]
        whole_results = [f.result(timeout=600) for f in whole]
        serial_s = time.perf_counter() - t0
        whole_delta = serve_delta(before_serial)
    finally:
        svc.stop(drain=False)
    if whole_delta["tenants"] != 0:
        fail(f"serve_path Load B: {whole_delta['tenants']} whole-check tenants coalesced")
    worst = 0.0
    for k, (t, r) in enumerate(zip(whole_tables, whole_results)):
        if r.scan_stats.get("coalesced") is not False:
            fail(f"serve_path Load B: whole-check tenant {k} was not served serially")
        want = {key: v for key, v in expected_metrics(t).items() if key[0] != "CountDistinct"}
        worst = max(worst, check_metrics(r, want))
    if watch.cpu_ops:
        fail(f"serve_path Load B: torch operations computed on CPU tensors: {watch.cpu_ops}")
    return {"tenants": len(scan_tables), "rows_a_tenant": SERVE_WIDE_ROWS,
            "columns": len(scan_tables[0].column_names),
            "analyzers": len(build_scan_check().required_analyzers()),
            "coalesced": delta, "coalesced_wall_s_watched": coalesced_s,
            "coalesced_wall_s": again_s, "coalesced_suites_per_s": len(scan_tables) / again_s,
            "serial_runs_s": serial_runs_s,
            "serial_suites_per_s": len(scan_tables) / serial_runs_s,
            "peak_device_bytes": {"coalesced_batch": batch_peak, "serial_run": serial_peak},
            "bit_for_bit": len(scan_tables), "worst_rel_err_coalesced_vs_numpy": worst_coalesced,
            "whole_check_tenants": len(whole_tables), "whole_check_wall_s_watched": serial_s,
            "whole_check_worst_rel_err": worst, "tables_s": table_s, "card": smi}


def serve_isolation(load, device, smi: str) -> dict:
    """On the card: a poison tenant (an OOM that follows it, the port's
    FaultInjectingScanHook with ``tenant_faults``) in a batch of 8 bisects
    the batch (3 ``coalesce_bisect`` events) and ends typed on its serial
    rung while the 7 others are bit for bit their serial runs; the second
    such batch quarantines it, a healthy run readmits it; a member whose
    budget is 0 under an injected OOM degrades alone."""
    from deequ_tpu_torch import RunPolicy, VerificationSuite
    from deequ_tpu_torch.exceptions import DeviceOOMException
    from deequ_tpu_torch.ops.device_policy import DEVICE_HEALTH, install_scan_fault_hook
    from deequ_tpu_torch.ops.scan_engine import SCAN_STATS
    from deequ_tpu_torch.resilience.faults import FaultInjectingScanHook
    from deequ_tpu_torch.serve import VerificationService

    members = [(f"iso-{k}", table, checks)
               for k, (_, table, checks) in enumerate(load[100:100 + SERVE_POISON_BATCH])]
    serial = {tenant: VerificationSuite.run(table, checks) for tenant, table, checks in members}
    svc = VerificationService(start=False, max_batch=SERVE_POISON_BATCH, coalesce_window=0.0,
                              quarantine_after=2)
    rounds = []
    hook = FaultInjectingScanHook(tenant_faults={SERVE_POISON: "oom"})
    prev = install_scan_fault_hook(hook)
    try:
        for round_ in range(2):
            events = len(SCAN_STATS.degradation_events)
            futures = {tenant: svc.submit(table, checks, tenant=tenant)
                       for tenant, table, checks in members}
            if round_ == 0:
                svc.start()
            results = {tenant: f.result(timeout=300) for tenant, f in futures.items()}
            kinds = [e["kind"] for e in SCAN_STATS.degradation_events[events:]]
            if kinds.count("coalesce_bisect") != 3:
                fail(f"serve_path isolation round {round_}: {kinds.count('coalesce_bisect')} "
                     "coalesce_bisect events, want 3 (8 -> 4 -> 2 -> 1)")
            poison = results[SERVE_POISON]
            if not poison.scan_stats.get("isolated_after") or not all(
                    not m.value.is_success and isinstance(m.value.exception, DeviceOOMException)
                    for m in poison.metrics.values()):
                fail(f"serve_path isolation round {round_}: the poison tenant did not end "
                     "typed on its serial rung")
            for tenant, want in serial.items():
                if tenant != SERVE_POISON:
                    same_result(want, results[tenant], f"serve_path isolation {tenant}")
            rounds.append({"events": {k: kinds.count(k) for k in set(kinds)}})
        if not svc.tenant_health.is_quarantined(SERVE_POISON):
            fail("serve_path isolation: the poison tenant was not quarantined after 2 failures")
    finally:
        install_scan_fault_hook(prev)
        DEVICE_HEALTH.reset()
    try:
        tenant, table, checks = next(m for m in members if m[0] == SERVE_POISON)
        healed = svc.submit(table, checks, tenant=tenant).result(timeout=300)
    finally:
        svc.stop(drain=False)
    if healed.scan_stats.get("coalesced") is not False:
        fail("serve_path isolation: the quarantined tenant coalesced")
    same_result(serial[SERVE_POISON], healed, "serve_path isolation readmission")
    if svc.tenant_health.is_quarantined(SERVE_POISON):
        fail("serve_path isolation: one healthy run did not readmit the tenant")

    # one member's budget of 0 under an injected OOM at the first dispatch
    budget_svc = VerificationService(start=False, max_batch=SERVE_POISON_BATCH)
    prev = install_scan_fault_hook(FaultInjectingScanHook(faults={0: ("oom", 1)}, relative=True))
    try:
        futures = {tenant: budget_svc.submit(
            table, checks, tenant=tenant,
            run_policy=RunPolicy(max_total_attempts=0 if k == 1 else 100))
            for k, (tenant, table, checks) in enumerate(members)}
        budget_svc.start()
        results = {tenant: f.result(timeout=300) for tenant, f in futures.items()}
    finally:
        install_scan_fault_hook(prev)
        DEVICE_HEALTH.reset()
        budget_svc.stop(drain=False)
    spent = members[1][0]
    if not results[spent].run_budget.get("exhausted") or all(
            m.value.is_success for m in results[spent].metrics.values()):
        fail("serve_path isolation: the member with no budget did not degrade")
    for tenant, want in serial.items():
        if tenant != spent:
            same_result(want, results[tenant], f"serve_path budget {tenant}")
    return {"batch": SERVE_POISON_BATCH, "poison": SERVE_POISON, "rounds": rounds,
            "injected": len(hook.injected), "quarantined_then_readmitted": True,
            "budget_degraded": spent, "card": smi}


def serve_k1_timing(load, rate: float) -> dict:
    """K1 and its fold merge at a coalesced batch's shape: one pass of Load A
    under the spy, its largest batch (one ``reduce_into`` over every
    member's tasks) held against the plain versions and timed alone, as
    ``fused_scan_timing`` times the resident chunk's; its fold merge the
    same (``k1_merge_timing``)."""
    import torch

    from deequ_tpu_torch.ops import masked_reduce
    from deequ_tpu_torch.serve import VerificationService

    svc = VerificationService(max_batch=SERVE_MAX_BATCH)
    try:
        run_load(svc, load)  # warm
        with K1Spy() as spy:
            run_load(svc, load)
    finally:
        svc.stop()
    torch.cuda.synchronize()
    flat, tasks, offsets = max(spy.batches, key=lambda b: len(b[1]))
    members = len({t.data[0].data_ptr() if t.data else id(t) for t in tasks
                   if t.kind == "sum"})
    batch = masked_reduce.group(tasks, offsets)
    held = k1_hold(tasks, "coalesced batch")
    out = torch.empty_like(flat)
    kernel_ms = time_queued(lambda i: masked_reduce.reduce_into(out, tasks, offsets), reps=20)
    plain_ms = time_cuda(lambda: [t.plain() for t in tasks], reps=5, warmup=1)
    library_ms = time_cuda(lambda: k1_library(tasks), reps=5, warmup=1)
    bound = k1_bound(tasks, offsets, rate)
    merge_args = max(spy.merges, key=lambda a: a[2].numel())
    merge = k1_merge_timing(merge_args, rate)
    return {"column": (f"Load A's largest coalesced batch: {len(tasks)} tasks of "
                       f"{SERVE_ROWS} rows, {members} members' sums, one reduce_into"),
            "tasks": len(tasks), "sources": len(batch.sources), "combos": len(batch.combos),
            "outputs": len(batch.outs), "batches_in_pass": len(spy.batches),
            "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library_call": "one torch.sum / amin / amax a task over its column, summed "
                            "(no mask)",
            **bound, "bound_share": bound["bound_ms"] / kernel_ms, "vs_plain": held,
            "merge": {**merge, "column": f"the same batch's fold merge: {merge['entries']} "
                                         f"entries of {merge['flat_entries']}"}}


def serve_path(table, seed: int, device, smi: str, rate: float) -> tuple:
    """Phase 21 (module doc): the serving tier on the card; Load B's
    tenants are cut from ``table`` (main_path's). Returns (the report,
    Load A), which fleet_path serves again."""
    t0 = time.perf_counter()
    load = serve_load(seed)
    load_s = time.perf_counter() - t0
    kernel_counts_zero()
    t0 = time.perf_counter()
    load_a = serve_load_a(load, device, smi)
    load_a["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    traced = serve_trace(load, device)
    traced["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    load_b = serve_load_b(table, device, smi)
    load_b["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    isolation = serve_isolation(load, device, smi)
    isolation["seconds"] = time.perf_counter() - t0
    launches = kernel_counts()
    k1_require(launches, "serve_path")
    t0 = time.perf_counter()
    k1_time = serve_k1_timing(load, rate)
    k1_time["seconds"] = time.perf_counter() - t0
    return {"load_a": load_a, "trace": traced, "load_b": load_b, "isolation": isolation,
            "kernel_launches": launches, "k1_coalesced": k1_time, "load_build_s": load_s}, load


# -- phase 22: fleet_path -----------------------------------------------------

#: the fleet of the phase: 4 workers on the card, fed by 4 submitter threads
FLEET_WORKERS = 4
FLEET_SUBMITTERS = 4
#: Load A's members held bit for bit against their serial runs (beside
#: every member of the fleet's busiest worker)
FLEET_SAMPLE = 64
#: the timed Load A passes of the fleet and of a 1-worker fleet, in turns
FLEET_TURNS = 2
#: the reference probe's death load (bench.py:measure_fleet_failover):
#: 144 tenants over 12 row counts (64 + 16 * shape), so they spread over
#: the ring, on Size, Completeness, Mean and Sum
FLEET_DEATH_TENANTS = 144
FLEET_DEATH_SHAPES = 12
#: the monitored stall: heartbeat, stall timeout, and the stall itself
FLEET_HEARTBEAT_S = 0.05
FLEET_STALL_TIMEOUT_S = 0.5
FLEET_STALL_S = 1.5
#: the durable ledger's accepted requests, and the whole-check tenants
#: (main_path's width, cut from its table past Load B's)
FLEET_LEDGER_REQUESTS = 200
FLEET_WHOLE_TENANTS = 2
FLEET_POISON = "fleet-poison"


def fleet_death_load(seed: int) -> list:
    """(tenant, table) for the reference probe's 144 tenants, made from
    ``seed``: ``x`` f64 with 5% nulls, ``i`` integral, 64 + 16 * shape
    rows."""
    import numpy as np

    from deequ_tpu_torch.data.table import Column, ColumnarTable, DType

    load = []
    for t in range(FLEET_DEATH_TENANTS):
        r = np.random.default_rng([seed, 7000 + t])
        n = 64 + 16 * (t % FLEET_DEATH_SHAPES)
        load.append((f"death-{t}", ColumnarTable([
            Column("x", DType.FRACTIONAL, values=r.normal(100, 5, n), mask=r.random(n) > 0.05),
            Column("i", DType.INTEGRAL, values=r.integers(0, 50, n).astype(np.float64),
                   mask=np.ones(n, dtype=bool))])))
    return load


def fleet_analyzers():
    from deequ_tpu_torch.analyzers import Completeness, Mean, Size, Sum

    return [Size(), Completeness("x"), Mean("x"), Sum("i")]


def fleet_pass(fleet, load, threads: int = FLEET_SUBMITTERS, **submit) -> tuple:
    """Every (tenant, table, checks) of ``load`` submitted from ``threads``
    threads (a share each), then every future awaited: (wall seconds,
    {tenant: future}, {tenant: result}). A submitter's error is raised
    here, in the calling thread."""
    import threading

    futures, errors = {}, []
    lock = threading.Lock()

    def submitter(items):
        try:
            for tenant, table, checks in items:
                f = fleet.submit(table, checks, tenant=tenant, **submit)
                with lock:
                    futures[tenant] = f
        except BaseException as e:  # noqa: BLE001 — raised by the caller
            errors.append(e)

    t0 = time.perf_counter()
    workers = [threading.Thread(target=submitter, args=(load[i::threads],))
               for i in range(threads)]
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    if errors:
        raise errors[0]
    results = {tenant: f.result(timeout=600) for tenant, f in futures.items()}
    return time.perf_counter() - t0, futures, results


def fleet_once(futures: dict, label: str) -> int:
    """Fails unless every future resolved exactly once; returns the late
    resolutions its gate dropped."""
    bad = [t for t, f in futures.items() if f.resolve_count != 1]
    if bad:
        fail(f"fleet_path {label}: {len(bad)} futures resolved other than once ({bad[:3]})")
    return sum(f.late_resolutions for f in futures.values())


def fleet_placement():
    """Where a fleet of FLEET_WORKERS places a submission: its ring, built
    alone, so that the phase's serial references are computed before any
    fleet runs and before its launch counts are zeroed."""
    from deequ_tpu_torch.serve import ConsistentHashRouter, VerificationFleet, route_digest

    ring = ConsistentHashRouter()
    for w in range(FLEET_WORKERS):
        ring.add_worker(w)

    def place(table, checks=(), required_analyzers=()):
        return ring.place(route_digest(
            table, VerificationFleet._analyzers_of(checks, required_analyzers)))

    return place


def fleet_references(table, load, death) -> dict:
    """Every serial run the phase holds the fleet against, made before its
    launch counts are zeroed (so that the counts are the fleet's own work):
    Load A's sample and every member of its busiest worker; the 144
    tenants; the ledger's 200 requests; the two whole-check tenants."""
    import collections

    from deequ_tpu_torch import VerificationSuite

    place = fleet_placement()
    routed = {t: place(tb, ch) for t, tb, ch in load}
    per_worker = collections.Counter(routed.values())
    busiest = max(per_worker, key=per_worker.get)
    held = {t: (tb, ch) for t, tb, ch in load[:: max(1, len(load) // FLEET_SAMPLE)][:FLEET_SAMPLE]}
    held.update({t: (tb, ch) for t, tb, ch in load if routed[t] == busiest})

    requests = []
    for tenant, tb, checks in load[:FLEET_LEDGER_REQUESTS]:
        analyzers = []
        for check in checks:
            analyzers.extend(check.required_analyzers())
        requests.append((tenant, tb, analyzers))

    # the whole-check tenants: 2^17 rows, or the nearest count below whose
    # digest places them off Load A's busiest worker, so that their
    # grouping kernels run beside that worker's K1 batches
    first = SERVE_WIDE_TENANTS + SERVE_WIDE_SERIAL
    if (first + FLEET_WHOLE_TENANTS) * SERVE_WIDE_ROWS > table.num_rows:
        fail(f"fleet_path: the whole-check tenants need more than the table's {table.num_rows} "
             "rows")
    rows = next(r for r in range(SERVE_WIDE_ROWS, SERVE_WIDE_ROWS - 64, -1)
                if place(slice_rows(table, 0, r), [build_check()]) != busiest)
    start = first * SERVE_WIDE_ROWS
    whole = [slice_rows(table, start + k * rows, start + (k + 1) * rows)
             for k in range(FLEET_WHOLE_TENANTS)]
    return {
        "routed": routed, "per_worker": per_worker, "busiest": busiest,
        "healthy": {t: VerificationSuite.run(tb, ch) for t, (tb, ch) in held.items()},
        "death": {t: VerificationSuite.run(tb, [], required_analyzers=fleet_analyzers())
                  for t, tb in death},
        "ledger_requests": requests,
        "ledger": {t: VerificationSuite.run(tb, [], required_analyzers=an)
                   for t, tb, an in requests},
        "whole_rows": rows, "whole_tables": whole,
        "whole_worker": place(whole[0], [build_check()]),
        "whole": [VerificationSuite.run(t, [build_check()]) for t in whole],
    }


def fleet_healthy(load, refs: dict, device, smi: str) -> tuple:
    """Part 1: Load A over 4 workers from 4 submitters, cold then timed in
    turns with a 1-worker fleet; the holds of the module doc. Returns (the
    report, the K1 spy of the cold pass)."""
    import numpy as np
    import torch

    from deequ_tpu_torch.ops.scan_engine import SCAN_STATS
    from deequ_tpu_torch.serve import VerificationFleet, route_digest

    knobs = {"max_batch": SERVE_MAX_BATCH}
    serial, per_worker = refs["healthy"], refs["per_worker"]
    fleet = VerificationFleet(n_workers=FLEET_WORKERS, monitor=False, distinct_devices=True,
                              worker_knobs=knobs)
    one = VerificationFleet(n_workers=1, monitor=False, distinct_devices=True,
                            worker_knobs=knobs)
    try:
        placed = {str(w.device) for w in fleet._workers.values()}
        if torch.cuda.device_count() == 1 and placed != {str(device)}:
            fail(f"fleet_path: workers placed on {placed}, want every one on {device}")
        moved = [t for t, tb, ch in load if fleet.route(tb, ch) != refs["routed"][t]]
        if moved:
            fail(f"fleet_path: the fleet places {len(moved)} tenants off its ring's placement")

        def checked(flt, label):
            """One pass: summed over the workers every tenant coalesced,
            one fetch, K1 batch and fold merge a coalesced batch, no
            grouping count on the host; each future once; the held
            members bit for bit."""
            before, host = serve_counters(), SCAN_STATS.hist_host_dispatches
            wall, futures, results = fleet_pass(flt, load)
            hold_coalesced(serve_delta(before), f"fleet_path {label}", len(load))
            if SCAN_STATS.hist_host_dispatches != host:
                fail(f"fleet_path {label}: a grouping count ran on the host")
            late = fleet_once(futures, label)
            for t, want in serial.items():
                same_result(want, results[t], f"fleet_path {label} {t}")
            return wall, futures, late

        with K1Spy() as spy:
            cold_s, _, late = checked(fleet, "cold")
        fleet.prewarm()
        checked(one, "1-worker warm")
        walls = {"fleet": [], "one_worker": []}
        latencies = []
        for turn in range(FLEET_TURNS):
            wall, futures, late_t = checked(fleet, f"turn {turn}")
            walls["fleet"].append(wall)
            latencies += [f.latency_seconds for f in futures.values()]
            late += late_t
            walls["one_worker"].append(checked(one, f"1-worker turn {turn}")[0])
        served = {i: w.service.suites_served for i, w in fleet._workers.items()}
    finally:
        fleet.stop()
        one.stop()
    fleet_rate = len(load) / min(walls["fleet"])
    one_rate = len(load) / min(walls["one_worker"])
    # the no-collapse gate (bench.py:1421-1428) on this load too; its
    # placement is skewed, so it is held on the 144 tenants as well
    if fleet_rate < 0.5 * one_rate:
        fail(f"fleet_path: {fleet_rate:.0f} suites/s over {FLEET_WORKERS} workers, under half "
             f"the 1-worker fleet's {one_rate:.0f}")
    lat = np.array(latencies)
    return {
        "tenants": len(load), "workers": FLEET_WORKERS, "submitters": FLEET_SUBMITTERS,
        "placed_on": sorted(placed),
        "tenants_per_worker": {str(w): per_worker.get(w, 0) for w in range(FLEET_WORKERS)},
        "distinct_digests": len({route_digest(tb, [a for c in ch for a in c.required_analyzers()])
                                 for _, tb, ch in load}),
        "suites_served_per_worker": served,
        "bit_for_bit": len(serial), "every_member_of_worker": refs["busiest"],
        "cold_s": cold_s, "walls_s": walls,
        "fleet_suites_per_s": fleet_rate, "one_worker_suites_per_s": one_rate,
        "fleet_over_one_worker": fleet_rate / one_rate,
        "latency_p50_s": float(np.percentile(lat, 50)),
        "latency_p99_s": float(np.percentile(lat, 99)),
        "late_resolutions": late, "card": smi,
    }, spy


def fleet_death(death, serial: dict, smi: str) -> dict:
    """Part 2, the reference probe's death pass: the 144 tenants, which
    spread over the ring, timed on the 4 warm workers and on a 1-worker
    fleet in turns, from one submitter as the probe submits (the
    no-collapse gate, bench.py:1421-1428) and from 4; then the busiest
    worker wedged, the tenants submitted (a run budget each), the worker
    killed: exactly its tenants re-dispatch, each charged
    ``worker_failover`` once, every result bit for bit its serial run."""
    import collections

    from deequ_tpu_torch import RunPolicy
    from deequ_tpu_torch.serve import VerificationFleet

    analyzers = fleet_analyzers()
    warm = [(t, tb, []) for t, tb in death]
    fleet = VerificationFleet(n_workers=FLEET_WORKERS, monitor=False, distinct_devices=True)
    one = VerificationFleet(n_workers=1, monitor=False, distinct_devices=True)
    walls = {subs: {"fleet": [], "one_worker": []} for subs in (1, FLEET_SUBMITTERS)}
    try:
        fleet_pass(fleet, warm, required_analyzers=analyzers)
        fleet_pass(one, warm, required_analyzers=analyzers)
        fleet.prewarm()
        for _ in range(3):
            for subs, by_fleet in walls.items():
                for name, flt in (("fleet", fleet), ("one_worker", one)):
                    wall, futures, _ = fleet_pass(flt, warm, threads=subs,
                                                  required_analyzers=analyzers)
                    fleet_once(futures, f"death load {name}")
                    by_fleet[name].append(wall)
        one.stop()
        routed = {t: fleet.route(tb, required_analyzers=analyzers) for t, tb in death}
        victim = max(set(routed.values()), key=lambda w: sum(v == w for v in routed.values()))
        victims = {t for t, w in routed.items() if w == victim}
        zombie = fleet._workers[victim].service
        fleet.stall_worker(victim, 600.0)
        time.sleep(0.2)
        t0 = time.perf_counter()
        futures = {t: fleet.submit(tb, required_analyzers=analyzers, tenant=t,
                                   run_policy=RunPolicy(max_total_attempts=100))
                   for t, tb in death}
        redispatched = fleet.kill_worker(victim)
        zombie_served = zombie.suites_served
        results = {t: f.result(timeout=600) for t, f in futures.items()}
        wall = time.perf_counter() - t0
        moved = fleet.requests_redispatched
    finally:
        fleet.stop()
        one.stop()
    rates = {subs: {name: len(death) / min(w) for name, w in by_fleet.items()}
             for subs, by_fleet in walls.items()}
    gate = rates[1]
    if gate["fleet"] < 0.5 * gate["one_worker"]:
        fail(f"fleet_path death load: {gate['fleet']:.0f} suites/s over {FLEET_WORKERS} workers, "
             f"under half the 1-worker fleet's {gate['one_worker']:.0f} (one submitter)")
    if redispatched != len(victims) or moved != redispatched:
        fail(f"fleet_path death: worker {victim} held {len(victims)} tenants, "
             f"{redispatched} re-dispatched, {moved} moved in all")
    for t, result in results.items():
        same_result(serial[t], result, f"fleet_path death {t}")
        charges = (result.run_budget or {}).get("charges", {}).get("worker_failover", 0)
        if charges != (1 if t in victims else 0):
            fail(f"fleet_path death: {t} charged worker_failover {charges} times")
    late = fleet_once(futures, "death")
    per_worker = collections.Counter(routed.values())
    return {"tenants": len(death), "shapes": FLEET_DEATH_SHAPES,
            "tenants_per_worker": {str(w): per_worker.get(w, 0) for w in range(FLEET_WORKERS)},
            "walls_s_by_submitters": walls,
            "by_submitters": {subs: {"fleet_suites_per_s": r["fleet"],
                                     "one_worker_suites_per_s": r["one_worker"],
                                     "fleet_over_one_worker": r["fleet"] / r["one_worker"]}
                              for subs, r in rates.items()},
            "no_collapse_gate": "one submitter, fleet >= 0.5x the 1-worker fleet",
            "victim_worker": victim, "victim_tenants": len(victims),
            "redispatched": redispatched, "death_pass_s": wall, "late_resolutions": late,
            "zombie_suites_served_after_kill": zombie.suites_served - zombie_served,
            "zombie_joined": not zombie._thread.is_alive(), "card": smi}


def fleet_monitored(death, serial: dict, smi: str) -> dict:
    """Parts 3 and 4: a stall found by the heartbeat monitor (its requests
    fail over bit for bit, the woken worker's resolutions dropped), then a
    warm rejoin whose joiner builds no serve plan of its own (nor a
    program), then every worker dead, typed. The fleet hands a joiner as
    many plans as the load has shapes (``warm_plans``)."""
    from deequ_tpu_torch.exceptions import ServiceClosedException
    from deequ_tpu_torch.ops.scan_engine import SCAN_STATS
    from deequ_tpu_torch.serve import VerificationFleet

    analyzers = fleet_analyzers()
    load = [(t, tb, []) for t, tb in death]
    fleet = VerificationFleet(n_workers=FLEET_WORKERS, monitor=False, distinct_devices=True,
                              heartbeat_interval=FLEET_HEARTBEAT_S,
                              stall_timeout=FLEET_STALL_TIMEOUT_S,
                              warm_plans=FLEET_DEATH_SHAPES)
    try:
        # warm every plan, hand them round, then arm the monitor: a cold
        # build would read as a stall
        fleet_pass(fleet, load, required_analyzers=analyzers)
        fleet.prewarm()
        fleet.membership.start()
        routed = {t: fleet.route(tb, required_analyzers=analyzers) for t, tb in death}
        victim = max(set(routed.values()), key=lambda w: sum(v == w for v in routed.values()))
        events = len(SCAN_STATS.degradation_events)
        fleet.stall_worker(victim, FLEET_STALL_S)
        time.sleep(0.1)
        t0 = time.perf_counter()
        wall, futures, results = fleet_pass(fleet, load, required_analyzers=analyzers)
        detected_s = time.perf_counter() - t0
        lost = [e for e in SCAN_STATS.degradation_events[events:]
                if e["kind"] == "worker_failover"]
        if fleet.workers_lost != 1 or len(lost) != 1 or "stopped heartbeating" not in lost[0][
                "error"] or lost[0]["worker"] != victim:
            fail(f"fleet_path monitor: {fleet.workers_lost} workers lost, events {lost}")
        for t, result in results.items():
            same_result(serial[t], result, f"fleet_path monitor {t}")
        late = fleet_once(futures, "monitor")
        time.sleep(max(0.0, FLEET_STALL_S - detected_s) + 0.1)  # the stall is over
        if any(f.resolve_count != 1 for f in futures.values()):
            fail("fleet_path monitor: a woken worker's resolution reached a future")
        redispatched = fleet.requests_redispatched

        # part 4: the warm rejoin. On one card the joiner would find every
        # program in the process-wide sub-plan cache even cold, so what is
        # held is its own warmth: it builds no serve plan
        built = SCAN_STATS.programs_built
        worker = fleet.rejoin_worker(victim)
        rejoin = [e for e in SCAN_STATS.degradation_events if e["kind"] == "worker_rejoin"]
        if not rejoin or rejoin[-1].get("warmed_plans", 0) < 1:
            fail(f"fleet_path rejoin: no worker_rejoin event with warmed plans ({rejoin[-1:]})")
        _, futures, results = fleet_pass(fleet, load, required_analyzers=analyzers)
        fleet.flush()
        joiner_served = worker.service.suites_served
        joiner_plans = worker.service.plans_built
        rebuilt = SCAN_STATS.programs_built - built
        if joiner_plans or rebuilt or not joiner_served:
            fail(f"fleet_path rejoin: the joiner built {joiner_plans} serve plans, the fleet "
                 f"{rebuilt} programs, the joiner served {joiner_served} suites (want 0, 0 and "
                 "at least 1)")
        fleet_once(futures, "rejoin")
        for t, result in results.items():
            same_result(serial[t], result, f"fleet_path rejoin {t}")
        for idx in fleet._alive_ids():
            fleet.kill_worker(idx)
        try:
            fleet.submit(death[0][1], required_analyzers=analyzers, tenant="after-all-dead")
            fail("fleet_path: a submit with every worker dead was accepted")
        except ServiceClosedException as e:
            if "no alive" not in str(e):
                fail(f"fleet_path: every worker dead raised {e!r}")
    finally:
        fleet.stop()
    return {"heartbeat_s": FLEET_HEARTBEAT_S, "stall_timeout_s": FLEET_STALL_TIMEOUT_S,
            "stall_s": FLEET_STALL_S, "victim_worker": victim, "pass_s": wall,
            "redispatched": redispatched, "late_resolutions": late,
            "rejoin_warmed_plans": rejoin[-1]["warmed_plans"],
            "joiner_plans_built": joiner_plans, "rejoin_programs_built": rebuilt,
            "joiner_suites_served": joiner_served,
            "all_dead": "ServiceClosedException", "card": smi}


def fleet_quarantine(death, serial: dict, smi: str) -> dict:
    """Part 5: a poison tenant (an OOM that follows it) quarantined by its
    home worker is quarantined on every worker; served by another worker
    it runs serially, and that one success readmits it on all."""
    from deequ_tpu_torch.ops.device_policy import DEVICE_HEALTH, install_scan_fault_hook
    from deequ_tpu_torch.resilience.faults import FaultInjectingScanHook
    from deequ_tpu_torch.serve import VerificationFleet

    analyzers = fleet_analyzers()
    tenant, table = death[5]
    fleet = VerificationFleet(n_workers=FLEET_WORKERS, monitor=False, distinct_devices=True,
                              quarantine_after=2, worker_knobs={"coalesce_window": 0.0})
    prev = install_scan_fault_hook(FaultInjectingScanHook(tenant_faults={FLEET_POISON: "oom"}))
    try:
        try:
            for _ in range(2):
                fleet.verify(table, required_analyzers=analyzers, tenant=FLEET_POISON)
        finally:
            install_scan_fault_hook(prev)
            DEVICE_HEALTH.reset()
        home = fleet.route(table, required_analyzers=analyzers)
        flagged = [i for i, w in fleet._workers.items()
                   if w.service.tenant_health.is_quarantined(FLEET_POISON)]
        if flagged != sorted(fleet._workers):
            fail(f"fleet_path quarantine: quarantined on workers {flagged} only")
        other = next(w for i, w in fleet._workers.items() if i != home)
        healed = other.service.submit(table, required_analyzers=analyzers,
                                      tenant=FLEET_POISON).result(timeout=300)
        if healed.scan_stats.get("coalesced") is not False:
            fail("fleet_path quarantine: the quarantined tenant coalesced on another worker")
        same_result(serial[tenant], healed, "fleet_path quarantine readmission")
        if any(w.service.tenant_health.is_quarantined(FLEET_POISON)
               for w in fleet._workers.values()):
            fail("fleet_path quarantine: one success did not readmit the tenant fleet-wide")
        again = fleet.verify(table, required_analyzers=analyzers, tenant=FLEET_POISON)
        if again.scan_stats.get("coalesced") is not True:
            fail("fleet_path quarantine: the readmitted tenant did not coalesce at home")
        same_result(serial[tenant], again, "fleet_path quarantine home")
    finally:
        fleet.stop()
    return {"home_worker": home, "served_serially_by": other.idx,
            "quarantined_on": len(flagged), "card": smi}


def fleet_ledger(refs: dict, smi: str) -> dict:
    """Part 6: a fleet with a ledger on local disk accepts 200 requests
    (required analyzers only: a check's lambdas need cloudpickle) while its
    workers are stalled and stops without draining; a fresh fleet on the
    directory resolves each on its original future once, bit for bit its
    serial run. Accepts/s with the ledger (an fsync an accept) and
    without."""
    import tempfile

    from deequ_tpu_torch.serve import VerificationFleet

    requests, serial = refs["ledger_requests"], refs["ledger"]

    def accept_all(fleet):
        for idx in range(FLEET_WORKERS):
            fleet.stall_worker(idx, 600.0)
        time.sleep(0.2)
        t0 = time.perf_counter()
        futures = {t: fleet.submit(tb, required_analyzers=an, tenant=t)
                   for t, tb, an in requests}
        return time.perf_counter() - t0, futures

    with tempfile.TemporaryDirectory(prefix="fleet-ledger-") as root:
        plain = VerificationFleet(n_workers=FLEET_WORKERS, monitor=False)
        try:
            plain_s, _ = accept_all(plain)
        finally:
            plain.stop(drain=False)
        first = VerificationFleet(n_workers=FLEET_WORKERS, monitor=False, ledger_dir=root)
        try:
            ledger_s, futures = accept_all(first)
        finally:
            t0 = time.perf_counter()
            leftovers = first.stop(drain=False)
            stop_s = time.perf_counter() - t0
        if len(leftovers) != len(requests) or any(f.done() for f in futures.values()):
            fail(f"fleet_path ledger: {len(leftovers)} of {len(requests)} unresolved at stop")
        second = VerificationFleet(n_workers=FLEET_WORKERS, monitor=False, ledger_dir=root,
                                   resume_futures={f.accept_id: f for f in futures.values()})
        try:
            t0 = time.perf_counter()
            results = {t: f.result(timeout=600) for t, f in futures.items()}
            replay_s = time.perf_counter() - t0
            replayed = len(second.resumed)
        finally:
            second.stop()
    if replayed != len(requests) or any(second.resumed[f.accept_id] is not f
                                        for f in futures.values()):
        fail(f"fleet_path ledger: {replayed} of {len(requests)} replayed on their futures")
    late = fleet_once(futures, "ledger")
    for t, result in results.items():
        same_result(serial[t], result, f"fleet_path ledger {t}")
    return {"requests": len(requests), "replayed": replayed, "late_resolutions": late,
            "accepts_per_s_ledger": len(requests) / ledger_s,
            "accepts_per_s_no_ledger": len(requests) / plain_s,
            "stop_s": stop_s, "replay_s": replay_s, "card": smi}


def fleet_whole_check(load, refs: dict, smi: str) -> dict:
    """Part 7: two whole-check tenants at main_path's width on the fleet's
    serial route while the workers run Load A's coalesced batches: bit for
    bit their serial runs, against numpy, one K7 launch and no K5 launch
    each. Their rows (``fleet_references``) place them off the worker that
    holds Load A's repeat shapes, so their grouping kernels run beside that
    worker's K1 batches."""
    from deequ_tpu_torch.ops import histogram_device
    from deequ_tpu_torch.serve import VerificationFleet

    tables, serial = refs["whole_tables"], refs["whole"]
    fleet = VerificationFleet(n_workers=FLEET_WORKERS, monitor=False,
                              worker_knobs={"max_batch": SERVE_MAX_BATCH})
    try:
        if fleet.route(tables[0], [build_check()]) != refs["whole_worker"]:
            fail("fleet_path whole check: the fleet places the tenants off its ring's placement")
        fleet_pass(fleet, load)  # warm
        k5, k7 = histogram_device.LAUNCHES, histogram_device.FUSED_LAUNCHES
        whole = [(f"whole-{k}", t, [build_check()]) for k, t in enumerate(tables)]
        wall, futures, results = fleet_pass(fleet, whole + load)
        k5, k7 = histogram_device.LAUNCHES - k5, histogram_device.FUSED_LAUNCHES - k7
    finally:
        fleet.stop()
    fleet_once(futures, "whole check")
    if (k5, k7) != (0, FLEET_WHOLE_TENANTS):
        fail(f"fleet_path whole check: K5 {k5} and K7 {k7} launches, want 0 and "
             f"{FLEET_WHOLE_TENANTS}")
    worst = 0.0
    for k, (t, want) in enumerate(zip(tables, serial)):
        got = results[f"whole-{k}"]
        if got.scan_stats.get("coalesced") is not False:
            fail(f"fleet_path whole check: tenant {k} was not served serially")
        same_result(want, got, f"fleet_path whole check {k}")
        expect = {key: v for key, v in expected_metrics(t).items() if key[0] != "CountDistinct"}
        worst = max(worst, check_metrics(got, expect))
    return {"tenants": FLEET_WHOLE_TENANTS, "rows_a_tenant": refs["whole_rows"],
            "beside_load_a_tenants": len(load), "whole_check_worker": refs["whole_worker"],
            "load_a_busiest_worker": [refs["busiest"], refs["per_worker"][refs["busiest"]]],
            "pass_s": wall, "k5": k5, "k7": k7,
            "worst_rel_err_vs_numpy": worst, "card": smi}


def fleet_path(table, load, seed: int, device, smi: str) -> dict:
    """Phase 22 (module doc): the serving fleet on the card, over Load A
    (``load``, serve_path's) and main_path's ``table``. Every serial
    reference is made before the counts are zeroed: the phase's launches
    are the fleet's own."""
    phase_t0 = time.perf_counter()
    death = fleet_death_load(seed)
    t0 = time.perf_counter()
    refs = fleet_references(table, load, death)
    refs_s = time.perf_counter() - t0
    kernel_counts_zero()
    parts = {}
    t0 = time.perf_counter()
    parts["healthy"], spy = fleet_healthy(load, refs, device, smi)
    parts["healthy"]["seconds"] = time.perf_counter() - t0
    for name, run in (("death", lambda: fleet_death(death, refs["death"], smi)),
                      ("monitor_and_rejoin", lambda: fleet_monitored(death, refs["death"], smi)),
                      ("quarantine", lambda: fleet_quarantine(death, refs["death"], smi)),
                      ("ledger", lambda: fleet_ledger(refs, smi)),
                      ("whole_check", lambda: fleet_whole_check(load, refs, smi))):
        t0 = time.perf_counter()
        parts[name] = run()
        parts[name]["seconds"] = time.perf_counter() - t0
    launches = kernel_counts()
    k1_require(launches, "fleet_path")
    # K1 and its fold merge at the fleet's largest coalesced batch, held
    # against their plain versions (after the counts: these launches
    # compare, they are not the path's)
    import torch

    from deequ_tpu_torch.ops import masked_reduce

    flat, tasks, offsets = max(spy.batches, key=lambda b: len(b[1]))
    held = k1_hold(tasks, "fleet batch")
    merge = max(spy.merges, key=lambda a: a[2].numel())
    if not torch.equal(masked_reduce.merge_tags(*merge).view(torch.int64),
                       masked_reduce.merge_tags_plain(*merge).view(torch.int64)):
        fail("fleet_path: the fold merge differs from its plain version in its bits")
    return {"parts": parts, "references_s": refs_s, "kernel_launches": launches, "k1_hold": held,
            "k1_merge_entries": merge[2].numel(), "seconds_in_phase":
                time.perf_counter() - phase_t0}


def nvidia_smi_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if proc.returncode != 0:
        fail(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rows", type=int, default=10_000_000)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    try:
        from deequ_tpu_torch import native
        from deequ_tpu_torch.ops import cuda_build
    except ImportError as e:
        print(f"chip_smoke: run from the root of a deequ_tpu checkout ({e})",
              file=sys.stderr)
        return 3

    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    rate = hbm_rate(kind)
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
          "hbm_bytes_per_s": rate})

    t0 = time.perf_counter()
    cuda_build.build(*KERNELS, verbose=True)
    native_lib = native.build()
    emit({"phase": "build", "built": list(KERNELS), "native": str(native_lib.name),
          "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    parity = kernel_parity(device)
    emit({"phase": "kernel_parity", "kernel": "bincount", **parity,
          "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    kparity = k1_parity(device)
    emit({"phase": "k1_parity", "kernel": "masked_reduce (K1)", **kparity,
          "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    hparity = hll_parity(device)
    emit({"phase": "hll_parity", "kernel": "hll", **hparity,
          "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    sparity = select_parity(device)
    emit({"phase": "select_parity", "kernel": "select", **sparity,
          "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    report, table, main_result = main_path(args.rows, args.seed, device)
    emit({**report, "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    api = check_api_path(table, device)
    emit({**api, "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    shapes = kernel_timing(table, device, rate)
    emit({"phase": "kernel_timing", "kernel": "bincount", "card": smi, "shapes": shapes,
          "boundaries": boundary_timing(device, rate), "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    res_main = resident_main(table, device, main_result, report)
    emit({**res_main, "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    fusion = fusion_path(table, main_result, res_main, device, smi, rate)
    emit({**fusion, "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    hv = hist_variant_path(table, main_result, device, smi, rate, args.seed)
    emit({**hv, "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    part = partition_path(table, args.seed, device)
    emit({**part, "card": smi, "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    stream = stream_path(args.seed, device)
    emit({**stream, "card": smi, "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    repo, hw_time = repository_path(table, main_result, args.seed, device)
    emit({**repo, "card": smi, "seconds": time.perf_counter() - t0})
    emit({"phase": "kernel_timing", "kernel": "holt_winters (K9)", "card": smi,
          "shapes": hw_time})

    t0 = time.perf_counter()
    prof = profile_path(table, args.seed, device)
    emit({**prof, "card": smi, "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    ooc, streamed = out_of_core_path(table, main_result, args.seed, device, smi,
                                     OOC_CONFIG3_RUN_SCALE * args.rows)
    emit({"phase": "out_of_core_path", "card": smi, **ooc,
          "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    spill = spill_path(table, main_result, streamed, args.seed, device, smi,
                       args.rows // SPILL_CONFIG4_CUT)
    emit({"phase": "spill_path", "card": smi, **spill,
          "seconds": time.perf_counter() - t0})
    del streamed

    t0 = time.perf_counter()
    faults = device_fault_path(table, main_result, device, smi)
    emit({"phase": "device_fault_path", "card": smi, **faults,
          "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    mesh = mesh_path(table, main_result, args.rows, args.seed, device, smi, rate)
    emit({"phase": "mesh_path", "card": smi, **mesh, "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    serve, load = serve_path(table, args.seed, device, smi, rate)
    emit({"phase": "serve_path", "card": smi, **serve, "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    fleet = fleet_path(table, load, args.seed, device, smi)
    emit({"phase": "fleet_path", "card": smi, **fleet, "seconds": time.perf_counter() - t0})
    del table, main_result, load

    t0 = time.perf_counter()
    sketch, table, streamed = sketch_path(args.rows, args.seed, device)
    emit({**sketch, "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    htime = hll_timing(table, device, rate, sketch["kernel_launches"]["hll"])
    emit({"phase": "kernel_timing", "kernel": "hll", "card": smi, "shapes": [htime],
          "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    res_sketch = resident_sketch(table, device, streamed, sketch)
    t_sel = time.perf_counter()
    select = select_timing(table, device, rate)
    emit({"phase": "kernel_timing", "kernel": "select (K4)", "card": smi, "shapes": [select],
          "seconds": time.perf_counter() - t_sel})
    res_sketch.update(unpersist_frees(table, device, "resident sketch"))
    emit({**res_sketch, "seconds": time.perf_counter() - t0})
    del table, streamed

    t0 = time.perf_counter()
    sshapes = select_shapes(device, rate)
    emit({"phase": "select_shapes", "kernel": "select", "card": smi, **sshapes,
          "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    freq, table, freq_result = frequency_path(args.rows, args.seed, device)
    emit({**freq, "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    c4 = config4_timing(table, device, rate)
    emit({"phase": "kernel_timing", "kernel": "bincount", "card": smi,
          "shapes": c4["bincount"], "packed_topk": c4["packed_topk"],
          "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    res_freq = resident_frequency(table, device, freq_result, freq)
    emit({**res_freq, "seconds": time.perf_counter() - t0})
    del table, freq_result

    launches = {"main_path": report["kernel_launches"],
                "check_api_path": api["kernel_launches"],
                "fusion_path": fusion["kernel_launches"]["bincount"],
                "sketch_path": sketch["kernel_launches"]["bincount"],
                "frequency_path": freq["kernel_launches"],
                "resident_path": sum(r["kernel_launches"]["bincount"]
                                     for r in (res_main, res_sketch, res_freq)),
                "partition_path": part["kernel_launches"]["bincount"],
                "stream_path": stream["kernel_launches"]["bincount"],
                "repository_path": repo["kernel_launches"]["bincount"],
                "profile_path": prof["kernel_launches"]["bincount"],
                "out_of_core_path": ooc["kernel_launches"]["bincount"],
                "spill_path": spill["kernel_launches"]["bincount"],
                "device_fault_path": faults["kernel_launches"]["bincount"],
                "mesh_path": mesh["kernel_launches"]["bincount"],
                "serve_path": serve["kernel_launches"]["bincount"],
                "fleet_path": fleet["kernel_launches"]["bincount"]}
    hll_launches = {"sketch_path": sketch["kernel_launches"]["hll"],
                    "frequency_path": freq["hll_launches"],
                    "resident_path": sum(r["kernel_launches"]["hll"]
                                         for r in (res_main, res_sketch, res_freq)),
                    "partition_path": part["kernel_launches"]["hll"],
                    "stream_path": stream["kernel_launches"]["hll"],
                    "repository_path": repo["kernel_launches"]["hll"],
                    "profile_path": prof["kernel_launches"]["hll"],
                    "out_of_core_path": ooc["kernel_launches"]["hll"],
                    "spill_path": spill["kernel_launches"]["hll"],
                    "device_fault_path": faults["kernel_launches"]["hll"],
                    "serve_path": serve["kernel_launches"]["hll"],
                    "fleet_path": fleet["kernel_launches"]["hll"]}
    select_launches = {"resident_path": res_sketch["kernel_launches"]["select"],
                       "profile_path": prof["kernel_launches"]["select"]}
    fused_launches = {"main_path": report["fused_launches"],
                      "check_api_path": api["fused_launches"],
                      "sketch_path": sketch["kernel_launches"]["fused_bincount"],
                      "frequency_path": freq["fused_launches"],
                      "resident_path": sum(r["kernel_launches"]["fused_bincount"]
                                           for r in (res_main, res_sketch, res_freq)),
                      "fusion_path": fusion["kernel_launches"]["fused_bincount"],
                      "partition_path": part["kernel_launches"]["fused_bincount"],
                      "stream_path": stream["kernel_launches"]["fused_bincount"],
                      "repository_path": repo["kernel_launches"]["fused_bincount"],
                      "profile_path": prof["kernel_launches"]["fused_bincount"],
                      "out_of_core_path": ooc["kernel_launches"].get("fused_bincount", 0),
                      "spill_path": spill["kernel_launches"].get("fused_bincount", 0),
                      "device_fault_path": faults["kernel_launches"].get("fused_bincount", 0),
                      "mesh_path": mesh["kernel_launches"]["fused_bincount"],
                      "serve_path": serve["kernel_launches"]["fused_bincount"],
                      "fleet_path": fleet["kernel_launches"]["fused_bincount"]}
    k7_time = fusion["kernel_timing"]
    by_path = {"main_path": report["k1_launches"], "check_api_path": api["k1_launches"],
               "sketch_path": sketch["kernel_launches"],
               "frequency_path": freq["k1_launches"],
               "resident_path/main": res_main["kernel_launches"],
               "resident_path/sketch": res_sketch["kernel_launches"],
               "resident_path/frequency": res_freq["kernel_launches"],
               "partition_path": part["kernel_launches"],
               "stream_path": stream["kernel_launches"],
               "repository_path": repo["kernel_launches"],
               "profile_path": prof["kernel_launches"],
               "out_of_core_path": ooc["kernel_launches"],
               "spill_path": spill["kernel_launches"],
               "device_fault_path": faults["kernel_launches"],
               "mesh_path": mesh["kernel_launches"],
               "serve_path": serve["kernel_launches"],
               "fleet_path": fleet["kernel_launches"]}
    k1_launches = {path: c["k1"] for path, c in by_path.items()}
    onehot_launches = {"main_path": report["onehot_launches"],
                       "hist_variant_path": hv["kernel_launches"]["onehot"],
                       **{path: c["onehot"] for path, c in by_path.items()
                          if isinstance(c, dict) and "onehot" in c}}
    k6_head = hv["k6_shapes"][0]
    k1_merges = {path: c["k1_merge"] for path, c in by_path.items()}
    k8_time = mesh["k8_timing"]
    k1_time = res_main["k1_fused_scan"]["k1"]
    k1_merge = res_main["k1_fused_scan"]["k1_merge"]
    k1_coalesced = {k: v for k, v in serve["k1_coalesced"].items()
                    if k not in ("vs_plain", "merge")}
    # the headline shape: the config 4 top-k count, the shape this slice
    # was cut for; every shape timed is listed beside it
    shapes = shapes + c4["bincount"]
    widest = c4["bincount"][0]
    max_err = max([parity["max_abs_err"]] + [s["max_abs_err"] for s in shapes])
    emit({"kernels": [{
        "name": "bincount",
        "route": "cuda",
        "source": "deequ_tpu_torch/csrc/bincount.cu",
        "replaces": "deequ_tpu/ops/histogram_device.py:200",
        "launches": sum(launches.values()),
        "launches_by_path": launches,
        "headline_shape": widest["column"],
        "max_abs_err": max_err,
        "ms": widest["kernel_ms"],
        "plain_ms": widest["plain_ms"],
        "bound_ms": widest["bound_ms"],
        "bound_by": widest["bound_by"],
        "library_ms": widest["library_ms"],
        "parity": "exact" if max_err == 0 else f"max abs err {max_err}",
        "shapes": shapes,
        # mesh_path: each member's counts summed on the lead by torch int64
        # adds (segment._member_counts), no kernel of their own
        "mesh_count_sum": mesh["count_sum_timing"],
    }, {
        "name": "fused_bincount",
        "route": "cuda",
        "source": "deequ_tpu_torch/csrc/bincount.cu",
        "replaces": "deequ_tpu/ops/segment.py:1035",
        "launches": sum(fused_launches.values()),
        "launches_by_path": fused_launches,
        "headline_shape": (f"main_path's fused group: {k7_time['column']}, "
                           f"{sum(k7_time['rows_per_input'])} int64 ids over "
                           f"{k7_time['num_segments']} bins"),
        "max_abs_err": max(parity["fused"]["max_abs_err"], k7_time["max_abs_err"]),
        "ms": k7_time["kernel_ms"],
        "plain_ms": k7_time["plain_ms"],
        "bound_ms": k7_time["bound_ms"],
        "bound_by": k7_time["bound_by"],
        "library_ms": k7_time["library_ms"],
        "library_call": k7_time["library_call"],
        "three_k5_ms": k7_time["three_k5_ms"],
        "parity": "exact",
        "shapes": [k7_time],
    }, {
        "name": "onehot",
        "route": "cuda",
        "source": "deequ_tpu_torch/csrc/onehot.cu",
        "replaces": "deequ_tpu/ops/histogram_device.py:154",
        "launches": sum(onehot_launches.values()),
        "launches_by_path": onehot_launches,
        "launches_by_forced_variant": hv["k6_launches_by_variant"],
        "headline_shape": (f"{k6_head['column']} under the onehot force: {k6_head['n']} "
                           f"{k6_head['ids']} ids over {k6_head['num_segments']} bins"),
        "max_abs_err": max(parity["onehot"]["max_abs_err"], k6_head["max_abs_err"]),
        "ms": k6_head["kernel_ms"],
        "plain_ms": k6_head["plain_ms"],
        "bound_ms": k6_head["bound_ms"],
        "bound_by": k6_head["bound_by"],
        "formulation_ops_ms": k6_head["formulation_ops_ms"],
        "library_ms": k6_head["library_ms"],
        "library_call": k6_head["library_call"],
        "k5_ms": k6_head["k5_ms"],
        "parity": "exact",
        "shapes": hv["k6_shapes"] + [hv["k6_fused_group"]],
        "sweep": hv["sweep"]["rows"],
        "cap_from_sweep": hv["sweep"]["cap_from_sweep"],
        "accel_cap": hv["accel_cap"],
    }, {
        "name": "hll",
        "route": "cuda",
        "source": "deequ_tpu_torch/csrc/hll.cu",
        "replaces": "deequ_tpu/ops/hll.py:350",
        "launches": sum(hll_launches.values()),
        "launches_by_path": hll_launches,
        "max_abs_err": 0,
        "ms": htime["kernel_ms"],
        "plain_ms": htime["plain_ms"],
        "bound_ms": htime["bound_ms"],
        "bound_by": htime["bound_by"],
        "library_ms": htime["library_ms"],
        "library_call": htime["library_call"],
        "parity": "exact",
        "shapes": [htime],
    }, {
        "name": "select",
        "route": "cuda",
        "source": "deequ_tpu_torch/csrc/select.cu",
        "replaces": "deequ_tpu/ops/select_device.py:149",
        "launches": sum(select_launches.values()),
        "launches_by_path": select_launches,
        "max_abs_err": 0,
        "ms": select["kernel_ms"],
        "plain_ms": select["plain_ms"],
        "bound_ms": select["bound_ms"],
        "bound_by": select["bound_by"],
        "library_ms": select["torch_sort_ms"],
        "library_call": "torch.sort of the same (K, n) keys, stable",
        "k3_summary_ms": select["k3_summary_ms"],
        "parity": "exact",
        "shapes": [select],
        "routing_shapes": sshapes["cells"],
    }, {
        "name": "holt_winters",
        "route": "cuda",
        "source": "deequ_tpu_torch/csrc/holt_winters.cu",
        "replaces": "deequ_tpu/anomaly/seasonal.py:77",
        "launches": repo["kernel_launches"]["holt_winters"],
        "launches_by_path": {
            "repository_path/daily_run": repo["daily_run"]["kernel_launches"]["holt_winters"],
            "repository_path/fleet_history":
                repo["fleet_history"]["kernel_launches"]["holt_winters"],
        },
        "headline_shape": hw_time[0]["column"],
        "max_abs_err": repo["holt_winters_parity"]["max_abs_err"],
        "ms": hw_time[0]["kernel_ms"],
        "plain_ms": hw_time[0]["plain_ms"],
        "bound_ms": hw_time[0]["bound_ms"],
        "bound_by": hw_time[0]["bound_by"],
        "bound_share": hw_time[0]["bound_share"],
        "library_ms": None,
        "library_call": None,
        "parity": f"alpha, beta, gamma within {HW_TOL} of the plain fit, same flags",
        "shapes": [{k: v for k, v in row.items() if k not in HW_CHAIN_KEYS}
                   for row in hw_time],
    }, {
        "name": "masked_reduce",
        "route": "cuda",
        "source": "deequ_tpu_torch/csrc/masked_reduce.cu",
        "replaces": "deequ_tpu/ops/df32.py:187",
        "replaces_also": ["deequ_tpu/ops/df32.py:197 masked_count",
                          "deequ_tpu/ops/df32.py:202 masked_extremum",
                          "deequ_tpu/ops/df32.py:260 masked_moments",
                          "deequ_tpu/ops/df32.py:275 masked_comoments"],
        "launches": sum(k1_launches.values()),
        "launches_by_path": k1_launches,
        "headline_shape": (f"the resident main chunk: {k1_time['tasks']} tasks over "
                           f"{k1_time['distinct_tensors']} tensors of {args.rows} rows, "
                           f"{k1_time['sources']} sources, {k1_time['combos']} combos"),
        "max_abs_err": max(kparity["max_abs_err"], k1_time["vs_plain"]["max_abs_err"],
                           serve["k1_coalesced"]["vs_plain"]["max_abs_err"],
                           fleet["k1_hold"]["max_abs_err"]),
        "ms": k1_time["kernel_ms"],
        "plain_ms": k1_time["plain_ms"],
        "bound_ms": k1_time["bound_ms"],
        "bound_by": k1_time["bound_by"],
        "library_ms": k1_time["library_ms"],
        "library_call": k1_time["library_call"],
        "parity": ("counts, min and max exact; sums within 1e-13 sum|x|; m2, x_mk, y_mk "
                   "within 1e-12 relative, ck within 1e-12 sqrt(x_mk y_mk), each plus "
                   "n (128 ulp max|x|)^2; the fold merge bit for bit"),
        "shapes": [{k: v for k, v in k1_time.items() if k != "vs_plain"}, k1_coalesced],
        # serve_path: one batch a coalesced dispatch of K members, whatever K
        "coalesced_batch": k1_coalesced,
    }, {
        "name": "masked_reduce_merge",
        "route": "cuda",
        "source": "deequ_tpu_torch/csrc/masked_reduce.cu",
        "replaces": "deequ_tpu/ops/df32.py:166",
        "launches": sum(k1_merges.values()),
        "launches_by_path": k1_merges,
        "headline_shape": (f"the resident main chunk's fold: {k1_merge['entries']} state "
                           f"entries from a flat vector of {k1_merge['flat_entries']}"),
        "max_abs_err": k1_merge["max_abs_err"],
        "ms": k1_merge["kernel_ms"],
        "empty_launch_ms": k1_merge["empty_launch_ms"],
        "plain_ms": k1_merge["plain_ms"],
        "bound_ms": k1_merge["bound_ms"],
        "bound_by": k1_merge["bound_by"],
        "library_ms": None,
        "library_call": None,
        "parity": "bit for bit",
        "shapes": [k1_merge, serve["k1_coalesced"]["merge"]],
        # K8 (scan_engine.mesh_merge) is k1_merge over the members in
        # member order: its launches are part of mesh_path's above
        "mesh_merge": {
            "replaces": "deequ_tpu/ops/scan_engine.py:541",
            "launches": mesh["kernel_launches"]["k1_merge_in_k8"],
            "headline_shape": (f"{k8_time['members']} members' flat vectors of the main "
                               f"chunk: {k8_time['entries']} state entries of "
                               f"{k8_time['flat_entries']}"),
            "parity": "bit for bit against merge_tags_plain in member order",
            **k8_time,
        },
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
