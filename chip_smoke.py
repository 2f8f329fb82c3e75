#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

1. Prints the device and `nvidia-smi`'s name and power limit.
2. Builds the CUDA kernels from csrc/ with nvcc (-Xptxas -v report shown).
3. Holds each kernel byte for byte against its plain PyTorch version on
   the card.  Fixed-width to-rows and from-rows at (7 rows, 3 columns),
   (1000, 20 with DECIMAL128 and nulls), (2^16, 212 with every third
   column nullable), (2^16 + 7, 212: a ragged last tile), (64, 3000:
   rows too wide to stage), (1, 212), (4099, 212 with every column a
   view one element into its buffer: bases off 16-byte alignment) and
   the main paths' own inputs (the flagship table and the bench table
   below); variable-width to-rows at (7, 3 with one
   string), (1000, 20 with DECIMAL128, nulls, null strings that keep
   their bytes and string offsets that start past 0), (2^16, 155),
   (40, 150 with strings of up to 70000 bytes: every tile too long for
   the kernel's shared row buffer), (3000, 20) and (2000, 10) with strings
   of up to 2000 and 20000 bytes (some tiles too long), (4099, 31) (a row
   count that no timed tile size divides), (300, 17) whose strings are
   all empty, and the JNI-door table below.  Both of the kernel's paths
   (tiles staged in shared memory, and tiles written straight to device
   memory) must have been taken.
4. Runs each main path once, with the launch counts set to 0 just before
   it and read just after it:
   - the flagship step (hashes, to-rows, bucketed sums) on 2^22 rows,
     checked against the same step on the CPU;
   - the bench shape (212 cycled fixed-width columns x 2^19 rows, as in
     bench_impl.py): to-rows -> from-rows must give the input back, and
     the to-rows bytes must equal the plain version's;
   - the JNI-door round trip on a table with strings (155 columns cycling
     INT8, INT32, INT16, INT64, INT32, BOOL8, STRING, UINT16, UINT8,
     UINT64 x 2^20 rows; strings of 0-32 random bytes; every third column
     nullable, about 10% nulls), built on the card with
     interop.table_from_host and registered as handles: the shim's
     murmur_hash3_32 and xx_hash_64 over columns 1, 3 and 6 must equal the
     same calls on the CPU, convert_to_rows must equal the plain version
     byte for byte, convert_from_rows must give every column back, and
     every handle is released.
   Each path must have launched every kernel it runs.
5. Times each kernel with CUDA events after warm-up at its main path's
   shape, beside its plain version and its device-memory bound, and each
   main path's step (median wall time, synchronized).  The fixed-width
   to-rows kernel at three shapes (bench, flagship, and bench with every
   third column nullable), each beside a device-to-device copy of as
   many bytes (`copy_ms`), and at the TO_ROWS_TIMED tiles and ring
   buffers (each checked byte-equal first; printed on a
   `to_rows_variant_ms` line).  The variable-width kernel also at 16,
   32, 64 and 128 rows a tile, and on the 70000-byte strings case, where
   every tile takes its direct path.

6. Drives the TPC-DS stage path (plan/catalog.run_q5 and run_q72 through
   the stage IR, its compiler and the device join probe) at TPC-DS
   SF100's widths (BASELINE.json's north star): q5 over 2^25
   store_sales and 2^22 store_returns rows (about one executor's share
   of 8), 402 stores, a 14-day window of 60 days, join capacity 2^23;
   q72 over 2^22 catalog_sales and 2^21 inventory rows, 204,000 items,
   35 days, 16 weeks, join capacity 2^26.  q72's rows are cut below one
   share of 8 (about 18.0M catalog_sales and 49.9M inventory rows):
   there every catalog_sales row meets about 245 inventory rows of its
   item, about 4.4 billion join pairs, more slots than the card's 80 GB
   holds.  Each query runs in the fused engine (one
   torch.compile'd program per stage) and op by op: the two must give
   the same bytes, both must equal a vectorised numpy oracle over the
   same seeded arrays, and each stage must compile once.  Prints the
   pair totals, the capacity used, each stage's compile seconds, both
   engines' median of 5 synchronized calls and their peak device memory.
   A small q72 whose join capacity is far too small must double through
   the capacity retry on the card.  Then the catalog's other stage
   queries, each over 2^25 fact rows (about one executor's share of 8
   of SF100's 287,997,024 store_sales rows) at SF100's widths, in both
   engines against vectorised oracles (models/tpcds.*_arrays): q3
   (204,000 items, 1,825 days, 1,000 brands approximating i_brand_id's
   distinct count; years=5, manufacturer 3 of the generator's 8, month
   11, LIMIT 100), q9, q67 and CUBE (i_category_id's 10 by i_class_id's
   16) and q89 (402 stores x 204,000 items: 82.0M dense groups, the
   largest sort of the stage path).  The stage path launches none of
   the hand-written kernels.
7. The named query catalog: run_catalog_query for each of its eight
   names at the default parameters on the card, equal to the same call
   with device="cpu"; op by op on both (the fused engine on the card is
   step 6's).  Each name with a cancelled QueryContext must raise
   QueryCancelled and allocate no device memory.  A check of function
   only, untimed: the defaults' few thousand rows are not a query size.
8. GROUP BY and ORDER BY over one GPU batch of store_sales columns:
   2^24 rows of ss_store_sk INT32 (402 values), ss_item_sk INT32
   (204,000), ss_quantity INT32 (1-100), ss_sales_price INT64 cents and
   ss_net_paid FLOAT64 (never negative), the last three about 4% null:
   0.47 GB (2^25 rows, 0.94 GB, near spark-rapids' default target batch
   size of 1 GiB, until step 19 needed the time; the later steps' batches
   of this shape keep 2^25 rows).  groupby_aggregate on (store, item):
   sum(quantity), count(net_paid), min and max(price), sum and
   mean(net_paid); its device group ids
   against the host branch's on the same card data; sort_table by
   (store ASC, price DESC nulls last).  A STRING-keyed group-by and
   order_by at 2^22 rows (1,000 distinct keys of 8-50 bytes; the
   group-by takes the device branch, order_by sorts the strings' device
   key words) and the same group-by and order_by over 2^18 rows of
   257-400-byte keys (the group-by's host rank branch; order_by sorts
   the device words at any length).  Each equals the same call on a CPU copy, byte
   for byte except the float sums and means, which the card adds with
   atomics in a varying order: those are held to |card - cpu| <=
   4 * count * 2^-53 * sum|x| per group (plus 2 ulps for a mean).
   Prints the median of 5 synchronized calls (3 for the sorts and the
   host-branch group-by), the peak device memory and the branch each
   group-by took.
9. The join layer (ops/joins.py, ops/hash_join.py, perf/calibrate.py)
   at one executor's share of 8 of TPC-DS SF100 (J1, J2 and the star
   join's store_sales at a share of 16), each cell drawn on the
   card from a seed: J1 store_sales (2^24 rows, ss_customer_sk INT32
   about 4% null, NULL_UNEQUAL) x customer (SF100's 2,000,000 unique
   keys); J2 store_sales x 2^22 store_returns drawn from the sales rows
   on (ss_item_sk INT32, ss_ticket_number INT64); J3 q72's cut
   catalog_sales (2^22) x inventory (2^21) on 204,000 items, about
   43.1M pairs; J4 2^22 brand-like STRING keys of 8-50 bytes x a
   1,000-row brand dim, and 2^18 keys of 257-400 bytes x 200.  Every
   engine (host_rank, host_hash, device_sort, device_hash) runs by
   name on every cell and must equal a numpy oracle byte for byte
   (int32 pairs on the card); the device engines are timed as the
   median of 5 synchronized calls, the host engines once on the first
   2^21 rows of the left side (JOIN_HOST_ROWS), each with
   the peak device memory its first call added to what was already
   held (`peak_added_mb`); device_hash's first call must double its
   pair capacity on J3 and its second start from the learned one.
   Then the router unpinned, with its verdict file fresh under build/:
   its engine, its verdict and calibration seconds, and its pairs
   against the oracle (keys over 256 bytes must route host_rank).  The
   JNI door's sort_merge_inner_join on J1 through handles, every
   handle released; and models.query.simple_star_join_agg over 2^24
   store_sales rows x 204,000 items grouped by i_brand_id (1,000), SUM
   of INT64 cents and COUNT exact against numpy.
10. The kudo shuffle (shuffle/): an executor's shuffle write and read
   over spark.sql.shuffle.partitions' default of 200 partitions, rows
   placed as Spark's HashPartitioning places them, pmod(murmur3_32(keys,
   42), 200), then ordered by partition with the port's stable order_by
   and a gather.  Two batches: a 2^25-row store_sales batch like step 8's,
   keyed by ss_item_sk; and 2^22 rows of ss_item_sk INT32, a brand-like
   STRING of 8-50 bytes, LIST<INT32> of 0-16 elements, STRUCT<INT64,
   STRING of 0-32 bytes, LIST<FLOAT64> of 0-4> and LIST<STRING> of 0-4
   strings of 0-16 bytes, drawn on the card, about 5% null at every
   level (null rows keep their child data), keyed by (ss_item_sk, the
   STRUCT).  For each: the device split's blob must equal, byte for
   byte, the host writer's over a CPU copy, and the partition offsets
   too; the device assemble of the blob and the merger on the card of
   the tables read from the host bytes must each give back the
   partition-ordered table, validity and offsets at every level; one
   partition written again with the KCRC trailer must read back, and
   with one byte flipped must raise KudoCorruptException.  On the
   nested batch, murmur3_32, xxhash64 and hive_hash over the nested
   columns on the card must equal the CPU's, the JNI door's hive_hash
   must too (every handle released), and a LIST of STRUCT must be
   refused on both.  Prints the device split and assemble (median of 5
   synchronized calls, ms and GB/s of blob), the host writer and merger
   (one call, s), the partition step's hash, sort and gather (ms), the
   blob's bytes, the peak device memory each device call adds and the
   nested hashes' ms, on a `shuffle` line.
11. The memory runtime (memory/, robustness/retry.py, ops/out_of_core.py,
   CompiledStage.run_spilled), every batch drawn on the card from a
   seed.  J2 (step 9: store_sales 2^24 x store_returns 2^22 on
   (ss_item_sk, ss_ticket_number)) out of core at a budget of the build
   side's bytes / 8, so 8 partitions, once on the host tier and once
   with every partition demoted to disk under build/spill: the pairs
   must equal the in-memory join on the card and the numpy oracle byte
   for byte.  Step 8's group-by over a 2^24-row batch out of core at a
   256 MiB budget (the keys and the six value columns it is given make
   0.97 GB, so 4 partitions) against the in-memory call (float sums
   within close_float_sums' bound).  A registered 2^25-row batch that
   nothing else references: spilling it must lower
   torch.cuda.memory_allocated() by at least 90% of its bytes, and
   restoring it must give it back byte for byte on the card; a flipped
   byte in a disk spill file of a 2^22-row batch must recompute from
   source, and without a recompute raise KudoCorruptException naming
   the file and the spill generation.  Four task threads (task ids
   1-4), each reserving and registering its own 2^23-row store_sales
   batch (B bytes), waiting until all four have (a stage barrier the
   adaptor knows of, so memory pressure is certain), and grouping it
   over four key partitions under split_and_retry, reserving B times
   the share of partitions it groups for the working set an attempt:
   first with no limit, then under
   rmm_spark.set_event_handler(3 B) with the spill store installed, at
   least one spill; each task's result must equal its unlimited run,
   and afterwards no reservation, thread or handle may be left and
   memory_allocated() must be back where it started; then one task with
   force_retry_oom and one with force_split_and_retry_oom, each ending
   in the same result.  Each thread is joined with a time limit, and a
   thread still alive fails the run.  q5 at step 6's size, store_sales
   and store_returns hash-partitioned by store key into 4 spilled
   partitions: run_spilled runs q5_partials once per partition, fused;
   the partials summed (int64; the overflow flags OR-ed) and q5_finish
   run must equal run_q5 in one pass byte for byte, with at most one
   compile per row bucket.  The JNI door's spill entries (install,
   spill_ensure_headroom, spill_store_stats_json, uninstall) over a card
   batch.  Prints a `memory` line: each cell's in-memory and out-of-core
   ms (median of 3 synchronized calls), the kudo bytes spilled per tier,
   the restores, the peak device memory each call adds, the spill write
   and restore seconds and the freed bytes, each task's retries, split
   retries and blocked ms and the four tasks' wall time with and
   without the limit, the q5 spilled and single-pass ms and its
   compiles.
12. The string casts and parse_url (ops/cast_string.py with its device
   engines ops/stod_device.py and ops/ftos_device.py, ops/strings_misc.py,
   ops/parse_uri.py, ops/parse_uri_device.py, columns/strbuild.py), every
   column drawn on the card from a seed.  Casts over 2^21 rows of step 8's
   store_sales values (2^24, one executor batch, until step 20 needed the
   time, 2^23 until step 21, 2^22 until step 23): ss_net_paid FLOAT64 (about 4%
   null) and its FLOAT32 rendered by float_to_string on the card, and
   ss_quantity or ss_ticket_number (1 to 24,000,000) rendered by digit
   arithmetic; a seeded 1/16 of each column replaced by an edge
   vocabulary (FLOAT_EDGES: whitespace, signs, "1.", ".5", exponents to
   +-400, 19- and 25-digit mantissas, subnormals, Infinity, NaN, -NaN,
   "1e", "abc", ""; INT_EDGES: overflow, ".5" truncation, signs,
   whitespace).  string_to_float must give every non-null rendered value
   back bit for bit, FLOAT64 and FLOAT32; string_to_integer into INT64,
   INT32 and INT8 every value that fits.  On a 2^18-row slice each cast on
   the card must equal the port's CPU run byte for byte, with as many rows
   sent to the host parse; on a 2^16-row sample the device engines must
   equal the host engines (SPARK_RAPIDS_TPU_STOD=host, _FTOS=host); ANSI
   mode must raise CastException at the first bad row.  The host-loop
   casts (string_to_decimal, both base conversions, conv, the literal
   range pattern, list_slice and the GBK decode) once at 2^16 rows, each
   returning a card column equal to its CPU run, and the JNI door's
   string_to_integer on a card handle, released.  parse_url over 2^20
   URLs (2^22 until step 19 needed the time, 2^21 until step 23) of at
   most 199 bytes drawn from a seeded vocabulary (schemes, userinfo,
   hosts and IPv4 addresses, ports, paths, queries, fragments; about 1%
   IPv6 hosts and 1% non-ASCII paths, the host parser's rows, about 2%
   invalid paths and 4% nulls): PROTOCOL, HOST, QUERY and PATH over all
   of it and over its first 2^20 rows, and QUERY with the key "q" over
   those 2^20 (BASELINE.json's 1e6-row column: keys are matched per row
   on the host); after PROTOCOL the 2^20-row calls must find every chunk
   in the analysis memo.  Each extractor and QUERY-with-key on one 2^17-
   row chunk must equal the CPU run byte for byte with as many host rows,
   and the host parser on a 2^14-row sample; ANSI mode must raise at the
   same row on the card, on the CPU and in the host parser.  Prints a
   `strings` line: each call's lower median ms of 2 synchronized calls
   (the first included) and its first call's ms, rows, MB/s of input chars (output chars for
   float_to_string), padded width and scan steps, rows sent to the host,
   the peak device memory the first call added and the memo hits and
   misses.
13. The JSON family (ops/json_path.py's router over the host oracle,
   ops/json_device.py's per-row scan and ops/json_tokenizer.py's
   structural index; ops/json_utils.py's from_json over
   ops/raw_map_device.py and ops/from_json_device.py; ops/map_utils.py),
   every column drawn on the card from a seed.  2^18 clickstream events
   (a quarter of BASELINE.json's get_json_object column, cut for steps
   19 and 20's time; `event_docs`): event, ts,
   user {id, name, tags}, page, items (0-8 objects of sku, qty and a
   fractional price), ctx 1-5 deep; 100-1,000 bytes (about 400), 4%
   null, a seeded 1/32 replaced by JSON_EDGES (single quotes, escapes,
   control chars, 17-deep nesting, leading zeros, whitespace, duplicate
   keys, non-ASCII, invalid JSON).  get_json_object through the router
   (its verdict file fresh under build/) for `$.event`, `$.user.id`,
   `$.user.name` and `$.ctx.a.b.c` over all 2^18 rows, and for
   `$.items[0]` and `$.items[*].sku` over the first 2^13 (2^14 until
   step 21 needed the time; most of their rows go to the host parser: a
   fractional price in every item, several items); the multi-path entry
   over the six paths on those 2^13; each
   engine pinned (SPARK_RAPIDS_TPU_PATH_JSON_GET_OBJECT) on `$.user.id`,
   the device scan and the tokenizer over 2^17 rows, the host engine
   over 2^13.  Each engine over the six paths on the first 2^13 rows
   must equal its CPU run byte for byte, with as many rows sent to the
   host, and the three engines each other; every router result's first
   2^13 rows must equal the host engine's.  2^18 flat objects of
   4-40 pairs (a seeded 1/256 of 65-70, past the tokenizer's 64; the
   device scan takes 32): from_json_to_raw_map and from_json_to_structs
   (INT64, INT32, FLOAT64, BOOL8, STRING, STRING) through the router,
   the first 2^13 rows under each engine equal to each other, to the
   router's rows and, for the tokenizer, to its CPU run;
   from_json_to_structs_nested (user struct, items list of structs) on
   2^12 events, the host and device engines equal and the host engine
   equal to its CPU run; sort_map_column and map_from_entries on the
   raw map of the first 2^13 rows against the CPU.  Prints a `json`
   line: each call's lower median ms of 2 synchronized calls (one for
   the multi-path entry and the nested structs) and first call's ms, rows,
   MB/s of chars, rows sent to the host, the router's engine, verdict
   and calibration seconds, the peak memory the first call added, the
   scan steps of each chunk.
14. Ingest and the read-side datetime ops (io/, models/filesource.py,
   the JNI door's parquet_read_table and arrow_ingest, ops/datetime_ops
   and ops/orc_timezones).  The operator batch's generator at 2^22
   store_sales rows (a share of 64: cut so steps 16, 17 and 23 fit the
   script's time; 4% null) and the 2^22 STRING keys of 8-50 bytes go to parquet with
   pyarrow under build/ingest: uncompressed with pyarrow's default
   encodings (dictionary pages, v1, 2^20-row groups); the batch once
   more snappy-compressed, as pyarrow and Spark write by default; and a
   2^21-row cut of both (6 columns; 2^22 before steps 16 and 17 needed
   the script's time) uncompressed, once PLAIN v1 and
   once PLAIN v2.  Each file is read whole onto the card and onto the
   CPU, and the batch's uncompressed file and the cuts also projected
   to ss_item_sk and ss_net_paid: every column equal to its source in
   validity and in the bytes of every valid row, the card's read equal
   byte for byte to the CPU's, the projection fetching fewer bytes.
   parquet_read_table of the PLAIN v1 cut and arrow_ingest of a
   RecordBatch of the batch equal their sources, every handle released.
   tpcds_q3_file, tpcds_q7_file and tpcds_q9_file at 2^22 rows (q3 and
   q7 at 204,000 items, q3 at 1,000 brands), each writing and reading
   its files, equal to run_catalog_query of tpcds_q3, q7 and q9 with
   the same params on the card.  A DATE and a TIMESTAMP[us] column
   of 2^23 rows (2^24 until step 19 needed the time; years 1500-2100:
   Julian dates and pre-1970 instants;
   4% null each) read from parquet onto the card: both rebases on both,
   to and from UTC for America/Los_Angeles and Asia/Shanghai, ORC
   rectification Asia/Tokyo -> UTC, truncate at each component and with
   a per-row component column; each held byte for byte to the same call
   on the CPU over the first 2^22 rows.  Prints an `ingest` line: each
   read's ms, file MB/s, the host decode (and the decompression within
   it) and the upload ms apart, the bytes fetched, pages and the peak MiB it added; the queries' ms; each
   datetime call's median ms of 3 and rows/s.  Needs pyarrow; reads the
   system zoneinfo (TZDIR if set).
15. The rest of the op breadth (ops/decimal_utils.py over
   ops/decimal_device.py's limbs, ops/arithmetic.py, ops/cast_more.py,
   ops/sha.py, ops/bloom_filter.py, ops/hllpp.py, ops/histogram.py,
   ops/zorder.py, ops/iceberg.py, ops/substring_index.py,
   ops/case_when.py, ops/uuid_gen.py, shim/jni_entry.py), every column
   drawn on the card from a seed.  Two DECIMAL128 columns of 2^24 rows
   (512 MiB; 2^25, spark.rapids.sql.batchSizeBytes, until step 19 needed
   the time), a of sums at scale -2 below
   5 * 2^64, b of ss_net_paid's prices in cents, 4% null each, 1/64 edge
   rows (zero divisors, +-(10^38 - 1), products that overflow): multiply
   to scale -4, add and sub at -2, divide at -20 with both cast to -4
   (TPC-DS q49's decimal(35,20) ratio), integer divide to 0, remainder at
   -2, routed by the columns' device to the limbs; each against the
   same call on the CPU over the first 2^16 rows, byte for byte against
   the CPU's limbs and, for the overflow flags and every non-overflow
   value, against the host big-int loop; decimal128_binop through the
   JNI door's handles equal to the direct calls, every handle released.
   INT64 multiply (regular, TRY, ANSI raising at the CPU's row) and
   round of FLOAT64 and DECIMAL64 over a 2^25-row batch like step 8's,
   long_to_binary_string over 2^24 rows, and the host-loop casts (string
   to date and timestamp, format_number, hex, decimal to string) over
   2^16.  SHA-256 and SHA-512 of the 2^22 STRING keys and the 2^25 INT64
   prices, against hashlib on the first 2^16 rows.  A v2 bloom filter
   of J1's 2,000,000 customer keys sized by Spark's optimalNumOfBits and
   optimalNumOfHashFunctions at fpp 0.03, probed by 2^25 ss_customer_sk
   (4% null): every built key probes true, its bytes equal the CPU's and
   a merge of two halves.  HLL++ at precision 9 over the 2^25
   ss_customer_sk, grouped by ss_store_sk (402) and as a merge of 8
   partial sketches equal to the whole: sketches equal to the CPU's over
   2^20 rows, the estimates of the whole sketch and the 402 store
   sketches equal to the CPU's estimates of the same sketches, and the
   estimate within 10% of the exact distinct count.  A per-row histogram
   of the 2^25 ss_quantity against the CPU over 2^20 rows, and one from
   its counts with its 0.25, 0.5, 0.75 and 0.99 percentiles against the
   sorted values.  interleave_bits and an
   18-bit hilbert_index of (ss_item_sk, ss_customer_sk); Iceberg bucket(16)
   of the INT64 prices and the STRING keys, truncate(10), and year,
   month, day and hour of a 2^24-row TIMESTAMP of 1500-2100;
   substring_index over step 12's 2^20 URLs; 2^22 random UUIDs (format,
   seed determinism, no repeat in 2^16); select_first_true_index over
   four BOOL8 columns of 2^25 rows.  Every other call equals the same
   call on a CPU copy over its first 2^16-2^20 rows byte for byte.
   Prints an `ops` line: each call's median ms of 3 synchronized calls
   and first call's ms, rows/s, route (device limbs, host loop or plain
   torch), the peak MiB its first call added and the CUDA kernels a
   call (launches torch.profiler records).
16. The protobuf decoder (ops/protobuf.py's router and host oracle,
   ops/protobuf_device.py's field-step engine, jni_entry's entry):
   2^21 clickstream events (2^22 until step 23 needed the time) as
   Kafka values decoded by Spark's from_protobuf, drawn on the card from a seed (`protobuf_events`):
   event_id (required), user_id up to 2^40, a URL from step 12's
   vocabulary, a 2026 ts_us, a double price, an int32 quantity (default
   1), a sint64 ZIGZAG delta with negatives, a bool, a float score, a
   fixed32 shard, a nested device message (os, version, mobile), 0-16
   packed int64 item_ids and 0-4 unpacked string tags; 150-400 bytes
   each (about 0.9 GB of chars), 4% null rows, a seeded 1/64 of edge
   rows (PB_EDGES: truncated varint and payload, wire types 3, 4, 6 and
   7, a missing event_id, unknown fields, wire-type mismatches,
   duplicates where the last wins, empty messages and packed payloads,
   a malformed nested message, length varints of 2^63 and 2^64 - 1).  The call must take the device route
   (the card column's device, no fallback); its first 2^18 rows equal
   the host oracle over a CPU copy on every valid row (pb_canonical:
   the engine keeps what it captured under null rows).  A 2^16-row
   column whose last row holds 40 item_ids (past the repeat cap of 32)
   must take the host route whole, counted, equal to the oracle; one
   call through jni_entry.protobuf_decode_to_struct on handles with the
   flat fields, every handle released.  Prints a `protobuf` line: the
   first call's ms and the median of 3 synchronized calls, MB/s of
   chars, the chunk size, the scan steps of each chunk, the CUDA
   kernels a call (launches torch.profiler records), the scalars read
   back to the host and the rows sent there, the peak MiB the first call
   added.
17. Distributed q5 and q72 (distributed/: the launcher, the runner, the
   shuffle service over unix sockets, kudo between the processes) as
   worker processes sharing the card, each regenerating step 6's seeded
   data (at half its rows) on the card and taking its shard, partials
   and finish through
   plan/catalog's fused stages (inductor's and Triton's caches under
   build/ shared with step 6).  Launch A: two ranks, q5 (2^24 x 2^21,
   402 stores) and q72 (2^21 x 2^20, 204,000 items); launch B: q72 with
   rank 1's first reduce-scatter send to rank 0 corrupted, NAKed and
   resent; launch C: the elastic protocol over three ranks, q5, rank 2
   killed after its partials and before broadcasting them, respawned
   once.  B and C run op by op (models/tpcds' map and reduce sides):
   they test the link and the fleet.  Every rank's result must equal single_q5 / single_q72 run in
   this process at the same params, byte for byte; B's summaries must
   show the NAK and the resend, and C a survivor's record of rank 2's
   death and of taking its shard.  Prints a `distributed` line per
   launch: wall s, and per rank boot s (spawn to a CUDA context), the
   fused stages' compile s, each query's s, partials and exchange ms,
   bytes and frames over the sockets, NAKs and resends, the fleet's
   events, the mesh mode and the peak MiB the worker allocated.  The
   workers run with metrics and tracing on (as the JAX worker does),
   and each rank's span, metrics and journal dumps beside its summary
   must agree with it: every span carries the launcher's trace id, the
   link byte and frame counters equal the summary's, every failed link
   attempt is counted (NAKs received and sent too); launch B's workers
   run with SPARK_RAPIDS_TPU_LOCKDEP=1, and their journals and metrics
   must show no lock-order cycle and the link lock instrumented.
18. The observability core (observability/, analysis/lockdep.py,
   utils/telemetry.py): the flagship step (2^22 rows, launching the
   fixed-width to-rows kernel), one map task's kudo write of a 2^22-row
   store_sales batch in 200 hash partitions and their merge onto the
   card, and memory's forced retry and forced split task rounds (2^20
   rows), first with observability off, then with metrics and tracing
   on under one root span while the telemetry Monitor samples every
   50 ms.  The flagship outputs and the merged table must be byte-equal
   between the runs (the task group-bys within close_float_sums'
   bound), every traced kudo table must be the untraced bytes behind a
   20-byte KTRX prefix naming its own kudo_write span, the counters
   must equal the known counts (bytes written, rows merged, one
   injected retry and one split), the journal and span ring must drop
   nothing, every span of the run must nest under the root, both dumps
   must parse, and the Monitor's HBM samples in a quiet window must be
   within 1% of torch.cuda.memory_allocated() read in the same listener
   call.  Prints an `observability` line: the flagship step and the
   shuffle write ms off and on, spans finished, journal events,
   samples and the phase's seconds.
19. The rest of observability and the caches (the query profiler with
   time attribution and the critical path, data statistics, the
   timeseries sampler and SLOs, the result cache, the flight
   recorder).  (a) The flagship step (2^22 rows, launching the
   fixed-width to-rows kernel) and tpcds_q5_fused at the stage path's
   size (2^25 x 2^22, 402 stores; its stages under 'auto', so the
   first run measures fused against op by op on a 2^18-row sample),
   first with everything off, then each as a profiled query with
   metrics, tracing, stats, attribution, the timeseries sampler (driven
   by the telemetry Monitor at 50 ms) and the SLO monitor on.  Outputs
   must be byte-equal between the runs, the q5 profile must hold a
   record of each stage, each ledger must conserve the query's wall
   within its tolerance, the critical path over the query's spans must
   cover its wall, and the windowed counter deltas must sum to the
   registry's cumulative values.  (b) The result cache armed: the q5
   pipeline twice, the second run hitting once per stage with the
   first's bytes (the miss, the hit and the inputs' digest timed), and
   tpcds_q5_incremental at 2^25 rows a batch: run, its stream's epoch
   bumped twice, run warm; its rows must equal a cold recompute with
   the cache off, and exactly the two new batches must fold.  (c) The
   flight recorder armed to a directory under build/: memory's forced-
   OOM task with its attempts cut to 2 (retry_exhausted) and a
   CRC-flipped kudo table read for a merge (kudo_corrupt) must leave two
   bundles, each parsed and inside the byte budget, named by the JNI
   door's health_json and incident_list, and srt_incidents_total must
   read 2.  (d) Step 17's launch A writes each rank's query profiles;
   merge_profiles must fold them into one fleet profile per query whose
   stages hold every rank.  Prints an `observability_plane` line: the
   profiled and unprofiled step and q5 ms, the stage cache's miss, hit
   and digest ms, the incremental q5's cold and warm ms, the incidents
   and their bundle bytes, the timeseries windows and the phase's
   seconds.
20. The query server (server/, robustness/lifeguard.py, the shim's
   server_* entries, analysis/plan_verify.py), driven as the JVM would
   drive it.  (a) server_start with 3 pool threads; four tenants submit
   tpcds_q5 (2^25 x 2^22 rows, 402 stores, step 6's join capacity),
   tpcds_q9 and tpcds_q3 (2^25 rows, 204,000 items, 1,000 brands) and
   tpcds_q72 (step 6's 2^22 x 2^21 cut, 204,000 items) at two seeds
   each through server_submit, with metrics, tracing, profiles and the
   SLO monitor on.  Every result must equal a direct run_catalog_query
   of the same request on the main thread (run once a request, before
   the server starts); each tenant's stats must count its requests; the
   journal must hold server_admit and server_complete for every
   tenant, each request one server_query span with its own task id,
   the srt_server_* families in the exposition, one SLO event a
   completion, and server_profile_json a retained profile.  (b) The
   flagship step (2^22 rows) registered as a query and served to two
   tenants at once: the rows must equal the main thread's, and the
   fixed-width to-rows kernel must launch once a request.  (c) A full
   queue and a tenant over its in-flight quota are refused typed
   (queue_full, tenant_inflight, that tenant alone); a query whose first
   attempt meets an injected GpuRetryOOM is requeued at a strictly
   lower task priority and then succeeds.  (d) A q5 with a 0.2 s
   deadline is cancelled by the watchdog (deadline); a query that sleeps
   without a heartbeat under hang_s = 2 s is declared hung, its task
   force-released, its worker replaced, a q9 waiting behind it finishes
   past the 1 s stall bar, and the flight recorder holds a query_hang
   and an admission_stall bundle (torch.cuda.memory_allocated() before
   and after is printed); a query failing twice is quarantined, refused
   typed, and readmitted by a probe after the cooldown.  (e) q5 over the
   unix socket door equals (a)'s rows; server_drain with a q5 and a
   gated query in flight refuses a new submit as draining, finishes
   both, and writes the journal, span and metric dumps; a following
   server_start serves q9 again with no new compile (dynamo's graph
   count is unchanged over the whole phase).  (f) Every plan the script
   compiled was verified exactly once, and a plan with a non-bool Where
   condition or an unbound column is refused with PlanVerifyError
   before it compiles.  Prints a `server` line: per-request and queue
   wait ms, q5 through the server over its direct call, rejects,
   requeues, watchdog actions, quarantine events, the drain report,
   the socket round trip and the phase's seconds.
21. The offline tools and the op layer's sidecars (utils/profiler.py,
   utils/fault_injection.py, utils/tracing.py, tools/).  (a) The
   flagship step (2^22 rows), median of 5, four ways: every sidecar
   off, the full bracket with nothing recording (as under an attached
   NVTX tool), the profiler streaming through the JNI door's profiler_*
   entries (alloc capture on, the step's task reserving its rows' bytes
   under an adaptor), and tracing on.  Every step's outputs must equal the
   first step's, the to-rows kernel must launch once a step, the stream
   must hold one op range each for murmur3_32, xxhash64 and
   convert_to_rows a step and an alloc and a free a step, tracing one op
   span each a step, and profile_converter's --summary calls and
   --chrome ranges must equal the op calls.  (b) A seeded GpuRetryOOM
   rule on convert_to_rows inside with_retry around the step (3
   attempts, a task holding the rows' bytes) must exhaust the retries
   and freeze exactly one retry_exhausted bundle whose fault_rules.json
   holds the rule; doctor --json must rank the fault_injection finding
   first (severity 95, naming the rule) and name the task holding device
   memory.  After uninstall the step runs byte-equal, and a
   CudfException rule on murmur3_32 raises typed at jni_api's
   murmur_hash3_32.  (c) The tools over files earlier phases wrote
   (copied under build/tools before those phases remove theirs):
   doctor on step 20's query_hang and admission_stall bundles, whose
   trigger each must be among its findings; metrics_report --json on
   the drain's journal (the server table present); trace_export on the
   drain's spans (no orphan); srt_explain merging launch A's per-rank q5
   profiles; srt_top --once --json twice over step 19's timeseries
   snapshot (the two frames byte-identical); srt_check clean on the
   port's tree and --plan verifying the seven catalog plans.  The tools
   run in this process through their main(argv).  Prints a `tools`
   line: the step's ms in the three modes beside the main path's, the
   launches a step, the op ranges, the bundles, doctor's first finding
   for each bundle, each tool's seconds and the phase's seconds.
22. The rest of the JVM door (shim/jni_entry.py), driven as the JNI
   library would drive it, end to end on the card.  The three host
   libraries (native/*.cpp: the kudo engine, the OOM state machine, the
   string rank) are built with g++ under build/native at once and must
   load.  initialize() puts the entries on the card.  The JNI-door table
   of step 4 (155 columns x 2^20 rows, drawn anew from seed 22) comes in
   through the entries: its fixed-width columns as one Arrow batch
   (arrow_ingest), each STRING column as its whole buffers
   (from_strings_bulk).  convert_to_rows runs the variable-width kernel
   (B3), convert_from_rows gives the table back, and the strings read
   back through string_column_chars / string_column_offsets must equal
   the bytes that went in.  The fixed-width bench table (212 x 2^19)
   goes through both entries (B1, B2).  Each launch's bytes must equal
   its kernel's plain version on the same inputs and the same entries'
   run on the CPU (the string table's first 2^15 rows: the CPU's plain
   paste takes seconds per 2^15 rows; the fixed-width table whole).
   kudo_write of the fixed-width table into 200 partitions twice, the
   memo's miss and then its hit, must give the spec engine's bytes;
   kudo_merge of every partition and export_kudo_host /
   columns_from_kudo_host must give the table back on the card; a host
   table round trip; under an RmmSpark limit a task meets one forced
   retry and one forced split through the rmm_* entries.  shutdown()
   with a server running must leave no live handle, memo entry, host
   table or server.  Each kernel must have launched once in the drive,
   and nothing after the row entries launched one.  Prints a `jvm_door`
   line: each entry's ms, the launches, the memo's miss and hit ms, the
   native and spec kudo ms, the host table's bytes, each library's build
   seconds, the peak device MiB after the row entries and over the phase
   (the checks' plain versions included) and the phase's seconds.
23. The mesh programs (distributed/mesh.py, distributed/pool.py,
   parallel/exchange.exchange, models/distributed_join.py,
   models/query.make_distributed_hash_aggregate, the models/tpcds and
   plan/catalog mesh factories, shim/jni_mesh.py), run as SPMD over a
   torch.distributed process group, one process a rank.  M1: the JVM
   door's flagship_q5_mesh(1, 2^25, 402) and flagship_q72_mesh(1, 2^22,
   204,000) start one rank over NCCL on the card (step 6's sizes), each
   called twice (the second reuses the started rank and the join
   capacity it learned from the JAX entries' 4096), each list equal to
   the single-device make_q5 / make_q72 on the same q5_mesh_data /
   q72_mesh_data; an entry asked for more ranks than the card count
   must raise ShimStateError.  M1's rank boots while M2 runs.  M2: two
   rank processes, started in this step, share the card over gloo
   (NCCL refuses two ranks on one GPU; gloo moves the CUDA tensors
   through the host itself), each rank drawing the data on the card
   from one seed and taking its shard: the exchange of step 8's
   store_sales (ss_item_sk, ss_sales_price) at 2^24 rows a rank, each
   rank's
   received rows equal to its partition of the whole batch in order;
   the distributed join of 2^22 item keys a rank against SF100's
   204,000 items from an exchange capacity of 2^20 (both ranks must
   double it together), each rank's pairs equal to the single-process
   join of its partition; the hash aggregate over 2^24 rows a rank
   (counts equal to one process's, f32 sums within 2 n 2^-24 sum|v|);
   q5 op by op and fused (one graph a rank, its all_reduces inside)
   and q72 op by op at step 6's sizes, equal on both ranks and to the
   single-process queries.  Prints a `mesh` line per launch: backend
   and mode; per rank boot s, compile s and graphs, each part's ms,
   all_to_all calls and bytes, all_reduce calls, doublings and peak
   MiB; each query's ms beside the single-process one.  No row kernel
   is on this path: its launch counts are the script's and every
   rank's own (each rank zeroes its counts when it starts its work).
   Ends with the seconds each phase took.

Prints a `{"kernels": [...]}` line and, last, `{"ok": true, "device":
{...}}`.  Any failed check raises, so the exit code is not 0 and no
result line is printed; so does a machine without a CUDA device.
"""

import contextlib
import datetime
import gc
import hashlib
import io
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import threading
import time

# compiled stages cache their programs inside the checkout
_BUILD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR",
                      os.path.join(_BUILD, "inductor"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(_BUILD, "triton"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from spark_rapids_tpu_torch.columns import dtypes, interop  # noqa: E402
from spark_rapids_tpu_torch.columns.column import Column  # noqa: E402
from spark_rapids_tpu_torch.columns.table import Table  # noqa: E402
from spark_rapids_tpu_torch.columns import strbuild as SB  # noqa: E402
from spark_rapids_tpu_torch.memory import rmm_spark  # noqa: E402
from spark_rapids_tpu_torch.memory import spill as PS  # noqa: E402
from spark_rapids_tpu_torch import models as TM  # noqa: E402
from spark_rapids_tpu_torch.models import flagship as F  # noqa: E402
from spark_rapids_tpu_torch.models import query as Q  # noqa: E402
from spark_rapids_tpu_torch.models import tpcds as TT  # noqa: E402
from spark_rapids_tpu_torch.io import parquet_reader as PR  # noqa: E402
from spark_rapids_tpu_torch.models import filesource as FS  # noqa: E402
from spark_rapids_tpu_torch.ops import arithmetic as AR  # noqa: E402
from spark_rapids_tpu_torch.ops import bloom_filter as BF  # noqa: E402
from spark_rapids_tpu_torch.ops import case_when as CW  # noqa: E402
from spark_rapids_tpu_torch.ops import cast_more as CM  # noqa: E402
from spark_rapids_tpu_torch.ops import cast_string as CS  # noqa: E402
from spark_rapids_tpu_torch.ops import copying as CP  # noqa: E402
from spark_rapids_tpu_torch.ops import datetime_ops as DT  # noqa: E402
from spark_rapids_tpu_torch.ops import decimal_utils as DU  # noqa: E402
from spark_rapids_tpu_torch.ops import groupby as G  # noqa: E402
from spark_rapids_tpu_torch.ops import hash as H  # noqa: E402
from spark_rapids_tpu_torch.ops import hash_join as HJ  # noqa: E402
from spark_rapids_tpu_torch.ops import histogram as HG  # noqa: E402
from spark_rapids_tpu_torch.ops import hllpp as HLL  # noqa: E402
from spark_rapids_tpu_torch.ops import iceberg as IB  # noqa: E402
from spark_rapids_tpu_torch.ops import json_device as JD  # noqa: E402
from spark_rapids_tpu_torch.ops import json_path as JP  # noqa: E402
from spark_rapids_tpu_torch.ops import json_tokenizer as JT  # noqa: E402
from spark_rapids_tpu_torch.ops import json_utils as JU  # noqa: E402
from spark_rapids_tpu_torch.ops import joins as J  # noqa: E402
from spark_rapids_tpu_torch.ops import map_utils as MU  # noqa: E402
from spark_rapids_tpu_torch.ops import orc_timezones as OTZ  # noqa: E402
from spark_rapids_tpu_torch.ops import out_of_core as OOC  # noqa: E402
from spark_rapids_tpu_torch.ops import parse_uri as U  # noqa: E402
from spark_rapids_tpu_torch.ops import parse_uri_device as UD  # noqa: E402
from spark_rapids_tpu_torch.ops import protobuf as PBF  # noqa: E402
from spark_rapids_tpu_torch.ops import protobuf_device as PD  # noqa: E402
from spark_rapids_tpu_torch.ops import raw_map_device as RM  # noqa: E402
from spark_rapids_tpu_torch.ops import row_assembly_cuda as RA  # noqa: E402
from spark_rapids_tpu_torch.ops import row_conversion as RC  # noqa: E402
from spark_rapids_tpu_torch.ops import sha as SHA  # noqa: E402
from spark_rapids_tpu_torch.ops import sorting as S  # noqa: E402
from spark_rapids_tpu_torch.ops import stod_device as SD  # noqa: E402
from spark_rapids_tpu_torch.ops import strings_misc as SM  # noqa: E402
from spark_rapids_tpu_torch.ops import uuid_gen as UG  # noqa: E402
from spark_rapids_tpu_torch.ops import zorder as Z  # noqa: E402
from spark_rapids_tpu_torch.ops.substring_index import (  # noqa: E402
    substring_index as substring_index_op)
from spark_rapids_tpu_torch.ops.exceptions import (  # noqa: E402
    CastException, ExceptionWithRowIndex)
from spark_rapids_tpu_torch.parallel import exchange as EX  # noqa: E402
from spark_rapids_tpu_torch.plan import catalog as TC  # noqa: E402
from spark_rapids_tpu_torch.perf import calibrate as CAL  # noqa: E402
from spark_rapids_tpu_torch.perf.jit_cache import bucket_rows  # noqa: E402
from spark_rapids_tpu_torch.plan.compiler import compile_stage  # noqa: E402
from spark_rapids_tpu_torch.robustness import retry as RT  # noqa: E402
from spark_rapids_tpu_torch.shim import jni_api  # noqa: E402
from spark_rapids_tpu_torch.shim import jni_entry as JE  # noqa: E402
from spark_rapids_tpu_torch.shim.handles import REGISTRY  # noqa: E402
from spark_rapids_tpu_torch.shuffle import device_split as DS  # noqa: E402
from spark_rapids_tpu_torch.shuffle import kudo as K  # noqa: E402
from spark_rapids_tpu_torch.shuffle import split_assemble as SA  # noqa: E402
from spark_rapids_tpu_torch.shuffle.schema import schema_of_table  # noqa: E402
from spark_rapids_tpu_torch.utils import cuda_build  # noqa: E402

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
BENCH_ROWS = 1 << 19
BENCH_COLS = 212
FLAGSHIP_ROWS = 1 << 22
TIMED_ITERS = 20
PLAIN_ITERS = 3
STEP_ITERS = 5
# (rows, columns, every n-th column nullable, every n-th column DECIMAL128,
# columns as views one element into their buffers): the fixed-width
# kernels' edges too, a ragged last tile, rows too wide to stage, one row,
# and column bases that are width-aligned but not 16-byte aligned
KERNEL_CASES = [(7, 3, 0, 0, 0), (1000, 20, 3, 11, 0),
                (1 << 16, 212, 3, 0, 0), ((1 << 16) + 7, 212, 3, 0, 0),
                (64, 3000, 0, 0, 0), (1, 212, 3, 11, 0),
                (4099, 212, 3, 11, 1)]
# (rows per tile (log2), ring buffers) at which the fixed-width to-rows
# kernel is timed beside the wrapper's choice, at the bench and flagship
# shapes
TO_ROWS_TIMED = {"bench": ((4, 2), (5, 1), (5, 2), (6, 1)),
                 "flagship": ((8, 2), (9, 1), (9, 2), (10, 2))}
# the string main path: the column cycle, after the upstream
# benchmarks/row_conversion.cpp variable_or_fixed_width case with strings
STRING_CYCLE = ["int8", "int32", "int16", "int64", "int32", "bool8",
                "string", "uint16", "uint8", "uint64"]
STRING_ROWS = 1 << 20
STRING_COLS = 155
STRING_MAX_LEN = 32
HASH_KEYS = (1, 3, 6)   # INT32, INT64, STRING
# (rows, columns, first cycle entry, every n-th column nullable, every
# n-th column DECIMAL128, string offsets' start, longest string)
LONG_STRINGS_CASE = (40, 150, 6, 3, 0, 0, 70000)
VAR_KERNEL_CASES = [(7, 3, 5, 0, 0, 0, 32), (1000, 20, 0, 3, 11, 5, 32),
                    (1 << 16, 155, 0, 3, 0, 0, 32), LONG_STRINGS_CASE,
                    (3000, 20, 0, 3, 0, 0, 2000),
                    (2000, 10, 6, 3, 0, 3, 20000),
                    (4099, 31, 3, 3, 0, 7, 32), (300, 17, 0, 3, 0, 0, 0)]
# rows per tile at which the variable-width kernel is timed (log2)
VAR_TIMED_TILES = (4, 5, 6, 7)
# the TPC-DS stage path at SF100's widths: 402 stores and 204,000 items
# are SF100's; days=60 (q5) and the inventory at half the catalog_sales
# rows over 35 days (q72) are the JAX package's registry entries
# (spark_rapids_tpu/models/__init__.py).  q5's rows are about one
# executor's share of 8 (SF100: 287,997,024 store_sales rows); q72's
# are cut to about a quarter of catalog_sales' share (143,997,065 / 8)
# and a 24th of inventory's (399,330,000 / 8), since a full share would
# join into about 4.4 billion pair slots, beyond the card's memory
Q5_DATA = dict(rows=1 << 25, stores=402, days=60, seed=5)
Q5_CAPACITY = 1 << 23      # about 7.83M sales pairs: no doubling
Q72_DATA = dict(cs_rows=1 << 22, inv_rows=1 << 21, items=204_000, days=35,
                seed=72)
Q72_CAPACITY = 1 << 26     # about 43.1M pairs: no doubling
Q72_MAX_WEEK = 16
Q72_WEEK0 = 11_000 // 7
Q72_LIMIT = 100
# far too small a join capacity: the retry must double it
Q72_SMALL_DATA = dict(cs_rows=1200, inv_rows=1200, items=4, days=35)
Q72_SMALL_CAPACITY = 1 << 12
# the catalog's other stage queries, each over 2^25 fact rows (about
# one executor's share of 8 of SF100's store_sales) at SF100's widths:
# 204,000 items and 402 stores are SF100's; 1,825 days are the five
# years of store_sales' date range; brands = 1,000 approximates
# i_brand_id's distinct count at SF100; q67's 10 categories and 16
# classes are i_category_id's 1-10 and i_class_id's 1-16.  The spreads
# are the JAX package's generators' (q3: 8 manufacturers, prices
# 100-49,999 cents; q9: quantities 1-100; q67: sales 100-49,999; q89:
# sales 100-29,999)
Q3_DATA = dict(rows=1 << 25, items=204_000, days=1_825, brands=1_000,
               seed=3)
Q3_BASE = 10_957
Q3_PARAMS = dict(years=5, manufact=3, month=11, limit=100)
Q9_DATA = dict(rows=1 << 25, seed=9)
Q67_DATA = dict(rows=1 << 25, ncat=10, ncls=16, seed=67)
Q89_DATA = dict(rows=1 << 25, stores=402, items=204_000, seed=89)
# the named queries, at the JAX package's default parameters
CATALOG_NAMES = ("tpcds_q3", "tpcds_q5", "tpcds_q7", "tpcds_q9",
                 "tpcds_q72", "tpcds_q3_fused", "tpcds_q5_fused",
                 "tpcds_q72_fused")
# one GPU batch of store_sales columns for the operators: 2^25 rows,
# 28 bytes a row (0.94 GB, near spark-rapids' default target batch of
# 1 GiB, spark.rapids.sql.batchSizeBytes), about 4% nulls in each value
# column
OPS_ROWS = 1 << 25
# the operators' own batch: half of OPS_ROWS since step 19 needed the
# time (its CPU reference group-by and sort over the batch dominate)
OPERATORS_ROWS = 1 << 24
OPS_NULL_SHARE = 0.04
STR_OPS_ROWS = 1 << 22      # brand-like STRING keys, 8-50 bytes
STR_DISTINCT = 1_000
LONG_STR_ROWS = 1 << 18     # keys of 257-400 bytes: the host rank branch
LONG_STR_DISTINCT = 200
U53 = 2.0 ** -53
# the join layer at one executor's share of 8 of TPC-DS SF100: J1
# store_sales x customer (SF100's 2,000,000 rows, unique keys) on
# ss_customer_sk, about 4% null (dsdgen's nullable foreign key); J2
# store_sales x store_returns drawn from the sales rows on (item,
# ticket); J3 q72's catalog_sales x inventory on the item (q72's cut
# sizes above); J4 brand-like STRING keys against a brand dim, and keys
# over DEVICE_STR_KEY_MAX_LEN (the host_rank route); the star join
# store_sales x item grouped by i_brand_id.  The store_sales side is cut
# to 2^24 rows (a share of 16) to make room for steps 16 and 17 in the
# script's time: the host engines' time follows it
J1_ROWS = 1 << 24
J1_CUSTOMERS = 2_000_000
J1_NULL_SHARE = 0.04
J2_RETURNS = 1 << 22
J2_ITEMS_PER_TICKET = 10
J3_DATA = dict(cs_rows=1 << 22, inv_rows=1 << 21, items=204_000)
J4_DATA = dict(rows=STR_OPS_ROWS, distinct=STR_DISTINCT, lo=8, hi=50)
J4_LONG_DATA = dict(rows=LONG_STR_ROWS, distinct=LONG_STR_DISTINCT, lo=257,
                    hi=400)
STAR_ITEMS = 204_000
STAR_BRANDS = 1_000
JOIN_ENGINES = ("host_rank", "host_hash", "device_sort", "device_hash")
# the host engines probe with the first 2^21 rows of a cell's left side
# (its oracle pairs cut to them): host-bound, they took 2.6-14.5 s a
# cell at 2^22-2^24 rows, and steps 16 and 17 needed the time
JOIN_HOST_ROWS = 1 << 21
# an executor's shuffle write and read: spark.sql.shuffle.partitions'
# default of 200, rows placed as Spark's HashPartitioning places them
# (pmod(murmur3_32(keys, 42), partitions)); the flat batch is the
# operators' store_sales batch, the nested one 2^22 rows of the columns
# a collect_list / named_struct stage shuffles, about 5% null at every
# level (ss_item_sk, a key, never)
SHUFFLE_PARTITIONS = 200
SHUFFLE_SEED = 42
NESTED_ROWS = 1 << 22
NESTED_NULL_SHARE = 0.05
# the memory runtime (step 11): J2 out of core at its build side's bytes
# / 8; step 8's group-by over a 2^25-row batch at a 256 MiB budget; four
# task threads, each with its own 2^23-row store_sales batch (B bytes),
# under a limit of 3 B; q5 over 4 spilled partitions
MEM_JOIN_PARTS = 8
MEM_GROUPBY_BUDGET = 256 << 20
# the out-of-core group-by's batch: half of OPS_ROWS since step 23
# needed the time
MEM_GROUPBY_ROWS = OPS_ROWS // 2
MEM_CORRUPT_ROWS = 1 << 22
MEM_TASKS = 4
MEM_TASK_ROWS = 1 << 23
MEM_TASK_PARTS = 4
MEM_TASK_LIMIT_BATCHES = 3
MEM_Q5_PARTS = 4
MEM_THREAD_TIMEOUT_S = 300
MEM_TASK_POLICY = RT.RetryPolicy(max_attempts=32)
# the string casts and parse_url (step 12), drawn on the card: the casts
# over 2^22 rows of the operators' store_sales values (2^24, one
# executor batch of about 300 MB of rendered chars, until step 20 needed
# the time; 2^23 until step 21, 2^22 until step 23), a seeded 1/16 of
# the rows replaced by an edge vocabulary; parse_url over 2^20 URLs of
# at most 199 bytes (about 98 MB; 2^22 before step 19 needed the time,
# 2^21 before step 23), and QUERY with a key over BASELINE.json's
# 1e6-row column (2^20 rows), since the key is matched per row on the
# host; each checked against a CPU run of a slice and against the host
# engine on a sample
STR_CAST_ROWS = 1 << 21
STR_EDGE_EVERY = 16
STR_CPU_ROWS = 1 << 18
STR_HOST_ROWS = 1 << 16
# the strings and json phases' timed calls a cast or extractor: 2 (3
# until the ops phase took the script past 950 s)
STR_ITERS = 2
URL_ROWS = 1 << 20
URL_KEY_ROWS = 1 << 20
URL_CPU_ROWS = 1 << 17      # one device chunk
URL_HOST_ROWS = 1 << 14
URL_NULL_SHARE = 0.04
FLOAT_EDGES = [" 12.5 ", "\t-0.25\n", "+7", "-3", "1.", ".5", "-.5",
               "1e400", "-1e-400", "1e308", "-1.5e-300", "1E+22", "5e-1",
               "1234567890123456789", "9999999999999999999e-5",
               "-9223372036854775808e2", "1234567890123456789012345",
               "-1234567890123456789012345e-30", "4.9e-324",
               "2.2250738585072014e-308", "1e-310", "1.17549435e-38",
               "1e-45", "3.4028236e38", "Infinity", "-Infinity", "inf",
               "+INF", "NaN", "-NaN", "nan", "1e", "abc", "", "  ",
               "1.2.3", "0x10", "+", "1_0", "1e+", "  1E+400  ", "--1"]
INT_EDGES = ["9223372036854775807", "9223372036854775808",
             "-9223372036854775808", "-9223372036854775809", "2147483648",
             "-2147483649", "128", "-129", "12.5", "-7.5", "+3.99", ".5",
             " 42 ", "\t-17\n", "1e3", "abc", "", "-", "+", "1-", " ",
             "99.", "0", "+0", "-0"]
# the kernels each main path must launch
PATH_KERNELS = {"flagship_step": ("to_rows",),
                "bench_round_trip": ("to_rows", "from_rows"),
                "jni_door_round_trip": ("to_rows_var",),
                "tpcds_stage_path": (),
                "tpcds_catalog_entry": (),
                "operators_batch": (),
                "joins_batch": (),
                "shuffle_batch": (),
                "memory": (),
                "strings": (),
                "json": (),
                "ingest": (),
                "ops": (),
                "protobuf": (),
                "distributed": (),
                "observability": ("to_rows",),
                "observability_plane": ("to_rows",),
                "server": ("to_rows",),
                "tools": ("to_rows",),
                "jvm_door": ("to_rows", "from_rows", "to_rows_var"),
                "mesh": ()}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def make_table(rows, ncols, device, seed, nullable_every=0, dec128_every=0,
               view_offset=0):
    """Seeded table of the 8-dtype cycle bench_impl.py uses, drawn on the
    device; optional DECIMAL128 columns and nullable columns.  With
    `view_offset`, each column's data and validity are views that many
    elements into a longer buffer."""
    cycle = [dtypes.INT64, dtypes.INT32, dtypes.FLOAT64, dtypes.FLOAT32,
             dtypes.INT16, dtypes.INT8, dtypes.BOOL8,
             dtypes.TIMESTAMP_MICROS]
    g = torch.Generator(device=device).manual_seed(seed)

    def ints(lo, hi, dtype, shape=(rows,)):
        return torch.randint(lo, hi, shape, generator=g, dtype=dtype,
                             device=device)

    def at_offset(t):
        if not view_offset:
            return t
        buf = torch.zeros((t.shape[0] + view_offset,) + tuple(t.shape[1:]),
                          dtype=t.dtype, device=device)
        buf[view_offset:] = t
        return buf[view_offset:]

    cols = []
    for i in range(ncols):
        dt = cycle[i % len(cycle)]
        if dec128_every and i % dec128_every == dec128_every - 1:
            dt = dtypes.decimal128(-2)
            data = ints(-2**31, 2**31, torch.int32, (rows, 4))
        elif dt.kind in ("float32", "float64"):
            data = torch.randn(rows, generator=g, dtype=dt.torch_dtype,
                               device=device)
        elif dt.kind == "bool8":
            data = ints(0, 2, torch.uint8)
        else:
            bits = 8 * dt.size_bytes
            data = ints(-2**(bits - 2), 2**(bits - 2), dt.torch_dtype)
        valid = None
        if nullable_every and i % nullable_every == 0:
            valid = ints(0, 2, torch.uint8)
        cols.append(Column(dt, rows, data=at_offset(data),
                           validity=None if valid is None
                           else at_offset(valid)))
    return Table(cols)


def string_host_specs(rows, ncols, seed, first=0, nullable_every=3,
                      dec128_every=0, skew=0, max_len=STRING_MAX_LEN):
    """Seeded host columns of STRING_CYCLE (from entry `first` on), drawn
    with numpy: integers over their whole range, strings of 0 to max_len
    random bytes whose offsets start at `skew`, and about 10% nulls in
    every n-th column.  A null string keeps its bytes and length."""
    rng = np.random.default_rng(seed)
    specs = []
    for i in range(ncols):
        kind = STRING_CYCLE[(first + i) % len(STRING_CYCLE)]
        if dec128_every and i % dec128_every == dec128_every - 1:
            kind = "decimal128"
        valid = None
        if nullable_every and i % nullable_every == 0:
            valid = (rng.random(rows) >= 0.1).astype(np.uint8)
        if kind == "string":
            offs = np.zeros(rows + 1, np.int64)
            np.cumsum(rng.integers(0, max_len + 1, rows),
                      out=offs[1:])
            offs += skew
            chars = rng.integers(0, 256, int(offs[-1]), dtype=np.uint8)
            specs.append((kind, chars, valid, offs.astype(np.int32)))
            continue
        if kind == "decimal128":
            data = rng.integers(-2**31, 2**31, (rows, 4)).astype(np.int32)
        elif kind == "bool8":
            data = rng.integers(0, 2, rows, dtype=np.uint8)
        else:
            dt = dtypes.DType(kind).np_dtype
            info = np.iinfo(dt)
            data = rng.integers(info.min, info.max, rows, dtype=dt,
                                endpoint=True)
        specs.append((kind, data, valid))
    return specs


def layout_of(table):
    """(field starts, validity offset, row size) of the table's rows."""
    schema = [c.dtype for c in table.columns]
    starts, voff, _fixed = RC.compute_layout(schema)
    return starts, voff, RC.row_size_of(schema)


def raw_bytes(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bytes in row-major order, as int16.  Copied into fresh
    storage first: torch counts a tensor whose only element has any
    stride as contiguous, and such a tensor cannot be viewed as bytes."""
    dense = torch.empty(t.shape, dtype=t.dtype, device=t.device).copy_(t)
    return dense.view(torch.uint8).reshape(-1).to(torch.int16)


def byte_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest absolute difference between two buffers' bytes."""
    a8 = raw_bytes(a)
    b8 = raw_bytes(b)
    check(a8.shape == b8.shape, f"byte lengths {a8.shape} vs {b8.shape}")
    return int((a8 - b8).abs().max()) if a8.numel() else 0


def compare_kernels(table):
    """Kernel vs plain version on the card for both directions; returns
    the largest byte error of each."""
    cols = table.columns
    starts, voff, row_size = layout_of(table)
    kern = RA.assemble_rows(cols, starts, voff, row_size)
    plain = RA.assemble_rows_plain(cols, starts, voff, row_size)
    err_to = byte_err(kern, plain)
    schema = [c.dtype for c in cols]
    kd, kv = RA.disassemble_rows(kern, schema, starts, voff, row_size)
    pd, pv = RA.disassemble_rows_plain(kern, schema, starts, voff, row_size)
    err_from = max([byte_err(a, b) for a, b in zip(kd, pd)]
                   + [byte_err(kv, pv)])
    torch.cuda.synchronize()
    for ci, c in enumerate(cols):   # and the round trip gives the input
        check(byte_err(kd[ci], c.data) == 0, f"round trip column {ci}")
        want = (torch.ones_like(kv[ci]) if c.validity is None
                else (c.validity != 0).to(torch.uint8))
        check(torch.equal(kv[ci], want), f"round trip validity {ci}")
    return err_to, err_from


def var_case_table(case, device):
    """The table of one VAR_KERNEL_CASES entry."""
    rows, ncols, first, nullable, dec, skew, max_len = case
    return interop.table_from_host(string_host_specs(
        rows, ncols, seed=rows + ncols, first=first,
        nullable_every=nullable, dec128_every=dec, skew=skew,
        max_len=max_len), device)


def compare_var_kernel(table):
    """Variable-width to-rows kernel vs its plain version on the card;
    returns the largest byte error."""
    cols = table.columns
    starts, voff, fixed = RC.compute_layout([c.dtype for c in cols])
    offsets, total = RC.var_row_offsets(cols, fixed)
    kern = RA.assemble_var_rows(cols, starts, voff, fixed, offsets, total)
    plain = RA.assemble_var_rows_plain(cols, starts, voff, fixed, offsets)
    torch.cuda.synchronize()
    return byte_err(kern, plain)


def var_tiles(table):
    """(tiles, tiles the variable-width kernel writes by its direct path,
    rows per tile) for the table at the wrapper's tile."""
    cols = table.columns
    _starts, _voff, fixed = RC.compute_layout([c.dtype for c in cols])
    offsets, total = RC.var_row_offsets(cols, fixed)
    nstr = sum(c.dtype.is_string for c in cols)
    log2_tile, buf = RA.var_tile(fixed, table.num_rows, total, len(cols),
                                 nstr)
    tiles = -(-table.num_rows >> log2_tile)
    return tiles, RA.var_direct_tiles(offsets, log2_tile, buf), 1 << log2_tile


def read_launches(path, elsewhere=()):
    """The launch counts since the last reset: this path's own call,
    plus the counts of the processes it ran in (`elsewhere`: the mesh
    ranks' own, each zeroed at the rank's start)."""
    launches = dict(RA.LAUNCHES)
    for counts in elsewhere:
        for name, n in counts.items():
            launches[name] += n
    print(f"main path {path}: launches {launches}", flush=True)
    for name in PATH_KERNELS[path]:
        check(launches[name] > 0, f"{path} launched the {name} kernel")
    return launches


def run_flagship():
    inputs = F.example_inputs(FLAGSHIP_ROWS, device="cuda")
    RA.reset_launches()
    t0 = time.perf_counter()
    out = F.flagship_step(*inputs)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = read_launches("flagship_step")
    ref = F.flagship_step(*F.example_inputs(FLAGSHIP_ROWS, device="cpu"))
    names = ("murmur3_32", "xxhash64", "rows", "bucket sums")
    for name, got, want in zip(names, out, ref):
        check(got.shape == want.shape and torch.equal(got.cpu(), want),
              f"flagship {name} on the card == on the CPU")
    check(int(out[3].sum()) == int(inputs[1].to(torch.int64).sum()),
          "bucket sums add up to the column sum")
    steady_ms = host_ms(lambda: F.flagship_step(*inputs), STEP_ITERS)
    return launches, ms, steady_ms


def run_bench_round_trip(table):
    schema = [c.dtype for c in table.columns]
    RA.reset_launches()
    t0 = time.perf_counter()
    rows_col = RC.convert_to_rows(table)
    back = RC.convert_from_rows(rows_col, schema)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = read_launches("bench_round_trip")
    for ci, (a, b) in enumerate(zip(table.columns, back.columns)):
        check(byte_err(a.data, b.data) == 0, f"bench round trip column {ci}")
        check(bool((b.validity == 1).all()), f"bench validity column {ci}")
    starts, voff, row_size = layout_of(table)
    plain = RA.assemble_rows_plain(table.columns, starts, voff, row_size)
    check(torch.equal(rows_col.children[0].data, plain),
          "bench to-rows bytes == plain version")
    steady_ms = host_ms(lambda: RC.convert_from_rows(
        RC.convert_to_rows(table), schema), STEP_ITERS)
    return launches, ms, steady_ms, rows_col


def jni_door_step(handles, type_ids, scales):
    """The JNI-door calls a Spark executor makes on a batch: hash-partition
    keys, then columnar -> rows -> columnar.  Returns the new handles."""
    keys = [handles[k] for k in HASH_KEYS]
    mm = jni_api.murmur_hash3_32(42, keys)
    xx = jni_api.xx_hash_64(42, keys)
    rows = jni_api.convert_to_rows(handles)
    back = jni_api.convert_from_rows(rows, type_ids, scales)
    return mm, xx, rows, back


def release_all(*handles):
    for h in handles:
        for one in (h if isinstance(h, list) else [h]):
            jni_api.release_column(one)


def run_jni_door(table, cpu_keys):
    """The JNI-door main path on `table` (on the card); `cpu_keys` are the
    hash key columns on the CPU.  Returns (launches, first-call ms,
    steady ms, max byte error of the rows against the plain version)."""
    start = REGISTRY.live_count()
    handles = [REGISTRY.register(c) for c in table.columns]
    type_ids = [c.dtype.kind for c in table.columns]
    scales = [c.dtype.scale for c in table.columns]
    RA.reset_launches()
    t0 = time.perf_counter()
    mm, xx, rows, back = jni_door_step(handles, type_ids, scales)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = read_launches("jni_door_round_trip")

    cpu = [REGISTRY.register(c) for c in cpu_keys]
    cmm = jni_api.murmur_hash3_32(42, cpu)
    cxx = jni_api.xx_hash_64(42, cpu)
    for name, got, want in (("murmur_hash3_32", mm, cmm),
                            ("xx_hash_64", xx, cxx)):
        g, w = REGISTRY.get(got).data, REGISTRY.get(want).data
        check(g.shape == w.shape and torch.equal(g.cpu(), w),
              f"JNI door {name} on the card == on the CPU")

    cols = table.columns
    starts, voff, fixed = RC.compute_layout([c.dtype for c in cols])
    rows_col = REGISTRY.get(rows)
    plain = RA.assemble_var_rows_plain(cols, starts, voff, fixed,
                                       rows_col.offsets)
    err = byte_err(rows_col.children[0].data, plain)
    check(err == 0, "JNI door rows == plain version")
    del plain
    for ci, (a, h) in enumerate(zip(cols, back)):
        b = REGISTRY.get(h)
        want = (torch.ones_like(b.validity) if a.validity is None
                else (a.validity != 0).to(torch.uint8))
        check(torch.equal(b.validity, want), f"JNI door validity {ci}")
        check(byte_err(a.data, b.data) == 0, f"JNI door column {ci} data")
        if a.dtype.is_string:
            check(torch.equal(a.offsets, b.offsets),
                  f"JNI door column {ci} offsets")
    release_all(mm, xx, rows, back, cpu, cmm, cxx)
    steady_ms = host_ms(lambda: release_all(*jni_door_step(
        handles, type_ids, scales)), STEP_ITERS)
    release_all(handles)
    check(REGISTRY.live_count() == start, "every JNI door handle released")
    return launches, ms, steady_ms, err


def event_ms(fn, iters):
    """Mean milliseconds per call on the card, after two warm-up calls."""
    fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters):
    """Median wall milliseconds of `fn` followed by a synchronize: a step
    time as its caller sees it, host work included."""
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def nbytes(t):
    return t.numel() * t.element_size()


def to_rows_bytes(table):
    """Bytes the to-rows function must move: each column and validity
    read once, the rows written once."""
    cols = table.columns
    return (sum(nbytes(c.data) for c in cols)
            + sum(nbytes(c.validity) for c in cols if c.validity is not None)
            + table.num_rows * layout_of(table)[2])


def time_to_rows(table, variants=()):
    """The to-rows kernel on `table` at the wrapper's tile, and at each
    (log2 rows per tile, ring buffers) of `variants`, each checked
    byte-equal to the plain version first; beside them the wrapper, the
    plain version, and a device-to-device copy of as many bytes as the
    function must move (half read, half written)."""
    cols = table.columns
    starts, voff, row_size = layout_of(table)
    rows = table.num_rows
    desc, _ = RA.to_rows_descriptors(cols, starts)
    key = RA.schema_key(cols, starts, voff)
    out = torch.empty((rows * row_size,), dtype=torch.uint8, device="cuda")
    plain = RA.assemble_rows_plain(cols, starts, voff, row_size)
    variant_ms = {}
    for lg, stages in variants:
        out.zero_()
        RA.launch_to_rows(desc, key, rows, row_size, out, lg, stages)
        torch.cuda.synchronize()
        check(torch.equal(out, plain),
              f"to-rows at {1 << lg} rows x {stages} buffers == plain")
        variant_ms[f"{1 << lg}x{stages}"] = event_ms(
            lambda: RA.launch_to_rows(desc, key, rows, row_size, out, lg,
                                      stages), TIMED_ITERS)
    del plain
    plan, stages, flags = RA.to_rows_tile(key, row_size)
    ms = event_ms(lambda: RA.launch_to_rows(desc, key, rows, row_size, out),
                  TIMED_ITERS)
    call = event_ms(lambda: RA.assemble_rows(cols, starts, voff, row_size),
                    TIMED_ITERS)
    plain_ms = event_ms(
        lambda: RA.assemble_rows_plain(cols, starts, voff, row_size),
        PLAIN_ITERS)
    moved = to_rows_bytes(table)
    src = torch.empty((moved // 2,), dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    copy_ms = event_ms(lambda: dst.copy_(src), TIMED_ITERS)
    return dict(ms=ms, call_ms=call, plain_ms=plain_ms, bytes=moved,
                bound_ms=moved / HBM_BYTES_PER_S * 1e3, copy_ms=copy_ms,
                tile_rows=1 << plan.log2_tile, stages=stages,
                smem_bytes=RA.to_rows_smem_bytes(plan, row_size, stages,
                                                 flags),
                variant_ms=variant_ms)


def time_from_rows(table, rows_col):
    cols = table.columns
    schema = [c.dtype for c in cols]
    starts, voff, row_size = layout_of(table)
    rows = table.num_rows
    row_bytes = rows_col.children[0].data
    datas, valid, desc_from = RA.from_rows_outputs(schema, starts, rows,
                                                   row_bytes.device)
    from_ms = event_ms(lambda: RA.launch_from_rows(
        row_bytes, rows, row_size, voff, desc_from, valid), TIMED_ITERS)
    from_call = event_ms(lambda: RA.disassemble_rows(
        row_bytes, schema, starts, voff, row_size), TIMED_ITERS)
    from_plain = event_ms(lambda: RA.disassemble_rows_plain(
        row_bytes, schema, starts, voff, row_size), PLAIN_ITERS)
    from_bytes = (nbytes(row_bytes) + sum(nbytes(d) for d in datas)
                  + nbytes(valid))
    return dict(ms=from_ms, call_ms=from_call, plain_ms=from_plain,
                bytes=from_bytes)


def time_var_kernel(table, log2_tiles=()):
    """The variable-width to-rows kernel on `table`, at the wrapper's tile
    and at each of `log2_tiles`.  Its bytes are what this table's rows
    need: the fixed-width columns, validity, string offsets and the chars
    they span read once, the row offsets read once, the rows written
    once."""
    cols = table.columns
    rows = table.num_rows
    starts, voff, fixed = RC.compute_layout([c.dtype for c in cols])
    offsets, total = RC.var_row_offsets(cols, fixed)
    desc, str_idx = RA.to_rows_descriptors(cols, starts)
    out = torch.empty((total,), dtype=torch.uint8, device=offsets.device)

    def launch(log2_tile=None):
        RA.launch_to_rows_var(desc, str_idx, rows, fixed, voff, offsets,
                              out, log2_tile)

    ms = event_ms(launch, TIMED_ITERS)
    tile_ms = {str(1 << lg): event_ms(lambda: launch(lg), TIMED_ITERS)
               for lg in log2_tiles}
    call = event_ms(lambda: RA.assemble_var_rows(
        cols, starts, voff, fixed, offsets, total), TIMED_ITERS)
    plain = event_ms(lambda: RA.assemble_var_rows_plain(
        cols, starts, voff, fixed, offsets), PLAIN_ITERS)
    read = nbytes(offsets)
    for c in cols:
        if c.validity is not None:
            read += nbytes(c.validity)
        if c.dtype.is_string:
            read += nbytes(c.offsets) + int(c.offsets[-1] - c.offsets[0])
        else:
            read += nbytes(c.data)
    return dict(ms=ms, call_ms=call, plain_ms=plain, bytes=read + total,
                tile_ms=tile_ms)


@contextlib.contextmanager
def fusion(mode):
    """Run the stage path's engine `mode` ("1" fused, "0" op by op)."""
    old = os.environ.get("SPARK_RAPIDS_TPU_STAGE_FUSION")
    os.environ["SPARK_RAPIDS_TPU_STAGE_FUSION"] = mode
    try:
        yield
    finally:
        if old is None:
            del os.environ["SPARK_RAPIDS_TPU_STAGE_FUSION"]
        else:
            os.environ["SPARK_RAPIDS_TPU_STAGE_FUSION"] = old


def same_bytes(got, want, what):
    """Every output equal to `want` in dtype, shape and bytes."""
    check(len(got) == len(want), f"{what}: output count")
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.cpu().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = w.cpu().numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        check(g.dtype == w.dtype and g.shape == w.shape
              and g.tobytes() == w.tobytes(), f"{what}: output {i}")


def q5_oracle(h, stores):
    """q5 in vectorised numpy over host copies of the same arrays (int64
    adds, so the sums are exact).  Returns (outputs, pair totals)."""
    sales, rets, profit, seen = (np.zeros(stores, np.int64)
                                 for _ in range(4))
    ms = np.isin(h.s_date, h.d_date)
    st = h.s_store[ms]
    np.add.at(sales, st, h.s_price[ms])
    np.add.at(profit, st, h.s_profit[ms])
    np.add.at(seen, st, 1)
    mr = np.isin(h.r_date, h.d_date)
    rt = h.r_store[mr]
    np.add.at(rets, rt, h.r_amt[mr])
    np.add.at(profit, rt, -h.r_loss[mr])
    np.add.at(seen, rt, 1)
    key = np.where(seen > 0, h.st_id, 2**31 - 1).astype(np.int32)
    order = np.argsort(key, kind="stable")
    return ((key[order], sales[order], rets[order], profit[order],
             np.bool_(False)), [int(ms.sum()), int(mr.sum())])


def q72_oracle(h, items, max_week, week0, limit):
    """q72 in vectorised numpy: every (catalog_sales, inventory) pair on
    item, expanded from searchsorted runs, filtered, counted per (item,
    week) in int64, then ORDER BY count DESC, group ASC LIMIT.  Returns
    (outputs, [pair total])."""
    order = np.argsort(h.inv_item, kind="stable")
    lo = np.searchsorted(h.inv_item[order], h.cs_item, "left")
    cnt = np.searchsorted(h.inv_item[order], h.cs_item, "right") - lo
    total = int(cnt.sum())
    li = np.repeat(np.arange(len(h.cs_item)), cnt)
    ri = order[np.repeat(lo - (np.cumsum(cnt) - cnt), cnt)
               + np.arange(total)]
    ow = h.cs_date[li] // 7
    wk = ow - week0
    keep = ((h.inv_date[ri] // 7 == ow + 1)
            & (h.inv_qty[ri] < h.cs_qty[li]) & (wk >= 0) & (wk < max_week))
    gid = (h.item_id[h.cs_item[li[keep]]].astype(np.int64) * max_week
           + wk[keep])
    n_groups = items * max_week
    counts = np.bincount(gid, minlength=n_groups).astype(np.int64)
    skey = np.where(counts > 0, -counts, 2**62)
    top = np.lexsort((np.arange(n_groups), skey))[:limit]
    return ((top // max_week, top % max_week + week0, counts[top],
             np.bool_(False)), [total])


def capacity_used(initial, totals):
    """The capacity the retry settles on: doubled until no join's true
    pair total exceeds it."""
    cap = initial
    while max(totals) > cap:
        cap *= 2
    return cap


def drive_query(name, run, want, plans):
    """One stage-path query in both engines; checks them against each
    other and against the oracle's outputs `want`, and that each stage of
    `plans` compiled once.  Returns its measurements."""
    res = {}
    outs = {}
    for engine, mode in (("fused", "1"), ("op_by_op", "0")):
        with fusion(mode):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            outs[engine] = run()
            torch.cuda.synchronize()
            res[f"{engine}_first_call_s"] = time.perf_counter() - t0
            # the first call's peak against the card, before the timed
            # calls (q89 sorts 82.0M groups)
            total = torch.cuda.get_device_properties(0).total_memory
            check(torch.cuda.max_memory_allocated() < 0.9 * total,
                  f"{name} {engine}: first call's peak under 90% of the "
                  f"card's memory")
            res[f"{engine}_ms"] = host_ms(run, STEP_ITERS)
            res[f"{engine}_peak_mb"] = torch.cuda.max_memory_allocated() / 2**20
        print(f"stage path {name} {engine}: first call "
              f"{res[engine + '_first_call_s']:.2f} s, "
              f"{res[engine + '_ms']:.3f} ms, peak "
              f"{res[engine + '_peak_mb']:.0f} MiB", flush=True)
    same_bytes(outs["fused"], outs["op_by_op"],
               f"{name}: fused == op by op on the card")
    same_bytes(outs["fused"], want, f"{name}: == numpy oracle")
    res["compile_s"] = {}
    for plan in plans:
        st = compile_stage(plan)
        check(st.compiles == 1 and len(st.compile_seconds) == 1,
              f"{name}: stage {plan.name} compiled once "
              f"({st.compiles} compiles)")
        res["compile_s"][plan.name] = next(iter(st.compile_seconds.values()))
    return res


def run_stage_path():
    """The TPC-DS stage path at full size (see the module docstring)."""
    RA.reset_launches()
    stores = Q5_DATA["stores"]
    d5 = TT.gen_q5(device="cuda", **Q5_DATA)
    want5, totals5 = q5_oracle(TT.Q5Data(*(x.cpu().numpy() for x in d5)),
                               stores)
    cap5 = capacity_used(Q5_CAPACITY, totals5)
    q5 = drive_query("q5", lambda: TC.run_q5(d5, stores, Q5_CAPACITY),
                     want5, [TC.q5_partials_plan(stores, cap5),
                             TC.q5_finish_plan(stores)])
    q5.update(pair_totals=totals5, capacity=cap5,
              rows=[Q5_DATA["rows"], Q5_DATA["rows"] // 8])
    del d5, want5
    torch.cuda.empty_cache()

    items = Q72_DATA["items"]
    d72 = TT.gen_q72(device="cuda", **Q72_DATA)
    want72, totals72 = q72_oracle(
        TT.Q72Data(*(x.cpu().numpy() for x in d72)), items, Q72_MAX_WEEK,
        Q72_WEEK0, Q72_LIMIT)
    cap72 = capacity_used(Q72_CAPACITY, totals72)
    q72 = drive_query(
        "q72", lambda: TC.run_q72(d72, items, Q72_MAX_WEEK, Q72_CAPACITY,
                                  Q72_LIMIT, Q72_WEEK0),
        want72, [TC.q72_partials_plan(items, Q72_MAX_WEEK, cap72,
                                      Q72_WEEK0),
                 TC.q72_finish_plan(items, Q72_MAX_WEEK, Q72_LIMIT,
                                    Q72_WEEK0)])
    q72.update(pair_totals=totals72, capacity=cap72,
               rows=[Q72_DATA["cs_rows"], Q72_DATA["inv_rows"]],
               groups=items * Q72_MAX_WEEK)
    del d72, want72
    torch.cuda.empty_cache()

    # the capacity retry on the card: op by op, so the doublings compile
    # nothing
    small = TT.gen_q72(device="cuda", **Q72_SMALL_DATA)
    with fusion("0"):
        (_counts, of), cap = TC.run_q72_partials(
            small, 4, Q72_MAX_WEEK, Q72_SMALL_CAPACITY, Q72_WEEK0)
        outs = TC.run_q72(small, 4, Q72_MAX_WEEK, Q72_SMALL_CAPACITY,
                          week0=Q72_WEEK0)
    check(cap > Q72_SMALL_CAPACITY and not bool(of) and not bool(outs[-1]),
          f"small q72 doubled its join capacity ({cap})")
    rows = [(int(i), int(w), int(c))
            for i, w, c in zip(*(o.cpu().tolist() for o in outs[:3]))
            if c > 0]
    check(rows == TT.oracle_q72(small, 4, Q72_MAX_WEEK, week0=Q72_WEEK0),
          "small q72 after the retry == oracle")
    others = run_catalog_stages()
    launches = read_launches("tpcds_stage_path")
    from torch._inductor.async_compile import shutdown_compile_workers
    shutdown_compile_workers()
    return launches, {"q5": q5, "q72": q72,
                      "retry": {"initial_capacity": Q72_SMALL_CAPACITY,
                                "capacity": cap}, **others}


def q3_want(d):
    """q3's stage outputs from the oracle: the first LIMIT groups (all
    live at this size) and the kept-row count."""
    years, brands, sums, kept = TT.q3_arrays(
        d, Q3_BASE, Q3_PARAMS["manufact"], Q3_PARAMS["month"])
    limit = Q3_PARAMS["limit"]
    check(len(years) >= limit, f"q3 has {limit} live groups")
    return years[:limit], brands[:limit], sums[:limit], np.int64(kept)


def q9_want(data):
    rows = TT.oracle_q9(*data)
    return (np.array([r[0] for r in rows], np.int64),
            np.array([r[1] for r in rows], np.float64),
            np.array([r[2] for r in rows], np.float64))


def q67_want(d, ncat, ncls):
    """q67's stage outputs from the oracle (every group live here)."""
    cat, cls, s, rank, cnt, sum1, total = TT.q67_arrays(d, ncat, ncls)
    check(len(cat) == ncat * ncls, "every q67 group is live")
    return cat, cls, s, rank, cnt, sum1, np.int64(total)


def q89_want(d, stores, items):
    """q89's stage outputs from the oracle: live groups by (store,
    item), then the empty ones in group order."""
    sales, cnt, tot = TT.q89_arrays(d, stores, items)
    g = np.concatenate([np.nonzero(cnt)[0], np.nonzero(cnt == 0)[0]])
    return g // items, g % items, sales[g], tot[g // items], cnt[g]


def run_catalog_stages():
    """q3, q9, q67, CUBE and q89 through the stage path at full size,
    each in both engines against its oracle."""
    out = {}
    d = TT.gen_q3(device="cuda", **Q3_DATA)
    want = q3_want(d)
    out["q3"] = drive_query(
        "q3", lambda: TC.run_q3(d, Q3_BASE, brands=Q3_DATA["brands"],
                                **Q3_PARAMS), want,
        [TC.q3_plan(Q3_BASE, Q3_PARAMS["years"], Q3_DATA["brands"],
                    Q3_PARAMS["manufact"], Q3_PARAMS["month"],
                    Q3_PARAMS["limit"])])
    out["q3"].update(rows=Q3_DATA["rows"], kept_rows=int(want[3]))
    del d, want
    data = TT.gen_q9(device="cuda", **Q9_DATA)
    out["q9"] = drive_query("q9", lambda: TC.run_q9(*data), q9_want(data),
                            [TC.q9_plan()])
    out["q9"].update(rows=Q9_DATA["rows"])
    del data
    ncat, ncls = Q67_DATA["ncat"], Q67_DATA["ncls"]
    d = TT.gen_q67(device="cuda", **Q67_DATA)
    out["q67"] = drive_query("q67", lambda: TC.run_q67(d, ncat, ncls),
                             q67_want(d, ncat, ncls),
                             [TC.q67_plan(ncat, ncls)])
    out["cube"] = drive_query("cube", lambda: TC.run_cube(d, ncat, ncls),
                              TT.oracle_cube(d, ncat, ncls),
                              [TC.cube_plan(ncat, ncls)])
    for q in ("q67", "cube"):
        out[q].update(rows=Q67_DATA["rows"], groups=ncat * ncls)
    del d
    stores, items = Q89_DATA["stores"], Q89_DATA["items"]
    d = TT.gen_q89(device="cuda", **Q89_DATA)
    want = q89_want(d, stores, items)
    out["q89"] = drive_query("q89", lambda: TC.run_q89(d, stores, items),
                             want, [TC.q89_plan(stores, items)])
    out["q89"].update(rows=Q89_DATA["rows"], groups=stores * items,
                      live_groups=int((want[4] > 0).sum()))
    del d, want
    torch.cuda.empty_cache()
    return out


def run_catalog_entry():
    """The eight named queries through run_catalog_query at their
    default parameters, on the card and on the CPU, op by op; then
    each with a cancelled context, which must raise before any work
    (no device memory allocated)."""
    RA.reset_launches()
    res = {}
    with fusion("0"):
        for name in CATALOG_NAMES:
            got = TM.run_catalog_query(name, {"device": "cuda"})
            want = TM.run_catalog_query(name, {"device": "cpu"})
            check(got == want, f"catalog {name} on the card == on the CPU")
            res[name] = {"rows": len(got)}
        cancelled = threading.Event()
        cancelled.set()
        for name in CATALOG_NAMES:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            try:
                TM.run_catalog_query(name, {"device": "cuda"},
                                     TM.QueryContext(cancel_event=cancelled))
                check(False, f"catalog {name} ran after a cancel")
            except TM.QueryCancelled:
                pass
            check(torch.cuda.max_memory_allocated() == base,
                  f"catalog {name} did no work after a cancel")
    print(f"catalog entry: {json.dumps(res)}", flush=True)
    return read_launches("tpcds_catalog_entry"), res


def store_sales_batch(rows, seed, device="cuda"):
    """A store_sales batch on the card (or `device`): ss_store_sk INT32
    (402 stores), ss_item_sk INT32 (204,000 items), ss_quantity INT32
    (1-100), ss_sales_price INT64 cents (100-19,999) and ss_net_paid
    FLOAT64 (quantity x price, less up to 20%, in dollars; never
    negative), the last three about 4% null."""
    g = torch.Generator(device=device).manual_seed(seed)

    def ints(lo, hi, dtype):
        return torch.randint(lo, hi, (rows,), generator=g, dtype=dtype,
                             device=device)

    def valid():
        return (torch.rand(rows, generator=g, device=device)
                >= OPS_NULL_SHARE).to(torch.uint8)

    qty = ints(1, 101, torch.int32)
    price = ints(100, 20_000, torch.int64)
    net = ((qty * price).to(torch.float64) / 100 * (
        1 - 0.2 * torch.rand(rows, generator=g, dtype=torch.float64,
                             device=device)))
    return Table([Column(dtypes.INT32, rows, data=ints(0, 402, torch.int32)),
                  Column(dtypes.INT32, rows,
                         data=ints(0, 204_000, torch.int32)),
                  Column(dtypes.INT32, rows, data=qty, validity=valid()),
                  Column(dtypes.INT64, rows, data=price, validity=valid()),
                  Column(dtypes.FLOAT64, rows, data=net, validity=valid())],
                 ["ss_store_sk", "ss_item_sk", "ss_quantity",
                  "ss_sales_price", "ss_net_paid"])


def string_keys(rows, distinct, lo, hi, seed, device="cuda"):
    """(pool, idx): `distinct` brand-like STRING values (lowercase
    letters, digits, spaces and '#') of lo to hi bytes on the card (or
    `device`), and `rows` int64 indices into the pool there."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz0123456789 #",
                             np.uint8)
    pool = [bytes(alphabet[rng.integers(0, len(alphabet), n)])
            for n in rng.integers(lo, hi + 1, distinct)]
    idx = torch.from_numpy(rng.integers(0, distinct, rows)).to(device)
    return Column.from_strings(pool, device), idx


def string_key_column(rows, distinct, lo, hi, seed, device="cuda"):
    """A STRING column of `rows` drawn from string_keys' pool, gathered
    on the card (or `device`)."""
    pool, idx = string_keys(rows, distinct, lo, hi, seed, device)
    return CP.gather(pool, idx)


def on_cpu(col):
    return Column(col.dtype, col.length,
                  data=None if col.data is None else col.data.cpu(),
                  validity=None if col.validity is None
                  else col.validity.cpu(),
                  offsets=None if col.offsets is None else col.offsets.cpu(),
                  children=tuple(on_cpu(c) for c in col.children))


def same_column(a, b, what):
    """Card column == CPU column: data bytes, validity, offsets."""
    check(a.dtype == b.dtype and a.length == b.length, f"{what}: type")
    check(byte_err(a.data, b.data.to(a.data.device)) == 0,
          f"{what}: data")
    for x, y, part in ((a.validity, b.validity, "validity"),
                       (a.offsets, b.offsets, "offsets")):
        check((x is None) == (y is None)
              and (x is None or torch.equal(x.cpu(), y)), f"{what}: {part}")


def close_float_sums(a, b, counts, mean, what):
    """A float SUM (or MEAN) on the card against the CPU's: the card adds
    with atomics, whose order varies, so each group is held to
    |card - cpu| <= 4 * count * 2^-53 * sum|x| (twice the worst error
    of two summation orders; sum|x| = the CPU's sum, as x >= 0), and a
    mean to that over count plus 2 ulps of the mean.  `counts` are the
    groups' non-null counts.  Returns the largest difference in units
    of the bound."""
    check(torch.equal(a.validity.cpu(), b.validity), f"{what}: validity")
    ga, gb = a.data.cpu(), b.data
    tol = 4 * U53 * counts.to(torch.float64) * gb.abs()
    if mean:
        tol = tol + 2 * U53 * gb.abs()
    diff = (ga - gb).abs()
    check(bool((diff <= tol).all()), f"{what}: within the stated bound")
    return float((diff / tol.clamp(min=1e-300)).max())


@contextlib.contextmanager
def branch_log():
    """Record which group-id branch each groupby_aggregate takes."""
    taken = []
    real = {n: getattr(G, n) for n in ("_group_ids_device",
                                       "_group_ids_host")}
    for n, fn in real.items():
        setattr(G, n, lambda k, n=n, fn=fn: taken.append(n[11:]) or fn(k))
    try:
        yield taken
    finally:
        for n, fn in real.items():
            setattr(G, n, fn)


def timed(fn, iters):
    """(median synchronized ms, peak MiB over the calls)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = host_ms(fn, iters)
    return ms, torch.cuda.max_memory_allocated() / 2**20


def run_operators():
    """GROUP BY and ORDER BY over one store_sales batch on the card, each
    against the same call on a CPU copy (see the module docstring)."""
    RA.reset_launches()
    res = {}
    batch = store_sales_batch(OPERATORS_ROWS, seed=29)
    cols = batch.columns
    keys = Table(cols[:2])
    # sum(quantity), count(net_paid), min and max(price), sum and
    # mean(net_paid)
    values = [cols[2], cols[4], cols[3], cols[3], cols[4], cols[4]]
    aggs = ["sum", "count", "min", "max", "sum", "mean"]
    with branch_log() as taken:
        out = G.groupby_aggregate(keys, values, aggs)
    torch.cuda.synchronize()
    # the device branch against the host branch on the same card data
    ids_d, first_d, n_d = G._group_ids_device(keys)
    ids_h, first_h, n_h = G._group_ids_host(keys)
    check(n_d == n_h and torch.equal(ids_d, ids_h)
          and torch.equal(first_d, first_h),
          "device group ids == host group ids on the card")
    del ids_d, first_d, ids_h, first_h
    cpu_cols = [on_cpu(c) for c in cols]
    want = G.groupby_aggregate(Table(cpu_cols[:2]),
                               [cpu_cols[i] for i in (2, 4, 3, 3, 4, 4)],
                               aggs)
    for i in (0, 1, 2, 3, 4, 5):
        same_column(out.columns[i], want.columns[i], f"groupby column {i}")
    counts = want.columns[3].data
    bound = max(close_float_sums(out.columns[6], want.columns[6], counts,
                                 False, "groupby sum(net_paid)"),
                close_float_sums(out.columns[7], want.columns[7], counts,
                                 True, "groupby mean(net_paid)"))
    ms, peak = timed(lambda: G.groupby_aggregate(keys, values, aggs),
                     STEP_ITERS)
    res["groupby"] = {"rows": OPERATORS_ROWS, "groups": out.num_rows,
                      "branch": taken, "ms": ms, "peak_mb": peak,
                      "float_diff_of_bound": bound}
    del out, want
    order = S.sort_table(batch, [0, 3], [True, False])
    want = S.sort_table(Table(cpu_cols), [0, 3], [True, False])
    for i in range(len(cols)):
        same_column(order.columns[i], want.columns[i],
                    f"sort_table column {i}")
    del order, want, cpu_cols
    ms, peak = timed(lambda: S.sort_table(batch, [0, 3], [True, False]), 3)
    res["sort_table"] = {"rows": OPERATORS_ROWS, "ms": ms,
                         "peak_mb": peak}
    del batch, cols, keys, values
    torch.cuda.empty_cache()

    for name, rows, distinct, lo, hi in (
            ("string", STR_OPS_ROWS, STR_DISTINCT, 8, 50),
            ("long_string", LONG_STR_ROWS, LONG_STR_DISTINCT, 257, 400)):
        brand = string_key_column(rows, distinct, lo, hi, seed=rows + lo)
        vals = store_sales_batch(rows, seed=lo).columns[2:]
        keys = Table([brand])
        s_aggs = ["sum", "count", "max", "sum", "mean"]
        s_vals = [vals[0], vals[2], vals[1], vals[2], vals[2]]
        with branch_log() as taken:
            out = G.groupby_aggregate(keys, s_vals, s_aggs)
        cpu_vals = [on_cpu(c) for c in s_vals]
        want = G.groupby_aggregate(Table([on_cpu(brand)]), cpu_vals, s_aggs)
        for i in range(4):
            same_column(out.columns[i], want.columns[i],
                        f"{name} groupby column {i}")
        counts = want.columns[2].data
        bound = max(close_float_sums(out.columns[4], want.columns[4],
                                     counts, False, f"{name} sum"),
                    close_float_sums(out.columns[5], want.columns[5],
                                     counts, True, f"{name} mean"))
        # the host rank branch's calls take seconds: 3 of them
        ms, peak = timed(lambda: G.groupby_aggregate(keys, s_vals, s_aggs),
                         3 if name == "long_string" else STEP_ITERS)
        res[f"{name}_groupby"] = {
            "rows": rows, "groups": out.num_rows, "key_bytes": [lo, hi],
            "branch": taken, "ms": ms, "peak_mb": peak,
            "float_diff_of_bound": bound}
        sort_keys = Table([brand, vals[0]])
        got = S.order_by(sort_keys, [True, False])
        check(torch.equal(got.cpu(), S.order_by(
            Table([on_cpu(brand), on_cpu(vals[0])]), [True, False])),
            f"{name} order_by on the card == on the CPU")
        ms, peak = timed(lambda: S.order_by(sort_keys, [True, False]), 3)
        res[f"{name}_order_by"] = {"rows": rows, "ms": ms, "peak_mb": peak}
        del brand, vals, keys, s_vals, out, want, sort_keys, got
    check(res["groupby"]["branch"] == ["device"]
          and res["string_groupby"]["branch"] == ["device"]
          and res["long_string_groupby"]["branch"] == ["host"],
          "each group-by took its branch")
    torch.cuda.empty_cache()
    print(f"operators: {json.dumps(res)}", flush=True)
    return read_launches("operators_batch"), res


def int_key_oracle(lk, rk, lvalid=None, device="cuda"):
    """The inner join in numpy on int64 surrogate keys (equal values <=>
    equal join keys): left rows ascending, each one's right rows
    ascending; the pairs on `device`."""
    order = np.argsort(rk, kind="stable")
    rs = rk[order]
    # each left key's run in the sorted right keys; searched with the
    # left keys in sorted order, which walks `rs` once instead of at
    # random, then put back in row order
    lorder = np.argsort(lk)
    ls = lk[lorder]
    lo = np.empty(len(lk), np.int64)
    counts = np.empty(len(lk), np.int64)
    lo[lorder] = np.searchsorted(rs, ls, "left")
    counts[lorder] = np.searchsorted(rs, ls, "right") - lo[lorder]
    del lorder, ls
    if lvalid is not None:
        counts = np.where(lvalid, counts, 0)
    li = np.repeat(np.arange(len(lk)), counts)
    starts = np.cumsum(counts) - counts
    ri = order[lo[li] + np.arange(len(li)) - starts[li]]
    return (torch.from_numpy(li.astype(np.int32)).to(device),
            torch.from_numpy(ri.astype(np.int32)).to(device))


def host_int64(t):
    return t.cpu().numpy().astype(np.int64)


def join_cells(oracle=True):
    """The join cells, one at a time, drawn on the card from a seed:
    (name, left keys, right keys, null semantics, oracle pairs or None
    without `oracle`)."""
    g = torch.Generator(device="cuda").manual_seed(81)

    def ints(lo, hi, n, dtype=torch.int32):
        return torch.randint(lo, hi, (n,), generator=g, dtype=dtype,
                             device="cuda")

    def int_oracle(*args):
        return int_key_oracle(*args) if oracle else None

    # J1: ss_customer_sk (4% null) x c_customer_sk (unique)
    lk = ints(1, J1_CUSTOMERS + 1, J1_ROWS)
    lv = (torch.rand(J1_ROWS, generator=g, device="cuda")
          >= J1_NULL_SHARE).to(torch.uint8)
    rk = (torch.randperm(J1_CUSTOMERS, generator=g, device="cuda")
          + 1).to(torch.int32)
    want = int_oracle(host_int64(lk), host_int64(rk),
                      lv.cpu().numpy().astype(bool))
    yield ("J1", Table([Column(dtypes.INT32, J1_ROWS, data=lk, validity=lv)]),
           Table([Column(dtypes.INT32, J1_CUSTOMERS, data=rk)]),
           J.NULL_UNEQUAL, want)
    del lk, lv, rk, want
    # J2: (ss_item_sk, ss_ticket_number) x store_returns drawn from sales
    item = ints(1, J3_DATA["items"] + 1, J1_ROWS)
    ticket = (torch.arange(J1_ROWS, dtype=torch.int64, device="cuda")
              // J2_ITEMS_PER_TICKET + 1)
    pick = torch.randperm(J1_ROWS, generator=g, device="cuda")[:J2_RETURNS]
    surrogate = host_int64(item) << 32 | host_int64(ticket)
    want = int_oracle(surrogate, surrogate[pick.cpu().numpy()])
    del surrogate
    yield ("J2", Table([Column(dtypes.INT32, J1_ROWS, data=item),
                        Column(dtypes.INT64, J1_ROWS, data=ticket)]),
           Table([Column(dtypes.INT32, J2_RETURNS, data=item[pick]),
                  Column(dtypes.INT64, J2_RETURNS, data=ticket[pick])]),
           J.NULL_EQUAL, want)
    del item, ticket, pick, want
    # J3: cs_item_sk x inv_item_sk, many to many
    lk = ints(0, J3_DATA["items"], J3_DATA["cs_rows"])
    rk = ints(0, J3_DATA["items"], J3_DATA["inv_rows"])
    want = int_oracle(host_int64(lk), host_int64(rk))
    yield ("J3", Table([Column(dtypes.INT32, lk.shape[0], data=lk)]),
           Table([Column(dtypes.INT32, rk.shape[0], data=rk)]),
           J.NULL_EQUAL, want)
    del lk, rk, want
    # J4: brand-like STRING keys x the brand dim, then keys of 257-400 B
    for name, data in (("J4", J4_DATA), ("J4_long", J4_LONG_DATA)):
        pool, idx = string_keys(seed=data["rows"] + data["lo"], **data)
        check(len(set(pool.to_pylist())) == data["distinct"],
              f"{name}: the dim's keys are distinct")
        want = int_oracle(host_int64(idx),
                          np.arange(data["distinct"], dtype=np.int64))
        yield (name, Table([CP.gather(pool, idx)]), Table([pool]),
               J.NULL_EQUAL, want)
        del pool, idx, want


@contextlib.contextmanager
def join_route_log():
    """Record the engine the router runs, and the verdict and seconds of
    its calibration when it calibrates."""
    log = {"engines": [], "verdict": None, "calibration_s": 0.0}
    real_engines, real_pick = J._join_engines, CAL.pick_path

    def engines():
        return {n: (lambda *a, n=n, f=f: log["engines"].append(n) or f(*a))
                for n, f in real_engines().items()}

    def pick_path(*a, **k):
        t0 = time.perf_counter()
        log["verdict"] = real_pick(*a, **k)
        log["calibration_s"] += time.perf_counter() - t0
        return log["verdict"]

    J._join_engines, CAL.pick_path = engines, pick_path
    try:
        yield log
    finally:
        J._join_engines, CAL.pick_path = real_engines, real_pick


def same_pairs(got, want, what):
    check(all(t.device == want[0].device and t.dtype == torch.int32
              for t in got), f"{what}: int32 pairs on the oracle's device")
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          f"{what}: pairs == the oracle's")


def left_prefix(left, want, rows):
    """The first `rows` rows of a join's left side and the oracle pairs
    they make (the oracle lists left rows ascending)."""
    if left.num_rows <= rows:
        return left, want
    keep = want[0] < rows
    return (Table([CP.slice_column(c, 0, rows) for c in left.columns]),
            (want[0][keep], want[1][keep]))


def run_join_cell(name, left, right, nulls, want,
                  host_rows=JOIN_HOST_ROWS):
    """Every engine by name on one cell, each held to the oracle; the
    device engines timed (median of 5 synchronized calls), the host
    engines once on the first `host_rows` left rows; then the router
    unpinned."""
    res = {"left_rows": left.num_rows, "right_rows": right.num_rows,
           "nulls": nulls, "pairs": int(want[0].shape[0]), "engines": {}}
    engines = J._join_engines()
    full = (left, want)
    for engine in JOIN_ENGINES:
        fn = engines[engine]
        left, want = left_prefix(*full, host_rows) \
            if engine.startswith("host") else full
        if engine == "device_hash":
            HJ._LEARNED_CAPACITY.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        got = fn(left, right, nulls)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        # the engine's own working set: the peak over what the inputs
        # and earlier phases already held
        r = {"first_ms": first_ms, "left_rows": left.num_rows,
             "peak_added_mb":
             (torch.cuda.max_memory_allocated() - before) / 2**20}
        same_pairs(got, want, f"{name} {engine}")
        del got
        if engine == "device_hash":
            r["doublings"] = [HJ.LAST_CAPACITY["doublings"]]
            same_pairs(fn(left, right, nulls), want, f"{name} {engine} again")
            r["doublings"].append(HJ.LAST_CAPACITY["doublings"])
            r["capacity"] = HJ.LAST_CAPACITY["used"]
        if engine.startswith("device"):
            r["ms"] = host_ms(lambda: fn(left, right, nulls), STEP_ITERS)
        res["engines"][engine] = r
    left, want = full
    CAL.forget()
    with join_route_log() as log:
        t0 = time.perf_counter()
        got = J.sort_merge_inner_join(left, right, nulls)
        torch.cuda.synchronize()
        router_ms = (time.perf_counter() - t0) * 1e3
    same_pairs(got, want, f"{name} router")
    # the engines the calibration timed come first in the log; the
    # router's own run is its last entry
    res["router"] = {"engine": log["engines"][-1],
                     "verdict": log["verdict"],
                     "calibration_s": log["calibration_s"],
                     "first_ms": router_ms}
    print(f"join {name}: {json.dumps(res)}", flush=True)
    return res


def run_star_join():
    """simple_star_join_agg: store_sales (ss_item_sk, net paid cents)
    x item (i_item_sk unique, i_brand_id of 1,000), SUM and COUNT by
    brand, exact against numpy."""
    g = torch.Generator(device="cuda").manual_seed(83)
    item_sk = torch.randint(0, STAR_ITEMS, (J1_ROWS,), generator=g,
                            dtype=torch.int32, device="cuda")
    paid = torch.randint(100, 20_000, (J1_ROWS,), generator=g,
                         dtype=torch.int64, device="cuda")
    dim_sk = torch.randperm(STAR_ITEMS, generator=g, device="cuda").to(
        torch.int32)
    brand = torch.randint(1, STAR_BRANDS + 1, (STAR_ITEMS,), generator=g,
                          dtype=torch.int32, device="cuda")
    fact = Table([Column(dtypes.INT32, J1_ROWS, data=item_sk),
                  Column(dtypes.INT64, J1_ROWS, data=paid)])
    dim = Table([Column(dtypes.INT32, STAR_ITEMS, data=dim_sk),
                 Column(dtypes.INT32, STAR_ITEMS, data=brand)])
    with join_route_log() as log:
        t0 = time.perf_counter()
        out = Q.simple_star_join_agg(fact, dim)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
    brand_of = np.empty(STAR_ITEMS, np.int64)
    brand_of[dim_sk.cpu().numpy()] = brand.cpu().numpy()
    b = brand_of[item_sk.cpu().numpy()]
    v = paid.cpu().numpy()
    check(int(v.sum()) < 2**53, "star join sums exact in float64")
    keys = np.unique(b)
    sums = np.bincount(b, weights=v.astype(np.float64)).astype(np.int64)
    counts = np.bincount(b)
    for col, want in zip(out.columns, (keys, sums[keys], counts[keys])):
        check(np.array_equal(col.data.cpu().numpy().astype(np.int64), want),
              "star join == numpy")
    ms, peak = timed(lambda: Q.simple_star_join_agg(fact, dim), STEP_ITERS)
    return {"fact_rows": J1_ROWS, "dim_rows": STAR_ITEMS,
            "groups": out.num_rows, "engine": log["engines"][-1],
            "verdict": log["verdict"], "calibration_s": log["calibration_s"],
            "first_ms": first_ms, "ms": ms, "peak_mb": peak}


def run_joins():
    """The join layer on the card (see the module docstring)."""
    RA.reset_launches()
    calib = os.path.join(_BUILD, "join_calib.json")
    if os.path.exists(calib):
        os.unlink(calib)
    saved = os.environ.get("SPARK_RAPIDS_TPU_CALIB_CACHE")
    os.environ["SPARK_RAPIDS_TPU_CALIB_CACHE"] = calib
    res = {}
    try:
        for name, left, right, nulls, want in join_cells():
            res[name] = run_join_cell(name, left, right, nulls, want)
            if name == "J1":
                start = REGISTRY.live_count()
                lh = REGISTRY.register(left.columns[0])
                rh = REGISTRY.register(right.columns[0])
                t0 = time.perf_counter()
                out = jni_api.sort_merge_inner_join([lh], [rh], False)
                torch.cuda.synchronize()
                res["jni_door_J1_ms"] = (time.perf_counter() - t0) * 1e3
                same_pairs([REGISTRY.get(h).data for h in out], want,
                           "JNI-door sort_merge_inner_join")
                release_all(lh, rh, out)
                check(REGISTRY.live_count() == start,
                      "every join handle released")
            del left, right, want
            torch.cuda.empty_cache()
        j3 = res["J3"]["engines"]["device_hash"]["doublings"]
        check(j3[0] > 0 and j3[1] == 0,
              f"J3 device_hash doubled, then started learned: {j3}")
        check(res["J4_long"]["router"]["engine"] == "host_rank"
              and res["J4_long"]["router"]["verdict"] is None,
              "keys over DEVICE_STR_KEY_MAX_LEN route host_rank")
        res["star_join"] = run_star_join()
        torch.cuda.empty_cache()
    finally:
        if saved is None:
            os.environ.pop("SPARK_RAPIDS_TPU_CALIB_CACHE", None)
        else:
            os.environ["SPARK_RAPIDS_TPU_CALIB_CACHE"] = saved
    print(f"joins: {json.dumps(res)}", flush=True)
    return read_launches("joins_batch"), res


def same_nested(a, b, what):
    """Two columns equal buffer for buffer at every level: kind, rows,
    data bytes, validity and offsets (None on both or equal)."""
    check(a.dtype == b.dtype and a.length == b.length, f"{what}: type")
    for x, y, part in ((a.data, b.data, "data"),
                       (a.validity, b.validity, "validity"),
                       (a.offsets, b.offsets, "offsets")):
        check((x is None) == (y is None), f"{what}: {part} present")
        if x is not None:
            xb = x.contiguous().view(torch.uint8).reshape(-1)
            yb = y.to(x.device).contiguous().view(torch.uint8).reshape(-1)
            check(torch.equal(xb, yb), f"{what}: {part}")
    check(len(a.children) == len(b.children), f"{what}: children")
    for i, (x, y) in enumerate(zip(a.children, b.children)):
        same_nested(x, y, f"{what}.{i}")


def card_strings(g, rows, lo, hi, device="cuda"):
    """A STRING column of random bytes, lo to hi a row, on the card (or
    `device`), about NESTED_NULL_SHARE null (null rows keep their
    bytes)."""
    lens = torch.randint(lo, hi + 1, (rows,), generator=g, device=device)
    offs = torch.zeros(rows + 1, dtype=torch.int64, device=device)
    torch.cumsum(lens, 0, out=offs[1:])
    chars = torch.randint(0, 256, (int(offs[-1]),), generator=g,
                          dtype=torch.uint8, device=device)
    return Column(dtypes.STRING, rows, data=chars,
                  validity=card_valid(g, rows, device),
                  offsets=offs.to(torch.int32))


def card_valid(g, rows, device="cuda"):
    return (torch.rand(rows, generator=g, device=device)
            >= NESTED_NULL_SHARE).to(torch.uint8)


def card_list(g, rows, max_count, child, device="cuda"):
    """A LIST column of 0..max_count elements a row over `child(n)`,
    about NESTED_NULL_SHARE null (null rows keep their elements)."""
    counts = torch.randint(0, max_count + 1, (rows,), generator=g,
                           device=device)
    offs = torch.zeros(rows + 1, dtype=torch.int64, device=device)
    torch.cumsum(counts, 0, out=offs[1:])
    return Column.make_list(offs.to(torch.int32), child(int(offs[-1])),
                            validity=card_valid(g, rows, device))


def nested_batch(rows, seed):
    """ss_item_sk INT32 (204,000 items, never null), a brand-like STRING
    of 8-50 bytes (string_keys' pool), LIST<INT32> of 0-16 elements,
    STRUCT<INT64, STRING of 0-32 bytes, LIST<FLOAT64> of 0-4> and
    LIST<STRING> of 0-4 strings of 0-16 bytes, drawn on the card; about
    NESTED_NULL_SHARE of the values null at every level."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def ints(n, hi, dtype):
        return Column(dtypes.DType({torch.int32: "int32",
                                    torch.int64: "int64"}[dtype]), n,
                      data=torch.randint(-hi, hi, (n,), generator=g,
                                         dtype=dtype, device="cuda"),
                      validity=card_valid(g, n))

    def doubles(n):
        return Column(dtypes.FLOAT64, n, data=torch.randn(
            n, generator=g, dtype=torch.float64, device="cuda"),
            validity=card_valid(g, n))

    item = Column(dtypes.INT32, rows, data=torch.randint(
        0, 204_000, (rows,), generator=g, dtype=torch.int32, device="cuda"))
    brand = string_key_column(rows, STR_DISTINCT, 8, 50, seed)
    brand.validity = card_valid(g, rows)
    struct = Column.make_struct(rows, [
        ints(rows, 2**62, torch.int64), card_strings(g, rows, 0, 32),
        card_list(g, rows, 4, doubles)], validity=card_valid(g, rows))
    return Table([item, brand,
                  card_list(g, rows, 16, lambda n: ints(n, 2**31,
                                                        torch.int32)),
                  struct,
                  card_list(g, rows, 4,
                            lambda n: card_strings(g, n, 0, 16))],
                 ["ss_item_sk", "brand", "items", "sale", "tags"])


def added_peak_mb(fn):
    """(fn's result, the peak device memory its call added, MiB).  Cyclic
    garbage is collected first: collected during the call, it would
    lower the peak below what the call itself allocated."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return out, (torch.cuda.max_memory_allocated() - base) / 2**20


def partition_by_hash(table, keys):
    """Rows ordered by pmod(murmur3_32(keys, 42), 200) with a stable sort
    and a gather of the port's ops; returns (ordered table, splits,
    synchronized ms of the hash, the sort and the gather)."""
    clock = [time.perf_counter()]
    ms = {}

    def lap(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        ms[name] = (now - clock[0]) * 1e3
        clock[0] = now

    torch.cuda.synchronize()
    clock[0] = time.perf_counter()
    h = H.murmur3_32(Table(keys), SHUFFLE_SEED).data
    pid = torch.remainder(h, SHUFFLE_PARTITIONS)         # pmod
    lap("hash")
    order = S.order_by(Table([Column(dtypes.INT32, h.shape[0], data=pid)]))
    lap("sort")
    ordered = CP.gather_table(table, order)
    counts = torch.bincount(pid, minlength=SHUFFLE_PARTITIONS)
    splits = counts.cumsum(0)[:-1].tolist()
    lap("gather")
    check(int(counts.sum()) == table.num_rows
          and counts.shape[0] == SHUFFLE_PARTITIONS, "partition ids in range")
    return ordered, splits, ms


def shuffle_cell(name, table, keys):
    """One batch's shuffle write and read on the card, each against the
    host writer and merger over a CPU copy (see the module docstring)."""
    ordered, splits, part_ms = partition_by_hash(table, keys)
    del table
    fields = schema_of_table(ordered)
    res = {"rows": ordered.num_rows, "partitions": SHUFFLE_PARTITIONS,
           "partition_ms": part_ms}
    (blob, offs), res["split_peak_added_mb"] = added_peak_mb(
        lambda: DS.device_shuffle_split(ordered, splits))
    nbytes_blob = blob.shape[0]
    res["blob_bytes"] = nbytes_blob
    cpu = Table([on_cpu(c) for c in ordered.columns])
    t0 = time.perf_counter()
    host, host_offs = SA.shuffle_split(cpu, splits)
    res["host_writer_s"] = time.perf_counter() - t0
    check(np.array_equal(offs, host_offs), f"{name}: partition offsets")
    check(torch.equal(blob.cpu(), torch.frombuffer(bytearray(host),
                                                   dtype=torch.uint8)),
          f"{name}: device blob == host writer, byte for byte")
    back, res["assemble_peak_added_mb"] = added_peak_mb(
        lambda: DS.device_shuffle_assemble(fields, blob, offs))
    for i, (a, b) in enumerate(zip(back.columns, ordered.columns)):
        same_nested(a, b, f"{name}: assembled column {i}")
    del back
    t0 = time.perf_counter()
    kts = K.read_tables(io.BytesIO(host))
    merged = K.merge_to_table(kts, fields, "cuda")
    torch.cuda.synchronize()
    res["host_merger_s"] = time.perf_counter() - t0
    check(len(kts) == SHUFFLE_PARTITIONS, f"{name}: one table a partition")
    for i, (a, b) in enumerate(zip(merged.columns, ordered.columns)):
        same_nested(a, b, f"{name}: merged column {i}")
    del merged, kts
    for key, fn in (("split", lambda: DS.device_shuffle_split(ordered,
                                                              splits)),
                    ("assemble", lambda: DS.device_shuffle_assemble(
                        fields, blob, offs))):
        ms = host_ms(fn, STEP_ITERS)
        res[f"{key}_ms"] = ms
        res[f"{key}_gb_per_s"] = nbytes_blob / ms / 1e6
    # one partition again with the KCRC trailer, read back, then a
    # flipped body byte must raise
    p = int(np.argmax(np.diff(host_offs)))
    bounds = [0] + splits + [ordered.num_rows]
    out = io.BytesIO()
    K.write_to_stream(K.prepare_host_columns(cpu.columns), out, bounds[p],
                      bounds[p + 1] - bounds[p], crc=True)
    crc = bytearray(out.getvalue())
    kt = K.read_one_table(io.BytesIO(bytes(crc)))
    check(bytes(crc[:-K.CRC_TRAILER_LEN])
          == host[host_offs[p]:host_offs[p + 1]]
          and kt.header.num_rows == bounds[p + 1] - bounds[p],
          f"{name}: CRC partition reads back")
    crc[len(crc) // 2] ^= 0x40
    try:
        K.read_one_table(io.BytesIO(bytes(crc)))
        check(False, f"{name}: a flipped byte raises under CRC")
    except K.KudoCorruptException:
        pass
    res["crc_partition"] = p
    del blob, host, cpu
    return ordered, res


def nested_hashes(table):
    """murmur3_32, xxhash64 and hive_hash over the nested columns on the
    card against the same calls on the CPU, the JNI door's hive_hash
    with its handles released, and LIST of STRUCT refused on both."""
    cols = table.columns[2:]
    cpu = [on_cpu(c) for c in cols]
    res = {}
    for name, fn, args in (("murmur3_32", H.murmur3_32, (SHUFFLE_SEED,)),
                           ("xxhash64", H.xxhash64, ()),
                           ("hive_hash", H.hive_hash, ())):
        got = fn(cols, *args).data
        check(torch.equal(got.cpu(), fn(cpu, *args).data),
              f"nested {name} on the card == on the CPU")
        res[f"{name}_ms"] = host_ms(lambda: fn(cols, *args), 3)
    start = REGISTRY.live_count()
    handles = [REGISTRY.register(c) for c in cols]
    out = jni_api.hive_hash(handles)
    check(torch.equal(REGISTRY.get(out).data, H.hive_hash(cols).data),
          "JNI-door hive_hash == hive_hash")
    release_all(handles, [out])
    check(REGISTRY.live_count() == start, "every hive handle released")
    st = Column.make_struct(3, [Column.from_pylist([1, 2, 3], dtypes.INT32,
                                                   "cuda")])
    bad = Column.make_list(torch.tensor([0, 1, 3], device="cuda"), st)
    for col in (bad, on_cpu(bad)):
        for fn in (H.murmur3_32, H.xxhash64):
            try:
                fn([col])
                check(False, "LIST of STRUCT refused")
            except ValueError as e:
                check("LIST of STRUCT" in str(e), "LIST of STRUCT refused")
    return res


def run_shuffle():
    """The kudo shuffle on the card (see the module docstring)."""
    RA.reset_launches()
    res = {}
    batch = store_sales_batch(OPS_ROWS, seed=31)
    _, res["flat"] = shuffle_cell("flat", batch, [batch.columns[1]])
    del batch, _
    torch.cuda.empty_cache()
    nested = nested_batch(NESTED_ROWS, seed=37)
    res["nested_hashes"] = nested_hashes(nested)
    _, res["nested"] = shuffle_cell("nested", nested,
                                    [nested.columns[0], nested.columns[3]])
    del nested, _
    torch.cuda.empty_cache()
    print(f"shuffle: {json.dumps(res)}", flush=True)
    return read_launches("shuffle_batch"), res


# ------------------------------------------------------------ memory (11)


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def allocated(device):
    """Device bytes held by live tensors; None off the card."""
    gc.collect()
    sync(device)
    if torch.device(device).type != "cuda":
        return None
    return torch.cuda.memory_allocated()


def wall_ms(fn, iters, device):
    """Median wall milliseconds of `fn` followed by a synchronize."""
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def peak_added(fn, device):
    """(fn's result, the peak device memory its call added in MiB; None
    off the card)."""
    if torch.device(device).type != "cuda":
        return fn(), None
    return added_peak_mb(fn)


def spill_store(tier):
    """A spill store with its files under build/spill/<tier>: the host
    tier, or every spill demoted to disk."""
    return PS.SpillStore(spill_dir=os.path.join(_BUILD, "spill", tier),
                         host_limit_bytes=0 if tier == "disk" else None)


def store_numbers(store):
    st = store.stats()
    return {"spills_host": st["spills_host"], "spills_disk": st["spills_disk"],
            "host_bytes": store.spill_bytes[PS.TIER_HOST],
            "disk_bytes": store.spill_bytes[PS.TIER_DISK],
            "restores": st["restores"], "handles_left": st["handles"]}


def equal_columns(got, want, what):
    """Columns equal byte for byte, on the same device."""
    check(len(got) == len(want), f"{what}: column count")
    for i, (a, b) in enumerate(zip(got, want)):
        check(a.device == b.device, f"{what}: column {i} on its device")
        for x, y, part in ((a.data, b.data, "data"),
                           (a.validity, b.validity, "validity"),
                           (a.offsets, b.offsets, "offsets")):
            check((x is None) == (y is None)
                  and (x is None or torch.equal(x, y)),
                  f"{what}: column {i} {part}")


def same_group_table(got, want, what):
    """An out-of-core or task group-by (MEM_AGGS) against the in-memory
    one: keys and integer aggregates byte for byte, the float sum and
    mean within close_float_sums' bound."""
    equal_columns(got.columns[:6], want.columns[:6], what)
    counts = want.columns[3].data.cpu()
    return max(close_float_sums(got.columns[6], on_cpu(want.columns[6]),
                                counts, False, f"{what} sum"),
               close_float_sums(got.columns[7], on_cpu(want.columns[7]),
                                counts, True, f"{what} mean"))


def j2_tables(rows, returns, device, seed):
    """Step 9's J2 on `device`: store_sales (ss_item_sk INT32,
    ss_ticket_number INT64) and store_returns drawn from its rows, with
    the numpy oracle's pairs."""
    g = torch.Generator(device=device).manual_seed(seed)
    item = torch.randint(1, J3_DATA["items"] + 1, (rows,), generator=g,
                         dtype=torch.int32, device=device)
    ticket = (torch.arange(rows, dtype=torch.int64, device=device)
              // J2_ITEMS_PER_TICKET + 1)
    pick = torch.randperm(rows, generator=g, device=device)[:returns]
    surrogate = host_int64(item) << 32 | host_int64(ticket)
    want = int_key_oracle(surrogate, surrogate[pick.cpu().numpy()],
                          device=device)
    return (Table([Column(dtypes.INT32, rows, data=item),
                   Column(dtypes.INT64, rows, data=ticket)]),
            Table([Column(dtypes.INT32, returns, data=item[pick]),
                   Column(dtypes.INT64, returns, data=ticket[pick])]),
            want)


def ooc_join_cell(device="cuda", rows=J1_ROWS, returns=J2_RETURNS,
                  iters=3):
    """J2 out of core at a budget of the build side's bytes / 8 (8
    partitions), on the host tier and on disk, against the in-memory
    join and the oracle."""
    t0 = time.perf_counter()
    left, right, want = j2_tables(rows, returns, device, seed=83)
    build = PS.columns_nbytes(right.columns)
    budget = build // MEM_JOIN_PARTS
    t1 = time.perf_counter()
    got = J.hash_inner_join(left, right)
    same_pairs(got, want, "J2 in memory")
    res = {"rows": [rows, returns], "pairs": int(got[0].shape[0]),
           "build_bytes": build, "budget": budget, "data_s": t1 - t0,
           "in_memory_first_s": time.perf_counter() - t1,
           "in_memory_ms": wall_ms(lambda: J.hash_inner_join(left, right),
                                   iters, device)}
    for tier in ("host", "disk"):
        store = spill_store(tier)

        def ooc():
            return OOC.out_of_core_hash_join(left, right, budget=budget,
                                             store=store)

        t0 = time.perf_counter()
        got, peak = peak_added(ooc, device)
        first_s = time.perf_counter() - t0
        same_pairs(got, want, f"J2 out of core ({tier})")
        first = store_numbers(store)
        check(first["spills_host"] == MEM_JOIN_PARTS
              and first["restores"] == MEM_JOIN_PARTS
              and first["spills_disk"] == (MEM_JOIN_PARTS
                                           if tier == "disk" else 0)
              and first["handles_left"] == 0,
              f"J2 ({tier}): every partition spilled, streamed back, "
              f"closed: {first}")
        res[tier] = dict(first, ms=wall_ms(ooc, iters, device),
                         peak_added_mb=peak, first_call_s=first_s)
        store.close()
    return res


MEM_AGGS = ["sum", "count", "min", "max", "sum", "mean"]


def group_inputs(cols):
    """Step 8's group-by over a store_sales batch's columns: keys
    (store, item); sum(quantity), count(net_paid), min and max(price),
    sum and mean(net_paid)."""
    return Table(cols[:2]), [cols[2], cols[4], cols[3], cols[3], cols[4],
                             cols[4]]


def ooc_groupby_cell(device="cuda", rows=MEM_GROUPBY_ROWS,
                     budget=MEM_GROUPBY_BUDGET, iters=3):
    """Step 8's group-by out of core at a 256 MiB budget (4 partitions)
    against the in-memory call."""
    batch = store_sales_batch(rows, seed=41, device=device)
    keys, values = group_inputs(batch.columns)
    # what the group-by is given: the keys and six value columns, two of
    # them passed more than once
    nbytes = PS.columns_nbytes(keys.columns + values)
    want = G.groupby_aggregate(keys, values, MEM_AGGS)
    store = spill_store("host")

    def ooc():
        return OOC.out_of_core_groupby(keys, values, MEM_AGGS,
                                       budget=budget, store=store)

    got, peak = peak_added(ooc, device)
    bound = same_group_table(got, want, "group-by out of core")
    first = store_numbers(store)
    parts = OOC._partition_count(nbytes, budget, None)
    check(first["spills_host"] == parts and first["restores"] == parts
          and first["handles_left"] == 0,
          f"group-by: {parts} partitions spilled and streamed back")
    res = dict(first, rows=rows, input_bytes=nbytes, budget=budget,
               partitions=parts, groups=got.num_rows,
               float_diff_of_bound=bound, peak_added_mb=peak,
               in_memory_ms=wall_ms(
                   lambda: G.groupby_aggregate(keys, values, MEM_AGGS),
                   iters, device),
               ms=wall_ms(ooc, iters, device))
    store.close()
    return res


def flip_byte(path, at):
    with open(path, "r+b") as f:
        f.seek(at)
        b = f.read(1)
        f.seek(at)
        f.write(bytes([b[0] ^ 0xFF]))


def spill_frees_memory(device="cuda", rows=OPS_ROWS,
                       corrupt_rows=MEM_CORRUPT_ROWS):
    """A registered batch that nothing else references: spilling it
    frees its device memory, restoring gives it back byte for byte on
    its device; a flipped byte in a disk spill file recomputes from
    source, or without a recompute raises KudoCorruptException naming
    the file and the generation."""
    store = spill_store("host")
    h = store.register(store_sales_batch(rows, seed=43,
                                         device=device).columns,
                       name="batch")
    before = allocated(device)
    t0 = time.perf_counter()
    h.spill()
    sync(device)
    spill_s = time.perf_counter() - t0
    after = allocated(device)
    res = {"rows": rows, "device_bytes": h.device_bytes,
           "kudo_bytes": store.spill_bytes[PS.TIER_HOST],
           "spill_s": spill_s}
    if before is not None:
        res["freed_bytes"] = before - after
        check(before - after >= 0.9 * h.device_bytes,
              f"a spill freed {before - after} of the batch's "
              f"{h.device_bytes} device bytes")
    t0 = time.perf_counter()
    cols = h.get()
    sync(device)
    res["restore_s"] = time.perf_counter() - t0
    equal_columns(cols, store_sales_batch(rows, seed=43,
                                          device=device).columns,
                  "restored batch")
    check(all(c.device.type == torch.device(device).type for c in cols),
          "the batch came back on its device")
    del cols
    store.close()

    disk = spill_store("disk")

    def source():
        return store_sales_batch(corrupt_rows, seed=47,
                                 device=device).columns

    h = disk.register(source(), name="corrupt_recompute", recompute=source)
    h.spill()
    check(h.tier == PS.TIER_DISK, "spilled to disk")
    flip_byte(h.path, 1000)
    equal_columns(h.get(), source(), "recomputed from source")
    h = disk.register(source(), name="corrupt_fail")
    h.spill()
    path = h.path
    flip_byte(path, 1000)
    try:
        h.get()
        check(False, "a corrupt spill file without recompute raises")
    except K.KudoCorruptException as e:
        check(e.path == path and e.generation == 1
              and path in str(e) and "generation 1" in str(e),
              f"the error names the file and generation: {e}")
    st = disk.stats()
    check(st["corrupt"] == 2 and st["recomputes"] == 1,
          f"corrupt spills counted: {st}")
    res["corrupt"] = {"rows": corrupt_rows, "corrupt": st["corrupt"],
                      "recomputes": st["recomputes"]}
    disk.close()
    return res


def task_group_by(h, parts, working_bytes, adaptor):
    """One attempt of a task's group-by over some of its key partitions:
    its batch pinned (restored if spilled), `working_bytes` x the share
    of partitions reserved for the working set."""
    with h.pin() as cols:
        w = working_bytes * len(parts) // MEM_TASK_PARTS
        adaptor.allocate(w)
        try:
            ix = torch.cat(list(parts))
            keys, values = group_inputs([CP.gather(c, ix) for c in cols])
            return G.groupby_aggregate(keys, values, MEM_AGGS)
        finally:
            adaptor.deallocate(w)


def task_run(task, rows, device, store, adaptor, barrier, force=None):
    """A Spark task on this thread: reserve and register its batch, wait
    until every task of the round has (a stage barrier), run the
    group-by over its key partitions under split_and_retry, close the
    batch, task_done.  Returns (table, retries, split retries, blocked
    ms)."""
    rmm_spark.current_thread_is_dedicated_to_task(task)
    batch = store_sales_batch(rows, seed=100 + task, device=device)
    nbytes = PS.columns_nbytes(batch.columns)
    # the batch's reservation under the retry contract too: a task
    # rolled back here holds nothing and waits for memory to free
    RT.with_retry(adaptor.allocate, nbytes, name=f"task{task}_batch",
                  policy=MEM_TASK_POLICY)
    words = HJ.join_key_words(Table(batch.columns[:2]),
                              Table(batch.columns[:2]), J.NULL_EQUAL)[0]
    parts = OOC.partition_rows(words, MEM_TASK_PARTS)
    h = store.register(batch.columns, device_bytes=nbytes,
                       name=f"task{task}", task_id=task)
    del batch, words
    # the adaptor knows this wait: a task still blocked on its batch's
    # reservation while the others wait here is woken to spill them
    adaptor.thread_waiting_on_pool()
    try:
        barrier.wait(MEM_THREAD_TIMEOUT_S)
    finally:
        adaptor.thread_done_waiting_on_pool()
    if force is not None:
        force(rmm_spark.current_thread_id(), 1)
    out = RT.split_and_retry(
        lambda p: task_group_by(h, p, nbytes, adaptor), parts,
        combine=lambda tables: OOC.merge_group_partials(tables, 2),
        name=f"task{task}", policy=MEM_TASK_POLICY)
    held = h.close()
    if held:
        adaptor.deallocate(held)
    stats = (adaptor.get_and_reset_num_retry_throw(task),
             adaptor.get_and_reset_num_split_retry_throw(task),
             adaptor.get_and_reset_block_time(task) / 1e6)
    rmm_spark.task_done(task)
    return (out,) + stats


def run_task_threads(jobs):
    """Run (target, args) jobs on dedicated threads, each joined with a
    time limit; a thread still alive (a deadlock) fails the run.  Returns
    their results in order."""
    results = [None] * len(jobs)

    def body(i, fn, args):
        try:
            results[i] = ("ok", fn(*args))
        except Exception as e:  # re-raised below, after the joins
            results[i] = ("error", e)

    threads = [threading.Thread(target=body, args=(i, fn, args),
                                daemon=True)
               for i, (fn, args) in enumerate(jobs)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + MEM_THREAD_TIMEOUT_S
    for t in threads:
        t.join(max(0.1, deadline - time.monotonic()))
    for r in results:
        if r is not None and r[0] == "error":
            raise r[1]
    check(not any(t.is_alive() for t in threads),
          "task threads finished (no deadlock)")
    return [value for _, value in results]


def task_round(name, limit, ids, rows, device, force=None):
    """One round of task threads under an adaptor of `limit` bytes with
    a spill store installed: their outputs, and the round's numbers.
    Afterwards no reservation, thread or handle may be left."""
    store = spill_store("host")
    adaptor = rmm_spark.set_event_handler(limit)
    PS.install(store)
    barrier = threading.Barrier(len(ids))
    try:
        t0 = time.perf_counter()
        out = run_task_threads([(task_run, (t, rows, device, store,
                                            adaptor, barrier, force))
                                for t in ids])
        sync(device)
        wall = time.perf_counter() - t0
        check(adaptor.resource.used == 0
              and adaptor.thread_state_dump() == []
              and store.stats()["handles"] == 0,
              f"{name}: no reservation, thread or handle left")
        return [o[0] for o in out], dict(
            store_numbers(store), limit_bytes=limit, wall_s=wall,
            per_task=[{"retries": r, "split_retries": sp, "blocked_ms": b}
                      for _, r, sp, b in out])
    finally:
        PS.uninstall()
        rmm_spark.clear_event_handler()


def same_task_results(got, want, what):
    return max(same_group_table(a, b, f"{what}, task {i + 1}")
               for i, (a, b) in enumerate(zip(got, want)))


def task_threads(device="cuda", rows=MEM_TASK_ROWS, tasks=MEM_TASKS):
    """The state machine under real task threads: each task reserves,
    registers and groups its own batch of B bytes, reserving one more B
    of working set an attempt, first with no limit, then under a limit
    of 3 B (at least one spill); then forced retry and split on one
    task (see the module docstring)."""
    start = allocated(device)
    ids = range(1, tasks + 1)
    # B: a batch's bytes, the same for every seed
    nbytes = rows * PS.columns_nbytes(store_sales_batch(
        1, seed=0, device=device).columns)
    res = {"tasks": tasks, "rows": rows, "batch_bytes": nbytes}
    want, res["unlimited"] = task_round("unlimited", 1 << 60, ids, rows,
                                        device)
    got, res["limited"] = task_round(
        "limited", MEM_TASK_LIMIT_BATCHES * nbytes, ids, rows, device)
    check(res["limited"]["spills_host"] >= 1,
          "the limited run spilled at least once")
    bound = same_task_results(got, want, "under the limit")
    del got
    # forced OOMs on one task thread over a card batch
    for name, force in (("forced_retry", rmm_spark.force_retry_oom),
                        ("forced_split",
                         rmm_spark.force_split_and_retry_oom)):
        got, r = task_round(name, 1 << 60, ids[:1], rows, device, force)
        (r,) = r["per_task"]
        check(r["retries" if name == "forced_retry" else "split_retries"]
              == 1, f"{name}: one thrown")
        bound = max(bound, same_task_results(got, want, name))
        res[name] = r
        del got
    del want
    res["float_diff_of_bound"] = bound
    end = allocated(device)
    if start is not None:
        check(end == start, f"device memory back to {start} (is {end})")
    return res


def q5_spilled(data, capacity, parts, device, store, iters):
    """q5 over spilled partitions: store_sales and store_returns hash-
    partitioned by store key, each partition's four columns registered
    and spilled; run_spilled runs q5_partials once per partition; the
    partials summed (int64, exact; the overflow flags OR-ed) and
    q5_finish run must equal run_q5 in one pass, byte for byte."""
    d = TT.gen_q5(device=device, **data)
    stores = data["stores"]
    want = TC.run_q5(d, stores, capacity)
    kinds = (dtypes.INT32, dtypes.INT32, dtypes.INT64, dtypes.INT64)

    def handles(cols, store_col, side):
        rows = OOC.partition_rows([store_col.to(torch.int64)], parts)
        return ([store.register([Column(k, len(ix), data=c[ix])
                                 for k, c in zip(kinds, cols)],
                                name=f"q5_{side}{p}")
                 for p, ix in enumerate(rows)],
                [bucket_rows(len(ix)) for ix in rows])

    hs, s_buckets = handles(d[0:4], d.s_store, "s")
    hr, r_buckets = handles(d[4:8], d.r_store, "r")
    stage = compile_stage(TC.q5_partials_plan(stores, capacity))
    buckets = set(zip(s_buckets, r_buckets))

    def spill_all():
        for h in hs + hr:
            h.spill()

    def run():
        outs = stage.run_spilled([{"s": a, "r": b, "d": (d.d_date,)}
                                  for a, b in zip(hs, hr)])
        sums = [sum(o[i] for o in outs) for i in range(4)]
        of = torch.stack([o[4] for o in outs]).any()
        return TC.run_q5_finish(*sums, of, d.st_id, stores)

    spill_all()
    compiles = stage.compiles
    t0 = time.perf_counter()
    got = run()
    sync(device)
    first_s = time.perf_counter() - t0
    for i, (a, b) in enumerate(zip(got, want)):
        check(a.dtype == b.dtype and torch.equal(a, b),
              f"q5 over spilled partitions == one pass (output {i})")
    check(not bool(got[4]), "q5 partitions fit the join capacity")
    res = {"partitions": parts, "spills_host": store.stats()["spills_host"],
           "restores": store.stats()["restores"],
           "compiles": stage.compiles - compiles,
           "row_buckets": sorted(buckets), "first_call_s": first_s}
    check(res["compiles"] <= len(buckets),
          f"at most one compile per row bucket: {res}")
    times = []
    for _ in range(iters):
        spill_all()
        times.append(wall_ms(run, 1, device))
    res["spilled_ms"] = sorted(times)[len(times) // 2] if times else None
    res["single_pass_ms"] = wall_ms(lambda: TC.run_q5(d, stores, capacity),
                                    max(iters, 1), device)
    for h in hs + hr:
        h.close()
    return res


def q5_spilled_fused():
    """Step 11's q5 at step 6's size, the stage fused."""
    store = spill_store("host")
    with fusion("1"):
        res = q5_spilled(Q5_DATA, Q5_CAPACITY, MEM_Q5_PARTS, "cuda", store,
                         iters=1)
    res.update(host_bytes=store.spill_bytes[PS.TIER_HOST])
    store.close()
    return res


def jni_spill_entries(device="cuda", rows=1 << 20):
    """The JNI door's spill entries over a batch on `device`."""
    check(not jni_api.spill_store_install(),
          "no adaptor installed to hook")
    store = PS.installed_store()
    h = store.register(store_sales_batch(rows, seed=53,
                                         device=device).columns,
                       name="door")
    freed = jni_api.spill_ensure_headroom(1)
    stats = json.loads(jni_api.spill_store_stats_json())
    check(freed == h.device_bytes and stats["installed"]
          and stats["spills_host"] == 1 and stats["handles"] == 1
          and stats["spillable_bytes"] == 0,
          f"the door spilled the batch: {freed} {stats}")
    equal_columns(h.get(), store_sales_batch(rows, seed=53,
                                             device=device).columns,
                  "door batch restored")
    jni_api.spill_store_uninstall()
    check(PS.installed_store() is None and h.closed
          and json.loads(jni_api.spill_store_stats_json())
          == {"installed": False}, "the door uninstalled the store")
    return {"freed_bytes": freed, "stats": stats}


def run_memory():
    """The memory runtime on the card (see the module docstring)."""
    RA.reset_launches()
    res = {}
    clock = time.perf_counter()
    # the join router's verdicts go to step 9's file: J2's is there
    saved = os.environ.get("SPARK_RAPIDS_TPU_CALIB_CACHE")
    os.environ["SPARK_RAPIDS_TPU_CALIB_CACHE"] = os.path.join(
        _BUILD, "join_calib.json")
    try:
        for name, fn in (("ooc_join", ooc_join_cell),
                         ("ooc_groupby", ooc_groupby_cell),
                         ("spill", spill_frees_memory),
                         ("task_threads", task_threads),
                         ("q5_spilled", q5_spilled_fused),
                         ("jni_door", jni_spill_entries)):
            res[name] = fn()
            torch.cuda.empty_cache()
            res[name]["phase_s"] = time.perf_counter() - clock
            clock = time.perf_counter()
    finally:
        if saved is None:
            os.environ.pop("SPARK_RAPIDS_TPU_CALIB_CACHE", None)
        else:
            os.environ["SPARK_RAPIDS_TPU_CALIB_CACHE"] = saved
        shutil.rmtree(os.path.join(_BUILD, "spill"), ignore_errors=True)
    print(f"memory: {json.dumps(res)}", flush=True)
    return read_launches("memory"), res


# ------------------------------------------------------------ strings (12)


@contextlib.contextmanager
def env(**values):
    """Environment variables set for the block (None: unset)."""
    saved = {k: os.environ.get(k) for k in values}
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def with_edges(col, vocab, g, every=STR_EDGE_EVERY):
    """(`col` with a seeded 1/every of its rows replaced by `vocab`'s
    entries, valid; the replaced rows' mask), on col's device."""
    device = col.device
    rows = col.length
    edge = torch.randint(0, every, (rows,), generator=g,
                         device=device) == 0
    pick = torch.randint(0, len(vocab), (rows,), generator=g,
                         device=device)
    both = CP.concat_columns([col, Column.from_strings(vocab, device)])
    idx = torch.where(edge, rows + pick, torch.arange(rows, device=device))
    return CP.gather(both, idx), edge


def int_strings(values, valid):
    """The decimal renderings of int64 values as a STRING column on their
    device, from digit arithmetic (no cast of the port's)."""
    device = values.device
    rows = values.shape[0]
    neg = values < 0
    mag = values.abs()
    p10 = 10 ** torch.arange(19, dtype=torch.int64, device=device)
    ndig = (mag[:, None] >= p10[None, :]).sum(dim=1).clamp(min=1)
    width = 20
    mat = torch.empty((rows, width), dtype=torch.uint8, device=device)
    for j in range(width):
        e = (ndig - 1 - (j - neg.to(torch.int64))).clamp(0, 18)
        d = (mag // p10[e]) % 10 + 48
        mat[:, j] = torch.where(neg & (j == 0), 45, d).to(torch.uint8)
    return SB.build_string_column(
        mat.reshape(-1), torch.arange(rows, device=device) * width,
        ndig + neg.to(torch.int64), valid)


def chars_mb(col):
    return int(col.offsets[-1] - col.offsets[0]) / 1e6


def timed_call(fn, device, iters):
    """(fn's first result, {the lower median ms of `iters` synchronized
    calls, the first of them included (of 2, the faster); the first
    call's ms; the peak device memory the first call added})."""
    t0 = time.perf_counter()
    out, peak = peak_added(fn, device)
    first = (time.perf_counter() - t0) * 1e3
    times = [first] + [wall_ms(fn, 1, device) for _ in range(iters - 1)]
    return out, {"first_ms": first,
                 "ms": sorted(times)[(len(times) - 1) // 2],
                 "peak_added_mb": peak}


def card_and_cpu(fn, cols, what):
    """fn over card columns, then over their CPU copies: equal byte for
    byte, the card's result on the card."""
    got = fn(*cols)
    want = fn(*[on_cpu(c) for c in cols])
    check(got.device == cols[0].device, f"{what}: on its input's device")
    same_nested(got, want, f"{what}: card == CPU")
    return got


def first_bad_row(call, want_row, what):
    """The ANSI call raises at `want_row` (the first valid input that
    casts to null)."""
    try:
        call()
    except CastException as e:
        check(e.row_index == want_row,
              f"{what}: ANSI raised at row {e.row_index}, want {want_row}")
        return e.row_index
    check(False, f"{what}: ANSI mode raised nothing")


def first_true(mask):
    rows = torch.nonzero(mask).squeeze(1)
    return int(rows[0]) if rows.shape[0] else None


def cast_values(device, rows, seed):
    """The casts' inputs on `device`: ss_net_paid FLOAT64 (about 4% null)
    and its FLOAT32, and ss_quantity or ss_ticket_number (TPC-DS SF100:
    1 to 24,000,000) as INT64, each rendered: the floats by the port's
    float_to_string, the integers by digit arithmetic."""
    batch = store_sales_batch(rows, seed, device)
    net = batch.columns[4]
    net32 = Column(dtypes.FLOAT32, rows, data=net.data.to(torch.float32),
                   validity=net.validity)
    g = torch.Generator(device=device).manual_seed(seed)
    qty = batch.columns[2]
    ticket = torch.randint(1, 24_000_001, (rows,), generator=g,
                           dtype=torch.int64, device=device)
    coin = torch.rand(rows, generator=g, device=device) < 0.5
    ints = torch.where(coin, qty.data.to(torch.int64), ticket)
    return net, net32, ints, qty.validity.to(torch.bool), g


def cast_phase(device="cuda", rows=STR_CAST_ROWS, cpu_rows=STR_CPU_ROWS,
               host_rows=STR_HOST_ROWS, iters=STR_ITERS):
    """The string casts on the card (see the module docstring)."""
    res = {"rows": rows}
    net, net32, ints, ivalid, g = cast_values(device, rows, seed=12)

    # float -> string -> float, FLOAT64 and FLOAT32
    for name, col, dt in (("f64", net, dtypes.FLOAT64),
                          ("f32", net32, dtypes.FLOAT32)):
        with env(SPARK_RAPIDS_TPU_FTOS="device"):
            text, ftos = timed_call(lambda: CS.float_to_string(col),
                                    device, iters)
        check(text.device == col.device, f"float_to_string {name}: device")
        ftos.update(out_chars_mb=chars_mb(text),
                    out_mb_per_s=chars_mb(text) / ftos["ms"] * 1e3)
        mixed, edge = with_edges(text, FLOAT_EDGES, g)
        with env(SPARK_RAPIDS_TPU_STOD="device"):
            back, stod = timed_call(lambda: CS.string_to_float(mixed, dt),
                                    device, iters)
        stod.update(SD.LAST_CALL, in_chars_mb=chars_mb(mixed),
                    in_mb_per_s=chars_mb(mixed) / stod["ms"] * 1e3)
        kept = ~edge & col.valid_mask()
        width = torch.int64 if name == "f64" else torch.int32
        check(torch.equal(back.valid_mask()[~edge], kept[~edge])
              and torch.equal(back.data.view(width)[kept],
                              col.data.view(width)[kept]),
              f"string_to_float {name}: every non-null value back bit for "
              f"bit")
        res[f"float_to_string_{name}"] = ftos
        res[f"string_to_float_{name}"] = stod
        first_bad_row(
            lambda: CS.string_to_float(mixed, dt, ansi_mode=True),
            first_true(mixed.valid_mask() & ~back.valid_mask()),
            f"string_to_float {name}")
        # the card against the port's CPU run on a slice, and against
        # the host engines on a sample
        part = CP.slice_column(mixed, 0, cpu_rows)
        with env(SPARK_RAPIDS_TPU_STOD="device",
                 SPARK_RAPIDS_TPU_FTOS="device"):
            got = CS.string_to_float(part, dt)
            flagged = SD.LAST_CALL["fallback_rows"]
            want = CS.string_to_float(on_cpu(part), dt)
            check(got.device == part.device, "string_to_float: device")
            same_nested(got, want, f"string_to_float {name} slice: card "
                        f"== CPU")
            check(SD.LAST_CALL["fallback_rows"] == flagged,
                  f"string_to_float {name}: as many host rows on the card "
                  f"as on the CPU ({flagged})")
            card_and_cpu(CS.float_to_string,
                         [CP.slice_column(col, 0, cpu_rows)],
                         f"float_to_string {name} slice")
        stod["cpu_slice_fallback_rows"] = flagged
        sample = CP.slice_column(mixed, 0, host_rows)
        values = CP.slice_column(col, 0, host_rows)
        with env(SPARK_RAPIDS_TPU_STOD="device",
                 SPARK_RAPIDS_TPU_FTOS="device"):
            dev = (CS.string_to_float(sample, dt),
                   CS.float_to_string(values))
        with env(SPARK_RAPIDS_TPU_STOD="host", SPARK_RAPIDS_TPU_FTOS="host"):
            host = (CS.string_to_float(sample, dt),
                    CS.float_to_string(values))
        for h in host:
            check(h.device == sample.device, "host engines: device")
        # the engines leave different bytes under null rows
        mask = host[0].valid_mask()
        check(torch.equal(dev[0].valid_mask(), mask)
              and torch.equal(raw_bytes(dev[0].data[mask]),
                              raw_bytes(host[0].data[mask])),
              f"string_to_float {name}: device engine == host")
        same_nested(dev[1], host[1],
                    f"float_to_string {name}: device engine == host")
        del text, mixed, back, edge

    # string -> integer into INT64, INT32 and INT8
    istr = int_strings(ints, ivalid)
    mixed, edge = with_edges(istr, INT_EDGES, g)
    for dt, lo, hi in ((dtypes.INT64, -2**63, 2**63 - 1),
                       (dtypes.INT32, -2**31, 2**31 - 1),
                       (dtypes.INT8, -128, 127)):
        out, t = timed_call(lambda: CS.string_to_integer(mixed, dt),
                            device, iters)
        t.update(in_chars_mb=chars_mb(mixed), width=mixed.max_string_length(),
                 in_mb_per_s=chars_mb(mixed) / t["ms"] * 1e3)
        t["scan_steps"] = t["width"]
        fits = ~edge & ivalid & (ints >= lo) & (ints <= hi)
        check(torch.equal(out.valid_mask()[~edge], fits[~edge])
              and torch.equal(out.data[fits].to(torch.int64), ints[fits]),
              f"string_to_integer {dt.kind}: every fitting value back")
        card_and_cpu(lambda c: CS.string_to_integer(c, dt),
                     [CP.slice_column(mixed, 0, cpu_rows)],
                     f"string_to_integer {dt.kind} slice")
        res[f"string_to_integer_{dt.kind}"] = t
    first_bad_row(
        lambda: CS.string_to_integer(mixed, dtypes.INT8, ansi_mode=True),
        first_true(mixed.valid_mask() & ~
            CS.string_to_integer(mixed, dtypes.INT8).valid_mask()),
        "string_to_integer int8")

    # the host-loop casts, once at host_rows, each on the card and on the
    # CPU
    fsample = with_edges(CS.float_to_string(
        CP.slice_column(net, 0, host_rows)), FLOAT_EDGES, g)[0]
    isample = CP.slice_column(mixed, 0, host_rows)
    clock = time.perf_counter()
    loops = {
        "string_to_decimal": (lambda c: CS.string_to_decimal(c, 12, -2),
                              [fsample]),
        "string_to_integers_with_base": (
            lambda c: CS.string_to_integers_with_base(c, 10), [isample]),
        "integers_with_base_to_string": (
            lambda c: CS.integers_with_base_to_string(c, 16),
            [Column(dtypes.INT64, host_rows, data=ints[:host_rows],
                    validity=ivalid[:host_rows].to(torch.uint8))]),
        "convert": (lambda c: SM.convert(c, 10, 16), [isample]),
        "literal_range_pattern": (
            lambda c: SM.literal_range_pattern(c, ".", 2, ord("0"),
                                               ord("9")), [fsample]),
        "list_slice": (lambda c: SM.list_slice(c, 2, 3),
                       [card_list(g, host_rows, 8, lambda n: Column(
                           dtypes.INT32, n, data=torch.randint(
                               -99, 99, (n,), generator=g,
                               dtype=torch.int32, device=device)),
                           device=device)]),
        "decode_to_utf8": (SM.decode_to_utf8,
                           [card_strings(g, host_rows, 0, 32, device)]),
    }
    for what, (fn, cols) in loops.items():
        card_and_cpu(fn, cols, what)
    res["host_loops"] = {"rows": host_rows,
                         "s": time.perf_counter() - clock}

    # the JNI door's string_to_integer on a card handle
    live = REGISTRY.live_count()
    h = REGISTRY.register(isample)
    out = jni_api.string_to_integer(h, "int64", False, True)
    try:
        same_nested(REGISTRY.get(out),
                    CS.string_to_integer(isample, dtypes.INT64),
                    "jni string_to_integer")
    finally:
        release_all(h, out)
    check(REGISTRY.live_count() == live, "jni: every handle released")
    return res


def concat_rows(cols, validity):
    """Row i of the result is row i of every column in order, on the
    columns' device (null rows keep their bytes)."""
    device = cols[0].device
    rows = cols[0].length
    lens = [c.string_lengths().to(torch.int64) for c in cols]
    offs = torch.zeros(rows + 1, dtype=torch.int64, device=device)
    torch.cumsum(sum(lens), 0, out=offs[1:])
    buf = torch.empty(int(offs[-1]), dtype=torch.uint8, device=device)
    pos = offs[:-1].clone()
    for c, n in zip(cols, lens):
        total = int(n.sum())
        row = torch.repeat_interleave(torch.arange(rows, device=device), n,
                                      output_size=total)
        within = torch.arange(total, device=device) - (
            torch.cumsum(n, 0) - n)[row]
        buf[pos[row] + within] = c.data[
            c.offsets[:-1].to(torch.int64)[row] + within]
        pos += n
    return Column(dtypes.STRING, rows, data=buf, validity=validity,
                  offsets=offs.to(torch.int32))


def url_vocab(seed):
    """The URL pieces: schemes, userinfo, hosts and IPv4 addresses,
    IPv6 literals, ports, paths (ASCII, non-ASCII, invalid), queries over
    a few common keys, fragments."""
    rng = np.random.default_rng(seed)
    alnum = np.array(list("abcdefghijklmnopqrstuvwxyz0123456789"))

    def word(lo, hi):
        return "".join(rng.choice(alnum, int(rng.integers(lo, hi + 1))))

    hosts = [f"www.{word(3, 12)}.com" for _ in range(400)] + \
        [f"{word(2, 8)}-{word(2, 8)}.example.org" for _ in range(300)] + \
        [f"cdn{int(rng.integers(0, 99))}.{word(3, 10)}.net"
         for _ in range(300)] + \
        [".".join(str(int(x)) for x in rng.integers(0, 256, 4))
         for _ in range(200)]
    def pairs(n):
        """`&`-joined key=value pairs of about n bytes."""
        out = []
        while sum(len(p) + 1 for p in out) < n:
            out.append(f"{keys[int(rng.integers(len(keys)))]}="
                       f"{word(1, 10)}")
        return "&".join(out)[:n]

    def path(n):
        """A path of `/`-separated segments, n bytes."""
        p = ""
        while len(p) < n:
            seg = word(1, 12)
            if rng.random() < 0.1:
                seg += "%20" + word(1, 4)
            p += "/" + seg
        return p[:n]

    keys = ["q", "id", "page", "utm_source", "ref", "lang", "sort"]
    # lengths: paths 6-88 bytes, queries empty or 3-48: every URL is at
    # most 199 bytes (scheme 8, userinfo 13, host 29, port 5, fragment 8)
    paths = [path(int(n)) for n in rng.integers(6, 89, 4000)]
    queries = [""] * 1000 + ["?" + pairs(int(n) - 1)
                             for n in rng.integers(3, 49, 3000)]
    return {
        "scheme": ["http"] * 4 + ["https"] * 8 + ["ftp", "s3a", "hdfs",
                                                  "HTTP"],
        "sep": ["://"],
        "user": [""] * 18 + ["user@", "admin:secret@"],
        "host": hosts,
        "ipv6": ["[2001:db8::1]", "[::1]", "[fe80::1:2:3:4]",
                 "[2001:db8:0:0:0:0:0:7]", "[1:2:3:4:5:6:7:8:9]"],
        "port": [""] * 14 + [":80", ":443", ":8080", ":9000", ":", ":x9"],
        "path": paths,
        "non_ascii": ["/café/menu", "/日本/東京",
                      "/naïve", "/straße/1"],
        "invalid": ["/bad path", "/p%zz", "/%2", "/a|b", "/x y/z"],
        "query": queries,
        "fragment": [""] * 17 + ["#top", "#sec2", "#frag%41"],
    }


def url_column(rows, seed, device):
    """`rows` URLs drawn on `device` from url_vocab: about 1% IPv6 hosts
    and 1% non-ASCII paths (the host fallback's rows), about 2% invalid
    paths and URL_NULL_SHARE nulls."""
    v = url_vocab(seed)
    g = torch.Generator(device=device).manual_seed(seed)

    def piece(name, alt=None, share=0.0):
        vocab = v[name] + (v[alt] if alt else [])
        idx = torch.randint(0, len(v[name]), (rows,), generator=g,
                            device=device)
        if alt:
            other = len(v[name]) + torch.randint(
                0, len(v[alt]), (rows,), generator=g, device=device)
            idx = torch.where(torch.rand(rows, generator=g, device=device)
                              < share, other, idx)
        return CP.gather(Column.from_strings(vocab, device), idx)

    path = piece("path", "non_ascii", 0.01)
    odd = CP.gather(Column.from_strings(v["path"] + v["invalid"], device),
                    torch.randint(len(v["path"]), len(v["path"])
                                  + len(v["invalid"]), (rows,),
                                  generator=g, device=device))
    bad = torch.rand(rows, generator=g, device=device) < 0.02
    path = CP.gather(CP.concat_columns([path, odd]), torch.where(
        bad, rows + torch.arange(rows, device=device),
        torch.arange(rows, device=device)))
    valid = (torch.rand(rows, generator=g, device=device)
             >= URL_NULL_SHARE).to(torch.uint8)
    return concat_rows([piece("scheme"), piece("sep"), piece("user"),
                        piece("host", "ipv6", 0.01), piece("port"), path,
                        piece("query"), piece("fragment")], valid)


EXTRACTORS = ("protocol", "host", "query", "path")


def extract(col, what, key=None, ansi=False):
    if what == "query_key":
        return U.parse_uri_to_query_with_key(col, key, ansi_mode=ansi)
    return getattr(U, f"parse_uri_to_{what}")(col, ansi_mode=ansi)


def first_invalid_url(call):
    try:
        call()
    except ExceptionWithRowIndex as e:
        return e.row_index, str(e)
    return None, None


def url_phase(device="cuda", rows=URL_ROWS, key_rows=URL_KEY_ROWS,
              cpu_rows=URL_CPU_ROWS, host_rows=URL_HOST_ROWS,
              iters=STR_ITERS):
    """parse_url on the card (see the module docstring)."""
    col = url_column(rows, seed=21, device=device)
    lens = col.string_lengths()
    res = {"rows": rows, "chars_mb": chars_mb(col),
           "min_len": int(lens.min()), "max_len": int(lens.max()),
           "mean_len": float(lens.to(torch.float64).mean())}
    calls = [(what, col, None) for what in EXTRACTORS]
    keyed = CP.slice_column(col, 0, key_rows)
    calls += [(what, keyed, None) for what in EXTRACTORS]
    calls += [("query_key", keyed, "q")]
    for what, c, key in calls:
        UD.reset_stats()
        out, t = timed_call(lambda: extract(c, what, key), device, iters)
        check(out.device == c.device and out.length == c.length,
              f"parse_url {what}: rows on the input's device")
        t.update(UD.STATS, rows=c.length, in_chars_mb=chars_mb(c),
                 in_mb_per_s=chars_mb(c) / t["ms"] * 1e3, calls=iters)
        res[f"{what}_{c.length}"] = t
    # the memo: after the 2^20-row column's PROTOCOL, the other
    # extractors over it analyse nothing again
    for what in ("host", "query", "path", "query_key"):
        t = res[f"{what}_{key_rows}"]
        check(t["memo_misses"] == 0 and t["memo_hits"] > 0,
              f"parse_url {what} over {key_rows} rows: memo hits only")
    # one chunk on the card against the CPU, and the device engine
    # against the host parser on a sample
    part = CP.slice_column(col, 0, cpu_rows)
    cpu_part = on_cpu(part)
    for what in EXTRACTORS + ("query_key",):
        UD.reset_stats()
        got = extract(part, what, "q")
        flagged = UD.STATS["fallback_rows"]
        UD.reset_stats()
        want = extract(cpu_part, what, "q")
        check(got.device == part.device, f"parse_url {what}: device")
        same_nested(got, want, f"parse_url {what} chunk: card == CPU")
        check(UD.STATS["fallback_rows"] == flagged,
              f"parse_url {what}: as many host rows on the card as on the "
              f"CPU ({flagged})")
    res["cpu_chunk_fallback_rows"] = flagged
    sample = CP.slice_column(col, 0, host_rows)
    for what in EXTRACTORS + ("query_key",):
        with env(SPARK_RAPIDS_TPU_FORCE_DEVICE_PARSE_URI="1"):
            dev = extract(sample, what, "q")
        with env(SPARK_RAPIDS_TPU_FORCE_DEVICE_PARSE_URI=None,
                 SPARK_RAPIDS_TPU_PARSE_URI_DEVICE_MIN=str(2 * host_rows)):
            host = extract(sample, what, "q")
        check(host.device == sample.device, "parse_url host: device")
        same_nested(dev, host, f"parse_url {what}: device engine == host")
    # ANSI: the first invalid row, on the card as on the CPU and the host
    # parser
    got = first_invalid_url(lambda: extract(part, "host", ansi=True))
    want = first_invalid_url(lambda: extract(cpu_part, "host", ansi=True))
    check(got[0] is not None and got[0] == want[0],
          f"parse_url ANSI: card row {got[0]}, CPU row {want[0]}")
    with env(SPARK_RAPIDS_TPU_FORCE_DEVICE_PARSE_URI=None,
             SPARK_RAPIDS_TPU_PARSE_URI_DEVICE_MIN=str(2 * rows)):
        host = first_invalid_url(lambda: extract(part, "host", ansi=True))
    check(host[0] == got[0], f"parse_url ANSI: host parser row {host[0]}")
    res["ansi_row"] = got[0]
    return res


def run_strings(device="cuda", cast_kw=None, url_kw=None):
    """The string casts and parse_url on the card (see the module
    docstring)."""
    RA.reset_launches()
    res = {}
    clock = time.perf_counter()
    res["casts"] = cast_phase(device, **(cast_kw or {}))
    res["casts"]["phase_s"] = time.perf_counter() - clock
    sync(device)
    clock = time.perf_counter()
    res["parse_url"] = url_phase(device, **(url_kw or {}))
    res["parse_url"]["phase_s"] = time.perf_counter() - clock
    print(f"strings: {json.dumps(res)}", flush=True)
    return read_launches("strings"), res


# --------------------------------------------------------------- json (13)

# a quarter of BASELINE.json's get_json_object column (all 2^20 rows
# before step 19 needed the time, 2^19 before step 20)
JSON_ROWS = 1 << 18
JSON_CHUNK_ROWS = 1 << 17    # one device-scan chunk (DEVICE_ROW_CHUNK)
# the CPU checks and the map ops: 2^13 rows (2^14 until step 21 needed
# the time); the host-bound calls keep one calibration sample, 2^14 rows
# (JP.JSON_CALIBRATE_MIN_ROWS: below it the router takes its default)
JSON_CPU_ROWS = 1 << 13      # the CPU run's rows, and the host engine's
JSON_SMALL_ROWS = 1 << 14    # the host-bound calls
JSON_MAP_ROWS = 1 << 13      # the map ops (host loops over the entries)
JSON_NULL_SHARE = 0.04
JSON_EDGE_EVERY = 32
JSON_PATHS = ("$.event", "$.user.id", "$.user.name", "$.items[0]",
              "$.items[*].sku", "$.ctx.a.b.c")
# most of these paths' rows go to the host parser (a fractional price in
# every item: Java double rendering; several items: a multi-match), about
# 90 us each: timed on JSON_SMALL_ROWS
JSON_HOST_BOUND = ("$.items[0]", "$.items[*].sku")
JSON_ENGINES = ("host", "device_scan", "tokenizer")
JSON_EVENTS = ["click", "view", "add_to_cart", "purchase", "search",
               "scroll", "login", "logout"]
JSON_TAGS = ["new", "vip", "mobile", "desktop", "returning", "promo",
             "beta", "eu", "us"]
# the tolerant parser's edges: single quotes, escapes (\n, é, a surrogate
# pair), unescaped control chars, nesting past the device scan's 16
# tracked levels, leading zeros, whitespace inside containers, duplicate
# keys, non-ASCII, invalid JSON
JSON_EDGES = [
    "{'event': 'single', 'ts': 1, 'user': {'id': 2, 'name': 'sq'}}",
    '{"event": "line\\nbreak", "user": {"id": 7, "name": "a\\tb"}}',
    '{"event": "caf\\u00e9", "user": {"name": "\\ud83d\\ude00", "id": 3}}',
    '{"event": "ctrl\x01char", "user": {"name": "x\ty", "id": 4}}',
    '{"event": "deep", "ctx": ' + '{"a": ' * 17 + '1' + '}' * 17 + '}',
    '{"event": "lz", "ts": 007, "user": {"id": 01}}',
    '{ "event" : "ws" , "items" : [ { "sku" : "s1" , "qty" : 2 } ] ,'
    ' "ctx" : { "a" : { "b" : { "c" : "x" } } } }',
    '{"event": "dup", "event": "dup2", "user": {"id": 1, "id": 2}}',
    '{"event": "naïve 中文", "user": {"name": "Zoë", "id": 9}}',
    '{"event": "broken", "ts": }',
    '{"event": "open"',
    '[{"event": "array root"}]',
    '{"items": [{"sku": "a\\"q", "price": 1e400}, {"sku": 5}], "ts": 1.5e3}',
    '{"user": {"id": -0, "name": null}, "items": []}',
]


def masked(col, keep):
    """`col` with the rows where `keep` is False emptied (length 0)."""
    lens = col.string_lengths().to(torch.int64)
    return SB.build_string_column(col.data, col.offsets[:-1].to(torch.int64),
                                  torch.where(keep, lens, 0))


def pick(vocab, g, rows, device):
    """A STRING column of `rows` entries drawn from `vocab`."""
    idx = torch.randint(0, len(vocab), (rows,), generator=g, device=device)
    return CP.gather(Column.from_strings(vocab, device), idx)


def const(text, rows, device):
    return CP.gather(Column.from_strings([text], device),
                     torch.zeros(rows, dtype=torch.int64, device=device))


def rand_text(g, rows, lo, hi, device):
    """Random lowercase words of lo to hi bytes."""
    mat = torch.randint(97, 123, (rows, max(hi, 1)), generator=g,
                        dtype=torch.uint8, device=device)
    lens = torch.randint(lo, hi + 1, (rows,), generator=g, device=device)
    return SB.build_string_column(
        mat.reshape(-1), torch.arange(rows, device=device) * max(hi, 1),
        lens)


def ints_text(g, rows, lo, hi, device):
    return int_strings(torch.randint(lo, hi, (rows,), generator=g,
                                     dtype=torch.int64, device=device),
                       None)


def ctx_vocab():
    """ctx objects 1 to 5 deep (keys a..e), a short string at the bottom."""
    out = []
    for depth in range(1, 6):
        for leaf in range(10):
            v = f'"x{leaf}"'
            for key in reversed("abcde"[:depth]):
                v = '{"%s":%s}' % (key, v)
            out.append(v)
    return out


def event_docs(rows, seed, device="cuda"):
    """Clickstream events drawn on `device`: event, ts, user {id, name,
    tags (0-4 strings)}, page (a path of 1-121 bytes), items (0-8
    objects of sku, qty, price) and ctx (1-5 deep), 100 to 1,000 bytes
    (about 400 on average); JSON_NULL_SHARE of the rows null and a seeded
    1/JSON_EDGE_EVERY replaced by JSON_EDGES.  Returns (column, edge
    mask)."""
    g = torch.Generator(device=device).manual_seed(seed)
    n_tags = torch.randint(0, 5, (rows,), generator=g, device=device)
    n_items = torch.randint(0, 9, (rows,), generator=g, device=device)
    parts = [const('{"event":"', rows, device),
             pick(JSON_EVENTS, g, rows, device),
             const('","ts":', rows, device),
             ints_text(g, rows, 1_600_000_000_000, 1_800_000_000_000,
                       device),
             const(',"user":{"id":', rows, device),
             ints_text(g, rows, 1, 10_000_000, device),
             const(',"name":"user_', rows, device),
             ints_text(g, rows, 0, 100_000, device),
             const('","tags":[', rows, device)]
    for t in range(4):
        keep = n_tags > t
        parts += [masked(const('"' if t == 0 else ',"', rows, device), keep),
                  masked(pick(JSON_TAGS, g, rows, device), keep),
                  masked(const('"', rows, device), keep)]
    parts += [const(']},"page":"/', rows, device),
              rand_text(g, rows, 0, 120, device),
              const('","items":[', rows, device)]
    for j in range(8):
        keep = n_items > j
        item = [const(('{' if j == 0 else ',{') + '"sku":"SKU', rows,
                      device),
                ints_text(g, rows, 10000, 100000, device),
                const('","qty":', rows, device),
                ints_text(g, rows, 1, 10, device),
                const(',"price":', rows, device),
                ints_text(g, rows, 0, 1000, device),
                pick([".%02d" % c for c in range(100)], g, rows, device),
                const('}', rows, device)]
        parts += [masked(p, keep) for p in item]
    parts += [const('],"ctx":', rows, device), pick(ctx_vocab(), g, rows,
                                                    device),
              const('}', rows, device)]
    valid = (torch.rand(rows, generator=g, device=device)
             >= JSON_NULL_SHARE).to(torch.uint8)
    col = concat_rows(parts, valid)
    return with_edges(col, JSON_EDGES, g, JSON_EDGE_EVERY)


def raw_map_docs(rows, seed, device="cuda"):
    """Flat objects of 4-40 pairs (a seeded 1/256 of the rows 65-70, past
    the tokenizer's 64), keys f0, f1, ...: f0 INT64, f1 INT32, f2
    FLOAT64, f3 BOOL8, f4 and f5 strings, the rest any of these or null;
    about 1 value in 50 of f0-f5 null.  JSON_NULL_SHARE of the rows
    null."""
    g = torch.Generator(device=device).manual_seed(seed)
    rng = np.random.default_rng(seed)
    ints = [str(int(v)) for v in rng.integers(-10**12, 10**12, 1000)]
    small = [str(int(v)) for v in rng.integers(-10**6, 10**6, 1000)]
    floats = ["%.2f" % v for v in rng.normal(0, 1000, 1000)]
    words = ['"w%d"' % v for v in rng.integers(0, 10**6, 1000)]
    typed = [ints, small, floats, ["true", "false"] * 25, words, words]
    # the other pairs' values are at most 6 bytes: 70 pairs stay under
    # 1,000 bytes
    mixed = ([str(int(v)) for v in rng.integers(-9999, 10000, 300)]
             + ["%.1f" % v for v in rng.uniform(0, 99, 300)]
             + ['"w%d"' % v for v in rng.integers(0, 1000, 300)]
             + ["true", "false", "null"] * 30)
    n = torch.randint(4, 41, (rows,), generator=g, device=device)
    wide = torch.randint(0, 256, (rows,), generator=g, device=device) == 0
    n = torch.where(wide, torch.randint(65, 71, (rows,), generator=g,
                                        device=device), n)
    parts = [const("{", rows, device)]
    for j in range(70):
        keep = n > j
        vocab = typed[j] + ["null"] if j < len(typed) else mixed
        parts += [masked(const(('"' if j == 0 else ',"') + f'f{j}":', rows,
                               device), keep),
                  masked(pick(vocab, g, rows, device), keep)]
    parts.append(const("}", rows, device))
    valid = (torch.rand(rows, generator=g, device=device)
             >= JSON_NULL_SHARE).to(torch.uint8)
    return concat_rows(parts, valid)


JSON_STRUCT_FIELDS = [("f0", dtypes.INT64), ("f1", dtypes.INT32),
                      ("f2", dtypes.FLOAT64), ("f3", dtypes.BOOL8),
                      ("f4", dtypes.STRING), ("f5", dtypes.STRING)]
JSON_NESTED_SCHEMA = ("struct", [
    ("user", ("struct", [("id", dtypes.INT64), ("name", dtypes.STRING),
                         ("tags", ("list", dtypes.STRING))])),
    ("items", ("list", ("struct", [("sku", dtypes.STRING),
                                   ("qty", dtypes.INT32),
                                   ("price", dtypes.FLOAT64)])))])


@contextlib.contextmanager
def json_route_log():
    """Record the engine the JSON router picks, and the verdict and
    seconds of its calibration when it calibrates."""
    log = {"engine": None, "verdict": None, "calibration_s": 0.0}
    real_route, real_pick = JP.route_json_engine, CAL.pick_path

    def route(*a, **k):
        log["engine"] = real_route(*a, **k)
        return log["engine"]

    def pick_path(*a, **k):
        t0 = time.perf_counter()
        log["verdict"] = real_pick(*a, **k)
        log["calibration_s"] += time.perf_counter() - t0
        return log["verdict"]

    JP.route_json_engine, CAL.pick_path = route, pick_path
    try:
        yield log
    finally:
        JP.route_json_engine, CAL.pick_path = real_route, real_pick


def json_host_rows(engine, rows):
    """Rows the last call of `engine` sent to the host parser."""
    return {"host": rows, "device_scan": JD.last_stats["fallback_rows"],
            "tokenizer": JT.last_stats["fallback_rows"]}[engine]


def json_pinned(engine):
    return env(SPARK_RAPIDS_TPU_PATH_JSON_GET_OBJECT=engine)


def json_engines_agree(col, device, paths=JSON_PATHS):
    """Each get_json_object engine pinned over `paths` (the tokenizer
    leaves the wildcard path out; the host engine and the tokenizer
    through the multi-path entry, which parses or tokenizes once, the
    device scan path by path): on `col`'s device and on a CPU copy, byte
    for byte, with as many rows sent to the host; and the engines
    byte-equal to each other.  Returns ({engine: rows its card calls
    sent to the host parser, per path for the device scan}, {path: the
    host engine's column})."""
    cpu = on_cpu(col)
    host_rows, outs = {}, {}

    def run(c, engine, todo):
        if engine != "device_scan":
            out = JP.get_json_object_multiple_paths(c, todo)
            return out, json_host_rows(engine, c.length)
        out, rows = [], {}
        for p in todo:
            out.append(JP.get_json_object(c, p))
            rows[p] = JD.last_stats["fallback_rows"]
        return out, rows

    for engine in JSON_ENGINES:
        todo = [p for p in paths if engine != "tokenizer" or "*" not in p]
        mode = {"host": "host", "device_scan": "device"}.get(engine)
        with json_pinned(engine), env(SPARK_RAPIDS_TPU_JSON=mode):
            got, flagged = run(col, engine, todo)
            want, cpu_flagged = run(cpu, engine, todo)
        check(cpu_flagged == flagged,
              f"json {engine}: as many host rows on {device} as on the "
              f"CPU ({flagged}, {cpu_flagged})")
        for p, a, b in zip(todo, got, want):
            check(a.device == col.device, f"json {engine} {p}: device")
            same_nested(a, b, f"json {engine} {p}: {device} == CPU")
        host_rows[engine] = flagged
        outs[engine] = dict(zip(todo, got))
    for engine in ("device_scan", "tokenizer"):
        for p, out in outs[engine].items():
            same_nested(out, outs["host"][p],
                        f"json {engine} {p} == host engine")
    return host_rows, outs["host"]


def json_from_engines(fn, op, col, engines, what):
    """`fn` over `col` with each engine pinned by
    SPARK_RAPIDS_TPU_PATH_JSON_<op>: every result on col's device and
    byte-equal to the host engine's."""
    outs = {}
    for engine in engines:
        with env(**{f"SPARK_RAPIDS_TPU_PATH_JSON_{op}": engine}):
            outs[engine] = fn(col)
        check(json_on_device(outs[engine], col.device),
              f"json {what} {engine}: on the input's device")
        same_nested(outs[engine], outs[engines[0]],
                    f"json {what} {engine} == {engines[0]}")
    return outs[engines[0]]


def json_phase(device="cuda", rows=JSON_ROWS, chunk_rows=JSON_CHUNK_ROWS,
               cpu_rows=JSON_CPU_ROWS, small_rows=JSON_SMALL_ROWS,
               map_rows=JSON_MAP_ROWS, iters=STR_ITERS):
    """get_json_object, from_json and the map ops on the card (see the
    module docstring)."""
    chunk_rows, small_rows = min(chunk_rows, rows), min(small_rows, rows)
    col, edge = event_docs(rows, seed=41, device=device)
    lens = col.string_lengths()
    mb = chars_mb(col)
    res = {"rows": rows, "chars_mb": mb, "min_len": int(lens.min()),
           "max_len": int(lens.max()),
           "mean_len": float(lens.to(torch.float64).mean()),
           "edge_rows": int(edge.sum()),
           "null_rows": int((~col.valid_mask()).sum()),
           "chunk_steps": [int(lens[r0:r0 + JD.DEVICE_ROW_CHUNK].max()) + 1
                           for r0 in range(0, rows, JD.DEVICE_ROW_CHUNK)]}
    check(res["max_len"] <= 1000, "json docs: at most 1,000 bytes")
    calib = os.path.join(_BUILD, "json_calib.json")
    if os.path.exists(calib):
        os.unlink(calib)
    CAL.forget()
    # every engine on the card against the CPU, on the first cpu_rows
    res["cpu_check_host_rows"], host_out = json_engines_agree(
        CP.slice_column(col, 0, cpu_rows), device)
    chunk = CP.slice_column(col, 0, chunk_rows)
    small = CP.slice_column(col, 0, small_rows)
    gjo = {}
    with env(SPARK_RAPIDS_TPU_CALIB_CACHE=calib):
        for path in JSON_PATHS:
            c = small if path in JSON_HOST_BOUND else col
            with json_route_log() as log:
                out, t = timed_call(lambda: JP.get_json_object(c, path),
                                    device, iters)
            check(out.device == c.device and out.length == c.length,
                  f"json {path}: rows on the input's device")
            t.update(log, rows=c.length, chars_mb=chars_mb(c),
                     host_rows=json_host_rows(log["engine"], c.length))
            t["mb_per_s"] = t["chars_mb"] / t["ms"] * 1e3
            gjo[path] = t
            same_nested(CP.slice_column(out, 0, cpu_rows), host_out[path],
                        f"json {path}: first {cpu_rows} rows == the host "
                        f"engine")
        res["get_json_object"] = gjo
        with json_route_log() as log:
            outs, t = timed_call(
                lambda: JP.get_json_object_multiple_paths(small, JSON_PATHS),
                device, 1)
        for path, out in zip(JSON_PATHS, outs):
            check(out.device == col.device, "json multi-path: device")
            same_nested(CP.slice_column(out, 0, cpu_rows), host_out[path],
                        f"json multi-path {path} == the host engine")
        res["multiple_paths"] = dict(
            t, engine=log["engine"], rows=small_rows,
            mb_per_s=chars_mb(small) / t["ms"] * 1e3)
        del outs, out
    # each engine pinned, on one chunk (the host engine on cpu_rows)
    pinned = {}
    for engine in JSON_ENGINES:
        part = CP.slice_column(col, 0, cpu_rows) if engine == "host" \
            else chunk
        with json_pinned(engine):
            _, t = timed_call(lambda: JP.get_json_object(part, "$.user.id"),
                              device, iters)
        t.update(rows=part.length, chars_mb=chars_mb(part),
                 host_rows=json_host_rows(engine, part.length))
        t["mb_per_s"] = t["chars_mb"] / t["ms"] * 1e3
        if engine == "device_scan":
            t["chunk_steps"] = JD.last_stats["chunk_steps"]
        pinned[engine] = t
    res["pinned_user_id"] = pinned
    del col, chunk, small, host_out

    # from_json: the raw map and flat structs over flat objects of 4-70
    # pairs, nested structs over events
    docs = raw_map_docs(rows, seed=43, device=device)
    dmb = chars_mb(docs)
    fj = {"rows": rows, "chars_mb": dmb,
          "max_len": docs.max_string_length()}
    check(fj["max_len"] <= 1000, "json flat objects: at most 1,000 bytes")
    part = CP.slice_column(docs, 0, cpu_rows)
    calls = (("raw_map", "RAW_MAP", JU.from_json_to_raw_map),
             ("structs_flat", "FROM_JSON",
              lambda c: JU.from_json_to_structs(c, JSON_STRUCT_FIELDS)))
    with env(SPARK_RAPIDS_TPU_CALIB_CACHE=calib):
        for name, op, fn in calls:
            with json_route_log() as log:
                out, t = timed_call(lambda: fn(docs), device, iters)
            check(out.length == rows and json_on_device(out, docs.device),
                  f"json {name}: on the input's device")
            t.update(log, mb_per_s=dmb / t["ms"] * 1e3)
            if log["engine"] == "tokenizer":
                t["host_rows"] = JT.last_stats["fallback_rows"]
            elif log["engine"] == "device_scan" and name == "raw_map":
                t["host_rows"] = RM.last_stats["fallback_rows"]
            fj[name] = t
            host = json_from_engines(fn, op, part, JSON_ENGINES,
                                     name)
            same_nested(CP.slice_column(out, 0, cpu_rows), host,
                        f"json {name}: first {cpu_rows} rows == host engine")
            with env(**{f"SPARK_RAPIDS_TPU_PATH_JSON_{op}": "tokenizer"}):
                card_and_cpu(fn, [part], f"json {name} tokenizer")
        events, _ = event_docs(cpu_rows // 2, seed=47, device=device)
        nested = lambda c: JU.from_json_to_structs_nested(  # noqa: E731
            c, JSON_NESTED_SCHEMA)
        with json_route_log() as log:
            out, t = timed_call(lambda: nested(events), device, 1)
        t.update(log, rows=events.length, chars_mb=chars_mb(events))
        fj["structs_nested"] = t
        same_nested(out, json_from_engines(nested, "FROM_JSON", events,
                                           ("host", "device_scan"),
                                           "structs_nested"),
                    "json structs_nested: router == host engine")
        with env(SPARK_RAPIDS_TPU_PATH_JSON_FROM_JSON="host"):
            card_and_cpu(nested, [events], "json structs_nested host")
    res["from_json"] = fj
    # the map ops over the raw map's first map_rows rows
    m = JU.from_json_to_raw_map(CP.slice_column(docs, 0, map_rows))
    maps = {"rows": map_rows, "entries": m.children[0].length}
    for name, fn in (("sort_map_column", MU.sort_map_column),
                     ("map_from_entries", MU.map_from_entries)):
        got, t = timed_call(lambda: fn(m), device, 1)
        check(json_on_device(got, m.offsets.device), f"{name}: device")
        same_nested(got, fn(on_cpu(m)), f"json {name}: card == CPU")
        maps[name] = t
    res["map_ops"] = maps
    return res


def json_on_device(col, device):
    """Every buffer of `col`, at every level, on `device`."""
    return all(t is None or t.device == device
               for t in (col.data, col.validity, col.offsets)) and all(
        json_on_device(c, device) for c in col.children)


def run_json(device="cuda", **kw):
    """The JSON family on the card (see the module docstring)."""
    check(kw.get("small_rows", JSON_SMALL_ROWS)
          >= JP.JSON_CALIBRATE_MIN_ROWS,
          "json: the host-bound calls calibrate their route")
    RA.reset_launches()
    clock = time.perf_counter()
    res = json_phase(device, **kw)
    res["phase_s"] = time.perf_counter() - clock
    print(json.dumps({"json": res}), flush=True)
    launches = read_launches("json")
    check(not any(launches.values()),
          "the json path launches none of the row kernels")
    return launches, res

# ------------------------------------------------------------- ingest (14)

# one executor's share of 8 of TPC-DS SF100, as the operator phases: the
# 2^25-row store_sales batch and the 2^22-row STRING keys, written with
# pyarrow's default encodings (dictionary pages, v1, 2^20-row groups),
# the batch once uncompressed and once snappy, and a 2^21-row cut of
# both once PLAIN v1 and once PLAIN v2
INGEST_ROW_GROUP = 1 << 20
INGEST_ROWS = 1 << 22      # the batch's rows (2^25, OPS_ROWS, before
                           # steps 16 and 17 needed the script's time,
                           # 2^23 before step 23)
INGEST_CUT_ROWS = 1 << 21  # 2^22 before steps 16 and 17
INGEST_PROJECTED = ("ss_item_sk", "ss_net_paid")   # 2 of the 5 columns
INGEST_SEED = 14
# the file-backed queries: q3 and q9 as run_catalog_stages runs their
# in-memory twins, q7 over SF100's 204,000 items, at 2^22 rows (2^25
# before steps 16 and 17 needed the script's time: each query writes
# and reads its files on the host)
FILE_QUERIES = {
    "tpcds_q3_file": dict(rows=1 << 22, items=204_000, brands=1_000,
                          seed=3),
    "tpcds_q7_file": dict(rows=1 << 22, items=204_000, seed=7),
    "tpcds_q9_file": dict(rows=1 << 22, seed=9),
}
# a DATE and a TIMESTAMP[us] column of years 1500-2100 (Julian dates and
# pre-1970 instants), 4% null; the CPU run covers the first DT_CPU_ROWS
DT_ROWS = 1 << 23          # 2^24 before step 19 needed the time
DT_CPU_ROWS = 1 << 22
DT_NULL_SHARE = 0.04
DT_US_RANGE = (-14831769600 * 10**6, 4102444800 * 10**6)   # 1500, 2100
DT_ZONES = ("America/Los_Angeles", "Asia/Shanghai")
DT_COMPONENTS = ("YEAR", "QUARTER", "MONTH", "WEEK", "DAY", "HOUR",
                 "MINUTE", "SECOND", "MILLISECOND", "MICROSECOND")
DT_ITERS = 3


def ingest_dir():
    return os.path.join(_BUILD, "ingest")


def arrow_table(table):
    """A pyarrow Table over a host copy of `table`: validity as the null
    mask, a STRING column from its offsets and chars."""
    import pyarrow as pa
    arrays = []
    for c in table.columns:
        valid = None if c.validity is None else c.validity.cpu().numpy()
        if c.dtype.is_string:
            check(valid is None and int(c.offsets[0]) == 0,
                  "string columns here are unsliced and null-free")
            arrays.append(pa.Array.from_buffers(
                pa.string(), c.length,
                [None, pa.py_buffer(c.offsets.cpu().numpy()),
                 pa.py_buffer(c.data.cpu().numpy())]))
        else:
            arrays.append(pa.array(c.data.cpu().numpy(), mask=None
                                   if valid is None else valid == 0))
    return pa.table(arrays, names=table.names)


def same_as_source(got, want, what):
    """A column read back == the column it was written from: kind, rows
    and validity, and the bytes of every valid row (a null row's value
    is not stored; the reader zeroes it, the Arrow door keeps it)."""
    check(got.dtype.kind == want.dtype.kind and got.length == want.length,
          f"{what}: type")
    want_valid = want.valid_mask().to(got.device)
    check(torch.equal(got.valid_mask(), want_valid), f"{what}: validity")
    if want.dtype.is_string:
        check(torch.equal(got.offsets, want.offsets.to(got.device))
              and torch.equal(got.data, want.data.to(got.device)),
              f"{what}: offsets and chars")
        return
    check(byte_err(got.data[want_valid],
                   want.data.to(got.device)[want_valid]) == 0,
          f"{what}: valid rows' bytes")


def timed_read(path, device, columns=None):
    """(table, numbers) of one read_table onto `device`."""
    sync(device)
    stats = {}
    t0 = time.perf_counter()
    table, peak = peak_added(
        lambda: PR.read_table(path, columns=columns, device=device,
                              stats=stats), device)
    sync(device)
    ms = (time.perf_counter() - t0) * 1e3
    mb = os.path.getsize(path) / 2**20
    return table, {"ms": ms, "file_mb": mb, "file_mb_per_s": mb / ms * 1e3,
                   "read_mb": stats["read_bytes"] / 2**20,
                   "decode_ms": stats["decode_ns"] / 1e6,
                   "decompress_ms": stats["decompress_ns"] / 1e6,
                   "upload_ms": stats["upload_ns"] / 1e6,
                   "pages": stats["pages"], "peak_mib": peak}


def ingest_files(device="cuda", rows=INGEST_ROWS, str_rows=STR_OPS_ROWS,
                 cut_rows=INGEST_CUT_ROWS, row_group=INGEST_ROW_GROUP):
    """The operator batch and the STRING keys to parquet and back (see
    the module docstring).  Returns (numbers, the batch, its arrow
    table, the cut and the PLAIN v1 cut's path)."""
    import pyarrow.parquet as pq
    batch = store_sales_batch(rows, INGEST_SEED, device)
    keys = string_key_column(str_rows, STR_DISTINCT, 8, 50, INGEST_SEED,
                             device)
    cut = Table([CP.slice_column(c, 0, cut_rows) for c in batch.columns]
                + [CP.slice_column(keys, 0, cut_rows)],
                batch.names + ["ss_brand"])
    arrow = arrow_table(batch)
    # name: (arrow data, its source, writer options, read projected)
    files = {"store_sales_dict": (arrow, batch, {}, True),
             "store_sales_snappy": (arrow, batch,
                                    {"compression": "snappy"}, False),
             "brand_dict": (arrow_table(Table([keys], ["ss_brand"])),
                            Table([keys], ["ss_brand"]), {}, False),
             "cut_plain_v1": (arrow_table(cut), cut,
                              {"use_dictionary": False}, True),
             "cut_plain_v2": (arrow_table(cut), cut,
                              {"use_dictionary": False,
                               "data_page_version": "2.0"}, True)}
    res = {}
    for name, (data, source, kw, project) in files.items():
        path = os.path.join(ingest_dir(), name + ".parquet")
        t0 = time.perf_counter()
        pq.write_table(data, path, row_group_size=row_group,
                       **{"compression": "NONE", **kw})
        out = {"rows": source.num_rows, "columns": source.num_columns,
               "write_ms": (time.perf_counter() - t0) * 1e3}
        got, out["whole"] = timed_read(path, device)
        for gc_, want, n in zip(got.columns, source.columns, source.names):
            same_as_source(gc_, want, f"{name} {n} read on {device}")
        cpu, out["whole_cpu"] = timed_read(path, "cpu")
        for a, b, n in zip(got.columns, cpu.columns, source.names):
            same_column(a, b, f"{name} {n}: {device} read == CPU read")
        del got, cpu
        compressed = out["whole"]["decompress_ms"] > 0
        check(compressed == ("compression" in kw),
              f"{name}: decompression ran only on the snappy file")
        if project:
            cols = list(INGEST_PROJECTED)
            got, out["projected"] = timed_read(path, device, cols)
            check(got.names == cols, f"{name}: projected names")
            for n in cols:
                same_as_source(got[n], source[n], f"{name} {n} projected")
            check(out["projected"]["read_mb"] < out["whole"]["read_mb"],
                  f"{name}: the projected read fetched fewer bytes")
            del got
        res[name] = out
    return res, batch, arrow, cut, os.path.join(ingest_dir(),
                                                "cut_plain_v1.parquet")


def ingest_jni(path, cut, batch, arrow, device="cuda"):
    """The JNI door's ingest entries on the card: parquet_read_table of
    the PLAIN v1 cut and arrow_ingest of a RecordBatch of the batch,
    each column against its source, every handle released."""
    before = REGISTRY.live_count()
    res = {}
    record_batch = arrow.combine_chunks().to_batches()[0]
    for name, source, call in (
            ("parquet_read_table", cut,
             lambda: jni_api.parquet_read_table(path, device=device)),
            ("arrow_ingest", batch,
             lambda: jni_api.arrow_ingest(record_batch, device=device))):
        t0 = time.perf_counter()
        handles = call()
        sync(device)
        res[name] = {"ms": (time.perf_counter() - t0) * 1e3,
                     "handles": len(handles)}
        check(len(handles) == source.num_columns,
              f"{name}: one handle a column")
        for h, want, n in zip(handles, source.columns, source.names):
            got = REGISTRY.get(h)
            check(got.device.type == torch.device(device).type,
                  f"{name} {n} on {device}")
            same_as_source(got, want, f"{name} {n}")
        release_all(*handles)
    check(REGISTRY.live_count() == before, "ingest handles released")
    return res


def file_queries(device="cuda", queries=None):
    """The file-backed TPC-DS queries on `device`, each call writing its
    files and reading them back, equal to the in-memory twin with the
    same params."""
    res = {}
    with env(SPARK_RAPIDS_TPU_INGEST_DIR=ingest_dir(),
             SPARK_RAPIDS_TPU_STAGE_FUSION="0"):
        FS.reset_dir()
        try:
            for name, params in (queries or FILE_QUERIES).items():
                params = dict(params, device=device)
                t0 = time.perf_counter()
                got = TM.run_catalog_query(name, params)
                sync(device)
                t1 = time.perf_counter()
                want = TM.run_catalog_query(name[:-len("_file")], params)
                sync(device)
                check(got == want,
                      f"{name} == {name[:-len('_file')]} on {device}")
                res[name] = {"rows": params.get("rows"),
                             "result_rows": len(want),
                             "write_read_run_ms": (t1 - t0) * 1e3,
                             "in_memory_ms":
                                 (time.perf_counter() - t1) * 1e3}
        finally:
            FS.reset_dir()
    return res


def datetime_file(rows, seed):
    """A DATE and a TIMESTAMP[us] column of years 1500-2100, 4% null
    each, written to parquet; returns its path."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    rng = np.random.default_rng(seed)
    days = np.floor_divide(rng.integers(*DT_US_RANGE, rows),
                           86_400_000_000).astype(np.int32)
    micros = rng.integers(*DT_US_RANGE, rows)
    table = pa.table({
        "d": pa.array(days, pa.date32(),
                      mask=rng.random(rows) < DT_NULL_SHARE),
        "ts": pa.array(micros, pa.timestamp("us"),
                       mask=rng.random(rows) < DT_NULL_SHARE)})
    path = os.path.join(ingest_dir(), "datetime.parquet")
    pq.write_table(table, path, compression="NONE")
    return path


def head(col, n):
    """The first `n` rows of a column on the CPU (string chars whole)."""
    col = on_cpu(col)
    return Column(col.dtype, n,
                  data=col.data if col.dtype.is_string else col.data[:n],
                  validity=None if col.validity is None
                  else col.validity[:n],
                  offsets=None if col.offsets is None
                  else col.offsets[:n + 1])


def component_column(rows, seed, device):
    """Per-row truncate components: the DT_COMPONENTS, lower-case
    spellings, an unknown one and an empty one, 4% null."""
    vocab = list(DT_COMPONENTS) + ["yyyy", "mon", "dd", "bogus", ""]
    g = torch.Generator(device=device).manual_seed(seed)
    pool = Column.from_strings(vocab, device)
    col = CP.gather(pool, torch.randint(0, len(vocab), (rows,),
                                        generator=g, device=device))
    valid = (torch.rand(rows, generator=g, device=device)
             >= DT_NULL_SHARE).to(torch.uint8)
    return Column(dtypes.STRING, rows, data=col.data, validity=valid,
                  offsets=col.offsets)


def datetime_calls(d, ts, comp):
    """(name, call) of every datetime op the phase drives."""
    calls = [("rebase_g2j_date", lambda: DT.rebase_gregorian_to_julian(d)),
             ("rebase_j2g_date", lambda: DT.rebase_julian_to_gregorian(d)),
             ("rebase_g2j_ts", lambda: DT.rebase_gregorian_to_julian(ts)),
             ("rebase_j2g_ts", lambda: DT.rebase_julian_to_gregorian(ts))]
    for z in DT_ZONES:
        calls += [(f"to_utc {z}",
                   lambda z=z: DT.convert_timestamp_to_utc(ts, z)),
                  (f"from_utc {z}",
                   lambda z=z: DT.convert_utc_timestamp_to_timezone(ts, z))]
    calls.append(("orc Asia/Tokyo->UTC",
                  lambda: OTZ.convert_orc_timezones(ts, "Asia/Tokyo",
                                                    "UTC")))
    calls += [(f"truncate_ts {c}", lambda c=c: DT.truncate(ts, c))
              for c in DT_COMPONENTS]
    calls += [(f"truncate_date {c}", lambda c=c: DT.truncate(d, c))
              for c in DT_COMPONENTS[:5]]
    calls.append(("truncate_ts column", lambda: DT.truncate(ts, comp)))
    return calls


def datetime_phase(device="cuda", rows=DT_ROWS, cpu_rows=DT_CPU_ROWS,
                   iters=DT_ITERS):
    """The datetime ops on columns read from parquet onto `device`, each
    held byte for byte to the same call on the CPU over the first
    `cpu_rows` rows."""
    path = datetime_file(rows, INGEST_SEED)
    t = PR.read_table(path, device=device)
    d, ts = t["d"], t["ts"]
    check(d.dtype == dtypes.TIMESTAMP_DAYS
          and ts.dtype == dtypes.TIMESTAMP_MICROS, "DATE and TIMESTAMP kinds")
    check(bool((ts.data[ts.valid_mask()] < 0).any()), "pre-1970 instants")
    comp = component_column(rows, INGEST_SEED, device)
    cpu_calls = dict(datetime_calls(head(d, cpu_rows), head(ts, cpu_rows),
                                    head(comp, cpu_rows)))
    res = {"rows": rows, "cpu_rows": cpu_rows}
    for name, call in datetime_calls(d, ts, comp):
        out = call()
        check(out.device.type == torch.device(device).type,
              f"{name} stays on {device}")
        same_column(head(out, cpu_rows), cpu_calls[name](),
                    f"{name}: {device} == CPU")
        ms = wall_ms(call, iters, device)
        res[name] = {"ms": ms, "rows_per_s": rows / ms * 1e3}
    return res


def ingest_phase(device="cuda", files_kw=None, queries=None, dt_kw=None):
    import importlib.util
    check(importlib.util.find_spec("pyarrow") is not None,
          "pyarrow present: the files are written with it")
    shutil.rmtree(ingest_dir(), ignore_errors=True)
    os.makedirs(ingest_dir())
    res = {}
    clock = time.perf_counter()
    try:
        res["files"], batch, arrow, cut, path = ingest_files(
            device, **(files_kw or {}))
        res["files"]["phase_s"] = time.perf_counter() - clock
        clock = time.perf_counter()
        res["jni_door"] = ingest_jni(path, cut, batch, arrow, device)
        del batch, arrow, cut
        res["queries"] = file_queries(device, queries)
        res["queries"]["phase_s"] = time.perf_counter() - clock
        clock = time.perf_counter()
        res["datetime"] = datetime_phase(device, **(dt_kw or {}))
        res["datetime"]["phase_s"] = time.perf_counter() - clock
    finally:
        shutil.rmtree(ingest_dir(), ignore_errors=True)
    return res


def run_ingest(device="cuda", **kw):
    """Ingest and the read-side datetime ops on the card (see the
    module docstring)."""
    RA.reset_launches()
    clock = time.perf_counter()
    res = ingest_phase(device, **kw)
    res["phase_s"] = time.perf_counter() - clock
    print(json.dumps({"ingest": res}), flush=True)
    launches = read_launches("ingest")
    check(not any(launches.values()),
          "the ingest path launches none of the row kernels")
    return launches, res


# ------------------------------------------------------------------ ops (15)

# the rest of the op breadth at one executor's share of 8 of TPC-DS
# SF100, drawn on the card from a seed: two DECIMAL128 columns of 2^24
# rows (512 MiB; 2^25, spark.rapids.sql.batchSizeBytes, until step 19
# needed the time), a of sums at scale -2
# of magnitude up to about 10^20, b of prices at scale -2 from
# ss_net_paid, each 4% null, a seeded 1/64 of the rows edge rows; the
# operator batch (2^25 rows), the 2^22 STRING keys, the 2^20 URLs and a
# 2^24-row TIMESTAMP like the ingest phase's for the rest
OPS_ROWS_DEC = 1 << 24
OPS_EDGE_EVERY = 64
OPS_CPU_ROWS = 1 << 16         # decimals, casts and SHA held to the CPU
OPS_WIDE_CPU_ROWS = 1 << 20    # sketches, z-order, Iceberg, CASE WHEN
OPS_BIN_ROWS = 1 << 24
OPS_HOST_ROWS = 1 << 16        # the host-loop casts
OPS_TS_ROWS = 1 << 24
OPS_UUID_ROWS = 1 << 22
OPS_ITERS = 3
OPS_SEED = 15
BLOOM_FPP = 0.03
HLL_PRECISION = 9              # Spark's default relativeSD of 0.05
HLL_PARTIALS = 8
HLL_MAX_ERR = 0.1              # tests/test_sketches.py's bound at p = 9
HILBERT_BITS = 18
ICEBERG_BUCKETS = 16
ICEBERG_WIDTH = 10
HIST_PERCENTILES = (0.25, 0.5, 0.75, 0.99)
SUBSTRING_CALLS = (("/", 3), (".", -2), ("://", -1))
FORCE_DEC = "SPARK_RAPIDS_TPU_FORCE_DEVICE_DECIMAL"
ROUTE_LIMBS, ROUTE_HOST, ROUTE_TORCH = "device limbs", "host loop", \
    "plain torch"


def bloom_num_bits(n, fpp):
    """Spark's BloomFilter.optimalNumOfBits."""
    return int(-n * math.log(fpp) / (math.log(2) * math.log(2)))


def bloom_num_hashes(n, num_bits):
    """Spark's BloomFilter.optimalNumOfHashFunctions (Java Math.round)."""
    return max(1, math.floor(num_bits / n * math.log(2) + 0.5))


KERNEL_LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                      "cuLaunchKernel", "cuLaunchKernelEx")


def device_kernels(fn, device):
    """(the CUDA kernels one call of `fn` launches, the kernels
    torch.profiler recorded on the device for it), or (None, None) off
    the card.  Launches are the launch calls the profiler records on the
    host (copies and memsets are other calls); the device's records
    carry the device's clock, and the two counts are printed side by
    side because they have been seen to differ after minutes of load."""
    if torch.device(device).type != "cuda":
        return None, None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    return (sum(1 for e in events if e.name in KERNEL_LAUNCH_APIS),
            sum(1 for e in events if e.device_type == DeviceType.CUDA
                and not e.name.startswith(("Memcpy", "Memset"))))


def ops_call(res, name, fn, device, rows, route, iters=OPS_ITERS):
    """fn's first result; res[name] gets its median ms of `iters`
    synchronized calls, rows/s, route, the peak MiB its first call added
    and the kernels a call.  The result must be on `device`."""
    out, t = timed_call(fn, device, iters)
    first = out[0] if isinstance(out, tuple) else out
    first = first.words if isinstance(first, BF.BloomFilter) else first
    check(first.device.type == torch.device(device).type,
          f"{name}: result on {device}")
    kernels, recorded = device_kernels(fn, device)
    t.update(rows=rows, rows_per_s=rows / t["ms"] * 1e3, route=route,
             kernels=kernels, kernels_recorded=recorded)
    check(t["kernels"] is None or route == ROUTE_HOST or t["kernels"] > 0,
          f"{name}: the profiler saw its kernels")
    res[name] = t
    return out


def vs_cpu(fn, cols, n, got, what):
    """fn over the first n rows of `cols` copied to the CPU, equal byte
    for byte to the first n rows of the card's result `got`."""
    want = fn(*[on_cpu(CP.slice_column(c, 0, n)) for c in cols])
    same_nested(CP.slice_column(got, 0, n), want, f"{what}: card == CPU")


def dec_limbs(lo, hi):
    """(rows, 4) int32 limbs of hi * 2^64 + (lo as unsigned)."""
    return torch.stack([lo, hi], dim=1).view(torch.int32)


def decimal_columns(net, rows, seed, device, edge_every=OPS_EDGE_EVERY):
    """(a, b), DECIMAL128 at scale -2: a sums of magnitude below
    5 * 2^64 (about 9.2e19), b ss_net_paid in cents (its nulls), each
    4% null; a seeded 1/edge_every of the rows are edges, a quarter
    each: b = 0, a = 10^38 - 1, a = -(10^38 - 1), and a = 10^30 with
    b = 10^12 (a product that overflows at every scale)."""
    g = torch.Generator(device=device).manual_seed(seed)

    def ints(lo, hi):
        return torch.randint(lo, hi, (rows,), generator=g,
                             dtype=torch.int64, device=device)

    lo, hi = ints(-2**63, 2**63 - 1), ints(-5, 5)
    cents = torch.round(net.data[:rows] * 100).to(torch.int64)
    kind = ints(0, 4 * edge_every)

    def put(x_lo, x_hi, k, v):
        return (torch.where(kind == k, signed64(v), x_lo),
                torch.where(kind == k, v >> 64, x_hi))

    for k, v in ((1, 10**38 - 1), (2, -(10**38 - 1)), (3, 10**30)):
        lo, hi = put(lo, hi, k, v)
    b_lo, b_hi = put(cents, torch.zeros_like(cents), 0, 0)
    b_lo, b_hi = put(b_lo, b_hi, 3, 10**12)
    a_valid = (torch.rand(rows, generator=g, device=device)
               >= OPS_NULL_SHARE).to(torch.uint8)
    return (Column(dtypes.decimal128(-2), rows, data=dec_limbs(lo, hi),
                   validity=a_valid),
            Column(dtypes.decimal128(-2), rows, data=dec_limbs(b_lo, b_hi),
                   validity=net.validity[:rows]))


def signed64(v):
    """The int64 with the bits of v's low 64 bits."""
    u = v & ((1 << 64) - 1)
    return u - (1 << 64) if u >= 1 << 63 else u


def same_decimal(got, fn, cols, n, what):
    """A decimal op's card result (overflow, value) against the same op
    on the CPU over the first n rows: byte for byte against the CPU's
    limbs, and the overflow flags and every non-overflow value equal to
    the host big-int loop's."""
    cpu = [on_cpu(CP.slice_column(c, 0, n)) for c in cols]
    card = [CP.slice_column(x, 0, n) for x in got]
    with env(**{FORCE_DEC: "1"}):
        limbs = fn(*cpu)
    with env(**{FORCE_DEC: "0"}):
        host = fn(*cpu)
    for x, y, part in zip(card, limbs, ("overflow", "value")):
        same_nested(x, y, f"{what} {part}: card == CPU limbs")
    check(torch.equal(card[0].valid_mask().cpu(), host[0].valid_mask()),
          f"{what}: validity == host loop")
    keep = card[0].valid_mask().cpu()
    ovf = card[0].data.cpu() != 0
    check(torch.equal(ovf[keep], host[0].data[keep] != 0),
          f"{what}: overflow flags == host loop")
    fine = keep & ~ovf
    check(torch.equal(card[1].data.cpu()[fine], host[1].data[fine]),
          f"{what}: every non-overflow value == host loop")
    return int(ovf[keep].sum())


def decimal_calls(res, device, net, rows, cpu_rows, seed, iters):
    a, b = decimal_columns(net, rows, seed, device)
    zero = Column(dtypes.decimal128(-2), rows,
                  data=torch.zeros((rows, 4), dtype=torch.int32,
                                   device=device))
    # the router sends card columns to the limbs; a CPU rehearsal forces
    # them there
    limbs = None if torch.device(device).type == "cuda" else "1"
    with env(**{FORCE_DEC: limbs}):
        a4 = DU.add_decimal128(a, zero, -4)[1]      # q49's operands,
        b4 = DU.add_decimal128(b, zero, -4)[1]      # cast to scale -4
        calls = [
            ("dec_multiply", DU.multiply_decimal128, (a, b), -4),
            ("dec_add", DU.add_decimal128, (a, b), -2),
            ("dec_sub", DU.sub_decimal128, (a, b), -2),
            ("dec_divide_q49", DU.divide_decimal128, (a4, b4), -20),
            ("dec_integer_divide", DU.integer_divide_decimal128, (a, b), 0),
            ("dec_remainder", DU.remainder_decimal128, (a, b), -2)]
        results = {}
        for name, fn, cols, scale in calls:
            out = ops_call(res, name, lambda: fn(*cols, scale), device,
                           rows, ROUTE_LIMBS, iters)
            res[name]["overflow_rows_checked"] = same_decimal(
                out, lambda *c: fn(*c, scale), cols, cpu_rows, name)
            results[name] = out
        # the JNI door: every binop through handles, each equal to the
        # direct call
        before = REGISTRY.live_count()
        for op, cols, scale, direct in (
                ("multiply", (a, b), -4, "dec_multiply"),
                ("add", (a, b), -2, "dec_add"),
                ("sub", (a, b), -2, "dec_sub"),
                ("divide", (a4, b4), -20, "dec_divide_q49")):
            hs = [REGISTRY.register(c) for c in cols]
            t0 = time.perf_counter()
            out = JE.decimal128_binop(op, hs[0], hs[1], scale)
            sync(device)
            res[f"jni_decimal128_binop_{op}"] = {
                "ms": (time.perf_counter() - t0) * 1e3, "rows": rows,
                "route": ROUTE_LIMBS}
            for h, want, part in zip(out, results[direct],
                                     ("overflow", "value")):
                same_nested(REGISTRY.get(h), want,
                            f"jni decimal128_binop {op} {part}")
            release_all(*hs, *out)
        check(REGISTRY.live_count() == before, "decimal handles released")


def int64_mult_columns(batch, g, rows):
    """ss_sales_price x ss_quantity as INT64, a seeded 1/64 of the
    quantities 2^62 (products that overflow)."""
    price = batch["ss_sales_price"]
    qty = batch["ss_quantity"]
    big = torch.randint(0, OPS_EDGE_EVERY, (rows,), generator=g,
                        device=price.device) == 0
    q64 = torch.where(big, 1 << 62, qty.data.to(torch.int64))
    return price, Column(dtypes.INT64, rows, data=q64, validity=qty.validity)


def arithmetic_calls(res, device, batch, g, cpu_rows, iters):
    rows = batch.num_rows
    lhs, rhs = int64_mult_columns(batch, g, rows)
    for mode, kw in (("regular", {}), ("try", {"is_try_mode": True})):
        name = f"multiply_int64_{mode}"
        out = ops_call(res, name, lambda kw=kw: AR.multiply(lhs, rhs, **kw),
                       device, rows, ROUTE_TORCH, iters)
        vs_cpu(lambda x, y, kw=kw: AR.multiply(x, y, **kw), (lhs, rhs),
               cpu_rows, out, name)

    def ansi(x, y):
        try:
            AR.multiply(x, y, is_ansi_mode=True)
        except ExceptionWithRowIndex as e:
            return e.row_index
        return None

    row = ansi(lhs, rhs)
    want = ansi(on_cpu(CP.slice_column(lhs, 0, cpu_rows)),
                on_cpu(CP.slice_column(rhs, 0, cpu_rows)))
    check(row is not None and row == want,
          f"ANSI multiply raised at row {row} on the card, {want} on the "
          f"CPU")
    res["multiply_int64_ansi"] = {
        "ms": wall_ms(lambda: ansi(lhs, rhs), iters, device), "rows": rows,
        "route": ROUTE_TORCH, "raised_at_row": row,
        "kernels": device_kernels(lambda: ansi(lhs, rhs), device)[0]}
    net = batch["ss_net_paid"]
    price = batch["ss_sales_price"]
    dec64 = Column(dtypes.DType("decimal64", -2), rows, data=price.data,
                   validity=price.validity)
    for name, col, places, method in (
            ("round_f64_half_up", net, 1, AR.HALF_UP),
            ("round_f64_half_even", net, 1, AR.HALF_EVEN),
            ("round_dec64_half_up", dec64, 0, AR.HALF_UP),
            ("round_dec64_half_even", dec64, 0, AR.HALF_EVEN)):
        out = ops_call(res, name, lambda col=col, p=places, m=method:
                       AR.round_column(col, p, m), device, rows,
                       ROUTE_TORCH, iters)
        vs_cpu(lambda c, p=places, m=method: AR.round_column(c, p, m),
               (col,), cpu_rows, out, name)


def date_strings(rows, seed, device):
    """`rows` date and timestamp strings of years 1500-2100 (a third with
    a time of day, a third with fractional seconds and a zone), 1/64 of
    them invalid, 4% null."""
    rng = np.random.default_rng(seed)
    days = rng.integers(-171_000, 47_000, rows)
    base = datetime.date(1970, 1, 1)
    out = []
    for k, d in enumerate(days.tolist()):
        s = (base + datetime.timedelta(days=d)).isoformat()
        if k % 3 == 1:
            s += " %02d:%02d:%02d" % (k % 24, k % 60, (k * 7) % 60)
        elif k % 3 == 2:
            s += "T%02d:%02d:%02d.%06d+%02d:00" % (
                k % 24, k % 60, (k * 3) % 60, k % 10**6, k % 14)
        if k % OPS_EDGE_EVERY == 5:
            s = ("2023-02-30", "bogus", "", "2023-13-01 10:00")[k % 4]
        out.append(None if rng.random() < OPS_NULL_SHARE else s)
    return Column.from_strings(out, device)


def cast_calls(res, device, batch, keys, host_rows, bin_rows, seed, iters):
    price = batch["ss_sales_price"]
    p24 = CP.slice_column(price, 0, bin_rows)
    out = ops_call(res, "long_to_binary_string", lambda:
                   CM.long_to_binary_string(p24), device, bin_rows,
                   ROUTE_TORCH, iters)
    vs_cpu(CM.long_to_binary_string, (p24,), host_rows, out,
           "long_to_binary_string")
    text = date_strings(host_rows, seed, device)
    p16 = CP.slice_column(price, 0, host_rows)
    net16 = CP.slice_column(batch["ss_net_paid"], 0, host_rows)
    dec16 = Column(dtypes.decimal128(-2), host_rows,
                   data=dec_limbs(p16.data, torch.zeros_like(p16.data)),
                   validity=p16.validity)
    k16 = CP.slice_column(keys, 0, host_rows)
    for name, fn, cols in (
            ("string_to_date", CM.parse_strings_to_date, (text,)),
            ("string_to_timestamp",
             lambda c: CM.parse_timestamp_strings(c, 3600), (text,)),
            ("format_number", lambda c: CM.format_number(c, 2), (net16,)),
            ("hex_int64", CM.long_to_hex_string, (p16,)),
            ("hex_string", CM.bytes_to_hex, (k16,)),
            ("decimal_to_string", CM.decimal_to_non_ansi_string,
             (dec16,))):
        out = ops_call(res, name, lambda fn=fn, cols=cols: fn(*cols),
                       device, host_rows, ROUTE_HOST, iters)
        vs_cpu(fn, cols, host_rows, out, name)
    check(int((~CM.parse_strings_to_date(text).valid_mask()).sum())
          > int((~text.valid_mask()).sum()), "invalid dates became null")


def hashlib_rows(col, bits, n):
    """hashlib's hex digests of the first n rows (None for nulls)."""
    valid = col.valid_mask()[:n].cpu().tolist()
    if col.dtype.is_string:
        rows = SB.host_row_bytes(col, torch.arange(n, device=col.device))
    else:
        host = col.data[:n].cpu().numpy()
        rows = [host[i].tobytes() for i in range(n)]
    return [hashlib.new(f"sha{bits}", r).hexdigest() if v else None
            for r, v in zip(rows, valid)]


def sha_calls(res, device, batch, keys, cpu_rows, iters):
    for what, col in (("strings", keys), ("int64",
                                          batch["ss_sales_price"])):
        for bits, fn in ((256, SHA.sha256_nulls_preserved),
                         (512, SHA.sha512_nulls_preserved)):
            name = f"sha{bits}_{what}"
            out = ops_call(res, name, lambda fn=fn, col=col: fn(col),
                           device, col.length, ROUTE_TORCH, iters)
            vs_cpu(fn, (col,), cpu_rows, out, name)
            got = CP.slice_column(out, 0, cpu_rows)
            check(got.to_pylist() == hashlib_rows(col, bits, cpu_rows),
                  f"{name}: == hashlib")


def bloom_calls(res, device, customers, probe_keys, cpu_rows, iters):
    n = customers.length
    num_bits = bloom_num_bits(n, BLOOM_FPP)
    k = bloom_num_hashes(n, num_bits)
    num_longs = (num_bits + 63) // 64
    res["bloom_sizing"] = {"keys": n, "fpp": BLOOM_FPP,
                           "num_bits": num_bits, "num_hashes": k,
                           "num_longs": num_longs}
    empty = BF.create(k, num_longs, 2, seed=0, device=device)
    bf = ops_call(res, "bloom_put", lambda: BF.put(empty, customers),
                  device, n, ROUTE_TORCH, iters)
    check(bool(BF.probe(bf, customers).data.all()),
          "every built key probes true")
    cpu_bf = BF.put(BF.create(k, num_longs, 2, 0, "cpu"), on_cpu(customers))
    blob = BF.serialize(bf)
    check(blob == BF.serialize(cpu_bf), "bloom bytes == the CPU's")
    halves = [BF.put(empty, CP.slice_column(customers, lo, hi))
              for lo, hi in ((0, n // 2), (n // 2, n))]
    merged = ops_call(res, "bloom_merge", lambda: BF.merge(halves),
                      device, n, ROUTE_TORCH, iters)
    check(BF.serialize(merged) == blob, "merged halves == the whole")
    check(BF.serialize(BF.deserialize(blob, device)) == blob,
          "bloom serde round trip")
    found = ops_call(res, "bloom_probe", lambda: BF.probe(bf, probe_keys),
                     device, probe_keys.length, ROUTE_TORCH, iters)
    vs_cpu(lambda c: BF.probe(cpu_bf, c), (probe_keys,), cpu_rows, found,
           "bloom_probe")
    res["bloom_probe"]["hit_share"] = float(
        found.data[found.valid_mask()].float().mean())
    res["bloom_bytes"] = len(blob)


def hll_calls(res, device, batch, cust, cpu_rows, iters):
    p = HLL_PRECISION
    rows = cust.length
    store_ids = batch["ss_store_sk"].data
    sk = ops_call(res, "hllpp_reduce", lambda: HLL.reduce_hllpp(cust, p),
                  device, rows, ROUTE_TORCH, iters)
    grouped = ops_call(res, "hllpp_group_402",
                       lambda: HLL.group_hllpp(cust, store_ids, 402, p),
                       device, rows, ROUTE_TORCH, iters)
    parts = [HLL.reduce_hllpp(c, p) for c in
             (CP.slice_column(cust, i * rows // HLL_PARTIALS,
                              (i + 1) * rows // HLL_PARTIALS)
              for i in range(HLL_PARTIALS))]
    partials = CP.concat_columns(parts)
    merged = ops_call(res, f"hllpp_merge_{HLL_PARTIALS}",
                      lambda: HLL.reduce_merge_hllpp(partials, p), device,
                      HLL_PARTIALS, ROUTE_TORCH, iters)
    same_nested(merged, sk, "merged partial sketches == the whole")
    est = ops_call(res, "hllpp_estimate",
                   lambda: HLL.estimate_from_hll_sketches(sk, p), device,
                   1, ROUTE_TORCH, iters)
    for name, fn, cols in (
            ("hllpp_reduce", lambda c: HLL.reduce_hllpp(c, p), (cust,)),
            ("hllpp_group_402", lambda c, s: HLL.group_hllpp(
                c, s.data, 402, p), (cust, batch["ss_store_sk"]))):
        card = fn(*[CP.slice_column(c, 0, cpu_rows) for c in cols])
        want = fn(*[on_cpu(CP.slice_column(c, 0, cpu_rows)) for c in cols])
        same_nested(card, want, f"{name} sketch over {cpu_rows} rows: card "
                    f"== CPU")
    exact = int(torch.unique(cust.data[cust.valid_mask()]).shape[0])
    got = int(est.data[0])
    res["hllpp_estimate"].update(estimate=got, exact=exact,
                                 rel_err=abs(got - exact) / exact)
    check(abs(got - exact) / exact < HLL_MAX_ERR,
          f"HLL++ estimate {got} within {HLL_MAX_ERR} of {exact}")
    same_nested(est, HLL.estimate_from_hll_sketches(on_cpu(sk), p),
                "hllpp_estimate of the reduce sketch: card == CPU")
    gest = HLL.estimate_from_hll_sketches(grouped, p)
    same_nested(gest, HLL.estimate_from_hll_sketches(on_cpu(grouped), p),
                "hllpp_estimate of the 402 store sketches: card == CPU")
    check(grouped.length == 402 and bool((gest.data > 0).all()),
          "a positive estimate for each of the 402 stores")


def histogram_calls(res, device, batch, cpu_rows, iters):
    qty = batch["ss_quantity"]
    rows = qty.length
    ones = Column(dtypes.INT64, rows, data=torch.ones(
        rows, dtype=torch.int64, device=device))
    per_row = ops_call(res, "histogram_create_rows",
                       lambda: HG.create_histogram_if_valid(qty, ones),
                       device, rows, ROUTE_TORCH, iters)
    vs_cpu(HG.create_histogram_if_valid, (qty, ones), cpu_rows, per_row,
           "histogram_create_rows")
    counts = torch.bincount(qty.data[qty.valid_mask()].to(torch.int64),
                            minlength=101)[1:]
    values = Column(dtypes.INT32, 100, data=torch.arange(
        1, 101, dtype=torch.int32, device=device))
    freq = Column(dtypes.INT64, 100, data=counts)
    h = ops_call(res, "histogram_create_counts",
                 lambda: HG.create_histogram_if_valid(values, freq),
                 device, 100, ROUTE_TORCH, iters)
    vs_cpu(HG.create_histogram_if_valid, (values, freq), 100, h,
           "histogram_create_counts")
    merged = Column(dtypes.LIST, 1, offsets=torch.tensor(
        [0, h.children[0].length], dtype=torch.int32, device=device),
        children=h.children)
    pct = ops_call(res, "histogram_percentile",
                   lambda: HG.percentile_from_histogram(
                       merged, list(HIST_PERCENTILES)), device, 1,
                   ROUTE_HOST, iters)
    got = pct.to_pylist()[0]
    q = np.sort(qty.data[qty.valid_mask()].cpu().numpy())
    want = []
    for p in HIST_PERCENTILES:
        pos = p * (q.shape[0] - 1)
        lo, hi = math.floor(pos), math.ceil(pos)
        want.append(float(q[lo]) + (pos - lo) * float(q[hi] - q[lo]))
    check(got == want, f"percentiles {got} == sorted quantities' {want}")
    res["histogram_percentile"]["values"] = got


def zorder_iceberg_calls(res, device, batch, cust, keys, ts, cpu_rows,
                         host_rows, iters):
    item = batch["ss_item_sk"]
    rows = item.length
    cust32 = Column(dtypes.INT32, rows, data=cust.data.to(torch.int32),
                    validity=cust.validity)
    for name, fn in (("interleave_bits", Z.interleave_bits),
                     ("hilbert_index_18",
                      lambda cols: Z.hilbert_index(HILBERT_BITS, cols))):
        out = ops_call(res, name, lambda fn=fn: fn([item, cust32]), device,
                       rows, ROUTE_TORCH, iters)
        vs_cpu(lambda a, b, fn=fn: fn([a, b]), (item, cust32), cpu_rows,
               out, name)
    price = batch["ss_sales_price"]
    for name, fn, col, n, route in (
            ("iceberg_bucket_int64",
             lambda c: IB.bucket(c, ICEBERG_BUCKETS), price, cpu_rows,
             ROUTE_TORCH),
            ("iceberg_bucket_string",
             lambda c: IB.bucket(c, ICEBERG_BUCKETS), keys, cpu_rows,
             ROUTE_TORCH),
            ("iceberg_truncate_int64",
             lambda c: IB.truncate(c, ICEBERG_WIDTH), price, cpu_rows,
             ROUTE_TORCH),
            ("iceberg_truncate_string",
             lambda c: IB.truncate(c, ICEBERG_WIDTH),
             CP.slice_column(keys, 0, host_rows), host_rows, ROUTE_HOST),
            ("iceberg_year", IB.year, ts, cpu_rows, ROUTE_TORCH),
            ("iceberg_month", IB.month, ts, cpu_rows, ROUTE_TORCH),
            ("iceberg_day", IB.day, ts, cpu_rows, ROUTE_TORCH),
            ("iceberg_hour", IB.hour, ts, cpu_rows, ROUTE_TORCH)):
        out = ops_call(res, name, lambda fn=fn, col=col: fn(col), device,
                       col.length, route, iters)
        vs_cpu(fn, (col,), n, out, name)


def misc_string_calls(res, device, batch, urls, cpu_rows, uuid_rows,
                      iters):
    for delim, count in SUBSTRING_CALLS:
        name = f"substring_index {delim!r} {count}"
        out = ops_call(res, name, lambda d=delim, k=count:
                       substring_index_op(urls, d, k), device, urls.length,
                       ROUTE_TORCH, iters)
        vs_cpu(lambda c, d=delim, k=count: substring_index_op(c, d, k),
               (urls,), cpu_rows, out, name)
    u = ops_call(res, "random_uuids", lambda: UG.random_uuids(
        uuid_rows, OPS_SEED, device), device, uuid_rows, ROUTE_TORCH, iters)
    check(torch.equal(u.data, UG.random_uuids(uuid_rows, OPS_SEED,
                                              device).data),
          "the same seed gives the same UUIDs")
    head_uuids = CP.slice_column(u, 0, cpu_rows).to_pylist()
    check(all(UUID_TEXT.match(x) for x in head_uuids)
          and len(set(head_uuids)) == len(head_uuids),
          "UUIDs well formed (version 4, variant 8-b), no repeats")
    b = batch
    whens = []
    for col, fn in ((b["ss_quantity"], lambda d: d > 50),
                    (b["ss_sales_price"], lambda d: d > 10_000),
                    (b["ss_net_paid"], lambda d: d > 500.0),
                    (b["ss_store_sk"], lambda d: d < 100)):
        whens.append(Column(dtypes.BOOL8, col.length,
                            data=fn(col.data).to(torch.uint8),
                            validity=col.validity))
    out = ops_call(res, "select_first_true_index",
                   lambda: CW.select_first_true_index(whens), device,
                   b.num_rows, ROUTE_TORCH, iters)
    vs_cpu(lambda *c: CW.select_first_true_index(list(c)), whens, cpu_rows,
           out, "select_first_true_index")


UUID_TEXT = re.compile(r"^[0-9a-f]{8}-[0-9a-f]{4}-4[0-9a-f]{3}-[89ab]"
                       r"[0-9a-f]{3}-[0-9a-f]{12}$")


def customer_keys(rows, device, seed, customers=J1_CUSTOMERS):
    """(ss_customer_sk as INT64 over `rows`, 4% null; c_customer_sk,
    J1's 2,000,000 unique keys) on `device`."""
    g = torch.Generator(device=device).manual_seed(seed)
    sk = torch.randint(1, customers + 1, (rows,), generator=g,
                       dtype=torch.int64, device=device)
    valid = (torch.rand(rows, generator=g, device=device)
             >= J1_NULL_SHARE).to(torch.uint8)
    dim = torch.randperm(customers, generator=g, device=device) + 1
    return (Column(dtypes.INT64, rows, data=sk, validity=valid),
            Column(dtypes.INT64, customers, data=dim))


def timestamp_column(rows, device, seed):
    """A TIMESTAMP[us] column of years 1500-2100, 4% null (the ingest
    phase's distribution)."""
    g = torch.Generator(device=device).manual_seed(seed)
    us = torch.randint(*DT_US_RANGE, (rows,), generator=g,
                       dtype=torch.int64, device=device)
    valid = (torch.rand(rows, generator=g, device=device)
             >= DT_NULL_SHARE).to(torch.uint8)
    return Column(dtypes.TIMESTAMP_MICROS, rows, data=us, validity=valid)


def ops_phase(device="cuda", rows=OPS_ROWS, dec_rows=OPS_ROWS_DEC,
              str_rows=STR_OPS_ROWS, url_rows=URL_ROWS,
              ts_rows=OPS_TS_ROWS, bin_rows=OPS_BIN_ROWS,
              uuid_rows=OPS_UUID_ROWS, cpu_rows=OPS_CPU_ROWS,
              wide_cpu_rows=OPS_WIDE_CPU_ROWS, host_rows=OPS_HOST_ROWS,
              customers=J1_CUSTOMERS, iters=OPS_ITERS):
    """Every op of the slice on `device` (see the module docstring);
    returns {call: numbers} and each group's seconds."""
    res = {}
    clock = time.perf_counter()
    g = torch.Generator(device=device).manual_seed(OPS_SEED)
    batch = store_sales_batch(rows, OPS_SEED, device)

    def lap(name):
        nonlocal clock
        now = time.perf_counter()
        res.setdefault("group_s", {})[name] = now - clock
        clock = now

    decimal_calls(res, device, batch["ss_net_paid"], dec_rows, cpu_rows,
                  OPS_SEED, iters)
    lap("decimals")
    arithmetic_calls(res, device, batch, g, wide_cpu_rows, iters)
    lap("arithmetic")
    keys = string_key_column(str_rows, STR_DISTINCT, 8, 50, OPS_SEED,
                             device)
    cast_calls(res, device, batch, keys, host_rows, bin_rows, OPS_SEED,
               iters)
    lap("casts")
    sha_calls(res, device, batch, keys, cpu_rows, iters)
    lap("sha")
    cust, customers = customer_keys(rows, device, OPS_SEED, customers)
    bloom_calls(res, device, customers, cust, wide_cpu_rows, iters)
    hll_calls(res, device, batch, cust, wide_cpu_rows, iters)
    histogram_calls(res, device, batch, wide_cpu_rows, iters)
    lap("sketches")
    ts = timestamp_column(ts_rows, device, OPS_SEED)
    zorder_iceberg_calls(res, device, batch, cust, keys, ts, wide_cpu_rows,
                         host_rows, iters)
    del ts, customers
    lap("zorder_iceberg")
    urls = url_column(url_rows, OPS_SEED, device)
    misc_string_calls(res, device, batch, urls, cpu_rows, uuid_rows, iters)
    lap("strings")
    return res


def run_ops(device="cuda", **kw):
    """The rest of the op breadth on the card (see the module
    docstring)."""
    RA.reset_launches()
    clock = time.perf_counter()
    res = ops_phase(device, **kw)
    res["phase_s"] = time.perf_counter() - clock
    print(json.dumps({"ops": res}), flush=True)
    launches = read_launches("ops")
    check(not any(launches.values()),
          "the ops path launches none of the row kernels")
    return launches, res


# ------------------------------------------------------------ protobuf (16)

# 2^21 clickstream events as Kafka values decoded by Spark's
# from_protobuf (half an executor batch: 2^22 before step 23 needed the
# time), drawn from a seed on `device`: 150-400 bytes each, about 0.4 GB
# of chars, 4% null rows, a seeded 1/64 replaced by edge rows
PB_ROWS = 1 << 21
PB_CHECK_ROWS = 1 << 18     # card result vs the host oracle on a CPU copy
PB_FALLBACK_ROWS = 1 << 16  # one row of 40 item_ids: the host route
PB_NULL_SHARE = 0.04
PB_EDGE_EVERY = 64
PB_SEED = 16
PB_ITERS = 3
PB_EDGES = ("trunc_varint", "trunc_payload", "wire3", "wire4", "wire6",
            "wire7", "missing_id", "unknown", "mismatch", "duplicate",
            "empty", "empty_packed", "bad_nested", "huge_len",
            "huge_len_unknown")
PB_OS = ["android", "ios", "windows", "macos", "linux", "chromeos"]
PB_TAGS = ["new", "vip", "mobile", "desktop", "returning", "promo",
           "sale", "beta", "gift", "repeat"]


def pb_fields():
    """The event schema (field numbers as protoc assigns them)."""
    from spark_rapids_tpu_torch.ops import protobuf as PBF
    F = PBF.Field
    device_msg = (F(1, dtypes.STRING, name="os"),
                  F(2, dtypes.INT32, name="version"),
                  F(3, dtypes.BOOL8, name="mobile"))
    return [
        F(1, dtypes.INT64, required=True, name="event_id"),
        F(2, dtypes.INT64, name="user_id"),
        F(3, dtypes.STRING, name="url"),
        F(4, dtypes.INT64, name="ts_us"),
        F(5, dtypes.FLOAT64, name="price"),
        F(6, dtypes.INT32, default=1, name="quantity"),
        F(7, dtypes.INT64, encoding=PBF.ZIGZAG, name="delta"),
        F(8, dtypes.BOOL8, name="flag"),
        F(9, dtypes.FLOAT32, name="score"),
        F(10, dtypes.INT32, encoding=PBF.FIXED, name="shard"),
        F(11, dtypes.STRUCT, children=device_msg, name="device"),
        F(12, dtypes.INT64, repeated=True, name="item_ids"),
        F(13, dtypes.STRING, repeated=True, name="tags"),
    ]


def pb_varint_bytes(v):
    """(rows, 10) uint8 varint encodings of int64 lanes (u64 bits) and
    their lengths."""
    from spark_rapids_tpu_torch.utils.u64math import shr
    parts = [shr(v, 7 * i) for i in range(10)]
    n = 1 + sum((p != 0).to(torch.int64) for p in parts[1:])
    cols = [(p & 0x7F) | torch.where(i < n - 1, 0x80, 0)
            for i, p in enumerate(parts)]
    return torch.stack(cols, 1).to(torch.uint8), n


def pb_key(num, wire):
    out = bytearray()
    v = (num << 3) | wire
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def pb_segment(mat, lens, keep):
    """STRING column of each row's first lens bytes of `mat` (rows, W),
    empty where `keep` is False."""
    rows, w = mat.shape
    return SB.build_string_column(
        mat.reshape(-1), torch.arange(rows, device=mat.device) * w,
        torch.where(keep, lens, 0))


def pb_const_bytes(data: bytes, rows, device):
    return torch.tensor(list(data), dtype=torch.uint8,
                        device=device).expand(rows, len(data))


def pb_varint_field(num, v, keep, wire=0):
    """tag(num, wire) + varint(v) where `keep`."""
    rows = v.shape[0]
    key = pb_key(num, wire)
    vb, n = pb_varint_bytes(v)
    mat = torch.cat([pb_const_bytes(key, rows, v.device), vb], 1)
    return pb_segment(mat, n + len(key), keep)


def pb_fixed_field(num, v, width, keep):
    """tag(num, I64/I32) + the low `width` little-endian bytes of v."""
    rows = v.shape[0]
    key = pb_key(num, 1 if width == 8 else 5)
    raw = v.to(torch.int64).contiguous().view(torch.uint8).reshape(
        rows, 8)[:, :width]
    mat = torch.cat([pb_const_bytes(key, rows, v.device), raw], 1)
    return pb_segment(mat, torch.full((rows,), len(key) + width,
                                      device=v.device), keep)


def pb_len_field(num, payload, keep):
    """tag(num, LEN) + varint(len) + payload where `keep`."""
    lens = payload.string_lengths().to(torch.int64)
    head = pb_varint_field(num, lens, keep, wire=2)
    return concat_rows([head, masked(payload, keep)], None)


def pb_grouped(elems, counts):
    """Rows of consecutive elements of a STRING column: row i is the
    concatenation of the next counts[i] elements."""
    lens = elems.string_lengths().to(torch.int64)
    ends = torch.cumsum(lens, 0)
    row_end = torch.cumsum(counts, 0)
    offs = torch.zeros(counts.shape[0] + 1, dtype=torch.int64,
                       device=counts.device)
    nz = row_end > 0
    offs[1:] = torch.where(nz, ends[(row_end - 1).clamp(min=0)], 0) \
        if lens.shape[0] else 0
    base = elems.offsets[0].to(torch.int64)
    return Column(dtypes.STRING, counts.shape[0],
                  data=elems.data[base:base + int(offs[-1])],
                  offsets=offs.to(torch.int32))


def protobuf_events(rows, seed, device="cuda", edge_every=PB_EDGE_EVERY,
                    null_share=PB_NULL_SHARE, max_items=16):
    """`rows` serialized events of pb_fields()' schema as a STRING
    (binary) column on `device` (see PB_ROWS)."""
    g = torch.Generator(device=device).manual_seed(seed)

    def ints(lo, hi, n=rows):
        return torch.randint(lo, hi, (n,), generator=g, dtype=torch.int64,
                             device=device)

    edge_at = ints(0, edge_every) == 0
    kind = torch.where(edge_at, ints(0, len(PB_EDGES)), -1)

    def is_edge(name):
        return kind == PB_EDGES.index(name)

    yes = torch.ones(rows, dtype=torch.bool, device=device)
    empty = ~is_edge("empty")
    segs = [pb_varint_field(1, ints(1, 1 << 62), empty
                            & ~is_edge("missing_id")),
            pb_varint_field(2, ints(0, 1 << 40), empty),
            pb_len_field(3, url_column(rows, seed, device), empty),
            pb_varint_field(4, ints(1767225600 * 10**6,
                                    1798761600 * 10**6), empty),
            pb_fixed_field(5, (torch.rand(rows, generator=g,
                                          dtype=torch.float64,
                                          device=device) * 500
                               ).view(torch.int64), 8, empty),
            pb_varint_field(6, ints(1, 100), empty
                            & (ints(0, 8) > 0)),
            pb_varint_field(7, (lambda d: (d << 1) ^ (d >> 63))(
                ints(-(1 << 33), 1 << 33)), empty),
            pb_varint_field(8, ints(0, 2), empty),
            pb_fixed_field(9, torch.randn(rows, generator=g,
                                          device=device).view(torch.int32),
                           4, empty),
            pb_fixed_field(10, ints(0, 1 << 32), 4, empty)]
    dev = concat_rows([pb_len_field(1, pick(PB_OS, g, rows, device), yes),
                       pb_varint_field(2, ints(1, 30), yes),
                       pb_varint_field(3, ints(0, 2), yes)], None)
    segs.append(pb_len_field(11, dev, empty & (ints(0, 16) > 0)))
    counts = ints(0, max_items + 1)
    total = int(counts.sum())
    ib, inb = pb_varint_bytes(torch.randint(1, 1 << 35, (total,),
                                            generator=g, device=device))
    packed = pb_grouped(pb_segment(ib, inb, torch.ones(
        total, dtype=torch.bool, device=device)), counts)
    segs.append(pb_len_field(12, packed, empty & (counts > 0)))
    tcounts = ints(0, 5)
    ttotal = int(tcounts.sum())
    tag_elems = pb_len_field(13, pick(PB_TAGS, g, ttotal, device),
                             torch.ones(ttotal, dtype=torch.bool,
                                        device=device))
    segs.append(masked(pb_grouped(tag_elems, tcounts), empty))
    # edge rows: appended records (the last record of a field wins)
    edge_bytes = {
        "trunc_varint": pb_key(2, 0) + b"\xff\xff",
        "trunc_payload": pb_key(3, 2) + b"\x28abc",
        "wire3": pb_key(20, 3) + b"\x00", "wire4": pb_key(20, 4),
        "wire6": pb_key(20, 6) + b"\x00", "wire7": pb_key(20, 7),
        "unknown": pb_key(99, 0) + b"\xb9\x60" + pb_key(98, 2) + b"\x03zzz"
        + pb_key(97, 1) + bytes(8) + pb_key(96, 5) + bytes(4),
        "mismatch": pb_key(5, 0) + b"\x07" + pb_key(3, 0) + b"\x01",
        "duplicate": pb_key(6, 0) + b"\xe7\x07" + pb_key(3, 2) + b"\x03dup",
        "empty_packed": pb_key(12, 2) + b"\x00",
        "bad_nested": pb_key(11, 2) + b"\x0c" + pb_key(1, 0) + b"\xff" * 11,
        # length varints of 2^63 and 2^64 - 1: negative on int64 lanes
        "huge_len": pb_key(3, 2) + b"\x80" * 9 + b"\x01" + b"ab",
        "huge_len_unknown": pb_key(98, 2) + b"\xff" * 9 + b"\x01",
    }
    vocab = [edge_bytes.get(e, b"") for e in PB_EDGES]
    segs.append(CP.gather(Column.from_strings(vocab, device),
                          kind.clamp(min=0)))
    segs[-1] = masked(segs[-1], edge_at)
    valid = (torch.rand(rows, generator=g, device=device)
             >= null_share).to(torch.uint8)
    return concat_rows(segs, valid)


def pb_fallback_column(rows, seed, device="cuda"):
    """`rows` events whose last row holds 40 packed item_ids: past the
    engine's repeat cap (32), so the whole column takes the host route."""
    long_row = (pb_key(1, 0) + b"\x07" + pb_key(12, 2) + bytes([40])
                + bytes(range(1, 41)))
    return CP.concat_columns([protobuf_events(rows - 1, seed, device),
                              Column.from_strings([long_row], device)])


def pb_canonical(col, valid=None):
    """`col` with every row under a null (its own or an ancestor's)
    emptied: fixed-width data zeroed, strings and lists of no elements,
    validity explicit at every level.  The device engine keeps what it
    captured under null rows and the host oracle does not; their
    canonical forms are equal byte for byte."""
    dev = col.device
    ok = col.valid_mask() if valid is None else valid & col.valid_mask()
    v8 = ok.to(torch.uint8)
    if col.dtype.kind == "struct":
        return Column(col.dtype, col.length, validity=v8,
                      children=tuple(pb_canonical(c, ok)
                                     for c in col.children))
    if col.dtype.is_string:
        out = masked(col, ok)
        return Column(col.dtype, col.length, data=out.data, validity=v8,
                      offsets=out.offsets)
    if col.dtype.kind == "list":
        lens = (col.offsets[1:] - col.offsets[:-1]).to(torch.int64)
        lens = torch.where(ok, lens, 0)
        offs = torch.zeros(col.length + 1, dtype=torch.int64, device=dev)
        torch.cumsum(lens, 0, out=offs[1:])
        total = int(offs[-1])
        row = torch.repeat_interleave(torch.arange(col.length, device=dev),
                                      lens, output_size=total)
        idx = (col.offsets[:-1].to(torch.int64)[row]
               + torch.arange(total, device=dev) - offs[:-1][row])
        child = pb_canonical(CP.gather(col.children[0], idx))
        return Column(col.dtype, col.length, validity=v8,
                      offsets=offs.to(torch.int32), children=(child,))
    data = torch.where(ok, col.data, torch.zeros_like(col.data))
    return Column(col.dtype, col.length, data=data, validity=v8)


def pb_same_as_oracle(got, col, what):
    """The decode `got` equals the host oracle over a CPU copy of `col`
    on every valid row (canonical forms, byte for byte)."""
    want = PBF.decode_protobuf_host(on_cpu(col), pb_fields())
    same_nested(on_cpu(pb_canonical(got)), pb_canonical(want), what)


def pb_call(col):
    return PBF.decode_protobuf_to_struct(col, pb_fields())


def protobuf_phase(device="cuda", rows=PB_ROWS, check_rows=PB_CHECK_ROWS,
                   fallback_rows=PB_FALLBACK_ROWS, iters=PB_ITERS):
    """The protobuf decoder on `device` (see the module docstring)."""
    res = {}
    col = protobuf_events(rows, PB_SEED, device)
    sync(device)
    mb = chars_mb(col)
    PD.reset_stats()
    t0 = time.perf_counter()
    out, peak = peak_added(lambda: pb_call(col), device)
    first = (time.perf_counter() - t0) * 1e3
    call = dict(PD.LAST_CALL)
    check(call.get("route") == "device" and not call.get("fallback"),
          f"protobuf: the main column took the device engine ({call})")
    check(out.device.type == torch.device(device).type,
          "protobuf: the result is on the column's device")
    ms = wall_ms(lambda: pb_call(col), iters, device)
    kernels, recorded = device_kernels(lambda: pb_call(col), device)
    res["decode"] = {
        "rows": rows, "chars_mb": mb, "first_ms": first, "ms": ms,
        "mb_per_s": mb / ms * 1e3, "chunk_rows": PD.DEVICE_ROW_CHUNK,
        "check_every": PD.CHECK_EVERY, "chunk_steps": call["chunk_steps"],
        "scan_steps": call["scan_steps"], "decodes": call["decodes"],
        "host_syncs": call["host_syncs"], "host_bytes": call["host_bytes"],
        "host_rows": call["host_rows"], "kernels": kernels,
        "kernels_recorded": recorded, "peak_added_mb": peak,
        "null_rows": int((out.valid_mask() == 0).sum()),
        "route": call["route"]}
    n = min(check_rows, rows)
    pb_same_as_oracle(CP.slice_column(out, 0, n), CP.slice_column(col, 0, n),
                      "protobuf: card == host oracle")
    del out
    # a column with one row past the repeat cap: the whole column on the
    # host oracle (the reference's routing), counted and equal to it
    fb = pb_fallback_column(fallback_rows, PB_SEED + 1, device)
    t0 = time.perf_counter()
    got = pb_call(fb)
    sync(device)
    fb_ms = (time.perf_counter() - t0) * 1e3
    fb_call = dict(PD.LAST_CALL)
    check(fb_call.get("route") == "host" and fb_call.get("fallback")
          and fb_call.get("host_rows") == fallback_rows,
          f"protobuf: the 40-item row sent its column to the host "
          f"({fb_call})")
    check(len(got.to_pylist()[-1][11]) == 40, "protobuf: 40 item_ids")
    same_nested(on_cpu(got), PBF.decode_protobuf_host(on_cpu(fb),
                                                      pb_fields()),
                "protobuf: host route == oracle")
    res["fallback"] = {"rows": fallback_rows, "ms": fb_ms,
                       "route": fb_call["route"],
                       "host_rows": fb_call["host_rows"]}
    # the JNI door on handles, a flat schema
    flat = [f for f in pb_fields() if not f.is_message and not f.repeated]
    live = JE.live_handles()
    head_col = CP.slice_column(col, 0, min(rows, PB_FALLBACK_ROWS))
    h = REGISTRY.register(head_col)
    out_h = JE.protobuf_decode_to_struct(
        h, [f.field_number for f in flat], [f.dtype.kind for f in flat],
        [f.encoding for f in flat], [f.required for f in flat])
    got = REGISTRY.get(out_h)
    check(PD.LAST_CALL.get("route") == "device",
          "protobuf: the JNI door's call took the device engine")
    want = PBF.decode_protobuf_host(on_cpu(head_col),
                                    [PBF.Field(f.field_number, f.dtype,
                                               f.encoding, False,
                                               f.required)
                                     for f in flat])
    same_nested(on_cpu(pb_canonical(got)), pb_canonical(want),
                "protobuf: JNI door == oracle")
    release_all(h, out_h)
    check(JE.live_handles() == live, "protobuf: every handle released")
    res["stats"] = dict(PD.STATS)
    return res


def run_protobuf(device="cuda", **kw):
    """The protobuf decoder on the card (see the module docstring)."""
    RA.reset_launches()
    clock = time.perf_counter()
    res = protobuf_phase(device, **kw)
    res["phase_s"] = time.perf_counter() - clock
    print(json.dumps({"protobuf": res}), flush=True)
    launches = read_launches("protobuf")
    check(not any(launches.values()),
          "the protobuf path launches none of the row kernels")
    return launches, res


# -------------------------------------------------------- distributed (17)

# step 6's q5 and q72 as worker processes sharing the card, their
# tables moved by kudo over unix sockets (distributed/launcher.py)
# step 6's q5 and q72 at half their rows (a quarter of q72's pairs)
# since step 23 needed the time
DIST_Q5 = dict(rows=Q5_DATA["rows"] // 2, stores=Q5_DATA["stores"],
               days=Q5_DATA["days"], join_capacity=Q5_CAPACITY)
DIST_Q72 = dict(cs_rows=Q72_DATA["cs_rows"] // 2,
                inv_rows=Q72_DATA["inv_rows"] // 2,
                items=Q72_DATA["items"], days=Q72_DATA["days"],
                join_capacity=Q72_CAPACITY, max_week=Q72_MAX_WEEK,
                limit=Q72_LIMIT, week0=Q72_WEEK0)
DIST_TIMEOUT_S = 400
DIST_RESPAWN_DELAY_S = 2.0
# launches B and C test the link and the fleet: their workers run op by
# op (the runner's escape hatch), sparing each process inductor's start
# and compiles (about 16 s a worker, measured on one H100)
DIST_OP_BY_OP = {"SPARK_RAPIDS_TPU_STAGE_FUSION": "0"}
# launch A's workers assemble a query profile per query (step 19 (d))
DIST_PROFILED = {"SPARK_RAPIDS_TPU_PROFILE": "1"}


def dist_dir():
    return os.path.join(_BUILD, "dist")


def same_results(got, want, what):
    for k, v in want.items():
        check(np.asarray(got[k]).tobytes() == np.asarray(v).tobytes(),
              f"{what}: {k} byte-equal to the single process")


def launch_numbers(res):
    """Per-rank numbers of a finished launch: boot, compile and query
    seconds, partials and exchange ms, socket bytes and frames, NAKs
    and resends, mesh mode, peak MiB."""
    ranks = []
    for s in res["summaries"]:
        r = s["rank"]
        ranks.append({
            "rank": r, "respawned": s["respawned"],
            "boot_s": s["t_ready"] - res["spawned"][r][-1],
            "compile_s": s["compile_s"], "op_s": s["op_s"],
            "times_ms": s["times"], "link": s["link"],
            "link_retries": s["link_retries"],
            "mesh": s["mesh"]["mode"], "peak_mib": s["peak_mib"],
            "epoch": s["epoch"],
            "fleet_events": s["fleet_events"],
            "service_events": [e for e in s["service_events"]
                               if e["kind"] != "shuffle_dup_dropped"],
            "dup_dropped": sum(e["kind"] == "shuffle_dup_dropped"
                               for e in s["service_events"])})
    return {"wall_s": res["wall_s"], "deaths": res["deaths"],
            "respawns": len(res["respawns"]), "ranks": ranks}


def dist_observability(res, lockdep=False):
    """A finished launch's per-rank dumps beside its summaries: every
    span carries the launcher's trace id, the link counters equal the
    bytes and frames the summaries count, and (with lockdep on in the
    workers) the journal and metrics show no lock-order cycle.  Returns
    per-rank counts."""
    out = []
    for s in res["summaries"]:
        r = s["rank"]

        def dump(kind, ext):
            return os.path.join(res["outdir"], f"{kind}_rank{r}{ext}")

        with open(dump("spans", ".jsonl")) as f:
            spans = [json.loads(line) for line in f]
        check(spans and all(x["trace_id"] == res["trace_id"]
                            for x in spans),
              f"rank {r}: every span carries the launcher's trace id")
        with open(dump("metrics", ".json")) as f:
            reg = json.load(f)
        with open(dump("journal", ".jsonl")) as f:
            journal = [json.loads(line) for line in f]
        sums = {}
        for fam in ("srt_shuffle_link_bytes_total",
                    "srt_shuffle_link_msgs_total"):
            for x in reg[fam]["series"]:
                key = (fam, x["labels"][0])
                sums[key] = sums.get(key, 0) + x["value"]
        link = s["link"]
        for fam, d, stat in (
                ("srt_shuffle_link_bytes_total", "send", "bytes_sent"),
                ("srt_shuffle_link_bytes_total", "recv", "bytes_recv"),
                ("srt_shuffle_link_msgs_total", "send", "frames_sent"),
                ("srt_shuffle_link_msgs_total", "recv", "frames_recv")):
            check(sums.get((fam, d), 0) == link[stat],
                  f"rank {r}: {fam}{{{d}}} == summary {stat} "
                  f"({sums.get((fam, d), 0)} vs {link[stat]})")
        retries = sum(x["value"] for x in
                      reg["srt_shuffle_link_retries_total"]["series"])
        naks = sum(x["value"] for x in
                   reg["srt_shuffle_link_retries_total"]["series"]
                   if x["labels"][1] == "nak")
        crc = sum(x["value"] for x in reg["srt_kudo_corrupt_total"]["series"]
                  if x["labels"] == ["crc"])
        # every failed attempt is counted, the last of an exhausted
        # send too (no resend follows it)
        lr = s["link_retries"]
        check(retries == lr["nak"] + lr["link"]
              and link["resends"] == retries - lr["exhausted"]
              and naks == lr["nak"] == link["naks_recv"]
              and crc == link["naks_sent"],
              f"rank {r}: link retries {retries} vs {lr} and "
              f"{link['resends']} resends, NAKs received "
              f"{naks}/{link['naks_recv']}, sent {crc}/{link['naks_sent']}")
        row = {"rank": r, "spans": len(spans), "journal": len(journal),
               "link_bytes": sums.get(
                   ("srt_shuffle_link_bytes_total", "send"), 0)}
        if lockdep:
            cycles = [e for e in journal if e["kind"] == "lockdep"
                      and e.get("event") == "cycle"]
            blocking = sum(x["value"] for x in
                           reg["srt_lockdep_blocking_total"]["series"])
            check(not cycles and not reg["srt_lockdep_cycles_total"][
                "series"], f"rank {r}: lockdep saw no cycle ({cycles})")
            check(blocking > 0, f"rank {r}: lockdep's locks were "
                  "instrumented (the link's held-across-send marker)")
            row["lockdep_blocking"] = blocking
        out.append(row)
    return out


def dist_profiles(res, ops):
    """Each query's per-rank profile dumps merged into one fleet
    profile: every rank's profile holds its stages, and every merged
    stage holds every rank.  Returns per query the ranks, the stages
    and the slowest rank's wall ms per stage."""
    from spark_rapids_tpu_torch.observability import merge_profiles
    world = len(res["summaries"])
    out = {}
    for op in ops:
        profiles = []
        for r in range(world):
            path = os.path.join(res["outdir"], f"profile_{op}_rank{r}.json")
            with open(path) as f:
                profiles.append(json.load(f))
            keep_for_tools(path, "dist", os.path.basename(path))
        merged = merge_profiles(profiles)
        stages = [s["stage"] for s in merged["stages"]]
        check(merged["ranks"] == list(range(world))
              and merged["trace_consistent"]
              and merged["trace_id"] == res["trace_id"],
              f"{op}: the rank profiles merge under the launch's trace")
        check(stages and sum(len(p["stages"]) for p in profiles)
              == world * len(stages)
              and all(len(s["per_rank_wall_ns"]) == world
                      for s in merged["stages"]),
              f"{op}: {world} ranks x {len(stages)} stages "
              f"({[len(p['stages']) for p in profiles]})")
        out[op] = {"ranks": world, "stages": stages,
                   "stage_ms": {s["stage"]: s["wall_ns"] / 1e6
                                for s in merged["stages"]}}
    return out


def dist_launch(name, world, ops, params, device="cuda", **kw):
    from spark_rapids_tpu_torch.distributed import launcher as DL
    outdir = os.path.join(dist_dir(), name)
    shutil.rmtree(outdir, ignore_errors=True)
    res = DL.launch(world, outdir, ops=ops, params=params, device=device,
                    timeout_s=DIST_TIMEOUT_S, **kw)
    results = [{op: dict(np.load(os.path.join(
        outdir, f"result_{op}_rank{r}.npz"))) for op in ops}
        for r in range(world)]
    return res, results


def distributed_phase(device="cuda", q5=None, q72=None):
    """Launches A-C on `device` (see the module docstring)."""
    from spark_rapids_tpu_torch.distributed import runner as DR
    q5 = dict(DIST_Q5, **(q5 or {}))
    q72 = dict(DIST_Q72, **(q72 or {}))
    res = {}
    clock = time.perf_counter()
    want = {w: DR.single_q5(dict(q5, world=w), device=device)
            for w in (2, 3)}
    want72 = DR.single_q72(dict(q72, world=2), device=device)
    res["single_s"] = time.perf_counter() - clock
    # the workers share the card: hand back this process's cached blocks
    gc.collect()
    sync(device)
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    shutil.rmtree(dist_dir(), ignore_errors=True)
    try:
        # A: q5 and q72 over two ranks, each rank profiling its queries
        a, got = dist_launch("a", 2, ("q5", "q72"),
                             {"q5": q5, "q72": q72}, device,
                             worker_env=DIST_PROFILED)
        for r in range(2):
            same_results(got[r]["q5"], want[2], f"launch A rank {r} q5")
            same_results(got[r]["q72"], want72, f"launch A rank {r} q72")
        res["a"] = launch_numbers(a)
        res["a"]["observability"] = dist_observability(a)
        res["a"]["profiles"] = dist_profiles(a, ("q5", "q72"))
        # B: q72 with rank 1's first reduce-scatter send corrupted, the
        # workers' locks under lockdep
        b, got = dist_launch("b", 2, ("q72",), {"q72": q72}, device,
                             fault="corrupt:0:111", fault_rank=1,
                             worker_env=dict(DIST_OP_BY_OP,
                                             SPARK_RAPIDS_TPU_LOCKDEP="1"))
        for r in range(2):
            same_results(got[r]["q72"], want72, f"launch B rank {r} q72")
        s0, s1 = b["summaries"]
        check(s0["link"]["naks_sent"] == 1 and s1["link"]["naks_recv"] == 1
              and s1["link"]["resends"] >= 1,
              f"launch B: the corrupt payload was NAKed and resent "
              f"({s0['link']}, {s1['link']})")
        res["b"] = launch_numbers(b)
        res["b"]["observability"] = dist_observability(b, lockdep=True)
        # C: elastic q5 over three ranks; rank 2 dies after its partials,
        # before broadcasting them, and is respawned once
        c, got = dist_launch("c", 3, ("q5",), {"q5": q5}, device,
                             elastic=True, die="q5:partials", die_rank=2,
                             respawn=True,
                             respawn_delay_s=DIST_RESPAWN_DELAY_S,
                             worker_env=DIST_OP_BY_OP)
        for r in range(3):
            same_results(got[r]["q5"], want[3], f"launch C rank {r} q5")
        check([(d["rank"], d["rc"]) for d in c["deaths"]] == [(2, 13)],
              f"launch C: rank 2's injected death ({c['deaths']})")
        survivors = c["summaries"][:2]
        deaths = [e for s in survivors for e in s["fleet_events"]
                  if e["change"] == "death" and 2 in e["dead"]]
        inherit = [e for s in survivors for e in s["service_events"]
                   if e["kind"] in ("fleet_inherit", "fleet_speculation")
                   and e["part"] == 2]
        check(deaths and inherit,
              "launch C: a survivor recorded rank 2's death and took "
              "its shard")
        res["c"] = launch_numbers(c)
        res["c"]["observability"] = dist_observability(c)
    finally:
        shutil.rmtree(dist_dir(), ignore_errors=True)
    return res


def run_distributed(device="cuda", **kw):
    """Distributed q5/q72 as worker processes on the card (see the
    module docstring)."""
    RA.reset_launches()
    clock = time.perf_counter()
    res = distributed_phase(device, **kw)
    res["phase_s"] = time.perf_counter() - clock
    print(json.dumps({"distributed": res}, default=str), flush=True)
    launches = read_launches("distributed")
    check(not any(launches.values()),
          "the distributed path launches none of the row kernels")
    return launches, res


# ------------------------------------------------------ observability

OBS_FLAGSHIP_ROWS = FLAGSHIP_ROWS
OBS_SHUFFLE_ROWS = 1 << 22   # a store_sales batch, 200 partitions
OBS_TASK_ROWS = 1 << 20      # the forced retry and split task rounds
OBS_MONITOR_MS = 50
OBS_QUIET_S = 0.3            # the HBM check's window, nothing allocating
OBS_HBM_TOL = 0.01


def obs_dir():
    return os.path.join(_BUILD, "observability")


def obs_partitions(table, device):
    """Rows ordered by pmod(murmur3_32(store, item), 200) (the shuffle
    cell's partitioning) and the 200 partitions' row bounds."""
    h = H.murmur3_32(Table(table.columns[:2]), SHUFFLE_SEED).data
    pid = torch.remainder(h, SHUFFLE_PARTITIONS)
    order = S.order_by(Table([Column(dtypes.INT32, h.shape[0], data=pid)]))
    ordered = CP.gather_table(table, order)
    counts = torch.bincount(pid, minlength=SHUFFLE_PARTITIONS).tolist()
    bounds = [0] + list(itertools.accumulate(counts))
    sync(device)
    return ordered, bounds


def obs_write(views, bounds):
    """One map task's kudo write of every partition into one stream,
    through the metered writer: (stream bytes, each write's bytes)."""
    out = io.BytesIO()
    sizes = [K.write_to_stream_with_metrics(
        views, out, lo, hi - lo).written_bytes
        for lo, hi in zip(bounds, bounds[1:])]
    return out.getvalue(), sizes


def obs_traced_task(ctx, *args):
    """memory's task_run with the phase's root span as this thread's
    parent, so the task's OOM and retry spans join its tree."""
    from spark_rapids_tpu_torch import observability as obs
    with obs.TRACER.activate(ctx):
        return task_run(*args)


def obs_task_rounds(device, rows, ctx=None):
    """memory's forced retry and split rounds, one task each, on `rows`
    rows: (outputs, per-task numbers)."""
    outs, nums = [], {}
    for name, force in (("forced_retry", rmm_spark.force_retry_oom),
                        ("forced_split",
                         rmm_spark.force_split_and_retry_oom)):
        store = spill_store("host")
        adaptor = rmm_spark.set_event_handler(1 << 60)
        PS.install(store)
        try:
            args = (1, rows, device, store, adaptor,
                    threading.Barrier(1), force)
            fn, fargs = ((task_run, args) if ctx is None
                         else (obs_traced_task, (ctx,) + args))
            (out,) = run_task_threads([(fn, fargs)])
            check(adaptor.resource.used == 0
                  and adaptor.thread_state_dump() == [],
                  f"observability {name}: nothing left reserved")
        finally:
            PS.uninstall()
            rmm_spark.clear_event_handler()
        outs.append(out[0])
        nums[name] = {"retries": out[1], "split_retries": out[2]}
    return outs, nums


def obs_run(device, inputs, views, bounds, fields, rows, ctx=None):
    """The phase's three workloads once: the flagship step, one map
    task's kudo write of 200 partitions and their merge, and the forced
    retry and split task rounds.  Returns (outputs, numbers)."""
    t0 = time.perf_counter()
    flag = F.flagship_step(*inputs)
    sync(device)
    flag_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    blob, sizes = obs_write(views, bounds)
    write_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    merged, mm = K.merge_to_table_with_metrics(
        K.read_tables(io.BytesIO(blob)), fields, device)
    sync(device)
    merge_ms = (time.perf_counter() - t0) * 1e3
    tasks, task_nums = obs_task_rounds(device, rows, ctx)
    return ((flag, blob, sizes, merged, tasks),
            {"flagship_ms": flag_ms, "write_ms": write_ms,
             "merge_ms": merge_ms, "merged_rows": mm.total_rows,
             "tasks": task_nums})


def obs_metric(snap, name, labels=()):
    """One counter or gauge series' value in a registry snapshot (0
    when absent)."""
    for s in snap[name]["series"]:
        if tuple(s["labels"]) == tuple(labels):
            return s["value"]
    return 0


def obs_one_tree(recs, root):
    """Every span record descends from `root` (same trace, parents
    inside the set)."""
    by_id = {r["span_id"]: r for r in recs}
    for r in recs:
        check(r["trace_id"] == root["trace_id"],
              f"span {r['name']} in the phase's trace")
        hops = 0
        while r["parent_id"] is not None:
            r = by_id[r["parent_id"]]
            hops += 1
            check(hops < 64, "span parents end")
        check(r is root, "every span nests under the phase's root")


def observability_phase(device="cuda", flagship_rows=OBS_FLAGSHIP_ROWS,
                        shuffle_rows=OBS_SHUFFLE_ROWS,
                        task_rows=OBS_TASK_ROWS, iters=STEP_ITERS):
    """Step 18 (see the module docstring): the flagship step, a kudo
    shuffle write and merge, and the forced retry and split task rounds,
    once with observability off and once with metrics and tracing on
    under one root span, with the telemetry Monitor sampling."""
    from spark_rapids_tpu_torch import observability as obs
    from spark_rapids_tpu_torch.utils import telemetry
    clock = time.perf_counter()
    shutil.rmtree(obs_dir(), ignore_errors=True)
    os.makedirs(obs_dir())
    prior = (obs.is_enabled(), obs.is_tracing_enabled())
    obs.disable()
    obs.disable_tracing()
    obs.reset()
    res = {"flagship_rows": flagship_rows, "shuffle_rows": shuffle_rows,
           "partitions": SHUFFLE_PARTITIONS, "task_rows": task_rows}
    inputs = F.example_inputs(flagship_rows, device=device)
    table = store_sales_batch(shuffle_rows, seed=18, device=device)
    ordered, bounds = obs_partitions(table, device)
    del table
    views = K.prepare_host_columns(ordered.columns)
    fields = schema_of_table(ordered)
    try:
        off, res["off"] = obs_run(device, inputs, views, bounds, fields,
                                  task_rows)
        res["off"]["flagship_step_ms"] = wall_ms(
            lambda: F.flagship_step(*inputs), iters, device)
        res["off"]["write_ms_median"] = wall_ms(
            lambda: obs_write(views, bounds), iters, device)
        check(len(obs.JOURNAL) == 0 and len(obs.TRACER) == 0,
              "observability off records nothing")
        obs.enable()
        obs.enable_tracing()
        samples = []

        def listener(infos):
            if torch.device(device).type == "cuda":
                samples.append((infos[0].memory_stats["bytes_in_use"],
                                torch.cuda.memory_allocated(0),
                                time.monotonic()))
            else:
                samples.append((0, 0, time.monotonic()))

        mon = telemetry.Monitor(OBS_MONITOR_MS, listener, device=device)
        mon.start()
        try:
            with obs.TRACER.span("observability_phase",
                                 kind="query") as root:
                on, res["on"] = obs_run(device, inputs, views, bounds,
                                        fields, task_rows, root.context)
            res["on"]["flagship_step_ms"] = wall_ms(
                lambda: F.flagship_step(*inputs), iters, device)
            res["on"]["write_ms_median"] = wall_ms(
                lambda: obs_write(views, bounds), iters, device)
            sync(device)
            quiet_from = time.monotonic()
            time.sleep(OBS_QUIET_S)
        finally:
            mon.stop()
        # outputs: the flagship and shuffle byte for byte, the task
        # group-bys within memory's float bound
        for name, a, b in zip(("murmur3_32", "xxhash64", "rows",
                               "bucket sums"), on[0], off[0]):
            check(torch.equal(a, b), f"observability: flagship {name} "
                  "equal with observability on")
        for i, (a, b) in enumerate(zip(on[3].columns, off[3].columns)):
            same_nested(a, b, f"observability: merged column {i}")
        res["task_float_diff_of_bound"] = same_task_results(
            on[4], off[4], "observability on vs off")
        check(res["on"]["tasks"] == res["off"]["tasks"]
              == {"forced_retry": {"retries": 1, "split_retries": 0},
                  "forced_split": {"retries": 0, "split_retries": 1}},
              f"observability: one injected retry and one split "
              f"({res['on']['tasks']})")
        # each kudo table is the untraced bytes behind a KTRX prefix
        # naming its own kudo_write span
        blob_on, sizes_on = on[1], on[2]
        blob_off, sizes_off = off[1], off[2]
        check([n - 20 for n in sizes_on] == sizes_off,
              "observability: each traced table is 20 bytes longer")
        writes = [r for r in obs.TRACER.records()
                  if r["name"] == "kudo_write"]
        want, at = [], 0
        for n, rec in zip(sizes_off, writes[:len(sizes_off)]):
            want.append(K.TRACE_MAGIC + int(rec["trace_id"], 16).to_bytes(
                8, "big") + int(rec["span_id"], 16).to_bytes(8, "big"))
            want.append(blob_off[at:at + n])
            at += n
        check(blob_on == b"".join(want),
              "observability: traced stream == KTRX prefix + untraced "
              "table, table by table")
        # counters equal the known counts; the journal dropped nothing
        snap = obs.METRICS.snapshot()
        written = obs_metric(snap, "srt_shuffle_write_bytes_total")
        check(written == len(blob_on) + iters * len(blob_on),
              f"observability: {written} bytes written counted")
        merged_rows = obs_metric(snap, "srt_shuffle_merge_rows_total")
        check(merged_rows == shuffle_rows,
              f"observability: {merged_rows} rows merged counted")
        for fam, n in (("srt_oom_retry_total", 1),
                       ("srt_oom_split_retry_total", 1)):
            got = obs_metric(snap, fam, ("device",))
            check(got == n, f"observability: {fam} {got} == {n}")
        check(obs_metric(snap, "srt_retry_splits_total") == 1,
              "observability: one split counted")
        check(obs.JOURNAL.dropped == 0 and obs.TRACER.dropped == 0,
              "observability: the journal and the span ring dropped "
              "nothing")
        recs = [r for r in obs.TRACER.records()
                if r["trace_id"] == f"{root.trace_id:016x}"]
        (root_rec,) = [r for r in recs if r["parent_id"] is None]
        check(root_rec["name"] == "observability_phase",
              "observability: the phase's root span")
        obs_one_tree(recs, root_rec)
        names = {r["name"] for r in recs}
        for n in ("kudo_write", "kudo_merge", "retry_episode:task1",
                  "oom_retry", "oom_split_retry"):
            check(n in names, f"observability: a {n} span")
        # both dumps parse
        spans_path = os.path.join(obs_dir(), "spans.jsonl")
        journal_path = os.path.join(obs_dir(), "journal.jsonl")
        n_spans = obs.dump_spans_jsonl(spans_path)
        n_journal = obs.dump_journal_jsonl(journal_path)
        for path, n in ((spans_path, n_spans), (journal_path, n_journal)):
            with open(path) as f:
                lines = [json.loads(line) for line in f]
            check(len(lines) == n, f"observability: {path} parses")
        # HBM samples: within 1% of memory_allocated() read in the same
        # listener call, over the quiet window
        quiet = [(a, b) for a, b, t in samples if t >= quiet_from]
        check(len(samples) >= 2 and quiet,
              f"observability: Monitor samples ({len(samples)})")
        worst = max(abs(a - b) / max(b, 1) for a, b in quiet)
        check(worst <= OBS_HBM_TOL,
              f"observability: HBM samples within 1% ({worst})")
        if torch.device(device).type == "cuda":
            check(obs_metric(snap, "srt_hbm_bytes_in_use", ("0",)) > 0,
                  "observability: the HBM gauge")
        res.update(spans_finished=len(obs.TRACER),
                   journal_events=len(obs.JOURNAL),
                   journal_by_kind=obs.JOURNAL.counts_by_kind(),
                   samples=len(samples), quiet_samples=len(quiet),
                   hbm_worst_rel_diff=worst,
                   bytes_written_per_stream=len(blob_on))
    finally:
        obs.reset()
        (obs.enable if prior[0] else obs.disable)()
        (obs.enable_tracing if prior[1] else obs.disable_tracing)()
        shutil.rmtree(obs_dir(), ignore_errors=True)
    res["phase_s"] = time.perf_counter() - clock
    return res


def run_observability(device="cuda", **kw):
    """Step 18 on the card (see the module docstring)."""
    RA.reset_launches()
    res = observability_phase(device, **kw)
    line = {k: res[k] for k in ("spans_finished", "journal_events",
                                "samples", "phase_s")}
    line.update(
        flagship_step_ms={"off": res["off"]["flagship_step_ms"],
                          "on": res["on"]["flagship_step_ms"]},
        shuffle_write_ms={"off": res["off"]["write_ms_median"],
                          "on": res["on"]["write_ms_median"]},
        detail=res)
    print(json.dumps({"observability": line}, default=str), flush=True)
    return read_launches("observability"), res


# ---------------------------------------------- observability plane (19)

# the stage path's q5 data and join capacity
PLANE_Q5 = dict(Q5_DATA, join_capacity=Q5_CAPACITY)
PLANE_TENANT = "chip_smoke"
PLANE_WINDOW_S = 0.25                 # timeseries windows
PLANE_WINDOWS_CAP = 4096              # no window leaves the ring
PLANE_CP_COVER = 0.9                  # the critical path's share of wall
PLANE_INCIDENT_BYTES = 64 << 20
PLANE_TASK_ATTEMPTS = 2
PLANE_STREAM = "q5_stream_chip_smoke"


def plane_dir():
    return os.path.join(_BUILD, "observability_plane")


def plane_query(o, name, fn, device, slo=True):
    """fn() as one profiled query under its own root span, fed to the
    SLO monitor unless `slo` is false: (outputs, profile, the root's
    span records, ms)."""
    t0 = time.perf_counter()
    with o.TRACER.span(name, kind="query") as root:
        sess = o.PROFILER.begin(f"{name}-{root.span_id:016x}",
                                tenant=PLANE_TENANT, query=name)
        try:
            out = fn()
            sync(device)
        finally:
            prof = o.PROFILER.end(sess)
    ms = (time.perf_counter() - t0) * 1e3
    if slo:
        o.SLO.observe(PLANE_TENANT, "success", int(ms * 1e6))
    trace = f"{root.trace_id:016x}"
    recs = [r for r in o.TRACER.records() if r["trace_id"] == trace]
    return out, prof, recs, ms


def plane_ledger(prof, what):
    """The profile's attribution ledger conserves its wall."""
    led = prof.get("attribution")
    check(led is not None and led["conserved"],
          f"observability_plane: {what}'s ledger conserves its wall "
          f"({led and led.get('residual_ns')}, "
          f"{led and led.get('overcount_ns')})")
    return led


def plane_profiled(device, flag_inputs, d5, p5, fusion=None):
    """(a): the flagship step and q5 off, then as profiled queries with
    the whole plane on, q5's stages under `fusion` (None: 'auto');
    returns the numbers."""
    from spark_rapids_tpu_torch import observability as obs
    from spark_rapids_tpu_torch.observability.critical_path import (
        critical_path)
    from spark_rapids_tpu_torch.observability.timeseries import (
        sum_counter_windows)
    from spark_rapids_tpu_torch.utils import telemetry
    res = {}

    def flag():
        return F.flagship_step(*flag_inputs)

    def q5():
        return TC.run_q5(d5, p5["stores"], p5["join_capacity"])

    # off: q5's first run under 'auto' measures its engines
    with env(SPARK_RAPIDS_TPU_STAGE_FUSION=fusion):
        t0 = time.perf_counter()
        off = (flag(), q5())
        sync(device)
        res["off_first_s"] = time.perf_counter() - t0
        res["flagship_ms"] = {"off": wall_ms(flag, STEP_ITERS, device)}
        res["q5_ms"] = {"off": wall_ms(q5, STEP_ITERS, device)}
        check(len(obs.JOURNAL) == 0 and len(obs.TRACER) == 0,
              "observability_plane: everything off records nothing")
        res["q5_engines"] = {
            k[0]: v for k, v in CAL._PROC_CACHE.items()
            if k[0] in ("stage:q5_partials", "stage:q5_finish")}
        obs.enable()
        obs.enable_tracing()
        obs.enable_profiling()
        obs.enable_attribution()
        obs.enable_stats()
        obs.enable_timeseries(window_s=PLANE_WINDOW_S,
                              capacity=PLANE_WINDOWS_CAP)
        obs.enable_slo()
        mon = telemetry.Monitor(OBS_MONITOR_MS, lambda infos: None,
                                device=device)
        mon.start()
        try:
            # the first profiled q5 compiles its tapped program
            t0 = time.perf_counter()
            plane_query(obs, "q5_first", q5, device, slo=False)
            res["on_first_s"] = time.perf_counter() - t0
            flag_on, fprof, _frecs, _ = plane_query(obs, "flagship", flag,
                                                    device)
            q5_on, qprof, qrecs, _ = plane_query(obs, "q5", q5, device)
            res["flagship_ms"]["on"] = wall_ms(
                lambda: plane_query(obs, "flagship", flag, device),
                STEP_ITERS, device)
            res["q5_ms"]["on"] = wall_ms(
                lambda: plane_query(obs, "q5", q5, device), STEP_ITERS,
                device)
            res["slo_alerts"] = obs.evaluate_slo()
        finally:
            mon.stop()
        obs.TIMESERIES.tick()              # close the last window
        keep_json_for_tools(obs.timeseries_snapshot(rank=0, epoch=0),
                            "plane", "timeseries_rank0.json")
    for name, a, b in zip(("murmur3_32", "xxhash64", "rows",
                           "bucket sums"), flag_on, off[0]):
        check(torch.equal(a, b), f"observability_plane: flagship {name} "
              "equal with the plane on")
    same_bytes(q5_on, off[1], "observability_plane: q5 with the plane on")
    stages = [s["stage"] for s in qprof["stages"]]
    check(sorted(stages) == ["q5_finish", "q5_partials"]
          and all(s["calls"] == 1 for s in qprof["stages"]),
          f"observability_plane: q5's profile holds each stage ({stages})")
    check(fprof["stages"] == [] and fprof["wall_ns"] > 0,
          "observability_plane: the flagship's profile")
    res["ledger"] = {"flagship": plane_ledger(fprof, "flagship"),
                     "q5": plane_ledger(qprof, "q5")}
    # the critical path over the query's spans covers its wall
    (root,) = [r for r in qrecs if r["parent_id"] is None]
    cp = critical_path({0: qrecs})
    cover = cp["total_ns"] / max(root["dur_ns"], 1)
    check(cp["path"] and PLANE_CP_COVER <= cover <= 1.0
          and cp["clamped_edges"] == 0,
          f"observability_plane: q5's critical path covers its wall "
          f"({cover:.3f}: {[p['name'] for p in cp['path']]})")
    res["critical_path"] = {"cover": cover,
                            "path": [p["name"] for p in cp["path"]]}
    # stats: the q5 taps observed the join and the filters
    sec = obs.STATS.last("q5_partials")
    check(sec is not None and any(n["kind"] == "JoinProbe"
                                  for n in sec["nodes"]),
          "observability_plane: q5's stats section")
    # conservation: every counter's windowed deltas sum to the registry
    windows = obs.TIMESERIES.windows()
    check(len(windows) < PLANE_WINDOWS_CAP,
          "observability_plane: no window left the ring")
    snap = obs.METRICS.snapshot()
    counters = 0
    # the sampler counts each window after taking its snapshot, so its
    # own counter is one window ahead of the ring by construction
    check(obs_metric(snap, "srt_timeseries_windows_total") == len(windows),
          "observability_plane: every window counted")
    for fam, body in snap.items():
        if body.get("kind") != "counter" or \
                fam == "srt_timeseries_windows_total":
            continue
        want = {"|".join(str(v) for v in x["labels"]): float(x["value"])
                for x in body["series"] if x["value"]}
        got = {k: v for k, v in sum_counter_windows(windows, fam).items()
               if v}
        check(got == want, f"observability_plane: {fam}'s windows sum "
              f"to its registry value ({got} vs {want})")
        counters += 1
    # every query is one SLI event (an alert is a query past the
    # default 250 ms target: reported, a matter of speed)
    status = obs.SLO.status()[PLANE_TENANT]
    check(status["events"] == 2 + 2 * STEP_ITERS,
          f"observability_plane: the SLO monitor saw every query "
          f"({status})")
    res.update(windows=len(windows), counters_conserved=counters,
               slo=status, spans=len(obs.TRACER),
               journal=len(obs.JOURNAL), dropped=obs.JOURNAL.dropped)
    return res


def plane_cache(device, d5, p5):
    """(b): the stage cache over the q5 pipeline and the incremental
    q5."""
    from spark_rapids_tpu_torch.perf import result_cache as RC
    res = {}
    flat = [d5.s_date, d5.s_store, d5.s_price, d5.s_profit,
            d5.r_date, d5.r_store, d5.r_amt, d5.r_loss, d5.d_date]
    t0 = time.perf_counter()
    RC.data_digest(flat)
    res["digest_ms"] = (time.perf_counter() - t0) * 1e3
    res["digest_bytes"] = sum(t.numel() * t.element_size() for t in flat)
    with env(SPARK_RAPIDS_TPU_RESULT_CACHE="1"):
        RC.CACHE.clear(reset_stats=True)
        RC.reset_ingest_epochs()
        try:
            outs = []
            for tag in ("miss", "hit"):
                before = RC.CACHE.stats()
                t0 = time.perf_counter()
                outs.append(TC.run_q5(d5, p5["stores"],
                                      p5["join_capacity"]))
                sync(device)
                res[f"{tag}_ms"] = (time.perf_counter() - t0) * 1e3
                after = RC.CACHE.stats()
                res[f"{tag}_counts"] = {
                    k: after[k] - before[k]
                    for k in ("hits", "misses", "puts")}
            check(res["miss_counts"] == {"hits": 0, "misses": 2, "puts": 2}
                  and res["hit_counts"] == {"hits": 2, "misses": 0,
                                            "puts": 0},
                  f"observability_plane: the second q5 hit once per "
                  f"stage ({res['miss_counts']}, {res['hit_counts']})")
            same_bytes(outs[1], outs[0],
                       "observability_plane: q5 from the stage cache")
            check(all(o.device.type == torch.device(device).type
                      for o in outs[1]),
                  "observability_plane: cached outputs on the card")
            params = dict(p5, device=device, source=PLANE_STREAM)
            TM.run_catalog_query("tpcds_q5_incremental", dict(params))
            RC.bump_ingest_epoch(PLANE_STREAM)
            RC.bump_ingest_epoch(PLANE_STREAM)
            folds = RC.CACHE.stats()["folds"]
            t0 = time.perf_counter()
            warm = TM.run_catalog_query("tpcds_q5_incremental",
                                        dict(params))
            res["incremental_warm_ms"] = (time.perf_counter() - t0) * 1e3
            res["incremental_folds"] = RC.CACHE.stats()["folds"] - folds
            with env(SPARK_RAPIDS_TPU_RESULT_CACHE="0"):
                t0 = time.perf_counter()
                cold = TM.run_catalog_query("tpcds_q5_incremental",
                                            dict(params))
                res["incremental_cold_ms"] = \
                    (time.perf_counter() - t0) * 1e3
            check(warm == cold and len(warm) > 0,
                  "observability_plane: incremental q5 warm == a cold "
                  "recompute")
            check(res["incremental_folds"] == 2,
                  f"observability_plane: the two new batches folded "
                  f"({res['incremental_folds']})")
            res["cache"] = RC.CACHE.stats()
        finally:
            RC.CACHE.clear(reset_stats=True)
            RC.reset_ingest_epochs()
    return res


def plane_forced_oom_task(device):
    """memory's forced-OOM task with its attempts cut to 2: every attempt
    of its batch reservation meets an injected GpuRetryOOM."""
    adaptor = rmm_spark.set_event_handler(1 << 60)
    try:
        def task():
            rmm_spark.current_thread_is_dedicated_to_task(9)
            rmm_spark.force_retry_oom(rmm_spark.current_thread_id(),
                                      PLANE_TASK_ATTEMPTS + 1)
            try:
                RT.with_retry(adaptor.allocate, 1 << 20,
                              name="task9_batch",
                              policy=RT.RetryPolicy(
                                  max_attempts=PLANE_TASK_ATTEMPTS,
                                  base_backoff_s=0.0))
            except RT.RetryExhausted as e:
                return e.reason, len(e.attempts)
            finally:
                rmm_spark.task_done(9)
            return None, 0

        (out,) = run_task_threads([(task, ())])
        check(out == ("attempts", PLANE_TASK_ATTEMPTS),
              f"observability_plane: the forced-OOM task exhausted its "
              f"{PLANE_TASK_ATTEMPTS} attempts ({out})")
        check(adaptor.resource.used == 0,
              "observability_plane: the task left nothing reserved")
    finally:
        rmm_spark.clear_event_handler()


def plane_incidents(device):
    """(c): the flight recorder armed; a retry_exhausted and a
    kudo_corrupt incident."""
    from spark_rapids_tpu_torch import observability as obs
    out_dir = os.path.join(plane_dir(), "incidents")
    obs.enable_flight_recorder(out_dir=out_dir,
                               max_bytes=PLANE_INCIDENT_BYTES,
                               min_interval_s=0.0)
    try:
        plane_forced_oom_task(device)
        prior = K.set_crc_enabled(True)
        try:
            col = Column(dtypes.INT64, 1 << 16, data=torch.arange(
                1 << 16, dtype=torch.int64, device=device))
            buf = io.BytesIO()
            K.write_to_stream(K.prepare_host_columns([col]), buf, 0,
                              1 << 16)
            raw = bytearray(buf.getvalue())
            raw[-10] ^= 0xFF           # a body bit the KCRC trailer covers
            try:
                K.merge_to_table_with_metrics(
                    K.read_tables(io.BytesIO(bytes(raw))),
                    schema_of_table(Table([col])), device)
                check(False, "observability_plane: a flipped table merged")
            except K.KudoCorruptException:
                pass
        finally:
            K.set_crc_enabled(prior)
    finally:
        obs.disable_flight_recorder()
    listing = json.loads(JE.incident_list())
    kinds = [i["kind"] for i in listing]
    check(sorted(kinds) == ["kudo_corrupt", "retry_exhausted"],
          f"observability_plane: two bundles ({kinds})")
    sizes = {}
    for inc in listing:
        total = 0
        for name in os.listdir(inc["path"]):
            p = os.path.join(inc["path"], name)
            total += os.path.getsize(p)
            with open(p) as f:
                if name.endswith(".jsonl"):
                    [json.loads(line) for line in f if line.strip()]
                else:
                    json.load(f)
        check(inc["total_bytes"] <= total <= PLANE_INCIDENT_BYTES,
              f"observability_plane: {inc['kind']} bundle parses and "
              f"fits its budget ({total} bytes)")
        sizes[inc["kind"]] = total
    health = json.loads(JE.health_json())
    fr = health["flight_recorder"]
    check(fr["bundles_written"] == 2
          and fr["last_trigger"]["kind"] == "kudo_corrupt",
          f"observability_plane: health_json names the bundles ({fr})")
    snap = obs.METRICS.snapshot()
    n = sum(x["value"] for x in snap["srt_incidents_total"]["series"])
    check(n == 2, f"observability_plane: srt_incidents_total {n}")
    return {"kinds": sorted(kinds), "bundle_bytes": sizes}


def observability_plane_phase(device="cuda", q5=None, flagship_rows=None,
                              fusion=None, dist_profiles_res=None):
    """Step 19 (see the module docstring); `fusion` pins q5's engine in
    (a) (None: 'auto')."""
    from spark_rapids_tpu_torch import observability as obs
    clock = time.perf_counter()
    shutil.rmtree(plane_dir(), ignore_errors=True)
    os.makedirs(plane_dir())
    p5 = dict(PLANE_Q5, **(q5 or {}))
    rows = flagship_rows or FLAGSHIP_ROWS
    calib = os.path.join(plane_dir(), "calib.json")
    res = {"q5": p5, "flagship_rows": rows}
    saved = (obs.is_enabled(), obs.is_tracing_enabled())
    obs.disable()
    obs.disable_tracing()
    obs.reset()
    try:
        with env(SPARK_RAPIDS_TPU_CALIB_CACHE=calib,
                 SPARK_RAPIDS_TPU_STATS_STORE=os.path.join(
                     plane_dir(), "stats.json")):
            flag_inputs = F.example_inputs(rows, device=device)
            d5 = TT.gen_q5(rows=p5["rows"], stores=p5["stores"],
                           days=p5["days"], seed=p5["seed"], device=device)
            res["profiled"] = plane_profiled(device, flag_inputs, d5, p5,
                                             fusion)
            for o_off in (obs.disable_profiling, obs.disable_attribution,
                          obs.disable_stats, obs.disable_timeseries,
                          obs.disable_slo, obs.disable_tracing):
                o_off()
            res["stage_cache"] = plane_cache(device, d5, p5)
            res["incidents"] = plane_incidents(device)
        if dist_profiles_res is not None:
            res["dist_profiles"] = dist_profiles_res
    finally:
        for o_off in (obs.disable_profiling, obs.disable_attribution,
                      obs.disable_stats, obs.disable_timeseries,
                      obs.disable_slo, obs.disable_flight_recorder):
            o_off()
        obs.reset()
        (obs.enable if saved[0] else obs.disable)()
        (obs.enable_tracing if saved[1] else obs.disable_tracing)()
        shutil.rmtree(plane_dir(), ignore_errors=True)
    res["phase_s"] = time.perf_counter() - clock
    return res


def run_observability_plane(device="cuda", **kw):
    """Step 19 on the card (see the module docstring)."""
    RA.reset_launches()
    res = observability_plane_phase(device, **kw)
    pr, sc, inc = res["profiled"], res["stage_cache"], res["incidents"]
    line = {
        "flagship_step_ms": pr["flagship_ms"], "q5_ms": pr["q5_ms"],
        "q5_engines": pr["q5_engines"],
        "stage_cache_ms": {k: sc[k] for k in ("miss_ms", "hit_ms",
                                              "digest_ms")},
        "digest_bytes": sc["digest_bytes"],
        "q5_incremental_ms": {"cold": sc["incremental_cold_ms"],
                              "warm": sc["incremental_warm_ms"]},
        "incidents": inc["kinds"], "bundle_bytes": inc["bundle_bytes"],
        "timeseries_windows": pr["windows"],
        "critical_path_cover": pr["critical_path"]["cover"],
        "phase_s": res["phase_s"], "detail": res}
    print(json.dumps({"observability_plane": line}, default=str),
          flush=True)
    return read_launches("observability_plane"), res


# ------------------------------------------------------- step 20: the server

SERVER_TENANTS = ("tenant_a", "tenant_b", "tenant_c", "tenant_d")
SERVER_CONCURRENCY = 3
SERVER_QUEUE = 16
SERVER_SEEDS = (1, 2)
SERVER_WAIT_S = 600.0
# the named queries at the stage path's sizes (step 6): q5 over 2^25 x
# 2^22 rows, 402 stores, its join capacity; q9 and q3 over 2^25 rows;
# q72's 2^22 x 2^21 cut with 204,000 items and its join capacity
SERVER_PARAMS = {
    "tpcds_q5": dict(rows=Q5_DATA["rows"], stores=Q5_DATA["stores"],
                     join_capacity=Q5_CAPACITY),
    "tpcds_q9": dict(rows=Q9_DATA["rows"]),
    "tpcds_q3": dict(rows=Q3_DATA["rows"], items=Q3_DATA["items"],
                     brands=Q3_DATA["brands"],
                     manufact=Q3_PARAMS["manufact"]),
    "tpcds_q72": dict(rows=Q72_DATA["cs_rows"], items=Q72_DATA["items"],
                      max_week=Q72_MAX_WEEK, join_capacity=Q72_CAPACITY),
}
# the phase at a small size (its rehearsal on the CPU and the gpu test):
# the deadline's q5 must outlast the deadline
SERVER_SMALL = {
    "tpcds_q5": dict(rows=1 << 12, stores=16, join_capacity=1 << 13),
    "tpcds_q9": dict(rows=1 << 12),
    "tpcds_q3": dict(rows=1 << 12, items=128, brands=16, manufact=3),
    "tpcds_q72": dict(rows=1 << 11, items=64, max_week=16,
                      join_capacity=1 << 17),
}
SERVER_SMALL_DEADLINE_Q5 = dict(rows=1 << 21, stores=16,
                                join_capacity=1 << 21)
SERVER_FLAGSHIP = "chip_smoke_flagship"
SERVER_OOM = "chip_smoke_oom_once"
SERVER_GATE = "chip_smoke_gate"
SERVER_HANG = "chip_smoke_hang"
SERVER_POISON = "chip_smoke_poison"
SERVER_HANG_S = 2.0
SERVER_WATCHDOG_S = 0.05
SERVER_STALL_MS = 1000
SERVER_QUARANTINE = 2
SERVER_COOLDOWN_S = 0.5
SERVER_DEADLINE_S = 0.2
SERVER_OOM_BYTES = 1 << 20


def server_dir():
    return os.path.join(_BUILD, "server")


def server_mix(device, params=None):
    """(a)'s requests: q5, q9, q3 and q72 at two seeds each, dealt to the
    four tenants in turn."""
    params = params or SERVER_PARAMS
    reqs = []
    for seed in SERVER_SEEDS:
        for name in ("tpcds_q5", "tpcds_q9", "tpcds_q3", "tpcds_q72"):
            reqs.append((SERVER_TENANTS[len(reqs) % len(SERVER_TENANTS)],
                         name, dict(params[name], seed=seed,
                                    device=device)))
    return reqs


def server_config(**kw):
    from spark_rapids_tpu_torch import server as srv
    return srv.ServerConfig(**dict(dict(
        max_queue=SERVER_QUEUE, stall_ms=0, hang_s=0.0,
        quarantine_failures=0, watchdog_interval_s=SERVER_WATCHDOG_S),
        **kw))


def server_poll(J, qid, timeout_s=SERVER_WAIT_S):
    st = json.loads(J.server_poll(qid, timeout_s))
    check(st["state"] not in ("queued", "running"),
          f"server: {qid} finished within {timeout_s} s ({st['state']})")
    return st


def dynamo_graphs():
    """Graphs dynamo has compiled in this process."""
    from torch._dynamo.utils import counters
    return int(counters["stats"]["unique_graphs"])


def server_interleaved(device, mix):
    """(a): the mix through the shim's entries against direct calls."""
    from spark_rapids_tpu_torch import observability as obs
    from spark_rapids_tpu_torch import server as srv
    from spark_rapids_tpu_torch.shim import jni_entry as J
    want, direct_ms = {}, {}
    for _t, name, p in mix:        # the main thread: once per request
        key = (name, json.dumps(p, sort_keys=True))
        if key not in want:
            t0 = time.perf_counter()
            want[key] = TM.run_catalog_query(name, dict(p))
            sync(device)
            direct_ms[key] = (time.perf_counter() - t0) * 1e3
    check(len(want) == len(mix), "server: one direct run a request")
    obs.enable()
    obs.enable_tracing()
    obs.enable_slo()
    obs.enable_profiling()
    obs.reset()
    with env(SPARK_RAPIDS_TPU_SERVER_STALL_MS="0"):
        check(J.server_start(SERVER_CONCURRENCY, SERVER_QUEUE),
              "server: server_start created the server")
    check(not J.server_start(), "server: server_start is idempotent")
    for t in SERVER_TENANTS:
        J.server_set_tenant_quota(t, max_inflight=4)
    t0 = time.perf_counter()
    ids = []
    for t, name, p in mix:
        resp = json.loads(J.server_submit(t, name, json.dumps(p)))
        check(resp["ok"], f"server: {t} {name} admitted ({resp})")
        ids.append(resp["query_id"])
    out = [server_poll(J, qid) for qid in ids]
    served_s = time.perf_counter() - t0
    for (t, name, p), st in zip(mix, out):
        key = (name, json.dumps(p, sort_keys=True))
        check(st["state"] == "done" and st["outcome"] == "success",
              f"server: {t} {name} seed {p['seed']} succeeded ({st})")
        check(st["result"] == want[key],
              f"server: {t} {name} seed {p['seed']} == the direct call")
    stats = json.loads(J.server_stats_json())
    for t in SERVER_TENANTS:
        n = sum(1 for tt, _n, _p in mix if tt == t)
        row = stats["tenants"][t]
        check(row["admitted"] == n and row["success"] == n
              and row["rejected"] == 0 and row["running"] == 0
              and row["queued"] == 0,
              f"server: {t}'s stats count its {n} requests ({row})")
    check({e["tenant"] for e in obs.JOURNAL.records("server_admit")}
          == set(SERVER_TENANTS)
          and {e["tenant"] for e in obs.JOURNAL.records("server_complete")}
          == set(SERVER_TENANTS),
          "server: server_admit and server_complete for every tenant")
    spans = [r for r in obs.TRACER.records()
             if r["name"].startswith("server_query:")]
    check(len(spans) == len(mix) and len(
        {r["attrs"]["server_task_id"] for r in spans}) == len(mix),
        "server: one server_query span a request, distinct task ids")
    text = obs.expose_text()
    for family in ("srt_server_admitted_total", "srt_server_completed_total",
                   "srt_server_queue_wait_ns", "srt_server_running"):
        check(family in text, f"server: {family} in the exposition")
    slo = obs.SLO.status()
    check(sum(v["events"] for v in slo.values()) == len(mix),
          f"server: one SLO event a completion ({slo})")
    obs.disable_slo()     # (d)'s deaths must not fire a burn alert
    prof = json.loads(J.server_profile_json(ids[0]))
    check(prof["ok"] and prof["profile"]["query_id"] == ids[0],
          "server: server_profile_json returns the retained profile")
    q5 = [i for i, (_t, n, _p) in enumerate(mix) if n == "tpcds_q5"][0]
    key5 = (mix[q5][1], json.dumps(mix[q5][2], sort_keys=True))
    served = [st["dur_ns"] / 1e6 for st in out]
    waits = [st["wait_ns"] / 1e6 for st in out]
    return {"requests": len(mix), "served_s": served_s,
            "request_ms": {"median": float(np.median(served)),
                           "max": max(served)},
            "queue_wait_ms": {"median": float(np.median(waits)),
                              "max": max(waits)},
            "q5_server_ms": served[q5], "q5_direct_ms": direct_ms[key5],
            "q5_over_direct": served[q5] / direct_ms[key5],
            "slo_events": sum(v["events"] for v in slo.values()),
            "ids": ids, "want": want}


def server_flagship(device, rows):
    """(b): the flagship step served as a registered query from two pool
    threads; the rows must equal the main thread's, one to-rows launch a
    request."""
    from spark_rapids_tpu_torch import server as srv
    inputs = F.example_inputs(rows, device=device)
    want = F.flagship_step(*inputs)[2]
    sync(device)
    kept = {}

    def run(params, ctx):
        ctx.check_cancel()
        out = F.flagship_step(*inputs)[2]
        sync(device)
        kept[ctx.query_id] = out
        return {"rows_bytes": int(out.numel())}

    TM.register_query(SERVER_FLAGSHIP, run)
    try:
        s = srv.get_server()
        before = RA.LAUNCHES["to_rows"]
        ids = [s.submit(t, SERVER_FLAGSHIP, {}) for t in SERVER_TENANTS[:2]]
        for qid in ids:
            st = s.wait(qid, SERVER_WAIT_S)
            check(st["state"] == "done",
                  f"server: flagship {qid} succeeded ({st})")
            check(torch.equal(kept[qid], want),
                  f"server: flagship {qid}'s rows == the main thread's")
        launched = RA.LAUNCHES["to_rows"] - before
        if torch.device(device).type == "cuda":
            check(launched == len(ids),
                  f"server: one to-rows launch a request ({launched})")
    finally:
        TM.unregister_query(SERVER_FLAGSHIP)
    return {"requests": len(ids), "to_rows_launches": launched}


def gate_runner(gate, started):
    def run(params, ctx):
        started.append(ctx.query_id)
        while not gate.wait(0.01):
            ctx.check_cancel()
        ctx.check_cancel()
        return ["done"]
    return run


def server_backpressure(device, q9_rows):
    """(c): typed refusals and the load-shedding requeue."""
    from spark_rapids_tpu_torch import server as srv
    gate, started = threading.Event(), []
    TM.register_query(SERVER_GATE, gate_runner(gate, started))
    s = srv.QueryServer(server_config(max_concurrency=1, max_queue=2))
    s.start()
    res = {}
    try:
        first = s.submit("tenant_a", SERVER_GATE)
        check(wait_until(lambda: len(started) == 1),
              "server: the gated query started")
        s.set_tenant_quota("tenant_b", max_inflight=1)
        s.submit("tenant_b", SERVER_GATE)
        try:
            s.submit("tenant_b", SERVER_GATE)
            check(False, "server: tenant_b's second submit was refused")
        except srv.ServerOverloaded as e:
            check(e.reason == "tenant_inflight",
                  f"server: refused as tenant_inflight ({e.reason})")
        s.submit("tenant_c", SERVER_GATE)   # the queue is full now
        try:
            s.submit("tenant_d", SERVER_GATE)
            check(False, "server: a submit past max_queue was refused")
        except srv.ServerOverloaded as e:
            check(e.reason == "queue_full" and e.retry_after_s > 0,
                  f"server: refused as queue_full ({e.to_dict()})")
        gate.set()
        check(s.wait(first, SERVER_WAIT_S)["state"] == "done",
              "server: the gated queries finish after the gate opens")
        st = s.stats()["tenants"]
        check(st["tenant_b"]["rejected"] == 1
              and st["tenant_d"]["rejected"] == 1
              and st["tenant_c"]["rejected"] == 0,
              f"server: only the refused tenants count rejects ({st})")
        res["rejects"] = sum(r["rejected"] for r in st.values())
    finally:
        gate.set()
        s.stop()
        TM.unregister_query(SERVER_GATE)

    adaptor = rmm_spark.set_event_handler(1 << 60)
    attempts = []

    def oom_once(params, ctx):
        attempts.append(ctx.query_id)
        if len(attempts) == 1:
            rmm_spark.force_retry_oom(rmm_spark.current_thread_id(), 1)
        adaptor.allocate(SERVER_OOM_BYTES)   # the first attempt's OOMs
        try:
            return TM.run_catalog_query(
                "tpcds_q9", {"rows": q9_rows, "device": device})
        finally:
            adaptor.deallocate(SERVER_OOM_BYTES)

    TM.register_query(SERVER_OOM, oom_once)
    s = srv.QueryServer(server_config(max_concurrency=1, max_requeues=1))
    s.start()
    try:
        qid = s.submit("tenant_a", SERVER_OOM)
        job = s._jobs[qid]
        p0 = job.priority
        st = s.wait(qid, SERVER_WAIT_S)
        want = TM.run_catalog_query("tpcds_q9",
                                    {"rows": q9_rows, "device": device})
        check(st["state"] == "done" and st["demotions"] == 1
              and st["result"] == want and len(attempts) == 2,
              f"server: the OOMed query was requeued once and then "
              f"succeeded ({st.get('state')}, {len(attempts)} attempts)")
        check(job.priority < p0,
              f"server: the requeue landed a lower task priority "
              f"({job.priority} < {p0})")
        check(s.stats()["tenants"]["tenant_a"]["requeued"] == 1,
              "server: the requeue is counted")
        check(adaptor.resource.used == 0, "server: nothing left reserved")
        res["requeues"] = 1
    finally:
        s.stop()
        TM.unregister_query(SERVER_OOM)
        rmm_spark.clear_event_handler()
    return res


def incident_kinds(out_dir):
    """The trigger kind of every finished bundle under `out_dir`."""
    kinds = []
    for name in sorted(os.listdir(out_dir)):
        if name.startswith("incident-"):
            with open(os.path.join(out_dir, name, "trigger.json")) as f:
                kinds.append(json.load(f)["kind"])
    return kinds


def wait_until(pred, timeout_s=60.0):
    end = time.monotonic() + timeout_s
    while time.monotonic() < end:
        if pred():
            return True
        time.sleep(0.01)
    return False


def server_lifeguard(device, q5, q9_rows):
    """(d): a deadline, a hung worker, a stall and a poison query."""
    from spark_rapids_tpu_torch import observability as obs
    from spark_rapids_tpu_torch import server as srv
    res = {}
    # a running q5 past its deadline is cancelled cooperatively
    s = srv.QueryServer(server_config(max_concurrency=1))
    s.start()
    try:
        qid = s.submit("tenant_a", "tpcds_q5", dict(q5),
                       deadline_s=SERVER_DEADLINE_S)
        st = s.wait(qid, SERVER_WAIT_S)
        check(st["state"] == "failed" and st["outcome"] == "deadline"
              and st["error"]["reason"] == "deadline"
              and st.get("cancel_reason") == "deadline",
              f"server: q5 past its deadline cancelled ({st})")
        acts = [e["action"] for e in obs.JOURNAL.records("server_watchdog")
                if e["query_id"] == qid]
        check(acts == ["deadline_cancel"],
              f"server: the watchdog fired the deadline cancel ({acts})")
        res["deadline_ms"] = st["dur_ns"] / 1e6
    finally:
        s.stop()

    # a silent runner is declared hung and force-released; its neighbour
    # waits past the stall bar behind it and finishes on the replacement
    inc_dir = os.path.join(server_dir(), "incidents")
    obs.enable_flight_recorder(out_dir=inc_dir, min_interval_s=0.0)
    adaptor = rmm_spark.set_event_handler(1 << 60)
    release, entered = threading.Event(), threading.Event()

    def hang(params, ctx):
        adaptor.allocate(4096)
        entered.set()
        release.wait(SERVER_WAIT_S)        # silent: no beat, no poll
        return ["late"]

    TM.register_query(SERVER_HANG, hang)
    s = srv.QueryServer(server_config(
        max_concurrency=1, hang_s=SERVER_HANG_S, stall_ms=SERVER_STALL_MS))
    s.start()
    try:
        mem0 = allocated(device)
        hung = s.submit("tenant_b", SERVER_HANG)
        check(entered.wait(SERVER_WAIT_S), "server: the hung query started")
        neighbour = s.submit("tenant_c", "tpcds_q9",
                             {"rows": q9_rows, "device": device})
        st = s.wait(hung, SERVER_WAIT_S)
        check(st["state"] == "failed" and st["outcome"] == "hung"
              and st["error"]["type"] == "QueryHung" and st.get("hung"),
              f"server: the silent worker was declared hung ({st})")
        nb = s.wait(neighbour, SERVER_WAIT_S)
        check(nb["state"] == "done" and nb["result"]
              == TM.run_catalog_query("tpcds_q9", {"rows": q9_rows,
                                                   "device": device}),
              f"server: the neighbour finished on the replacement ({nb})")
        check(nb["wait_ns"] > SERVER_STALL_MS * 1e6,
              "server: the neighbour waited past the stall bar")
        rels = [e for e in obs.JOURNAL.records("server_watchdog")
                if e["action"] == "hang_release"]
        check(len(rels) == 1 and rels[0]["query_id"] == hung,
              f"server: one hang_release ({rels})")
        check(not any(t["pool_tasks"] for t in adaptor.thread_state_dump()),
              "server: the hung task was force-released")
        check(any("FORCE_RELEASE" in row for row in adaptor.get_log()),
              "server: the force release is in the adaptor's log")
        res["hang"] = {"silent_ms": rels[0]["silent_ms"],
                       "memory_allocated": [mem0, allocated(device)]}
        release.set()
        check(wait_until(lambda: s.stats()["lifeguard"]["orphaned_workers"]
                         == 0),
              "server: the orphaned worker exits when it wakes")
        kinds = sorted(incident_kinds(inc_dir))
        check(kinds == ["admission_stall", "query_hang"],
              f"server: query_hang and admission_stall bundles ({kinds})")
        res["incidents"] = kinds
        res["watchdog_actions"] = len(obs.JOURNAL.records("server_watchdog"))
        keep_for_tools(inc_dir, "server", "incidents")
    finally:
        release.set()
        s.stop()
        TM.unregister_query(SERVER_HANG)
        rmm_spark.clear_event_handler()
        obs.disable_flight_recorder()

    # a poison query is quarantined; a probe after the cooldown readmits it
    healthy = {"on": False}

    def poison(params, ctx):
        if not healthy["on"]:
            raise RuntimeError("poison query")
        return TM.run_catalog_query("tpcds_q9", {"rows": q9_rows,
                                                 "device": device})

    TM.register_query(SERVER_POISON, poison)
    s = srv.QueryServer(server_config(
        max_concurrency=1, quarantine_failures=SERVER_QUARANTINE,
        quarantine_cooldown_s=SERVER_COOLDOWN_S))
    s.start()
    try:
        for _ in range(SERVER_QUARANTINE):
            st = s.wait(s.submit("tenant_d", SERVER_POISON), SERVER_WAIT_S)
            check(st["outcome"] == "failed", f"server: poison failed ({st})")
        try:
            s.submit("tenant_d", SERVER_POISON)
            check(False, "server: the quarantined query was refused")
        except srv.ServerOverloaded as e:
            check(e.reason == "quarantined" and e.retry_after_s > 0,
                  f"server: refused as quarantined ({e.to_dict()})")
        healthy["on"] = True
        time.sleep(SERVER_COOLDOWN_S * 1.2)
        st = s.wait(s.submit("tenant_d", SERVER_POISON), SERVER_WAIT_S)
        check(st["outcome"] == "success", f"server: the probe passed ({st})")
        check(s.stats()["lifeguard"]["quarantine"]["quarantined"] == {},
              "server: the probe closed the circuit")
        events = [e["event"]
                  for e in obs.JOURNAL.records("server_quarantine")]
        check(events == ["opened", "rejected", "probe", "closed"],
              f"server: the breaker's transitions ({events})")
        res["quarantine_events"] = events
    finally:
        s.stop()
        TM.unregister_query(SERVER_POISON)
    return res


def server_socket_and_drain(device, mix, want, q9_rows):
    """(e): the socket door and the drain, then a warm restart."""
    import socket as socket_mod
    from spark_rapids_tpu_torch import server as srv
    from spark_rapids_tpu_torch.shim import jni_entry as J
    res = {}
    path = os.path.join(server_dir(), "server.sock")
    check(not J.server_start(socket_path=path),
          "server: the running server gained the socket door")
    t, name, p = [r for r in mix if r[1] == "tpcds_q5"][0]
    conn = socket_mod.socket(socket_mod.AF_UNIX, socket_mod.SOCK_STREAM)
    conn.connect(path)
    f = conn.makefile("rwb")

    def rpc(req):
        f.write(json.dumps(req).encode() + b"\n")
        f.flush()
        return json.loads(f.readline())

    t0 = time.perf_counter()
    sub = rpc({"op": "submit", "tenant": t, "query": name, "params": p})
    st = rpc({"op": "poll", "query_id": sub.get("query_id"),
              "timeout_s": SERVER_WAIT_S})
    res["socket_round_trip_ms"] = (time.perf_counter() - t0) * 1e3
    check(sub["ok"] and st["ok"] and st["status"]["state"] == "done"
          and st["status"]["result"]
          == want[(name, json.dumps(p, sort_keys=True))],
          "server: q5 over the socket == (a)'s rows")
    conn.close()

    # drain with a q5 and a gated query in flight: the gate holds the
    # drain open while a new submit is refused, then both finish
    gate, started = threading.Event(), []
    TM.register_query(SERVER_GATE, gate_runner(gate, started))
    served = srv.get_server()
    try:
        qids = []
        for q, qp in ((name, p), (SERVER_GATE, {})):
            resp = json.loads(J.server_submit(t, q, json.dumps(qp)))
            check(resp["ok"], f"server: in-flight {q} admitted ({resp})")
            qids.append(resp["query_id"])
        check(wait_until(lambda: len(started) == 1),
              "server: the gated query started")
        box = {}
        drainer = threading.Thread(target=lambda: box.setdefault(
            "r", json.loads(J.server_drain(SERVER_WAIT_S, os.path.join(
                server_dir(), "drain")))))
        drainer.start()
        check(wait_until(lambda: srv.get_server()._draining),
              "server: the drain began")
        late = json.loads(J.server_submit(t, "tpcds_q9", json.dumps(
            {"rows": q9_rows, "device": device})))
        check(not late["ok"] and late["error"]["reason"] == "draining",
              f"server: a submit during the drain was refused ({late})")
        gate.set()
        drainer.join(SERVER_WAIT_S)
    finally:
        gate.set()
        TM.unregister_query(SERVER_GATE)
    rep = box["r"]
    check(rep["state"] == "drained" and rep["in_flight"] >= 1
          and rep["completed"] == rep["in_flight"] and rep["cancelled"] == 0
          and rep["abandoned"] == 0,
          f"server: the drain finished the in-flight work ({rep})")
    st = served.poll(qids[0])
    check(st["state"] == "done" and st["result"]
          == want[(name, json.dumps(p, sort_keys=True))],
          "server: the q5 submitted before the drain == (a)'s rows")
    for fn in ("journal.jsonl", "spans.jsonl", "metrics.json"):
        check(os.path.isfile(os.path.join(rep["flush"]["dir"], fn)),
              f"server: the drain wrote {fn}")
    keep_for_tools(rep["flush"]["dir"], "server", "drain")
    check(srv.get_server() is None and not os.path.exists(path),
          "server: the drain cleared the singleton and its door")
    res["drain"] = {k: rep[k] for k in ("in_flight", "completed",
                                        "cancelled", "abandoned",
                                        "duration_s")}
    res["drain"].update(journal_records=rep["flush"]["journal_records"],
                        span_records=rep["flush"]["span_records"])
    # a warm restart serves q9 again without compiling anything
    graphs = dynamo_graphs()
    with env(SPARK_RAPIDS_TPU_SERVER_STALL_MS="0"):
        check(J.server_start(1, SERVER_QUEUE), "server: restarted")
    q9 = [r for r in mix if r[1] == "tpcds_q9"][0]
    resp = json.loads(J.server_submit(q9[0], q9[1], json.dumps(q9[2])))
    st = server_poll(J, resp["query_id"])
    check(st["state"] == "done" and st["result"]
          == want[(q9[1], json.dumps(q9[2], sort_keys=True))],
          "server: q9 after the restart == (a)'s rows")
    check(dynamo_graphs() == graphs, "server: the restart compiled nothing")
    J.server_stop()
    return res


def server_plan_verify(verify_calls):
    """(f): every plan compiled so far verified exactly once; a malformed
    plan refused before it compiles."""
    from spark_rapids_tpu_torch.analysis import plan_verify as PV
    from spark_rapids_tpu_torch.plan import compiler as PC
    from spark_rapids_tpu_torch.plan import ir
    if verify_calls is not None:
        check(verify_calls and max(verify_calls.values()) == 1
              and len(PC._VERIFIED) == len(verify_calls),
              f"server: each plan digest verified once "
              f"({len(verify_calls)} digests, {len(PC._VERIFIED)} memo)")
    check(set(PC._STAGE_MEMO) <= set(PC._VERIFIED),
          "server: every compiled stage was verified")
    bad = ir.StagePlan(
        "chip_smoke_bad_where",
        inputs=(ir.ScanBind("f", (ir.ColSpec("x"),)),),
        nodes=(ir.Project("y", ir.Where(ir.Col("x"), ir.Col("x"),
                                        ir.Lit(0))),),
        outputs=("y",))
    try:
        PV.verify_stage(bad, input_dtypes={"f": ("int64",)})
        check(False, "server: a Where over int64 was refused")
    except PV.PlanVerifyError as e:
        check("expected bool" in str(e), f"server: {e}")
    unbound = ir.StagePlan(
        "chip_smoke_unbound",
        inputs=(ir.ScanBind("f", (ir.ColSpec("x"),)),),
        nodes=(ir.Project("y", ir.Col("ghost")),), outputs=("y",))
    graphs, memo = dynamo_graphs(), len(PC._STAGE_MEMO)
    try:
        PC.compile_stage(unbound)
        check(False, "server: an unbound plan was refused")
    except PV.PlanVerifyError as e:
        check("ghost" in str(e), f"server: {e}")
    check(dynamo_graphs() == graphs and len(PC._STAGE_MEMO) == memo,
          "server: the refused plan compiled nothing")
    return {"verified_digests": len(PC._VERIFIED)}


def count_plan_verifications():
    """Counts, per digest, the compiler's plan verifications (calls of
    plan/compiler._verify_once that miss its memo) from here on."""
    from spark_rapids_tpu_torch.plan import compiler as PC
    calls = {}
    real = PC._verify_once

    def counted(plan_or_pipeline):
        if plan_or_pipeline.digest not in PC._VERIFIED:
            d = plan_or_pipeline.digest
            calls[d] = calls.get(d, 0) + 1
        return real(plan_or_pipeline)

    PC._verify_once = counted
    return calls


def server_phase(device="cuda", params=None, flagship_rows=None,
                 q9_rows=1 << 20, deadline_q5=None, verify_calls=None):
    """Step 20 (see the module docstring)."""
    from spark_rapids_tpu_torch import observability as obs
    from spark_rapids_tpu_torch import server as srv
    clock = time.perf_counter()
    shutil.rmtree(server_dir(), ignore_errors=True)
    os.makedirs(server_dir())
    saved = (obs.is_enabled(), obs.is_tracing_enabled())
    mix = server_mix(device, params)
    graphs = dynamo_graphs()
    res = {}
    try:
        a = server_interleaved(device, mix)
        want = a.pop("want")
        a.pop("ids")
        res["interleaved"] = a
        res["flagship"] = server_flagship(device,
                                          flagship_rows or FLAGSHIP_ROWS)
        res["backpressure"] = server_backpressure(device, q9_rows)
        q5 = deadline_q5 or [p for _t, n, p in mix if n == "tpcds_q5"][0]
        res["lifeguard"] = server_lifeguard(device, dict(q5, device=device),
                                            q9_rows)
        res["socket_drain"] = server_socket_and_drain(device, mix, want,
                                                      q9_rows)
        res["plan_verify"] = server_plan_verify(verify_calls)
        res["dynamo_graphs_added"] = dynamo_graphs() - graphs
        check(res["dynamo_graphs_added"] == 0,
              "server: the phase compiled no graph")
    finally:
        srv.stop_server()
        for off in (obs.disable_profiling, obs.disable_slo,
                    obs.disable_flight_recorder):
            off()
        obs.reset()
        (obs.enable if saved[0] else obs.disable)()
        (obs.enable_tracing if saved[1] else obs.disable_tracing)()
        shutil.rmtree(server_dir(), ignore_errors=True)
    res["phase_s"] = time.perf_counter() - clock
    return res


def run_server(device="cuda", **kw):
    """Step 20 on the card (see the module docstring)."""
    RA.reset_launches()
    res = server_phase(device, **kw)
    a, lg = res["interleaved"], res["lifeguard"]
    line = {
        "request_ms": a["request_ms"], "queue_wait_ms": a["queue_wait_ms"],
        "q5_server_ms": a["q5_server_ms"], "q5_direct_ms": a["q5_direct_ms"],
        "q5_over_direct": a["q5_over_direct"],
        "rejects": res["backpressure"]["rejects"],
        "requeues": res["backpressure"]["requeues"],
        "watchdog_actions": lg["watchdog_actions"],
        "quarantine_events": len(lg["quarantine_events"]),
        "drain": res["socket_drain"]["drain"],
        "socket_round_trip_ms": res["socket_drain"]["socket_round_trip_ms"],
        "phase_s": res["phase_s"], "detail": res}
    print(json.dumps({"server": line}, default=str), flush=True)
    return read_launches("server"), res


# ------------------------------------------------------- step 21: tools

TOOLS_ITERS = 5
TOOLS_RETRY_ATTEMPTS = 3
TOOLS_TASK = 2101
TOOLS_FAULT_SEED = 21
TOOLS_OPS = ("murmur3_32", "xxhash64", "convert_to_rows")


def tools_dir():
    return os.path.join(_BUILD, "tools")


def keep_for_tools(src, *rel):
    """Copy a file or directory an earlier phase writes (and removes at
    its end) to build/tools/<rel>, for step 21's tools to read."""
    dst = os.path.join(tools_dir(), *rel)
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    if os.path.isdir(src):
        shutil.copytree(src, dst, dirs_exist_ok=True)
    else:
        shutil.copyfile(src, dst)
    return dst


def keep_json_for_tools(obj, *rel):
    dst = os.path.join(tools_dir(), *rel)
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    with open(dst, "w") as f:
        f.write(json.dumps(obj, sort_keys=True))
    return dst


def run_tool(tool, argv):
    """(exit code, stdout, seconds) of the port's tool's main(argv), as
    ``python -m spark_rapids_tpu_torch.tools.<tool>`` runs it, in this
    process (no interpreter start-up per tool)."""
    import importlib
    mod = importlib.import_module(f"spark_rapids_tpu_torch.tools.{tool}")
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        try:
            rc = mod.main(list(argv))
        except SystemExit as e:
            rc = e.code
    return rc, out.getvalue(), time.perf_counter() - t0


def same_flagship(out, want):
    for name, got, w in zip(("murmur3_32", "xxhash64", "rows",
                             "bucket sums"), out, want):
        check(torch.equal(got, w), f"tools: flagship {name} unchanged "
              "with the sidecars on")


def tools_mode(device, inputs, want, adaptor=None):
    """The flagship step's median wall ms over TOOLS_ITERS steps (each
    synchronized; its outputs held to `want` outside the timed span)
    and the to-rows kernel's launches over them.  Under `adaptor` each
    step's task reserves its rows' bytes first and frees them after,
    as an executor task does."""
    held = nbytes(want[2]) if adaptor is not None else 0
    before = RA.LAUNCHES["to_rows"]
    times = []
    for _ in range(TOOLS_ITERS):
        t0 = time.perf_counter()
        if held:
            adaptor.allocate(held)
        out = F.flagship_step(*inputs)
        sync(device)
        if held:
            adaptor.deallocate(held)
        times.append((time.perf_counter() - t0) * 1e3)
        same_flagship(out, want)
    launches = RA.LAUNCHES["to_rows"] - before
    if torch.device(device).type == "cuda":
        check(launches == TOOLS_ITERS, f"tools: the to-rows kernel "
              f"launched once a step ({launches} in {TOOLS_ITERS})")
    return sorted(times)[len(times) // 2], TOOLS_ITERS, launches


def tools_sidecars(device, rows):
    """(a): the flagship step with every sidecar off, with the profiler
    streaming (alloc capture on, a task's reservation under an adaptor)
    and with tracing on; then the profile converter over the stream."""
    from spark_rapids_tpu_torch import observability as obs
    from spark_rapids_tpu_torch.tools import profile_converter as PCV
    from spark_rapids_tpu_torch.utils import fault_injection as FI
    from spark_rapids_tpu_torch.utils import profiler as PROF
    from spark_rapids_tpu_torch.utils import tracing as TRC
    inputs = F.example_inputs(rows, device=device)
    want = F.flagship_step(*inputs)
    sync(device)
    res = {"ms": {}, "launches": {}}
    check(FI.installed() is None and PROF.Profiler.get() is None
          and TRC.sidecars_off(), "tools: every sidecar off")
    res["ms"]["off"], _, res["launches"]["off"] = tools_mode(
        device, inputs, want)
    # the full bracket with nothing recording, as under an attached
    # NVTX tool: what the sidecars-off shortcut saves
    tool, PROF.NVTX_TOOL = PROF.NVTX_TOOL, True
    try:
        check(not TRC.sidecars_off(), "tools: the bracket forced open")
        res["ms"]["bracket"], _, res["launches"]["bracket"] = tools_mode(
            device, inputs, want)
    finally:
        PROF.NVTX_TOOL = tool
    # the profiler, streaming to a file through the JNI door
    stream = os.path.join(tools_dir(), "sidecars.bin")
    adaptor = rmm_spark.set_event_handler(1 << 60)
    rmm_spark.current_thread_is_dedicated_to_task(TOOLS_TASK)
    JE.profiler_init(stream, 0, True)
    try:
        JE.profiler_start()
        res["ms"]["profiler"], psteps, res["launches"]["profiler"] = \
            tools_mode(device, inputs, want, adaptor)
        JE.profiler_stop()
    finally:
        JE.profiler_shutdown()
        rmm_spark.remove_current_thread_association()
        rmm_spark.clear_event_handler()
    with open(stream, "rb") as f:
        records = list(PROF.iter_records(f.read()))
    ops = {}
    for r in records:
        if r["kind"] == "op_range":
            ops[r["name"]] = ops.get(r["name"], 0) + 1
    check(ops == {name: psteps for name in TOOLS_OPS},
          f"tools: one op range each a step ({ops} in {psteps} steps)")
    allocs = {k: sum(1 for r in records if r["kind"] == k)
              for k in ("alloc", "free")}
    check(allocs == {"alloc": psteps, "free": psteps},
          f"tools: the task's reservations recorded ({allocs})")
    # the converter over the stream: its calls equal the op calls
    rows_ = PCV.summarize(PCV.load_records([stream]))
    check({r["op"]: r["calls"] for r in rows_} == ops,
          f"tools: profile_converter's calls == the op calls ({rows_})")
    chrome = os.path.join(tools_dir(), "sidecars_chrome.json")
    rc, text, secs = run_tool("profile_converter",
                              [stream, "--chrome", chrome, "--summary"])
    with open(chrome) as f:
        xs = [e for e in json.load(f)["traceEvents"] if e["ph"] == "X"]
    check(rc == 0 and len(xs) == sum(ops.values())
          and f"allocs: {psteps}" in text,
          f"tools: profile_converter --chrome --summary ({rc}, "
          f"{len(xs)} ranges)")
    res["profile_converter_s"] = secs
    # tracing on: one op span each a step
    obs.reset()
    obs.enable_tracing()
    try:
        res["ms"]["tracing"], tsteps, res["launches"]["tracing"] = \
            tools_mode(device, inputs, want)
        spans = [r for r in obs.TRACER.records() if r["span_kind"] == "op"]
    finally:
        obs.disable_tracing()
        obs.reset()
    names = sorted(r["name"] for r in spans)
    check(names == sorted(list(TOOLS_OPS) * tsteps),
          f"tools: one op span each a step ({len(names)} in {tsteps})")
    check(TRC.sidecars_off(), "tools: every sidecar off again")
    res["ms"]["off_after"] = tools_mode(device, inputs, want)[0]
    res["op_ranges"] = ops
    res["allocs"] = allocs
    return res, inputs, want


def tools_faults(device, inputs, want):
    """(b): a seeded GpuRetryOOM rule on convert_to_rows exhausts the
    retried flagship step and freezes one retry_exhausted bundle the
    doctor ranks; after uninstall the step runs; a CudfException rule on
    a door export raises typed at the door."""
    from spark_rapids_tpu_torch import observability as obs
    from spark_rapids_tpu_torch.memory import exceptions as EXC
    from spark_rapids_tpu_torch.utils import fault_injection as FI
    res = {}
    rules = keep_json_for_tools({"seed": TOOLS_FAULT_SEED, "faults": [
        {"match": "convert_to_rows", "exception": "GpuRetryOOM"}]},
        "faults_retry.json")
    inc = os.path.join(tools_dir(), "incidents")
    held = nbytes(want[2])
    obs.enable()
    obs.enable_flight_recorder(out_dir=inc, min_interval_s=0.0)
    adaptor = rmm_spark.set_event_handler(1 << 60)
    rmm_spark.current_thread_is_dedicated_to_task(TOOLS_TASK)
    adaptor.allocate(held)
    FI.install(rules, watch=False)
    try:
        try:
            RT.with_retry(lambda: F.flagship_step(*inputs),
                          name="flagship_step", policy=RT.RetryPolicy(
                              max_attempts=TOOLS_RETRY_ATTEMPTS,
                              base_backoff_s=0.0, jitter=False))
            check(False, "tools: the injected rule exhausted the retries")
        except RT.RetryExhausted as e:
            check(e.reason == "attempts" and isinstance(
                e.last, EXC.GpuRetryOOM),
                f"tools: exhausted by the injected GpuRetryOOM ({e})")
    finally:
        FI.uninstall()
        adaptor.deallocate(held)
        rmm_spark.remove_current_thread_association()
        rmm_spark.clear_event_handler()
        obs.disable_flight_recorder()
        obs.disable()
        obs.reset()
    bundles = sorted(os.path.join(inc, n) for n in os.listdir(inc)
                     if n.startswith("incident-"))
    check(len(bundles) == 1, f"tools: one bundle ({bundles})")
    with open(os.path.join(bundles[0], "trigger.json")) as f:
        kind = json.load(f)["kind"]
    with open(os.path.join(bundles[0], "fault_rules.json")) as f:
        frozen = json.load(f)
    check(kind == "retry_exhausted" and frozen == [
        {"match": "convert_to_rows", "probability": 1.0, "remaining": -1,
         "exception": "GpuRetryOOM"}],
        f"tools: a retry_exhausted bundle holding the rule ({kind}, "
        f"{frozen})")
    rc, text, secs = run_tool("doctor", [bundles[0], "--json"])
    findings = json.loads(text)["findings"]
    top = findings[0]
    check(rc == 0 and top["kind"] == "fault_injection"
          and top["severity"] == 95
          and "match='convert_to_rows'" in top["message"],
          f"tools: doctor ranks the injected rule first ({top})")
    exhausted = [f for f in findings if f["kind"] == "retry_exhausted"]
    check(exhausted and f"task {TOOLS_TASK}" in exhausted[0]["message"]
          and "held" in exhausted[0]["message"],
          f"tools: doctor names the task holding device memory "
          f"({exhausted})")
    res.update(bundles=1, doctor_first=top, doctor_s=secs,
               exhausted=exhausted[0]["message"])
    # uninstalled: the same step runs, byte-equal
    same_flagship(F.flagship_step(*inputs), want)
    # a CudfException rule on a door export raises typed at the door
    door = keep_json_for_tools({"faults": [
        {"match": "murmur3_32", "repeat": 1,
         "exception": "CudfException"}]}, "faults_door.json")
    col = Column(dtypes.INT64, int(inputs[0].shape[0]), data=inputs[0])
    h = REGISTRY.register(col)
    FI.install(door, watch=False)
    try:
        try:
            jni_api.murmur_hash3_32(42, [h])
            check(False, "tools: the door raised the injected fault")
        except EXC.CudfException as e:
            check("injected fault in murmur3_32" in str(e),
                  f"tools: the door's typed exception ({e})")
        out = jni_api.murmur_hash3_32(42, [h])
        check(torch.equal(REGISTRY.get(out).data,
                          H.murmur3_32([col], 42).data),
              "tools: the door's next call ran (the rule spent)")
        jni_api.release_column(out)
    finally:
        FI.uninstall()
        jni_api.release_column(h)
    return res


def tools_files(inputs):
    """(c): the tools over the files the earlier phases wrote."""
    from spark_rapids_tpu_torch.tools import trace_export as TE
    res = {"s": {}, "doctor_first": {}}
    for bundle in inputs["bundles"]:
        with open(os.path.join(bundle, "trigger.json")) as f:
            kind = json.load(f)["kind"]
        rc, text, secs = run_tool("doctor", [bundle, "--json"])
        findings = json.loads(text)["findings"]
        check(rc == 0 and kind in [f["kind"] for f in findings],
              f"tools: doctor on the {kind} bundle ({findings[:2]})")
        res["doctor_first"][kind] = findings[0]
        res["s"][f"doctor_{kind}"] = secs
    rc, text, res["s"]["metrics_report"] = run_tool(
        "metrics_report", [inputs["journal"], "--json"])
    report = json.loads(text)
    check(rc == 0 and report["server"],
          "tools: metrics_report's server table over the drain's journal")
    res["server_rows"] = len(report["server"])
    trace = os.path.join(tools_dir(), "drain_trace.json")
    rc, text, res["s"]["trace_export"] = run_tool(
        "trace_export", [inputs["spans"], "-o", trace, "--stats"])
    spans = [r for _, recs in TE.load_files([inputs["spans"]])
             for r in TE.spans_of(recs)]
    check(rc == 0 and spans and TE.find_orphans(spans) == [],
          f"tools: trace_export over the drain's spans, no orphans "
          f"({len(spans)} spans)")
    res["spans"] = len(spans)
    rc, text, res["s"]["srt_explain"] = run_tool(
        "srt_explain", list(inputs["profiles"]) + ["--json"])
    merged = json.loads(text)
    check(rc == 0 and merged["fleet"]
          and merged["ranks"] == list(range(len(inputs["profiles"]))),
          f"tools: srt_explain merged the rank profiles "
          f"({merged.get('ranks')})")
    frames = []
    for _ in range(2):
        rc, text, secs = run_tool("srt_top", [inputs["timeseries"],
                                              "--once", "--json"])
        check(rc == 0, "tools: srt_top --once")
        frames.append(text)
    check(frames[0] == frames[1] and json.loads(frames[0])["ranks"],
          "tools: srt_top's two frames are byte-identical")
    res["s"]["srt_top"] = secs
    rc, text, res["s"]["srt_check"] = run_tool("srt_check", [])
    check(rc == 0 and "0 finding(s)" in text,
          f"tools: srt_check clean on the port's tree ({text[-200:]})")
    rc, text, res["s"]["srt_check_plan"] = run_tool(
        "srt_check", ["--plan", "--json"])
    plans = json.loads(text)["plans"]
    check(rc == 0 and len(plans) == 7 and all(p["ok"] for p in plans),
          f"tools: srt_check --plan verified every catalog plan "
          f"({plans})")
    return res


def tools_inputs():
    """The files the earlier phases kept for step 21."""
    d = tools_dir()
    inc = os.path.join(d, "server", "incidents")
    drain = os.path.join(d, "server", "drain")
    return {
        "bundles": sorted(os.path.join(inc, n) for n in os.listdir(inc)
                          if n.startswith("incident-")),
        "journal": os.path.join(drain, "journal.jsonl"),
        "spans": os.path.join(drain, "spans.jsonl"),
        "profiles": sorted(os.path.join(d, "dist", n)
                           for n in os.listdir(os.path.join(d, "dist"))
                           if n.startswith("profile_q5_rank")),
        "timeseries": os.path.join(d, "plane", "timeseries_rank0.json")}


def tools_phase(device="cuda", flagship_rows=None, inputs=None):
    """Step 21 (see the module docstring)."""
    clock = time.perf_counter()
    os.makedirs(tools_dir(), exist_ok=True)
    res = {}
    try:
        res["sidecars"], flag_inputs, want = tools_sidecars(
            device, flagship_rows or FLAGSHIP_ROWS)
        res["faults"] = tools_faults(device, flag_inputs, want)
        res["files"] = tools_files(inputs or tools_inputs())
    finally:
        shutil.rmtree(tools_dir(), ignore_errors=True)
    res["phase_s"] = time.perf_counter() - clock
    return res


def run_tools(device="cuda", flagship_ms=None, **kw):
    """Step 21 on the card (see the module docstring)."""
    RA.reset_launches()
    res = tools_phase(device, **kw)
    sc, fl = res["sidecars"], res["files"]
    seconds = dict(fl["s"], doctor_retry_exhausted=res["faults"][
        "doctor_s"], profile_converter=sc["profile_converter_s"])
    line = {
        "flagship_step_ms": dict(sc["ms"], main_path=flagship_ms),
        "launches_a_step": {k: v / TOOLS_ITERS
                            for k, v in sc["launches"].items()},
        "op_ranges": sc["op_ranges"], "allocs": sc["allocs"],
        "bundles": {"retry_exhausted": res["faults"]["bundles"],
                    "server": len(fl["doctor_first"])},
        "doctor_first": dict(fl["doctor_first"], retry_exhausted=res[
            "faults"]["doctor_first"]),
        "tool_s": seconds, "phase_s": res["phase_s"]}
    print(json.dumps({"tools": line}, default=str), flush=True)
    return read_launches("tools"), res


# --------------------------------------------------- step 22: jvm door

JVM_DOOR_PARTITIONS = 200
# the CPU run of the variable-width door: the rows of this prefix (the
# CPU's plain string paste takes seconds per 2^15 rows of the 155-column
# table)
JVM_DOOR_CPU_ROWS = 1 << 15
JVM_DOOR_TASK = 2201
NATIVE_LIBRARIES = ("kudo_native", "sra_native", "columnar_native")


def build_native_libraries():
    """Build the three host libraries at once (one g++ a library);
    returns the seconds each took to become available."""
    from spark_rapids_tpu_torch.memory import native_adaptor
    from spark_rapids_tpu_torch.shuffle import kudo_native
    from spark_rapids_tpu_torch.utils import native
    mods = dict(zip(NATIVE_LIBRARIES, (kudo_native, native_adaptor,
                                       native)))
    took = {}

    def build(name):
        t0 = time.perf_counter()
        ok = mods[name].available()
        took[name] = (time.perf_counter() - t0) if ok else None

    threads = [threading.Thread(target=build, args=(n,))
               for n in NATIVE_LIBRARIES]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for name in NATIVE_LIBRARIES:
        check(took.get(name) is not None,
              f"jvm door: the {name} library built and loaded")
    return took


def arrow_array(spec):
    import pyarrow as pa
    kind, data, valid = spec[:3]
    mask = None if valid is None else valid == 0
    if kind == "bool8":
        return pa.array(data != 0, pa.bool_(), mask=mask)
    return pa.array(data, mask=mask)


def bulk_strings(spec, rows=None):
    """A STRING host column as from_strings_bulk's three buffers, cut to
    its first `rows` rows."""
    _kind, chars, valid, offs = spec
    rows = len(offs) - 1 if rows is None else rows
    offs = offs[:rows + 1]
    packed = (None if valid is None
              else np.packbits(valid[:rows] != 0,
                               bitorder="little").tobytes())
    return (chars[:int(offs[-1])].tobytes(), offs.astype("<i4").tobytes(),
            packed)


def door_batch(specs, rows=None):
    """The table's fixed-width columns as one Arrow batch (what a JVM
    caller hands over through its Arrow FFI), cut to `rows` rows."""
    import pyarrow as pa
    fixed = [i for i, s in enumerate(specs) if s[0] != "string"]
    batch = pa.RecordBatch.from_arrays(
        [arrow_array(specs[i]) for i in fixed],
        names=[f"c{i}" for i in fixed])
    return batch if rows is None else batch.slice(0, rows)


def door_ingest(specs, batch, rows=None, device=None, ms=None):
    """The table's columns through the door's entries: the fixed-width
    ones as `batch` (arrow_ingest), each STRING column as its whole
    buffers (from_strings_bulk); returns the handles in column order."""
    from spark_rapids_tpu_torch.utils import platform
    ms = {} if ms is None else ms
    dev = platform.entry_device() if device is None else device
    fixed = [i for i, s in enumerate(specs) if s[0] != "string"]
    handles = [None] * len(specs)
    got = door_timed(ms, "arrow_ingest",
                     lambda: JE.arrow_ingest(batch, device), dev)
    for i, h in zip(fixed, got):
        handles[i] = h
    bulk = {i: bulk_strings(s, rows) for i, s in enumerate(specs)
            if s[0] == "string"}
    for i, payload in bulk.items():
        handles[i] = door_timed(
            ms, "from_strings_bulk",
            lambda p=payload: JE.from_strings_bulk(*p, device=device), dev)
    return handles


def door_string_readback(handles, specs):
    """{column: (chars, offsets)} of the STRING columns through the
    door's bulk readback."""
    return {i: (JE.string_column_chars(handles[i]),
                JE.string_column_offsets(handles[i]))
            for i, s in enumerate(specs) if s[0] == "string"}


def rows_parts(handle, rows=None):
    """(offsets, bytes) of a rows handle's first `rows` rows, on the
    host."""
    col = REGISTRY.get(handle)
    offs = col.offsets.cpu()
    rows = col.length if rows is None else rows
    offs = offs[:rows + 1]
    data = col.children[0].data[:int(offs[-1])].cpu()
    return offs, data


def same_rows(a, b):
    return torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def door_timed(ms, name, fn, device):
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    ms[name] = ms.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
    return out


def jvm_door_rows(device, specs, fixed, ms):
    """(b)-(c): the string table and the fixed-width table through the
    row entries.  Returns what the checks read."""
    type_ids = [s[0] for s in specs]
    handles = door_ingest(specs, door_batch(specs), ms=ms)
    rows = door_timed(ms, "convert_to_rows_var",
                      lambda: JE.convert_to_rows(handles), device)
    back = door_timed(ms, "convert_from_rows_var",
                      lambda: JE.convert_from_rows(
                          rows, type_ids, [0] * len(specs)), device)
    strings = door_timed(ms, "string_readback",
                         lambda: door_string_readback(back, specs), device)
    fhandles = [REGISTRY.register(c) for c in fixed.columns]
    fids = [c.dtype.kind for c in fixed.columns]
    fscales = [c.dtype.scale for c in fixed.columns]
    frows = door_timed(ms, "convert_to_rows_fixed",
                       lambda: JE.convert_to_rows(fhandles), device)
    fback = door_timed(ms, "convert_from_rows_fixed",
                       lambda: JE.convert_from_rows(frows, fids, fscales),
                       device)
    return dict(handles=handles, rows=rows, back=back, strings=strings,
                fhandles=fhandles, frows=frows, fback=fback, fids=fids,
                fscales=fscales)


def jvm_door_check_rows(device, specs, fixed, r, cpu_rows):
    """(d): each launch's bytes against the kernel's plain version on
    the same inputs and against the same entries' run on the CPU."""
    cols = [REGISTRY.get(h) for h in r["handles"]]
    for ci, (c, s) in enumerate(zip(cols, specs)):
        check(c.device.type == torch.device(device).type,
              f"jvm door: column {ci} on {device}")
    starts, voff, fixedw = RC.compute_layout([c.dtype for c in cols])
    rows_col = REGISTRY.get(r["rows"])
    plain = RA.assemble_var_rows_plain(cols, starts, voff, fixedw,
                                       rows_col.offsets)
    err_var = byte_err(rows_col.children[0].data, plain)
    check(err_var == 0, "jvm door: to-rows (strings) == plain version")
    del plain
    for ci, s in enumerate(specs):
        b = REGISTRY.get(r["back"][ci])
        if s[0] == "string":
            chars, offs, _valid = bulk_strings(s)
            got = r["strings"][ci]
            check(got == (chars, offs),
                  f"jvm door: string column {ci} read back == its input")
        else:
            want = cols[ci]
            check(byte_err(b.data, want.data) == 0,
                  f"jvm door: column {ci} back from rows")
        want_v = (np.ones(b.length, bool) if s[2] is None
                  else s[2] != 0)
        check(np.array_equal(b.validity.cpu().numpy() != 0, want_v),
              f"jvm door: column {ci}'s validity back from rows")

    fcols = fixed.columns
    fstarts, fvoff, row_size = layout_of(fixed)
    frows = REGISTRY.get(r["frows"])
    fplain = RA.assemble_rows_plain(fcols, fstarts, fvoff, row_size)
    err_to = byte_err(frows.children[0].data, fplain)
    check(err_to == 0, "jvm door: to-rows (fixed) == plain version")
    schema = [c.dtype for c in fcols]
    pd, pv = RA.disassemble_rows_plain(frows.children[0].data, schema,
                                       fstarts, fvoff, row_size)
    err_from = 0
    for ci, h in enumerate(r["fback"]):
        b = REGISTRY.get(h)
        err_from = max(err_from, byte_err(b.data, pd[ci]),
                       byte_err(b.validity, pv[ci]))
        check(byte_err(b.data, fcols[ci].data) == 0,
              f"jvm door: fixed column {ci} back from rows")
    check(err_from == 0, "jvm door: from-rows == plain version")
    del fplain, pd, pv

    # the same entries on the CPU: the string table's first cpu_rows
    # rows, the fixed-width table whole
    cpu = door_ingest(specs, door_batch(specs, cpu_rows), cpu_rows,
                      device="cpu")
    crows = JE.convert_to_rows(cpu)
    check(same_rows(rows_parts(crows), rows_parts(r["rows"], cpu_rows)),
          f"jvm door: to-rows (strings) == the CPU run's "
          f"({cpu_rows} rows)")
    cback = JE.convert_from_rows(crows, [s[0] for s in specs],
                                 [0] * len(specs))
    for ci, s in enumerate(specs):
        if s[0] != "string":
            continue
        chars, offs = (JE.string_column_chars(cback[ci]),
                       JE.string_column_offsets(cback[ci]))
        n = int(np.frombuffer(offs, "<i4")[-1])
        card_chars, card_offs = r["strings"][ci]
        check(card_chars[:n] == chars
              and card_offs[:4 * (cpu_rows + 1)] == offs,
              f"jvm door: string column {ci} == the CPU run's")
    fcpu = [REGISTRY.register(Column(c.dtype, c.length, data=c.data.cpu(),
                                     validity=None if c.validity is None
                                     else c.validity.cpu()))
            for c in fcols]
    cfrows = JE.convert_to_rows(fcpu)
    check(same_rows(rows_parts(cfrows), rows_parts(r["frows"])),
          "jvm door: to-rows (fixed) == the CPU run's")
    cfback = JE.convert_from_rows(cfrows, r["fids"], r["fscales"])
    for ci, (h, ch) in enumerate(zip(r["fback"], cfback)):
        a, b = REGISTRY.get(h), REGISTRY.get(ch)
        check(torch.equal(raw_bytes(a.data).cpu(), raw_bytes(b.data))
              and torch.equal(a.validity.cpu(), b.validity),
              f"jvm door: from-rows (fixed) column {ci} == the CPU run's")
    for h in cpu + [crows] + cback + fcpu + [cfrows] + cfback:
        JE.free(h)
    return {"to_rows_var": err_var, "to_rows": err_to,
            "from_rows": err_from}


def jvm_door_kudo(device, handles, ms, partitions):
    """(e): kudo_write of the fixed-width table into `partitions` slices
    twice (the memo's miss, then its hit), each byte-equal to the spec
    engine's; kudo_merge of every slice; the host export and import."""
    from spark_rapids_tpu_torch.shuffle import kudo_native
    check(kudo_native.available() and not JE.kudo_crc_enabled(),
          "jvm door: the native kudo engine takes the write")
    cols = [REGISTRY.get(h) for h in handles]
    n = cols[0].length
    bounds = [(p * n // partitions, (p + 1) * n // partitions
               - p * n // partitions) for p in range(partitions)]
    key = tuple(handles)
    check(key not in JE._KUDO_WRITE_CACHE, "jvm door: the memo misses")
    blobs = door_timed(ms, "kudo_write_miss", lambda: [
        JE.kudo_write(handles, o, c) for o, c in bounds], device)
    check(key in JE._KUDO_WRITE_CACHE, "jvm door: the memo holds the table")
    again = door_timed(ms, "kudo_write_hit", lambda: [
        JE.kudo_write(handles, o, c) for o, c in bounds], device)
    check(again == blobs, "jvm door: the memo's hit writes the same bytes")

    def spec():
        views = K.prepare_host_columns(cols)
        out = []
        for o, c in bounds:
            buf = io.BytesIO()
            K.write_to_stream(views, buf, o, c)
            out.append(buf.getvalue())
        return out

    specs = door_timed(ms, "kudo_write_spec", spec, device)
    check(specs == blobs, "jvm door: native kudo bytes == the spec engine's")
    del again, specs
    blob = b"".join(blobs)
    ids = [c.dtype.kind for c in cols]
    scales = [c.dtype.scale for c in cols]
    merged = door_timed(ms, "kudo_merge",
                        lambda: JE.kudo_merge(blob, ids, scales), device)
    for ci, (h, c) in enumerate(zip(merged, cols)):
        m = REGISTRY.get(h)
        check(m.device.type == torch.device(device).type
              and byte_err(m.data, c.data) == 0,
              f"jvm door: merged column {ci} == the table's")
    flat = door_timed(ms, "export_kudo_host",
                      lambda: JE.export_kudo_host(handles), device)
    check(flat[0] == n and flat[1] == len(cols),
          "jvm door: the export's shape")
    imported = door_timed(
        ms, "columns_from_kudo_host",
        lambda: JE.columns_from_kudo_host(flat[0], flat[2:]), device)
    for ci, (h, c) in enumerate(zip(imported, cols)):
        check(byte_err(REGISTRY.get(h).data, c.data) == 0,
              f"jvm door: imported column {ci} == the table's")
    for h in merged + imported:
        JE.free(h)
    check(key in JE._KUDO_WRITE_CACHE, "jvm door: the memo still holds")
    return {"partitions": partitions, "bytes": len(blob)}


def jvm_door_host_table(device, handles, ms):
    """(f): the fixed-width table to a host table and back."""
    cols = [REGISTRY.get(h) for h in handles]
    ht = door_timed(ms, "host_table_from_table",
                    lambda: JE.host_table_from_table(handles), device)
    size = JE.host_table_size_bytes(ht)
    check(size >= sum(nbytes(c.data) for c in cols),
          "jvm door: the host table holds every buffer")
    back = door_timed(ms, "host_table_to_device",
                      lambda: JE.host_table_to_device(ht), device)
    for ci, (h, c) in enumerate(zip(back, cols)):
        b = REGISTRY.get(h)
        check(b.device.type == torch.device(device).type
              and byte_err(b.data, c.data) == 0,
              f"jvm door: host table column {ci} back on {device}")
    JE.host_table_free(ht)
    for h in back:
        JE.free(h)
    return size


def jvm_door_rmm(nbytes_):
    """(g): a task under a limit: one forced retry, then one forced
    split whose halves fit."""
    from spark_rapids_tpu_torch.memory import exceptions as MX
    JE.rmm_set_event_handler(2 * nbytes_)
    seen = []
    try:
        JE.rmm_register_current_thread(JVM_DOOR_TASK)
        tid = JE.rmm_current_thread_id()
        JE.rmm_force_retry_oom(tid, 1)
        try:
            JE.rmm_alloc(nbytes_)
            check(False, "jvm door: the forced retry fired")
        except MX.GpuRetryOOM:
            seen.append("GpuRetryOOM")
        JE.rmm_block_thread_until_ready()
        JE.rmm_alloc(nbytes_)
        JE.rmm_dealloc(nbytes_)
        JE.rmm_force_split_and_retry_oom(tid, 1)
        try:
            JE.rmm_alloc(nbytes_)
            check(False, "jvm door: the forced split fired")
        except MX.GpuSplitAndRetryOOM:
            seen.append("GpuSplitAndRetryOOM")
        JE.rmm_block_thread_until_ready()
        for _ in range(2):
            JE.rmm_alloc(nbytes_ // 2)
        for _ in range(2):
            JE.rmm_dealloc(nbytes_ // 2)
        seen.append(JE.rmm_get_state_of(tid))
        JE.rmm_task_done(JVM_DOOR_TASK)
    finally:
        JE.rmm_clear_event_handler()
    check(seen == ["GpuRetryOOM", "GpuSplitAndRetryOOM", "THREAD_RUNNING"],
          f"jvm door: a retry, a split, then running ({seen})")
    return seen


def jvm_door_phase(device="cuda", rows=STRING_ROWS, ncols=STRING_COLS,
                   fixed=None, cpu_rows=JVM_DOOR_CPU_ROWS,
                   partitions=JVM_DOOR_PARTITIONS):
    """Step 22 (see the module docstring).  `fixed` is the fixed-width
    table (on `device`); returns the phase's numbers and the launch
    counts of its drive."""
    from spark_rapids_tpu_torch import server as srv
    from spark_rapids_tpu_torch.utils import platform
    clock = time.perf_counter()
    so_s = build_native_libraries()
    specs = string_host_specs(rows, ncols, seed=22)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    ms = {}
    RA.reset_launches()
    door_timed(ms, "initialize", JE.initialize, device)
    check(platform.entry_device() == torch.device(device).type,
          f"jvm door: initialize() put the entries on {device}")
    r = jvm_door_rows(device, specs, fixed, ms)
    launches = dict(RA.LAUNCHES)
    # the row entries' own peak, before the checks' plain versions
    rows_peak = torch.cuda.max_memory_allocated() / 2**20 if on_card \
        else None
    errs = jvm_door_check_rows(device, specs, fixed, r, cpu_rows)
    kudo_res = jvm_door_kudo(device, r["fhandles"], ms, partitions)
    ht_bytes = jvm_door_host_table(device, r["fhandles"], ms)
    rmm = door_timed(ms, "rmm", lambda: jvm_door_rmm(
        sum(nbytes(c.data) for c in fixed.columns)), device)
    check(JE.server_start(1, 4), "jvm door: a server to stop")
    door_timed(ms, "shutdown", JE.shutdown, device)
    check(JE.live_handles() == 0 and srv.get_server() is None
          and not JE._KUDO_WRITE_CACHE and not JE._HOST_TABLES,
          "jvm door: shutdown left no handle, memo, host table or server")
    check(dict(RA.LAUNCHES) == launches,
          "jvm door: nothing after the row entries launched a kernel")
    peak = torch.cuda.max_memory_allocated() / 2**20 if on_card else None
    return {"shape": f"{rows}x{ncols}",
            "fixed_shape": f"{fixed.num_rows}x{fixed.num_columns}",
            "cpu_rows": cpu_rows, "entry_ms": ms, "launches": launches,
            "max_abs_err": errs, "kudo": kudo_res,
            "memo_miss_ms": ms["kudo_write_miss"],
            "memo_hit_ms": ms["kudo_write_hit"],
            "native_kudo_ms": ms["kudo_write_hit"],
            "spec_kudo_ms": ms["kudo_write_spec"],
            "host_table_bytes": ht_bytes, "rmm": rmm, "so_build_s": so_s,
            "rows_peak_mib": rows_peak, "peak_mib": peak,
            "phase_s": time.perf_counter() - clock}


def run_jvm_door(fixed):
    """Step 22 on the card (see the module docstring)."""
    res = jvm_door_phase("cuda", fixed=fixed)
    print(f"main path jvm_door: launches {res['launches']}", flush=True)
    for name in PATH_KERNELS["jvm_door"]:
        check(res["launches"][name] == 1,
              f"jvm_door launched the {name} kernel once")
    print(json.dumps({"jvm_door": res}), flush=True)
    return res["launches"], res


# ------------------------------------------------------------ step 23


# M2's two ranks share the card over gloo at step 6's and step 8's
# widths: store_sales rows per rank for the exchange and the aggregate
# (a batch of 2^25 drawn on each rank's card from one seed, each rank
# taking its half), q5 and q72 at step 6's sizes, the join's left side
# 2^22 rows a rank against SF100's 204,000 items, from an exchange
# capacity of a quarter of a rank's rows (the retry must double it)
MESH_M2 = dict(exchange_rows=1 << 24, seed=23,
               join_rows=1 << 22, join_items=204_000,
               join_exch_cap=1 << 20, join_pair_cap=1 << 21,
               agg_rows=1 << 24, agg_buckets=1024,
               q5=Q5_DATA, q5_capacity=Q5_CAPACITY,
               q72=Q72_DATA, q72_capacity=Q72_CAPACITY // 2,
               fused=True, iters=3)
# M1: one NCCL rank through the JVM door's mesh entries at step 6's
# sizes (q72's entry draws its 64-row inventory itself)
MESH_M1 = dict(q5_rows=1 << 25, stores=402, q72_rows=1 << 22,
               items=204_000)
MESH_TIMEOUT_S = 600
# step 23 at a small size: the card's `gpu` tests and the CPU rehearsal
MESH_M1_SMALL = dict(q5_rows=1 << 16, stores=40, q72_rows=1 << 14,
                     items=2000)
MESH_M2_SMALL = dict(exchange_rows=1 << 12, seed=23, join_rows=1 << 10,
                     join_items=204_000, join_exch_cap=1 << 8,
                     join_pair_cap=1 << 9, agg_rows=1 << 12,
                     agg_buckets=64,
                     q5=dict(rows=1 << 14, stores=40, days=60, seed=5),
                     q5_capacity=1 << 12,
                     q72=dict(cs_rows=1 << 12, inv_rows=1 << 11,
                              items=2000, days=35, seed=72),
                     q72_capacity=1 << 14, fused=True, iters=1)


def mesh_rank(mesh, sizes):
    """One rank of step 23's M2 (see the module docstring): every check
    runs on the rank against the single-process result on its own card;
    a failed one raises, which fails the call and the step.  Returns the
    rank's numbers and its replicated query outputs."""
    from spark_rapids_tpu_torch.models import distributed_join as DJ
    from spark_rapids_tpu_torch.ops.device_join import inner_join_device
    from spark_rapids_tpu_torch.utils.u64math import urem
    dev, n, r = mesh.device, mesh.size, mesh.rank
    res = {"rank": r, "device": str(dev), "backend": mesh.backend}
    RA.reset_launches()   # this rank's own row-kernel launches

    def timed(fn):
        sync(dev)
        t0 = time.perf_counter()
        out = fn()
        sync(dev)
        return out, (time.perf_counter() - t0) * 1e3

    def median_ms(fn, iters):
        return sorted(timed(fn)[1] for _ in range(iters))[iters // 2]

    # the exchange: (ss_item_sk, ss_sales_price) keyed by item mod n
    batch = store_sales_batch(sizes["exchange_rows"] * n, sizes["seed"],
                              device=dev)
    key = batch.columns[1].data
    price = batch.columns[3].data
    cap = sizes["exchange_rows"]
    part = torch.remainder(key, n).to(torch.int32)
    mesh.stats.reset()
    ((rk, rv), valid, total, sends), ms = timed(lambda: EX.exchange(
        [mesh.shard(key), mesh.shard(price)], mesh.shard(part), mesh, n,
        cap))
    mine = part == r
    check(bool((sends <= cap).all()), "mesh exchange: nothing dropped")
    check(torch.equal(rk[valid], key[mine])
          and torch.equal(rv[valid], price[mine]),
          f"mesh exchange rank {r}: the rows of its partition, in order")
    res["exchange"] = dict(ms=ms, rows=int(total), **mesh.stats.as_dict())
    del rk, rv, valid, batch

    # the join from a capacity that must double, on every rank alike
    rows = sizes["join_rows"] * n
    lk = key[:rows].to(torch.int64)
    lv = torch.arange(rows, dtype=torch.int64, device=dev)
    g = torch.Generator(device=dev).manual_seed(sizes["seed"])
    rkeys = torch.randperm(sizes["join_items"], generator=g, device=dev)
    rvals = torch.remainder(rkeys, 1000)
    run = DJ.make_distributed_join_auto(
        mesh, sizes["join_exch_cap"], sizes["join_pair_cap"],
        max_doublings=8)
    mesh.stats.reset()
    ((k, a, b, ok, _tot, of), caps), ms = timed(lambda: run(
        mesh.shard(lk), mesh.shard(lv), mesh.shard(rkeys),
        mesh.shard(rvals)))
    check(not bool(of.any()), "mesh join: no overflow after the retry")
    pl = torch.remainder(lk, n) == r
    pr = torch.remainder(rkeys, n) == r
    want = inner_join_device(lk[pl], rkeys[pr], caps[1])
    li, ri = (want.left_indices.to(torch.int64),
              want.right_indices.to(torch.int64))
    ok1 = ok[0]
    check(torch.equal(k[0][ok1], lk[pl][li][want.valid])
          and torch.equal(a[0][ok1], lv[pl][li][want.valid])
          and torch.equal(b[0][ok1], rvals[pr][ri][want.valid]),
          f"mesh join rank {r}: the single-process join of its partition")
    doublings = (caps[0] // sizes["join_exch_cap"]).bit_length() - 1
    check(doublings >= 1, f"mesh join rank {r}: the capacity doubled")
    res["join"] = dict(ms=ms, pairs=int(ok1.sum()), capacity=list(caps),
                       doublings=doublings, **mesh.stats.as_dict())
    del k, a, b, ok, want, lk, lv

    # the hash aggregate: every row's key and its net paid
    keys = key.to(torch.int64)[:sizes["agg_rows"] * n]
    vals = torch.rand(keys.shape[0], generator=g, device=dev,
                      dtype=torch.float32) * 1000
    buckets = sizes["agg_buckets"]
    step, shard = Q.make_distributed_hash_aggregate(
        mesh, n, buckets, sizes["agg_rows"])
    mesh.stats.reset()
    (sums, counts, sends), ms = timed(lambda: step(shard(keys),
                                                   shard(vals)))
    check(bool((sends <= sizes["agg_rows"]).all()),
          "mesh aggregate: nothing dropped")
    h = H.murmur3_32([Column(dtypes.INT64, keys.shape[0], data=keys)],
                     42).data
    mine = torch.remainder(h.to(torch.int64) & 0xFFFFFFFF, n) == r
    bucket = urem(keys[mine], buckets)
    want_counts = torch.bincount(bucket, minlength=buckets).to(torch.int32)
    want_sums = torch.zeros(buckets, dtype=torch.float64,
                            device=dev).index_add_(
        0, bucket, vals[mine].to(torch.float64))
    check(torch.equal(counts, want_counts),
          f"mesh aggregate rank {r}: counts equal one process's")
    tol = 2 * want_counts.to(torch.float64) * 2.0 ** -24 * want_sums
    check(bool(((sums.to(torch.float64) - want_sums).abs() <= tol).all()),
          f"mesh aggregate rank {r}: f32 sums within 2 n 2^-24 sum|v|")
    res["aggregate"] = dict(ms=ms, rows=int(counts.sum()),
                            **mesh.stats.as_dict())
    del keys, vals, h, mine, bucket, key, price, part

    # q5 op by op and fused, q72 op by op: replicated outputs
    outs = {}
    q5 = sizes["q5"]
    d, args = mesh_q5_args(mesh, sizes)
    step5 = TT.make_q5_multichip(mesh, q5["stores"], sizes["q5_capacity"])
    mesh.stats.reset()
    outs["q5"], first = timed(lambda: step5(*args))
    check(not bool(outs["q5"][4]), "mesh q5: no overflow")
    res["q5"] = dict(first_ms=first, all_reduce=mesh.stats.all_reduce,
                     ms=median_ms(lambda: step5(*args), sizes["iters"]))
    if sizes["fused"]:
        fused = TC.make_q5_multichip_fused(mesh, q5["stores"],
                                           sizes["q5_capacity"])
        got = fused(*args)
        same_bytes(got, outs["q5"], f"mesh q5 fused rank {r} == op by op")
        res["q5_fused"] = dict(
            compile_s=fused.program.compile_s,
            graphs=fused.program.compiles,
            ms=median_ms(lambda: fused(*args), sizes["iters"]))
        check(fused.program.compiles == 1,
              f"mesh q5 fused rank {r}: one graph")
    if r == 0:
        single = TT.make_q5(q5["stores"], sizes["q5_capacity"])
        same_bytes(outs["q5"], single(d),
                   "mesh q5 == the single-process q5")
        res["q5"]["single_ms"] = median_ms(lambda: single(d),
                                           sizes["iters"])
    del d, args
    q72 = sizes["q72"]
    d = TT.gen_q72(device=dev, **q72)
    args = [mesh.shard(x) for x in d[:3]] + list(d[3:])
    mesh.stats.reset()
    (outs["q72"], cap72), first = timed(lambda: TT.run_with_capacity_retry(
        lambda c: TT.make_q72_multichip(mesh, q72["items"], Q72_MAX_WEEK,
                                        c, Q72_LIMIT, Q72_WEEK0),
        args, sizes["q72_capacity"], mesh=mesh))
    res["q72"] = dict(first_ms=first, capacity=cap72,
                      all_reduce=mesh.stats.all_reduce)
    step72 = TT.make_q72_multichip(mesh, q72["items"], Q72_MAX_WEEK, cap72,
                                   Q72_LIMIT, Q72_WEEK0)
    res["q72"]["ms"] = median_ms(lambda: step72(*args), sizes["iters"])
    if r == 0:
        single = TT.make_q72(q72["items"], Q72_MAX_WEEK, cap72 * n,
                             Q72_LIMIT, Q72_WEEK0)
        same_bytes(outs["q72"], single(d),
                   "mesh q72 == the single-process q72")
        res["q72"]["single_ms"] = median_ms(lambda: single(d),
                                            sizes["iters"])
    if dev.type == "cuda":
        res["peak_mib"] = torch.cuda.max_memory_allocated(dev) / 2**20
    res["launches"] = dict(RA.LAUNCHES)
    return res, outs


def mesh_q5_args(mesh, sizes):
    """This rank's q5 inputs: its shard of the facts, the dims whole."""
    q5 = sizes["q5"]
    d = TT.q5_mesh_data(q5["rows"], q5["stores"], mesh.size,
                        days=q5["days"], device=mesh.device)
    return d, [mesh.shard(x) for x in d[:8]] + [d.d_date, d.st_id]


def mesh_m2(device="cuda", sizes=MESH_M2, timeout_s=MESH_TIMEOUT_S):
    """Step 23's M2: two rank processes sharing `device` over gloo,
    booted, then each running mesh_rank (its fused q5 compiled there)."""
    from spark_rapids_tpu_torch.distributed.pool import RankPool
    t0 = time.perf_counter()
    with RankPool(2, device=device, backend="gloo",
                  timeout_s=timeout_s) as pool:
        got = pool.run(mesh_rank, sizes, timeout_s=timeout_s)
    for name in got[0][1]:
        same_bytes(got[1][1][name], got[0][1][name],
                   f"mesh {name}: both ranks hold the replicated result")
    out = [dict(res, boot_s=b["boot_s"])
           for (res, _), b in zip(got, pool.ranks)]
    return {"launch": "M2", "backend": "gloo", "mode": "mesh",
            "ranks": out, "boot_wall_s": pool.boot_wall_s,
            "wall_s": time.perf_counter() - t0}


def mesh_m1(device="cuda", sizes=MESH_M1):
    """Step 23's M1: one rank through the JVM door's mesh entries (over
    NCCL on the card; the entries' device is what initialize() set),
    each result equal to the single-device query on the same data."""
    from spark_rapids_tpu_torch.shim import jni_mesh
    from spark_rapids_tpu_torch.shim.errors import ShimStateError
    from spark_rapids_tpu_torch.utils import platform
    JE.initialize()
    t0 = time.perf_counter()
    res = {"launch": "M1", "mode": "mesh"}
    try:
        for name, call in (
                ("q5", lambda: JE.flagship_q5_mesh(1, sizes["q5_rows"],
                                                   sizes["stores"])),
                ("q72", lambda: JE.flagship_q72_mesh(1, sizes["q72_rows"],
                                                     sizes["items"]))):
            t = time.perf_counter()
            flat = call()
            first_s = time.perf_counter() - t
            info = dict(jni_mesh.LAST_CALL)
            t = time.perf_counter()
            check(call() == flat, f"mesh entry {name}: a second call agrees")
            res[name] = dict(first_call_s=first_s,
                             second_call_s=time.perf_counter() - t,
                             boot=info["boot"], ranks=info["ranks"],
                             warm_ranks=jni_mesh.LAST_CALL["ranks"],
                             rows=len(flat))
            res.setdefault("launches", []).extend(
                rank["launches"] for rank in
                info["ranks"] + jni_mesh.LAST_CALL["ranks"])
            res["backend"] = info["backend"]
            cap = info["ranks"][0]["capacity"]
            if name == "q5":
                d = TT.q5_mesh_data(sizes["q5_rows"], sizes["stores"], 1,
                                    device=device)
                single = TT.make_q5(sizes["stores"], cap)
                width = 4
            else:
                d = TT.q72_mesh_data(sizes["q72_rows"], sizes["items"], 1,
                                     device=device)
                single = TT.make_q72(sizes["items"], jni_mesh.Q72_MAX_WEEK,
                                     cap, week0=jni_mesh.Q72_WEEK0)
                width = 3
            outs = [o.cpu().numpy() for o in single(d)]
            live = (outs[0] != 2**31 - 1) if name == "q5" else outs[2] > 0
            want = [int(x) for row in zip(*(o[live] for o in outs[:width]))
                    for x in row]
            check(flat == want,
                  f"mesh entry {name} == the single-device {name}")
            res[name]["single_ms"] = wall_ms(lambda: single(d), STEP_ITERS,
                                             device)
            del d
        want = "nccl" if torch.device(device).type == "cuda" else "gloo"
        check(res["backend"] == want, f"M1 runs over {want}")
        try:
            JE.flagship_q5_mesh(platform.mesh_ranks_allowed() + 1,
                                1 << 10, 8)
            refused = False
        except ShimStateError:
            refused = True
        check(refused, "a mesh entry past the allowed ranks raises "
                       "ShimStateError")
    finally:
        jni_mesh.stop_pools()
    res["wall_s"] = time.perf_counter() - t0
    return res


def run_mesh():
    """Step 23 on the card (see the module docstring): M2, M1's rank
    booting meanwhile, then M1.  The launch counts are the parent's and
    every rank's own."""
    from spark_rapids_tpu_torch.shim import jni_mesh
    RA.reset_launches()
    JE.initialize()
    boot = threading.Thread(target=jni_mesh.pool_for, args=(1,),
                            daemon=True)
    boot.start()
    try:
        m2 = mesh_m2()
    finally:
        boot.join(MESH_TIMEOUT_S)
    print(json.dumps({"mesh": m2}), flush=True)
    m1 = mesh_m1()
    print(json.dumps({"mesh": m1}), flush=True)
    launches = read_launches("mesh", [r["launches"] for r in m2["ranks"]]
                             + m1["launches"])
    return launches, {"M1": m1, "M2": m2}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 1

    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    print(f"device: {kind}  torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)

    # the phases before step 19 run their stages fused unless they pin
    # op by op, as before 'auto' measured the engines (workers inherit
    # this); step 19 runs q5 under 'auto' itself
    os.environ.setdefault("SPARK_RAPIDS_TPU_STAGE_FUSION", "1")
    phase_s = {}
    clock = [time.perf_counter()]
    verify_calls = count_plan_verifications()

    def phase(name):
        now = time.perf_counter()
        phase_s[name] = now - clock[0]
        clock[0] = now

    # step 21 reads what earlier phases keep under build/tools
    shutil.rmtree(tools_dir(), ignore_errors=True)
    t0 = time.perf_counter()
    cuda_build.build("row_assembly")
    build_s = time.perf_counter() - t0
    phase("build")
    print(f"build: row_assembly.cu in {build_s:.1f} s (0 = cached)")
    print(cuda_build.build_log("row_assembly"), flush=True)

    # kernel vs plain: the edge cases, then the main path's own inputs
    bench = make_table(BENCH_ROWS, BENCH_COLS, "cuda", seed=7)
    a, b, c = F.example_inputs(FLAGSHIP_ROWS, device="cuda")
    flagship_table = Table([Column(dtypes.INT64, FLAGSHIP_ROWS, data=a),
                            Column(dtypes.INT32, FLAGSHIP_ROWS, data=b),
                            Column(dtypes.FLOAT64, FLAGSHIP_ROWS, data=c)])
    errs = {"to_rows": 0, "from_rows": 0}
    cases = (make_table(rows, ncols, "cuda", seed=rows + ncols,
                        nullable_every=nullable, dec128_every=dec,
                        view_offset=off)
             for rows, ncols, nullable, dec, off in KERNEL_CASES)
    for table in itertools.chain(cases, [flagship_table, bench]):
        e_to, e_from = compare_kernels(table)
        print(f"kernel vs plain: rows={table.num_rows} "
              f"cols={table.num_columns} to_rows max_abs_err={e_to} "
              f"from_rows max_abs_err={e_from}", flush=True)
        check(e_to == 0 and e_from == 0, "kernels byte-equal to plain")
        errs["to_rows"] = max(errs["to_rows"], e_to)
        errs["from_rows"] = max(errs["from_rows"], e_from)

    string_specs = string_host_specs(STRING_ROWS, STRING_COLS, seed=11)
    string_table = interop.table_from_host(string_specs, device="cuda")
    cpu_keys = interop.table_from_host(
        [string_specs[k] for k in HASH_KEYS], device="cpu").columns
    del string_specs
    errs["to_rows_var"] = 0
    paths = {"staged": 0, "direct": 0}
    for case in VAR_KERNEL_CASES:
        table = var_case_table(case, "cuda")
        err = compare_var_kernel(table)
        tiles, direct, tile_rows = var_tiles(table)
        print(f"kernel vs plain: rows={case[0]} cols={case[1]} with strings "
              f"of up to {case[6]} bytes, {tiles} tiles of {tile_rows} "
              f"rows, {direct} direct: to_rows_var max_abs_err={err}",
              flush=True)
        check(err == 0, "variable-width kernel byte-equal to plain")
        errs["to_rows_var"] = max(errs["to_rows_var"], err)
        paths["staged"] += tiles - direct
        paths["direct"] += direct
        if case == LONG_STRINGS_CASE:
            check(direct == tiles, "every long-strings tile went direct")
            long_table = table
    check(min(paths.values()) > 0,
          f"both variable-width kernel paths taken: {paths}")
    phase("kernel_checks")

    by_path = {}
    by_path["flagship_step"], flagship_ms, flagship_steady = run_flagship()
    phase("flagship_step")
    (by_path["bench_round_trip"], bench_ms, bench_steady,
     rows_col) = run_bench_round_trip(bench)
    phase("bench_round_trip")
    (by_path["jni_door_round_trip"], jni_ms, jni_steady,
     err) = run_jni_door(string_table, cpu_keys)
    phase("jni_door_round_trip")
    by_path["tpcds_stage_path"], stage_path = run_stage_path()
    print(json.dumps({"stage_path": stage_path}), flush=True)
    phase("tpcds_stage_path")
    by_path["tpcds_catalog_entry"], catalog = run_catalog_entry()
    phase("tpcds_catalog_entry")
    by_path["operators_batch"], operators = run_operators()
    print(json.dumps({"catalog_entry": catalog, "operators": operators}),
          flush=True)
    phase("operators_batch")
    by_path["joins_batch"], joins = run_joins()
    print(json.dumps({"joins": joins}), flush=True)
    phase("joins_batch")
    by_path["shuffle_batch"], shuffle = run_shuffle()
    print(json.dumps({"shuffle": shuffle}), flush=True)
    phase("shuffle_batch")
    by_path["memory"], _ = run_memory()
    phase("memory")
    by_path["strings"], _ = run_strings()
    phase("strings")
    by_path["json"], _ = run_json()
    phase("json")
    by_path["ingest"], _ = run_ingest()
    phase("ingest")
    by_path["ops"], _ = run_ops()
    phase("ops")
    by_path["protobuf"], _ = run_protobuf()
    phase("protobuf")
    by_path["distributed"], dist = run_distributed()
    phase("distributed")
    by_path["observability"], _ = run_observability()
    phase("observability")
    by_path["observability_plane"], _ = run_observability_plane(
        dist_profiles_res=dist["a"]["profiles"])
    phase("observability_plane")
    by_path["server"], _ = run_server(verify_calls=verify_calls)
    phase("server")
    by_path["tools"], _ = run_tools(flagship_ms=flagship_steady)
    phase("tools")
    by_path["jvm_door"], _ = run_jvm_door(bench)
    phase("jvm_door")
    by_path["mesh"], _ = run_mesh()
    phase("mesh")
    print(f"kernel vs plain: rows={STRING_ROWS} cols={STRING_COLS} with "
          f"strings (JNI door) to_rows_var max_abs_err={err}", flush=True)
    errs["to_rows_var"] = max(errs["to_rows_var"], err)

    times = {"to_rows": time_to_rows(bench, TO_ROWS_TIMED["bench"]),
             "from_rows": time_from_rows(bench, rows_col)}
    del rows_col, bench
    to_rows_shapes = {"flagship": time_to_rows(flagship_table,
                                               TO_ROWS_TIMED["flagship"])}
    del flagship_table
    nullable = make_table(BENCH_ROWS, BENCH_COLS, "cuda", seed=8,
                          nullable_every=3)
    to_rows_shapes["bench_nullable"] = time_to_rows(nullable)
    del nullable
    shaped = [("bench", times["to_rows"])] + list(to_rows_shapes.items())
    print(json.dumps({"to_rows_variant_ms": {
        k: dict(t["variant_ms"], chosen={
            key: t[key] for key in ("tile_rows", "stages", "smem_bytes")})
        for k, t in shaped}}), flush=True)
    times["to_rows_var"] = time_var_kernel(string_table, VAR_TIMED_TILES)
    direct = time_var_kernel(long_table)
    direct_path = {"shape": "x".join(map(str, LONG_STRINGS_CASE[:2])),
                   "max_len": LONG_STRINGS_CASE[6], "ms": direct["ms"],
                   "bound_ms": direct["bytes"] / HBM_BYTES_PER_S * 1e3,
                   "plain_ms": direct["plain_ms"], "bytes": direct["bytes"]}
    del long_table
    replaces = {
        "to_rows": "spark_rapids_tpu/ops/row_assembly_pallas.py:47",
        "from_rows": "spark_rapids_tpu/ops/row_assembly_pallas.py:136",
        "to_rows_var": "spark_rapids_tpu/ops/row_assembly_pallas.py:281",
    }
    shapes = {"to_rows": f"{BENCH_ROWS}x{BENCH_COLS}",
              "from_rows": f"{BENCH_ROWS}x{BENCH_COLS}",
              "to_rows_var": f"{STRING_ROWS}x{STRING_COLS}"}
    kernels = []
    for name, t in times.items():
        bound_ms = t["bytes"] / HBM_BYTES_PER_S * 1e3
        kernels.append({
            "name": name, "route": "cuda",
            "source": "spark_rapids_tpu_torch/csrc/row_assembly.cu",
            "replaces": replaces[name],
            "launches": sum(n[name] for n in by_path.values()),
            "launches_by_path": {p: n[name] for p, n in by_path.items()},
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": bound_ms,
            "bound_by": "bytes", "library_ms": None,
            "call_ms": t["call_ms"], "bytes": t["bytes"],
            "gb_per_s": t["bytes"] / t["ms"] / 1e6,
            "shape": shapes[name],
        })
        if name == "to_rows":
            kernels[-1].update(
                copy_ms=t["copy_ms"], tile_rows=t["tile_rows"],
                stages=t["stages"], smem_bytes=t["smem_bytes"],
                shapes={k: {key: v[key] for key in (
                    "ms", "bound_ms", "plain_ms", "call_ms", "copy_ms",
                    "bytes", "tile_rows", "stages")}
                        for k, v in to_rows_shapes.items()})
        if name == "to_rows_var":
            kernels[-1].update(tile_rows=var_tiles(string_table)[2],
                               tile_ms=t["tile_ms"], direct_path=direct_path)
    print(json.dumps({"main_path": {
        "flagship_rows": FLAGSHIP_ROWS,
        "flagship_first_call_ms": flagship_ms,
        "flagship_step_ms": flagship_steady,
        "bench_shape": f"{BENCH_ROWS}x{BENCH_COLS}",
        "bench_round_trip_first_call_ms": bench_ms,
        "bench_round_trip_ms": bench_steady,
        "jni_door_shape": f"{STRING_ROWS}x{STRING_COLS}",
        "jni_door_first_call_ms": jni_ms,
        "jni_door_round_trip_ms": jni_steady,
        "build_s": build_s}}))
    phase("kernel_timing")
    print(json.dumps({"phase_s": phase_s,
                      "total_s": sum(phase_s.values())}), flush=True)
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
