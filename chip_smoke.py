#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on an NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout, one card
    python3 chip_smoke.py --kernels  # steps 1 to 3 and the wave split only
    python3 chip_smoke.py --mc       # steps 1, 2, K2 at head dim 32 and 18

1. Prints the card (``torch.cuda.get_device_name``) and its power limit.
2. Builds every kernel of the path from ``client_tpu_torch/csrc`` with
   ``nvcc`` (one process per source, all at once) and prints the seconds.
   Counts the flash-attention kernels' instructions (``cuobjdump -sass``)
   and fails unless the bf16 kernel runs on wgmma fed by TMA and the fp32
   one on TF32 mma.sync.
3. Kernel phases: hold each kernel against its plain PyTorch version on the
   card at the shapes the main path gives it, plus its edge cases, with the
   tolerance stated below; then time kernel, plain version and the one
   PyTorch call that computes the same function (flash attention: kernel
   and call in turns, and the call's own kernels named from one
   ``torch.profiler`` pass), and work out the least time the card could
   take (the bound). The kernels: flash attention in bf16 (BERT) and in
   fp32 causal (the generative prefill), the fused decode wave (its split
   and tile edges, repeated calls bit for bit), and the ring all-reduce of
   the row-sharded KV arena (2 to 8 shards on the one card, bit for bit
   against its plain version) and of DLRM's pooled bags ([832, 128], 2
   and 4 shards). The decode wave and the all-reduce are a
   few microseconds of device work behind tens of host work, so their
   device time is taken with calls queued back to back behind a sleeping
   kernel, in turns with the library call, and the decode wave cycles
   over the 4 layers as a decode step does; a call alone, host included,
   is printed beside it. Each prints its launch plan and the registers
   and shared memory of its build (``cuobjdump -res-usage``).
4. Serve phase: starts ``client_tpu_torch``'s HTTP server with ``bert_base``
   and ``bert_long`` on the card (full BERT-base width and depth, random
   weights from a fixed seed), sets every kernel's launch count to 0, sends
   concurrent v2 requests (JSON and binary tensors) so dynamic batching
   forms batches, and checks status, shapes, finite values, agreement with
   the same module run directly with its attention swapped for the plain
   version, that each ``bert_long`` batch launched the flash kernel once per
   layer, and the 404 / 400 error paths. Then every other request again
   over gRPC ``ModelInfer`` on the same engine (a ``GrpcInferenceServer``),
   raw and typed ``int_contents``, held as the HTTP answers are; the flash
   kernel's count must rise by one per layer for each gRPC ``bert_long``
   batch; NOT_FOUND and INVALID_ARGUMENT for an unknown model and a
   wrong shape.
5. Generate phase: an engine and HTTP server with ``tiny_gpt`` and
   ``tiny_gpt_long`` at their registered sizes (decode waves through the
   fused kernel, ``tiny_gpt_long``'s prefill through the fp32 flash kernel),
   one short warm-up round, then launch counts set to 0 and concurrent
   ``/generate_stream`` requests over several prompt buckets, greedy and
   seeded sampled. Every stream must
   equal, token for token, the same model run directly on the card one
   stream at a time on the plain path (einsum prefill, reference decode);
   the launch counts must show the kernels ran; ``/generate`` must match
   the stream; the 400s and a stop token are checked. The same 20 streams
   then go over gRPC ``ModelStreamInfer`` on the same engine (5 RPCs side
   by side, 4 requests multiplexed on each, every third with
   ``response_coalesce``), every token against the plain path, and the
   counts must rise. Wall time, tokens/s and the median inter-token gap
   are printed, not claimed, and so is one observation line: the same 8
   greedy streams over SSE and over gRPC, with and without
   ``response_coalesce``, their median inter-token gap, messages and
   tokens/s.
6. Sharded generate phase: ``tiny_gpt_long`` at its registered size with
   its KV arena split by rows over 2 shards on the card (``kv_shards=2``),
   served over HTTP as ``tiny_gpt_long_kv2``; launch counts set to 0, then
   8 concurrent ``/generate_stream`` streams of 32 tokens (prompts of 3 to
   1,500 tokens, two sampled). Every stream must equal the same prompt run
   directly on the plain unsharded path; every decode step must have
   launched the ring all-reduce once per layer and the decode kernel once
   per layer and shard. Then 4 of the streams over gRPC (2 RPCs of 2),
   with the same checks.
7. Vision phase: ``resnet50``, ``densenet_onnx``,
   ``ssd_mobilenet_v2_coco_quantized``, ``ssd_mobilenet_v2_tpu``,
   ``image_preprocess``, ``ensemble_image``, ``bert_preprocess``,
   ``bert_base``, ``bert_postprocess`` and ``ensemble_bert`` (10 models)
   at their registered full size, random weights from the
   port's seeds, and the four ``simple`` models, served over HTTP and
   gRPC from one engine; 98 concurrent HTTP requests, JSON and
   binary, two of them asking ``resnet50`` for ``classification: 3``,
   built and parsed by the phase's own wire code, not the server's.
   Checks every status, shape and dtype; that dynamic batching put more
   than one request in an execution of ``resnet50`` and of
   ``ssd_mobilenet_v2_tpu``; every SSD output bit for bit against the
   same module run directly on the request's rows at a bucket of its
   ladder; classifier logits within ``CLASSIFIER_RTOL`` (exactness
   printed); the classification strings against the direct top 3; each
   ensemble bit for bit against its steps run by hand; the 400 for a
   shared-memory output. Over gRPC, one request at a time, each answer
   against the same request's HTTP answer: the ``simple`` models byte for
   byte (and against numpy), raw and typed, ``resnet50``'s classification
   strings, ``ensemble_image`` and ``ensemble_bert``; INVALID_ARGUMENT for
   an input that names a shared-memory region. Then prints each model's device time for one
   forward at its largest bucket (queued behind a sleeping kernel, so the
   card never waits on the host), images/s and the share of the bf16 peak
   from it, the wall time of one forward with the card waiting on the
   host's launches, and the
   batched NMS alone at B=16 (host, device, launches). No hand-written
   kernel runs on this path: convolutions and matmuls are cuDNN's and
   cuBLAS's.
8. Stateful phase: one engine behind HTTP and gRPC with ``dlrm``,
   ``dlrm_cached``, ``simple_sequence``, ``simple_sequence_oldest``,
   ``simple_repeat`` at their registered sizes and an MLPerf-shaped DLRM
   (``MLPERF_DLRM``: 26 tables of 65,536 rows x 128, 2 shards on the one
   card combined by the ring all-reduce). Launch counts set to 0, then 96
   concurrent one-row CSR requests (Zipf ids, bags of 1 to 4) over HTTP,
   JSON and binary, and gRPC: the ragged scheduler must batch them, the
   ring all-reduce must launch once per execution, every score must equal
   the request run alone (``DLRM_ATOL``; exactness printed). Then sharded
   against unsharded bag sums bit for bit, ``dlrm`` against its direct run
   and ``dlrm_cached`` (hit rate above 0), the 400s of malformed CSR on
   both transports, and an observation: requests/s and p50/p99 at
   concurrency 32, rows and lookups per execution, the /stats split, and
   one execution's device time at the 4,096-lookup bucket. 64 sequences of
   8 steps on each sequence model (half over HTTP, half on gRPC streams),
   every running sum exact, the oldest strategy's waves wider than one;
   a restart; the 400s; ``simple_repeat`` over SSE and ``ModelStreamInfer``.
9. Shm phase: one engine behind HTTP and gRPC with ``simple``,
   ``simple_string``, ``bert_base``, ``bert_long`` and ``resnet50`` at
   full size, K1's count set to 0. Over the system plane (regions by shm
   key) and the device planes (host-staged regions by handle, on the
   ``cudasharedmemory`` and ``tpusharedmemory`` routes and the ``Cuda*``
   and ``Tpu*`` RPCs), on both frontends: a ``simple``,
   ``simple_string`` (BYTES), ``bert_long`` and ``resnet50`` request
   with its inputs and outputs in a region, every output bit for bit
   against the same request sent inline as binary; status,
   unregister-one and unregister-all; 400 / INVALID_ARGUMENT for an
   unregistered region, a double register and an offset past the region.
   The segments are made and read by the script's own ``mmap`` code and
   handle JSON, not the port's. Then regions made with the port's client
   utilities, served and read back; then, in process, 4 ``bert_long``
   and 16 ``resnet50`` requests at once on device regions of tensors on
   the card with ``keep_outputs_on_device``: every output bit for bit
   against the same rows through the host path at the bucket its batch
   used, each region sharing its batch's output storage, no ``Memcpy
   HtoD`` or ``DtoH`` in a ``torch.profiler`` window around them, K1
   launched 12 times a ``bert_long`` batch; a region filled on a side
   stream just before its request; and one observation line
   (``resnet50``, 64 one-image requests at concurrency 16 over binary
   HTTP, system shm over HTTP and host-staged regions over gRPC:
   requests/s, p50, bytes on the wire and ``compute_input`` a request;
   ``bert_long`` in process on device regions against host arrays).
10. Clients phase: one engine behind HTTP and gRPC with ``bert_base``,
   ``bert_long``, ``tiny_gpt_long``, ``dlrm_mlperf`` (2 shards, K3) and
   ``simple``; every launch count set to 0, then a child process (this
   script with ``--clients-child``) drives them through the port's own
   clients, ``client_tpu_torch.http`` and ``client_tpu_torch.grpc``, and
   must load no torch, jax or ``client_tpu`` module: health, metadata and
   config of every model on both; 4 ``bert_long`` requests one at a time
   and 8 at once over HTTP, 4 over gRPC; 8 greedy ``tiny_gpt_long``
   streams of 32 tokens on one gRPC stream; 16 one-row ``dlrm_mlperf``
   requests over HTTP, every other one with its inputs in system shm; a
   bad model version on each frontend. The counts are read when the child
   exits and each kernel's must have risen (K1 bf16 12 a ``bert_long``
   batch, K3 one a ``dlrm_mlperf`` execution). Then the script holds the
   answers: one at a time bit for bit against the same requests built by
   its own wire code, the 8 at once within ``KERNEL_ATOL``, the streams
   token for token against the plain path, DLRM bit for bit, the
   reference's 400 words. An observation line: ``bert_base``, 64
   requests at concurrency 16 from the child (requests/s, p50, p99, the
   client's ``InferStat`` against the server's ``/stats`` split).
11. Repository phase: a directory repository written for the phase
   (removed at the end): ``config.json`` files from the zoo's configs for
   ``bert_long`` (``version_policy: all``, versions 1 and 2),
   ``tiny_gpt_long``, ``dlrm_mlperf`` (2 shards, K3), ``dlrm_cached``,
   ``ensemble_bert`` with its steps and ``ensemble_bert_logits`` (its
   first two steps), and a copy of ``models/``, served at full size by
   one engine behind HTTP and gRPC, every launch count set to 0. Both
   ``bert_long`` versions over ``/versions/<v>`` and gRPC, bit for bit
   alike and within ``SERVED_ATOL`` of the plain path (K1 bf16 once a
   layer a batch; the serve phase's tolerance for the same comparison, a
   whole 12-layer forward against the module with plain attention); an
   unload over HTTP (400 "not ready", and the raw
   ``torch.cuda.memory_allocated`` falls by at least ``REPO_FREED`` of
   both versions' parameter and buffer bytes), a load over gRPC, a
   ``3/`` under ``latest`` 2 (version 2 kept, 3 served, 1 a 404), then
   ``REPO_CYCLES`` unload/load cycles whose raw memory, cuBLAS's
   workspaces included, may grow at most ``REPO_LEAK``.
   ``tiny_gpt_long`` unloaded with ``REPO_STREAMS``
   streams open (each ends with an error within
   ``REPO_STREAM_WAIT_S``), reloaded, 8 greedy streams token for token
   against the plain path (K1 fp32, K2); ``dlrm_mlperf`` reloaded bit for
   bit, K3 once an execution, and the reloaded model's sharded bag sums
   (K3) bit for bit the unsharded table's; ``dlrm_cached``'s row cache
   emptied by a
   reload; ``ensemble_bert`` unloaded with ``unload_dependents`` (its own
   step goes, the two it shares stay); the SSDs; the index equal on the
   engine, HTTP and gRPC. Memory readings are printed beside the card's
   name and power limit.
12. Observability phase: one engine behind HTTP and gRPC with
   ``bert_long``, ``tiny_gpt_long`` and ``dlrm_mlperf`` (2 shards, K3),
   every launch count set to 0 just before the traffic. ``/metrics`` is
   scraped in both formats (0.0.4 and OpenMetrics) before and after:
   ``tpu_inference_request_success``, ``tpu_inference_exec_count`` and
   the ``tpu_batch_size`` count rise by what was sent and executed, and
   each kernel's launches equal its launches per execution times the
   executions read there (K1 bf16 12 a ``bert_long`` batch; K1 fp32 4 a
   prefill chunk and K2 4 a decode wave, the waves from ``/v2/profile``;
   K3 one a ``dlrm_mlperf`` execution). ``bert_long`` one request at a
   time with a ``traceparent`` over HTTP and gRPC (as a parameter and as
   metadata): the trace id comes back, and the request's spans from
   ``/v2/trace/requests`` agree with its ``Server-Timing`` (or
   ``server_*_us``) within ``OBS_TIMING_MS``. ``model.execute`` armed at
   probability 0.5, seed ``OBS_FAULT_SEED``, over ``OBS_FAULTED``
   requests: the failures are the seed's ``random.Random`` draws,
   counted on ``tpu_fault_injections_total`` and in ``/v2/events``; one
   ``http.pre_read`` drop and one ``grpc.pre_infer`` error; disarmed,
   ``bert_long`` within ``SERVED_ATOL`` of the plain path.
   ``/v2/profile``: each bucket used with its executions, rows, one cold
   first execution and a counted roofline, every MFU and MBU in (0,
   ``OBS_SHARE_MAX``]; ``bert_long``'s bucket 1 FLOPs counted on the card
   within ``OBS_FLOPS_RTOL`` of the same bucket counted on the CPU plain
   path; the decode waves' bytes above the model's parameter bytes (K2's
   arena reads). One ``observability observation:`` JSON line with the
   table, the peaks and ``tpu_device_duty_cycle``.
13. Weights phase: checkpoints written by the port's ``save_params`` from
   in-process twins on the card (``bert_long`` v1 seeded and v2 with
   layer 0's ``w1`` halved, ``bert_base`` with its pooler halved,
   ``tiny_gpt_long`` with layer 0's ``w1`` halved, served again as
   ``tiny_gpt_long_kv2`` over 2 shards), and the JAX-written fixture
   ``tests/torch_data/jax_gpt_ckpt`` (orbax's zstd frames), served from a
   directory repository (``<v>/weights`` and ``weights_path``) by one
   engine behind HTTP and gRPC, every launch count set to 0 just before
   the traffic. One row per request: each BERT answer bit for bit its
   twin's forward, the two versions apart; each greedy stream token for
   token its twin's direct stream (K1 bf16, K1 fp32, K2, K3); the
   fixture's leaves' SHA-256 and greedy streams JAX's, with no JAX or
   ``zstandard`` on the machine. Prints ``bert_base``'s ``save_params``
   and ``load_params`` seconds and MB/s, the fixture's decode rate, each
   restore's ``max_memory_allocated`` peak against its weights' bytes
   (at most ``WEIGHTS_PEAK_MAX``), and a ``weights observation:`` line;
   an unload of the restored ``bert_long`` frees its memory.
14. Overload phase: one engine behind HTTP and gRPC with ``bert_long``,
   ``tiny_gpt_long``, ``tiny_gpt_long_kv2`` (2 shards, K3) and
   ``dlrm_mlperf`` (2 shards, K3), ``CLIENT_TPU_SLO`` set, the census,
   profiler and cost ledger fresh. The census: ``/v2/memory`` and the
   ``MemoryCensus`` RPC agree; ``bert_long``'s ``weights`` row equals its
   parameters' bytes, each ``kv_arena`` row its arena tensors' bytes (the
   2-shard twin's its shards' and ``tok``), ``dlrm_mlperf``'s
   ``embedding`` row its table with no drift, attributed bytes at most
   ``torch.cuda.memory_allocated``; an unload removes ``bert_long``'s row.
   Every launch count set to 0; ``bert_long``'s two workers held
   ``OVER_HOLD_MS`` by a ``model.execute`` latency fault while 1 ms
   requests (``timeout-ms`` over HTTP, ``timeout_ms`` and a 1 ms RPC
   deadline over gRPC) expire: 504 / DEADLINE_EXCEEDED, counted on
   ``tpu_deadline_expirations_total``, only the held requests executed.
   ``bert_long`` at 5 requests/s, burst 2: bursts shed with 429,
   ``Retry-After`` in [0.01, 30] and ``X-Health-State: DEGRADED`` over
   HTTP, RESOURCE_EXHAUSTED with ``retry-after`` and ``retry-pushback-ms``
   over gRPC; the port's clients with a ``RetryPolicy`` get every answer;
   each answer within ``SERVED_ATOL`` of the plain path. Two tenants
   (``X-Tpu-Tenant`` and the ``tenant`` parameter) billed, the ledger's
   device seconds within ``OVER_RECONCILE`` of the profiler's;
   ``/v2/slo`` counts what was sent; a recorder sample with the duty
   cycle, queue depth and the census's card bytes. K1 bf16's launches =
   12 x the ``bert_long`` executions on ``/metrics``. Then ``drain()``
   with 8 ``tiny_gpt_long`` and 4 ``tiny_gpt_long_kv2`` streams
   mid-generation: a new request 503 DRAINING, ``/v2/health/ready`` 503,
   every stream token for token against the plain path, the report clean
   with nothing pending in well under its deadline. Then a child
   ``python -m client_tpu_torch.server --zoo bert_long`` sent SIGTERM with
   requests in flight: all answered, its drain clean, exit 0. One
   ``overload observation:`` line (census rows, drain seconds, sheds,
   expirations, the host µs admission and the deadline check add a
   request).
15. Tuning phase: one engine behind HTTP and gRPC with ``bert_long``
   (one worker, ladder [1, 4], 2 priority levels, level 2 capped at
   ``TUNE_LEVEL_CAP`` queued), ``tiny_gpt_long`` and ``dlrm_mlperf``,
   loaded with ``warmup=True`` and ``CLIENT_TPU_QOS``,
   ``CLIENT_TPU_AUTOTUNE`` and ``CLIENT_TPU_SELFDRIVE`` set, the census
   and profiler fresh. Before any request: K1 bf16 launched 12 x
   ``bert_long``'s buckets, K1 fp32 and K2 by the generative warm-up, K3
   once per ``dlrm_mlperf`` bucket, and every bucket's cold execution in
   ``/v2/profile``. The first request is warm (no ``compile`` in its
   ``Server-Timing``). ``bert_long``'s worker held by a ``model.execute``
   latency fault while batch-class requests (``X-Tpu-Tenant: etl``)
   queue, one past the level's cap shed with 429 in the JAX engine's
   words, then interactive ones (``ui``): the interactive ones make the
   first wave (each waits less than every batch one), and every answer is
   within ``SERVED_ATOL`` of its own feed's plain output; ``/v2/qos`` and
   the ``Qos`` RPC give equal bodies; K1 bf16 = 12 x the executions on
   ``/metrics``. Streams and DLRM requests too; no execution or decode
   dispatch of that traffic is cold. Then the profiler fresh, 2-row
   requests fill bucket 4 half; one ``Autotuner.tick()`` warms bucket 2
   through ``warm_bucket`` (12 K1 launches) and promotes it; its
   reservation is on ``/v2/memory``'s ``autotune_warm`` plan (the arena
   only plans; the drift is the plan less the tagged bytes), the recorder's
   ``hbm_reserved`` is the arena's ``reserved_bytes``, and requests at
   bucket 2 run warm. Self-drive: one tick under a stub's fast burn
   tightens ``bert_long``'s admission, one after the quiet hold restores
   it. Last, ``bert_long`` reloaded without warm-up, for the first
   request's cold ``compute_infer``. One ``tuning observation:`` line
   (the warm seconds per model, the first request's ``compute_infer``
   with and without warm-up, ``warm_bucket``'s seconds, the interactive
   and batch requests' queue ms).
16. Incident phase, in a child process (the script again, with
   ``--incident-child``) started with ``CLIENT_TPU_LOCKDEP=1``, so that
   every lock of the card path is a lockdep lock from import on: one
   engine behind HTTP and gRPC with ``bert_long``, ``tiny_gpt_long`` and
   ``dlrm_mlperf`` (2 shards, K3 at [832, 128]), the blackbox on with the
   ``deadline.burst`` trigger alone. ``bert_long`` requests through shm
   slot rings: spans of one slot, doorbells over HTTP and over gRPC,
   and a span of 4 slots behind a held worker, each answer byte for byte
   the same request's over binary HTTP (the span's requests queued in the
   same order behind the same hold) and within ``SERVED_ATOL`` of the
   plain path. A reaped ring of ``dlrm_mlperf`` requests whose inputs are
   staged descriptors into one registered dataset, each score byte for
   byte the binary HTTP one and within ``DLRM_ATOL`` of the plain path
   (the whole table's bag sums without K3, then the MLPs). A producer process killed with 2 slots in
   flight (the worker held): the slots are failed in its segment, its
   ring detached, ``shm_ring.producer_dead`` and ``detach_inflight`` in
   the journal. A burst of ``storm_count`` expired ``bert_long``
   requests while 4 ``tiny_gpt_long`` streams run: exactly one
   ``deadline.burst`` bundle, and a second burst suppressed by the
   cooldown; the streams token for token against the plain path. Manual
   captures over HTTP and gRPC; ``/v2/debug/bundles`` and
   ``BlackboxBundles`` list the same index; no section of a bundle holds
   an error; the bundles' ``memory`` owners are ``/v2/memory``'s;
   ``tools/blackbox_report.py`` renders the burst's bundle. Each kernel
   launched its count per execution read on ``/metrics``. A lockdep
   violation anywhere fails the phase: lockdep records each one as it
   raises, and the child reads that record after the engine's shutdown
   and prints its count. Prints the lock-order graph's node and edge
   counts and one ``incident observation:`` line (wall µs per
   ``bert_long`` slot through a doorbell against per request over binary
   HTTP, ``capture_ms``, bundle bytes, the reaper's sweep µs).
17. Router phase: three replica processes on the one card, two of them
   the script again (``--replica-child``: ``bert_long``,
   ``tiny_gpt_long``, ``simple_sequence`` and ``dlrm_mlperf`` on 2 shards
   behind HTTP and gRPC, drained on SIGTERM, printing their kernels'
   launches when they exit) and one the real launcher (``python -m
   client_tpu_torch.server --zoo bert_long,tiny_gpt_long,simple_sequence``),
   behind ``python -m client_tpu_torch.router`` (its process maps no
   libtorch). Driven over HTTP by the script's own wire code and the
   port's client: ``bert_long`` requests of 4 rows (each one whole batch)
   at concurrency 8 through the router, each answer byte for byte the
   same request straight to the replica its ``X-Tpu-Replica`` names,
   within ``SERVED_ATOL`` of the plain path, with an ``X-Tpu-Load``
   report, every replica serving some; a ``ModelInfer`` straight to one
   replica with its ``x-tpu-load`` trailer; ``simple_sequence``
   sequences each on the replica ``rendezvous_pick`` names; the fleet
   planes (``/v2/fleet/metrics`` each counter summed
   over the replicas' own ``/metrics``, ``/v2/fleet/{profile,events}``
   per replica, a stitched trace with each replica's phase spans under
   the router's attempt, a placement plan, one fleet capture with no
   section in error); the launcher's replica SIGKILLed under traffic (no
   client error, its breaker open); then, on the two children alone,
   ``tiny_gpt_long`` streams through the router token for token against
   the plain path and ``dlrm_mlperf`` through the router within
   ``DLRM_ATOL`` of the plain path; a rolling drain of one child under
   traffic (``clean``, nothing dropped, the child exits 0) and the last
   replica's drain refused. Each kernel's launches are the children's
   own counts, each of which the child holds equal to its executions
   times the launches per execution when it exits. The launcher's
   replica counts nothing in its process: its executions read on its
   ``/metrics`` before the kill go on a line of their own
   (``launcher_execs``), not into the launches. One ``router
   observation:`` line (p50/p99 wall ms at concurrency 8 through the
   router over three replicas and straight to one, the router's added
   ms, ms from the kill to the open breaker, the drain's seconds, a
   child's µs to build the load report and its header, and cached).
18. Mc phase: the six ``*_mc`` families of ``client_tpu_torch.parallel
   .serving`` at the JAX zoo's widths, each on a mesh that repeats the
   card (``bert_base_mc`` dp2 x tp4, ``bert_long_mc`` dp2 x sp4 with ring
   attention, ``tiny_gpt_mc`` tp8, ``moe_gpt_mc`` ep2 x tp4,
   ``moe_lm_mc`` dp2 x ep2 x tp2, ``pipelined_lm_mc`` dp2 x pp4), on one
   engine behind HTTP and gRPC; launch counts set to 0. 16 forward
   requests over HTTP (BERT and the pipelined LM at once, ``moe_lm_mc``
   one at a time, its routing depending on the batch) and each again over
   gRPC, every answer against the family's unsharded plain path run
   directly on the same weights at the same bucket (BERT within
   ``SERVED_ATOL``, the LMs within ``MC_LM_ATOL``); 12 streams of the two
   generative families at once over SSE and again on 2 gRPC stream RPCs,
   every token equal to the plain path's (a degree-1 mesh, K2's plain
   version). K2's head-dim-32 instantiation must have run (and head dim
   64 not, nor K1 or K3), one wave run directly must launch it once per
   tp shard and layer, and the registered degree-1 builders, loaded by
   name, must answer as the sharded families' plain paths do. Before the
   serving phases, K2 at head dim 32 is held against its plain version at
   ``tiny_gpt_mc``'s arena [4, 65, 128, 8, 32] and a tp8 shard's [4, 65,
   128, 1, 32] (B=16, tile and split edges, repeated calls bit for bit)
   and timed queued, in turns with the head-dim-64 case and with
   ``scaled_dot_product_attention`` on gathered rows.
19. Prints one ``{"kernels": [...]}`` line (each kernel's ``launches`` over
   HTTP and gRPC, beside ``http_launches`` over HTTP alone, which must be
   fewer; the ring all-reduce's include the stateful phase's, and its
   entry carries ``dlrm_shape``, its times at [832, 128]; flash
   attention's include the shm phase's, also given as ``shm_launches``;
   every kernel's include the clients, repository, observability,
   weights, overload, tuning, incident and router phases', also given
   as ``clients_launches``, ``repository_launches``,
   ``observability_launches``, ``weights_launches``,
   ``overload_launches``, ``tuning_launches``, ``incident_launches`` and
   ``router_launches``; K2's head-dim-32 entry, last, counts the mc
   phase's), the ``nvidia-smi`` name and power limit line, and last
   ``{"ok": true, "device": {...}}``.

The gRPC client code of steps 4 to 9, 11 to 15 and 18 is the script's own
(tensors as ``tobytes`` and ``np.frombuffer``, BYTES with a hand-written
length prefix); it uses the port's ``grpc_service_pb2`` and ``grpc_stub``
only, the wire schema. Without ``grpc`` the script fails. Step 10 holds the
port's clients against that code.

``--kernels`` stops after step 3, prints the per-wave host/device split of
``tiny_gpt_long`` over one arena and over 2 shards (built directly, no
engine), then the ``{"kernels": [...]}`` line (launches null) and the
``nvidia-smi`` line, and no ``ok`` line. Copied into an older checkout, it
times that checkout's kernels by the same method, so that two commits can
be compared in one call. ``--mc`` builds the kernels, runs K2 at head dim
32 and the mc phase (step 18), then prints the ``{"kernels": [...]}`` line
with that one entry and the ``nvidia-smi`` line, and no ``ok`` line.

Any failed check raises, so the script exits non-zero and prints no result.
It exits non-zero as well without CUDA, or outside a checkout of the repo.
"""

from __future__ import annotations

import collections
import concurrent.futures
import itertools
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import threading
import time
import http.client
from pathlib import Path

import numpy as np

# Tolerances, each with its reason.
# Kernel vs plain version, bf16 output: both accumulate in fp32, but the
# kernel rounds P to bf16 under a running (tile) max and sums in another
# order, so outputs of magnitude <= ~2 may differ by a couple of bf16 ulps
# (1 ulp = 7.8e-3 at 1.0).
KERNEL_ATOL = 2e-2
# Served BERT vs the same module with plain attention, fp32 outputs of
# magnitude <= ~1.5: a one-ulp difference in an attention output propagates
# through 12 bf16 layers; the batch it ran in also changes the GEMM shapes.
SERVED_ATOL = 6e-2
# fp32 flash kernel vs plain version: fp32 throughout, outputs of
# magnitude <= ~3, sums over up to 2048 keys in another order.
FP32_ATOL = 1e-4
# fp32 flash kernel vs attention in float64, inputs scaled x8 (scores up to
# a few hundred, outputs up to ~35): the fp32 plain version itself misses
# by ~6e-4 there, plain TF32 products by ~0.5 (both printed beside it).
FP32_F64_ATOL = 2e-3
# Decode-wave kernel vs plain version: fp32 throughout, one query over up
# to 2048 keys, sums in another order; the scatter is compared exactly.
DECODE_ATOL = 2e-5
# Ring all-reduce vs plain version: none. Both add in the ring's order, so
# every shard's sum must be equal bit for bit.
RING_SHAPES = ((1, 4, 64), (3, 4, 64), (16, 4, 64))  # decode wave buckets
DLRM_POOLED = (832, 128)  # 32 rows x 26 tables of 128: the DLRM partials

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 (data sheet)
PEAK_TF32_FLOPS = 495e12   # H100 SXM dense TF32 on the tensor cores
PEAK_FP32_FLOPS = 67e12    # H100 SXM fp32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3

N_TIMED = 25


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def _samples_ms(torch, fn) -> list[float]:
    """N_TIMED launches after a warm-up, each bracketed by CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(N_TIMED):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def _time_ms(torch, fn) -> float:
    """Median over N_TIMED launches, each bracketed by CUDA events."""
    return float(np.median(_samples_ms(torch, fn)))


def _time_turns(torch, kernel, library) -> tuple[float, float]:
    """Medians of a kernel and its library call timed in turns (kernel,
    library, library, kernel; N_TIMED launches a turn), so that drift in
    the card's clocks falls on both alike."""
    samples = {"kernel": [], "library": []}
    for name in ("kernel", "library", "library", "kernel"):
        samples[name] += _samples_ms(
            torch, kernel if name == "kernel" else library)
    return (float(np.median(samples["kernel"])),
            float(np.median(samples["library"])))


def _device_kernels(torch, fn) -> str:
    """The kernels one call of ``fn`` ran on the card, longest first, from
    one ``torch.profiler`` pass; "not measured" where the profiler saw no
    device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = sorted(
        (e for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA
         and e.self_device_time_total > 0),
        key=lambda e: -e.self_device_time_total)
    return "; ".join(e.key for e in kernels) or "not measured"


def _queued_samples(torch, fn, reps: int = 20) -> list[float]:
    """Device time per call of a call too short to time alone: ``reps``
    calls queued back to back behind a sleeping kernel, so the device never
    waits on the host between them, over one pair of CUDA events; five such
    runs. ``reps`` stays small enough that the launches of the plain ring
    at 4 shards (~28 a call) do not fill the launch queue."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)  # ~10 ms at the H100's clocks
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return times


def _queued_ms(torch, fn, reps: int = 20) -> float:
    """Median of :func:`_queued_samples`."""
    return float(np.median(_queued_samples(torch, fn, reps)))


def _queued_turns(torch, calls: dict[str, list]) -> dict[str, float]:
    """Device ms per call of several calls (each a list cycled through, one
    per layer), queued back to back (:func:`_queued_samples`) in turns:
    the names in order, then in reverse (kernel, library, library,
    kernel). Medians of the runs of each."""
    samples = {name: [] for name in calls}
    for name in list(calls) + list(reversed(calls)):
        cycle = itertools.cycle(calls[name])
        samples[name] += _queued_samples(torch, lambda: next(cycle)())
    return {name: float(np.median(s)) for name, s in samples.items()}


def _resource_usage(cuda_build, name: str) -> str:
    """Registers, static shared memory and local memory of each kernel in
    the library built from ``csrc/<name>.cu`` (``cuobjdump -res-usage``,
    the figures ``ptxas`` reports)."""
    tool = Path(cuda_build._nvcc()).parent / "cuobjdump"
    out = subprocess.run(
        [str(tool), "-res-usage", str(cuda_build.library_path(name))],
        capture_output=True, text=True, timeout=120, check=True).stdout
    usage, kernel = [], None
    for line in out.splitlines():
        found = re.search(r"Function (\S+):", line)
        if found:
            short = re.search(r"\d+([a-z][a-z0-9_]*_kernel)(?:ILi(\d+)E)?",
                              found.group(1))
            kernel = (short.group(1) + (f"<{short.group(2)}>"
                                        if short.group(2) else "")
                      if short else found.group(1))
            continue
        fields = re.findall(r"(REG|SHARED|LOCAL|STACK):(\d+)", line)
        if kernel and fields:
            usage.append(f"{kernel} " + " ".join(f"{k}:{v}" for k, v in fields))
            kernel = None
    return "; ".join(usage) or "no resource usage found"


def _sass_census(cuda_build) -> dict:
    """Instruction counts of the two flash-attention kernels in the built
    library, from ``cuobjdump -sass``: wgmma (HGMMA), TMA loads (UTMALDG)
    and mma.sync (HMMA, and those with TF32 operands). Fails unless the
    bf16 kernel runs its products on wgmma, loads with TMA and has no
    mma.sync, and every HMMA of the fp32 kernel is TF32."""
    tool = Path(cuda_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run(
        [str(tool), "-sass", str(cuda_build.library_path("flash_attention"))],
        capture_output=True, text=True, timeout=120, check=True).stdout
    census, kernel = {}, None
    for line in sass.splitlines():
        found = re.search(
            r"Function : \S*(flash_fwd_f32_kernel|flash_fwd_kernel)", line)
        if found:
            kernel = "fp32" if "f32" in found.group(1) else "bf16"
            census[kernel] = collections.Counter(
                {"HGMMA": 0, "UTMALDG": 0, "HMMA": 0, "HMMA_TF32": 0})
            continue
        op = re.search(
            r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)", line)
        if kernel is None or op is None:
            continue
        for family in ("HGMMA", "UTMALDG", "HMMA"):
            if op.group(1).startswith(family):
                census[kernel][family] += 1
        if op.group(1).startswith("HMMA") and "TF32" in op.group(1):
            census[kernel]["HMMA_TF32"] += 1
    census = {k: dict(c) for k, c in census.items()}
    print(f"set-up: SASS census of flash_attention (cuobjdump -sass): "
          f"{census}", flush=True)
    _check(set(census) == {"bf16", "fp32"}, f"kernels in the library: {census}")
    bf16, fp32 = census["bf16"], census["fp32"]
    _check(bf16["HGMMA"] > 0 and bf16["UTMALDG"] > 0 and bf16["HMMA"] == 0,
           f"bf16 kernel is not wgmma fed by TMA: {bf16}")
    _check(fp32["HMMA_TF32"] > 0 and fp32["HMMA_TF32"] == fp32["HMMA"],
           f"fp32 kernel is not TF32 mma.sync: {fp32}")
    return census


# -- kernel phase -----------------------------------------------------------

def kernel_phase(torch) -> dict:
    from client_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator().manual_seed(0)

    def qkv(b, s, h):
        # As BERT hands them over: slices of one fused [b, s, 3, h, 64].
        fused = torch.randn(b, s, 3, h, 64, generator=gen).to(
            torch.bfloat16).cuda()
        return fused[:, :, 0], fused[:, :, 1], fused[:, :, 2]

    def tail_bias(b, s):
        # BERT's additive mask: -1e9 past each row's length.
        lengths = [s, s * 3 // 4, s // 2, 17][:b]
        mask = torch.ones(b, s)
        for i, n in enumerate(lengths):
            mask[i, n:] = 0
        return ((mask - 1.0) * 1e9).cuda()

    errors = {}

    def compare(label, q, k, v, bias, causal=False):
        out = fa.flash_attention(q, k, v, bias, causal=causal)
        torch.cuda.synchronize()
        ref = fa.flash_attention_plain(q, k, v, bias, causal=causal)
        _check(out.shape == q.shape and out.dtype == torch.bfloat16,
               f"{label}: output {out.dtype} {tuple(out.shape)}")
        _check(bool(torch.isfinite(out).all()), f"{label}: non-finite output")
        err = float((out.float() - ref.float()).abs().max())
        print(f"kernel case {label}: max_abs_err {err} (tolerance "
              f"{KERNEL_ATOL})", flush=True)
        _check(err <= KERNEL_ATOL, f"{label}: max_abs_err {err}")
        errors[label] = err
        return out

    B, S, H, D = 4, 2048, 12, 64  # bert_long at its max batch
    q, k, v = qkv(B, S, H)
    bias = tail_bias(B, S)
    compare("bert_long B4 S2048 H12 tail-masked", q, k, v, bias)
    compare("causal B4 S2048 H12", q, k, v, bias, causal=True)
    inf_bias = torch.zeros(2, 256, device="cuda")
    inf_bias[:, ::3] = -math.inf
    inf_bias[1] = -math.inf  # every key masked: the row must be exactly 0
    qi, ki, vi = qkv(2, 256, 4)
    out = compare("-inf bias, one row fully masked", qi, ki, vi, inf_bias)
    _check(bool((out[1] == 0).all()), "fully masked row is not 0")
    qr, kr, vr = qkv(3, 200, 12)
    compare("ragged S=200", qr, kr, vr, tail_bias(3, 200))

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=bias[:, None, None, :].to(q.dtype))

    ms, library_ms = _time_turns(
        torch, lambda: fa.flash_attention(q, k, v, bias), library)
    plain_ms = _time_ms(torch, lambda: fa.flash_attention_plain(q, k, v, bias))
    library_kernel = _device_kernels(torch, library)
    flops = 4.0 * B * H * S * S * D       # QK^T and PV, 2 FLOP per MAC
    nbytes = 4 * B * S * H * D * 2 + B * S * 4  # q, k, v, out (bf16), bias
    flop_ms = flops / PEAK_BF16_FLOPS * 1e3
    byte_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    print(f"flash_attention at B{B} S{S} H{H} D{D}: kernel {ms} ms "
          f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms} ms, "
          f"scaled_dot_product_attention {library_ms} ms (timed in turns "
          f"with the kernel; it ran {library_kernel}); bound "
          f"{max(flop_ms, byte_ms)} ms ({flops:.3e} FLOP, {nbytes} bytes)",
          flush=True)
    return {
        "name": "flash_attention",
        "route": "cuda",
        "source": "client_tpu_torch/csrc/flash_attention.cu",
        "replaces": "client_tpu/ops/flash_attention.py:31",
        "launches": None,  # from the serve phase
        "max_abs_err": max(errors.values()),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(flop_ms, byte_ms),
        "bound_by": "operations" if flop_ms >= byte_ms else "bytes",
        "library_ms": library_ms,
        "library_call": "scaled_dot_product_attention, float mask",
        "library_kernel": library_kernel,
    }


def _fp32_accuracy(torch, fa) -> None:
    """The fp32 kernel against attention computed in float64, with inputs
    scaled x8 so that the rounding of each product shows; the plain
    version in fp32 and with TF32 products, and the library call, beside
    it. TF32 is switched on for that one call only."""
    for causal in (False, True):
        gen = torch.Generator(device="cuda").manual_seed(7)
        fused = torch.randn(2, 512, 3, 2, 64, device="cuda",
                            generator=gen) * 8
        q, k, v = fused[:, :, 0], fused[:, :, 1], fused[:, :, 2]
        scores = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()) / 8
        if causal:
            keep = torch.ones(512, 512, dtype=torch.bool,
                              device="cuda").tril()
            scores = scores.masked_fill(~keep, -math.inf)
        ref = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, -1),
                           v.double())
        errs = {"kernel": fa.flash_attention(q, k, v, causal=causal),
                "plain fp32": fa.flash_attention_plain(q, k, v,
                                                       causal=causal),
                "library": torch.nn.functional.scaled_dot_product_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    is_causal=causal).transpose(1, 2)}
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            errs["plain TF32"] = fa.flash_attention_plain(q, k, v,
                                                          causal=causal)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        errs = {name: float((out.double() - ref).abs().max())
                for name, out in errs.items()}
        print(f"kernel case fp32 x8 inputs {'causal' if causal else 'full'} "
              f"B2 S512 H2 against float64 (|out| up to "
              f"{float(ref.abs().max()):.1f}): max_abs_err {errs} "
              f"(kernel tolerance {FP32_F64_ATOL})", flush=True)
        _check(errs["kernel"] <= FP32_F64_ATOL,
               f"fp32 x8 against float64: {errs}")


def kernel_phase_fp32(torch) -> dict:
    """The fp32 instantiation, at tiny_gpt_long's prefill shape."""
    from client_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(1)

    def qkv(b, s, h):
        return [torch.randn(b, s, h, 64, device="cuda", generator=gen)
                for _ in range(3)]

    errors = []

    def compare(label, q, k, v, bias, causal):
        out = fa.flash_attention(q, k, v, bias, causal=causal)
        torch.cuda.synchronize()
        ref = fa.flash_attention_plain(q, k, v, bias, causal=causal)
        _check(out.shape == q.shape and out.dtype == torch.float32,
               f"{label}: output {out.dtype} {tuple(out.shape)}")
        _check(bool(torch.isfinite(out).all()), f"{label}: non-finite output")
        err = float((out - ref).abs().max())
        print(f"kernel case fp32 {label}: max_abs_err {err} (tolerance "
              f"{FP32_ATOL})", flush=True)
        _check(err <= FP32_ATOL, f"fp32 {label}: max_abs_err {err}")
        errors.append(err)

    B, S, H, D = 8, 2048, 4, 64  # tiny_gpt_long: admit lanes, max bucket
    q, k, v = qkv(B, S, H)
    compare("causal B8 S2048 H4", q, k, v, None, True)
    qr, kr, vr = qkv(3, 200, 4)
    compare("causal ragged S=200", qr, kr, vr, None, True)
    tail = torch.zeros(3, 200, device="cuda")
    tail[1, 150:] = -1e9
    tail[2, :] = -math.inf  # every key masked: the row must be exactly 0
    compare("tail-masked ragged S=200", qr, kr, vr, tail, False)
    out = fa.flash_attention(qr, kr, vr, tail)
    _check(bool((out[2] == 0).all()), "fp32: fully masked row is not 0")
    _fp32_accuracy(torch, fa)

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True)

    ms, library_ms = _time_turns(
        torch, lambda: fa.flash_attention(q, k, v, causal=True), library)
    plain_ms = _time_ms(
        torch, lambda: fa.flash_attention_plain(q, k, v, causal=True))
    library_kernel = _device_kernels(torch, library)
    # Causal: only the S(S+1)/2 (query, key) pairs on or below the diagonal.
    flops = 4.0 * B * H * D * S * (S + 1) / 2
    nbytes = 4 * B * S * H * D * 4  # q, k, v read, out written (fp32)
    # The faster of the two fp32-accurate routes: SIMT FMAs, or three TF32
    # products per product on the tensor cores (the 3xTF32 split).
    simt_ms = flops / PEAK_FP32_FLOPS * 1e3
    tf32x3_ms = 3 * flops / PEAK_TF32_FLOPS * 1e3
    flop_ms = min(simt_ms, tf32x3_ms)
    byte_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    route = ("3xTF32 on the tensor cores: 3 x FLOP / 495 TFLOP/s"
             if tf32x3_ms <= simt_ms else "SIMT fp32: FLOP / 67 TFLOP/s")
    print(f"flash_attention fp32 causal at B{B} S{S} H{H} D{D}: kernel {ms} "
          f"ms ({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms} ms, "
          f"scaled_dot_product_attention {library_ms} ms (timed in turns "
          f"with the kernel; it ran {library_kernel}); bound "
          f"{max(flop_ms, byte_ms)} ms "
          f"({flops:.3e} FLOP, {nbytes} bytes; {route}; SIMT alone "
          f"{simt_ms} ms)", flush=True)
    return {
        "name": "flash_attention_fp32",
        "route": "cuda",
        "source": "client_tpu_torch/csrc/flash_attention.cu",
        "replaces": "client_tpu/ops/flash_attention.py:31",
        "launches": None,  # from the generate phase
        "max_abs_err": max(errors),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(flop_ms, byte_ms),
        "bound_by": "operations" if flop_ms >= byte_ms else "bytes",
        "bound_route": route,
        "library_ms": library_ms,
        "library_call": "scaled_dot_product_attention, is_causal",
        "library_kernel": library_kernel,
    }


def _decode_occupancy(cuda_build, b: int, h: int, n_split: int,
                      head_dim: int) -> str:
    """The decode kernel's dynamic shared memory per CTA and the clusters
    of ``n_split`` CTAs the card holds at once
    (``cudaOccupancyMaxActiveClusters``), for one head dim."""
    import ctypes

    lib = cuda_build.load("decode_attention")
    fn = getattr(lib, "client_tpu_decode_wave_occupancy", None)
    if fn is None:  # a tree from before the clustered kernel
        return "occupancy not reported by this build"
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    smem, clusters = ctypes.c_int(0), ctypes.c_int(0)
    err = fn(b, h, n_split, head_dim, ctypes.byref(smem),
             ctypes.byref(clusters))
    _check(err == 0, f"cudaOccupancyMaxActiveClusters failed: error {err}")
    return (f"{smem.value} bytes of dynamic shared memory a CTA, at most "
            f"{clusters.value} clusters of {n_split} resident at once")


def _decode_bound(lens_np, b: int, heads: int, dim: int
                  ) -> tuple[float, str, int]:
    """(bound ms, what bounds it, bytes) of one K2 call: each lane's valid
    K/V prefix read once, q, k_new, v_new read and o written, the two
    scattered slots, rows and lens; 4 H D (sum of lens + B) FLOPs."""
    lane_bytes = heads * dim * 4
    nbytes = (2 * int(np.sum(lens_np)) * lane_bytes + 4 * b * lane_bytes
              + 2 * b * lane_bytes + 2 * b * 4)
    flops = 4.0 * heads * dim * (int(np.sum(lens_np)) + b)
    byte_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    flop_ms = flops / PEAK_FP32_FLOPS * 1e3
    return (max(byte_ms, flop_ms),
            "bytes" if byte_ms >= flop_ms else "operations", nbytes)


def kernel_phase_decode(torch, cuda_build) -> dict:
    """The fused decode wave at tiny_gpt_long's arena shape."""
    from client_tpu_torch.ops import decode_attention as da

    L, R, S, H, D = 4, 17, 2048, 4, 64  # 16 stream rows + the dummy row 16
    dummy = R - 1
    gen = torch.Generator(device="cuda").manual_seed(2)
    k_arena = torch.randn(L, R, S, H, D, device="cuda", generator=gen)
    v_arena = torch.randn(L, R, S, H, D, device="cuda", generator=gen)
    rng = np.random.default_rng(2)
    cases = {  # label: (rows, lens); lanes on the dummy row are padding
        "B1": ([5], [2047]),
        "B3": ([2, 9, dummy], [1, 777, 0]),
        "B16": (list(range(12)) + [dummy] * 4,
                [0, 1, 2047] + rng.integers(2, 1600, 9).tolist() + [0] * 4),
        # Split and tile edges: 32-key tiles, a new CTA every 256 keys.
        "edges": (list(range(16)),
                  [1, 31, 32, 33, 255, 256, 257, 511, 512, 513, 1791, 1792,
                   1793, 2046, 2047, 0]),
        "B16 all 2047": (list(range(16)), [2047] * 16),
    }
    errors = []
    for layer, (label, (rows, lens)) in enumerate(cases.items()):
        layer %= L
        rows_np = np.asarray(rows, np.int32)
        lens_np = np.asarray(lens, np.int32)
        b = len(rows_np)
        real = rows_np != dummy
        q, kn, vn = (torch.randn(b, H, D, device="cuda", generator=gen)
                     for _ in range(3))
        index = da.WaveIndex(rows_np, lens_np, R, S, "cuda")
        k_ref, v_ref = k_arena.clone(), v_arena.clone()
        o = da.decode_wave_attention(k_arena, v_arena, q, kn, vn, index,
                                     layer=layer)
        torch.cuda.synchronize()
        o_ref = da.decode_wave_attention_plain(k_ref, v_ref, q, kn, vn,
                                               index, layer=layer)
        err = float((o[real] - o_ref[real]).abs().max())
        print(f"kernel case decode {label} lens {lens}: max_abs_err {err} "
              f"(tolerance {DECODE_ATOL})", flush=True)
        _check(err <= DECODE_ATOL, f"decode {label}: max_abs_err {err}")
        _check(bool(torch.isfinite(o).all()), f"decode {label}: non-finite")
        errors.append(err)
        for i in np.flatnonzero(real & (lens_np == 0)):
            _check(bool(torch.equal(o[i], vn[i])),
                   f"decode {label} lane {i}: lens 0 is not exactly v_new")
        # Untouched rows bit-identical, scattered slots equal to the
        # inputs: every row but the dummy equals the plain version's.
        _check(bool(torch.equal(k_arena[:, :dummy], k_ref[:, :dummy])
                    and torch.equal(v_arena[:, :dummy], v_ref[:, :dummy])),
               f"decode {label}: arena differs from the plain scatter")
        r = torch.from_numpy(rows_np[real]).long().cuda()
        n = torch.from_numpy(lens_np[real]).long().cuda()
        _check(bool(torch.equal(k_arena[layer, r, n], kn[real])
                    and torch.equal(v_arena[layer, r, n], vn[real])),
               f"decode {label}: scattered slots differ from the inputs")
        # The merge runs in a fixed order: a second call gives the same bits.
        again = da.decode_wave_attention(k_arena, v_arena, q, kn, vn, index,
                                         layer=layer)
        _check(bool(torch.equal(again, o)),
               f"decode {label}: two identical calls differ")
        del k_ref, v_ref
    print("decode kernel: lens 0 gives exactly v_new; untouched rows and "
          "scattered slots bit-identical; repeated calls bit-identical",
          flush=True)

    # Timing at B=16, the largest wave bucket of tiny_gpt_long, over all 4
    # layers in turn, as a decode step walks them: one layer's valid
    # prefix (16 MB) fits the 50 MB L2, four do not.
    rows_np = np.asarray(cases["B16"][0], np.int32)
    lens_np = np.asarray(cases["B16"][1], np.int32)
    index = da.WaveIndex(rows_np, lens_np, R, S, "cuda")
    b = len(rows_np)
    # A tree from before the split plan launches one CTA per (lane, head).
    n_split = getattr(index, "n_split", 1)
    longest = int(lens_np.max())
    share = min(longest, (-(-longest // n_split) + 31) // 32 * 32)  # tiles
    print(f"decode split plan at B{b}: n_split {n_split}, {n_split * H * b} "
          f"CTAs, at most {share} keys per CTA (longest lane {longest}); "
          f"{_decode_occupancy(cuda_build, b, H, n_split, D)}; "
          f"{_resource_usage(cuda_build, 'decode_attention')}", flush=True)
    q, kn, vn = (torch.randn(b, H, D, device="cuda", generator=gen)
                 for _ in range(3))
    k_ref, v_ref = k_arena.clone(), v_arena.clone()
    rows_t = index.rows.long()
    lens_t = index.lens.long()
    gathered = [(k_ref[layer, rows_t].transpose(1, 2),  # beforehand
                 v_ref[layer, rows_t].transpose(1, 2)) for layer in range(L)]
    mask = (torch.arange(S, device="cuda")[None, :] <= lens_t[:, None])
    kernel = [lambda layer=layer: da.decode_wave_attention(
        k_arena, v_arena, q, kn, vn, index, layer=layer) for layer in range(L)]
    library = [lambda ck=ck, cv=cv: torch.nn.functional
               .scaled_dot_product_attention(q[:, :, None], ck, cv,
                                             attn_mask=mask[:, None, None, :])
               for ck, cv in gathered]
    times = _queued_turns(torch, {"kernel": kernel, "library": library})
    ms, library_ms = times["kernel"], times["library"]
    alone_ms = _time_ms(torch, kernel[0])
    plain_ms = _queued_ms(torch, lambda: da.decode_wave_attention_plain(
        k_ref, v_ref, q, kn, vn, index, layer=0))
    library_kernel = _device_kernels(torch, library[0])
    bound_ms, bound_by, nbytes = _decode_bound(lens_np, b, H, D)
    print(f"decode_wave_attention at B{b} (sum of lens {int(lens_np.sum())}"
          f"), device ms per call queued back to back over the {L} layers, "
          f"in turns with the library call: kernel {ms} ms "
          f"({nbytes / ms / 1e6:.1f} GB/s, {100 * bound_ms / ms:.1f}% of the "
          f"bound), scaled_dot_product_attention {library_ms} ms (it ran "
          f"{library_kernel}); one kernel call alone, host included, "
          f"{alone_ms} ms; plain {plain_ms} ms; bound {bound_ms} ms "
          f"({nbytes} bytes)", flush=True)
    return {
        "name": "decode_wave_attention",
        "route": "cuda",
        "source": "client_tpu_torch/csrc/decode_attention.cu",
        "replaces": "client_tpu/ops/decode_kernel.py:58",
        "launches": None,  # from the generate phase
        "max_abs_err": max(errors),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
        "library_call": "scaled_dot_product_attention over rows gathered "
                        "beforehand, boolean mask; no scatter, no gather",
        "library_kernel": library_kernel,
        "alone_ms": alone_ms,
        "n_split": n_split,
    }


def _decode_case(torch, da, k_arena, v_arena, gen, rows, lens, layer,
                 label: str) -> float:
    """One K2 call against its plain version on clones of the arena (the
    last row is the dummy): max error on the real lanes, exactly v_new at
    lens 0, every other row bit-identical, the scattered slots equal to
    the inputs, and a second call bit-identical."""
    dummy = k_arena.shape[1] - 1
    rows_np, lens_np = np.asarray(rows, np.int32), np.asarray(lens, np.int32)
    b, (heads, dim) = len(rows_np), k_arena.shape[3:]
    real = rows_np != dummy
    q, kn, vn = (torch.randn(b, heads, dim, device=k_arena.device,
                             generator=gen) for _ in range(3))
    index = da.WaveIndex(rows_np, lens_np, k_arena.shape[1],
                         k_arena.shape[2], k_arena.device)
    k_ref, v_ref = k_arena.clone(), v_arena.clone()
    o = da.decode_wave_attention(k_arena, v_arena, q, kn, vn, index,
                                 layer=layer)
    torch.cuda.synchronize()
    o_ref = da.decode_wave_attention_plain(k_ref, v_ref, q, kn, vn, index,
                                           layer=layer)
    err = float((o[real] - o_ref[real]).abs().max())
    print(f"kernel case decode head dim {dim} {label} lens {lens}: "
          f"max_abs_err {err} (tolerance {DECODE_ATOL})", flush=True)
    _check(err <= DECODE_ATOL, f"decode hd{dim} {label}: max_abs_err {err}")
    _check(bool(torch.isfinite(o).all()), f"decode hd{dim} {label}: non-finite")
    for i in np.flatnonzero(real & (lens_np == 0)):
        _check(bool(torch.equal(o[i], vn[i])),
               f"decode hd{dim} {label} lane {i}: lens 0 is not v_new")
    _check(bool(torch.equal(k_arena[:, :dummy], k_ref[:, :dummy])
                and torch.equal(v_arena[:, :dummy], v_ref[:, :dummy])),
           f"decode hd{dim} {label}: arena differs from the plain scatter")
    again = da.decode_wave_attention(k_arena, v_arena, q, kn, vn, index,
                                     layer=layer)
    _check(bool(torch.equal(again, o)),
           f"decode hd{dim} {label}: two identical calls differ")
    return err


def kernel_phase_decode_hd32(torch, cuda_build) -> dict:
    """K2's head-dim-32 instantiation (tiny_gpt_mc and moe_gpt_mc): held
    against its plain version at tiny_gpt_mc's arena [4, 65, 128, 8, 32]
    (64 stream rows + the dummy) at B=16 with padded lanes, tile and split
    edges, and on a tp8 shard's one head ([4, 65, 128, 1, 32], the shape
    the served path gives it); then timed queued over the 4 layers, in
    turns with the head-dim-64 case of tiny_gpt_long ([4, 17, 2048, 4,
    64] at B=16) and with scaled_dot_product_attention on gathered rows."""
    from client_tpu_torch.ops import decode_attention as da

    L, R, S, D = 4, 65, 128, 32
    gen = torch.Generator(device="cuda").manual_seed(32)
    arenas = {heads: (torch.randn(L, R, S, heads, D, device="cuda",
                                  generator=gen),
                      torch.randn(L, R, S, heads, D, device="cuda",
                                  generator=gen)) for heads in (8, 1)}
    rng = np.random.default_rng(32)
    b16 = (list(range(12)) + [R - 1] * 4,
           [0, 1, 127] + rng.integers(2, 120, 9).tolist() + [0] * 4)
    cases = {
        "B16": b16,
        "B1": ([5], [127]),
        "edges": (list(range(10)), [1, 31, 32, 33, 63, 64, 65, 95, 126, 127]),
        "B64 all 127": (list(range(64)), [127] * 64),
    }
    errors = []
    for heads, (k_a, v_a) in arenas.items():
        for layer, (label, (rows, lens)) in enumerate(cases.items()):
            errors.append(_decode_case(torch, da, k_a, v_a, gen, rows, lens,
                                       layer % L, f"H{heads} {label}"))
    # The split edges need a longer arena: 256-key shares, one head.
    long_k = torch.randn(2, 5, 2048, 1, D, device="cuda", generator=gen)
    long_v = torch.randn(2, 5, 2048, 1, D, device="cuda", generator=gen)
    for n in (255, 256, 257, 511, 512, 513, 1793, 2047):
        errors.append(_decode_case(torch, da, long_k, long_v, gen, [1, 4],
                                   [n, 0], 1, f"split n={n}"))
    del long_k, long_v
    print("decode kernel head dim 32: lens 0 gives exactly v_new; untouched "
          "rows bit-identical; repeated calls bit-identical", flush=True)

    # Timing: the B16 case over the 4 layers, unsharded (8 heads) and on a
    # tp8 shard (1 head), beside the head-dim-64 case and the library.
    rows_np, lens_np = (np.asarray(x, np.int32) for x in b16)
    b = len(rows_np)
    hd64 = [torch.randn(4, 17, 2048, 4, 64, device="cuda", generator=gen)
            for _ in range(2)]
    rows64 = np.asarray(list(range(12)) + [16] * 4, np.int32)
    lens64 = np.asarray([0, 1, 2047] + np.random.default_rng(2).integers(
        2, 1600, 9).tolist() + [0] * 4, np.int32)
    index64 = da.WaveIndex(rows64, lens64, 17, 2048, "cuda")
    q64, kn64, vn64 = (torch.randn(b, 4, 64, device="cuda", generator=gen)
                       for _ in range(3))
    calls, results = {}, {}
    for heads, (k_a, v_a) in arenas.items():
        index = da.WaveIndex(rows_np, lens_np, R, S, "cuda")
        q, kn, vn = (torch.randn(b, heads, D, device="cuda", generator=gen)
                     for _ in range(3))
        calls[f"hd32 H{heads}"] = [
            lambda layer=layer, k_a=k_a, v_a=v_a, q=q, kn=kn, vn=vn,
            index=index: da.decode_wave_attention(k_a, v_a, q, kn, vn, index,
                                                  layer=layer)
            for layer in range(L)]
        results[heads] = (k_a, v_a, q, kn, vn, index)
    calls["hd64 H4"] = [lambda layer=layer: da.decode_wave_attention(
        hd64[0], hd64[1], q64, kn64, vn64, index64, layer=layer)
        for layer in range(L)]
    k_a, v_a, q, kn, vn, index = results[8]
    rows_t, lens_t = index.rows.long(), index.lens.long()
    gathered = [(k_a[layer, rows_t].transpose(1, 2),
                 v_a[layer, rows_t].transpose(1, 2)) for layer in range(L)]
    mask = torch.arange(S, device="cuda")[None, :] <= lens_t[:, None]
    calls["sdpa H8"] = [
        lambda ck=ck, cv=cv: torch.nn.functional.scaled_dot_product_attention(
            q[:, :, None], ck, cv, attn_mask=mask[:, None, None, :])
        for ck, cv in gathered]
    times = _queued_turns(torch, calls)
    plain_ms = _queued_ms(torch, lambda: da.decode_wave_attention_plain(
        k_a.clone(), v_a.clone(), q, kn, vn, index, layer=0))
    alone_ms = _time_ms(torch, calls["hd32 H8"][0])
    bound_ms, bound_by, nbytes = _decode_bound(lens_np, b, 8, D)
    shard_bound, _, shard_bytes = _decode_bound(lens_np, b, 1, D)
    occupancy = {heads: _decode_occupancy(
        cuda_build, b, heads, getattr(results[heads][5], "n_split", 1), D)
        for heads in arenas}
    bound64, _, _ = _decode_bound(lens64, b, 4, 64)
    ms = times["hd32 H8"]
    print(f"decode_wave_attention head dim 32 at B{b} (sum of lens "
          f"{int(lens_np.sum())}), device ms per call queued over the {L} "
          f"layers in turns: [4, 65, 128, 8, 32] {ms} ms "
          f"({nbytes / ms / 1e6:.1f} GB/s, {100 * bound_ms / ms:.1f}% of its "
          f"bound {bound_ms} ms); the tp8 shard [4, 65, 128, 1, 32] "
          f"{times['hd32 H1']} ms (bound {shard_bound} ms, {shard_bytes} "
          f"bytes); head dim 64 [4, 17, 2048, 4, 64] {times['hd64 H4']} ms "
          f"(bound {bound64} ms); scaled_dot_product_attention on gathered "
          f"rows {times['sdpa H8']} ms; one call alone, host included, "
          f"{alone_ms} ms; plain {plain_ms} ms; occupancy at head dim 32: "
          f"H8 {occupancy[8]}, H1 {occupancy[1]}", flush=True)
    return {
        "name": "decode_wave_attention_hd32",
        "route": "cuda",
        "source": "client_tpu_torch/csrc/decode_attention.cu",
        "replaces": "client_tpu/ops/decode_kernel.py:58",
        "launches": None,  # from the mc phase
        "max_abs_err": max(errors),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": times["sdpa H8"],
        "library_call": "scaled_dot_product_attention over rows gathered "
                        "beforehand, boolean mask; no scatter, no gather",
        "shard_ms": times["hd32 H1"],
        "shard_bound_ms": shard_bound,
        "hd64_ms_same_turns": times["hd64 H4"],
        "alone_ms": alone_ms,
        "head_dim": D,
    }


def kernel_phase_ring(torch, cuda_build) -> dict:
    """The ring all-reduce at the decode wave's partial outputs [B, 4, 64]
    (and an odd element count), 2 to 8 shards on the one card."""
    from client_tpu_torch.parallel import kv_shard as ks

    gen = torch.Generator(device="cuda").manual_seed(5)

    def partials(n, shape):
        return [torch.randn(shape, device="cuda", generator=gen) * 4
                for _ in range(n)]

    for n in (2, 3, 4, 8):
        for shape in RING_SHAPES + ((5,),):
            parts = partials(n, shape)
            got = ks.ring_all_reduce(parts)
            torch.cuda.synchronize()
            want = ks.ring_all_reduce_plain(parts)
            _check(len(got) == n, f"ring n={n}: {len(got)} outputs")
            for i, (g, w) in enumerate(zip(got, want)):
                _check(g.shape == shape and bool(torch.equal(g, w)),
                       f"ring n={n} {shape} shard {i}: differs from the "
                       f"plain version by {float((g - w).abs().max())}")
            print(f"kernel case ring n={n} {list(shape)}: every shard's sum "
                  "equals the plain version bit for bit", flush=True)
    one = partials(1, RING_SHAPES[0])
    before = ks.launches
    _check(ks.ring_all_reduce(one)[0] is one[0] and ks.launches == before,
           "ring n=1 launched or copied")
    if torch.cuda.device_count() >= 2:
        try:
            ks.kv_mesh(2)
        except NotImplementedError as exc:
            print(f"ring on distinct cards: not run ({exc})", flush=True)
    else:
        print("ring on distinct cards: not run (1 card visible)", flush=True)

    # Each call is a few microseconds of device work behind tens of host
    # work, so a call timed alone measures the host: the device time is
    # taken with calls queued back to back, kernel and library call in
    # turns (_queued_turns), and the time of a call alone, the host's
    # included (_time_ms), is printed beside it.
    numel = math.prod(RING_SHAPES[-1])
    print(f"ring plan at {list(RING_SHAPES[-1])}: one launch of "
          f"{-(-numel // 4 // 128)} CTAs of 128 threads, one 16-byte group of "
          f"every partial a thread; {_resource_usage(cuda_build, 'ring_all_reduce')}",
          flush=True)
    timed = {}
    for n in (2, 4):
        parts = partials(n, RING_SHAPES[-1])
        calls = {"kernel": lambda: ks.ring_all_reduce(parts),
                 "plain": lambda: ks.ring_all_reduce_plain(parts),
                 "torch.stack(...).sum(0)": lambda: torch.stack(parts).sum(0)}
        turns = _queued_turns(torch, {
            "kernel": [calls["kernel"]],
            "torch.stack(...).sum(0)": [calls["torch.stack(...).sum(0)"]]})
        queued = {"kernel": turns["kernel"],
                  "plain": _queued_ms(torch, calls["plain"]),
                  "torch.stack(...).sum(0)": turns["torch.stack(...).sum(0)"]}
        alone = {k: _time_ms(torch, f) for k, f in calls.items()}
        timed[n] = tuple(queued.values())
        nbytes = 2 * n * numel * 4  # n partials read, n sums written
        flops = (n - 1) * n * numel
        print(f"ring_all_reduce n={n} at {list(RING_SHAPES[-1])} fp32, device "
              f"ms per call queued back to back {queued}, one call alone "
              f"{alone}; bound "
              f"{max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOPS) * 1e3}"
              f" ms ({nbytes} bytes, {flops} additions)", flush=True)
    dlrm_shape = _ring_dlrm_shape(torch, ks, partials)
    ms, plain_ms, library_ms = timed[2]  # the main path: 2 shards
    nbytes, flops = 2 * 2 * numel * 4, 2 * numel
    byte_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    flop_ms = flops / PEAK_FP32_FLOPS * 1e3
    return {
        "name": "ring_all_reduce",
        "route": "cuda",
        "source": "client_tpu_torch/csrc/ring_all_reduce.cu",
        "replaces": "client_tpu/parallel/kv_shard.py:84",
        "launches": None,  # from the sharded generate phase
        "max_abs_err": 0.0,  # checked bit for bit above
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(byte_ms, flop_ms),
        "bound_by": "bytes" if byte_ms >= flop_ms else "operations",
        "library_ms": library_ms,
        "library_call": "torch.stack(partials).sum(0) on the one card",
        # The second call site: the pooled bags of the row-sharded DLRM
        # tables (stateful phase), 2 shards on the one card.
        "dlrm_shape": dlrm_shape,
    }


def _ring_bound(n: int, numel: int) -> tuple[float, str]:
    """(ms, what bounds it) for an all-reduce of ``n`` fp32 partials of
    ``numel``: each partial read once and each of the ``n`` sums written
    once, against ``(n - 1) * n * numel`` additions."""
    nbytes, flops = 2 * n * numel * 4, (n - 1) * n * numel
    byte_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    flop_ms = flops / PEAK_FP32_FLOPS * 1e3
    return max(byte_ms, flop_ms), ("bytes" if byte_ms >= flop_ms
                                   else "operations")


def _ring_dlrm_shape(torch, ks, partials) -> dict:
    """K3 at DLRM's pooled shape, ``[max_batch_size * num_tables,
    emb_dim]`` = [832, 128] of the MLPerf-shaped model: 2 and 4 shards,
    every shard's sum bit for bit against the plain version, then timed
    queued in turns with ``torch.stack(partials).sum(0)``."""
    shape = DLRM_POOLED
    out = {}
    for n in (2, 4):
        parts = partials(n, shape)
        got = ks.ring_all_reduce(parts)
        torch.cuda.synchronize()
        for i, (g, w) in enumerate(zip(got, ks.ring_all_reduce_plain(parts))):
            _check(g.shape == shape and bool(torch.equal(g, w)),
                   f"ring n={n} {list(shape)} shard {i} differs from the plain "
                   f"version by {float((g - w).abs().max())}")
        turns = _queued_turns(torch, {
            "kernel": [lambda: ks.ring_all_reduce(parts)],
            "library": [lambda: torch.stack(parts).sum(0)]})
        ms, library_ms = turns["kernel"], turns["library"]
        plain_ms = _queued_ms(torch, lambda: ks.ring_all_reduce_plain(parts))
        bound_ms, bound_by = _ring_bound(n, math.prod(shape))
        print(f"ring_all_reduce n={n} at {list(shape)} fp32 (DLRM's pooled "
              f"bags): every shard's sum equals the plain version bit for "
              f"bit; device ms per call queued back to back: kernel {ms}, "
              f"plain {plain_ms}, torch.stack(...).sum(0) {library_ms}; "
              f"bound {bound_ms} ms ({bound_by})", flush=True)
        out[f"n{n}"] = {"shape": list(shape), "ms": ms, "plain_ms": plain_ms,
                        "library_ms": library_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "max_abs_err": 0.0}
    return out


# -- gRPC client ------------------------------------------------------------
# The phases' own gRPC tensor code, built from the protocol's text as the
# vision phase's HTTP wire code is: raw contents are little-endian
# ``arr.tobytes()``, a BYTES element a 4-byte little-endian length and then
# its bytes, read back with ``np.frombuffer``; never the server's codec, so
# that a fault shared by the server's encoder and decoder cannot pass. The
# messages are the port's ``grpc_service_pb2``: the wire schema itself.

# The wire dtypes of both clients, HTTP's and gRPC's.
_WIRE_DTYPES = {"FP32": np.float32, "INT32": np.int32, "UINT32": np.uint32,
                "INT8": np.int8, "UINT8": np.uint8}
GRPC_TIMEOUT_S = 600


def _grpc_channel(url: str):
    """(channel, stub) for the server at ``url``; close the channel."""
    import grpc

    from client_tpu_torch.protocol.grpc_stub import GRPCInferenceServiceStub

    channel = grpc.insecure_channel(url)
    return channel, GRPCInferenceServiceStub(channel)


def _set_param(param_map, key: str, value) -> None:
    p = param_map[key]
    if isinstance(value, bool):
        p.bool_param = value
    elif isinstance(value, int):
        p.int64_param = value
    elif isinstance(value, float):
        p.double_param = value
    else:
        p.string_param = str(value)


def _grpc_request(model: str, inputs: dict[str, np.ndarray],
                  outputs: list | None = None, typed: bool = False,
                  request_id: str = "", parameters: dict | None = None):
    """A ModelInferRequest: every input as raw contents, or when ``typed``
    with the INT32 and INT8 ones as ``int_contents`` and the BYTES ones as
    ``bytes_contents``."""
    from client_tpu_torch.protocol import grpc_service_pb2 as pb

    names = {np.dtype(v): k for k, v in _WIRE_DTYPES.items()}
    req = pb.ModelInferRequest(model_name=model, id=request_id)
    for name, arr in inputs.items():
        wire = "BYTES" if arr.dtype == np.object_ else names[arr.dtype]
        tensor = req.inputs.add(name=name, datatype=wire,
                                shape=list(arr.shape))
        if typed and wire in ("INT32", "INT8"):
            tensor.contents.int_contents.extend(int(x) for x in arr.ravel())
        elif typed and wire == "BYTES":
            tensor.contents.bytes_contents.extend(arr.ravel().tolist())
        else:
            req.raw_input_contents.append(_wire_bytes(arr))
    for o in outputs or []:
        out = req.outputs.add(name=o["name"])
        for k, v in (o.get("parameters") or {}).items():
            _set_param(out.parameters, k, v)
    for k, v in (parameters or {}).items():
        _set_param(req.parameters, k, v)
    return req


def _grpc_outputs(resp) -> dict[str, np.ndarray]:
    """Every output of a ModelInferResponse from its raw contents."""
    _check(len(resp.outputs) == len(resp.raw_output_contents),
           f"{len(resp.outputs)} outputs, {len(resp.raw_output_contents)} "
           "raw contents")
    out = {}
    for tensor, raw in zip(resp.outputs, resp.raw_output_contents):
        if tensor.datatype == "BYTES":
            arr = _bytes_elements(raw)
        else:
            dtype = np.dtype(_WIRE_DTYPES[tensor.datatype])
            arr = np.frombuffer(raw, dtype.newbyteorder("<")).astype(dtype)
        out[tensor.name] = arr.reshape([int(d) for d in tensor.shape])
    return out


def _grpc_final(resp) -> bool:
    p = resp.parameters
    return ("triton_final_response" in p
            and p["triton_final_response"].bool_param)


def _grpc_streams(url: str, streams: list) -> dict[str, tuple]:
    """One ModelStreamInfer RPC carrying every ``(request_id, model,
    prompt, parameters)`` of ``streams``, multiplexed. Per request: its
    tokens, the arrival time of each (monotonic seconds; the tokens of one
    coalesced message share it) and its count of messages. Checks that no
    message is an error, that INDEX runs on without a gap, and that each
    request ends with one final message that carries no tokens."""
    channel, stub = _grpc_channel(url)
    try:
        requests = [_grpc_request(model, {"INPUT_IDS": np.asarray(
            prompt, np.int32)}, request_id=rid, parameters=params)
            for rid, model, prompt, params in streams]
        got = {rid: ([], [], [0]) for rid, *_ in streams}
        finals = set()
        for msg in stub.ModelStreamInfer(iter(requests),
                                         timeout=GRPC_TIMEOUT_S):
            t = time.monotonic()
            resp = msg.infer_response
            _check(not msg.error_message,
                   f"stream {resp.id}: {msg.error_message}")
            _check(resp.id in got and resp.id not in finals,
                   f"stream message for {resp.id!r} after its final")
            tokens, times, count = got[resp.id]
            if _grpc_final(resp):
                _check(not resp.outputs, f"{resp.id}: final with tokens")
                finals.add(resp.id)
                continue
            outs = _grpc_outputs(resp)
            k = len(outs["TOKEN"])
            _check(outs["INDEX"].tolist()
                   == list(range(len(tokens), len(tokens) + k)),
                   f"{resp.id}: INDEX {outs['INDEX']} after {len(tokens)}")
            tokens += outs["TOKEN"].tolist()
            times += [t] * k
            count[0] += 1
        _check(finals == set(got), f"no final for {set(got) - finals}")
        return {rid: (tokens, times, count[0])
                for rid, (tokens, times, count) in got.items()}
    finally:
        channel.close()


def _grpc_stream_rpcs(url: str, rpcs: list[list]) -> dict[str, tuple]:
    """Several ModelStreamInfer RPCs side by side (:func:`_grpc_streams`
    on each), their results merged."""
    with concurrent.futures.ThreadPoolExecutor(len(rpcs)) as pool:
        parts = list(pool.map(lambda streams: _grpc_streams(url, streams),
                              rpcs))
    return {rid: res for part in parts for rid, res in part.items()}


# -- serve phase ------------------------------------------------------------

def _post(port: int, path: str, body: bytes, headers: dict | None = None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("POST", path, body, headers or {})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def _json_request(ids: np.ndarray, mask: np.ndarray) -> bytes:
    return json.dumps({"inputs": [
        {"name": "input_ids", "datatype": "INT32", "shape": list(ids.shape),
         "data": ids.ravel().tolist()},
        {"name": "attention_mask", "datatype": "INT32",
         "shape": list(mask.shape), "data": mask.ravel().tolist()},
    ]}).encode()


def _binary_request(ids: np.ndarray, mask: np.ndarray,
                    parameters: dict | None = None) -> tuple[bytes, dict]:
    head = json.dumps({
        "inputs": [
            {"name": "input_ids", "datatype": "INT32",
             "shape": list(ids.shape),
             "parameters": {"binary_data_size": ids.nbytes}},
            {"name": "attention_mask", "datatype": "INT32",
             "shape": list(mask.shape),
             "parameters": {"binary_data_size": mask.nbytes}},
        ],
        "parameters": {"binary_data_output": True, **(parameters or {})},
    }).encode()
    return (head + ids.tobytes() + mask.tobytes(),
            {"Inference-Header-Content-Length": str(len(head))})


def _parse_response(headers: dict, data: bytes) -> dict[str, np.ndarray]:
    jlen = headers.get("Inference-Header-Content-Length")
    head = json.loads(data[:int(jlen)] if jlen else data)
    tail = data[int(jlen):] if jlen else b""
    out, offset = {}, 0
    for o in head["outputs"]:
        _check(o["datatype"] == "FP32", f"{o['name']} is {o['datatype']}")
        size = (o.get("parameters") or {}).get("binary_data_size")
        if size is not None:
            arr = np.frombuffer(tail[offset:offset + size], np.float32)
            offset += size
        else:
            arr = np.array(o["data"], np.float32)
        out[o["name"]] = arr.reshape(o["shape"])
    return out


def serve_phase(torch) -> dict:
    from client_tpu_torch.engine import TorchEngine
    from client_tpu_torch.models import build_repository
    from client_tpu_torch.ops import flash_attention as fa
    from client_tpu_torch.server import (
        GrpcInferenceServer,
        HttpInferenceServer,
    )

    t0 = time.monotonic()
    engine = TorchEngine(build_repository(["bert_base", "bert_long"]))
    server = HttpInferenceServer(engine, port=0).start()
    grpc_server = GrpcInferenceServer(engine, port=0).start()
    print(f"serve: engine and server up in {time.monotonic() - t0:.1f} s "
          f"on {engine.device}", flush=True)
    rng = np.random.default_rng(0)
    try:
        requests = []  # (model, ids, mask, binary)
        for model, seq, count in (("bert_base", 128, 16),
                                  ("bert_long", 2048, 8)):
            for i in range(count):
                rows = 2 if i == 0 else 1
                ids = rng.integers(0, 30522, (rows, seq)).astype(np.int32)
                mask = np.ones((rows, seq), np.int32)
                for r in range(rows):
                    mask[r, rng.integers(seq // 4, seq + 1):] = 0
                requests.append((model, ids, mask, i == 0))

        def send(item):
            model, ids, mask, binary = item
            if binary:
                body, headers = _binary_request(ids, mask)
            else:
                body, headers = _json_request(ids, mask), {}
            t = time.monotonic()
            status, rheaders, data = _post(
                server.port, f"/v2/models/{model}/infer", body, headers)
            _check(status == 200, f"{model}: HTTP {status}: {data[:300]!r}")
            return _parse_response(rheaders, data), time.monotonic() - t

        fa.launches = 0  # count only the main path's launches
        t0 = time.monotonic()
        with concurrent.futures.ThreadPoolExecutor(len(requests)) as pool:
            results = list(pool.map(send, requests))
        wall = time.monotonic() - t0
        launches = fa.launches
        stats = {s["name"]: s for s in engine.model_statistics()["model_stats"]}
        for model in ("bert_base", "bert_long"):
            n_req = sum(1 for r in requests if r[0] == model)
            print(f"serve: {model}: {n_req} requests in "
                  f"{stats[model]['execution_count']} executions, batch "
                  f"sizes {[b['batch_size'] for b in stats[model]['batch_stats']]}",
                  flush=True)
        print(f"serve: {len(requests)} concurrent requests in {wall:.3f} s; "
              f"latency max {max(t for _, t in results):.3f} s", flush=True)
        long_batches = stats["bert_long"]["execution_count"]
        n_layers = len(engine.repository.get("bert_long").backend.layers)
        _check(launches == n_layers * long_batches,
               f"flash launches {launches} != {n_layers} x {long_batches} "
               "bert_long batches")
        _check(any(stats[m]["execution_count"]
                   < sum(1 for r in requests if r[0] == m)
                   for m in stats), "dynamic batching formed no batch > 1")

        # The same engine over gRPC ModelInfer: every other request again,
        # concurrently, half as raw contents and half as typed int_contents.
        grpc_requests = requests[::2]
        channel, stub = _grpc_channel(grpc_server.url)

        def send_grpc(item):
            i, (model, ids, mask, _) = item
            resp = stub.ModelInfer(_grpc_request(
                model, {"input_ids": ids, "attention_mask": mask},
                typed=i % 2 == 1), timeout=GRPC_TIMEOUT_S)
            return _grpc_outputs(resp)

        try:
            with concurrent.futures.ThreadPoolExecutor(
                    len(grpc_requests)) as pool:
                grpc_results = list(pool.map(send_grpc,
                                             enumerate(grpc_requests)))
        finally:
            channel.close()
        total = fa.launches
        grpc_batches = engine.model_statistics("bert_long")["model_stats"][
            0]["execution_count"] - long_batches
        print(f"serve: gRPC ModelInfer: {len(grpc_requests)} concurrent "
              f"requests ({sum(1 for r in grpc_requests if r[0] == 'bert_long')}"
              f" bert_long in {grpc_batches} batches), raw and typed "
              f"contents; flash launches {launches} over HTTP, {total} "
              "with gRPC", flush=True)
        _check(grpc_batches >= 1 and total - launches == n_layers
               * grpc_batches, f"flash launches {total - launches} over "
               f"gRPC != {n_layers} x {grpc_batches} bert_long batches")

        # Served outputs against the same module run directly on the card,
        # its attention swapped for the plain version (bert_long) or as is.
        errs = {"bert_base": 0.0, "bert_long": 0.0}
        served = [(r, out) for r, (out, _) in zip(requests, results)]
        served += list(zip(grpc_requests, grpc_results))
        with torch.inference_mode():
            for (model, ids, mask, _), out in served:
                backend = engine.repository.get(model).backend
                inputs = {"input_ids": torch.from_numpy(ids).cuda(),
                          "attention_mask": torch.from_numpy(mask).cuda()}
                attend = (fa.flash_attention_plain if model == "bert_long"
                          else backend.attend)
                ref = backend.encode(inputs, attend)
                for tc in backend.config.output:
                    name, got = tc.name, out[tc.name]
                    _check(got.shape == (ids.shape[0], *tc.dims),
                           f"{model} {name} shape {got.shape}")
                    _check(bool(np.isfinite(got).all()),
                           f"{model} {name} not finite")
                    err = float(np.abs(got - ref[name].cpu().numpy()).max())
                    errs[model] = max(errs[model], err)
        print(f"serve: max |served - direct| over HTTP and gRPC {errs} "
              f"(tolerance {SERVED_ATOL})", flush=True)
        _check(max(errs.values()) <= SERVED_ATOL, f"served outputs off: {errs}")
        _check(total == fa.launches, "the reference run launched the kernel")

        ids = np.zeros((1, 128), np.int32)
        mask = np.ones((1, 128), np.int32)
        status, _, _ = _post(server.port, "/v2/models/no_such_model/infer",
                             _json_request(ids, mask))
        _check(status == 404, f"unknown model answered {status}")
        status, _, _ = _post(server.port, "/v2/models/bert_base/infer",
                             b'{"inputs": [')
        _check(status == 400, f"malformed body answered {status}")
        status, _, _ = _post(server.port, "/v2/models/bert_base/infer",
                             _json_request(ids[:, :100], mask[:, :100]))
        _check(status == 400, f"wrong input shape answered {status}")
        import grpc

        channel, stub = _grpc_channel(grpc_server.url)
        try:
            for model, inputs, want in (
                    ("no_such_model", {"input_ids": ids},
                     grpc.StatusCode.NOT_FOUND),
                    ("bert_base", {"input_ids": ids[:, :100],
                                   "attention_mask": mask[:, :100]},
                     grpc.StatusCode.INVALID_ARGUMENT)):
                try:
                    stub.ModelInfer(_grpc_request(model, inputs),
                                    timeout=GRPC_TIMEOUT_S)
                    code = None
                except grpc.RpcError as exc:
                    code = exc.code()
                _check(code == want, f"gRPC {model}: {code}, not {want}")
        finally:
            channel.close()
        print("serve: 404 for an unknown model, 400 for a malformed body "
              "and a wrong shape; over gRPC NOT_FOUND and INVALID_ARGUMENT",
              flush=True)
        return {"launches": total, "http_launches": launches, "errs": errs}
    finally:
        grpc_server.stop()
        server.stop()
        engine.shutdown()


# -- generate phase ---------------------------------------------------------

def _stream(port: int, model: str, body: dict
            ) -> tuple[list[int], list[float], int]:
    """One /generate_stream request: its tokens, the arrival time of each
    (monotonic seconds; the tokens of one coalesced event share it) and
    its count of events, read event by event as they come."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("POST", f"/v2/models/{model}/generate_stream",
                     json.dumps(body).encode())
        resp = conn.getresponse()
        _check(resp.status == 200, f"{model}: generate_stream HTTP "
               f"{resp.status}")
        _check(resp.getheader("Content-Type") == "text/event-stream",
               f"{model}: not an event stream")
        tokens, times, events, buf = [], [], 0, b""
        while True:
            data = resp.read1(65536)
            if not data:
                break
            buf += data
            while b"\n\n" in buf:
                event, buf = buf.split(b"\n\n", 1)
                _check(event.startswith(b"data: "), f"bad event {event!r}")
                head = json.loads(event[len(b"data: "):])
                _check("error" not in head, f"{model}: {head}")
                outs = {o["name"]: o["data"] for o in head["outputs"]}
                k = len(outs["TOKEN"])
                _check(outs["INDEX"] == list(range(len(tokens),
                                                   len(tokens) + k)),
                       f"{model}: INDEX {outs['INDEX']} after {len(tokens)} "
                       "tokens")
                tokens += outs["TOKEN"]
                times += [time.monotonic()] * k
                events += 1
        _check(not buf, f"{model}: trailing bytes {buf[:80]!r}")
        return tokens, times, events
    finally:
        conn.close()


def _direct_stream(torch, backend, arena, prompt, n, params,
                   device: str = "cuda") -> list[int]:
    """The same model run directly, one stream alone in arena row 0."""
    lanes = backend.lane_params([params.get("seed", 0)],
                                [params.get("temperature", 0.0)],
                                [params.get("top_k", 0)],
                                [params.get("top_p", 1.0)])
    sample = params.get("temperature", 0.0) > 0
    ids = torch.tensor([prompt], dtype=torch.int32, device=device)
    tokens = [int(backend.prefill(
        arena, backend.wave_index(arena, [0], [len(prompt)]), ids, lanes,
        sample)[0])]
    for i in range(n - 1):
        index = backend.wave_index(arena, [0], [len(prompt) + i])
        tokens.append(int(backend.decode(arena, index, lanes, sample)[0]))
    return tokens


def _wave_split(torch, backend, smi: str) -> None:
    """Where one decode wave's time goes: the host's dispatch (Python and
    kernel launches, no sync) against the device's time for the same wave,
    at 12 live lanes in a 16-lane bucket, greedy and with a sampled lane.
    The device time is taken with the wave queued behind a sleeping
    kernel, so the device runs it with no wait on the host (one wave at a
    time: a sampled wave's ~500 launches fill most of the launch queue)."""
    arena = backend.init_arena(backend.max_streams)
    rng = np.random.default_rng(4)
    free, dummy = backend.arena_rows()
    rows = free[:12] + [dummy] * 4
    lens = rng.integers(100, 1600, 12).tolist() + [0] * 4
    index = backend.wave_index(arena, rows, lens)
    for label, temps in (("greedy", [0.0] * 16),
                         ("sampled", [0.8] + [0.0] * 15)):
        lanes = backend.lane_params(list(range(16)), temps, [24] * 16,
                                    [0.9] * 16)
        sample = label == "sampled"
        for _ in range(3):
            backend.decode(arena, index, lanes, sample)
        torch.cuda.synchronize()
        host = []
        for _ in range(N_TIMED):
            t = time.perf_counter()
            backend.decode(arena, index, lanes, sample)
            host.append(time.perf_counter() - t)
        torch.cuda.synchronize()
        device = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(100_000_000)  # ~50 ms at the H100's clocks
            start.record()
            backend.decode(arena, index, lanes, sample)
            end.record()
            end.synchronize()
            device.append(start.elapsed_time(end))
        print(f"generate: {backend.config.name} wave, 12 lanes in a 16 "
              f"bucket, {label}: host dispatch {1e3 * float(np.median(host)):.3f} "
              f"ms (median of {N_TIMED}), device "
              f"{float(np.median(device)):.3f} ms (median of 5); {smi}",
              flush=True)


def _frontend_observation(port: int, grpc_url: str, streams: list,
                          max_tokens: int, smi: str) -> None:
    """The same greedy streams (``(model, prompt)``, all at once, one
    connection or RPC each) over SSE and over gRPC on one engine, with and
    without ``response_coalesce``: the median inter-token gap (tokens of
    one coalesced message arrive together), the messages sent and the
    tokens/s. Printed as an observation, not a cell; every run must carry
    the same tokens."""
    parts, first = [], None
    for frontend in ("sse", "grpc"):
        for coalesce in (False, True):
            params = {"max_tokens": max_tokens,
                      **({"response_coalesce": True} if coalesce else {})}
            t0 = time.monotonic()
            if frontend == "sse":
                with concurrent.futures.ThreadPoolExecutor(
                        len(streams)) as pool:
                    res = list(pool.map(lambda r: _stream(port, r[0], {
                        "inputs": [{"name": "INPUT_IDS", "datatype": "INT32",
                                    "shape": [len(r[1])], "data": r[1]}],
                        "parameters": params}), streams))
            else:
                got = _grpc_stream_rpcs(grpc_url, [
                    [(f"o{i}", model, prompt, params)]
                    for i, (model, prompt) in enumerate(streams)])
                res = [got[f"o{i}"] for i in range(len(streams))]
            wall = time.monotonic() - t0
            tokens = [r[0] for r in res]
            first = tokens if first is None else first
            _check(tokens == first, f"{frontend} coalesce={coalesce}: other "
                   "tokens than the first run")
            gaps = [b - a for _, times, _ in res
                    for a, b in zip(times, times[1:])]
            n_tok = sum(len(t) for t in tokens)
            parts.append(
                f"{frontend}{' coalesced' if coalesce else ''}: median "
                f"inter-token gap {1e3 * float(np.median(gaps)):.3f} ms, "
                f"{sum(r[2] for r in res)} messages for {n_tok} tokens, "
                f"{n_tok / wall:.1f} tokens/s")
    print(f"frontends: {len(streams)} greedy tiny_gpt_long streams of "
          f"{max_tokens} tokens, one engine (observation, not a cell): "
          + "; ".join(parts) + f"; {smi}", flush=True)


def generate_phase(torch, smi: str) -> dict:
    from client_tpu_torch.engine import TorchEngine
    from client_tpu_torch.models import build_repository
    from client_tpu_torch.models.generate import TinyGptBackend
    from client_tpu_torch.ops import decode_attention as da
    from client_tpu_torch.ops import flash_attention as fa
    from client_tpu_torch.server import (
        GrpcInferenceServer,
        HttpInferenceServer,
    )

    _check(not torch.backends.cuda.matmul.allow_tf32,
           "TF32 matmuls are on: fp32 parity needs them off")
    t0 = time.monotonic()
    engine = TorchEngine(build_repository(["tiny_gpt", "tiny_gpt_long"]))
    server = HttpInferenceServer(engine, port=0).start()
    grpc_server = GrpcInferenceServer(engine, port=0).start()
    print(f"generate: engine and both servers up in "
          f"{time.monotonic() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(3)
    sampled = {"temperature": 0.8, "top_k": 24, "top_p": 0.9}
    requests = []  # (model, prompt, params)
    for i, n in enumerate((3, 17, 60, 130, 200, 300, 450, 700, 900, 1100,
                           1300, 1500)):
        params = {**sampled, "seed": 100 + i} if i in (4, 9) else {}
        requests.append(("tiny_gpt_long",
                         rng.integers(0, 512, n).tolist(), params))
    for i, n in enumerate((1, 5, 9, 20, 33, 50, 70, 96)):
        params = {**sampled, "seed": 200 + i} if i == 3 else {}
        requests.append(("tiny_gpt", rng.integers(0, 512, n).tolist(),
                         params))
    max_tokens = 32

    def send_all(n_tokens):
        with concurrent.futures.ThreadPoolExecutor(len(requests)) as pool:
            return list(pool.map(lambda r: _stream(
                server.port, r[0], {
                    "inputs": [{"name": "INPUT_IDS", "datatype": "INT32",
                                "shape": [len(r[1])], "data": r[1]}],
                    "parameters": {"max_tokens": n_tokens, **r[2]}}),
                requests))

    try:
        # One short round first, so the timed round does not carry the
        # first use of each shape, stream and library handle.
        t0 = time.monotonic()
        send_all(4)
        print(f"generate: warm-up round (4 tokens a stream) in "
              f"{time.monotonic() - t0:.3f} s", flush=True)
        fa.launches_fp32 = 0  # count only the main path's launches
        da.launches = 0
        t0 = time.monotonic()
        results = send_all(max_tokens)
        wall = time.monotonic() - t0
        k1, k2 = fa.launches_fp32, da.launches
        n_tokens = sum(len(toks) for toks, _, _ in results)
        gaps = [b - a for _, times, _ in results
                for a, b in zip(times, times[1:])]
        stats = {s["name"]: s for s in engine.model_statistics()["model_stats"]}
        print(f"generate: {len(requests)} concurrent streams, {n_tokens} "
              f"tokens in {wall:.3f} s ({n_tokens / wall:.1f} tokens/s), "
              f"median inter-token gap {1e3 * float(np.median(gaps)):.2f} ms, "
              f"p90 {1e3 * float(np.percentile(gaps, 90)):.2f} ms; "
              f"executions {[(m, s['execution_count']) for m, s in sorted(stats.items())]}; "
              f"{smi} (printed, not claimed)", flush=True)
        _check(all(len(toks) == max_tokens for toks, _, _ in results),
               f"stream lengths {[len(t) for t, _, _ in results]}")
        n_layers = 4
        _check(k2 % n_layers == 0 and k2 >= n_layers * (max_tokens - 1),
               f"decode kernel launches {k2}: not a multiple of {n_layers} "
               f"or fewer than {n_layers * (max_tokens - 1)}")
        _check(k1 % n_layers == 0 and k1 >= n_layers,
               f"fp32 flash launches {k1}: not a multiple of {n_layers}")
        print(f"generate: decode kernel launched {k2} times, fp32 flash "
              f"{k1} times ({k1 // n_layers} tiny_gpt_long prefill chunks) "
              "over HTTP", flush=True)

        # The same streams over gRPC ModelStreamInfer on the same engine:
        # 5 RPCs side by side, 4 requests multiplexed on each, every third
        # with response_coalesce.
        streams = [(f"s{i}", model, prompt, {
            "max_tokens": max_tokens, **params,
            **({"response_coalesce": True} if i % 3 == 0 else {})})
            for i, (model, prompt, params) in enumerate(requests)]
        t0 = time.monotonic()
        by_id = _grpc_stream_rpcs(grpc_server.url,
                                  [streams[i::5] for i in range(5)])
        grpc_wall = time.monotonic() - t0
        grpc_results = [by_id[rid] for rid, *_ in streams]
        k1_all, k2_all = fa.launches_fp32, da.launches
        _check(all(len(toks) == max_tokens for toks, _, _ in grpc_results),
               f"gRPC stream lengths {[len(t) for t, _, _ in grpc_results]}")
        _check(k2_all - k2 >= n_layers * (max_tokens - 1)
               and (k2_all - k2) % n_layers == 0,
               f"decode kernel launches over gRPC {k2_all - k2}")
        _check(k1_all - k1 >= n_layers and (k1_all - k1) % n_layers == 0,
               f"fp32 flash launches over gRPC {k1_all - k1}")
        print(f"generate: gRPC: {len(streams)} streams on 5 RPCs in "
              f"{grpc_wall:.3f} s, {sum(r[2] for r in grpc_results)} "
              f"messages for {sum(len(r[0]) for r in grpc_results)} tokens; "
              f"decode kernel launched {k2_all} times ({k2} over HTTP), fp32 "
              f"flash {k1_all} ({k1} over HTTP)", flush=True)

        # Oracle: the same weights on the plain path, one stream at a time.
        oracles = {}
        for model in ("tiny_gpt", "tiny_gpt_long"):
            served = engine.repository.get(model).backend
            oracle = TinyGptBackend(
                name=model, max_seq_len=served.max_seq_len,
                max_streams=served.max_streams, attention_impl="einsum",
                attn_impl="reference", device="cuda")
            oracles[model] = (oracle, oracle.init_arena(1))
        t0 = time.monotonic()
        for (model, prompt, params), (toks, _, _), (grpc_toks, _, _) in zip(
                requests, results, grpc_results):
            oracle, arena = oracles[model]
            want = _direct_stream(torch, oracle, arena, prompt, max_tokens,
                                  params)
            _check(toks == want, f"{model} prompt of {len(prompt)} "
                   f"{params or 'greedy'}: served {toks} != direct {want}")
            _check(grpc_toks == want, f"{model} prompt of {len(prompt)} "
                   f"{params or 'greedy'} over gRPC: {grpc_toks} != direct "
                   f"{want}")
        _check((fa.launches_fp32, da.launches) == (k1_all, k2_all),
               "the plain-path oracle launched a kernel")
        print(f"generate: all {len(requests)} streams over HTTP and all "
              f"{len(streams)} over gRPC equal the plain path run directly, "
              f"token for token ({time.monotonic() - t0:.1f} s)", flush=True)

        # /generate collects what the stream sent.
        model, prompt, _ = requests[5]
        body = {"inputs": [{"name": "INPUT_IDS", "datatype": "INT32",
                            "shape": [len(prompt)], "data": prompt}],
                "parameters": {"max_tokens": max_tokens}}
        status, _, data = _post(server.port, f"/v2/models/{model}/generate",
                                json.dumps(body).encode())
        _check(status == 200, f"/generate HTTP {status}: {data[:200]!r}")
        collected = [{o["name"]: o["data"] for o in r["outputs"]}["TOKEN"][0]
                     for r in json.loads(data)["responses"]]
        _check(collected == results[5][0], "/generate differs from the stream")
        # A stop token ends the stream without being emitted.
        full = results[5][0]
        stop = full[4]
        stopped, _, _ = _stream(server.port, model, {
            **body, "parameters": {"max_tokens": max_tokens,
                                   "stop_token_ids": stop}})
        _check(stopped == full[:full.index(stop)],
               f"stop token {stop}: got {stopped}")
        # The 400s: prompt + max_tokens over max_seq; sync infer.
        long_body = {**body, "parameters": {"max_tokens": 200}}
        long_body["inputs"] = [{**body["inputs"][0], "shape": [2000],
                                "data": [1] * 2000}]
        status, _, _ = _post(server.port, "/v2/models/tiny_gpt_long/generate",
                             json.dumps(long_body).encode())
        _check(status == 400, f"prompt + max_tokens > max_seq: HTTP {status}")
        status, _, _ = _post(server.port, "/v2/models/tiny_gpt/infer",
                             json.dumps(body).encode())
        _check(status == 400, f"sync infer on tiny_gpt: HTTP {status}")
        print("generate: /generate equals the stream; a stop token ends it "
              "unemitted; 400 for prompt + max_tokens > max_seq and for a "
              "sync infer", flush=True)
        _frontend_observation(
            server.port, grpc_server.url,
            [(m, p) for m, p, params in requests
             if m == "tiny_gpt_long" and not params][:8], max_tokens, smi)
        _wave_split(torch, engine.repository.get("tiny_gpt_long").backend,
                    smi)
        return {"flash_attention_fp32": k1_all, "decode_wave_attention": k2_all,
                "http_launches": {"flash_attention_fp32": k1,
                                  "decode_wave_attention": k2},
                "wall_s": wall, "tokens": n_tokens,
                "median_gap_ms": 1e3 * float(np.median(gaps))}
    finally:
        grpc_server.stop()
        server.stop()
        engine.shutdown()


def sharded_phase(torch, smi: str) -> dict:
    """tiny_gpt_long with its arena split over 2 shards on the one card,
    served over HTTP, every stream checked against the plain unsharded
    path run directly."""
    from client_tpu_torch.engine import TorchEngine
    from client_tpu_torch.engine.repository import ModelRepository
    from client_tpu_torch.models.generate import TinyGptBackend
    from client_tpu_torch.ops import decode_attention as da
    from client_tpu_torch.ops import flash_attention as fa
    from client_tpu_torch.parallel import kv_shard as ks
    from client_tpu_torch.server import (
        GrpcInferenceServer,
        HttpInferenceServer,
    )

    name, shards, n_layers, max_tokens = "tiny_gpt_long_kv2", 2, 4, 32

    def build(device):
        # tiny_gpt_long's registered size; every shard on this card.
        backend = TinyGptBackend(name=name, max_seq_len=2048, max_streams=16,
                                 attention_impl="flash", attn_impl="fused",
                                 kv_shards=shards, device=device)
        backend._kv_mesh = ks.kv_mesh(shards, [device] * shards)
        return backend

    repo = ModelRepository()
    repo.register(name, build)
    t0 = time.monotonic()
    engine = TorchEngine(repo)
    server = HttpInferenceServer(engine, port=0).start()
    grpc_server = GrpcInferenceServer(engine, port=0).start()
    sched = engine._schedulers[name]
    backend = engine.repository.get(name).backend
    _check(sched.arena_shards() == shards and sched._chunk == 1,
           f"scheduler: {sched.arena_shards()} shards, chunk {sched._chunk}")
    arena_mb = sum(t.numel() * 4 for t in sched._arena.k + sched._arena.v) / 1e6
    print(f"sharded: engine and server up in {time.monotonic() - t0:.1f} s; "
          f"arena {arena_mb:.1f} MB in {shards} shards of "
          f"{list(sched._arena.k[0].shape)} on "
          f"{[str(d) for d in backend._mesh().devices]}", flush=True)
    rng = np.random.default_rng(6)
    sampled = {"temperature": 0.8, "top_k": 24, "top_p": 0.9}
    requests = []  # (prompt, params)
    for i, n in enumerate((3, 40, 150, 400, 700, 1000, 1300, 1500)):
        params = {**sampled, "seed": 300 + i} if i in (2, 5) else {}
        requests.append((rng.integers(0, 512, n).tolist(), params))
    try:
        fa.launches_fp32 = da.launches = ks.launches = 0
        t0 = time.monotonic()
        with concurrent.futures.ThreadPoolExecutor(len(requests)) as pool:
            results = list(pool.map(lambda r: _stream(server.port, name, {
                "inputs": [{"name": "INPUT_IDS", "datatype": "INT32",
                            "shape": [len(r[0])], "data": r[0]}],
                "parameters": {"max_tokens": max_tokens, **r[1]}}),
                requests))
        wall = time.monotonic() - t0
        k1, k2, k3 = fa.launches_fp32, da.launches, ks.launches
        executions = engine.model_statistics(name)["model_stats"][0][
            "execution_count"]
        prefills = k1 // n_layers
        steps = executions - prefills  # wave dispatches of one step each
        n_tokens = sum(len(toks) for toks, _, _ in results)
        gaps = [b - a for _, times, _ in results
                for a, b in zip(times, times[1:])]
        print(f"sharded: {len(requests)} concurrent streams, {n_tokens} "
              f"tokens in {wall:.3f} s ({n_tokens / wall:.1f} tokens/s), "
              f"median inter-token gap {1e3 * float(np.median(gaps)):.2f} ms; "
              f"{executions} executions: {prefills} prefill chunks, {steps} "
              f"decode steps; {smi} (printed, not claimed)", flush=True)
        _check(all(len(toks) == max_tokens for toks, _, _ in results),
               f"stream lengths {[len(t) for t, _, _ in results]}")
        _check(k1 == n_layers * prefills and prefills >= 1,
               f"fp32 flash launches {k1}: not {n_layers} per prefill chunk")
        _check(steps >= max_tokens - 1, f"{steps} decode steps")
        _check(k3 == n_layers * steps,
               f"ring launches {k3} != {n_layers} x {steps} decode steps")
        _check(k2 == shards * n_layers * steps,
               f"decode launches {k2} != {shards} x {n_layers} x {steps}")
        print(f"sharded: ring all-reduce launched {k3} = {n_layers} x {steps} "
              f"times, decode kernel {k2} = {shards} x {n_layers} x {steps}, "
              f"fp32 flash {k1} = {n_layers} x {prefills} over HTTP",
              flush=True)

        # Four of the streams again over gRPC: 2 RPCs, 2 requests each.
        streams = [(f"k{i}", name, prompt, {"max_tokens": max_tokens,
                                            **params})
                   for i, (prompt, params) in enumerate(requests[2:6])]
        by_id = _grpc_stream_rpcs(grpc_server.url, [streams[0::2],
                                                    streams[1::2]])
        grpc_results = [by_id[rid] for rid, *_ in streams]
        g1, g2, g3 = (fa.launches_fp32 - k1, da.launches - k2,
                      ks.launches - k3)
        g_prefills = g1 // n_layers
        g_steps = (engine.model_statistics(name)["model_stats"][0][
            "execution_count"] - executions - g_prefills)
        _check(g1 == n_layers * g_prefills and g_prefills >= 1,
               f"fp32 flash launches over gRPC {g1}")
        _check(g_steps >= max_tokens - 1 and g3 == n_layers * g_steps
               and g2 == shards * n_layers * g_steps,
               f"over gRPC: ring {g3}, decode {g2}, {g_steps} decode steps")
        print(f"sharded: gRPC: {len(streams)} streams on 2 RPCs; ring "
              f"all-reduce launched {k3 + g3} times ({k3} over HTTP), decode "
              f"kernel {k2 + g2} ({k2} over HTTP)", flush=True)

        oracle = TinyGptBackend(name=name, max_seq_len=2048, max_streams=16,
                                attention_impl="einsum",
                                attn_impl="reference", device="cuda")
        arena = oracle.init_arena(1)
        t0 = time.monotonic()
        served = list(zip(requests, results))
        served += list(zip(requests[2:6], grpc_results))
        for (prompt, params), (toks, _, _) in served:
            want = _direct_stream(torch, oracle, arena, prompt, max_tokens,
                                  params)
            _check(toks == want, f"{name} prompt of {len(prompt)} "
                   f"{params or 'greedy'}: served {toks} != direct {want}")
        _check((fa.launches_fp32, da.launches, ks.launches)
               == (k1 + g1, k2 + g2, k3 + g3),
               "the plain-path oracle launched a kernel")
        print(f"sharded: all {len(requests)} streams over HTTP and "
              f"{len(streams)} over gRPC equal the plain unsharded path run "
              f"directly, token for token ({time.monotonic() - t0:.1f} s)",
              flush=True)
        _wave_split(torch, backend, smi)
        return {"ring_all_reduce": k3 + g3, "http_launches": k3,
                "wall_s": wall, "tokens": n_tokens}
    finally:
        grpc_server.stop()
        server.stop()
        engine.shutdown()


# -- vision phase -------------------------------------------------------------

SIMPLE_MODELS = ("simple", "simple_int8", "simple_string", "simple_identity")
VISION_MODELS = ("resnet50", "densenet_onnx", "ssd_mobilenet_v2_coco_quantized",
                 "ssd_mobilenet_v2_tpu", "image_preprocess", "ensemble_image",
                 "bert_preprocess", "bert_base", "bert_postprocess",
                 "ensemble_bert") + SIMPLE_MODELS
SSD_MODELS = ("ssd_mobilenet_v2_coco_quantized", "ssd_mobilenet_v2_tpu")
# Served classifier logits vs the same module run directly on the request's
# rows padded to a ladder bucket, relative to the request's max |logit|:
# the served rows sat elsewhere in their batch, which cuDNN need not sum
# alike in bf16 (a few bf16 ulps). Whether they were exact is printed; on
# the H100 every request was (PERF.md).
CLASSIFIER_RTOL = 2e-2


# The vision phase's own v2 wire client: built from the protocol's text
# (little-endian tensors; a BYTES element is a 4-byte little-endian length,
# then its bytes), never from the server's codec, so that a fault shared by
# the server's encoder and decoder cannot pass unseen. Its dtypes are
# ``_WIRE_DTYPES``, the gRPC client's.
def _wire_bytes(arr: np.ndarray) -> bytes:
    if arr.dtype == np.object_:
        return b"".join(len(x).to_bytes(4, "little") + x for x in arr.ravel())
    return arr.astype(arr.dtype.newbyteorder("<")).tobytes()


def _infer_body(inputs: dict[str, np.ndarray], outputs: list | None,
                binary: bool) -> tuple[bytes, dict]:
    """A v2 infer body with every input as JSON data or as binary."""
    names = {np.dtype(v): k for k, v in _WIRE_DTYPES.items()}
    entries, tails = [], []
    for name, arr in inputs.items():
        entry = {"name": name, "shape": list(arr.shape),
                 "datatype": ("BYTES" if arr.dtype == np.object_
                              else names[arr.dtype])}
        if binary:
            raw = _wire_bytes(arr)
            entry["parameters"] = {"binary_data_size": len(raw)}
            tails.append(raw)
        elif arr.dtype == np.object_:
            entry["data"] = [x.decode() for x in arr.ravel()]
        else:
            entry["data"] = arr.ravel().tolist()
        entries.append(entry)
    head = {"inputs": entries}
    if outputs is not None:
        head["outputs"] = outputs
    if binary:
        head["parameters"] = {"binary_data_output": True}
    data = json.dumps(head).encode()
    if not binary:
        return data, {}
    return data + b"".join(tails), {
        "Inference-Header-Content-Length": str(len(data))}


def _bytes_elements(raw: bytes) -> np.ndarray:
    """The elements of a BYTES tensor's raw bytes, as a 1-D object array."""
    items, i = [], 0
    while i < len(raw):
        n = int.from_bytes(raw[i:i + 4], "little")
        _check(i + 4 + n <= len(raw), "BYTES element overruns its tensor")
        items.append(raw[i + 4:i + 4 + n])
        i += 4 + n
    arr = np.empty(len(items), np.object_)
    arr[:] = items
    return arr


def _any_outputs(headers: dict, data: bytes) -> dict[str, np.ndarray]:
    """Every output of a v2 infer response, FP32, INT32, UINT8 or BYTES,
    from JSON data or from the binary tail."""
    jlen = headers.get("Inference-Header-Content-Length")
    head = json.loads(data[:int(jlen)] if jlen else data)
    tail = data[int(jlen):] if jlen else b""
    out, offset = {}, 0
    for o in head["outputs"]:
        size = (o.get("parameters") or {}).get("binary_data_size")
        raw = None
        if size is not None:
            raw = tail[offset:offset + size]
            offset += size
        if o["datatype"] == "BYTES":
            if raw is None:
                arr = np.empty(len(o["data"]), np.object_)
                arr[:] = [x.encode() for x in o["data"]]
            else:
                arr = _bytes_elements(raw)
        else:
            dtype = np.dtype(_WIRE_DTYPES[o["datatype"]])
            arr = (np.array(o["data"], dtype) if raw is None else
                   np.frombuffer(raw, dtype.newbyteorder("<")).astype(dtype))
        out[o["name"]] = arr.reshape(o["shape"])
    return out


def _vision_requests(rng) -> list[tuple[str, dict, list | None, bool]]:
    """(model, inputs, requested outputs, binary) for the vision phase."""
    reqs = []

    def images(n, size):
        return rng.standard_normal((n, size, size, 3)).astype(np.float32)

    def uint8(n, h, w):
        return rng.integers(0, 256, (n, h, w, 3)).astype(np.uint8)

    for i in range(40):
        rows = 1 if i % 4 == 0 else int(rng.integers(1, 5))
        reqs.append(("resnet50", {"INPUT": images(rows, 224)}, None,
                     i % 4 != 0))
    for i in range(16):
        rows = 1 + i % 2
        reqs.append(("densenet_onnx", {"INPUT": images(rows, 224)}, None,
                     i % 3 != 0))
    for i in range(8):
        reqs.append(("ssd_mobilenet_v2_coco_quantized",
                     {"normalized_input_image_tensor": uint8(1, 300, 300)},
                     None, i % 2 == 0))
    for i in range(24):
        reqs.append(("ssd_mobilenet_v2_tpu",
                     {"normalized_input_image_tensor": uint8(1 + i % 2, 300,
                                                             300)},
                     None, i % 3 != 0))
    for i, (h, w) in enumerate(((480, 640), (333, 500), (480, 640),
                                (333, 500))):
        reqs.append(("ensemble_image", {"RAW_IMAGE": uint8(1, h, w)}, None,
                     i % 2 == 0))
    texts = [b"a great movie", b"the plot falls apart in the last act",
             b"i would watch it again", b"not for me"]
    for i, text in enumerate(texts):
        reqs.append(("ensemble_bert",
                     {"TEXT": np.array([[text]] * (1 + i % 2),
                                       dtype=np.object_)}, None, i % 2 == 1))
    for i in range(2):
        reqs.append(("resnet50", {"INPUT": images(2, 224)},
                     [{"name": "OUTPUT", "parameters": {"classification": 3}}],
                     i == 0))
    return reqs


def _direct_buckets(torch, model, inputs: dict[str, np.ndarray]):
    """The module run directly on the card on the request's rows padded to
    each bucket of the model's ladder that holds them, smallest first."""
    rows = next(iter(inputs.values())).shape[0]
    with torch.inference_mode():
        for bucket in model.config.effective_buckets():
            if bucket < rows:
                continue
            staged = {k: torch.from_numpy(np.pad(
                v, [(0, bucket - rows)] + [(0, 0)] * (v.ndim - 1))).cuda()
                for k, v in inputs.items()}
            out = model.backend(staged)
            yield bucket, {k: v[:rows].cpu().numpy() for k, v in out.items()}


def _match_logits(torch, model, inputs, got: np.ndarray
                  ) -> tuple[float, int | None]:
    """(smallest max |served - direct| over the ladder, the first bucket
    where it is 0, else None)."""
    best = math.inf
    for bucket, out in _direct_buckets(torch, model, inputs):
        best = min(best, float(np.abs(got - next(iter(out.values()))).max()))
        if best == 0:
            return 0.0, bucket
    return best, None


def _forward_profile(torch, backend, inputs) -> dict:
    """One forward pass at a bucket: its wall ms (median of N_TIMED calls
    bracketed by CUDA events, after a warm-up, the card waiting on the
    host's launches), the host's ms to launch it (no sync; median of
    N_TIMED), its device ms (median of N_TIMED calls, each queued behind a
    sleeping kernel that outlasts twice the host's launch time, so the
    card never waits on the host), the card's busy ms (the sum of its
    kernels' device time in one ``torch.profiler`` pass), the three
    kernels that take longest, and the FLOPs ``torch.utils.flop_counter``
    counts."""
    from torch.profiler import ProfilerActivity, profile
    from torch.utils.flop_counter import FlopCounterMode

    def forward():
        return backend(inputs)

    with torch.inference_mode():
        wall = _time_ms(torch, forward)
        host = []
        for _ in range(N_TIMED):
            t = time.perf_counter()
            forward()
            host.append(time.perf_counter() - t)
            torch.cuda.synchronize()
        host_ms = 1e3 * float(np.median(host))
        # ~2e6 sleep cycles per ms at the H100's clocks.
        cycles = int(max(20e6, 4e6 * host_ms))
        device = []
        for _ in range(N_TIMED):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(cycles)
            start.record()
            forward()
            end.record()
            end.synchronize()
            device.append(start.elapsed_time(end))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            forward()
            torch.cuda.synchronize()
        counter = FlopCounterMode(display=False)
        with counter:
            forward()
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and e.self_device_time_total > 0),
                     key=lambda e: -e.self_device_time_total)
    return {"ms": float(np.median(device)), "wall_ms": wall, "host_ms": host_ms,
            "busy_ms": sum(e.self_device_time_total for e in kernels) / 1e3,
            "top": [(e.key[:60], e.self_device_time_total / 1e3, e.count)
                    for e in kernels[:3]],
            "launches": sum(e.count for e in kernels),
            "flops": float(counter.get_total_flops())}


def _nms_split(torch, smi: str) -> None:
    """The batched NMS alone at B=16: host time per call (enqueue, no
    sync), device time (CUDA events, the call queued behind a sleeping
    kernel), and the kernels it launches (one ``torch.profiler`` pass)."""
    from torch.profiler import ProfilerActivity, profile

    from client_tpu_torch.models import ssd

    gen = torch.Generator(device="cuda").manual_seed(5)
    enc = torch.randn(16, 1917, 4, device="cuda", generator=gen)
    scores = torch.rand(16, 1917, 91, device="cuda", generator=gen)
    anchors = torch.from_numpy(ssd.make_anchors()).cuda()

    def call():
        return ssd.decode_and_nms(enc, scores, anchors)

    with torch.inference_mode():
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        host = []
        for _ in range(N_TIMED):
            t = time.perf_counter()
            call()
            host.append(time.perf_counter() - t)
            torch.cuda.synchronize()
        device = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(20_000_000)
            start.record()
            call()
            end.record()
            end.synchronize()
            device.append(start.elapsed_time(end))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
    launches = sum(1 for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    print(f"vision: batched NMS at B=16 (1,917 anchors, 91 classes, 10 "
          f"steps): host {1e3 * float(np.median(host)):.3f} ms per call "
          f"(median of {N_TIMED}), device {float(np.median(device)):.3f} ms "
          f"(median of 5, queued), {launches} kernel launches; {smi}",
          flush=True)


def _simple_requests(rng) -> dict[str, dict[str, np.ndarray]]:
    """One request's inputs for each ``simple`` model: integers over their
    whole range (sums wrap), decimal strings, arbitrary bytes."""
    def ints(dtype, rows):
        info = np.iinfo(dtype)
        return rng.integers(info.min, info.max, (rows, 16),
                            dtype=np.int64).astype(dtype)

    def decimal():
        arr = np.empty((1, 16), np.object_)
        arr[0] = [str(v).encode() for v in rng.integers(-10**6, 10**6, 16)]
        return arr

    raw = np.empty((2, 3), np.object_)
    raw[:] = [[b"", b"\x00\xffz", b"abc"], ["\u00e9".encode(), b"1", b"22"]]
    return {"simple": {"INPUT0": ints(np.int32, 3),
                       "INPUT1": ints(np.int32, 3)},
            "simple_int8": {"INPUT0": ints(np.int8, 2),
                            "INPUT1": ints(np.int8, 2)},
            "simple_string": {"INPUT0": decimal(), "INPUT1": decimal()},
            "simple_identity": {"INPUT0": raw}}


def _simple_expected(name: str, inputs: dict) -> dict[str, np.ndarray]:
    """What each ``simple`` model must answer, in numpy."""
    if name == "simple_identity":
        return {"OUTPUT0": inputs["INPUT0"]}
    a, b = inputs["INPUT0"], inputs["INPUT1"]
    if name == "simple_string":
        a, b = (np.array([[int(x) for x in row] for row in t])
                for t in (a, b))
        out = {}
        for key, val in (("OUTPUT0", a + b), ("OUTPUT1", a - b)):
            arr = np.empty(val.shape, np.object_)
            arr[:] = [[str(int(v)).encode() for v in row] for row in val]
            out[key] = arr
        return out
    return {"OUTPUT0": a + b, "OUTPUT1": a - b}  # wrapping, as on the card


def _same_tensor(a: np.ndarray, b: np.ndarray) -> bool:
    """Byte-identical: dtype, shape and every element's bytes."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == np.object_:
        return a.tolist() == b.tolist()
    return a.tobytes() == b.tobytes()


def _grpc_vision_checks(http_port: int, grpc_url: str) -> None:
    """The vision phase's engine over gRPC, each answer held against the
    same request's HTTP answer: the four ``simple`` models byte for byte
    (raw and typed contents) and against numpy, ``resnet50``'s
    classification strings, both ensembles (a UINT8 and a BYTES input),
    and INVALID_ARGUMENT for an input that names a shared-memory
    region. Requests go one at a time, so each runs alone in its batch."""
    import grpc

    channel, stub = _grpc_channel(grpc_url)
    rng = np.random.default_rng(8)

    def both(model, inputs, outputs=None, typed=False):
        body, headers = _infer_body(inputs, outputs, binary=True)
        status, rh, data = _post(http_port, f"/v2/models/{model}/infer",
                                 body, headers)
        _check(status == 200, f"{model}: HTTP {status}: {data[:300]!r}")
        resp = stub.ModelInfer(_grpc_request(model, inputs, outputs, typed),
                               timeout=GRPC_TIMEOUT_S)
        return _any_outputs(rh, data), _grpc_outputs(resp)

    try:
        for name, inputs in _simple_requests(rng).items():
            want = _simple_expected(name, inputs)
            for typed in (False, True):
                http_out, grpc_out = both(name, inputs, typed=typed)
                for key, arr in want.items():
                    _check(_same_tensor(grpc_out[key], http_out[key]),
                           f"{name} {key}: gRPC {grpc_out[key]} != HTTP "
                           f"{http_out[key]}")
                    _check(_same_tensor(grpc_out[key], arr),
                           f"{name} {key}: {grpc_out[key]} != {arr}")
        images = rng.standard_normal((2, 224, 224, 3)).astype(np.float32)
        http_out, grpc_out = both(
            "resnet50", {"INPUT": images},
            [{"name": "OUTPUT", "parameters": {"classification": 3}}])
        _check(grpc_out["OUTPUT"].shape == (2, 3)
               and _same_tensor(grpc_out["OUTPUT"], http_out["OUTPUT"]),
               f"classification: gRPC {grpc_out['OUTPUT']} != HTTP "
               f"{http_out['OUTPUT']}")
        raw = rng.integers(0, 256, (1, 333, 500, 3)).astype(np.uint8)
        http_out, grpc_out = both("ensemble_image", {"RAW_IMAGE": raw})
        _check(_same_tensor(grpc_out["CLASS_LOGITS"],
                            http_out["CLASS_LOGITS"]),
               "ensemble_image: gRPC logits differ from HTTP's")
        text = np.empty((2, 1), np.object_)
        text[:, 0] = [b"a great movie", b"not for me"]
        for typed in (False, True):
            http_out, grpc_out = both("ensemble_bert", {"TEXT": text},
                                      typed=typed)
            _check(all(_same_tensor(grpc_out[k], http_out[k])
                       for k in ("LABEL", "SCORE")),
                   f"ensemble_bert: gRPC {grpc_out} != HTTP {http_out}")
        req = _grpc_request("resnet50", {"INPUT": images[:1]})
        _set_param(req.inputs[0].parameters, "shared_memory_region", "r0")
        _set_param(req.inputs[0].parameters, "shared_memory_byte_size",
                   images[:1].nbytes)
        try:
            stub.ModelInfer(req, timeout=GRPC_TIMEOUT_S)
            code, details = None, ""
        except grpc.RpcError as exc:
            code, details = exc.code(), exc.details()
        _check(code == grpc.StatusCode.INVALID_ARGUMENT
               and "not registered" in details,
               f"shared-memory input over gRPC answered {code} {details!r}")
    finally:
        channel.close()
    print(f"vision: gRPC answers equal HTTP's: {', '.join(SIMPLE_MODELS)} "
          "byte for byte over raw and typed contents (and equal to numpy), "
          "resnet50 classification strings, ensemble_image and "
          "ensemble_bert; a shared-memory input answered INVALID_ARGUMENT: "
          f"{details}", flush=True)


def vision_phase(torch, smi: str) -> None:
    """resnet50, densenet_onnx, both SSDs and both ensembles with their
    composing models, all ten at full size, and the four ``simple``
    models, served over HTTP and gRPC on the card; every output checked
    against the same modules run directly, and the gRPC answers against
    the HTTP ones."""
    from client_tpu_torch.engine import TorchEngine
    from client_tpu_torch.models import build_repository
    from client_tpu_torch.models.ensembles import (
        BertPostprocessBackend,
        BertPreprocessBackend,
        ImagePreprocessBackend,
    )
    from client_tpu_torch.server import (
        GrpcInferenceServer,
        HttpInferenceServer,
    )

    _check(not torch.backends.cudnn.benchmark,
           "cuDNN benchmark mode is on: served-vs-direct needs the same "
           "algorithm for a shape every time")
    print(f"vision: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}, "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          "(every convolution on this path is bf16)", flush=True)
    t0 = time.monotonic()
    engine = TorchEngine(build_repository(list(VISION_MODELS)))
    server = HttpInferenceServer(engine, port=0).start()
    grpc_server = GrpcInferenceServer(engine, port=0).start()
    served = engine.repository.names()
    print(f"vision: {len(served)} models up in "
          f"{time.monotonic() - t0:.1f} s: {served}", flush=True)
    _check(len(served) == 14, f"served {served}")
    try:
        requests = _vision_requests(np.random.default_rng(6))

        def send(item):
            model, inputs, outputs, binary = item
            body, headers = _infer_body(inputs, outputs, binary)
            t = time.monotonic()
            status, rheaders, data = _post(
                server.port, f"/v2/models/{model}/infer", body, headers)
            _check(status == 200, f"{model}: HTTP {status}: {data[:300]!r}")
            return _any_outputs(rheaders, data), time.monotonic() - t

        t0 = time.monotonic()
        with concurrent.futures.ThreadPoolExecutor(len(requests)) as pool:
            results = list(pool.map(send, requests))
        wall = time.monotonic() - t0
        n_images = sum(next(iter(r[1].values())).shape[0] for r in requests)
        print(f"vision: {len(requests)} concurrent requests ({n_images} "
              f"images or texts) in {wall:.3f} s; latency max "
              f"{max(t for _, t in results):.3f} s", flush=True)
        stats = {s["name"]: s for s in engine.model_statistics()["model_stats"]}
        for name in served:
            st = stats[name]
            print(f"vision: {name}: {st['inference_count']} requests in "
                  f"{st['execution_count']} executions, batch sizes "
                  f"{[(b['batch_size'], b['compute_infer']['count']) for b in st['batch_stats']]}",
                  flush=True)
        for name in ("resnet50", "ssd_mobilenet_v2_tpu"):
            _check(stats[name]["execution_count"]
                   < stats[name]["inference_count"],
                   f"{name}: dynamic batching formed no batch of more than "
                   "one request")

        # Every output: status, declared shape and dtype, then against the
        # same module run directly on the card.
        errs = {"resnet50": 0.0, "densenet_onnx": 0.0}
        exact = {"resnet50": [], "densenet_onnx": [], "ssd": [],
                 "ensemble_image": [], "ensemble_bert": []}
        image_pre = ImagePreprocessBackend()
        for (model, inputs, outputs, _), (out, _) in zip(requests, results):
            cfg = engine.repository.get(model).config
            rows = next(iter(inputs.values())).shape[0]
            for tc in cfg.output:
                got = out[tc.name]
                if outputs is not None:  # classification: [rows, 3] BYTES
                    _check(got.shape == (rows, 3) and got.dtype == np.object_,
                           f"{model} classification {got.shape} {got.dtype}")
                    continue
                want_dt = np.object_ if tc.data_type == "BYTES" else np.float32
                _check(got.shape == (rows, *tc.dims) and got.dtype == want_dt,
                       f"{model} {tc.name}: {got.shape} {got.dtype}")
                _check(want_dt == np.object_ or bool(np.isfinite(got).all()),
                       f"{model} {tc.name} not finite")
            if model in SSD_MODELS:
                m = engine.repository.get(model)
                hit = None
                for bucket, ref in _direct_buckets(torch, m, inputs):
                    if all(out[k].tobytes() == ref[k].tobytes() for k in ref):
                        hit = bucket
                        break
                _check(hit is not None, f"{model}: served outputs equal the "
                       "direct run at no bucket of the ladder")
                exact["ssd"].append(hit)
            elif model in ("resnet50", "densenet_onnx"):
                m = engine.repository.get(model)
                if outputs is None:
                    err, hit = _match_logits(torch, m, inputs, out["OUTPUT"])
                    scale = float(np.abs(out["OUTPUT"]).max())
                    errs[model] = max(errs[model], err / scale)
                    exact[model].append(hit)
                    continue
                # Classification: "score:idx" strings, the direct top 3.
                logits = next(_direct_buckets(torch, m, inputs))[1]["OUTPUT"]
                top3 = np.argsort(-logits, axis=1)[:, :3]
                for r in range(rows):
                    parts = [e.decode().split(":") for e in out["OUTPUT"][r]]
                    _check(all(len(p) == 2 for p in parts),
                           f"classification entries {out['OUTPUT'][r]}")
                    _check([int(p[1]) for p in parts] == top3[r].tolist(),
                           f"classification {parts} != top 3 {top3[r]}")
                    _check(all(abs(float(p[0]) - logits[r, int(p[1])])
                               <= CLASSIFIER_RTOL * np.abs(logits[r]).max()
                               for p in parts), f"classification {parts}")
            elif model == "ensemble_image":
                image = image_pre(inputs)["IMAGE"]
                err, hit = _match_logits(
                    torch, engine.repository.get("resnet50"),
                    {"INPUT": image}, out["CLASS_LOGITS"])
                _check(hit is not None,
                       f"ensemble_image off its steps by {err}")
                exact["ensemble_image"].append(hit)
            elif model == "ensemble_bert":
                pre = BertPreprocessBackend()(inputs)
                hit = None
                for bucket, logits in _direct_buckets(
                        torch, engine.repository.get("bert_base"), pre):
                    post = BertPostprocessBackend()(
                        {"logits": logits["logits"]})
                    if post["LABEL"].tolist() == out["LABEL"].tolist() \
                            and post["SCORE"].tobytes() == \
                            out["SCORE"].tobytes():
                        hit = bucket
                        break
                _check(hit is not None, "ensemble_bert equals its steps run "
                       "by hand at no bucket of bert_base's ladder")
                exact["ensemble_bert"].append(hit)
        print(f"vision: classifier logits, max |served - direct| / max|logit| "
              f"{errs} (tolerance {CLASSIFIER_RTOL}); exact at a ladder "
              f"bucket: resnet50 {sum(h is not None for h in exact['resnet50'])}"
              f"/{len(exact['resnet50'])}, densenet_onnx "
              f"{sum(h is not None for h in exact['densenet_onnx'])}/"
              f"{len(exact['densenet_onnx'])}", flush=True)
        _check(max(errs.values()) <= CLASSIFIER_RTOL,
               f"served logits off: {errs}")
        print(f"vision: SSD outputs bit for bit at buckets {exact['ssd']}; "
              f"ensembles equal to their steps run by hand (at a "
              f"bucket, bit for bit: ensemble_image "
              f"{exact['ensemble_image']}, ensemble_bert "
              f"{exact['ensemble_bert']}); classification "
              "strings parse as score:idx with the direct top 3", flush=True)

        body, _ = _infer_body(
            {"INPUT": np.zeros((1, 224, 224, 3), np.float32)},
            [{"name": "OUTPUT", "parameters": {
                "shared_memory_region": "r0",
                "shared_memory_byte_size": 4000}}], binary=False)
        status, _, data = _post(server.port, "/v2/models/resnet50/infer", body)
        _check(status == 400 and b"not registered" in data,
               f"shared-memory output answered {status} {data!r}")
        print(f"vision: shared-memory output answered 400: "
              f"{json.loads(data)['error']}", flush=True)
        _grpc_vision_checks(server.port, grpc_server.url)
    finally:
        grpc_server.stop()
        server.stop()
        engine.shutdown()

    # Device time of one forward of each model at its largest bucket, on the
    # modules the engine served (random inputs, no engine).
    gen = torch.Generator(device="cuda").manual_seed(7)
    for name, bucket in (("resnet50", 32), ("densenet_onnx", 16),
                         ("ssd_mobilenet_v2_tpu", 16),
                         ("ssd_mobilenet_v2_coco_quantized", 1)):
        backend = engine.repository.get(name).backend
        if name in SSD_MODELS:
            inputs = {"normalized_input_image_tensor": torch.randint(
                0, 256, (bucket, 300, 300, 3), dtype=torch.uint8,
                device="cuda", generator=gen)}
        else:
            inputs = {"INPUT": torch.randn(bucket, 224, 224, 3,
                                           device="cuda", generator=gen)}
        f = _forward_profile(torch, backend, inputs)
        ms = f["ms"]
        print(f"vision: {name} forward at batch {bucket}: device "
              f"{ms:.3f} ms (median of {N_TIMED}, CUDA events, queued "
              f"behind a sleeping kernel), {bucket / ms * 1e3:.1f} images/s, "
              f"{f['flops'] / 1e9:.1f} GFLOP "
              f"({f['flops'] / (ms / 1e3) / PEAK_BF16_FLOPS * 100:.2f}% of "
              f"the {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s dense bf16 peak); "
              f"card busy {f['busy_ms']:.3f} ms in {f['launches']} kernels "
              f"({f['busy_ms'] / ms * 100:.1f}% of the device time); wall "
              f"{f['wall_ms']:.3f} ms with the card waiting on the host, "
              f"which launches it in {f['host_ms']:.3f} ms; longest kernels "
              f"(name, ms, calls) {f['top']}; {smi}", flush=True)
    _nms_split(torch, smi)


# -- stateful phase -----------------------------------------------------------

STATEFUL_MODELS = ("dlrm", "dlrm_cached", "simple_sequence",
                   "simple_sequence_oldest", "simple_repeat")
DLRM_MODEL = "dlrm_mlperf"
# MLPerf Inference's DLRM (Criteo) shape: 26 tables of 128, 13 dense
# features, bottom MLP 512-256, top MLP 1024-1024-512-256; the tables cut
# to 65,536 rows each (0.87 GB stacked, fp32). Row-sharded over 2 shards on
# the one card, combined by K3. Not a registered model: the JAX zoo has no
# such entry; the arguments are the JAX DlrmBackend's.
MLPERF_DLRM = dict(num_tables=26, table_rows=65_536, emb_dim=128,
                   dense_dim=13, bottom_units=(512, 256),
                   top_units=(1024, 1024, 512, 256), max_batch_size=32,
                   max_lookups=4096, emb_shards=2, combine="ring", seed=26)
# Served DLRM scores vs the same request run alone through
# Model.execute_timed: rows always pad to max_batch_size, so both run the
# same products on the same shapes and should agree bit for bit; where
# cuBLAS picks another order of additions, fp32 scores of magnitude ~1 may
# differ by a few ulps. Whether they were exact is printed.
DLRM_ATOL = 1e-5
DLRM_CONCURRENCY = 32
SEQ_MODELS = ("simple_sequence", "simple_sequence_oldest")
N_SEQ, SEQ_STEPS = 64, 8


def _mlperf_csr(rng, rows: int = 1) -> dict[str, np.ndarray]:
    """One CSR request of ``rows`` rows: bags of 1 to 4 ids in each of the
    26 tables, Zipf(1.3)-skewed ids (bench.py's DLRM traffic)."""
    t, table_rows = MLPERF_DLRM["num_tables"], MLPERF_DLRM["table_rows"]
    counts = rng.integers(1, 5, size=rows * t)
    nnz = int(counts.sum())
    idx = ((rng.zipf(1.3, size=nnz) - 1) % table_rows).astype(np.int32)
    off = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    dense = rng.standard_normal((rows, MLPERF_DLRM["dense_dim"])).astype(
        np.float32)
    return {"DENSE": dense, "INDICES": idx, "OFFSETS": off}


def _small_csr(rng, rows: int = 1) -> dict[str, np.ndarray]:
    """A CSR request for the registered ``dlrm`` / ``dlrm_cached`` (4
    tables of 64 rows, 8 dense features), Zipf-skewed ids."""
    counts = rng.integers(0, 5, size=rows * 4)
    idx = ((rng.zipf(1.3, size=int(counts.sum())) - 1) % 64).astype(np.int32)
    off = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return {"DENSE": rng.standard_normal((rows, 8)).astype(np.float32),
            "INDICES": idx, "OFFSETS": off}


def _http_infer(port: int, model: str, inputs: dict, binary: bool,
                parameters: dict | None = None):
    """(status, outputs or error words) of one /infer request."""
    body, headers = _infer_body(inputs, None, binary)
    if parameters:
        head_len = headers.get("Inference-Header-Content-Length")
        head = json.loads(body[:int(head_len)] if head_len else body)
        head.setdefault("parameters", {}).update(parameters)
        new = json.dumps(head).encode()
        if head_len:
            body = new + body[int(head_len):]
            headers = {"Inference-Header-Content-Length": str(len(new))}
        else:
            body = new
    status, rheaders, data = _post(port, f"/v2/models/{model}/infer", body,
                                   headers)
    if status != 200:
        return status, json.loads(data)["error"]
    return status, _any_outputs(rheaders, data)


def _grpc_infer(stub, model: str, inputs: dict, parameters=None,
                request_id: str = ""):
    """(code, outputs or error words) of one ModelInfer call."""
    import grpc

    try:
        resp = stub.ModelInfer(_grpc_request(
            model, inputs, request_id=request_id, parameters=parameters),
            timeout=GRPC_TIMEOUT_S)
    except grpc.RpcError as exc:
        return exc.code(), exc.details()
    return grpc.StatusCode.OK, _grpc_outputs(resp)


def _dlrm_checks(torch, engine, http_port: int, grpc_url: str,
                 smi: str, device) -> dict:
    """The MLPerf-shaped DLRM (and the registered two) over HTTP and gRPC;
    returns K3's launches over HTTP and over both."""
    import grpc

    from client_tpu_torch.parallel import emb_shard as es
    from client_tpu_torch.parallel import kv_shard as ks

    model = engine.repository.get(DLRM_MODEL)
    backend = model.backend

    def executions(name):
        return engine.model_statistics(name)["model_stats"][0][
            "execution_count"]

    rng = np.random.default_rng(26)
    reqs = [_mlperf_csr(rng) for _ in range(96)]
    http_reqs, grpc_reqs = reqs[:64], reqs[64:]
    channel, stub = _grpc_channel(grpc_url)
    try:
        # Counted: K3 launches once per sharded execution.
        e0 = executions(DLRM_MODEL)
        ks.launches = 0
        with concurrent.futures.ThreadPoolExecutor(DLRM_CONCURRENCY) as pool:
            http_out = list(pool.map(
                lambda ir: _http_infer(http_port, DLRM_MODEL, ir[1],
                                       binary=ir[0] % 2 == 1),
                enumerate(http_reqs)))
        http_launches, http_execs = ks.launches, executions(DLRM_MODEL) - e0
        with concurrent.futures.ThreadPoolExecutor(DLRM_CONCURRENCY) as pool:
            grpc_out = list(pool.map(
                lambda r: _grpc_infer(stub, DLRM_MODEL, r), grpc_reqs))
        launches, execs = ks.launches, executions(DLRM_MODEL) - e0
        for status, out in http_out:
            _check(status == 200, f"{DLRM_MODEL}: HTTP {status}: {out}")
        for code, out in grpc_out:
            _check(code == grpc.StatusCode.OK, f"{DLRM_MODEL}: gRPC {code}: "
                   f"{out}")
        on_card = device.type == "cuda"  # the CPU wrapper launches nothing
        _check((http_launches, launches) == ((http_execs, execs) if on_card
                                             else (0, 0)),
               f"K3 launched {http_launches} / {launches} times for "
               f"{http_execs} / {execs} sharded executions")
        _check(execs < len(reqs), f"{execs} executions for {len(reqs)} "
               "requests: the ragged scheduler batched nothing")
        print(f"stateful: {DLRM_MODEL}: {len(reqs)} one-row CSR requests "
              f"(64 over HTTP, JSON and binary, 32 over gRPC; "
              f"{DLRM_CONCURRENCY} at a time) in {execs} executions; K3 "
              f"launched {launches} times ({http_launches} over HTTP), one "
              "per execution", flush=True)

        # Every score against the same request run alone.
        exact, worst = 0, 0.0
        for r, out in zip(reqs, [o for _, o in http_out + grpc_out]):
            got = out["OUTPUT0"]
            _check(got.shape == (1, 1) and got.dtype == np.float32
                   and bool(np.isfinite(got).all()),
                   f"{DLRM_MODEL}: {got.shape} {got.dtype}")
            want, _ = model.execute_timed(dict(r), batch_size=int(
                r["INDICES"].shape[0]))
            want = want["OUTPUT0"][:1]
            exact += got.tobytes() == want.tobytes()
            worst = max(worst, float(np.abs(got - want).max()))
        _check(worst <= DLRM_ATOL, f"served scores off the direct run by "
               f"{worst} (tolerance {DLRM_ATOL})")
        print(f"stateful: {DLRM_MODEL}: every score equals the request run "
              f"alone through Model.execute_timed: {exact}/{len(reqs)} bit "
              f"for bit, max |served - direct| {worst} (tolerance "
              f"{DLRM_ATOL})", flush=True)

        # Sharded against unsharded bag sums, a full batch of 32 rows at
        # the largest lookup bucket.
        batch = _mlperf_csr(np.random.default_rng(27), rows=32)
        staged = {k: torch.from_numpy(v).to(device) for k, v in
                  backend.pre_stage(batch, MLPERF_DLRM["max_lookups"]).items()}
        num_seg = MLPERF_DLRM["max_batch_size"] * MLPERF_DLRM["num_tables"]
        with torch.inference_mode():
            sharded = backend.pooled(staged)
            whole = torch.from_numpy(backend.table_host).to(device)
            oracle = es.bag_sum_oracle(whole, staged["INDICES"],
                                       staged["SEG_IDS"], num_seg)
        _check(bool(torch.equal(sharded, oracle)),
               "sharded bag sums differ from the unsharded ones by "
               f"{float((sharded - oracle).abs().max())}")
        del whole, oracle
        print(f"stateful: {DLRM_MODEL}: pooled {list(sharded.shape)} over 2 "
              f"shards (ring) equals the unsharded table's bit for bit, "
              f"{int(batch['INDICES'].shape[0])} lookups in a bucket of "
              f"{MLPERF_DLRM['max_lookups']}", flush=True)

        # The registered two: dlrm over both transports against the direct
        # run, dlrm_cached until its row cache hits.
        small = engine.repository.get("dlrm")
        srng = np.random.default_rng(4)
        for i in range(6):
            r = _small_csr(srng, rows=1 + i % 3)
            status, out = _http_infer(http_port, "dlrm", r, binary=i % 2 == 0)
            code, gout = _grpc_infer(stub, "dlrm", r)
            _check(status == 200 and code == grpc.StatusCode.OK,
                   f"dlrm: {status} {out} / {code} {gout}")
            want, _ = small.execute_timed(dict(r), batch_size=int(
                r["INDICES"].shape[0]))
            for got in (out["OUTPUT0"], gout["OUTPUT0"]):
                _check(got.tobytes() == want["OUTPUT0"][:len(got)].tobytes(),
                       "dlrm: served score differs from the direct run")
            status, out = _http_infer(http_port, "dlrm_cached", r, True)
            _check(status == 200 and out["OUTPUT0"].tobytes()
                   == want["OUTPUT0"][:len(got)].tobytes(),
                   f"dlrm_cached: {status}, not equal to dlrm's score")
        cache = engine.repository.get("dlrm_cached").backend.row_cache
        snap = cache.snapshot()
        _check(snap["hit_rate"] > 0, f"dlrm_cached row cache: {snap}")
        print(f"stateful: dlrm over HTTP and gRPC bit for bit against the "
              f"direct run; dlrm_cached equal to dlrm, row cache {snap}",
              flush=True)

        # validate_ragged's 400s on both transports.
        r = _mlperf_csr(np.random.default_rng(5))
        over = {"DENSE": r["DENSE"], "INDICES": np.zeros(4097, np.int32),
                "OFFSETS": np.array([0] + [4097] * 26, np.int32)}
        cases = {
            "OFFSETS[-1]": {**r, "OFFSETS": np.concatenate(
                [r["OFFSETS"][:-1], [r["OFFSETS"][-1] + 1]]).astype(
                    np.int32)},
            "OFFSETS length": {**r, "OFFSETS": r["OFFSETS"][:-1]},
            "exceeding max_lookups": over,
            "out of range": {**r, "INDICES": np.full_like(
                r["INDICES"], MLPERF_DLRM["table_rows"])},
        }
        for words, bad in cases.items():
            status, err = _http_infer(http_port, DLRM_MODEL, bad, True)
            code, gerr = _grpc_infer(stub, DLRM_MODEL, bad)
            _check(status == 400 and words in err and err == gerr
                   and code == grpc.StatusCode.INVALID_ARGUMENT,
                   f"{words}: HTTP {status} {err!r}, gRPC {code} {gerr!r}")
        print(f"stateful: {len(cases)} malformed CSR requests answered 400 "
              "and INVALID_ARGUMENT with the same words", flush=True)

        # Printed, not claimed: throughput at a fixed concurrency, fill, and
        # one execution's device time at the largest lookup bucket.
        obs_rng = np.random.default_rng(28)
        pool_reqs = [_mlperf_csr(obs_rng) for _ in range(256)]
        e1 = executions(DLRM_MODEL)
        st1 = engine.model_statistics(DLRM_MODEL)["model_stats"][0]

        def client(k):
            lat = []
            for r in pool_reqs[k::DLRM_CONCURRENCY]:
                t = time.monotonic()
                status, out = _http_infer(http_port, DLRM_MODEL, r, True)
                _check(status == 200, f"{DLRM_MODEL}: {status} {out}")
                lat.append(time.monotonic() - t)
            return lat

        t0 = time.monotonic()
        with concurrent.futures.ThreadPoolExecutor(DLRM_CONCURRENCY) as pool:
            lats = [x for part in pool.map(client, range(DLRM_CONCURRENCY))
                    for x in part]
        wall = time.monotonic() - t0
        n_exec = executions(DLRM_MODEL) - e1
        split = _stats_split(
            st1, engine.model_statistics(DLRM_MODEL)["model_stats"][0])
        nnz = sum(int(r["INDICES"].shape[0]) for r in pool_reqs)
        device_ms = None
        if device.type == "cuda":
            with torch.inference_mode():
                device_ms = _queued_ms(torch, lambda: backend(staged),
                                       reps=10)
        print(f"stateful: {DLRM_MODEL} at concurrency {DLRM_CONCURRENCY} over "
              f"HTTP (binary, client threads in this process): "
              f"{len(pool_reqs) / wall} requests/s, latency p50 "
              f"{1e3 * float(np.percentile(lats, 50))} ms, p99 "
              f"{1e3 * float(np.percentile(lats, 99))} ms; {n_exec} "
              f"executions, {len(pool_reqs) / n_exec} rows and {nnz / n_exec}"
              f" lookups per execution; server-side ms per request "
              f"{split}; one execution of 32 rows at the "
              f"{MLPERF_DLRM['max_lookups']}-lookup bucket: device "
              f"{device_ms} ms (queued behind a sleeping kernel); {smi} "
              "(printed, not claimed)", flush=True)
        return {"ring_all_reduce": launches, "http_launches": http_launches}
    finally:
        channel.close()


def _stats_split(before: dict, after: dict) -> dict:
    """Mean server-side ms per request of each /stats phase between two
    snapshots of one model's statistics."""
    b, a = before["inference_stats"], after["inference_stats"]
    n = max(1, a["success"]["count"] - b["success"]["count"])
    return {k: (a[k]["ns"] - b[k]["ns"]) / n / 1e6
            for k in ("success", "queue", "compute_input", "compute_infer",
                      "compute_output")}


def _seq_expected(sid: int) -> list[int]:
    return np.cumsum([sid * 100 + i for i in range(SEQ_STEPS)]).tolist()


def _seq_over_http(port: int, model: str, sid: int) -> list:
    sums = []
    for i in range(SEQ_STEPS):
        status, out = _http_infer(
            port, model, {"INPUT": np.array([sid * 100 + i], np.int32)},
            binary=i % 2 == 1, parameters={
                "sequence_id": sid, "sequence_start": i == 0,
                "sequence_end": i == SEQ_STEPS - 1})
        _check(status == 200, f"{model} sequence {sid}: {status} {out}")
        sums.append(int(out["OUTPUT"][0]))
    return sums


def _seq_over_stream(url: str, model: str, sids: list[int]) -> dict:
    """Every step of ``sids`` on one ModelStreamInfer RPC, interleaved and
    sent at once; each sequence's sums by request id."""
    channel, stub = _grpc_channel(url)
    try:
        reqs = [_grpc_request(
            model, {"INPUT": np.array([sid * 100 + i], np.int32)},
            request_id=f"{sid}:{i}", parameters={
                "sequence_id": sid, "sequence_start": i == 0,
                "sequence_end": i == SEQ_STEPS - 1})
            for i in range(SEQ_STEPS) for sid in sids]
        got = {sid: [None] * SEQ_STEPS for sid in sids}
        for msg in stub.ModelStreamInfer(iter(reqs), timeout=GRPC_TIMEOUT_S):
            _check(not msg.error_message, f"{model}: {msg.error_message}")
            sid, i = map(int, msg.infer_response.id.split(":"))
            got[sid][i] = int(_grpc_outputs(msg.infer_response)["OUTPUT"][0])
        return got
    finally:
        channel.close()


def _sequence_checks(engine, http_port: int, grpc_url: str) -> None:
    """64 sequences of 8 steps side by side on each sequence model, half
    over HTTP and half over gRPC streams; restarts and the 400s."""
    import grpc

    for model in SEQ_MODELS:
        st0 = engine.model_statistics(model)["model_stats"][0]
        sids = list(range(1, N_SEQ + 1))
        t0 = time.monotonic()
        with concurrent.futures.ThreadPoolExecutor(N_SEQ // 2 + 8) as pool:
            http_f = {sid: pool.submit(_seq_over_http, http_port, model, sid)
                      for sid in sids[:N_SEQ // 2]}
            groups = [sids[N_SEQ // 2 + k::8] for k in range(8)]
            grpc_f = [pool.submit(_seq_over_stream, grpc_url, model, g)
                      for g in groups]
            got = {sid: f.result() for sid, f in http_f.items()}
            for f in grpc_f:
                got.update(f.result())
        wall = time.monotonic() - t0
        for sid in sids:
            _check(got[sid] == _seq_expected(sid),
                   f"{model} sequence {sid}: {got[sid]} != "
                   f"{_seq_expected(sid)}")
        st = engine.model_statistics(model)["model_stats"][0]
        steps = st["inference_count"] - st0["inference_count"]
        execs = st["execution_count"] - st0["execution_count"]
        widest = max(b["batch_size"] for b in st["batch_stats"])
        _check(steps == N_SEQ * SEQ_STEPS, f"{model}: {steps} steps")
        if model == "simple_sequence_oldest":
            _check(widest > 1, f"{model}: no wave held two sequences")
        print(f"stateful: {model}: {N_SEQ} sequences of {SEQ_STEPS} steps "
              f"({N_SEQ // 2} over HTTP, {N_SEQ // 2} on 8 gRPC streams), "
              f"every running sum exact; {steps} steps in {execs} executions "
              f"({steps / execs} sequences per execution, widest {widest}), "
              f"{steps / wall} steps/s, server-side ms per step "
              f"{_stats_split(st0, st)} (printed, not claimed)", flush=True)

        # A restart resets the sum; the 400s on both transports.
        sid = 9001
        sums = []
        for value, params in ((5, {"sequence_start": True}), (3, {}),
                              (10, {"sequence_start": True}),
                              (1, {"sequence_end": True})):
            status, out = _http_infer(http_port, model, {"INPUT": np.array(
                [value], np.int32)}, False, {"sequence_id": sid, **params})
            _check(status == 200, f"{model} restart: {status} {out}")
            sums.append(int(out["OUTPUT"][0]))
        _check(sums == [5, 8, 10, 11], f"{model} restart: {sums}")
        channel, stub = _grpc_channel(grpc_url)
        try:
            for params, words in (
                    ({"sequence_id": 0, "sequence_start": True},
                     "non-zero sequence id"),
                    ({"sequence_id": 9002}, "without start flag")):
                one = {"INPUT": np.array([1], np.int32)}
                status, err = _http_infer(http_port, model, one, False,
                                          params)
                code, gerr = _grpc_infer(stub, model, one, params)
                _check(status == 400 and words in err and err == gerr
                       and code == grpc.StatusCode.INVALID_ARGUMENT,
                       f"{model} {params}: HTTP {status} {err!r}, gRPC "
                       f"{code} {gerr!r}")
        finally:
            channel.close()
    print("stateful: a restart resets the sum; sequence id 0 and a step "
          "without a start answer 400 and INVALID_ARGUMENT on both "
          "sequence models", flush=True)


def _repeat_checks(http_port: int, grpc_url: str) -> None:
    """simple_repeat over /generate_stream and ModelStreamInfer: every OUT
    and IDX in order, then the end (SSE) or the final flag (gRPC)."""
    values = list(range(100, 124))
    body = {"inputs": [{"name": "IN", "datatype": "INT32",
                        "shape": [len(values)], "data": values}]}
    conn = http.client.HTTPConnection("127.0.0.1", http_port, timeout=600)
    try:
        conn.request("POST", "/v2/models/simple_repeat/generate_stream",
                     json.dumps(body).encode())
        resp = conn.getresponse()
        _check(resp.status == 200, f"simple_repeat SSE: {resp.status}")
        events = [json.loads(e[len(b"data: "):])
                  for e in resp.read().split(b"\n\n") if e]
    finally:
        conn.close()
    outs = [{o["name"]: o["data"] for o in e["outputs"]} for e in events]
    _check([o["OUT"] for o in outs] == [[v] for v in values]
           and [o["IDX"] for o in outs] == [[i] for i in range(len(values))]
           and all(e["parameters"] == {"triton_final_response": False}
                   for e in events),
           f"simple_repeat SSE events {events[:3]}...")
    channel, stub = _grpc_channel(grpc_url)
    try:
        reqs = [_grpc_request("simple_repeat", {"IN": np.array(
            values[k::2], np.int32)}, request_id=f"r{k}") for k in (0, 1)]
        got = {"r0": [], "r1": []}
        finals = set()
        for msg in stub.ModelStreamInfer(iter(reqs), timeout=GRPC_TIMEOUT_S):
            r = msg.infer_response
            _check(not msg.error_message and r.id not in finals,
                   f"simple_repeat stream: {msg.error_message or r.id}")
            if _grpc_final(r):
                _check(not r.outputs, "final message with outputs")
                finals.add(r.id)
                continue
            o = _grpc_outputs(r)
            got[r.id].append((int(o["OUT"][0]), int(o["IDX"][0])))
        _check(finals == {"r0", "r1"}, f"finals {finals}")
        for k in (0, 1):
            want = list(zip(values[k::2], range(len(values[k::2]))))
            _check(got[f"r{k}"] == want, f"simple_repeat r{k}: {got}")
    finally:
        channel.close()
    print(f"stateful: simple_repeat: {len(values)} responses over SSE and "
          "2 requests multiplexed on one ModelStreamInfer RPC, OUT and IDX "
          "in order, each gRPC request ended by its final flag", flush=True)


def stateful_phase(torch, smi: str, device: str = "cuda") -> dict:
    """DLRM (ragged batching, the row cache, row-sharded tables combined
    by K3), both sequence strategies and the decoupled simple_repeat, on
    one engine behind HTTP and gRPC. ``device`` is for a dry run of the
    phase's logic on the CPU at a cut size; the script runs it on cuda."""
    from client_tpu_torch.engine import TorchEngine
    from client_tpu_torch.models import build_repository
    from client_tpu_torch.models.dlrm import DlrmBackend
    from client_tpu_torch.server import (
        GrpcInferenceServer,
        HttpInferenceServer,
    )

    device = torch.device(device)
    repo = build_repository(list(STATEFUL_MODELS))
    repo.register(DLRM_MODEL, lambda dev: DlrmBackend(
        name=DLRM_MODEL, device=dev, emb_devices=[dev] * 2, **MLPERF_DLRM))
    t0 = time.monotonic()
    engine = TorchEngine(repo, device=device)
    server = HttpInferenceServer(engine, port=0).start()
    grpc_server = GrpcInferenceServer(engine, port=0).start()
    served = engine.repository.names()
    table_gb = engine.repository.get(DLRM_MODEL).backend.table_host.nbytes / 1e9
    print(f"stateful: {len(served)} models up in {time.monotonic() - t0:.1f}"
          f" s: {served}; {DLRM_MODEL}'s stacked table {table_gb:.2f} GB in "
          f"2 shards on {device}", flush=True)
    try:
        counts = _dlrm_checks(torch, engine, server.port, grpc_server.url,
                              smi, device)
        _sequence_checks(engine, server.port, grpc_server.url)
        _repeat_checks(server.port, grpc_server.url)
        return counts
    finally:
        grpc_server.stop()
        server.stop()
        engine.shutdown()


# -- shm phase ----------------------------------------------------------------

SHM_MODELS = ("simple", "simple_string", "bert_base", "bert_long",
              "resnet50")
SHM_BYTES_ROOM = 512  # placement bytes of a BYTES output
SHM_PLANES = ("system", "cuda", "tpu")
OBS_REQUESTS, OBS_CONCURRENCY = 64, 16


class _Segment:
    """A POSIX shm segment made, written and read by the script's own
    ``mmap`` code (not the port's utilities), unlinked on close."""

    def __init__(self, key: str, size: int):
        import mmap

        self.key, self.size = key, size
        self.path = "/dev/shm/" + key.lstrip("/")
        fd = os.open(self.path, os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o600)
        try:
            os.ftruncate(fd, size)
            self.map = mmap.mmap(fd, size)
        finally:
            os.close(fd)

    def write(self, offset: int, raw: bytes) -> None:
        self.map[offset:offset + len(raw)] = raw

    def read(self, offset: int, size: int) -> bytes:
        return bytes(self.map[offset:offset + size])

    def close(self) -> None:
        self.map.close()
        os.unlink(self.path)


def _get(port: int, path: str):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read() or b"null")
    finally:
        conn.close()


def _handle(key: str, size: int) -> bytes:
    """A host-staged device region's handle, written by the script from
    the protocol: JSON with the kind, shm key, byte size and device id."""
    return json.dumps({"kind": "host_staged", "key": key, "byte_size": size,
                       "device_id": 0}).encode()


class _Plane:
    """Register, status and unregister of one shm plane ("system", "cuda"
    or "tpu") over one transport ("http" or "grpc")."""

    def __init__(self, plane: str, wire: str, http_port: int, stub):
        self.plane, self.wire = plane, wire
        self.port, self.stub = http_port, stub
        self.rpc = {"system": "SystemSharedMemory", "cuda":
                    "CudaSharedMemory", "tpu": "TpuSharedMemory"}[plane]

    def _call(self, verb: str, **fields):
        """(ok, answer): the RPC's response, or its code and words."""
        import grpc

        from client_tpu_torch.protocol import grpc_service_pb2 as pb

        request = getattr(pb, f"{self.rpc}{verb}Request")(**fields)
        try:
            return True, getattr(self.stub, f"{self.rpc}{verb}")(
                request, timeout=GRPC_TIMEOUT_S)
        except grpc.RpcError as exc:
            return False, (exc.code(), exc.details())

    def register(self, name: str, seg: _Segment):
        """(ok, error answer or None)."""
        if self.wire == "grpc":
            if self.plane == "system":
                ok, ans = self._call("Register", name=name, key=seg.key,
                                     offset=0, byte_size=seg.size)
            else:
                ok, ans = self._call(
                    "Register", name=name, raw_handle=_handle(
                        seg.key, seg.size), device_id=0, byte_size=seg.size)
            return ok, None if ok else ans
        import base64

        body = ({"key": seg.key, "offset": 0, "byte_size": seg.size}
                if self.plane == "system" else
                {"raw_handle": {"b64": base64.b64encode(_handle(
                    seg.key, seg.size)).decode()}, "device_id": 0,
                 "byte_size": seg.size})
        status, _, data = _post(
            self.port, f"/v2/{self.plane}sharedmemory/region/{name}/register",
            json.dumps(body).encode())
        return status == 200, None if status == 200 else (
            status, json.loads(data)["error"])

    def status(self) -> set[str]:
        if self.wire == "grpc":
            ok, resp = self._call("Status")
            _check(ok, f"{self.rpc}Status: {resp}")
            return set(resp.regions)
        status, body = _get(self.port, f"/v2/{self.plane}sharedmemory/status")
        _check(status == 200, f"{self.plane} status: HTTP {status}")
        return set(body)

    def unregister(self, name: str | None = None) -> None:
        if self.wire == "grpc":
            ok, resp = self._call("Unregister", name=name or "")
            _check(ok, f"{self.rpc}Unregister: {resp}")
            return
        path = (f"/v2/{self.plane}sharedmemory"
                + (f"/region/{name}" if name else "") + "/unregister")
        status, _, data = _post(self.port, path, b"{}")
        _check(status == 200, f"{path}: HTTP {status}: {data!r}")


def _wire_dtype(arr: np.ndarray) -> str:
    names = {np.dtype(v): k for k, v in _WIRE_DTYPES.items()}
    return "BYTES" if arr.dtype == np.object_ else names[arr.dtype]


def _shm_params(region: str, offset: int, size: int) -> dict:
    return {"shared_memory_region": region, "shared_memory_offset": offset,
            "shared_memory_byte_size": size}


def _out_rooms(config, rows: int) -> tuple:
    """(output, placement bytes) of one request of ``rows`` rows: the exact
    size of a fixed-size output, room to spare for a BYTES one."""
    return tuple(
        (t.name, SHM_BYTES_ROOM if t.data_type == "BYTES" else
         rows * int(np.prod(t.dims)) * np.dtype(
             _WIRE_DTYPES[t.data_type]).itemsize)
        for t in config.output)


def _shm_layout(inputs: dict, outputs) -> tuple[dict, dict, int]:
    """Offsets of the inputs (back to back) and then of the outputs in one
    segment, and its size."""
    at, pos = {}, 0
    for name, arr in inputs.items():
        at[name] = (pos, len(_wire_bytes(arr)))
        pos += len(_wire_bytes(arr))
    out_at = {}
    for name, size in outputs:
        out_at[name] = (pos, size)
        pos += size
    return at, out_at, pos


def _shm_infer(plane: _Plane, model: str, region: str, seg: _Segment,
               inputs: dict, rooms: tuple, offsets: dict | None = None):
    """One request with every input read from ``region`` and every output
    written into it; (ok, outputs read back from the segment, or the error
    answer). ``offsets`` overrides input offsets (the 400 cases)."""
    import grpc

    from client_tpu_torch.protocol import grpc_service_pb2 as pb

    at, out_at, _ = _shm_layout(inputs, rooms)
    for name, arr in inputs.items():
        seg.write(at[name][0], _wire_bytes(arr))
    if offsets:
        at = {**at, **offsets}
    if plane.wire == "http":
        head = {"inputs": [{
            "name": name, "datatype": _wire_dtype(arr),
            "shape": list(arr.shape),
            "parameters": _shm_params(region, *at[name])}
            for name, arr in inputs.items()],
            "outputs": [{"name": name, "parameters": _shm_params(
                region, *out_at[name])} for name in out_at]}
        status, headers, data = _post(
            plane.port, f"/v2/models/{model}/infer", json.dumps(head).encode())
        if status != 200:
            return False, (status, json.loads(data)["error"])
        _check("Inference-Header-Content-Length" not in headers,
               f"{model}: a binary tail beside shm outputs")
        entries = [(o["name"], o["datatype"], o["shape"], o["parameters"])
                   for o in json.loads(data)["outputs"]]
    else:
        req = pb.ModelInferRequest(model_name=model)
        for name, arr in inputs.items():
            t = req.inputs.add(name=name, datatype=_wire_dtype(arr),
                               shape=list(arr.shape))
            for k, v in _shm_params(region, *at[name]).items():
                _set_param(t.parameters, k, v)
        for name in out_at:
            o = req.outputs.add(name=name)
            for k, v in _shm_params(region, *out_at[name]).items():
                _set_param(o.parameters, k, v)
        try:
            resp = plane.stub.ModelInfer(req, timeout=GRPC_TIMEOUT_S)
        except grpc.RpcError as exc:
            return False, (exc.code(), exc.details())
        _check(not resp.raw_output_contents,
               f"{model}: raw contents beside shm outputs")
        entries = [(t.name, t.datatype, list(t.shape), {
            k: (v.string_param or v.int64_param)
            for k, v in t.parameters.items()}) for t in resp.outputs]
    out = {}
    for name, dtype, shape, params in entries:
        offset, room = out_at[name]
        written = int(params["shared_memory_byte_size"])
        _check(params["shared_memory_region"] == region
               and int(params.get("shared_memory_offset", 0)) == offset
               and 0 < written <= room, f"{model} {name}: {params}")
        raw = seg.read(offset, written)
        if dtype == "BYTES":
            arr = _bytes_elements(raw)
        else:
            arr = np.frombuffer(raw, np.dtype(_WIRE_DTYPES[dtype])
                                .newbyteorder("<")).astype(_WIRE_DTYPES[dtype])
        out[name] = arr.reshape(shape)
    return True, out


def _bert_feed(rng, seq: int, valid: int) -> dict[str, np.ndarray]:
    """One ``bert_long`` row: random ids, ``valid`` tokens attended."""
    mask = np.zeros((1, seq), np.int32)
    mask[0, :valid] = 1
    return {"input_ids": rng.integers(0, 512, (1, seq)).astype(np.int32),
            "attention_mask": mask}


def _shm_requests(rng, seq: int) -> dict[str, dict[str, np.ndarray]]:
    """One request's inputs for each model the planes carry."""
    simple = _simple_requests(rng)
    return {
        "simple": {k: v[:2] for k, v in simple["simple"].items()},
        "simple_string": simple["simple_string"],
        "bert_long": _bert_feed(rng, seq, seq * 3 // 4),
        "resnet50": {"INPUT": rng.standard_normal((1, 224, 224, 3)).astype(
            np.float32)},
    }


def _planes_checks(http_port: int, stub, requests: dict, rooms: dict,
                   inline: dict, tag: str) -> int:
    """Every plane over both transports: register the four models' regions,
    status, each request with inputs and outputs in its region (bit for bit
    against the same request inline), unregister one, unregister all, and
    the 400s. Returns the requests sent."""
    import grpc

    sent = 0
    bad_arg = {"http": 400, "grpc": grpc.StatusCode.INVALID_ARGUMENT}
    for plane_name in SHM_PLANES:
        for wire in ("http", "grpc"):
            plane = _Plane(plane_name, wire, http_port, stub)
            segs = {}
            try:
                for model, inputs in requests.items():
                    size = _shm_layout(inputs, rooms[model])[2]
                    segs[model] = _Segment(
                        f"/{tag}_{plane_name}_{wire}_{model}", size)
                    ok, err = plane.register(model, segs[model])
                    _check(ok, f"{plane_name}/{wire} register {model}: {err}")
                _check(plane.status() == set(requests),
                       f"{plane_name}/{wire} status {plane.status()}")
                for model, inputs in requests.items():
                    ok, got = _shm_infer(plane, model, model, segs[model],
                                         inputs, rooms[model])
                    _check(ok, f"{plane_name}/{wire} {model}: {got}")
                    sent += 1
                    for name, want in inline[model].items():
                        _check(_same_tensor(got[name], want),
                               f"{plane_name}/{wire} {model} {name}: shm "
                               "output differs from the inline answer")
                # The 400s: an unregistered region, a double register, an
                # input offset past the region.
                simple = requests["simple"]
                ok, ans = _shm_infer(plane, "simple", "no_such_region",
                                     segs["simple"], simple, rooms["simple"])
                _check(not ok and ans == (
                    bad_arg[wire],
                    "shared memory region 'no_such_region' not registered"),
                    f"{plane_name}/{wire} unregistered: {ans}")
                ok, ans = plane.register("simple", segs["simple"])
                _check(not ok and ans == (
                    bad_arg[wire],
                    "shared memory region 'simple' already registered"),
                    f"{plane_name}/{wire} double register: {ans}")
                size = segs["simple"].size
                ok, ans = _shm_infer(plane, "simple", "simple",
                                     segs["simple"], simple, rooms["simple"],
                                     offsets={"INPUT1": (size + 64, 128)})
                _check(not ok and ans == (
                    bad_arg[wire],
                    f"offset {size + 64} outside region 'simple' "
                    f"({size}B)"), f"{plane_name}/{wire} offset: {ans}")
                plane.unregister("simple")
                _check(plane.status() == set(requests) - {"simple"},
                       f"{plane_name}/{wire} after unregister-one: "
                       f"{plane.status()}")
                plane.unregister()
                _check(plane.status() == set(),
                       f"{plane_name}/{wire} after unregister-all")
            finally:
                plane.unregister()
                for seg in segs.values():
                    seg.close()
    return sent


def _utils_checks(http_port: int, stub) -> None:
    """Regions made with the port's client utilities, one of each kind,
    registered over HTTP and gRPC and served; the outputs read back with
    ``get_contents_as_numpy``."""
    from client_tpu_torch.protocol import grpc_service_pb2 as pb
    from client_tpu_torch.utils import cuda_shared_memory as cudashm
    from client_tpu_torch.utils import shared_memory as sysshm

    a = np.arange(16, dtype=np.int32).reshape(1, 16)
    b = np.full((1, 16), 7, np.int32)
    key = f"/chip_smoke_utils_{os.getpid()}"
    sys_h = sysshm.create_shared_memory_region("u_sys", key, 192)
    dev_h = cudashm.create_shared_memory_region("u_dev", 64)
    try:
        sysshm.set_shared_memory_region(sys_h, [a, b])
        status, _, data = _post(
            http_port, "/v2/systemsharedmemory/region/u_sys/register",
            json.dumps({"key": key, "byte_size": 192}).encode())
        _check(status == 200, f"utils register: {data!r}")
        stub.CudaSharedMemoryRegister(pb.CudaSharedMemoryRegisterRequest(
            name="u_dev", raw_handle=cudashm.get_raw_handle(dev_h),
            device_id=0, byte_size=64), timeout=GRPC_TIMEOUT_S)
        head = {"inputs": [
            {"name": f"INPUT{i}", "datatype": "INT32", "shape": [1, 16],
             "parameters": _shm_params("u_sys", 64 * i, 64)}
            for i in range(2)], "outputs": [
            {"name": "OUTPUT0", "parameters": _shm_params("u_sys", 128, 64)},
            {"name": "OUTPUT1", "parameters": _shm_params("u_dev", 0, 64)}]}
        status, _, data = _post(http_port, "/v2/models/simple/infer",
                                json.dumps(head).encode())
        _check(status == 200, f"utils infer: {data!r}")
        got0 = sysshm.get_contents_as_numpy(sys_h, np.int32, (1, 16), 128)
        got1 = cudashm.get_contents_as_numpy(dev_h, np.int32, (1, 16))
        _check(got0.tolist() == (a + b).tolist()
               and got1.tolist() == (a - b).tolist(),
               f"utils: {got0} {got1}")
        for path in ("/v2/systemsharedmemory/unregister",
                     "/v2/cudasharedmemory/unregister"):
            _post(http_port, path, b"{}")
    finally:
        sysshm.destroy_shared_memory_region(sys_h)
        cudashm.destroy_shared_memory_region(dev_h)
    print("shm: the port's client utilities: a system region and a device "
          "region served, outputs read back with get_contents_as_numpy",
          flush=True)


def _group_batches(resps: list, name: str) -> list[tuple[int, list]]:
    """The executions behind ``resps`` (keep_outputs_on_device): requests
    whose output ``name`` shares one storage ran in one batch. Per batch,
    its bucket and its requests in row order."""
    groups = collections.defaultdict(list)
    for i, resp in enumerate(resps):
        t = resp.outputs[name]
        groups[t.untyped_storage().data_ptr()].append(i)
    batches = []
    for ptr, members in groups.items():
        t = resps[members[0]].outputs[name]
        row = t[0].nbytes
        nbytes = t.untyped_storage().nbytes()
        _check(nbytes % row == 0, f"{name}: storage of {nbytes} B")
        rows = {(resps[i].outputs[name].data_ptr() - ptr) // row: i
                for i in members}
        _check(sorted(rows) == list(range(len(members))),
               f"{name}: request rows {sorted(rows)}")
        batches.append((nbytes // row, [rows[k] for k in sorted(rows)]))
    return batches


def _inline_rows(model, feeds: list[dict], bucket: int) -> dict:
    """The same rows through the host path at the same bucket: a lone
    request padded with zeros (as the executor pads it), several with the
    first repeated (as the device concatenation pads them)."""
    rows = feeds + ([feeds[0]] * (bucket - len(feeds)) if len(feeds) > 1
                    else [])
    host = {name: np.concatenate([f[name] for f in rows])
            for name in feeds[0]}
    out, _ = model.execute_timed(host, batch_size=len(rows))
    return out


def _device_region_checks(torch, engine, rng) -> dict:
    """In process, on the card: 4 ``bert_long`` and 16 ``resnet50``
    requests at once, inputs and outputs in device regions of tensors on
    the card, with ``keep_outputs_on_device``. Returns K1's launches and
    the ``bert_long`` batches."""
    from torch.profiler import ProfilerActivity, profile

    from client_tpu_torch.engine import InferRequest, OutputRequest
    from client_tpu_torch.ops import flash_attention as fa

    device = engine.device
    cuda = device.type == "cuda"
    seq = engine.repository.get("bert_long").config.input[0].dims[0]
    feeds = {"bert_long": [_bert_feed(rng, seq, seq // 2 + k * seq // 8)
                           for k in range(4)],
             "resnet50": [{"INPUT": rng.standard_normal(
                 (1, 224, 224, 3)).astype(np.float32)} for _ in range(16)]}
    out_shapes = {model: {t.name: (1, *t.dims) for t in
                          engine.repository.get(model).config.output}
                  for model in feeds}
    reqs = []
    for model, rows in feeds.items():
        for k, feed in enumerate(rows):
            for name, arr in feed.items():
                engine.cuda_shm.register_device_tensor(
                    f"{model}_{k}_{name}", torch.from_numpy(arr).to(device))
            for name, shape in out_shapes[model].items():
                engine.cuda_shm.register_device_tensor(
                    f"{model}_{k}_out_{name}",
                    torch.zeros(shape, device=device))
            reqs.append((model, k))
    if cuda:
        torch.cuda.synchronize()
    done = threading.Event()
    resps, lock = {}, threading.Lock()

    def submit():
        for model, k in reqs:
            def cb(resp, key=(model, k)):
                with lock:
                    resps[key] = resp
                    if len(resps) == len(reqs):
                        done.set()
            engine.async_infer(InferRequest(
                model_name=model, inputs={
                    name: engine.read_shm_tensor(
                        f"{model}_{k}_{name}", 0, arr.nbytes,
                        _wire_dtype(arr), arr.shape)
                    for name, arr in feeds[model][k].items()},
                outputs=[OutputRequest(name=n) for n in out_shapes[model]],
                keep_outputs_on_device=True), cb)
        _check(done.wait(600), "device-region requests timed out")
        for (model, k), resp in resps.items():
            _check(resp.error is None, f"{model} {k}: {resp.error}")
            for name, t in resp.outputs.items():
                engine.write_shm_tensor(f"{model}_{k}_out_{name}", 0, 0, t)
        if cuda:
            torch.cuda.synchronize()

    before = fa.launches
    t0 = time.monotonic()
    if cuda:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            submit()
        names = collections.Counter()
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                names[e.key] += e.count
        copies = {k: n for k, n in names.items()
                  if "Memcpy HtoD" in k or "Memcpy DtoH" in k}
        _check(sum(names.values()) > 0, "the profiler saw no device work")
        _check(not copies, f"host/card copies on the device-region path: "
                           f"{copies}")
        print(f"shm: device regions: {sum(names.values())} device events "
              f"in the profiler window, no Memcpy HtoD / DtoH "
              f"({len(names)} kinds)", flush=True)
    else:
        submit()
    wall = time.monotonic() - t0
    launches = fa.launches - before
    batches = {}
    for model in feeds:
        model_resps = [resps[(model, k)] for k in range(len(feeds[model]))]
        first = next(iter(out_shapes[model]))
        batches[model] = _group_batches(model_resps, first)
        served = engine.repository.get(model)
        for bucket, members in batches[model]:
            want = _inline_rows(served, [feeds[model][k] for k in members],
                                bucket)
            for row, k in enumerate(members):
                for name, t in model_resps[k].outputs.items():
                    _check(t.device.type == device.type,
                           f"{model} {k} {name} on {t.device}")
                    back = engine.cuda_shm.read_back(f"{model}_{k}_out_{name}")
                    _check(back.untyped_storage().data_ptr()
                           == model_resps[members[0]].outputs[name]
                           .untyped_storage().data_ptr(),
                           f"{model} {k} {name}: the region does not share "
                           "its batch's output storage")
                    _check(back.cpu().numpy().tobytes()
                           == want[name][row:row + 1].tobytes(),
                           f"{model} {k} {name}: device-region output "
                           "differs from the inline run at bucket "
                           f"{bucket}")
    n_bert = len(batches["bert_long"])
    if cuda:
        _check(launches == 12 * n_bert,
               f"K1 launched {launches} times for {n_bert} bert_long "
               "batches (12 a batch)")
    print(f"shm: device regions: 4 bert_long in {n_bert} batches "
          f"{batches['bert_long']}, 16 resnet50 in "
          f"{len(batches['resnet50'])} batches (buckets "
          f"{sorted(b for b, _ in batches['resnet50'])}), in {wall:.2f} s; "
          f"every output bit for bit against the inline run at its bucket; "
          f"K1 launches {launches}", flush=True)
    engine.cuda_shm.unregister(None)
    return {"launches": launches, "bert_batches": n_bert}


def _side_stream_check(torch, engine, rng) -> None:
    """A ``bert_long`` input region filled on a side stream behind a
    ~10 ms sleep and registered there: the request reads the filled rows
    (the batch's stream waits on the region's event)."""
    from client_tpu_torch.engine import InferRequest

    device = engine.device
    seq = engine.repository.get("bert_long").config.input[0].dims[0]
    feed = _bert_feed(rng, seq, seq // 3)
    side = torch.cuda.Stream(device=device)
    inputs = {}
    for name, arr in feed.items():
        t = torch.zeros(arr.shape, dtype=torch.int32, device=device)
        src = torch.from_numpy(arr).to(device)
        torch.cuda.synchronize()
        with torch.cuda.stream(side):
            torch.cuda._sleep(20_000_000)
            t.copy_(src)
            engine.cuda_shm.register_device_tensor(f"side_{name}", t)
        inputs[name] = engine.read_shm_tensor(f"side_{name}", 0, arr.nbytes,
                                              "INT32", arr.shape)
    resp = engine.infer(InferRequest(
        model_name="bert_long", inputs=inputs, keep_outputs_on_device=True),
        timeout_s=600)
    want = _inline_rows(engine.repository.get("bert_long"), [feed], 1)
    for name, t in resp.outputs.items():
        _check(t.cpu().numpy().tobytes() == want[name].tobytes(),
               f"side stream: {name} differs from the filled rows' answer")
    engine.cuda_shm.unregister(None)
    print("shm: a device region filled on a side stream just before its "
          "request: answered from the filled rows", flush=True)


def _shm_observation(torch, engine, http_port: int, stub, smi: str,
                     rng) -> None:
    """One observation line: ``resnet50``, 64 one-image requests at
    concurrency 16 over binary HTTP, system shm over HTTP and host-staged
    regions over gRPC (requests/s, p50, bytes on the wire per request,
    compute_input per request from /stats); and ``bert_long`` in process,
    compute_input and compute_output on device regions against host
    arrays. Observations, not claims."""
    import queue as queue_mod

    from client_tpu_torch.engine import InferRequest
    from client_tpu_torch.protocol import grpc_service_pb2 as pb

    images = [rng.standard_normal((1, 224, 224, 3)).astype(np.float32)
              for _ in range(8)]
    in_size, out_size = images[0].nbytes, 4000
    slots = queue_mod.Queue()
    segs = [_Segment(f"/chip_smoke_obs_{os.getpid()}_{i}", in_size + out_size)
            for i in range(OBS_CONCURRENCY)]
    try:
        for i, seg in enumerate(segs):
            status, _, data = _post(
                http_port, f"/v2/systemsharedmemory/region/obs{i}/register",
                json.dumps({"key": seg.key, "byte_size": seg.size}).encode())
            _check(status == 200, f"obs register: {data!r}")
            stub.CudaSharedMemoryRegister(pb.CudaSharedMemoryRegisterRequest(
                name=f"obs{i}", raw_handle=_handle(seg.key, seg.size),
                device_id=0, byte_size=seg.size), timeout=GRPC_TIMEOUT_S)
            slots.put(i)

        def binary_http(img):
            body, headers = _infer_body({"INPUT": img}, None, True)
            status, rh, data = _post(http_port, "/v2/models/resnet50/infer",
                                     body, headers)
            _check(status == 200, f"binary: {data[:200]!r}")
            out = _any_outputs(rh, data)["OUTPUT"]
            return out, len(body) + len(data)

        def shm_http(img):
            i = slots.get()
            try:
                segs[i].write(0, img.tobytes())
                head = {"inputs": [{
                    "name": "INPUT", "datatype": "FP32", "shape": [1, 224,
                                                                   224, 3],
                    "parameters": _shm_params(f"obs{i}", 0, in_size)}],
                    "outputs": [{"name": "OUTPUT", "parameters": _shm_params(
                        f"obs{i}", in_size, out_size)}]}
                body = json.dumps(head).encode()
                status, _, data = _post(
                    http_port, "/v2/models/resnet50/infer", body)
                _check(status == 200, f"shm: {data[:200]!r}")
                out = np.frombuffer(segs[i].read(in_size, out_size),
                                    np.float32).reshape(1, 1000)
                return out, len(body) + len(data)
            finally:
                slots.put(i)

        def staged_grpc(img):
            i = slots.get()
            try:
                segs[i].write(0, img.tobytes())
                req = pb.ModelInferRequest(model_name="resnet50")
                t = req.inputs.add(name="INPUT", datatype="FP32",
                                   shape=[1, 224, 224, 3])
                for k, v in _shm_params(f"obs{i}", 0, in_size).items():
                    _set_param(t.parameters, k, v)
                o = req.outputs.add(name="OUTPUT")
                for k, v in _shm_params(f"obs{i}", in_size,
                                        out_size).items():
                    _set_param(o.parameters, k, v)
                resp = stub.ModelInfer(req, timeout=GRPC_TIMEOUT_S)
                out = np.frombuffer(segs[i].read(in_size, out_size),
                                    np.float32).reshape(1, 1000)
                return out, req.ByteSize() + resp.ByteSize()
            finally:
                slots.put(i)

        def stats(model):
            status, body = _get(http_port, f"/v2/models/{model}/stats")
            _check(status == 200, f"{model} stats: HTTP {status}")
            return body["model_stats"][0]

        routes = {}
        for route, fn in (("binary_http", binary_http),
                          ("system_shm_http", shm_http),
                          ("host_staged_grpc", staged_grpc)):
            def timed(img, fn=fn):
                t = time.monotonic()
                out, wire = fn(img)
                return out, wire, time.monotonic() - t

            before = stats("resnet50")
            t0 = time.monotonic()
            with concurrent.futures.ThreadPoolExecutor(
                    OBS_CONCURRENCY) as pool:
                results = list(pool.map(
                    timed, [images[k % len(images)]
                            for k in range(OBS_REQUESTS)]))
            wall = time.monotonic() - t0
            split = _stats_split(before, stats("resnet50"))
            for out, _, _ in results:
                _check(out.shape == (1, 1000) and np.isfinite(out).all(),
                       f"{route}: resnet50 output {out.shape}")
            routes[route] = {
                "requests_per_s": OBS_REQUESTS / wall,
                "p50_ms": float(np.median([r[2] for r in results])) * 1e3,
                "wire_bytes_per_request": float(np.mean(
                    [r[1] for r in results])),
                "compute_input_ms": split["compute_input"]}
    finally:
        _post(http_port, "/v2/systemsharedmemory/unregister", b"{}")
        _post(http_port, "/v2/cudasharedmemory/unregister", b"{}")
        for seg in segs:
            seg.close()

    # bert_long in process: device regions against host arrays, 4 at once.
    seq = engine.repository.get("bert_long").config.input[0].dims[0]
    feeds = [_bert_feed(rng, seq, seq // 2 + k * seq // 8) for k in range(4)]
    bert = {}
    for path in ("device_regions", "host_arrays"):
        reqs = []
        for k, feed in enumerate(feeds):
            if path == "host_arrays":
                inputs = dict(feed)
            else:
                inputs = {}
                for name, arr in feed.items():
                    engine.cuda_shm.register_device_tensor(
                        f"obs_{k}_{name}",
                        torch.from_numpy(arr).to(engine.device))
                    inputs[name] = engine.read_shm_tensor(
                        f"obs_{k}_{name}", 0, arr.nbytes, "INT32", arr.shape)
            reqs.append(InferRequest(
                model_name="bert_long", inputs=inputs,
                keep_outputs_on_device=path == "device_regions"))
        before = stats("bert_long")
        with concurrent.futures.ThreadPoolExecutor(4) as pool:
            list(pool.map(lambda r: engine.infer(r, timeout_s=600), reqs))
        split = _stats_split(before, stats("bert_long"))
        bert[path] = {"compute_input_ms": split["compute_input"],
                      "compute_output_ms": split["compute_output"]}
        engine.cuda_shm.unregister(None)
    print("shm observation: " + json.dumps({
        "card": smi, "resnet50": {
            "requests": OBS_REQUESTS, "concurrency": OBS_CONCURRENCY,
            **routes}, "bert_long_in_process": bert}), flush=True)


def shm_phase(torch, smi: str, device: str = "cuda") -> dict:
    """The shared-memory data planes: system regions and host-staged device
    regions over HTTP and gRPC for ``simple``, ``simple_string``,
    ``bert_long`` and ``resnet50``, every output bit for bit against the
    same request inline; in-process device regions of tensors on the card;
    the port's client utilities; an observation line. ``device`` is for a
    dry run of the phase's logic on the CPU; the script runs it on
    cuda."""
    from client_tpu_torch.engine import TorchEngine
    from client_tpu_torch.models import build_repository
    from client_tpu_torch.ops import flash_attention as fa
    from client_tpu_torch.server import (
        GrpcInferenceServer,
        HttpInferenceServer,
    )

    t_phase = time.monotonic()
    usage = shutil.disk_usage("/dev/shm")
    print(f"shm: /dev/shm {usage.total / 2**20:.0f} MiB, "
          f"{usage.free / 2**20:.0f} MiB free", flush=True)
    t0 = time.monotonic()
    engine = TorchEngine(build_repository(list(SHM_MODELS)),
                         device=torch.device(device))
    server = HttpInferenceServer(engine, port=0).start()
    grpc_server = GrpcInferenceServer(engine, port=0).start()
    channel, stub = _grpc_channel(grpc_server.url)
    print(f"shm: {engine.repository.names()} up in "
          f"{time.monotonic() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(10)
    try:
        status, md = _get(server.port, "/v2")
        _check({"system_shared_memory", "cuda_shared_memory",
                "tpu_shared_memory"} <= set(md["extensions"]),
               f"server metadata: {md}")
        fa.launches = 0
        seq = engine.repository.get("bert_long").config.input[0].dims[0]
        requests = _shm_requests(rng, seq)
        rooms = {model: _out_rooms(engine.repository.get(model).config,
                                   len(next(iter(inputs.values()))))
                 for model, inputs in requests.items()}
        t0 = time.monotonic()
        inline = {}
        for model, inputs in requests.items():
            status, got = _http_infer(server.port, model, inputs, True)
            _check(status == 200, f"inline {model}: {got}")
            code, via_grpc = _grpc_infer(stub, model, inputs)
            _check(all(_same_tensor(via_grpc[n], got[n]) for n in got),
                   f"inline {model}: gRPC and HTTP differ")
            inline[model] = got
        want = _simple_expected("simple", requests["simple"])
        _check(all(_same_tensor(inline["simple"][n], want[n]) for n in want),
               "simple: inline answer against numpy")
        sent = _planes_checks(server.port, stub, requests, rooms, inline,
                              f"chip_smoke_{os.getpid()}")
        print(f"shm: system, cuda and tpu planes over HTTP and gRPC: {sent} "
              "requests with inputs and outputs in regions, each bit for "
              "bit against the inline answer; status, unregister-one and "
              "-all, and the 400s / INVALID_ARGUMENTs, in "
              f"{time.monotonic() - t0:.1f} s", flush=True)
        _utils_checks(server.port, stub)
        region = _device_region_checks(torch, engine, rng)
        if engine.device.type == "cuda":
            _side_stream_check(torch, engine, rng)
        _shm_observation(torch, engine, server.port, stub, smi, rng)
        launches = fa.launches
        if engine.device.type == "cuda":
            _check(launches > region["launches"] > 0,
                   f"K1 in the shm phase: {launches} launches, "
                   f"{region['launches']} in process")
        print(f"shm: phase passed in {time.monotonic() - t_phase:.1f} s; "
              f"K1 launches {launches}", flush=True)
        return {"launches": launches}
    finally:
        channel.close()
        grpc_server.stop()
        server.stop()
        engine.shutdown()


# -- clients phase -------------------------------------------------------------

CLIENT_MODELS = ("simple", "bert_base", "bert_long", "tiny_gpt_long")
CLIENT_PROMPTS = (3, 17, 60, 130, 300, 700, 1100, 1500)
CLIENT_TOKENS = 32
CLIENT_DLRM = 16  # one-row requests, every other one with inputs in shm
CLIENT_OBSERVED, CLIENT_CONCURRENCY = 64, 16  # bert_base, the observation
CHILD_TIMEOUT_S = 900
# The client process may load none of these.
CHILD_FORBIDDEN = ("jax", "jaxlib", "client_tpu", "torch")
BERT_OUTPUTS = ("pooled_output", "logits")


def _client_inputs(seq: int) -> dict[str, np.ndarray]:
    """Every request of the clients phase, from fixed seeds: 8 one-row
    ``bert_long`` requests of ``seq`` tokens, the stream prompts, the
    one-row ``dlrm_mlperf`` requests and a ``bert_base`` request."""
    rng = np.random.default_rng(11)
    arrays = {}
    for i in range(8):
        arrays[f"ids{i}"] = rng.integers(0, 30522, (1, seq)).astype(np.int32)
        mask = np.ones((1, seq), np.int32)
        mask[0, rng.integers(seq // 4, seq + 1):] = 0
        arrays[f"mask{i}"] = mask
    for i, n in enumerate(CLIENT_PROMPTS):
        arrays[f"prompt{i}"] = rng.integers(0, 512, n).astype(np.int32)
    dlrm_rng = np.random.default_rng(36)
    for i in range(CLIENT_DLRM):
        for k, v in _mlperf_csr(dlrm_rng).items():
            arrays[f"dlrm{i}_{k}"] = v
    arrays["base_ids"] = rng.integers(0, 30522, (1, 128)).astype(np.int32)
    arrays["base_mask"] = np.ones((1, 128), np.int32)
    return arrays


def clients_child(argv: list[str]) -> int:
    """The clients phase's other process (``--clients-child WORKDIR
    HTTP_URL GRPC_URL``): drives the servers through the port's own
    clients, ``client_tpu_torch.http`` and ``client_tpu_torch.grpc``, with
    system shm from ``client_tpu_torch.utils.shared_memory``, and writes
    every answer to WORKDIR. It loads neither torch nor jax nor the JAX
    package, and says which modules it loaded."""
    workdir, http_url, grpc_url = argv
    import client_tpu_torch.grpc as grpcclient
    import client_tpu_torch.http as httpclient
    import client_tpu_torch.utils.shared_memory as shm
    from client_tpu_torch.utils import InferenceServerException

    data = dict(np.load(os.path.join(workdir, "inputs.npz")))
    models = json.loads(Path(workdir, "models.json").read_text())
    out: dict[str, np.ndarray] = {}
    summary: dict = {}
    hc = httpclient.InferenceServerClient(
        http_url, concurrency=8, connection_timeout=CHILD_TIMEOUT_S,
        network_timeout=CHILD_TIMEOUT_S)
    gc = grpcclient.InferenceServerClient(grpc_url)

    def bert(mod, i):
        """A BERT request's inputs: ``bert_long``'s ``i``-th, or, for
        ``i == "base"``, the ``bert_base`` one."""
        ids = data["base_ids" if i == "base" else f"ids{i}"]
        mask = data["base_mask" if i == "base" else f"mask{i}"]
        inputs = [mod.InferInput("input_ids", list(ids.shape), "INT32"),
                  mod.InferInput("attention_mask", list(mask.shape),
                                 "INT32")]
        inputs[0].set_data_from_numpy(ids)
        inputs[1].set_data_from_numpy(mask)
        return inputs

    try:
        # Health, metadata and config of every model over both clients.
        summary["health"] = [hc.is_server_live(), hc.is_server_ready(),
                             gc.is_server_live(), gc.is_server_ready()]
        summary["models"] = {}
        for m in models:
            hmd, gmd = hc.get_model_metadata(m), gc.get_model_metadata(m)
            summary["models"][m] = [
                hc.is_model_ready(m), gc.is_model_ready(m), hmd["name"],
                hc.get_model_config(m)["name"], gmd.name,
                gc.get_model_config(m).config.name,
                [t["name"] for t in hmd["inputs"]],
                [t.name for t in gmd.inputs]]

        # bert_long: 4 one at a time over HTTP, 8 at once, 4 over gRPC.
        t0 = time.monotonic()
        for i in range(4):
            r = hc.infer("bert_long", bert(httpclient, i))
            for n in BERT_OUTPUTS:
                out[f"http_one{i}_{n}"] = r.as_numpy(n)
        handles = [hc.async_infer("bert_long", bert(httpclient, i))
                   for i in range(8)]
        for i, h in enumerate(handles):
            r = h.get_result(timeout=CHILD_TIMEOUT_S)
            for n in BERT_OUTPUTS:
                out[f"http_many{i}_{n}"] = r.as_numpy(n)
        for i in range(4):
            r = gc.infer("bert_long", bert(grpcclient, i),
                         client_timeout=CHILD_TIMEOUT_S)
            for n in BERT_OUTPUTS:
                out[f"grpc_one{i}_{n}"] = r.as_numpy(n)
        summary["bert_long_s"] = time.monotonic() - t0

        # tiny_gpt_long: 8 greedy streams multiplexed on one gRPC stream.
        got: dict[str, list] = {}
        finals, errors = set(), []
        cond = threading.Condition()

        def on_message(result, error):
            with cond:
                if error is not None:
                    errors.append(str(error))
                else:
                    resp = result.get_response()
                    p = resp.parameters
                    if resp.outputs:
                        tokens, index = got.setdefault(resp.id, ([], []))
                        tokens += result.as_numpy("TOKEN").tolist()
                        index += result.as_numpy("INDEX").tolist()
                    if ("triton_final_response" in p
                            and p["triton_final_response"].bool_param):
                        finals.add(resp.id)
                cond.notify_all()

        t0 = time.monotonic()
        gc.start_stream(on_message)
        for i in range(len(CLIENT_PROMPTS)):
            prompt = data[f"prompt{i}"]
            inp = grpcclient.InferInput("INPUT_IDS", [len(prompt)], "INT32")
            inp.set_data_from_numpy(prompt)
            gc.async_stream_infer("tiny_gpt_long", [inp], request_id=f"s{i}",
                                  parameters={"max_tokens": CLIENT_TOKENS})
        with cond:
            done = cond.wait_for(
                lambda: errors or len(finals) == len(CLIENT_PROMPTS),
                timeout=CHILD_TIMEOUT_S)
        gc.stop_stream()
        if errors or not done:
            raise RuntimeError(f"streams: errors {errors}, finals {finals}")
        for i in range(len(CLIENT_PROMPTS)):
            tokens, index = got[f"s{i}"]
            if index != list(range(len(tokens))):
                raise RuntimeError(f"stream s{i}: INDEX {index}")
            out[f"stream{i}"] = np.asarray(tokens, np.int64)
        summary["streams_s"] = time.monotonic() - t0

        # dlrm_mlperf: one-row requests, every other one from system shm.
        order = ("DENSE", "INDICES", "OFFSETS")
        wire = {"DENSE": "FP32", "INDICES": "INT32", "OFFSETS": "INT32"}
        size = max(sum(data[f"dlrm{i}_{k}"].nbytes for k in order)
                   for i in range(CLIENT_DLRM))
        region, key = "clients_dlrm", f"/chip_smoke_clients_{os.getpid()}"
        handle = shm.create_shared_memory_region(region, key, size)
        try:
            hc.register_system_shared_memory(region, key, size)
            summary["shm_status"] = hc.get_system_shared_memory_status(
                region)
            for i in range(CLIENT_DLRM):
                arrs = {k: data[f"dlrm{i}_{k}"] for k in order}
                inputs, offset = [], 0
                if i % 2:
                    shm.set_shared_memory_region(
                        handle, [arrs[k] for k in order])
                for k in order:
                    inp = httpclient.InferInput(k, list(arrs[k].shape),
                                                wire[k])
                    if i % 2:
                        inp.set_shared_memory(region, arrs[k].nbytes,
                                              offset=offset)
                        offset += arrs[k].nbytes
                    else:
                        inp.set_data_from_numpy(arrs[k])
                    inputs.append(inp)
                r = hc.infer(DLRM_MODEL, inputs)
                out[f"dlrm{i}"] = r.as_numpy("OUTPUT0")
            hc.unregister_system_shared_memory(region)
        finally:
            shm.destroy_shared_memory_region(handle)

        # A model version that is not a positive integer, on both frontends.
        simple = {"INPUT0": np.arange(16, dtype=np.int32).reshape(1, 16),
                  "INPUT1": np.ones((1, 16), np.int32)}

        def simple_inputs(mod):
            inputs = [mod.InferInput(k, [1, 16], "INT32") for k in simple]
            for inp, v in zip(inputs, simple.values()):
                inp.set_data_from_numpy(v)
            return inputs

        summary["versions"] = []
        for call in (lambda: hc.get_model_metadata("simple", "abc"),
                     lambda: gc.get_model_metadata("simple", "abc"),
                     lambda: hc.infer("simple", simple_inputs(httpclient),
                                      model_version="0"),
                     lambda: gc.infer("simple", simple_inputs(grpcclient),
                                      model_version="0")):
            try:
                call()
                summary["versions"].append(None)
            except InferenceServerException as exc:
                summary["versions"].append([str(exc.status()),
                                            exc.message()])
        summary["version_01"] = [hc.is_model_ready("simple", "01"),
                                 gc.is_model_ready("simple", "01")]

        # The observation: bert_base at concurrency 16 over HTTP.
        oc = httpclient.InferenceServerClient(
            http_url, concurrency=CLIENT_CONCURRENCY,
            network_timeout=CHILD_TIMEOUT_S)
        try:
            def one(_):
                t = time.monotonic()
                oc.infer("bert_base", bert(httpclient, "base"))
                return time.monotonic() - t

            with concurrent.futures.ThreadPoolExecutor(
                    CLIENT_CONCURRENCY) as pool:
                list(pool.map(one, range(CLIENT_CONCURRENCY)))  # warm-up
                before = hc.get_inference_statistics("bert_base")[
                    "model_stats"][0]
                stat0 = oc.get_infer_stat()
                t0 = time.monotonic()
                lat = list(pool.map(one, range(CLIENT_OBSERVED)))
                wall = time.monotonic() - t0
            after = hc.get_inference_statistics("bert_base")["model_stats"][0]
            stat1 = oc.get_infer_stat()
            n = (stat1["completed_request_count"]
                 - stat0["completed_request_count"])
            summary["observation"] = {
                "model": "bert_base", "requests": CLIENT_OBSERVED,
                "concurrency": CLIENT_CONCURRENCY,
                "requests_per_s": CLIENT_OBSERVED / wall,
                "p50_ms": 1e3 * float(np.percentile(lat, 50)),
                "p99_ms": 1e3 * float(np.percentile(lat, 99)),
                "client_round_trip_ms": (
                    stat1["cumulative_total_request_time_us"]
                    - stat0["cumulative_total_request_time_us"]) / n / 1e3,
                "client_requests": n,
                "client_server_timed": (stat1["reported_request_count"]
                                        - stat0["reported_request_count"]),
                "server_ms": _stats_split(before, after),
                "server_executions": (after["execution_count"]
                                      - before["execution_count"])}
        finally:
            oc.close()
    finally:
        gc.close()
        hc.close()
    summary["modules"] = sorted(m for m in sys.modules
                                if m.split(".")[0] in CHILD_FORBIDDEN)
    np.savez(os.path.join(workdir, "outputs.npz"), **out)
    Path(workdir, "summary.json").write_text(json.dumps(summary))
    print(f"{len(out)} answers, modules of torch / jax / client_tpu "
          f"loaded: {summary['modules']}", flush=True)
    return 0


def clients_phase(torch, smi: str, device: str = "cuda") -> dict:
    """The port's own clients in another process against the port's
    servers: one engine with ``bert_base``, ``bert_long``,
    ``tiny_gpt_long``, ``dlrm_mlperf`` (2 shards on the card, K3) and
    ``simple`` behind HTTP and gRPC, launch counts set to 0 just before the
    child starts and read just after it exits. Every answer is held against
    the same request through the script's own wire code or the plain path.
    ``device`` is for a dry run of the phase's logic on the CPU."""
    import tempfile

    from client_tpu_torch.engine import TorchEngine
    from client_tpu_torch.models import build_repository
    from client_tpu_torch.models.dlrm import DlrmBackend
    from client_tpu_torch.models.generate import TinyGptBackend
    from client_tpu_torch.ops import decode_attention as da
    from client_tpu_torch.ops import flash_attention as fa
    from client_tpu_torch.parallel import kv_shard as ks
    from client_tpu_torch.server import (
        GrpcInferenceServer,
        HttpInferenceServer,
    )

    t_phase = time.monotonic()
    device = torch.device(device)
    repo = build_repository(list(CLIENT_MODELS))
    repo.register(DLRM_MODEL, lambda dev: DlrmBackend(
        name=DLRM_MODEL, device=dev, emb_devices=[dev] * 2, **MLPERF_DLRM))
    engine = TorchEngine(repo, device=device)
    server = HttpInferenceServer(engine, port=0).start()
    grpc_server = GrpcInferenceServer(engine, port=0).start()
    names = engine.repository.names()
    print(f"clients: {names} up in {time.monotonic() - t_phase:.1f} s on "
          f"{device}", flush=True)
    root = Path(__file__).resolve().parent
    (root / "build").mkdir(exist_ok=True)
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_clients_",
                                    dir=root / "build"))
    channel, stub = _grpc_channel(grpc_server.url)

    def executions(name):
        return engine.model_statistics(name)["model_stats"][0][
            "execution_count"]

    try:
        seq = engine.repository.get("bert_long").config.input[0].dims[0]
        arrays = _client_inputs(seq)
        np.savez(workdir / "inputs.npz", **arrays)
        (workdir / "models.json").write_text(json.dumps(names))

        # Counted: what the child's requests launch, and nothing else.
        e_long, e_dlrm = executions("bert_long"), executions(DLRM_MODEL)
        fa.launches = fa.launches_fp32 = da.launches = ks.launches = 0
        t0 = time.monotonic()
        proc = subprocess.run(
            [sys.executable, str(root / "chip_smoke.py"), "--clients-child",
             str(workdir), server.url, grpc_server.url], cwd=root,
            capture_output=True, text=True, timeout=CHILD_TIMEOUT_S)
        child_s = time.monotonic() - t0
        launches = {"flash_attention": fa.launches,
                    "flash_attention_fp32": fa.launches_fp32,
                    "decode_wave_attention": da.launches,
                    "ring_all_reduce": ks.launches}
        long_execs = executions("bert_long") - e_long
        dlrm_execs = executions(DLRM_MODEL) - e_dlrm
        for line in proc.stdout.splitlines():
            print(f"clients: child: {line}", flush=True)
        _check(proc.returncode == 0, f"the client process exited "
               f"{proc.returncode}: {proc.stderr[-4000:]}")
        out = dict(np.load(workdir / "outputs.npz"))
        summary = json.loads((workdir / "summary.json").read_text())
        _check(summary["modules"] == [], "the client process loaded "
               f"{summary['modules']}")
        print(f"clients: the child ran {child_s:.1f} s with the port's "
              "clients alone (no torch, jax or client_tpu module loaded); "
              f"launches {launches}; bert_long {long_execs} executions, "
              f"{DLRM_MODEL} {dlrm_execs}", flush=True)

        # Health, metadata and config of every model, over both.
        _check(summary["health"] == [True] * 4, f"health {summary['health']}")
        for m in names:
            got = summary["models"][m]
            want_inputs = [t.name for t in engine.repository.get(m)
                           .config.input]
            _check(got == [True, True, m, m, m, m, want_inputs, want_inputs],
                   f"{m}: metadata / config over the clients: {got}")

        # bert_long one at a time: bit for bit against the script's own
        # wire code at the same bucket (one row alone).
        hand = []
        for i in range(8):
            ids, mask = arrays[f"ids{i}"], arrays[f"mask{i}"]
            body, headers = _binary_request(ids, mask)
            status, rheaders, data = _post(
                server.port, "/v2/models/bert_long/infer", body, headers)
            _check(status == 200, f"bert_long: HTTP {status}")
            hand.append(_parse_response(rheaders, data))
            if i < 4:
                via_grpc = _grpc_outputs(stub.ModelInfer(_grpc_request(
                    "bert_long", {"input_ids": ids, "attention_mask": mask}),
                    timeout=GRPC_TIMEOUT_S))
                for n in BERT_OUTPUTS:
                    _check(out[f"http_one{i}_{n}"].tobytes()
                           == hand[i][n].tobytes(),
                           f"bert_long {i} {n}: HTTP client differs from "
                           "the hand-built request")
                    _check(out[f"grpc_one{i}_{n}"].tobytes()
                           == via_grpc[n].tobytes(),
                           f"bert_long {i} {n}: gRPC client differs from "
                           "the hand-built request")
        errs = [float(np.abs(out[f"http_many{i}_{n}"] - hand[i][n]).max())
                for i in range(8) for n in BERT_OUTPUTS]
        exact = sum(out[f"http_many{i}_{n}"].tobytes() == hand[i][n].tobytes()
                    for i in range(8) for n in BERT_OUTPUTS)
        _check(max(errs) <= KERNEL_ATOL, f"bert_long at once: max error "
               f"{max(errs)} against one at a time (tolerance {KERNEL_ATOL})")
        print(f"clients: bert_long: 4 one at a time over each client bit for "
              f"bit against the hand-built requests; 8 at once "
              f"(async_infer) within {max(errs):.3g} of one at a time "
              f"(tolerance {KERNEL_ATOL}), {exact}/16 outputs exact",
              flush=True)

        # Streams: token for token against the plain path run directly.
        served = engine.repository.get("tiny_gpt_long").backend
        oracle = TinyGptBackend(
            name="tiny_gpt_long", max_seq_len=served.max_seq_len,
            max_streams=served.max_streams, attention_impl="einsum",
            attn_impl="reference", device=device)
        arena = oracle.init_arena(1)
        for i in range(len(CLIENT_PROMPTS)):
            want = _direct_stream(torch, oracle, arena,
                                  arrays[f"prompt{i}"].tolist(),
                                  CLIENT_TOKENS, {}, device=device.type)
            _check(out[f"stream{i}"].tolist() == want,
                   f"stream {i} (prompt of {CLIENT_PROMPTS[i]}): "
                   f"{out[f'stream{i}'].tolist()} != direct {want}")
        del oracle, arena
        print(f"clients: {len(CLIENT_PROMPTS)} greedy tiny_gpt_long streams "
              f"of {CLIENT_TOKENS} tokens (prompts {CLIENT_PROMPTS}) on one "
              "gRPC stream equal the plain path, token for token", flush=True)

        # dlrm_mlperf: bit for bit against the hand-built request.
        for i in range(CLIENT_DLRM):
            arrs = {k: arrays[f"dlrm{i}_{k}"]
                    for k in ("DENSE", "INDICES", "OFFSETS")}
            status, want = _http_infer(server.port, DLRM_MODEL, arrs, True)
            _check(status == 200, f"{DLRM_MODEL}: HTTP {status}: {want}")
            _check(out[f"dlrm{i}"].tobytes() == want["OUTPUT0"].tobytes(),
                   f"{DLRM_MODEL} request {i} ({'shm' if i % 2 else 'inline'}"
                   f"): {out[f'dlrm{i}']} != {want['OUTPUT0']}")
        _check(list(summary["shm_status"]) == ["clients_dlrm"],
               f"shm status {summary['shm_status']}")
        print(f"clients: {DLRM_MODEL}: {CLIENT_DLRM} one-row requests, half "
              "with inputs in system shm, bit for bit against the hand-built "
              "request", flush=True)

        words = "invalid model version '{}'"
        want = [["400", words.format("abc")],
                ["StatusCode.INVALID_ARGUMENT", words.format("abc")],
                ["400", words.format("0")],
                ["StatusCode.INVALID_ARGUMENT", words.format("0")]]
        _check(summary["versions"] == want, f"bad versions: "
               f"{summary['versions']}")
        _check(summary["version_01"] == [True, True],
               f"version '01': {summary['version_01']}")
        print("clients: a bad model version answers 400 / INVALID_ARGUMENT "
              "with the reference's words on both frontends; '01' serves "
              "version 1", flush=True)

        if device.type == "cuda":
            n_layers = len(engine.repository.get("bert_long").backend.layers)
            _check(launches["flash_attention"] == n_layers * long_execs > 0,
                   f"K1 bf16: {launches['flash_attention']} launches for "
                   f"{long_execs} bert_long batches")
            _check(launches["ring_all_reduce"] == dlrm_execs > 0,
                   f"K3: {launches['ring_all_reduce']} launches for "
                   f"{dlrm_execs} {DLRM_MODEL} executions")
            _check(launches["flash_attention_fp32"] > 0
                   and launches["flash_attention_fp32"] % 4 == 0,
                   f"K1 fp32 launches {launches['flash_attention_fp32']}")
            _check(launches["decode_wave_attention"]
                   >= 4 * (CLIENT_TOKENS - 1)
                   and launches["decode_wave_attention"] % 4 == 0,
                   f"K2 launches {launches['decode_wave_attention']}")
        observation = {**summary["observation"], "card": smi}
        print(f"clients observation: {json.dumps(observation)}", flush=True)
        print(f"clients: phase passed in {time.monotonic() - t_phase:.1f} s; "
              f"launches {launches}", flush=True)
        return launches
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
        channel.close()
        grpc_server.stop()
        server.stop()
        engine.shutdown()


# -- repository phase ----------------------------------------------------------

REPO_STREAMS = 4      # tiny_gpt_long streams open when it unloads
REPO_STREAM_WAIT_S = 10.0  # each must end with an error within this
REPO_CYCLES = 5       # bert_long unload/load cycles of the leak check
REPO_FREED = 0.9      # share of bert_long's bytes an unload must free
REPO_LEAK = 0.01      # memory growth allowed over the cycles
REPO_TOKENS = 16      # tokens of each stream after the reload


def _write_config(root: Path, name: str, cfg: dict,
                  versions: tuple = ()) -> None:
    mdir = root / name
    mdir.mkdir(exist_ok=True)
    (mdir / "config.json").write_text(json.dumps(cfg))
    for v in versions:
        (mdir / str(v)).mkdir(exist_ok=True)


def _repository_dir(root: Path, torch) -> None:
    """The phase's directory repository: ``config.json`` files from the
    zoo's own configs (``bert_long`` with ``version_policy: all`` and
    versions 1 and 2), a second ensemble sharing ``ensemble_bert``'s first
    two steps, and a copy of the repo's ``models/``."""
    from client_tpu_torch.models import _REGISTRY, _import_all
    from client_tpu_torch.models.dlrm import DlrmBackend

    _import_all()
    cpu = torch.device("cpu")
    for name in ("tiny_gpt_long", "dlrm_cached", "bert_preprocess",
                 "bert_base", "bert_postprocess", "ensemble_bert"):
        _write_config(root, name,
                      _REGISTRY[name](cpu).config.config_dict())
    cfg = _REGISTRY["bert_long"](cpu).config.config_dict()
    _write_config(root, "bert_long", {**cfg, "version_policy": {"all": {}}},
                  versions=(1, 2))
    # Only the config of the MLPerf DLRM: a one-row table builds it.
    small = DlrmBackend(name=DLRM_MODEL, device=cpu, **{
        **MLPERF_DLRM, "table_rows": 1, "emb_shards": 0})
    _write_config(root, DLRM_MODEL, small.config.config_dict())
    ens = _REGISTRY["ensemble_bert"](cpu).config.config_dict()
    steps = ens["ensemble_scheduling"]["step"]
    _write_config(root, "ensemble_bert_logits", {
        **ens, "name": "ensemble_bert_logits",
        "output": [{"name": "LOGITS", "data_type": "TYPE_FP32",
                    "dims": [2]}],
        "ensemble_scheduling": {"step": [
            steps[0], {**steps[1], "output_map": {"logits": "LOGITS"}}]}})
    for entry in (Path(__file__).resolve().parent / "models").iterdir():
        shutil.copytree(entry, root / entry.name)


def _device_bytes(model) -> int:
    backend = model.backend
    return sum(t.numel() * t.element_size()
               for t in (*backend.parameters(), *backend.buffers()))


def _allocated(torch, device) -> int:
    """``torch.cuda.memory_allocated`` once nothing refers to the dropped
    tensors (0 on the CPU). It counts cuBLAS's workspaces, one for each
    (handle, stream) pair that has run, which no unload gives back: a
    reload that made new pairs would show here as growth."""
    import gc

    gc.collect()
    if device.type != "cuda":
        return 0
    torch.cuda.synchronize(device)
    return torch.cuda.memory_allocated(device)


def _repo_post(port: int, path: str, body: dict | None = None):
    status, _, data = _post(port, path,
                            json.dumps(body).encode() if body else b"")
    return status, (json.loads(data) if data else None)


def _open_stream(port: int, prompt: list, max_tokens: int,
                 first: threading.Event) -> dict:
    """A ``tiny_gpt_long`` /generate_stream read in this thread until it
    ends; ``first`` is set on its first token. Returns its tokens, the
    error event's words and the monotonic time it ended."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    out = {"tokens": [], "error": None, "end": None}
    try:
        conn.request("POST", "/v2/models/tiny_gpt_long/generate_stream",
                     json.dumps({"inputs": [{
                         "name": "INPUT_IDS", "datatype": "INT32",
                         "shape": [len(prompt)], "data": prompt}],
                         "parameters": {"max_tokens": max_tokens}}).encode())
        resp = conn.getresponse()
        _check(resp.status == 200, f"stream: HTTP {resp.status}")
        buf = b""
        while True:
            data = resp.read1(65536)
            if not data:
                break
            buf += data
            while b"\n\n" in buf:
                event, buf = buf.split(b"\n\n", 1)
                head = json.loads(event[len(b"data: "):])
                if "error" in head:
                    out["error"] = head["error"]
                    continue
                outs = {o["name"]: o["data"] for o in head["outputs"]}
                out["tokens"] += outs["TOKEN"]
                first.set()
    finally:
        out["end"] = time.monotonic()
        first.set()
        conn.close()
    return out


def _bert_long_checks(torch, engine, port: int, stub, device) -> dict:
    """Both versions over both frontends, bit for bit alike and within
    ``SERVED_ATOL`` of the plain path (a whole 12-layer forward against
    the module with plain attention, as the serve phase holds it); K1
    bf16's launches per batch."""
    from client_tpu_torch.ops import flash_attention as fa

    seq = engine.repository.get("bert_long").config.input[0].dims[0]
    rng = np.random.default_rng(12)
    feeds = []
    for _ in range(2):
        ids = rng.integers(0, 30522, (1, seq)).astype(np.int32)
        mask = np.ones((1, seq), np.int32)
        mask[0, rng.integers(seq // 4, seq + 1):] = 0
        feeds.append((ids, mask))

    def executions(version):
        return engine.model_statistics("bert_long", version)["model_stats"][
            0]["execution_count"]

    e0 = {v: executions(v) for v in ("1", "2")}
    k0 = fa.launches
    answers = {}
    for v in ("1", "2"):
        for i, (ids, mask) in enumerate(feeds):
            body, headers = _binary_request(ids, mask)
            status, rheaders, data = _post(
                port, f"/v2/models/bert_long/versions/{v}/infer", body,
                headers)
            _check(status == 200, f"bert_long v{v}: HTTP {status}: "
                   f"{data[:300]!r}")
            answers[("http", v, i)] = _parse_response(rheaders, data)
            req = _grpc_request("bert_long", {"input_ids": ids,
                                              "attention_mask": mask})
            req.model_version = v
            answers[("grpc", v, i)] = _grpc_outputs(
                stub.ModelInfer(req, timeout=GRPC_TIMEOUT_S))
    batches = sum(executions(v) - e0[v] for v in ("1", "2"))
    launches = fa.launches - k0
    n_layers = len(engine.repository.get("bert_long").backend.layers)
    if device.type == "cuda":
        _check(batches == 8 and launches == n_layers * batches,
               f"K1 bf16: {launches} launches for {batches} bert_long "
               f"batches of two versions ({n_layers} a batch)")
    names = [tc.name for tc in engine.repository.get("bert_long")
             .config.output]
    for (wire, v, i), out in answers.items():
        for n in names:
            _check(out[n].tobytes() == answers[("http", "1", i)][n]
                   .tobytes(), f"bert_long {wire} v{v} request {i} {n}: "
                   "not bit for bit the HTTP v1 answer")
    errs = []
    with torch.inference_mode():
        for i, (ids, mask) in enumerate(feeds):
            model = engine.repository.get("bert_long", "2")
            ref = model.backend.encode(
                {"input_ids": torch.from_numpy(ids).to(device),
                 "attention_mask": torch.from_numpy(mask).to(device)},
                fa.flash_attention_plain)
            errs += [float(np.abs(answers[("http", "2", i)][n]
                                  - ref[n].float().cpu().numpy()).max())
                     for n in names]
    _check(fa.launches - k0 == launches, "the plain path launched K1")
    # The serve phase's comparison and tolerance: a whole 12-layer forward
    # through K1 against the same module with plain attention.
    _check(max(errs) <= SERVED_ATOL, f"bert_long against the plain path: "
           f"{max(errs)} (tolerance {SERVED_ATOL})")
    print(f"repository: bert_long versions 1 and 2 over /versions/<v> and "
          f"gRPC model_version: 8 batches, K1 bf16 {launches} launches; "
          f"every answer bit for bit alike across versions and frontends, "
          f"within {max(errs):.3g} of the plain path (tolerance "
          f"{SERVED_ATOL})", flush=True)
    return {"feed": feeds[0], "answer": answers[("http", "1", 0)]}


def repository_phase(torch, smi: str, device: str = "cuda") -> dict:
    """Repository control on one engine behind HTTP and gRPC, serving a
    directory repository written for the phase: ``bert_long`` (versions 1
    and 2, K1 bf16), ``tiny_gpt_long`` (K1 fp32, K2), ``dlrm_mlperf`` (2
    shards, K3), ``dlrm_cached``, ``ensemble_bert`` with its steps, a
    second ensemble sharing two of them, and both SSDs of ``models/``,
    at their registered sizes. Models are unloaded, loaded and reloaded
    over both frontends while every kernel is counted; the card memory an
    unload gives back and the growth over ``REPO_CYCLES`` unload/load
    cycles are read with ``torch.cuda.memory_allocated``. ``device`` is
    for a dry run of the phase's logic on the CPU."""
    import tempfile

    import grpc

    from client_tpu_torch.engine import TorchEngine
    from client_tpu_torch.engine.repository import ModelRepository
    from client_tpu_torch.models import _REGISTRY, register_model
    from client_tpu_torch.models.dlrm import DlrmBackend
    from client_tpu_torch.models.generate import TinyGptBackend
    from client_tpu_torch.ops import decode_attention as da
    from client_tpu_torch.ops import flash_attention as fa
    from client_tpu_torch.parallel import kv_shard as ks
    from client_tpu_torch.protocol import grpc_service_pb2 as pb
    from client_tpu_torch.server import (
        GrpcInferenceServer,
        HttpInferenceServer,
    )

    t_phase = time.monotonic()
    device = torch.device(device)
    cuda = device.type == "cuda"
    register_model(DLRM_MODEL, default=False)(lambda dev: DlrmBackend(
        name=DLRM_MODEL, device=dev, emb_devices=[dev] * 2, **MLPERF_DLRM))
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_repository_"))
    engine = server = grpc_server = channel = None
    try:
        _repository_dir(root, torch)
        engine = TorchEngine(ModelRepository.from_directory(str(root)),
                             device=device)
        server = HttpInferenceServer(engine, port=0).start()
        grpc_server = GrpcInferenceServer(engine, port=0).start()
        channel, stub = _grpc_channel(grpc_server.url)
        index = engine.repository_index()
        _check(all(e["state"] == "READY" for e in index),
               f"a model of the directory did not load: {index}")
        print(f"repository: {len(index)} rows READY from {root} in "
              f"{time.monotonic() - t_phase:.1f} s on {device}: "
              f"{[(e['name'], e['version']) for e in index]}", flush=True)
        fa.launches = fa.launches_fp32 = da.launches = ks.launches = 0

        # bert_long: two versions, then an unload over HTTP.
        first = _bert_long_checks(torch, engine, server.port, stub, device)
        freed_bytes = sum(_device_bytes(m) for m in
                          engine.repository.loaded_versions(
                              "bert_long").values())
        before = _allocated(torch, device)
        status, _ = _repo_post(server.port,
                               "/v2/repository/models/bert_long/unload")
        _check(status == 200, f"unload bert_long: HTTP {status}")
        after = _allocated(torch, device)
        body, headers = _binary_request(*first["feed"])
        status, _, data = _post(server.port, "/v2/models/bert_long/infer",
                                body, headers)
        _check(status == 400 and json.loads(data)["error"]
               == "model 'bert_long' is not ready",
               f"bert_long unloaded: HTTP {status} {data[:200]!r}")
        if cuda:
            _check(before - after >= REPO_FREED * freed_bytes,
                   f"unloading bert_long freed {before - after} bytes of "
                   f"its {freed_bytes}")
        print(f"repository: bert_long unloaded over HTTP (then 400 'not "
              f"ready'): memory_allocated {before} -> {after} bytes, "
              f"{before - after} freed of its 2 versions' {freed_bytes} "
              f"parameter and buffer bytes (at least {REPO_FREED:.0%} "
              f"required); {smi}", flush=True)

        # Load over gRPC; then 3/ under latest-2: 2 and 3 serve, 1 retires.
        stub.RepositoryModelLoad(pb.RepositoryModelLoadRequest(
            model_name="bert_long"), timeout=GRPC_TIMEOUT_S)
        status, rheaders, data = _post(
            server.port, "/v2/models/bert_long/versions/1/infer", body,
            headers)
        _check(status == 200, f"bert_long reloaded: HTTP {status}")
        for n, got in _parse_response(rheaders, data).items():
            _check(got.tobytes() == first["answer"][n].tobytes(),
                   f"bert_long {n} after the reload differs")
        kept = engine.repository.get("bert_long", "2")
        (root / "bert_long" / "3").mkdir()
        cfg = json.loads((root / "bert_long" / "config.json").read_text())
        cfg["version_policy"] = {"latest": {"num_versions": 2}}
        (root / "bert_long" / "config.json").write_text(json.dumps(cfg))
        status, _ = _repo_post(server.port,
                               "/v2/repository/models/bert_long/load")
        _check(status == 200, f"load bert_long with 3/: HTTP {status}")
        versions = engine.model_metadata("bert_long")["versions"]
        _check(versions == ["2", "3"] and engine.repository.get(
            "bert_long", "2") is kept, f"after 3/: versions {versions}")
        status, _, data = _post(
            server.port, "/v2/models/bert_long/versions/1/infer", body,
            headers)
        _check(status == 404 and json.loads(data)["error"]
               == "model 'bert_long' has no version '1'",
               f"retired version 1: HTTP {status} {data[:200]!r}")
        for v in ("3", ""):
            path = f"/v2/models/bert_long{'/versions/' + v if v else ''}/infer"
            status, rheaders, data = _post(server.port, path, body, headers)
            _check(status == 200, f"bert_long {path}: HTTP {status}")
            for n, got in _parse_response(rheaders, data).items():
                _check(got.tobytes() == first["answer"][n].tobytes(),
                       f"bert_long v{v or 'latest'} {n} differs")
        del kept
        print("repository: bert_long loaded over gRPC serves v1 bit for bit "
              "as before; with 3/ and latest-2 a load serves 2 (kept, not "
              "rebuilt) and 3, and v1 answers 404 'has no version'",
              flush=True)

        # The leak check: unload/load cycles over both frontends.
        readings = []
        for cycle in range(REPO_CYCLES):
            if cycle % 2:
                stub.RepositoryModelUnload(pb.RepositoryModelUnloadRequest(
                    model_name="bert_long"), timeout=GRPC_TIMEOUT_S)
                stub.RepositoryModelLoad(pb.RepositoryModelLoadRequest(
                    model_name="bert_long"), timeout=GRPC_TIMEOUT_S)
            else:
                for op in ("unload", "load"):
                    status, _ = _repo_post(
                        server.port, f"/v2/repository/models/bert_long/{op}")
                    _check(status == 200, f"{op} bert_long: HTTP {status}")
            status, rheaders, data = _post(
                server.port, "/v2/models/bert_long/infer", body, headers)
            _check(status == 200, f"bert_long cycle {cycle}: HTTP {status}")
            readings.append(_allocated(torch, device))
        growth = (readings[-1] - readings[0]) / max(1, readings[0])
        if cuda:
            _check(abs(growth) <= REPO_LEAK,
                   f"memory over {REPO_CYCLES} unload/load cycles: "
                   f"{readings}")
        print(f"repository: {REPO_CYCLES} unload/load cycles of bert_long "
              f"(HTTP and gRPC, one request each): memory_allocated "
              f"{readings} bytes, {growth:+.4%} from the first to the last "
              f"(at most {REPO_LEAK:.0%}); {smi}", flush=True)

        _gpt_checks(torch, engine, server.port, grpc_server.url, device,
                    TinyGptBackend)
        _repo_dlrm_checks(torch, engine, server.port, stub)

        # Ensembles: ensemble_bert's own step goes, the shared ones stay.
        text = np.array([[b"a chip check"]], dtype=np.object_)
        want = _http_infer(server.port, "ensemble_bert_logits",
                           {"TEXT": text}, True)
        _check(want[0] == 200, f"ensemble_bert_logits: {want}")
        status, _ = _repo_post(
            server.port, "/v2/repository/models/ensemble_bert/unload",
            {"parameters": {"unload_dependents": True}})
        _check(status == 200, f"unload ensemble_bert: HTTP {status}")
        states = {e["name"]: e["state"] for e in engine.repository_index()}
        _check([states[m] for m in (
            "ensemble_bert", "bert_postprocess", "bert_preprocess",
            "bert_base", "ensemble_bert_logits")] == [
            "UNAVAILABLE", "UNAVAILABLE", "READY", "READY", "READY"],
            f"after unload_dependents: {states}")
        got = _http_infer(server.port, "ensemble_bert_logits",
                          {"TEXT": text}, True)
        _check(got[0] == 200 and got[1]["LOGITS"].tobytes()
               == want[1]["LOGITS"].tobytes(),
               f"ensemble_bert_logits after the unload: {got}")
        print("repository: ensemble_bert unloaded with unload_dependents "
              "took bert_postprocess and left bert_preprocess and bert_base,"
              " which ensemble_bert_logits still names (it serves bit for "
              "bit as before)", flush=True)

        # The directory's SSDs, and the index on both frontends.
        img = np.random.default_rng(9).integers(
            0, 255, (1, 300, 300, 3)).astype(np.uint8)
        for name in SSD_MODELS:
            status, out = _http_infer(
                server.port, name, {"normalized_input_image_tensor": img},
                True)
            _check(status == 200 and out["TFLite_Detection_PostProcess"]
                   .shape == (1, 1, 10, 4), f"{name}: {status} {out}")
        index = engine.repository_index()
        status, over_http = _repo_post(server.port, "/v2/repository/index")
        over_grpc = [{k: v for k, v in (
            ("name", m.name), ("version", m.version), ("state", m.state),
            ("reason", m.reason)) if v} for m in stub.RepositoryIndex(
                pb.RepositoryIndexRequest(), timeout=GRPC_TIMEOUT_S).models]
        _check(status == 200 and over_http == index == over_grpc,
               f"index: engine {index}, HTTP {over_http}, gRPC {over_grpc}")
        try:
            stub.RepositoryModelLoad(pb.RepositoryModelLoadRequest(
                model_name="no_such_model"), timeout=GRPC_TIMEOUT_S)
            code = None
        except grpc.RpcError as exc:
            code = exc.code()
        _check(code == grpc.StatusCode.NOT_FOUND, f"unknown load: {code}")
        print(f"repository: both SSDs of models/ serve; the index ({len(index)}"
              " rows) is the engine's over HTTP and gRPC", flush=True)

        launches = {"flash_attention": fa.launches,
                    "flash_attention_fp32": fa.launches_fp32,
                    "decode_wave_attention": da.launches,
                    "ring_all_reduce": ks.launches}
        if cuda:
            _check(all(launches.values()),
                   f"a kernel did not run in the phase: {launches}")
        print(f"repository: phase passed in {time.monotonic() - t_phase:.1f}"
              f" s; launches {launches}; {smi}", flush=True)
        return launches
    finally:
        if channel is not None:
            channel.close()
        for srv in (grpc_server, server):
            if srv is not None:
                srv.stop()
        if engine is not None:
            engine.shutdown()
        _REGISTRY.pop(DLRM_MODEL, None)
        shutil.rmtree(root, ignore_errors=True)


def _gpt_checks(torch, engine, port: int, grpc_url: str, device,
                gpt_cls) -> None:
    """``tiny_gpt_long``: unloaded with ``REPO_STREAMS`` streams open (each
    ends with an error), then reloaded: greedy streams over HTTP and gRPC
    token for token against the plain path (K1 fp32, K2)."""
    from client_tpu_torch.ops import decode_attention as da
    from client_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(14)
    firsts = [threading.Event() for _ in range(REPO_STREAMS)]
    with concurrent.futures.ThreadPoolExecutor(REPO_STREAMS) as pool:
        futures = [pool.submit(_open_stream, port,
                               rng.integers(0, 512, 5).tolist(), 2000, f)
                   for f in firsts]
        for f in firsts:
            _check(f.wait(120), "a stream sent no first token")
        t0 = time.monotonic()
        status, _ = _repo_post(port,
                               "/v2/repository/models/tiny_gpt_long/unload")
        _check(status == 200, f"unload tiny_gpt_long: HTTP {status}")
        ended = [fut.result(timeout=120) for fut in futures]
    for out in ended:
        _check(out["error"] == "server shutting down"
               and out["end"] - t0 <= REPO_STREAM_WAIT_S
               and len(out["tokens"]) < 2000,
               f"an open stream at unload: {len(out['tokens'])} tokens, "
               f"error {out['error']!r}, ended {out['end'] - t0:.2f} s "
               "after the unload began")
    print(f"repository: tiny_gpt_long unloaded with {REPO_STREAMS} streams "
          f"open ({[len(o['tokens']) for o in ended]} tokens in): each "
          f"ended with 'server shutting down' within "
          f"{max(o['end'] for o in ended) - t0:.2f} s", flush=True)

    status, _ = _repo_post(port, "/v2/repository/models/tiny_gpt_long/load")
    _check(status == 200, f"load tiny_gpt_long: HTTP {status}")
    k1, k2 = fa.launches_fp32, da.launches
    prompts = [rng.integers(0, 512, n).tolist() for n in CLIENT_PROMPTS]
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        http_toks = list(pool.map(lambda p: _stream(
            port, "tiny_gpt_long", {"inputs": [{
                "name": "INPUT_IDS", "datatype": "INT32", "shape": [len(p)],
                "data": p}], "parameters": {"max_tokens": REPO_TOKENS}})[0],
            prompts[:4]))
    by_id = _grpc_streams(grpc_url, [
        (f"r{i}", "tiny_gpt_long", p, {"max_tokens": REPO_TOKENS})
        for i, p in enumerate(prompts[4:])])
    served = http_toks + [by_id[f"r{i}"][0] for i in range(4)]
    backend = engine.repository.get("tiny_gpt_long").backend
    oracle = gpt_cls(name="tiny_gpt_long", max_seq_len=backend.max_seq_len,
                     max_streams=backend.max_streams,
                     attention_impl="einsum", attn_impl="reference",
                     device=device)
    arena = oracle.init_arena(1)
    for prompt, toks in zip(prompts, served):
        want = _direct_stream(torch, oracle, arena, prompt, REPO_TOKENS, {},
                              device=device.type)
        _check(toks == want, f"reloaded tiny_gpt_long, prompt of "
               f"{len(prompt)}: {toks} != direct {want}")
    del oracle, arena
    n_layers = backend.n_layers
    if device.type == "cuda":
        _check(fa.launches_fp32 - k1 >= n_layers
               and (fa.launches_fp32 - k1) % n_layers == 0
               and da.launches - k2 >= n_layers * (REPO_TOKENS - 1)
               and (da.launches - k2) % n_layers == 0,
               f"reloaded tiny_gpt_long: K1 fp32 {fa.launches_fp32 - k1}, "
               f"K2 {da.launches - k2} launches")
    print(f"repository: tiny_gpt_long reloaded: 8 greedy streams of "
          f"{REPO_TOKENS} tokens (prompts {CLIENT_PROMPTS}; 4 over SSE, 4 on"
          f" one gRPC stream) equal the plain path token for token; K1 fp32 "
          f"{fa.launches_fp32 - k1}, K2 {da.launches - k2} launches",
          flush=True)


def _repo_dlrm_checks(torch, engine, port: int, stub) -> None:
    """``dlrm_mlperf`` reloaded answers bit for bit as before, K3 once an
    execution, and its sharded bag sums (K3) equal the unsharded table's
    bit for bit; a reload of ``dlrm_cached`` empties its row cache."""
    from client_tpu_torch.parallel import emb_shard as es
    from client_tpu_torch.parallel import kv_shard as ks
    from client_tpu_torch.protocol import grpc_service_pb2 as pb

    def executions():
        return engine.model_statistics(DLRM_MODEL)["model_stats"][0][
            "execution_count"]

    rng = np.random.default_rng(27)
    reqs = [_mlperf_csr(rng, rows=1 + i % 3) for i in range(6)]
    k0, e0 = ks.launches, executions()
    before = []
    for r in reqs:
        status, out = _http_infer(port, DLRM_MODEL, r, True)
        _check(status == 200, f"{DLRM_MODEL}: {status} {out}")
        before.append(out["OUTPUT0"])
    stub.RepositoryModelUnload(pb.RepositoryModelUnloadRequest(
        model_name=DLRM_MODEL), timeout=GRPC_TIMEOUT_S)
    status, _ = _repo_post(port, f"/v2/repository/models/{DLRM_MODEL}/load")
    _check(status == 200, f"load {DLRM_MODEL}: HTTP {status}")
    e1 = executions()
    for r, want in zip(reqs, before):
        code, out = _grpc_infer(stub, DLRM_MODEL, r)
        _check(out["OUTPUT0"].tobytes() == want.tobytes(),
               f"{DLRM_MODEL} after the reload: {out['OUTPUT0']} != {want}")
    execs = (e1 - e0) + (executions() - e1)
    if engine.device.type == "cuda":
        _check(ks.launches - k0 == execs == 2 * len(reqs),
               f"K3: {ks.launches - k0} launches for {execs} executions")
    launches = ks.launches - k0

    # The reloaded model against its plain version: sharded bag sums of a
    # full batch against the unsharded table's (this launch is not the
    # phase's).
    backend = engine.repository.get(DLRM_MODEL).backend
    device = engine.device
    batch = _mlperf_csr(np.random.default_rng(28), rows=32)
    staged = {k: torch.from_numpy(v).to(device) for k, v in
              backend.pre_stage(batch, MLPERF_DLRM["max_lookups"]).items()}
    num_seg = MLPERF_DLRM["max_batch_size"] * MLPERF_DLRM["num_tables"]
    with torch.inference_mode():
        sharded = backend.pooled(staged)
        whole = torch.from_numpy(backend.table_host).to(device)
        oracle = es.bag_sum_oracle(whole, staged["INDICES"],
                                   staged["SEG_IDS"], num_seg)
    ks.launches = k0 + launches
    _check(bool(torch.equal(sharded, oracle)),
           f"{DLRM_MODEL} after the reload: sharded bag sums differ from "
           f"the unsharded ones by {float((sharded - oracle).abs().max())}")
    del backend, staged, sharded, whole, oracle
    print(f"repository: {DLRM_MODEL} unloaded over gRPC, loaded over HTTP: "
          f"{len(reqs)} requests bit for bit as before the reload; K3 "
          f"{launches} launches for {execs} executions; pooled over 2 "
          "shards (ring) bit for bit the unsharded table's", flush=True)

    r = _small_csr(np.random.default_rng(8), rows=2)
    cache = engine.repository.get("dlrm_cached").backend.row_cache
    for _ in range(2):
        status, want = _http_infer(port, "dlrm_cached", r, True)
    hits = cache.hits
    status, again = _http_infer(port, "dlrm_cached", r, True)
    _check(cache.hits - hits == int(r["INDICES"].shape[0]) > 0,
           f"dlrm_cached: {cache.hits - hits} hits of a resident request")
    status, _ = _repo_post(port, "/v2/repository/models/dlrm_cached/load")
    _check(status == 200 and cache.snapshot()["resident_rows"] == 0,
           f"dlrm_cached reload: {status} {cache.snapshot()}")
    hits = cache.hits
    status, after = _http_infer(port, "dlrm_cached", r, True)
    _check(cache.hits - hits == 0 and after["OUTPUT0"].tobytes()
           == want["OUTPUT0"].tobytes(),
           f"dlrm_cached after the reload: {cache.hits - hits} hits")
    print(f"repository: dlrm_cached reload emptied its row cache: the same "
          f"request hit {int(r['INDICES'].shape[0])} rows before and 0 "
          "after, the same score", flush=True)


# -- observability phase -------------------------------------------------------

OBS_LONG_HTTP = 4     # bert_long requests over HTTP with a traceparent
OBS_LONG_GRPC = 2     # and over gRPC (one as a parameter, one as metadata)
OBS_STREAMS = 16      # tiny_gpt_long streams: 8 over SSE, 8 on one RPC
OBS_TOKENS = 16
OBS_DLRM = 8          # one-row dlrm_mlperf requests over HTTP
OBS_FAULT_SEED = 5    # model.execute armed at probability 0.5 ...
OBS_FAULTED = 16      # ... over this many bert_long requests
# A phase duration from the span store against Server-Timing (or the
# gRPC server_*_us parameters) of the same request: both are formatted
# from the same stamps, ms to 3 decimals and us floored.
OBS_TIMING_MS = 1.0
# A bucket's counted FLOPs on the card against the same bucket counted
# on the CPU plain path (the kernel's formula against the plain version's
# counted matmuls).
OBS_FLOPS_RTOL = 0.01
OBS_SHARE_MAX = 1.05  # MFU and MBU must lie in (0, this]


def _scrape(port: int, openmetrics: bool = False) -> str:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("GET", "/metrics", headers={
            "Accept": "application/openmetrics-text; version=1.0.0"}
            if openmetrics else {})
        resp = conn.getresponse()
        body = resp.read().decode()
        _check(resp.status == 200, f"/metrics: HTTP {resp.status}")
        want = ("application/openmetrics-text" if openmetrics
                else "text/plain; version=0.0.4")
        _check(resp.getheader("Content-Type").startswith(want),
               f"/metrics content type {resp.getheader('Content-Type')}")
        _check(body.endswith("# EOF\n") == openmetrics,
               "/metrics: # EOF where it does not belong, or missing")
        return body
    finally:
        conn.close()


def _samples(text: str) -> dict[tuple, float]:
    """{(name, ((label, value), ...)): value} of an exposition, parsed by
    the script itself (an exemplar's ' # ' tail dropped)."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        line = line.split(" # ", 1)[0]
        m = re.match(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)$",
                     line)
        _check(m is not None, f"/metrics: unparsed line {line!r}")
        labels = tuple(sorted(re.findall(
            r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"',
            m.group(2) or "")))
        out[(m.group(1), labels)] = float(m.group(3))
    return out


def _sample_sum(samples: dict, name: str, **labels) -> float:
    want = set(labels.items())
    return sum(v for (n, lab), v in samples.items()
               if n == name and want <= set(lab))


def _trace_spans(port: int, trace_id: str) -> dict[str, float]:
    """{phase: duration ms} of one traced request, from
    ``/v2/trace/requests``."""
    status, data = _get(port, f"/v2/trace/requests?trace_id={trace_id}")
    _check(status == 200, f"/v2/trace/requests: HTTP {status}")
    spans = {e["name"]: e["dur"] / 1e3 for e in data["traceEvents"]
             if e["ph"] == "X"}
    _check(all(e["args"]["trace_id"] == trace_id
               for e in data["traceEvents"]),
           f"trace {trace_id}: another request's spans")
    _check({"queue", "compute_input", "compute_infer",
            "compute_output"} <= set(spans), f"trace {trace_id}: {spans}")
    return spans


def _check_timing(what: str, spans: dict, timing: dict) -> float:
    """The largest gap (ms) between the spans and the response's own
    phase timings; fails past ``OBS_TIMING_MS``."""
    worst = 0.0
    for phase in ("queue", "compute_input", "compute_infer",
                  "compute_output"):
        worst = max(worst, abs(spans[phase] - timing[phase]))
    _check(worst <= OBS_TIMING_MS, f"{what}: spans {spans} against the "
           f"response's timings {timing}")
    return worst


def _obs_bert_inputs(seq: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 30522, (1, seq)).astype(np.int32)
    mask = np.ones((1, seq), np.int32)
    mask[0, rng.integers(seq // 4, seq + 1):] = 0
    return ids, mask


def _obs_traffic(port: int, stub, grpc_url: str, seq: int) -> dict:
    """The phase's traced traffic: ``bert_long`` one request at a time
    over HTTP and gRPC with a ``traceparent``, ``tiny_gpt_long`` streams
    over SSE and one RPC, ``dlrm_mlperf`` one request at a time; each
    trace round trip and span set checked. Returns the timing gaps."""
    gaps = []
    for i in range(OBS_LONG_HTTP + OBS_LONG_GRPC):
        trace_id = f"{0xB0 + i:02x}" + "5e" * 15
        tp = f"00-{trace_id}-{i + 1:016x}-01"
        ids, mask = _obs_bert_inputs(seq, i)
        if i < OBS_LONG_HTTP:
            body, headers = _binary_request(ids, mask)
            status, rheaders, data = _post(
                port, "/v2/models/bert_long/infer", body,
                dict(headers, traceparent=tp))
            _check(status == 200, f"bert_long: HTTP {status}: {data[:200]}")
            echo = rheaders.get("traceparent", "")
            timing = {}
            for entry in rheaders["Server-Timing"].split(","):
                name, _, dur = entry.strip().partition(";dur=")
                timing[name] = float(dur)
        else:
            metadata = (("traceparent", tp),) if i % 2 else ()
            resp = stub.ModelInfer(_grpc_request(
                "bert_long", {"input_ids": ids, "attention_mask": mask},
                parameters=None if i % 2 else {"traceparent": tp}),
                metadata=metadata, timeout=GRPC_TIMEOUT_S)
            params = {k: getattr(v, v.WhichOneof("parameter_choice"))
                      for k, v in resp.parameters.items()}
            echo = params.get("traceparent", "")
            timing = {p: params[f"server_{p}_us"] / 1e3 for p in (
                "queue", "compute_input", "compute_infer",
                "compute_output")}
        _check(echo.split("-")[1:2] == [trace_id] and echo.endswith("-01"),
               f"traceparent {tp} came back as {echo!r}")
        gaps.append(_check_timing(f"bert_long request {i}",
                                  _trace_spans(port, trace_id), timing))
    # At once, so that waves reach the 16-lane bucket.
    rng = np.random.default_rng(41)
    half = OBS_STREAMS // 2
    prompts = [rng.integers(0, 512, CLIENT_PROMPTS[i % len(CLIENT_PROMPTS)])
               .tolist() for i in range(OBS_STREAMS)]
    body = {"parameters": {"max_tokens": OBS_TOKENS}}
    with concurrent.futures.ThreadPoolExecutor(half + 1) as pool:
        sse = [pool.submit(_stream, port, "tiny_gpt_long", dict(
            body, inputs=[{"name": "INPUT_IDS", "datatype": "INT32",
                           "shape": [len(p)], "data": p}]))
               for p in prompts[:half]]
        rpc = pool.submit(_grpc_streams, grpc_url, [
            (f"s{i}", "tiny_gpt_long", p, {"max_tokens": OBS_TOKENS})
            for i, p in enumerate(prompts[half:])])
        toks = [f.result()[0] for f in sse] + [
            rpc.result()[f"s{i}"][0] for i in range(half)]
    _check(all(len(t) == OBS_TOKENS for t in toks),
           f"streams of {[len(t) for t in toks]} tokens")
    rng = np.random.default_rng(42)
    for _ in range(OBS_DLRM):
        status, out = _http_infer(port, DLRM_MODEL, _mlperf_csr(rng), True)
        _check(status == 200 and np.isfinite(out["OUTPUT0"]).all(),
               f"{DLRM_MODEL}: {status} {out}")
    return {"timing_gap_ms": max(gaps)}


def _obs_faults(port: int, stub, seq: int) -> dict:
    """A seeded ``model.execute`` fault fails exactly the requests the
    seed's draws predict; counted on ``/metrics`` and journalled. Then one
    ``http.pre_read`` drop and one ``grpc.pre_infer`` error."""
    import random

    import grpc

    from client_tpu_torch import faults

    before = _samples(_scrape(port))
    cursor = _get(port, "/v2/events?category=fault")[1]["next_seq"]
    rng = random.Random(OBS_FAULT_SEED)
    want = [rng.random() < 0.5 for _ in range(OBS_FAULTED)]
    ids, mask = _obs_bert_inputs(seq, 99)
    body, headers = _binary_request(ids, mask)
    faults.configure({"model.execute": {
        "probability": 0.5, "seed": OBS_FAULT_SEED, "error_status": 503}})
    try:
        got = [_post(port, "/v2/models/bert_long/infer", body, headers)
               for _ in range(OBS_FAULTED)]
    finally:
        faults.reset()
    failed = [g[0] == 503 for g in got]
    _check(failed == want, f"faulted requests {failed}, the seed's draws "
           f"{want}")
    _check(all(g[0] in (200, 503) for g in got), "another status")
    _check(all(json.loads(g[2])["error"] == "injected fault at "
               "model.execute (error, status 503)" for g in got
               if g[0] == 503), "the fault's words")
    n = sum(want)

    # One http.pre_read drop (the connection closes with no answer) and one
    # grpc.pre_infer error; the next request on each answers.
    faults.configure({"http.pre_read": {"drop": True, "max_injections": 1},
                      "grpc.pre_infer": {"error_status": 503,
                                         "max_injections": 1}})
    try:
        try:
            _get(port, "/v2")
            dropped = False
        except (http.client.HTTPException, ConnectionError):
            dropped = True
        try:
            stub.ModelInfer(_grpc_request(
                "bert_long", {"input_ids": ids, "attention_mask": mask}),
                timeout=GRPC_TIMEOUT_S)
            code = None
        except grpc.RpcError as exc:
            code = (exc.code(), exc.details())
    finally:
        faults.reset()
    _check(dropped, "http.pre_read drop: the request was answered")
    _check(code == (grpc.StatusCode.UNAVAILABLE, "injected fault at "
                    "grpc.pre_infer (error, status 503)"),
           f"grpc.pre_infer: {code}")
    _check(_get(port, "/v2")[0] == 200, "HTTP after the drop")

    after = _samples(_scrape(port))
    for site, kind, count in (("model.execute", "error", n),
                              ("http.pre_read", "drop", 1),
                              ("grpc.pre_infer", "error", 1)):
        delta = (_sample_sum(after, "tpu_fault_injections_total",
                             site=site, kind=kind)
                 - _sample_sum(before, "tpu_fault_injections_total",
                               site=site, kind=kind))
        _check(delta == count, f"tpu_fault_injections_total{{{site},{kind}}}"
               f" rose by {delta}, not {count}")
    events = _get(port, f"/v2/events?category=fault&since={cursor}")[1]
    _check(len(events["events"]) == n + 2
           and all(e["name"] == "injected" for e in events["events"]),
           f"/v2/events: {events['events']}")
    return {"failed": n, "pattern": "".join("x" if f else "."
                                            for f in failed)}


def _obs_profile(engine, port: int, cpu_flops: float) -> dict:
    """``/v2/profile``: every bucket used has its executions, rows, one cold
    first execution and a counted roofline; every MFU and MBU on the card
    lies in (0, ``OBS_SHARE_MAX``]; ``bert_long``'s bucket 1 FLOPs equal
    the CPU count; the kernels' share of the counted costs."""
    status, snap = _get(port, "/v2/profile")
    _check(status == 200, f"/v2/profile: HTTP {status}")
    cuda = engine.device.type == "cuda"
    out = {"duty_cycle": snap["duty_cycle"],
           "peaks": snap["roofline"]["peaks"], "buckets": {}}
    shares = []
    for key in ("bert_long:1", DLRM_MODEL + ":1", "tiny_gpt_long:1"):
        entry = snap["models"].get(key)
        _check(entry is not None, f"/v2/profile has no {key}: "
               f"{list(snap['models'])}")
        for b in entry["buckets"]:
            rl = b["roofline"]
            warm = b["executions"] - b["cold_executions"]
            _check(b["cold_executions"] == 1 and b["compilations"] == 1
                   and b["rows"] > 0 and rl["cost_model"] == "counted"
                   and rl["flops_per_call"] > 0 and rl["bytes_per_call"] > 0,
                   f"{key} bucket {b['bucket']}: {b}")
            _check((b["device_s"] > 0) == (warm > 0),
                   f"{key} bucket {b['bucket']}: device_s {b['device_s']} "
                   f"over {warm} warm executions")
            row = {k: b[k] for k in ("executions", "cold_executions", "rows",
                                     "padded_rows", "device_s")}
            row.update({k: rl[k] for k in (
                "flops_per_call", "bytes_per_call", "achieved_flops_per_s",
                "mfu", "mbu")})
            out["buckets"][f"{key}/{b['bucket']}"] = row
            if cuda and warm > 0:
                shares += [(f"{key}/{b['bucket']}", rl["mfu"], rl["mbu"])]
        for w in entry.get("decode_waves", ()):
            rl = w["roofline"]
            row = {k: w[k] for k in ("waves", "dispatches", "device_s",
                                     "wave_ms_p50")}
            row.update({k: rl[k] for k in ("flops_per_call", "bytes_per_call",
                                           "mfu", "mbu")})
            out["buckets"][f"{key}/wave{w['bucket']}"] = row
            # A wave shape's first dispatch is cold (counted, its time kept
            # out): a shape used once has no device time.
            _check(rl["cost_model"] == "counted"
                   and (w["device_s"] > 0) == (w["dispatches"] > 1),
                   f"{key} wave bucket {w['bucket']}: {w}")
            if cuda and w["dispatches"] > 1:
                shares += [(f"{key}/wave{w['bucket']}", rl["mfu"], rl["mbu"])]
    for what, mfu, mbu in shares:
        _check(mfu is not None and mbu is not None
               and 0 < mfu <= OBS_SHARE_MAX and 0 < mbu <= OBS_SHARE_MAX,
               f"{what}: MFU {mfu}, MBU {mbu} outside (0, {OBS_SHARE_MAX}]")
    _check(not cuda or shares, "no bucket with a warm execution")

    # bert_long, bucket 1: the card's count (counter + K1's report) against
    # the CPU plain path's (counter over the plain attention's matmuls).
    card = out["buckets"]["bert_long:1/1"]["flops_per_call"]
    _check(abs(card - cpu_flops) <= OBS_FLOPS_RTOL * cpu_flops,
           f"bert_long bucket 1: {card:.6e} FLOPs counted on "
           f"{engine.device}, {cpu_flops:.6e} on the CPU")
    out["bert_long_flops"] = {"device": card, "cpu": cpu_flops}

    # The hand-written kernels' share of the counted costs: K2's arena
    # reads in every wave shape's bytes, and on the card K1's and K2's
    # FLOPs, which the FLOP counter cannot see through ctypes.
    costs = engine.profiler.cost_models()
    waves = {k: c for k, c in costs.items()
             if k[0] == "tiny_gpt_long" and len(k) == 4}
    long_cost = costs[("bert_long", "1", 1)]
    _check(waves and all(c["kernel_bytes"] > 0 and (
        not cuda or c["kernel_flops"] > 0) for c in waves.values()),
           f"tiny_gpt_long wave costs {waves}")
    _check(long_cost["kernel_bytes"] > 0
           and (not cuda or long_cost["kernel_flops"] > 0),
           f"bert_long bucket 1 cost {long_cost}")
    out["kernel_share"] = {
        "bert_long/1": {k: long_cost[k] for k in (
            "kernel_flops", "kernel_bytes", "flops", "bytes_accessed")},
        **{f"tiny_gpt_long/wave{k[2]}": {n: c[n] for n in (
            "kernel_flops", "kernel_bytes", "flops", "bytes_accessed")}
           for k, c in waves.items()}}
    return out


def _trace_cost_us(n: int = 20_000) -> float:
    """Host microseconds the tracing of one HTTP request costs the
    server, timed on this host: adopting its ``traceparent``, snapshotting
    its spans into the ring, and writing its ``traceparent`` and
    ``Server-Timing`` headers."""
    from client_tpu_torch.engine.types import RequestTimes
    from client_tpu_torch.observability.tracing import (
        TraceContext,
        TraceStore,
        build_request_trace,
        server_timing_header,
    )

    store = TraceStore(512)
    times = RequestTimes(received=1, queue_start=2, compute_start=3,
                         compute_input_end=4, compute_infer_end=5,
                         compute_output_end=6)
    header = "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01"
    t0 = time.perf_counter()
    for _ in range(n):
        ctx = TraceContext.from_traceparent(header)
        store.add(build_request_trace(ctx, "bert_long", "", times, True))
        ctx.to_traceparent()
        server_timing_header(times)
    return (time.perf_counter() - t0) / n * 1e6


def _cpu_bucket_flops(torch, served, seq: int) -> float:
    """``bert_long``'s FLOPs for one row counted on the CPU: the same
    model (dims read from the served one), its attention the plain
    version's torch ops."""
    from client_tpu_torch.models.bert import BertBackend
    from client_tpu_torch.observability.roofline import CostCapture

    cpu = BertBackend(
        name="bert_long_cpu", seq_len=seq,
        hidden=served.pooler.in_features, n_layers=len(served.layers),
        n_heads=served.n_heads, ffn=served.layers[0].w1.out_features,
        vocab=served.tok_embed.shape[0], attention_impl="flash",
        device="cpu")
    ids, mask = _obs_bert_inputs(seq, 0)
    with torch.inference_mode(), CostCapture(cpu) as cap:
        cpu({"input_ids": torch.from_numpy(ids),
             "attention_mask": torch.from_numpy(mask)})
    return cap.result()["flops"]


def observability_phase(torch, smi: str, device: str = "cuda") -> dict:
    """The metrics, tracing, fault and efficiency planes on one engine with
    ``bert_long`` (K1 bf16), ``tiny_gpt_long`` (K1 fp32, K2) and
    ``dlrm_mlperf`` (2 shards, K3) behind HTTP and gRPC. ``/metrics`` in
    both formats before and after the traffic: its deltas are what was
    sent, and each kernel launched its count per execution read there.
    ``device`` is for a dry run of the phase's logic on the CPU."""
    from client_tpu_torch.engine import TorchEngine
    from client_tpu_torch.models import build_repository
    from client_tpu_torch.models.dlrm import DlrmBackend
    from client_tpu_torch.ops import decode_attention as da
    from client_tpu_torch.ops import flash_attention as fa
    from client_tpu_torch.parallel import kv_shard as ks
    from client_tpu_torch.server import (
        GrpcInferenceServer,
        HttpInferenceServer,
    )

    t_phase = time.monotonic()
    device = torch.device(device)
    repo = build_repository(["bert_long", "tiny_gpt_long"])
    repo.register(DLRM_MODEL, lambda dev: DlrmBackend(
        name=DLRM_MODEL, device=dev, emb_devices=[dev] * 2, **MLPERF_DLRM))
    engine = TorchEngine(repo, device=device)
    # The profiler is process-global, and the earlier phases' engines
    # recorded into it: this phase reads its own records only, as a fresh
    # server process would.
    engine.profiler.reset()
    server = HttpInferenceServer(engine, port=0).start()
    grpc_server = GrpcInferenceServer(engine, port=0).start()
    channel, stub = _grpc_channel(grpc_server.url)
    models = ("bert_long", "tiny_gpt_long", DLRM_MODEL)
    print(f"observability: {list(models)} up in "
          f"{time.monotonic() - t_phase:.1f} s on {device}", flush=True)
    try:
        backend = engine.repository.get("bert_long").backend
        seq = engine.repository.get("bert_long").config.input[0].dims[0]
        t0 = time.monotonic()
        cpu_flops = _cpu_bucket_flops(torch, backend, seq)
        print(f"observability: bert_long, one row counted on the CPU in "
              f"{time.monotonic() - t0:.1f} s: {cpu_flops:.6e} FLOPs",
              flush=True)
        before = {om: _scrape(server.port, om) for om in (False, True)}
        fa.launches = fa.launches_fp32 = da.launches = ks.launches = 0
        t0 = time.monotonic()
        traffic = _obs_traffic(server.port, stub, grpc_server.url, seq)
        mid = _samples(_scrape(server.port))
        faulted = _obs_faults(server.port, stub, seq)
        # Disarmed: bert_long answers within the serve phase's tolerance of
        # the same module with its attention the plain version.
        ids, mask = _obs_bert_inputs(seq, 7)
        status, rheaders, data = _post(
            server.port, "/v2/models/bert_long/infer",
            *_binary_request(ids, mask))
        _check(status == 200, f"bert_long after the faults: HTTP {status}")
        got = _parse_response(rheaders, data)
        with torch.inference_mode():
            ref = backend.encode({
                "input_ids": torch.from_numpy(ids).to(device),
                "attention_mask": torch.from_numpy(mask).to(device)},
                fa.flash_attention_plain)
        err = max(float(np.abs(got[n] - ref[n].float().cpu().numpy()).max())
                  for n in BERT_OUTPUTS)
        _check(err <= SERVED_ATOL, f"bert_long after the faults: {err} off "
               f"the plain path (tolerance {SERVED_ATOL})")
        launches = {"flash_attention": fa.launches,
                    "flash_attention_fp32": fa.launches_fp32,
                    "decode_wave_attention": da.launches,
                    "ring_all_reduce": ks.launches}
        traffic_s = time.monotonic() - t0
        after = {om: _scrape(server.port, om) for om in (False, True)}

        # /metrics: the deltas are what was sent and executed.
        b, a = _samples(before[False]), _samples(after[False])

        def delta(name, model, samples=a):
            return (_sample_sum(samples, name, model=model)
                    - _sample_sum(b, name, model=model))

        sent = {"bert_long": OBS_LONG_HTTP + OBS_LONG_GRPC,
                "tiny_gpt_long": OBS_STREAMS, DLRM_MODEL: OBS_DLRM}
        execs = {}
        for m in models:
            ok = delta("tpu_inference_request_success", m, mid)
            _check(ok == sent[m], f"{m}: {ok} successes on /metrics after "
                   f"the traffic, {sent[m]} sent")
            execs[m] = delta("tpu_inference_exec_count", m)
            _check(execs[m] == delta("tpu_batch_size_count", m) > 0,
                   f"{m}: {execs[m]} executions, "
                   f"{delta('tpu_batch_size_count', m)} batch sizes")
        ok = delta("tpu_inference_request_success", "bert_long")
        _check(ok == sent["bert_long"] + OBS_FAULTED - faulted["failed"] + 1,
               f"bert_long: {ok} successes over the phase")
        fails = delta("tpu_inference_request_failure", "bert_long")
        _check(fails == faulted["failed"], f"bert_long: {fails} failures, "
               f"{faulted['failed']} injected")
        _check(execs["bert_long"] == ok and execs[DLRM_MODEL] == OBS_DLRM,
               f"executions {execs}: one a request, one at a time")
        om_after = _samples(after[True])
        _check(_sample_sum(om_after, "tpu_inference_exec_count") == 0
               and _sample_sum(om_after, "tpu_batch_size_count",
                               model="bert_long")
               == _sample_sum(a, "tpu_batch_size_count", model="bert_long"),
               "OpenMetrics: the legacy block is 0.0.4 only; the "
               "histograms agree")

        # Each kernel's launches: its count per execution read on /metrics.
        status, snap = _get(server.port, "/v2/profile?model=tiny_gpt_long")
        waves = sum(w["dispatches"] for w in snap["models"][
            "tiny_gpt_long:1"]["decode_waves"])
        gpt = engine.repository.get("tiny_gpt_long").backend
        per = {"flash_attention": (len(backend.layers), execs["bert_long"]),
               "flash_attention_fp32": (gpt.n_layers,
                                        execs["tiny_gpt_long"] - waves),
               "decode_wave_attention": (gpt.n_layers, waves),
               "ring_all_reduce": (1, execs[DLRM_MODEL])}
        if device.type == "cuda":
            for name, (k, n) in per.items():
                _check(launches[name] == k * n > 0,
                       f"{name}: {launches[name]} launches, {k} x {n} "
                       "executions read on /metrics")
        print(f"observability: /metrics deltas: successes {sent} (bert_long "
              f"{ok} over the phase, {fails} failed), executions {execs}, "
              f"{waves} of tiny_gpt_long's decode waves; launches {launches}"
              f" = per-execution counts x executions {per}", flush=True)
        print(f"observability: traceparent round trips over HTTP and gRPC "
              f"(parameter and metadata); spans against Server-Timing / "
              f"server_*_us within {traffic['timing_gap_ms']:.4f} ms "
              f"(limit {OBS_TIMING_MS})", flush=True)
        print(f"observability: model.execute at p=0.5, seed "
              f"{OBS_FAULT_SEED}: {faulted['pattern']} ({faulted['failed']}"
              f" of {OBS_FAULTED} failed, the seed's draws exactly); "
              "tpu_fault_injections_total and /v2/events counted them; an "
              "http.pre_read drop and a grpc.pre_infer error once each; "
              f"then bert_long within {err:.4g} of the plain path "
              f"(tolerance {SERVED_ATOL})", flush=True)
        profile = _obs_profile(engine, server.port, cpu_flops)
        duty = _sample_sum(_samples(_scrape(server.port)),
                           "tpu_device_duty_cycle")
        observation = {"card": smi, "traffic_s": round(traffic_s, 3),
                       "tpu_device_duty_cycle": duty,
                       "trace_us_per_request": _trace_cost_us(), **profile}
        print(f"observability observation: {json.dumps(observation)}",
              flush=True)
        print(f"observability: phase passed in "
              f"{time.monotonic() - t_phase:.1f} s; launches {launches}; "
              f"{smi}", flush=True)
        return launches
    finally:
        channel.close()
        grpc_server.stop()
        server.stop()
        engine.shutdown()


# -- weights phase ------------------------------------------------------------

FIXTURE = (Path(__file__).resolve().parent / "tests" / "torch_data"
           / "jax_gpt_ckpt")
WEIGHTS_KV2 = "tiny_gpt_long_kv2"
# tiny_gpt_long's registered size; a dry run on the CPU may shrink it.
WEIGHTS_GPT = dict(max_seq_len=2048, max_streams=16)
WEIGHTS_TOKENS = 16   # tokens of each restored GPT stream
# Card memory a restore may reach above what was allocated before it, in
# the weights' bytes: one copy of them (the module is filled on the host
# and moved one tensor at a time), and the caching allocator's rounding.
WEIGHTS_PEAK_MAX = 1.05


def _tree_bytes(tree) -> int:
    from client_tpu_torch.engine.checkpoint import flatten

    return sum(leaf.numel() * leaf.element_size()
               for _, _, leaf in flatten(tree))


def _restore_on_card(torch, build, path, device) -> tuple:
    """``build(device)`` inside ``restoring(path)``: (backend, seconds,
    peak bytes above the memory allocated before, weights' bytes)."""
    import gc

    from client_tpu_torch.engine.model import restoring

    gc.collect()
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.monotonic()
    with restoring(str(path)):
        backend = build(device)
    if cuda:
        torch.cuda.synchronize(device)
    seconds = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated(device) - base if cuda else 0
    return backend, seconds, peak, _tree_bytes(backend.params_to_jax())


def weights_phase(torch, smi: str, device: str = "cuda") -> dict:
    """Checkpoints restored and served: a directory repository whose
    weights the port's ``save_params`` wrote from in-process twins on the
    card (``bert_long`` v1 seeded and v2 with layer 0's ``w1`` halved, K1
    bf16; ``tiny_gpt_long`` with the same perturbation, K1 fp32 and K2,
    and again as ``tiny_gpt_long_kv2`` over 2 shards, K3; ``bert_base``
    with its pooler halved), plus the JAX-written fixture
    ``tests/torch_data/jax_gpt_ckpt`` (zstd-compressed by orbax), served
    by one engine behind HTTP and gRPC, every launch count set to 0 just
    before the traffic and read just after it. One row per request, so
    each BERT answer is bit for bit its twin's forward at batch 1; every
    greedy stream token for token its twin's direct stream, and the
    fixture's the tokens JAX recorded, its leaves' SHA-256 JAX's. Prints
    ``bert_base``'s save and restore seconds and MB/s, the fixture's
    decode rate, and each restore's peak card memory against its
    weights' bytes. ``device`` is for a dry run on the CPU."""
    import gc
    import hashlib
    import tempfile

    from client_tpu_torch.engine import TorchEngine
    from client_tpu_torch.engine.checkpoint import (
        flatten,
        load_params,
        save_params,
    )
    from client_tpu_torch.engine.repository import ModelRepository
    from client_tpu_torch.models import _REGISTRY, _import_all, register_model
    from client_tpu_torch.models.generate import TinyGptBackend
    from client_tpu_torch.ops import decode_attention as da
    from client_tpu_torch.ops import flash_attention as fa
    from client_tpu_torch.parallel import kv_shard as ks
    from client_tpu_torch.server import (
        GrpcInferenceServer,
        HttpInferenceServer,
    )

    t_phase = time.monotonic()
    device = torch.device(device)
    cuda = device.type == "cuda"
    _import_all()
    expect = json.loads((FIXTURE / "expect.json").read_text())
    fixture = expect["name"]
    cpu = torch.device("cpu")

    def gpt_long(dev, name="tiny_gpt_long", shards=1):
        backend = TinyGptBackend(name=name, attention_impl="flash",
                                 attn_impl="fused", kv_shards=shards,
                                 device=dev, **WEIGHTS_GPT)
        if shards > 1:  # every shard on this card
            backend._kv_mesh = ks.kv_mesh(shards, [dev] * shards)
        return backend

    def fixture_gpt(dev):
        return TinyGptBackend(name=fixture, device=dev, **expect["model"])

    register_model(WEIGHTS_KV2, default=False)(
        lambda dev: gpt_long(dev, WEIGHTS_KV2, 2))
    register_model(fixture, default=False)(fixture_gpt)
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_weights_"))
    engine = server = grpc_server = channel = None
    try:
        # The twins: each served model's weights, given directly.
        twins = {}
        with torch.no_grad():
            twins["bert_long", "1"] = _REGISTRY["bert_long"](device)
            twins["bert_long", "2"] = _REGISTRY["bert_long"](device)
            twins["bert_long", "2"].layers[0].w1.weight.mul_(0.5)
            twins["bert_base", "1"] = _REGISTRY["bert_base"](device)
            twins["bert_base", "1"].pooler.weight.mul_(0.5)
            gpt = gpt_long(device)
            gpt.layers[0].w1.weight.mul_(0.5)
        for (name, v), twin in twins.items():
            _write_config(root, name, {**twin.config.config_dict(),
                                       "version_policy": {"all": {}}},
                          versions=(v,))
        saved = {}
        for (name, v), twin in twins.items():
            tree = twin.params_to_jax()
            t0 = time.monotonic()
            save_params(str(root / name / v / "weights"), tree)
            saved[name, v] = (_tree_bytes(tree), time.monotonic() - t0)
        gcfg = gpt.config.config_dict()
        _write_config(root, "tiny_gpt_long",
                      {**gcfg, "parameters": {"weights_path": "ckpt"}})
        save_params(str(root / "tiny_gpt_long" / "ckpt"), gpt.params_to_jax())
        _write_config(root, WEIGHTS_KV2, {**gcfg, "name": WEIGHTS_KV2,
                                          "parameters": {"weights_path": str(
                                              root / "tiny_gpt_long" /
                                              "ckpt")}})
        _write_config(root, fixture, {
            **fixture_gpt(cpu).config.config_dict(),
            "parameters": {"weights_path": str(FIXTURE / "ckpt")}})
        nbytes, seconds = saved["bert_base", "1"]
        print(f"weights: save_params wrote bert_base ({nbytes / 1e6:.1f} MB "
              f"of weights on {device}) in {seconds:.2f} s, "
              f"{nbytes / 1e6 / seconds:.1f} MB/s; bert_long v1 and v2 in "
              f"{saved['bert_long', '1'][1]:.2f} and "
              f"{saved['bert_long', '2'][1]:.2f} s", flush=True)

        # Restores, each alone: seconds, rate and peak card memory.
        ckpt = root / "bert_base" / "1" / "weights"
        like = twins["bert_base", "1"].params_to_jax()
        t0 = time.monotonic()
        host = load_params(str(ckpt), like)
        host_s = time.monotonic() - t0
        del host
        observed = {"bert_base_save_s": seconds,
                    "bert_base_save_mb_s": nbytes / 1e6 / seconds,
                    "bert_base_load_params_s": host_s,
                    "bert_base_load_params_mb_s": nbytes / 1e6 / host_s}
        t0 = time.monotonic()
        load_params(str(FIXTURE / "ckpt"),
                    fixture_gpt(cpu).params_to_jax())
        fixture_s = time.monotonic() - t0
        frames = sum(p.stat().st_size for p in (FIXTURE / "ckpt").rglob("*")
                     if p.is_file())
        fixture_bytes = _tree_bytes(
            fixture_gpt(cpu).params_to_jax())
        observed.update(fixture_decode_s=fixture_s,
                        fixture_decode_mb_s=fixture_bytes / 1e6 / fixture_s,
                        fixture_frames_mb_s=frames / 1e6 / fixture_s)
        print(f"weights: the JAX-written fixture ({frames / 1e6:.2f} MB of "
              f"orbax files, {fixture_bytes / 1e6:.2f} MB of weights) "
              f"decoded in {fixture_s:.2f} s: "
              f"{fixture_bytes / 1e6 / fixture_s:.2f} MB/s of weights out, "
              f"{frames / 1e6 / fixture_s:.2f} MB/s of files in", flush=True)
        peaks = {}
        for label, build, path in (
                ("bert_base", _REGISTRY["bert_base"], ckpt),
                ("bert_long", _REGISTRY["bert_long"],
                 root / "bert_long" / "2" / "weights"),
                ("tiny_gpt_long", gpt_long, root / "tiny_gpt_long" / "ckpt"),
                (fixture, fixture_gpt, FIXTURE / "ckpt")):
            backend, secs, peak, wbytes = _restore_on_card(
                torch, build, path, device)
            del backend
            peaks[label] = {"seconds": secs, "peak_bytes": peak,
                            "weights_bytes": wbytes,
                            "mb_s": wbytes / 1e6 / secs}
            if cuda:
                _check(peak <= WEIGHTS_PEAK_MAX * wbytes,
                       f"restoring {label}: the card's memory peaked "
                       f"{peak} bytes above its start for {wbytes} bytes "
                       "of weights")
            print(f"weights: {label} restored to {device} in {secs:.2f} s "
                  f"({wbytes / 1e6 / secs:.1f} MB/s of weights); "
                  f"max_memory_allocated {peak} bytes above the start for "
                  f"{wbytes} bytes of weights ({peak / wbytes:.3f}x)",
                  flush=True)
        observed["restores"] = peaks
        gc.collect()

        engine = TorchEngine(ModelRepository.from_directory(str(root)),
                             device=device)
        server = HttpInferenceServer(engine, port=0).start()
        grpc_server = GrpcInferenceServer(engine, port=0).start()
        channel, stub = _grpc_channel(grpc_server.url)
        index = engine.repository_index()
        _check(all(e["state"] == "READY" for e in index),
               f"a restored model did not load: {index}")
        print(f"weights: {len(index)} rows READY from {root}: "
              f"{[(e['name'], e['version']) for e in index]}", flush=True)

        rng = np.random.default_rng(13)
        feeds = {}
        for name, v in twins:
            seq = twins[name, v].config.input[0].dims[0]
            for i in range(2):
                ids = rng.integers(0, 30522, (1, seq)).astype(np.int32)
                mask = np.ones((1, seq), np.int32)
                mask[0, rng.integers(seq // 4, seq + 1):] = 0
                feeds[name, v, i] = (ids, mask)
        prompts = [rng.integers(0, 512, n).tolist() for n in CLIENT_PROMPTS]
        gpt_prompts = [p for p in prompts if len(p) < gpt.max_seq_len
                       - WEIGHTS_TOKENS]

        def gen(model, prompt_list, n):
            with concurrent.futures.ThreadPoolExecutor(4) as pool:
                over_http = list(pool.map(lambda p: _stream(
                    server.port, model, {"inputs": [{
                        "name": "INPUT_IDS", "datatype": "INT32",
                        "shape": [len(p)], "data": p}],
                        "parameters": {"max_tokens": n}})[0], prompt_list))
            by_id = _grpc_streams(grpc_server.url, [
                (f"w{i}", model, p, {"max_tokens": n})
                for i, p in enumerate(prompt_list)])
            return over_http, [by_id[f"w{i}"][0]
                               for i in range(len(prompt_list))]

        fa.launches = fa.launches_fp32 = da.launches = ks.launches = 0
        answers = {}
        for (name, v, i), (ids, mask) in feeds.items():
            body, headers = _binary_request(ids, mask)
            status, rheaders, data = _post(
                server.port, f"/v2/models/{name}/versions/{v}/infer", body,
                headers)
            _check(status == 200, f"{name} v{v}: HTTP {status}: "
                   f"{data[:300]!r}")
            answers["http", name, v, i] = _parse_response(rheaders, data)
            req = _grpc_request(name, {"input_ids": ids,
                                       "attention_mask": mask})
            req.model_version = v
            answers["grpc", name, v, i] = _grpc_outputs(
                stub.ModelInfer(req, timeout=GRPC_TIMEOUT_S))
        streams = {model: gen(model, gpt_prompts, WEIGHTS_TOKENS)
                   for model in ("tiny_gpt_long", WEIGHTS_KV2)}
        streams[fixture] = gen(fixture, expect["prompts"],
                               expect["max_tokens"])
        launches = {"flash_attention": fa.launches,
                    "flash_attention_fp32": fa.launches_fp32,
                    "decode_wave_attention": da.launches,
                    "ring_all_reduce": ks.launches}

        # The twins, after the count is read.
        names = [tc.name for tc in twins["bert_base", "1"].config.output]
        with torch.inference_mode():
            for (wire, name, v, i), out in answers.items():
                ids, mask = feeds[name, v, i]
                want = twins[name, v]({
                    "input_ids": torch.from_numpy(ids).to(device),
                    "attention_mask": torch.from_numpy(mask).to(device)})
                for n in names:
                    _check(out[n].tobytes() == want[n].cpu().numpy()
                           .tobytes(), f"{name} v{v} over {wire}, request "
                           f"{i}: {n} is not bit for bit its twin's")
        _check(not np.array_equal(answers["http", "bert_long", "1", 0][
            "logits"], answers["http", "bert_long", "2", 0]["logits"]),
            "bert_long versions 1 and 2 answer alike")
        arena = gpt.init_arena(1)
        for model in ("tiny_gpt_long", WEIGHTS_KV2):
            for wire, got in zip(("SSE", "gRPC"), streams[model]):
                for prompt, toks in zip(gpt_prompts, got):
                    want = _direct_stream(torch, gpt, arena, prompt,
                                          WEIGHTS_TOKENS, {},
                                          device=device.type)
                    _check(toks == want, f"{model} over {wire}, prompt of "
                           f"{len(prompt)}: {toks} != its twin's {want}")
        del arena
        for wire, got in zip(("SSE", "gRPC"), streams[fixture]):
            _check(got == expect["greedy_tokens"],
                   f"the JAX-written {fixture} over {wire}: {got} != JAX's "
                   f"{expect['greedy_tokens']}")
        served = engine.repository.get(fixture).backend
        digests = {}
        for path, _, leaf in flatten(served.params_to_jax()):
            arr = leaf.detach().contiguous().cpu().numpy()
            digests[".".join(path)] = {
                "dtype": arr.dtype.name, "shape": list(arr.shape),
                "sha256": hashlib.sha256(arr.tobytes()).hexdigest()}
        _check(digests == expect["leaves"], "the JAX-written fixture's "
               "leaves on the card are not the SHA-256 JAX recorded")
        print(f"weights: bert_long v1/v2 and bert_base over HTTP and gRPC, "
              f"{len(answers)} answers bit for bit their twins' (v1 and v2 "
              f"differ); tiny_gpt_long and {WEIGHTS_KV2} "
              f"{len(gpt_prompts)} greedy streams each over SSE and gRPC "
              f"token for token their twin's; {fixture} restored with no "
              f"JAX: {len(digests)} leaves' SHA-256 and "
              f"{len(expect['prompts'])} greedy streams over SSE and gRPC "
              f"equal JAX's; launches {launches}", flush=True)
        if cuda:
            _check(all(launches.values()),
                   f"a kernel did not run in the phase: {launches}")

        # An unload gives the restored weights' card memory back.
        freed_bytes = sum(_device_bytes(m) for m in
                          engine.repository.loaded_versions(
                              "bert_long").values())
        before = _allocated(torch, device)
        status, _ = _repo_post(server.port,
                               "/v2/repository/models/bert_long/unload")
        _check(status == 200, f"unload bert_long: HTTP {status}")
        after = _allocated(torch, device)
        if cuda:
            _check(before - after >= REPO_FREED * freed_bytes,
                   f"unloading the restored bert_long freed "
                   f"{before - after} bytes of its {freed_bytes}")
        observed.update(unload_freed_bytes=before - after,
                        bert_long_bytes=freed_bytes, launches=launches)
        print(f"weights observation: {json.dumps(observed)}", flush=True)
        print(f"weights: phase passed in {time.monotonic() - t_phase:.1f} s; "
              f"{smi}", flush=True)
        return launches
    finally:
        if channel is not None:
            channel.close()
        for srv in (grpc_server, server):
            if srv is not None:
                srv.stop()
        if engine is not None:
            engine.shutdown()
        for name in (WEIGHTS_KV2, fixture):
            _REGISTRY.pop(name, None)
        shutil.rmtree(root, ignore_errors=True)


# -- overload phase -----------------------------------------------------------

OVER_GPT = dict(max_seq_len=2048, max_streams=16)  # tiny_gpt_long's size
OVER_KV2 = "tiny_gpt_long_kv2"
OVER_TOKENS = 64        # tokens of each stream the drain lets finish
OVER_HOLD_MS = 1500     # model.execute latency that holds bert_long's workers
OVER_EXPIRED = 3        # 1 ms requests: over HTTP, and twice over gRPC
OVER_BURST = 6          # concurrent bert_long requests against 5/s, burst 2
OVER_RETRIED = 4        # requests each port client sends with a RetryPolicy
OVER_TENANT = 4         # bert_long requests of each of two tenants
OVER_DLRM = 4           # dlrm_mlperf requests the SLO tracker must count
OVER_CHILD = 4          # requests in flight when the child gets SIGTERM
OVER_DRAIN_DEADLINE_S = 60.0
OVER_ADMISSION = {"models": {"bert_long": {"tokens_per_s": 5, "burst": 2}}}
OVER_SLO = '{"availability": 0.999}'
# The cost ledger against the profiler: the reconciliation the JAX package
# reports (device_s_ratio within 5%).
OVER_RECONCILE = (0.95, 1.05)


def _wait_for(cond, what: str, timeout_s: float = 120.0) -> None:
    end = time.monotonic() + timeout_s
    while not cond():
        _check(time.monotonic() < end, f"timed out waiting for {what}")
        time.sleep(0.0005)


def _grpc_outcome(stub, request, timeout: float = GRPC_TIMEOUT_S):
    """(code name, outputs or details, trailing metadata) of one
    ModelInfer call."""
    import grpc

    try:
        resp, call = stub.ModelInfer.with_call(request, timeout=timeout)
        return "OK", _grpc_outputs(resp), dict(call.trailing_metadata() or ())
    except grpc.RpcError as exc:
        return (exc.code().name, exc.details(),
                dict(exc.trailing_metadata() or ()))


def _bert_plain(torch, backend, ids, mask, device) -> dict:
    """``bert_long`` with its attention the plain version, on the card."""
    from client_tpu_torch.ops import flash_attention as fa

    with torch.inference_mode():
        ref = backend.encode({
            "input_ids": torch.from_numpy(ids).to(device),
            "attention_mask": torch.from_numpy(mask).to(device)},
            fa.flash_attention_plain)
    return {n: ref[n].float().cpu().numpy() for n in BERT_OUTPUTS}


def _bert_err(got: dict, ref: dict) -> float:
    err = max(float(np.abs(got[n] - ref[n]).max()) for n in BERT_OUTPUTS)
    _check(err <= SERVED_ATOL, f"bert_long: {err} off the plain path "
           f"(tolerance {SERVED_ATOL})")
    return err


def _over_census(torch, engine, port: int, stub, device) -> dict:
    """``/v2/memory`` and ``MemoryCensus`` agree; the rows equal the
    parameter and arena bytes exactly; DLRM's ``embedding`` has no drift;
    an unload of ``bert_long`` removes its row (and a load brings it
    back)."""
    from client_tpu_torch.observability.memory import tensor_leaves
    from client_tpu_torch.protocol import ops_pb2

    status, census = _get(port, "/v2/memory")
    _check(status == 200, f"/v2/memory: HTTP {status}")
    rpc = json.loads(stub.MemoryCensus(ops_pb2.MemoryRequest(),
                                       timeout=GRPC_TIMEOUT_S).memory_json)
    _check(set(rpc) == set(census) and rpc["owners"] == census["owners"],
           f"MemoryCensus {rpc['owners']} != /v2/memory {census['owners']}")
    rows = {(r["model"], r["component"]): r for r in census["owners"]}

    def param_bytes(backend):
        return sum(p.numel() * p.element_size() for p in backend.parameters())

    bert = param_bytes(engine.repository.get("bert_long").backend)
    _check(rows[("bert_long", "weights")]["bytes"] == bert,
           f"bert_long weights row {rows[('bert_long', 'weights')]} != its "
           f"parameters' {bert} bytes")
    arenas = {}
    for name in ("tiny_gpt_long", OVER_KV2):
        leaves = tensor_leaves(engine.scheduler_for(name)._arena)
        arenas[name] = sum(t.numel() * t.element_size() for t in leaves)
        row = rows[(name, "kv_arena")]
        _check(row["bytes"] == arenas[name]
               and row["buffers"] == len(leaves),
               f"{name} kv_arena row {row} != its {len(leaves)} arena "
               f"tensors' {arenas[name]} bytes")
    shards = engine.scheduler_for(OVER_KV2)._arena
    _check(arenas[OVER_KV2] == sum(t.numel() * t.element_size()
                                   for t in shards.k + shards.v + [shards.tok])
           and len(shards.k) == 2, f"{OVER_KV2}: the row is not its shards'")
    emb = rows[(DLRM_MODEL, "embedding")]
    dlrm = engine.repository.get(DLRM_MODEL).backend
    _check(emb["bytes"] == emb["plan_bytes"] == dlrm.table_host.nbytes
           and emb["drift_bytes"] == 0, f"{DLRM_MODEL} embedding row {emb}")
    _check(census["unattributed_bytes"] >= 0, "unattributed below 0")
    if device.type == "cuda":
        allocated = torch.cuda.memory_allocated()
        _check(census["attributed_bytes"] <= allocated,
               f"attributed {census['attributed_bytes']} > allocated "
               f"{allocated}")
    for verb, present in (("unload", False), ("load", True)):
        status, _ = _repo_post(port, f"/v2/repository/models/bert_long/{verb}")
        _check(status == 200, f"{verb} bert_long: HTTP {status}")
        after = {(r["model"], r["component"]): r["bytes"]
                 for r in _get(port, "/v2/memory")[1]["owners"]}
        _check((("bert_long", "weights") in after) == present,
               f"after the {verb}: bert_long's row {'missing' if present else 'kept'}")
    _check(after[("bert_long", "weights")] == param_bytes(
        engine.repository.get("bert_long").backend), "reloaded bert_long row")
    print(f"overload: census over HTTP and gRPC alike: bert_long weights "
          f"{bert} B (its parameters), kv_arena {arenas['tiny_gpt_long']} B "
          f"and {arenas[OVER_KV2]} B ({OVER_KV2}: 2 shards + tok), "
          f"{DLRM_MODEL} embedding {emb['bytes']} B (drift 0); attributed "
          f"{census['attributed_bytes']} B, unattributed "
          f"{census['unattributed_bytes']} B; an unload removed bert_long's "
          f"row, a load restored it", flush=True)
    return {f"{m}/{c}": r["bytes"] for (m, c), r in sorted(rows.items())}


def _over_deadlines(engine, port: int, stub, seq: int) -> dict:
    """``bert_long``'s workers held in a ``model.execute`` latency fault;
    1 ms requests over HTTP (``timeout-ms``) and gRPC (the parameter, and
    the RPC deadline) expire: 504 / DEADLINE_EXCEEDED, counted on
    ``tpu_deadline_expirations_total``; only the held requests execute."""
    from client_tpu_torch import faults

    sched = engine.scheduler_for("bert_long")
    workers = len(sched.workers)
    ids, mask = _obs_bert_inputs(seq, 21)
    body, headers = _binary_request(ids, mask)
    path = "/v2/models/bert_long/infer"
    before = _samples(_scrape(port))
    faults.configure({"model.execute": {"latency_ms": OVER_HOLD_MS}})
    try:
        with concurrent.futures.ThreadPoolExecutor(16) as pool:
            held = []
            for i in range(workers):
                held.append(pool.submit(_post, port, path, body, headers))
                _wait_for(lambda: sched.active_batches == i + 1,
                          f"bert_long worker {i} held")
            grpc_req = _grpc_request("bert_long", {"input_ids": ids,
                                                   "attention_mask": mask})
            param_req = _grpc_request("bert_long", {
                "input_ids": ids, "attention_mask": mask},
                parameters={"timeout_ms": 1})
            late_http = [pool.submit(_post, port, path, body,
                                     dict(headers, **{"timeout-ms": "1"}))
                         for _ in range(OVER_EXPIRED)]
            late_param = [pool.submit(_grpc_outcome, stub, param_req)
                          for _ in range(OVER_EXPIRED)]
            late_rpc = [pool.submit(_grpc_outcome, stub, grpc_req, 0.001)
                        for _ in range(OVER_EXPIRED)]
            held = [f.result() for f in held]
            late_http = [f.result() for f in late_http]
            late_param = [f.result() for f in late_param]
            late_rpc = [f.result() for f in late_rpc]
    finally:
        faults.reset()
    _check(all(h[0] == 200 for h in held), f"held: {[h[0] for h in held]}")
    for status, _, data in late_http:
        _check(status == 504 and json.loads(data)["error"].startswith(
            "end-to-end deadline expired before"),
            f"1 ms over HTTP: {status} {data[:200]}")
    for code, details, _ in late_param:
        _check(code == "DEADLINE_EXCEEDED" and details.startswith(
            "end-to-end deadline expired before"),
            f"timeout_ms 1 over gRPC: {code} {details}")
    _check(all(o[0] == "DEADLINE_EXCEEDED" for o in late_rpc),
           f"1 ms RPC deadline: {[o[:2] for o in late_rpc]}")
    after = _samples(_scrape(port))
    stages = {}
    for stage in ("admission", "queue", "execute"):
        n = (_sample_sum(after, "tpu_deadline_expirations_total",
                         model="bert_long", stage=stage)
             - _sample_sum(before, "tpu_deadline_expirations_total",
                           model="bert_long", stage=stage))
        if n:
            stages[stage] = int(n)
    expired = sum(stages.values())
    # The RPC-deadline calls count where the server saw them before the
    # client gave up; the others always.
    _check(2 * OVER_EXPIRED <= expired <= 3 * OVER_EXPIRED,
           f"{expired} expirations counted {stages}, "
           f"{3 * OVER_EXPIRED} sent")
    execs = int(_sample_sum(after, "tpu_inference_exec_count",
                            model="bert_long")
                - _sample_sum(before, "tpu_inference_exec_count",
                              model="bert_long"))
    _check(execs == workers, f"{execs} bert_long executions, {workers} held "
           "requests: an expired request executed")
    print(f"overload: deadlines: {workers} bert_long workers held "
          f"{OVER_HOLD_MS} ms; {OVER_EXPIRED} x timeout-ms 1 over HTTP -> "
          f"504, {OVER_EXPIRED} x timeout_ms 1 and {OVER_EXPIRED} x a 1 ms "
          f"RPC deadline over gRPC -> DEADLINE_EXCEEDED; counted {stages}; "
          f"{execs} executions (the held requests alone)", flush=True)
    return {"expired": stages, "executions": execs}


def _over_admission(torch, engine, port: int, url: str, grpc_url: str, stub,
                    backend, seq: int, device) -> dict:
    """``bert_long`` at 5 requests/s, burst 2: bursts over HTTP and gRPC
    shed with pushback; the port's own clients with a ``RetryPolicy`` ride
    it out; every answer within ``SERVED_ATOL`` of the plain path."""
    import client_tpu_torch.grpc as grpcclient
    import client_tpu_torch.http as httpclient
    from client_tpu_torch.admission import (
        AdmissionConfig,
        AdmissionController,
    )
    from client_tpu_torch.resilience import RetryPolicy

    inputs = [_obs_bert_inputs(seq, 31 + i) for i in range(2)]
    refs = [_bert_plain(torch, backend, ids, mask, device)
            for ids, mask in inputs]
    default = engine.admission
    engine.admission = AdmissionController(
        AdmissionConfig.from_dict(json.loads(json.dumps(OVER_ADMISSION))),
        metrics=engine.metrics)
    errs, retries = [], {}
    try:
        with concurrent.futures.ThreadPoolExecutor(OVER_BURST) as pool:
            http_burst = list(pool.map(
                lambda i: _post(port, "/v2/models/bert_long/infer",
                                *_binary_request(*inputs[i % 2])),
                range(OVER_BURST)))
            grpc_burst = list(pool.map(
                lambda i: _grpc_outcome(stub, _grpc_request(
                    "bert_long", {"input_ids": inputs[i % 2][0],
                                  "attention_mask": inputs[i % 2][1]})),
                range(OVER_BURST)))
        words = "model 'bert_long' request rate exceeds 5/s (burst 2)"
        http_shed = 0
        for i, (status, headers, data) in enumerate(http_burst):
            if status == 200:
                errs.append(_bert_err(_parse_response(headers, data),
                                      refs[i % 2]))
                continue
            http_shed += 1
            _check(status == 429 and json.loads(data)["error"] == words
                   and 0.01 <= float(headers["Retry-After"]) <= 30
                   and headers["X-Health-State"] == "DEGRADED",
                   f"HTTP shed: {status} {headers} {data[:200]}")
        grpc_shed = 0
        for i, (code, out, trailers) in enumerate(grpc_burst):
            if code == "OK":
                errs.append(_bert_err(out, refs[i % 2]))
                continue
            grpc_shed += 1
            after_s = float(trailers["retry-after"])
            _check(code == "RESOURCE_EXHAUSTED" and out == words
                   and 0.01 <= after_s <= 30
                   and abs(int(trailers["retry-pushback-ms"])
                           - after_s * 1000) <= 1,
                   f"gRPC shed: {code} {out} {trailers}")
        _check(http_shed > 0 and grpc_shed > 0,
               f"{OVER_BURST} at once shed {http_shed} over HTTP, "
               f"{grpc_shed} over gRPC")
        for mod, target in ((httpclient, url), (grpcclient, grpc_url)):
            client = mod.InferenceServerClient(
                target, retry_policy=RetryPolicy(max_attempts=40, seed=3))
            try:
                for i in range(OVER_RETRIED):
                    ids, mask = inputs[i % 2]
                    feed = [mod.InferInput("input_ids", list(ids.shape),
                                           "INT32"),
                            mod.InferInput("attention_mask", list(mask.shape),
                                           "INT32")]
                    feed[0].set_data_from_numpy(ids)
                    feed[1].set_data_from_numpy(mask)
                    result = client.infer("bert_long", feed)
                    errs.append(_bert_err({n: result.as_numpy(n)
                                           for n in BERT_OUTPUTS},
                                          refs[i % 2]))
                retries[mod.__name__.rsplit(".", 1)[1]] = \
                    client.get_infer_stat()["retry_count"]
            finally:
                client.close()
        sheds = engine.admission.rejection_count
    finally:
        engine.admission = default
    print(f"overload: admission (bert_long 5/s, burst 2): {OVER_BURST} at "
          f"once shed {http_shed} over HTTP (429, Retry-After, DEGRADED) and "
          f"{grpc_shed} over gRPC (RESOURCE_EXHAUSTED, retry-after and "
          f"retry-pushback-ms); the port's clients with a RetryPolicy: "
          f"{OVER_RETRIED} each, all answered, retries {retries}; {sheds} "
          f"sheds in all; answers within {max(errs):.4g} of the plain path "
          f"(tolerance {SERVED_ATOL})", flush=True)
    return {"http": http_shed, "grpc": grpc_shed, "total": sheds,
            "client_retries": retries}


def _over_ledgers(engine, port: int, seq: int) -> dict:
    """Two tenants (``X-Tpu-Tenant`` and the ``tenant`` parameter) billed
    and reconciled with the profiler; ``/v2/slo`` counts what was sent;
    the recorder's samples carry the duty cycle, the queue depth and the
    census's card bytes."""
    rng = np.random.default_rng(44)
    for i in range(OVER_TENANT):
        ids, mask = _obs_bert_inputs(seq, 70 + i)
        body, headers = _binary_request(ids, mask)
        status, _, _ = _post(port, "/v2/models/bert_long/infer", body,
                             dict(headers, **{"X-Tpu-Tenant": "tenant-a"}))
        _check(status == 200, f"tenant-a: HTTP {status}")
        body, headers = _binary_request(ids, mask, {"tenant": "tenant-b"})
        status, _, _ = _post(port, "/v2/models/bert_long/infer", body,
                             headers)
        _check(status == 200, f"tenant-b: HTTP {status}")
    for _ in range(OVER_DLRM):
        status, out = _http_infer(port, DLRM_MODEL, _mlperf_csr(rng), True)
        _check(status == 200 and np.isfinite(out["OUTPUT0"]).all(),
               f"{DLRM_MODEL}: {status}")
    costs = _get(port, "/v2/costs")[1]
    bert = _get(port, "/v2/costs?model=bert_long")[1]
    for tenant in ("tenant-a", "tenant-b"):
        row = bert["tenants"][tenant]["models"]["bert_long:1"]
        _check(row["requests"] == OVER_TENANT and row["device_s"] > 0,
               f"{tenant}: {row}")
    ratios = {}
    for key, snap in (("all", costs), ("bert_long", bert)):
        rec = snap["reconciliation"]
        ratios[key] = rec["device_s_ratio"]
        _check(rec["device_s_ratio"] is not None and OVER_RECONCILE[0]
               <= rec["device_s_ratio"] <= OVER_RECONCILE[1],
               f"costs reconciliation ({key}): {rec}")
    slo = _get(port, "/v2/slo")[1]
    counts = {m: slo["models"][m]["windows"]["5m"]["requests"]
              for m in ("bert_long", DLRM_MODEL)}
    metrics = _samples(_scrape(port))
    answered = int(sum(_sample_sum(metrics, f"tpu_inference_request_{k}",
                                   model="bert_long")
                       for k in ("success", "failure")))
    _check(counts[DLRM_MODEL] == OVER_DLRM and counts["bert_long"] == answered,
           f"/v2/slo counts {counts}: {OVER_DLRM} {DLRM_MODEL} requests sent, "
           f"{answered} bert_long requests answered")
    engine.recorder.tick()
    sample = _get(port, "/v2/timeseries?limit=1")[1]["samples"][-1]["signals"]
    in_use = sum(d["bytes_in_use"] for d in
                 _get(port, "/v2/memory")[1]["devices"])
    _check({"duty_cycle", "queue_depth", "hbm_used"} <= set(sample)
           and "bert_long" in sample["queue_depth"]
           and (sample["hbm_used"] > 0) == (in_use > 0),
           f"/v2/timeseries sample {sample}")
    print(f"overload: costs: tenant-a (X-Tpu-Tenant) and tenant-b (the "
          f"tenant parameter) {OVER_TENANT} bert_long requests each; "
          f"device_s_ratio against the profiler {ratios}; /v2/slo counts "
          f"{counts}; a recorder sample {sorted(sample)}, hbm_used "
          f"{sample['hbm_used']} B", flush=True)
    return {"device_s_ratio": ratios, "slo_requests": counts}


def _over_drain(torch, engine, server, grpc_server, device) -> dict:
    """8 ``tiny_gpt_long`` streams (4 over SSE, 4 on one gRPC stream) and 4
    ``tiny_gpt_long_kv2`` streams mid-generation when ``drain()`` begins:
    new requests 503 DRAINING, ``/v2/health/ready`` 503, every stream
    finishes token for token against the plain path, a clean report well
    inside the deadline. The drain shuts the engine down."""
    from client_tpu_torch.admission.drain import drain
    from client_tpu_torch.models.generate import TinyGptBackend

    port = server.port
    rng = np.random.default_rng(52)
    lens = [min(n, OVER_GPT["max_seq_len"] - OVER_TOKENS - 1)
            for n in CLIENT_PROMPTS]
    prompts = [rng.integers(0, 512, n).tolist() for n in lens]
    kv2_prompts = prompts[1::2]
    keep = [http.client.HTTPConnection("127.0.0.1", port, timeout=600)
            for _ in range(2)]
    for conn in keep:  # kept alive: the drain stops the accept loop
        conn.request("GET", "/v2/health/live")
        resp = conn.getresponse()
        resp.read()
        _check(resp.status == 200, "health/live before the drain")

    def body(p):
        return {"inputs": [{"name": "INPUT_IDS", "datatype": "INT32",
                            "shape": [len(p)], "data": p}],
                "parameters": {"max_tokens": OVER_TOKENS}}

    scheds = {m: engine.scheduler_for(m) for m in ("tiny_gpt_long", OVER_KV2)}
    with concurrent.futures.ThreadPoolExecutor(12) as pool:
        sse = [pool.submit(_stream, port, "tiny_gpt_long", body(p))
               for p in prompts[:4]]
        rpc = pool.submit(_grpc_streams, grpc_server.url, [
            (f"d{i}", "tiny_gpt_long", p, {"max_tokens": OVER_TOKENS})
            for i, p in enumerate(prompts[4:])])
        kv2 = [pool.submit(_stream, port, OVER_KV2, body(p))
               for p in kv2_prompts]
        _wait_for(lambda: len(scheds["tiny_gpt_long"]._streams) == 8
                  and len(scheds[OVER_KV2]._streams) == 4,
                  "12 streams generating")
        t_drain = time.monotonic()
        report = pool.submit(drain, engine, [server], [grpc_server],
                             deadline_s=OVER_DRAIN_DEADLINE_S)
        _wait_for(lambda: not engine.is_ready(), "the drain began")
        keep[0].request("POST", "/v2/models/bert_long/infer",
                        *_binary_request(*_obs_bert_inputs(
                            engine.repository.get("bert_long").config
                            .input[0].dims[0], 90)))
        resp = keep[0].getresponse()
        shed = (resp.status, resp.getheader("Retry-After"),
                resp.getheader("X-Health-State"), json.loads(resp.read()))
        keep[1].request("GET", "/v2/health/ready")
        resp = keep[1].getresponse()
        ready = (resp.status, resp.getheader("X-Health-State"),
                 json.loads(resp.read()))
        report = report.result(timeout=OVER_DRAIN_DEADLINE_S + 60)
        served = ([f.result()[:2] for f in sse]
                  + [rpc.result()[f"d{i}"][:2] for i in range(4)]
                  + [f.result()[:2] for f in kv2])
    for conn in keep:
        conn.close()
    _check(shed == (503, "1.000", "DRAINING", {
        "error": "server is draining; retry against another replica"}),
        f"a request during the drain: {shed}")
    _check(ready == (503, "DRAINING", {"state": "DRAINING"}),
           f"/v2/health/ready during the drain: {ready}")
    _check(report["clean"] and report["pending"] == 0
           and report["drain_s"] < OVER_DRAIN_DEADLINE_S / 2,
           f"drain report {report}")
    _check(all(len(toks) == OVER_TOKENS and times[-1] > t_drain
               for toks, times in served),
           "a stream was not mid-generation when the drain began, or did "
           f"not finish: {[len(t) for t, _ in served]}")
    oracle = TinyGptBackend(name="tiny_gpt_long", attention_impl="einsum",
                            attn_impl="reference", device=device, **OVER_GPT)
    arena = oracle.init_arena(1)
    for prompt, (toks, _) in zip(prompts + kv2_prompts, served):
        want = _direct_stream(torch, oracle, arena, prompt, OVER_TOKENS, {},
                              device=device.type)
        _check(toks == want, f"a drained stream, prompt of {len(prompt)}: "
               f"{toks} != direct {want}")
    print(f"overload: drain with 8 tiny_gpt_long (4 SSE, 4 on one gRPC "
          f"stream) and 4 {OVER_KV2} streams mid-generation: a new request "
          f"503 DRAINING (Retry-After 1.000), /v2/health/ready 503; every "
          f"stream finished, {OVER_TOKENS} tokens token for token against "
          f"the plain path; report {report} (deadline "
          f"{OVER_DRAIN_DEADLINE_S} s)", flush=True)
    return report


def _over_sigterm_child(torch, backend, seq: int, device) -> dict:
    """``python -m client_tpu_torch.server --zoo bert_long`` on the card,
    its executions held ``OVER_HOLD_MS`` by a fault from its environment,
    sent SIGTERM with ``OVER_CHILD`` requests in flight: each is
    answered (within ``SERVED_ATOL`` of the plain path), the drain is
    clean and the child exits 0."""
    import signal
    import socket

    ports = []
    for _ in range(2):
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            ports.append(sock.getsockname()[1])
    env = dict(os.environ, CLIENT_TPU_FAULTS=json.dumps(
        {"model.execute": {"latency_ms": OVER_HOLD_MS}}))
    inputs = [_obs_bert_inputs(seq, 80 + i) for i in range(OVER_CHILD)]
    refs = [_bert_plain(torch, backend, ids, mask, device)
            for ids, mask in inputs]
    t0 = time.monotonic()
    proc = subprocess.Popen(
        [sys.executable, "-m", "client_tpu_torch.server", "--zoo",
         "bert_long", "--host", "127.0.0.1", "--http-port", str(ports[0]),
         "--grpc-port", str(ports[1]), "--drain-deadline",
         str(OVER_DRAIN_DEADLINE_S)],
        cwd=Path(__file__).resolve().parent, env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    lines: list[str] = []
    reader = threading.Thread(target=lambda: lines.extend(proc.stderr),
                              daemon=True)
    reader.start()
    try:
        _wait_for(lambda: any("serving grpc at" in ln for ln in lines)
                  or proc.poll() is not None, "the child serving", 600)
        _check(proc.poll() is None, f"the child exited: {''.join(lines)}")
        up_s = time.monotonic() - t0
        with concurrent.futures.ThreadPoolExecutor(OVER_CHILD) as pool:
            futures = [pool.submit(_post, ports[0],
                                   "/v2/models/bert_long/infer",
                                   *_binary_request(ids, mask))
                       for ids, mask in inputs]
            time.sleep(OVER_HOLD_MS / 3e3)  # each held in the fault
            _check(not any(f.done() for f in futures),
                   "a request finished before the SIGTERM")
            proc.send_signal(signal.SIGTERM)
            answers = [f.result(timeout=600) for f in futures]
        rc = proc.wait(timeout=OVER_DRAIN_DEADLINE_S + 60)
        reader.join(timeout=10)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    _check(rc == 0, f"the child exited {rc}: {''.join(lines)[-2000:]}")
    errs = []
    for (status, headers, data), ref in zip(answers, refs):
        _check(status == 200, f"a request in flight at SIGTERM: {status}")
        errs.append(_bert_err(_parse_response(headers, data), ref))
    drains = [ln for ln in lines if ln.startswith("drain: ")]
    _check(len(drains) == 1, f"the child's drain line: {lines[-5:]}")
    import ast

    report = ast.literal_eval(drains[0][len("drain: "):].strip())
    _check(report["clean"] and report["pending"] == 0,
           f"the child's drain {report}")
    print(f"overload: SIGTERM child (python -m client_tpu_torch.server, up "
          f"in {up_s:.1f} s): {OVER_CHILD} requests in flight all answered "
          f"within {max(errs):.4g} of the plain path, drain {report}, exit "
          f"{rc}", flush=True)
    return report


def _admission_cost_us(n: int = 20_000) -> dict:
    """Host µs per request of the admission decision, the in-flight
    accounting and the deadline check, with no limit and with a token
    bucket configured."""
    from client_tpu_torch.admission import (
        AdmissionConfig,
        AdmissionController,
    )
    from client_tpu_torch.engine.types import InferRequest

    req = InferRequest(model_name="m", inputs={})
    req.set_deadline_from_timeout_ms(60_000)
    out = {}
    for label, cfg in (("unlimited", {}),
                       ("bucket", {"tokens_per_s": 1e12, "burst": 1e12})):
        ctl = AdmissionController(AdmissionConfig(models={"m": cfg}))
        t0 = time.perf_counter()
        for _ in range(n):
            req.deadline_expired()
            ctl.admit("m", "", queue_depth=0, instances=2, tenant="default")
            ctl.on_request_start("m")
            ctl.on_request_end("m", 0.001)
        out[label] = round((time.perf_counter() - t0) / n * 1e6, 3)
    return out


def overload_phase(torch, smi: str, device: str = "cuda") -> dict:
    """Overload protection and the census planes on one engine with
    ``bert_long`` (K1 bf16), ``tiny_gpt_long`` (K1 fp32, K2),
    ``tiny_gpt_long_kv2`` (2 shards, K3) and ``dlrm_mlperf`` (2 shards,
    K3) behind HTTP and gRPC: the census, deadlines, admission, costs,
    SLO and the recorder, a drain with streams in flight, then a SIGTERM'd
    server child (on the card only). Returns each kernel's launches.
    ``device`` is for a dry run of the phase's logic on the CPU."""
    from client_tpu_torch.engine import TorchEngine
    from client_tpu_torch.models import build_repository
    from client_tpu_torch.models.dlrm import DlrmBackend
    from client_tpu_torch.models.generate import TinyGptBackend
    from client_tpu_torch.observability.costs import ledger
    from client_tpu_torch.observability.memory import reset_hbm_census
    from client_tpu_torch.ops import decode_attention as da
    from client_tpu_torch.ops import flash_attention as fa
    from client_tpu_torch.parallel import kv_shard as ks
    from client_tpu_torch.server import (
        GrpcInferenceServer,
        HttpInferenceServer,
    )

    t_phase = time.monotonic()
    device = torch.device(device)
    cuda = device.type == "cuda"

    def gpt(dev, name, shards):
        backend = TinyGptBackend(name=name, attention_impl="flash",
                                 attn_impl="fused", kv_shards=shards,
                                 device=dev, **OVER_GPT)
        if shards > 1:  # every shard on this card
            backend._kv_mesh = ks.kv_mesh(shards, [dev] * shards)
        return backend

    repo = build_repository(["bert_long"])
    repo.register("tiny_gpt_long", lambda dev: gpt(dev, "tiny_gpt_long", 1))
    repo.register(OVER_KV2, lambda dev: gpt(dev, OVER_KV2, 2))
    repo.register(DLRM_MODEL, lambda dev: DlrmBackend(
        name=DLRM_MODEL, device=dev, emb_devices=[dev] * 2, **MLPERF_DLRM))
    # The census, the profiler and the ledger are process-global: this
    # phase reads its own models and records alone, as a fresh server
    # process would.
    reset_hbm_census()
    previous = os.environ.get("CLIENT_TPU_SLO")
    os.environ["CLIENT_TPU_SLO"] = OVER_SLO
    try:
        engine = TorchEngine(repo, device=device)
    finally:
        if previous is None:
            os.environ.pop("CLIENT_TPU_SLO")
        else:
            os.environ["CLIENT_TPU_SLO"] = previous
    engine.profiler.reset()
    ledger().reset()
    server = HttpInferenceServer(engine, port=0).start()
    grpc_server = GrpcInferenceServer(engine, port=0).start()
    channel, stub = _grpc_channel(grpc_server.url)
    print(f"overload: bert_long, tiny_gpt_long, {OVER_KV2}, {DLRM_MODEL} up "
          f"in {time.monotonic() - t_phase:.1f} s on {device}", flush=True)
    drained = False
    try:
        census = _over_census(torch, engine, server.port, stub, device)
        seq = engine.repository.get("bert_long").config.input[0].dims[0]
        before = _samples(_scrape(server.port))
        fa.launches = fa.launches_fp32 = da.launches = ks.launches = 0
        deadlines = _over_deadlines(engine, server.port, stub, seq)
        backend = engine.repository.get("bert_long").backend
        admission = _over_admission(torch, engine, server.port, server.url,
                                    grpc_server.url, stub, backend, seq,
                                    device)
        ledgers = _over_ledgers(engine, server.port, seq)
        after = _samples(_scrape(server.port))
        executions = int(_sample_sum(after, "tpu_inference_exec_count",
                                     model="bert_long")
                         - _sample_sum(before, "tpu_inference_exec_count",
                                       model="bert_long"))
        if cuda:
            _check(fa.launches == len(backend.layers) * executions > 0,
                   f"K1 bf16: {fa.launches} launches, {len(backend.layers)} "
                   f"x {executions} bert_long executions on /metrics")
        drain_report = _over_drain(torch, engine, server, grpc_server,
                                   device)
        drained = True
        launches = {"flash_attention": fa.launches,
                    "flash_attention_fp32": fa.launches_fp32,
                    "decode_wave_attention": da.launches,
                    "ring_all_reduce": ks.launches}
        if cuda:
            _check(all(v > 0 for v in launches.values()),
                   f"a kernel of the path did not launch: {launches}")
            child = _over_sigterm_child(torch, backend, seq, device)
        else:
            child = None
        observation = {
            "card": smi, "census": census,
            "drain_s": round(drain_report["drain_s"], 4),
            "child_drain_s": (round(child["drain_s"], 4) if child
                              else None),
            "shed": admission, "expired": deadlines["expired"],
            "admission_deadline_us_per_request": _admission_cost_us(),
            "device_s_ratio": ledgers["device_s_ratio"]}
        print(f"overload observation: {json.dumps(observation)}", flush=True)
        print(f"overload: phase passed in {time.monotonic() - t_phase:.1f} "
              f"s; launches {launches}; {smi}", flush=True)
        return launches
    finally:
        channel.close()
        if not drained:
            grpc_server.stop()
            server.stop()
            engine.shutdown()


TUNE_QOS = {"classes": {
    "interactive": {"weight": 4, "preempt": True, "priority_level": 1},
    "batch": {"weight": 1, "priority_level": 2}},
    "tenants": {"ui": "interactive", "etl": "batch"},
    "default_class": "interactive"}
TUNE_LEVEL_CAP = 4      # bert_long's level 2 holds this many queued
TUNE_WAVE = 4           # requests of each class queued behind the hold
TUNE_HOLD_MS = 1500     # model.execute latency that holds the worker
TUNE_PAIRS = 9          # 2-row bert_long requests before the tuner's tick
TUNE_AUTOTUNE = '{"interval_s": 3600, "min_calls": 8}'
TUNE_SELFDRIVE = '{"interval_s": 3600}'
TUNE_STREAMS = (3, 40, 700)  # tiny_gpt_long prompt lengths
TUNE_TOKENS = 8
TUNE_DLRM = 4           # dlrm_mlperf requests


class _Env:
    """Environment variables set for a block, then restored."""

    def __init__(self, **values):
        self.values = values
        self.saved = {}

    def __enter__(self):
        for k, v in self.values.items():
            self.saved[k] = os.environ.get(k)
            os.environ[k] = v

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _timing(headers: dict) -> dict[str, float]:
    """A response's ``Server-Timing`` phases in ms."""
    from client_tpu_torch.observability.tracing import parse_server_timing

    return {k: v / 1e3 for k, v in parse_server_timing(
        headers.get("Server-Timing")).items()}


def _cold_table(engine) -> dict:
    """{model: [(bucket, compilations, cold executions, executions)]}
    and, for a generative model, its decode shapes' cold dispatches."""
    out = {e["model"]: [(b["bucket"], b["compilations"],
                         b["cold_executions"], b["executions"])
                        for b in e["buckets"]]
           for e in engine.profile_snapshot()["models"].values()}
    waves = {}
    for (model, _v, bucket, chunk), w in engine.profiler._waves.items():
        waves.setdefault(model, []).append(
            (bucket, chunk, w.dispatches, w.cold_dispatches))
    return out, waves


def _tune_qos(torch, engine, port: int, stub, seq: int, backend,
              device) -> dict:
    """``bert_long``'s worker held; batch-class then interactive requests
    queue; the interactive ones make the first wave, one batch request
    past the level's cap sheds, every answer is within ``SERVED_ATOL`` of
    its own feed's plain output; ``/v2/qos`` and ``Qos`` agree."""
    from client_tpu_torch import faults
    from client_tpu_torch.protocol import ops_pb2

    sched = engine.scheduler_for("bert_long")
    path = "/v2/models/bert_long/infer"
    feeds = [_obs_bert_inputs(seq, 60 + i) for i in range(2 * TUNE_WAVE + 2)]

    def send(i, tenant):
        ids, mask = feeds[i]
        body, headers = _binary_request(ids, mask)
        return _post(port, path, body, dict(headers,
                                            **{"X-Tpu-Tenant": tenant}))

    faults.configure({"model.execute": {"latency_ms": TUNE_HOLD_MS}})
    try:
        with concurrent.futures.ThreadPoolExecutor(2 * TUNE_WAVE + 2) as pool:
            held = pool.submit(send, 0, "etl")
            _wait_for(lambda: sched.active_batches == 1, "bert_long held")
            batch = []
            for i in range(TUNE_WAVE):
                batch.append(pool.submit(send, 1 + i, "etl"))
                _wait_for(lambda: sched.queue.qsize() == i + 1,
                          f"batch request {i} queued")
            shed = send(1 + TUNE_WAVE, "etl")  # past the level's cap
            inter = []
            for i in range(TUNE_WAVE):
                inter.append(pool.submit(send, 2 + TUNE_WAVE + i, "ui"))
                _wait_for(lambda: sched.queue.qsize() == TUNE_WAVE + i + 1,
                          f"interactive request {i} queued")
            lanes = engine.qos_snapshot(model="bert_long")["queues"]
            faults.reset()
            held = held.result()
            batch = [f.result() for f in batch]
            inter = [f.result() for f in inter]
    finally:
        faults.reset()
    _check(lanes == {"bert_long": {"interactive": TUNE_WAVE,
                                   "batch": TUNE_WAVE}},
           f"lanes while held: {lanes}")
    _check(shed[0] == 429 and json.loads(shed[2])["error"] == (
        f"model 'bert_long' rejected request at priority level 2: current "
        f"queue depth {TUNE_LEVEL_CAP} exceeds maximum queue size "
        f"({TUNE_LEVEL_CAP}) for that level"),
        f"past the level's cap: {shed[0]} {shed[2][:200]}")
    for status, headers, data in [held] + batch + inter:
        _check(status == 200, f"bert_long: HTTP {status} {data[:200]}")
        _check("compile" not in _timing(headers), "a cold execution")
    queue_ms = {"interactive": [_timing(h)["queue"] for _, h, _ in inter],
                "batch": [_timing(h)["queue"] for _, h, _ in batch]}
    _check(max(queue_ms["interactive"]) < min(queue_ms["batch"]),
           f"interactive requests did not lead: {queue_ms}")
    # Every answer against its own feed's plain output: a lane that
    # returned the wrong tensor, or one request another's answer, fails.
    answered = [(0, held)] + [(1 + i, r) for i, r in enumerate(batch)] + [
        (2 + TUNE_WAVE + i, r) for i, r in enumerate(inter)]
    plains = {i: _bert_plain(torch, backend, *feeds[i], device)
              for i, _ in answered}
    err = max(_bert_err(_parse_response(headers, data), plains[i])
              for i, (_, headers, data) in answered)
    apart = min(max(float(np.abs(plains[i][n] - plains[j][n]).max())
                    for n in BERT_OUTPUTS)
                for i in plains for j in plains if i < j)
    status, body = _get(port, "/v2/qos")
    rpc = json.loads(stub.Qos(ops_pb2.QosRequest(),
                              timeout=GRPC_TIMEOUT_S).qos_json)
    _check(status == 200 and rpc == body, f"Qos RPC {rpc} != /v2/qos {body}")
    _check(body["enabled"] and body["queues"]["bert_long"] == {
        "interactive": 0, "batch": 0}, f"/v2/qos after: {body}")
    print(f"tuning: QoS: worker held {TUNE_HOLD_MS} ms, {TUNE_WAVE} batch "
          f"then {TUNE_WAVE} interactive requests queued (one more batch "
          f"shed at level 2's cap); interactive queue ms "
          f"{[round(q, 3) for q in queue_ms['interactive']]} < batch "
          f"{[round(q, 3) for q in queue_ms['batch']]}; "
          f"{len(answered)} answers at most {err:.2e} off their own feeds' "
          f"plain outputs (tolerance {SERVED_ATOL}; distinct feeds' plain "
          f"outputs at least {apart:.2e} apart); /v2/qos == Qos", flush=True)
    return {k: [round(q, 3) for q in v] for k, v in queue_ms.items()}


def _tune_autotune(engine, port: int, seq: int, take) -> dict:
    """2-row requests half fill bucket 4; one tick warms bucket 2 through
    ``warm_bucket`` and promotes it; the census holds the arena's
    reservations as its plan; the recorder's ``hbm_reserved`` is the
    arena's; bucket 2 runs warm."""
    path = "/v2/models/bert_long/infer"
    engine.profiler.reset()
    rng = np.random.default_rng(77)
    for _ in range(TUNE_PAIRS):
        ids = rng.integers(0, 30522, (2, seq)).astype(np.int32)
        status, _, data = _post(port, path,
                                *_binary_request(ids, np.ones_like(ids)))
        _check(status == 200, f"2-row bert_long: HTTP {status}")
    sched = engine.scheduler_for("bert_long")
    _check(sched.bucket_ladder() == [1, 4], f"ladder {sched.bucket_ladder()}")
    take()
    decisions = engine.autotuner.tick()
    warm_launches = take()["flash_attention"]
    _check([(d["action"], d["model"], d["bucket"], d["applied"])
            for d in decisions] == [("add_bucket", "bert_long", 2, True)],
           f"the tuner decided {decisions}")
    layers = len(engine.repository.get("bert_long").backend.layers)
    if engine.device.type == "cuda":
        _check(warm_launches == layers,
               f"warm_bucket launched K1 {warm_launches} times, {layers} "
               "layers")
    _check(sched.bucket_ladder() == [1, 2, 4],
           f"ladder after the tick {sched.bucket_ladder()}")
    arena = engine.autotuner.arena
    _check(arena.get("bucket:bert_long:1:2") is not None,
           "no reservation for the promoted bucket")
    status, census = _get(port, "/v2/memory")
    row = next(r for r in census["owners"]
               if (r["model"], r["component"]) == ("bert_long",
                                                  "autotune_warm"))
    planned = sum(r.nbytes for r in map(arena.get, (
        f"bucket:bert_long:1:{b}" for b in (1, 2, 4))))
    # The arena only plans: the census reads its reservations as the plan
    # and the drift as the plan less the bytes tagged autotune_warm.
    _check(row["plan_bytes"] == planned
           and row["drift_bytes"] == row["plan_bytes"] - row["bytes"],
           f"/v2/memory's autotune_warm row {row}, {planned} B planned")
    sample = engine.recorder.tick()["signals"]
    _check(sample["hbm_reserved"] == arena.reserved_bytes() > 0,
           f"recorder hbm_reserved {sample.get('hbm_reserved')} != arena "
           f"{arena.reserved_bytes()}")
    for _ in range(2):
        ids = rng.integers(0, 30522, (2, seq)).astype(np.int32)
        status, headers, _ = _post(port, path,
                                   *_binary_request(ids, np.ones_like(ids)))
        _check(status == 200 and "compile" not in _timing(headers),
               f"bucket 2: HTTP {status}, timing {_timing(headers)}")
    bucket2 = next(b for b in engine.profile_snapshot()["models"][
        "bert_long:1"]["buckets"] if b["bucket"] == 2)
    _check((bucket2["compilations"], bucket2["cold_executions"],
            bucket2["executions"]) == (1, 0, 2), f"bucket 2 {bucket2}")
    compile_s = decisions[0]["compile_s"]
    print(f"tuning: autotune: {TUNE_PAIRS} 2-row requests in bucket 4, one "
          f"tick promoted bucket 2 (warm_bucket {compile_s} s, {warm_launches}"
          f" K1 launches), ladder [1, 2, 4]; autotune_warm plan {planned} B, "
          f"drift {row['drift_bytes']} B; hbm_reserved "
          f"{arena.reserved_bytes()} B; bucket 2 warm", flush=True)
    return {"warm_bucket_s": compile_s, "warm_bucket_launches": warm_launches,
            "hbm_reserved": arena.reserved_bytes()}


def _tune_selfdrive(engine) -> dict:
    """One tick under a stub's fast burn tightens ``bert_long``; one after
    the quiet hold restores it."""
    from types import SimpleNamespace

    from client_tpu_torch.engine.selfdrive import SelfDriveGovernor

    clock = [1000.0]
    slo = SimpleNamespace(enabled=True, burning=["bert_long"])
    slo.fast_burn = lambda: list(slo.burning)
    view = SimpleNamespace(slo=slo, admission=engine.admission,
                           profiler=engine.profiler,
                           scheduler_for=engine.scheduler_for)
    config = engine.selfdrive.config
    gov = SelfDriveGovernor(view, config, clock=lambda: clock[0])
    burn = gov.tick()["admission"]
    tightened = engine.admission.tightened_models()
    _check([(d["action"], d["model"]) for d in burn]
           == [("tighten", "bert_long")] and tightened == {
               "bert_long": config.burn_factor},
           f"under burn: {burn}, tightened {tightened}")
    slo.burning = []
    clock[0] += config.burn_restore_hold_s
    quiet = gov.tick()["admission"]
    _check([(d["action"], d["model"]) for d in quiet]
           == [("restore", "bert_long")]
           and engine.admission.tightened_models() == {},
           f"after the hold: {quiet}, {engine.admission.tightened_models()}")
    _check("selfdrive" in engine.profile_snapshot(), "no selfdrive section")
    print(f"tuning: self-drive: a burning tick tightened bert_long to "
          f"{config.burn_factor}, a quiet one after {config.burn_restore_hold_s}"
          f" s restored it", flush=True)
    return {"tightened": tightened}


def tuning_phase(torch, smi: str, device: str = "cuda") -> dict:
    """Warm-up, QoS with priority levels, the bucket autotuner with its
    arena and self-drive on one engine with ``bert_long`` (K1 bf16),
    ``tiny_gpt_long`` (K1 fp32, K2) and ``dlrm_mlperf`` (2 shards, K3)
    behind HTTP and gRPC. Returns each kernel's launches. ``device`` is
    for a dry run of the phase's logic on the CPU."""
    from client_tpu_torch.engine import TorchEngine
    from client_tpu_torch.engine.config import (
        DynamicBatchingConfig,
        QueuePolicy,
    )
    from client_tpu_torch.engine.generative import GenerativeScheduler
    from client_tpu_torch.engine.model import Model
    from client_tpu_torch.engine.repository import ModelRepository
    from client_tpu_torch.models import _REGISTRY
    from client_tpu_torch.models.dlrm import DlrmBackend
    from client_tpu_torch.observability.costs import ledger
    from client_tpu_torch.observability.events import journal
    from client_tpu_torch.observability.memory import reset_hbm_census
    from client_tpu_torch.observability.profiler import profiler
    from client_tpu_torch.ops import decode_attention as da
    from client_tpu_torch.ops import flash_attention as fa
    from client_tpu_torch.parallel import kv_shard as ks
    from client_tpu_torch.server import (
        GrpcInferenceServer,
        HttpInferenceServer,
    )

    t_phase = time.monotonic()
    device = torch.device(device)
    cuda = device.type == "cuda"

    def bert(dev):
        backend = _REGISTRY["bert_long"](dev)
        cfg = backend.config
        cfg.instance_count = 1
        cfg.batch_buckets = [1, cfg.max_batch_size]
        cfg.dynamic_batching = DynamicBatchingConfig(
            preferred_batch_size=[cfg.max_batch_size],
            max_queue_delay_microseconds=500, priority_levels=2,
            default_priority_level=2,
            priority_queue_policy={2: QueuePolicy(
                max_queue_size=TUNE_LEVEL_CAP)})
        return backend

    repo = ModelRepository()
    repo.register("bert_long", bert)
    repo.register("tiny_gpt_long", _REGISTRY["tiny_gpt_long"])
    repo.register(DLRM_MODEL, lambda dev: DlrmBackend(
        name=DLRM_MODEL, device=dev, emb_devices=[dev] * 2, **MLPERF_DLRM))
    reset_hbm_census()
    profiler().reset()
    ledger().reset()
    # The seconds each model's warm-up takes, timed around the engine's
    # own calls.
    warm_s: dict[str, float] = {}

    def timed(fn, name_of):
        def run(self):
            t0 = time.monotonic()
            fn(self)
            key = name_of(self)
            warm_s[key] = round(warm_s.get(key, 0.0)
                                + time.monotonic() - t0, 3)
        return run

    model_warmup = Model.warmup
    sched_warmup = GenerativeScheduler.warmup
    Model.warmup = timed(model_warmup, lambda m: m.config.name)
    GenerativeScheduler.warmup = timed(sched_warmup,
                                       lambda s: s.model.config.name)
    total = dict.fromkeys(("flash_attention", "flash_attention_fp32",
                           "decode_wave_attention", "ring_all_reduce"), 0)

    def take() -> dict:
        """The launches since the last take, added to the phase's."""
        now = {"flash_attention": fa.launches,
               "flash_attention_fp32": fa.launches_fp32,
               "decode_wave_attention": da.launches,
               "ring_all_reduce": ks.launches}
        fa.launches = fa.launches_fp32 = da.launches = ks.launches = 0
        for k, v in now.items():
            total[k] += v
        return now

    fa.launches = fa.launches_fp32 = da.launches = ks.launches = 0
    since = journal().export(limit=0)["next_seq"]
    try:
        with _Env(CLIENT_TPU_QOS=json.dumps(TUNE_QOS),
                  CLIENT_TPU_AUTOTUNE=TUNE_AUTOTUNE,
                  CLIENT_TPU_SELFDRIVE=TUNE_SELFDRIVE):
            engine = TorchEngine(repo, device=device, warmup=True)
    finally:
        Model.warmup = model_warmup
        GenerativeScheduler.warmup = sched_warmup
    warm = take()
    server = HttpInferenceServer(engine, port=0).start()
    grpc_server = GrpcInferenceServer(engine, port=0).start()
    channel, stub = _grpc_channel(grpc_server.url)
    print(f"tuning: bert_long, tiny_gpt_long, {DLRM_MODEL} warmed and up in "
          f"{time.monotonic() - t_phase:.1f} s on {device}; warm-up seconds "
          f"{warm_s}; warm-up launches {warm}", flush=True)
    try:
        index = {e["name"]: e["state"] for e in engine.repository_index()}
        failed = [e for e in engine.events_export(
            category="lifecycle", since_seq=since)["events"]
            if e["name"] == "model_load_failed"]
        _check(set(index.values()) == {"READY"} and not failed,
               f"index {index}, failed loads {failed}")
        bert_model = engine.repository.get("bert_long")
        layers = len(bert_model.backend.layers)
        ladders = {m: engine.repository.get(m).config.effective_buckets()
                   for m in ("bert_long", DLRM_MODEL)}
        if cuda:
            _check(warm["flash_attention"]
                   == layers * len(ladders["bert_long"]),
                   f"warm-up: K1 bf16 {warm['flash_attention']} launches, "
                   f"{layers} layers x {ladders['bert_long']}")
            _check(warm["flash_attention_fp32"] > 0
                   and warm["decode_wave_attention"] > 0,
                   f"the generative warm-up launched {warm}")
            _check(warm["ring_all_reduce"] == len(ladders[DLRM_MODEL]),
                   f"warm-up: K3 {warm['ring_all_reduce']} launches, "
                   f"{len(ladders[DLRM_MODEL])} {DLRM_MODEL} buckets")
        status, prof = _get(server.port, "/v2/profile")
        _check(status == 200, f"/v2/profile: HTTP {status}")
        for model, ladder in ladders.items():
            rows = {b["bucket"]: (b["compilations"], b["cold_executions"],
                                  b["executions"])
                    for b in prof["models"][f"{model}:1"]["buckets"]}
            _check(rows == {b: (1, 0, 0) for b in ladder},
                   f"{model}'s warm buckets in /v2/profile: {rows}")
        gpt = engine.scheduler_for("tiny_gpt_long")
        waves = {w["bucket"] for w in prof["models"]["tiny_gpt_long:1"]
                 ["decode_waves"]}
        _check(waves == set(gpt._wave_buckets),
               f"tiny_gpt_long's warmed wave shapes {waves}")
        seq = bert_model.config.input[0].dims[0]
        ids, mask = _obs_bert_inputs(seq, 50)
        status, headers, data = _post(server.port,
                                      "/v2/models/bert_long/infer",
                                      *_binary_request(ids, mask))
        first = _timing(headers)
        _check(status == 200 and "compile" not in first,
               f"the first request: HTTP {status}, timing {first}")
        # The other models' traffic: no execution or dispatch is cold.
        rng = np.random.default_rng(88)
        for plen in TUNE_STREAMS:
            plen = min(plen, gpt._max_seq - TUNE_TOKENS - 1)
            tokens, _, _ = _stream(server.port, "tiny_gpt_long", {
                "inputs": [{"name": "INPUT_IDS", "datatype": "INT32",
                            "shape": [plen], "data": rng.integers(
                                0, 256, plen).tolist()}],
                "parameters": {"max_tokens": TUNE_TOKENS}})
            _check(len(tokens) == TUNE_TOKENS, f"{plen}: {len(tokens)}")
        for i in range(TUNE_DLRM):
            code, out = _grpc_infer(stub, DLRM_MODEL, _mlperf_csr(rng))
            _check(code.name == "OK" and np.isfinite(
                out["OUTPUT0"]).all(), f"{DLRM_MODEL} over gRPC: {code}")
        before = _samples(_scrape(server.port))
        take()
        queue_ms = _tune_qos(torch, engine, server.port, stub, seq,
                             bert_model.backend, device)
        after = _samples(_scrape(server.port))
        executions = int(_sample_sum(after, "tpu_inference_exec_count",
                                     model="bert_long")
                         - _sample_sum(before, "tpu_inference_exec_count",
                                       model="bert_long"))
        _check(executions == 3, f"{executions} bert_long executions: the "
               "held one and two waves")
        qos_launches = take()["flash_attention"]
        if cuda:
            _check(qos_launches == layers * executions,
                   f"QoS: K1 {qos_launches} launches, {layers} x "
                   f"{executions} executions on /metrics")
        buckets, gen = _cold_table(engine)
        cold = [(m, b) for m, rows in buckets.items() for b in rows
                if b[1] != 1 or b[2] != 0]
        cold += [(m, w) for m, rows in gen.items() for w in rows if w[3]]
        _check(not cold, f"cold under traffic: {cold}")
        tuned = _tune_autotune(engine, server.port, seq, take)
        driven = _tune_selfdrive(engine)
        # The first request without warm-up: bert_long reloaded cold.
        engine._warmup = False
        try:
            engine.unload_model("bert_long")
            engine.load_model("bert_long")
        finally:
            engine._warmup = True
        status, headers, _ = _post(server.port, "/v2/models/bert_long/infer",
                                   *_binary_request(ids, mask))
        unwarmed = _timing(headers)
        _check(status == 200 and "compile" in unwarmed,
               f"an unwarmed first request: HTTP {status}, {unwarmed}")
        take()
        launches = dict(total)
        if cuda:
            _check(all(v > 0 for v in launches.values()),
                   f"a kernel of the path did not launch: {launches}")
        observation = {
            "card": smi, "warm_s": warm_s,
            "first_compute_infer_ms": {
                "warmup": first["compute_infer"],
                "no_warmup": unwarmed["compute_infer"],
                "no_warmup_compile": unwarmed["compile"]},
            "warm_bucket_s": tuned["warm_bucket_s"],
            "queue_ms": queue_ms,
            "hbm_reserved": tuned["hbm_reserved"],
            "tightened": driven["tightened"]}
        print(f"tuning observation: {json.dumps(observation)}", flush=True)
        print(f"tuning: phase passed in {time.monotonic() - t_phase:.1f} s; "
              f"launches {launches}; {smi}", flush=True)
        return launches
    finally:
        channel.close()
        grpc_server.stop()
        server.stop()
        engine.shutdown()


# -- incident phase -----------------------------------------------------------

INC_STORM = 5           # expired requests that make a burst ...
INC_STORM_WINDOW_S = 10.0   # ... inside this window
# The blackbox in the child: the burst trigger alone, so that no other edge
# (memory pressure under three full-size models) takes the debounce first.
INC_BLACKBOX = {"triggers": ["deadline.burst"], "storm_count": INC_STORM,
                "storm_window_s": INC_STORM_WINDOW_S, "post_window_s": 1.0,
                "debounce_s": 30.0, "cooldown_s": 300.0}
INC_ONE = 4             # bert_long spans of one slot, wires alternating
INC_SPAN = 4            # bert_long slots of the held span (max_batch_size)
INC_TIMED = 16          # sequential requests of each path, timed
INC_HOLD_MS = 1500      # model.execute latency that holds bert_long's worker
INC_DLRM = 8            # dlrm_mlperf requests through the reaped ring
INC_STREAMS = (5, 60, 300, 900)  # tiny_gpt_long prompt lengths in the burst
INC_TOKENS = 96
INC_SWEEPS = 2000       # idle reaper sweeps timed
INC_CHILD_TIMEOUT_S = 600
LOCKDEP_WORDS = ("LockOrderViolation", "BlockingUnderLock")

# The producer the incident phase kills: a reaped ring of bert_long with
# two slots filled, then nothing (the port's client and ring utilities
# only).
_INC_DEAD_PRODUCER = r"""
import sys, time
import numpy as np
import client_tpu_torch.http as httpclient
from client_tpu_torch.utils.shm_ring import RingBuffer

url, name, key, seq = sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4])
ring = RingBuffer.create(key, 4, 8 * seq, 16 * seq + 4096)
metas = [{"name": n, "datatype": "INT32", "shape": [1, seq],
          "offset": i * 4 * seq, "byte_size": 4 * seq}
         for i, n in enumerate(("input_ids", "attention_mask"))]
httpclient.InferenceServerClient(url).register_shm_ring(
    name, key, spec={"model_name": "bert_long", "inputs": metas})
for i in range(2):
    ring.fill({"input_ids": np.full((1, seq), 7 + i, np.int32),
               "attention_mask": np.ones((1, seq), np.int32)})
print("filled", flush=True)
time.sleep(600)
"""


def _inc_ring(torch, engine, port: int, hc, gc, backend, seq: int,
              device) -> dict:
    """``bert_long`` through slot rings: spans of one slot (doorbells over
    HTTP and gRPC, wires alternating), then a span of ``INC_SPAN`` queued
    behind a held worker; every answer byte for byte the same request's
    over binary HTTP and within ``SERVED_ATOL`` of the plain path; then
    the paths timed, one request at a time."""
    from client_tpu_torch import faults
    from client_tpu_torch.utils.shm_ring import RingProducer

    sched = engine.scheduler_for("bert_long")
    path = "/v2/models/bert_long/infer"
    feeds = [_obs_bert_inputs(seq, 200 + i) for i in range(INC_ONE + INC_SPAN)]

    def over_http(i):
        status, headers, data = _post(port, path, *_binary_request(*feeds[i]))
        _check(status == 200, f"bert_long: HTTP {status}: {data[:200]}")
        return _parse_response(headers, data)

    def slot(i):
        ids, mask = feeds[i]
        return {"input_ids": ids, "attention_mask": mask}

    def reap(prod):
        _, outs, err = prod.reap(timeout_s=GRPC_TIMEOUT_S, copy=True)
        _check(err is None, f"bert_long slot: {err}")
        return outs

    def held(submit_queued, n):
        """Hold every worker with a request over HTTP, queue ``n`` more
        through ``submit_queued`` (in order), release: the first worker
        free takes the ``n`` as one batch. Returns their answers."""
        workers = len(sched.workers)
        faults.configure({"model.execute": {"latency_ms": INC_HOLD_MS}})
        try:
            with concurrent.futures.ThreadPoolExecutor(n + workers) as pool:
                holds = []
                for w in range(workers):
                    holds.append(pool.submit(over_http, 0))
                    _wait_for(lambda: sched.active_batches == w + 1,
                              f"bert_long worker {w} held")
                answers = submit_queued(pool)
                _wait_for(lambda: sched.queue.qsize() == n,
                          f"{n} bert_long requests queued")
                faults.reset()
                for h in holds:
                    h.result()
                return [a() for a in answers]
        finally:
            faults.reset()

    tag = os.getpid()
    slot_bytes = 8 * seq
    rings = {
        "http": RingProducer(hc, "inc_http", f"/chip_smoke_inc_http_{tag}",
                             slot_count=8, slot_bytes=slot_bytes),
        "grpc": RingProducer(gc, "inc_grpc", f"/chip_smoke_inc_grpc_{tag}",
                             slot_count=8, slot_bytes=slot_bytes)}
    for prod in rings.values():
        prod.__enter__()
    try:
        ring_out = {}
        for i in range(INC_ONE):
            prod = rings["http" if i % 2 == 0 else "grpc"]
            prod.fill(slot(i))
            _check(prod.doorbell("bert_long")["admitted"] == 1,
                   "a one-slot doorbell")
            ring_out[i] = reap(prod)
        http_out = {i: over_http(i) for i in range(INC_ONE)}
        span = list(range(INC_ONE, INC_ONE + INC_SPAN))

        def ring_span(pool):
            prod = rings["grpc"]
            for i in span:
                prod.fill(slot(i))
            _check(prod.doorbell("bert_long")["admitted"] == INC_SPAN,
                   f"a {INC_SPAN}-slot doorbell over gRPC")
            return [lambda: reap(prod) for _ in span]

        def http_span(pool):
            futs = []
            for k, i in enumerate(span):
                futs.append(pool.submit(over_http, i))
                _wait_for(lambda: sched.queue.qsize() == k + 1,
                          f"HTTP request {k} queued")
            return [f.result for f in futs]

        ring_out.update(zip(span, held(ring_span, INC_SPAN)))
        http_out.update(zip(span, held(http_span, INC_SPAN)))
        for i in ring_out:
            for n in BERT_OUTPUTS:
                _check(ring_out[i][n].dtype == http_out[i][n].dtype
                       and ring_out[i][n].tobytes()
                       == http_out[i][n].tobytes(),
                       f"bert_long feed {i} {n}: the ring's answer differs "
                       "from binary HTTP's")
        # _bert_err fails the run past SERVED_ATOL.
        err = max(_bert_err(ring_out[i], _bert_plain(torch, backend,
                                                      *feeds[i], device))
                  for i in ring_out)

        # Timed, one request at a time: binary HTTP against one-slot spans.
        t0 = time.perf_counter()
        for k in range(INC_TIMED):
            over_http(k % len(feeds))
        http_us = (time.perf_counter() - t0) / INC_TIMED * 1e6
        prod = rings["http"]
        t0 = time.perf_counter()
        for k in range(INC_TIMED):
            prod.fill(slot(k % len(feeds)))
            prod.doorbell("bert_long")
            reap(prod)
        ring_us = (time.perf_counter() - t0) / INC_TIMED * 1e6
        t0 = time.perf_counter()
        for k in range(0, INC_TIMED, INC_SPAN):
            for j in range(INC_SPAN):
                prod.fill(slot((k + j) % len(feeds)))
            prod.doorbell("bert_long")
            for _ in range(INC_SPAN):
                reap(prod)
        span_us = (time.perf_counter() - t0) / INC_TIMED * 1e6
        status = {w: p._client.get_shm_ring_status(f"inc_{w}")[f"inc_{w}"]
                  for w, p in rings.items()}
    finally:
        for prod in rings.values():
            prod.__exit__(None, None, None)
    _check(status["grpc"]["slots_ok"] == INC_ONE // 2 + INC_SPAN
           and status["http"]["slots_ok"]
           == INC_ONE - INC_ONE // 2 + 2 * INC_TIMED,
           f"ring status {status}")
    print(f"incident: bert_long through slot rings: {INC_ONE} one-slot "
          f"doorbells over HTTP and gRPC and a {INC_SPAN}-slot span behind a "
          f"held worker, each answer byte for byte binary HTTP's; at most "
          f"{err:.4g} off the plain path (tolerance {SERVED_ATOL}); wall per "
          f"request, one at a time: binary HTTP {http_us:.1f} us, one-slot "
          f"doorbell {ring_us:.1f} us, {INC_SPAN}-slot spans {span_us:.1f} "
          "us a slot", flush=True)
    return {"http_us_per_request": round(http_us, 1),
            "ring_us_per_slot": round(ring_us, 1),
            "ring_span_us_per_slot": round(span_us, 1)}


def _dlrm_plain(torch, backend, reqs: list) -> list:
    """Each request's ``dlrm_mlperf`` score by the plain path: the bag sums
    of the whole table on one device (``bag_sum_oracle``, no K3), then the
    backend's own MLPs and interaction, as ``DlrmBackend.forward``."""
    from client_tpu_torch.models.dlrm import _mlp
    from client_tpu_torch.parallel.emb_shard import bag_sum_oracle

    dev = backend.device
    b_max = backend.config.max_batch_size
    t, d = backend.num_tables, backend.emb_dim
    out = []
    with torch.inference_mode():
        whole = torch.from_numpy(backend.table_host).to(dev)
        for req in reqs:
            st = {k: torch.from_numpy(v).to(dev)
                  for k, v in backend.pre_stage(req, None).items()}
            pooled = bag_sum_oracle(whole, st["INDICES"], st["SEG_IDS"],
                                    b_max * t).reshape(b_max, t, d)
            bottom = _mlp(backend.bottom, st["DENSE"])
            feats = torch.cat([bottom[:, None, :], pooled], dim=1)
            z = torch.bmm(feats, feats.transpose(1, 2))
            inter = z[:, backend.pair_i, backend.pair_j]
            score = _mlp(backend.top, torch.cat([bottom, inter], dim=-1))
            out.append(score[:1].cpu().numpy())
    del whole
    return out


def _inc_staged(torch, engine, port: int, hc) -> dict:
    """``dlrm_mlperf`` through a reaped ring whose slots hold staged
    descriptors into one registered dataset, one request at a time; each
    score byte for byte the binary HTTP one and within ``DLRM_ATOL`` of the
    plain path (:func:`_dlrm_plain`). Then the idle reaper's sweep
    timed."""
    from client_tpu_torch.utils.shm_ring import (
        RingProducer,
        staged_inputs_meta,
    )
    from client_tpu_torch.utils.shm_ring.staged import build_staged_dataset

    rng = np.random.default_rng(77)
    reqs = [_mlperf_csr(rng) for _ in range(INC_DLRM)]
    starts = np.concatenate([[0], np.cumsum([len(r["INDICES"])
                                             for r in reqs])])
    n_off = len(reqs[0]["OFFSETS"])
    tensors = {name: np.concatenate([r[name] for r in reqs])
               for name in ("DENSE", "INDICES", "OFFSETS")}

    def refs(r):
        return {"DENSE": ("DENSE", r, 1),
                "INDICES": ("INDICES", int(starts[r]),
                            int(starts[r + 1] - starts[r])),
                "OFFSETS": ("OFFSETS", r * n_off, n_off)}

    tag = os.getpid()
    ds = build_staged_dataset(f"/chip_smoke_inc_ds_{tag}", tensors)
    got = []
    try:
        hc.register_staged_dataset("inc_ds", ds.key)
        spec = {"model_name": DLRM_MODEL,
                "inputs": staged_inputs_meta(refs(0)), "dataset": "inc_ds"}
        with RingProducer(hc, "inc_dlrm", f"/chip_smoke_inc_dlrm_{tag}",
                          slot_count=4, slot_bytes=4096, dataset=ds,
                          dataset_name="inc_ds", spec=spec) as prod:
            for r in range(INC_DLRM):
                _check(prod.fill_staged(refs(r)) is not None,
                       "the dlrm ring is full")
                _, outs, err = prod.reap(timeout_s=GRPC_TIMEOUT_S)
                _check(err is None, f"{DLRM_MODEL} slot {r}: {err}")
                got.append(outs["OUTPUT0"])
            mgr = engine.ring_shm
            t0 = time.perf_counter()
            for _ in range(INC_SWEEPS):
                mgr._sweep_once(mgr._reaper_span)
            sweep_us = (time.perf_counter() - t0) / INC_SWEEPS * 1e6
            status = hc.get_shm_ring_status("inc_dlrm")["inc_dlrm"]
        refs_total = hc.get_staged_dataset_status("inc_ds")["inc_ds"]["refs"]
        hc.unregister_staged_dataset("inc_ds")
    finally:
        ds.close(unlink=True)
    for r, req in enumerate(reqs):
        status_code, out = _http_infer(port, DLRM_MODEL, req, True)
        _check(status_code == 200 and np.isfinite(out["OUTPUT0"]).all()
               and got[r].tobytes() == out["OUTPUT0"].tobytes(),
               f"{DLRM_MODEL} request {r}: the staged slot's score "
               f"{got[r]} != binary HTTP's {out}")
    plain = _dlrm_plain(torch, engine.repository.get(DLRM_MODEL).backend,
                        reqs)
    worst = max(float(np.abs(g - p).max()) for g, p in zip(got, plain))
    _check(worst <= DLRM_ATOL, f"{DLRM_MODEL}: the staged slots' scores are "
           f"{worst} off the plain path (tolerance {DLRM_ATOL})")
    _check(status["reaped"] and status["reap_slots"] == INC_DLRM
           and status["doorbells"] == 0 and refs_total == 3 * INC_DLRM,
           f"reaped ring {status}, {refs_total} descriptors resolved")
    print(f"incident: {INC_DLRM} {DLRM_MODEL} requests through a reaped ring "
          f"of staged descriptors (no doorbell), each score byte for byte "
          f"binary HTTP's and at most {worst:.4g} off the plain path "
          f"(tolerance {DLRM_ATOL}); an idle sweep {sweep_us:.2f} us",
          flush=True)
    return {"reaper_sweep_us": round(sweep_us, 2)}


def _inc_dead_producer(engine, server, seq: int) -> dict:
    """A producer process killed with two slots of its reaped ring in
    flight (the worker held): the slots are failed in the segment, the
    ring detached, both edges in the journal."""
    from client_tpu_torch import faults
    from client_tpu_torch.utils.shm_ring import SLOT_DONE, RingBuffer

    sched = engine.scheduler_for("bert_long")
    key = f"/chip_smoke_inc_dead_{os.getpid()}"
    root = Path(__file__).resolve().parent
    cursor = engine.events_export(limit=0)["next_seq"]
    workers = len(sched.workers)
    faults.configure({"model.execute": {"latency_ms": INC_HOLD_MS}})
    proc = None
    try:
        with concurrent.futures.ThreadPoolExecutor(workers) as pool:
            ids, mask = _obs_bert_inputs(seq, 300)
            holds = []
            for w in range(workers):
                holds.append(pool.submit(
                    _post, server.port, "/v2/models/bert_long/infer",
                    *_binary_request(ids, mask)))
                _wait_for(lambda: sched.active_batches == w + 1,
                          f"bert_long worker {w} held")
            proc = subprocess.Popen(
                [sys.executable, "-c", _INC_DEAD_PRODUCER, server.url,
                 "inc_dead", key, str(seq)], stdout=subprocess.PIPE,
                cwd=root, env=dict(os.environ, PYTHONPATH=str(root)))
            _check(proc.stdout.readline().strip() == b"filled",
                   "the producer process did not fill its slots")
            _wait_for(lambda: sched.queue.qsize() == 2,
                      "the dead producer's slots queued")
            pid = proc.pid
            proc.kill()
            proc.wait(timeout=30)
            _wait_for(lambda: "inc_dead" not in engine.ring_shm.status(),
                      "the dead producer's ring reclaimed", timeout_s=30)
            faults.reset()
            statuses = [h.result()[0] for h in holds]
            _check(statuses == [200] * workers,
                   f"the held requests: HTTP {statuses}")
        seg = RingBuffer.attach(key)
        try:
            failed = [(seg.state(s), seg.read_response(s)[1])
                      for s in (0, 1)]
        finally:
            seg.close()
    finally:
        faults.reset()
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        try:
            os.unlink("/dev/shm/" + key.lstrip("/"))
        except FileNotFoundError:
            pass
    _check(all(state == SLOT_DONE and "detached" in (err or "")
               for state, err in failed),
           f"the dead producer's slots: {failed}")
    edges = {e["name"]: e["detail"] for e in engine.events_export(
        category="shm_ring", since_seq=cursor)["events"]}
    _check(edges.get("producer_dead", {}).get("pid") == pid
           and edges.get("detach_inflight", {}).get("slots") == 2,
           f"shm_ring journal after the kill: {edges}")
    _wait_for(lambda: sched.queue.qsize() == 0 and sched.active_batches == 0,
              "bert_long idle")
    print(f"incident: producer {pid} killed with 2 slots in flight: both "
          f"failed in its segment ({failed[0][1]!r}), its ring detached, "
          "shm_ring.producer_dead and detach_inflight journaled", flush=True)
    return {}


def _inc_burst(torch, engine, port: int, seq: int, device) -> dict:
    """``INC_STORM`` expired ``bert_long`` requests while tiny_gpt_long
    streams run: exactly one ``deadline.burst`` bundle; a second burst
    inside the cooldown is suppressed; the streams token for token
    against the plain path."""
    from client_tpu_torch.models.generate import TinyGptBackend

    rec = engine.blackbox
    gpt = engine.scheduler_for("tiny_gpt_long")
    rng = np.random.default_rng(99)
    prompts = [rng.integers(0, 512, min(n, gpt._max_seq - INC_TOKENS - 1))
               .tolist() for n in INC_STREAMS]
    ids, mask = _obs_bert_inputs(seq, 400)
    expired = _binary_request(ids, mask)

    def burst() -> list[int]:
        return [_post(port, "/v2/models/bert_long/infer", expired[0],
                      dict(expired[1], **{"timeout-ms": "0.001"}))[0]
                for _ in range(INC_STORM)]

    before = (rec.captures, rec.suppressed)
    with concurrent.futures.ThreadPoolExecutor(len(prompts)) as pool:
        streams = [pool.submit(_stream, port, "tiny_gpt_long", {
            "inputs": [{"name": "INPUT_IDS", "datatype": "INT32",
                        "shape": [len(p)], "data": p}],
            "parameters": {"max_tokens": INC_TOKENS}}) for p in prompts]
        _wait_for(lambda: len(gpt._free) <= len(gpt._rows_init)
                  - len(prompts), "the streams admitted")
        first = burst()
        t_burst = time.monotonic()
        _wait_for(lambda: rec.captures == before[0] + 1,
                  "the deadline.burst capture", timeout_s=60)
        second = burst()
        served = [f.result() for f in streams]
    _check(first == second == [504] * INC_STORM,
           f"expired requests answered {first} and {second}")
    _check(rec.captures == before[0] + 1
           and rec.suppressed == before[1] + 1,
           f"captures {rec.captures}, suppressed {rec.suppressed} after two "
           f"bursts (before {before})")
    _check(all(len(toks) == INC_TOKENS and times[-1] > t_burst
               for toks, times, _ in served),
           "a stream was not running through the burst: "
           f"{[(len(t), tm[-1] - t_burst) for t, tm, _ in served]}")
    oracle = TinyGptBackend(name="tiny_gpt_long", attention_impl="einsum",
                            attn_impl="reference", device=device,
                            max_seq_len=gpt._max_seq, max_streams=gpt._cap)
    arena = oracle.init_arena(1)
    for prompt, (toks, _, _) in zip(prompts, served):
        want = _direct_stream(torch, oracle, arena, prompt, INC_TOKENS, {},
                              device=device.type)
        _check(toks == want, f"a stream, prompt of {len(prompt)}: {toks} "
               f"!= direct {want}")
    bursts = [m for m in rec.store.list() if m["trigger"] == "deadline.burst"]
    _check(len(bursts) == 1, f"deadline.burst bundles: {bursts}")
    print(f"incident: {INC_STORM} expired bert_long requests (504) during "
          f"{len(prompts)} tiny_gpt_long streams: one deadline.burst bundle "
          f"{bursts[0]['id']} ({bursts[0]['capture_ms']} ms, "
          f"{bursts[0]['bytes']} B); a second burst suppressed; every "
          f"stream {INC_TOKENS} tokens token for token against the plain "
          "path", flush=True)
    return bursts[0]


def _inc_bundles(engine, port: int, stub, hc, gc, burst: dict) -> dict:
    """Manual captures over HTTP and gRPC; the index equal over both; no
    section of a bundle holds an error; each bundle's memory owners are
    ``/v2/memory``'s; ``tools/blackbox_report.py`` renders the burst's
    bundle."""
    from client_tpu_torch.protocol import ops_pb2

    root = Path(__file__).resolve().parent
    manual = [hc.capture_bundle(note="incident phase, over HTTP"),
              gc.capture_bundle(note="incident phase, over gRPC")]
    status, index = _get(port, "/v2/debug/bundles")
    rpc = json.loads(stub.BlackboxBundles(ops_pb2.BlackboxBundlesRequest(),
                                          timeout=GRPC_TIMEOUT_S)
                     .bundles_json)
    _check(status == 200 and rpc == index and rpc == hc.get_bundles()
           == gc.get_bundles(), "/v2/debug/bundles and BlackboxBundles "
           "differ")
    _check([b["id"] for b in index["bundles"]] == [
        manual[1]["id"], manual[0]["id"], burst["id"]],
        f"the bundle index {index['bundles']}")
    _, memory = _get(port, "/v2/memory")
    for meta in [burst] + manual:
        bundle = gc.get_bundles(meta["id"])
        _check(bundle == hc.get_bundles(meta["id"]),
               f"{meta['id']} differs over the two wires")
        bad = {k: v for k, v in bundle["sections"].items()
               if not isinstance(v, dict) or "error" in v}
        _check(not bad and not bundle["truncated"],
               f"{meta['id']}: sections {bad}, truncated "
               f"{bundle['truncated']}")
        _check(bundle["sections"]["memory"]["owners"] == memory["owners"],
               f"{meta['id']}: memory owners differ from /v2/memory's")
    path = Path(engine.blackbox.store.directory) / f"{burst['id']}.json"
    report = subprocess.run(
        [sys.executable, str(root / "tools" / "blackbox_report.py"),
         str(path)], capture_output=True, text=True, timeout=120, cwd=root)
    _check(report.returncode == 0 and "deadline.burst" in report.stdout,
           f"blackbox_report exited {report.returncode}: "
           f"{report.stderr[-2000:]}")
    metrics = _scrape(port)
    _check('tpu_blackbox_captures_total{trigger="deadline.burst"} 1'
           in metrics and 'tpu_blackbox_captures_total{trigger="manual"} 2'
           in metrics, "tpu_blackbox_captures_total on /metrics")
    print(f"incident: manual captures over HTTP and gRPC "
          f"({manual[0]['capture_ms']} and {manual[1]['capture_ms']} ms); "
          f"/v2/debug/bundles == BlackboxBundles ({len(index['bundles'])} "
          f"bundles, {index['total_bytes']} B); no section with an error; "
          f"memory owners == /v2/memory's; blackbox_report rendered "
          f"{burst['id']} ({len(report.stdout.splitlines())} lines)",
          flush=True)
    return {"manual_capture_ms": [m["capture_ms"] for m in manual],
            "total_bytes": index["total_bytes"]}


def incident_run(torch, smi: str, workdir: Path,
                 device: str = "cuda") -> dict:
    """The incident phase's body, in the process started with
    ``CLIENT_TPU_LOCKDEP=1``: the slot ring, staged datasets and the
    blackbox on one engine with ``bert_long`` (K1 bf16), ``tiny_gpt_long``
    (K1 fp32, K2) and ``dlrm_mlperf`` (2 shards, K3) behind HTTP and
    gRPC. Returns each kernel's launches, the lock-order graph's size and
    the observation. ``device`` is for a dry run of the phase's logic on
    the CPU."""
    import client_tpu_torch.grpc as grpcclient
    import client_tpu_torch.http as httpclient
    from client_tpu_torch.engine import TorchEngine
    from client_tpu_torch.models import build_repository
    from client_tpu_torch.models.dlrm import DlrmBackend
    from client_tpu_torch.ops import decode_attention as da
    from client_tpu_torch.ops import flash_attention as fa
    from client_tpu_torch.parallel import kv_shard as ks
    from client_tpu_torch.server import (
        GrpcInferenceServer,
        HttpInferenceServer,
    )
    from client_tpu_torch.utils import lockdep

    t_phase = time.monotonic()
    device = torch.device(device)
    os.environ["CLIENT_TPU_BLACKBOX"] = json.dumps(
        dict(INC_BLACKBOX, dir=str(workdir / "bundles")))
    repo = build_repository(["bert_long", "tiny_gpt_long"])
    repo.register(DLRM_MODEL, lambda dev: DlrmBackend(
        name=DLRM_MODEL, device=dev, emb_devices=[dev] * 2, **MLPERF_DLRM))
    engine = TorchEngine(repo, device=device)
    engine.profiler.reset()
    server = HttpInferenceServer(engine, port=0).start()
    grpc_server = GrpcInferenceServer(engine, port=0).start()
    channel, stub = _grpc_channel(grpc_server.url)
    hc = httpclient.InferenceServerClient(server.url)
    gc = grpcclient.InferenceServerClient(grpc_server.url)
    models = ("bert_long", "tiny_gpt_long", DLRM_MODEL)
    print(f"incident: {list(models)} up in {time.monotonic() - t_phase:.1f}"
          f" s on {device}, lockdep {'on' if lockdep.enabled() else 'off'}",
          flush=True)
    try:
        backend = engine.repository.get("bert_long").backend
        seq = engine.repository.get("bert_long").config.input[0].dims[0]
        before = _samples(_scrape(server.port))
        fa.launches = fa.launches_fp32 = da.launches = ks.launches = 0
        timed = _inc_ring(torch, engine, server.port, hc, gc, backend, seq,
                          device)
        swept = _inc_staged(torch, engine, server.port, hc)
        _inc_dead_producer(engine, server, seq)
        burst = _inc_burst(torch, engine, server.port, seq, device)
        launches = {"flash_attention": fa.launches,
                    "flash_attention_fp32": fa.launches_fp32,
                    "decode_wave_attention": da.launches,
                    "ring_all_reduce": ks.launches}
        captured = _inc_bundles(engine, server.port, stub, hc, gc, burst)
        after = _samples(_scrape(server.port))
        execs = {m: int(_sample_sum(after, "tpu_inference_exec_count",
                                    model=m)
                        - _sample_sum(before, "tpu_inference_exec_count",
                                      model=m)) for m in models}
        _, snap = _get(server.port, "/v2/profile?model=tiny_gpt_long")
        waves = sum(w["dispatches"] for w in snap["models"][
            "tiny_gpt_long:1"]["decode_waves"])
        gpt = engine.repository.get("tiny_gpt_long").backend
        per = {"flash_attention": (len(backend.layers), execs["bert_long"]),
               "flash_attention_fp32": (gpt.n_layers,
                                        execs["tiny_gpt_long"] - waves),
               "decode_wave_attention": (gpt.n_layers, waves),
               "ring_all_reduce": (1, execs[DLRM_MODEL])}
        if device.type == "cuda":
            for name, (k, n) in per.items():
                _check(launches[name] == k * n > 0,
                       f"{name}: {launches[name]} launches, {k} x {n} "
                       "executions read on /metrics")
        graph = lockdep.graph()
        nodes = set(graph) | {s for v in graph.values() for s in v}
        edges = sum(len(v) for v in graph.values())
        print(f"incident: launches {launches} = per-execution counts x "
              f"executions on /metrics {per}", flush=True)
        print(f"incident: lockdep graph {len(nodes)} nodes, {edges} edges",
              flush=True)
        observation = {"card": smi, **timed, **swept,
                       "capture_ms": burst["capture_ms"],
                       "bundle_bytes": burst["bytes"], **captured,
                       "lockdep_nodes": len(nodes), "lockdep_edges": edges}
    finally:
        hc.close()
        gc.close()
        channel.close()
        grpc_server.stop()
        server.stop()
        engine.shutdown()
    # Read after shutdown: a violation raised where the caller swallows it
    # (a journal sink, a frontend's handler) is still on this record.
    found = lockdep.violations()
    print(f"incident: lockdep recorded {len(found)} violations through "
          "shutdown", flush=True)
    _check(not found, f"lockdep violations in the incident child: {found}")
    observation["lockdep_violations"] = len(found)
    print(f"incident observation: {json.dumps(observation)}", flush=True)
    print(f"incident: phase body passed in "
          f"{time.monotonic() - t_phase:.1f} s; {smi}", flush=True)
    return {"launches": launches, "observation": observation}


def incident_child(argv: list[str]) -> int:
    """``--incident-child WORKDIR``: :func:`incident_run` on the card, its
    result in ``WORKDIR/result.json``."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from client_tpu_torch.utils import lockdep

    _check(lockdep.enabled(), "the incident child runs without lockdep")
    workdir = Path(argv[0])
    result = incident_run(torch, _nvidia_smi(), workdir)
    (workdir / "result.json").write_text(json.dumps(result))
    return 0


def incident_phase(torch, smi: str) -> dict:
    """Runs :func:`incident_run` in a child process started with
    ``CLIENT_TPU_LOCKDEP=1`` and passes its lines through; a lockdep
    violation anywhere in its output fails the phase. Returns each
    kernel's launches in the child."""
    import tempfile

    t_phase = time.monotonic()
    root = Path(__file__).resolve().parent
    (root / "build").mkdir(exist_ok=True)
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_incident_",
                                    dir=root / "build"))
    proc = subprocess.run(
        [sys.executable, str(root / "chip_smoke.py"), "--incident-child",
         str(workdir)], cwd=root, capture_output=True, text=True,
        timeout=INC_CHILD_TIMEOUT_S,
        env=dict(os.environ, CLIENT_TPU_LOCKDEP="1"))
    for line in proc.stdout.splitlines():
        print(line if line.startswith("incident") else
              f"incident: child: {line}", flush=True)
    _check(proc.returncode == 0, f"the incident child exited "
           f"{proc.returncode}: {proc.stderr[-6000:]}")
    hits = [w for w in LOCKDEP_WORDS if w in proc.stdout + proc.stderr]
    _check(not hits, f"lockdep in the incident child: {hits}: "
           f"{proc.stderr[-6000:]}")
    result = json.loads((workdir / "result.json").read_text())
    shutil.rmtree(workdir, ignore_errors=True)
    launches = result["launches"]
    _check(all(v > 0 for v in launches.values()),
           f"a kernel of the path did not launch in the incident child: "
           f"{launches}")
    print(f"incident: phase passed in {time.monotonic() - t_phase:.1f} s "
          f"under CLIENT_TPU_LOCKDEP=1; launches {launches}; {smi}",
          flush=True)
    return launches


# -- the router phase ---------------------------------------------------------

ROUTER_CONC = 8         # bert_long requests in flight through the router
ROUTER_ROUNDS = 4       # requests each of the 8 senders makes
ROUTER_ROWS = 4         # rows of a bert_long request: one whole batch
ROUTER_TIMED = 6        # timed requests of each of the 8 senders, each way
ROUTER_ADDED = 12       # alternating pinned requests, router and straight
ROUTER_STREAMS = (5, 60, 300, 900)  # tiny_gpt_long prompt lengths
ROUTER_TOKENS = 32
ROUTER_DLRM = 8         # dlrm_mlperf requests through the router
ROUTER_SEQS = (21, 22, 23, 24)      # simple_sequence ids
ROUTER_FAILOVER_S = 2.0  # traffic kept up after the SIGKILL
ROUTER_DRAIN_DEADLINE_S = 60.0
ROUTER_BOOT_S = 600     # replicas and router up, models loaded
ROUTER_EXIT_S = 120     # a drained child gone
ROUTER_ZOO = "bert_long,tiny_gpt_long,simple_sequence"


class _Proc:
    """One process the router phase starts: its lines (stdout and stderr
    together) read on a thread, and the addresses it announces."""

    _SERVING = re.compile(r"serving (http|grpc|router) at (\S+)")

    def __init__(self, name: str, cmd: list, env: dict, cwd: Path):
        self.name = name
        self.proc = subprocess.Popen(cmd, cwd=cwd, env=env, text=True,
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT)
        self.urls: dict[str, str] = {}
        self.lines: list[str] = []
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            self.lines.append(line.rstrip("\n"))
            m = self._SERVING.search(line)
            if m:
                self.urls[m.group(1)] = m.group(2)

    @property
    def pid(self) -> int:
        return self.proc.pid

    def port(self) -> int:
        """The HTTP port: a replica's, or the router's."""
        url = self.urls.get("http") or self.urls["router"]
        return int(url.rsplit(":", 1)[1])

    def wait_up(self, kinds: tuple, deadline: float) -> None:
        while not all(k in self.urls for k in kinds):
            _check(self.proc.poll() is None and time.monotonic() < deadline,
                   f"router: {self.name} did not start (exit "
                   f"{self.proc.poll()}): " + "\n".join(self.lines[-40:]))
            time.sleep(0.05)

    def wait_exit(self, timeout_s: float) -> int:
        try:
            rc = self.proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            rc = None
        self._reader.join(timeout=10)
        _check(rc is not None, f"router: {self.name} still running after "
               f"{timeout_s} s")
        return rc

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=30)


def _get_raw(port: int, path: str):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def _router_infer(port: int, model: str, inputs: dict, binary: bool,
                  parameters: dict | None = None,
                  headers: dict | None = None):
    """(status, response headers, outputs or error words) of one /infer
    request with ``parameters`` in its JSON head."""
    body, hdrs = _infer_body(inputs, None, binary)
    if parameters:
        head_len = hdrs.get("Inference-Header-Content-Length")
        head = json.loads(body[:int(head_len)] if head_len else body)
        head.setdefault("parameters", {}).update(parameters)
        new = json.dumps(head).encode()
        body = new + (body[int(head_len):] if head_len else b"")
        if head_len:
            hdrs["Inference-Header-Content-Length"] = str(len(new))
    status, rheaders, data = _post(port, f"/v2/models/{model}/infer", body,
                                   dict(hdrs, **(headers or {})))
    if status != 200:
        return status, rheaders, json.loads(data)["error"]
    return status, rheaders, _any_outputs(rheaders, data)


def _bert_requests(torch, bert, seq: int, n: int, seed: int, device):
    """``n`` bert_long requests of ``ROUTER_ROWS`` rows (each its own full
    batch, so that a replica runs it alone at one bucket however the
    traffic interleaves), each with its plain path's outputs."""
    rng = np.random.default_rng(seed)
    reqs = []
    for _ in range(n):
        ids = rng.integers(0, 30522, (ROUTER_ROWS, seq)).astype(np.int32)
        mask = np.ones((ROUTER_ROWS, seq), np.int32)
        for r in range(ROUTER_ROWS):
            mask[r, rng.integers(seq // 4, seq + 1):] = 0
        reqs.append((ids, mask, _bert_plain(torch, bert, ids, mask, device)))
    return reqs


def _percentiles(ms: list) -> dict:
    return {"p50": round(float(np.percentile(ms, 50)), 3),
            "p99": round(float(np.percentile(ms, 99)), 3)}


def _client_load(url: str, reqs: list, n_each: int, senders: int,
                 stop: threading.Event | None = None) -> tuple:
    """``senders`` threads, each with its own port HTTP client, sending
    bert_long requests (round robin over ``reqs``) until ``n_each`` each or
    ``stop``; every answer held to its plain path. -> (wall ms of each,
    errors, worst error against the plain path)."""
    import client_tpu_torch.http as httpclient

    walls, errors, worst = [], [], [0.0]
    lock = threading.Lock()

    def sender(k: int) -> None:
        client = httpclient.InferenceServerClient(url)
        try:
            i = 0
            while (stop is None and i < n_each) or (
                    stop is not None and not stop.is_set()):
                ids, mask, ref = reqs[(k + i * senders) % len(reqs)]
                inputs = [httpclient.InferInput("input_ids", list(ids.shape),
                                                "INT32"),
                          httpclient.InferInput("attention_mask",
                                                list(mask.shape), "INT32")]
                inputs[0].set_data_from_numpy(ids, binary_data=True)
                inputs[1].set_data_from_numpy(mask, binary_data=True)
                t0 = time.perf_counter()
                try:
                    result = client.infer("bert_long", inputs)
                    got = {n: result.as_numpy(n) for n in BERT_OUTPUTS}
                except Exception as exc:  # noqa: BLE001 — counted, then failed
                    with lock:
                        errors.append(repr(exc))
                    i += 1
                    continue
                wall = (time.perf_counter() - t0) * 1e3
                err = _bert_err(got, ref)
                with lock:
                    walls.append(wall)
                    worst[0] = max(worst[0], err)
                i += 1
        finally:
            client.close()

    with concurrent.futures.ThreadPoolExecutor(senders) as pool:
        list(pool.map(sender, range(senders)))
    return walls, errors, worst[0]


def _launcher_execs(port: int, before: dict, per: dict) -> dict:
    """The launcher replica's executions since ``before``, read on its
    /metrics (K2's waves on /v2/profile), and each kernel's launches per
    execution times them: what its kernels would have launched, not a
    count (its process counts nothing the script can read)."""
    now = _samples(_scrape(port))
    execs = {m: int(_sample_sum(now, "tpu_inference_exec_count", model=m)
                    - _sample_sum(before, "tpu_inference_exec_count",
                                  model=m))
             for m in ("bert_long", "tiny_gpt_long")}
    _, snap = _get(port, "/v2/profile?model=tiny_gpt_long")
    waves = sum(w["dispatches"] for w in snap["models"].get(
        "tiny_gpt_long:1", {}).get("decode_waves", ()))
    return {"execs": execs, "waves": waves, "times_per_execution": {
        "flash_attention": per["flash_attention"] * execs["bert_long"],
        "flash_attention_fp32": per["flash_attention_fp32"]
        * (execs["tiny_gpt_long"] - waves),
        "decode_wave_attention": per["decode_wave_attention"] * waves}}


def _router_bert(torch, router: _Proc, replicas: dict, reqs: list,
                 ids_of: dict) -> dict:
    """Step 1: ``bert_long`` at concurrency 8 through the router; each
    answer byte for byte the same request sent straight to the replica its
    ``X-Tpu-Replica`` names, within ``SERVED_ATOL`` of the plain path, with
    an ``X-Tpu-Load`` report; every replica served some."""
    from client_tpu_torch.protocol.loadreport import (
        LoadReport,
        decode_header,
        encode_header,
    )

    def send(k: int) -> list:
        out = []
        for i in range(ROUTER_ROUNDS):
            j = k * ROUTER_ROUNDS + i
            body, headers = _binary_request(reqs[j][0], reqs[j][1])
            t0 = time.perf_counter()
            status, rheaders, data = _post(
                router.port(), "/v2/models/bert_long/infer", body, headers)
            out.append((j, status, rheaders, data,
                        (time.perf_counter() - t0) * 1e3))
        return out

    with concurrent.futures.ThreadPoolExecutor(ROUTER_CONC) as pool:
        answers = [a for part in pool.map(send, range(ROUTER_CONC))
                   for a in part]
    served = collections.Counter()
    worst, trace_ids = 0.0, {}
    for j, status, rheaders, data, _ in answers:
        _check(status == 200, f"router: bert_long HTTP {status}: {data[:200]}")
        rid = rheaders.get("X-Tpu-Replica")
        _check(rid in ids_of, f"router: X-Tpu-Replica {rid!r} names no "
               f"replica of {sorted(ids_of)}")
        report = decode_header(rheaders.get("X-Tpu-Load"))
        _check(report is not None and report.state in ("READY", "DEGRADED"),
               f"router: X-Tpu-Load {rheaders.get('X-Tpu-Load')!r}")
        trace_ids[rid] = rheaders["X-Tpu-Trace-Id"]
        served[rid] += 1
        body, headers = _binary_request(reqs[j][0], reqs[j][1])
        d_status, d_headers, direct = _post(
            replicas[ids_of[rid]].port(), "/v2/models/bert_long/infer",
            body, headers)
        _check(d_status == 200 and direct == data,
               f"router: request {j} through the router differs from the "
               f"same request straight to {rid} (HTTP {d_status})")
        worst = max(worst, _bert_err(_parse_response(rheaders, data),
                                     reqs[j][2]))
    _check(set(served) == set(ids_of), f"router: replicas served {served}, "
           f"not every one of {sorted(ids_of)}")
    # Each replica's own /v2/load: the body and its header form agree.
    for rid, name in ids_of.items():
        status, headers, data = _get_raw(replicas[name].port(), "/v2/load")
        body = json.loads(data)
        _check(status == 200 and decode_header(headers["X-Tpu-Load"])
               is not None and headers["X-Tpu-Load"] == encode_header(
                   LoadReport.from_json_dict(body)),
               f"router: {rid} /v2/load {status} {headers} {body}")
    print(f"router: {len(answers)} bert_long requests of {ROUTER_ROWS} rows "
          f"at concurrency {ROUTER_CONC} through the router, served "
          f"{dict(served)}; each byte for byte the same request straight to "
          f"the replica its X-Tpu-Replica names, max |served - plain| "
          f"{worst} (tolerance {SERVED_ATOL}); X-Tpu-Load on every answer",
          flush=True)
    return {"served": dict(served), "max_err": worst, "trace_ids": trace_ids}


def _router_grpc_trailer(replica: _Proc, req: tuple) -> None:
    """A ModelInfer straight to one replica carries the x-tpu-load trailer
    and answers within ``SERVED_ATOL`` of the plain path."""
    from client_tpu_torch.protocol.loadreport import (
        LOAD_METADATA_KEY,
        decode_header,
    )

    channel, stub = _grpc_channel(replica.urls["grpc"])
    try:
        code, out, trailers = _grpc_outcome(stub, _grpc_request(
            "bert_long", {"input_ids": req[0], "attention_mask": req[1]}))
    finally:
        channel.close()
    _check(code == "OK", f"router: gRPC bert_long {code}: {out}")
    _bert_err(out, req[2])
    _check(decode_header(trailers.get(LOAD_METADATA_KEY)) is not None,
           f"router: ModelInfer trailers {trailers}")
    print(f"router: ModelInfer straight to {replica.name} carries "
          f"{LOAD_METADATA_KEY}: {trailers[LOAD_METADATA_KEY]}", flush=True)


def _router_streams(torch, router: _Proc, gpt_cfg: dict, device) -> None:
    """tiny_gpt_long streams through the router (the two child replicas,
    after the launcher's SIGKILL), token for token against the plain
    path."""
    from client_tpu_torch.models.generate import TinyGptBackend

    rng = np.random.default_rng(31)
    prompts = [rng.integers(0, 512, min(n, gpt_cfg["max_seq_len"]
                                        - ROUTER_TOKENS - 1)).tolist()
               for n in ROUTER_STREAMS]
    with concurrent.futures.ThreadPoolExecutor(len(prompts)) as pool:
        served = list(pool.map(lambda p: _stream(
            router.port(), "tiny_gpt_long", {
                "inputs": [{"name": "INPUT_IDS", "datatype": "INT32",
                            "shape": [len(p)], "data": p}],
                "parameters": {"max_tokens": ROUTER_TOKENS}}), prompts))
    oracle = TinyGptBackend(name="tiny_gpt_long", attention_impl="einsum",
                            attn_impl="reference", device=device, **gpt_cfg)
    arena = oracle.init_arena(1)
    for prompt, (toks, _, events) in zip(prompts, served):
        want = _direct_stream(torch, oracle, arena, prompt, ROUTER_TOKENS, {},
                              device=device.type)
        _check(toks == want, f"router: a stream, prompt of {len(prompt)}: "
               f"{toks} != plain {want}")
    del oracle, arena
    print(f"router: {len(prompts)} tiny_gpt_long streams through the "
          f"router, {ROUTER_TOKENS} tokens each, token for token against "
          f"the plain path ({[e for _, _, e in served]} events)", flush=True)


def _router_sequences(router: _Proc, eligible: list) -> dict:
    """Step 2: simple_sequence sequences through the router keep to the
    replica ``rendezvous_pick`` names (half by the X-Sequence-Id header,
    half by the sequence_id in the request head)."""
    from client_tpu_torch.router.core import rendezvous_pick

    pinned = {}
    for n, sid in enumerate(ROUTER_SEQS):
        sums, rids = [], set()
        for i in range(SEQ_STEPS):
            status, headers, out = _router_infer(
                router.port(), "simple_sequence",
                {"INPUT": np.array([sid * 100 + i], np.int32)},
                binary=i % 2 == 1, parameters={
                    "sequence_id": sid, "sequence_start": i == 0,
                    "sequence_end": i == SEQ_STEPS - 1},
                headers={"X-Sequence-Id": str(sid)} if n % 2 else None)
            _check(status == 200, f"router: sequence {sid}: {status} {out}")
            sums.append(int(out["OUTPUT"][0]))
            rids.add(headers["X-Tpu-Replica"])
        want = rendezvous_pick(sorted(eligible), sid)
        _check(rids == {want} and sums == _seq_expected(sid),
               f"router: sequence {sid} served by {rids} (affinity names "
               f"{want}), sums {sums}")
        pinned[sid] = want
    print(f"router: {len(ROUTER_SEQS)} simple_sequence sequences of "
          f"{SEQ_STEPS} steps, each on the replica rendezvous_pick names "
          f"{pinned}", flush=True)
    return pinned


def _router_fleet(router: _Proc, replicas: dict, ids_of: dict,
                  trace_ids: dict) -> dict:
    """Step 3: the fleet planes. /v2/fleet/metrics is each counter summed
    over the replicas' own /metrics; /v2/fleet/profile and /v2/fleet/events
    have a row or tag per replica; a stitched trace holds the router's
    spans with the serving replica's phase spans parented onto the attempt
    that carried them; a placement plan; one capture with every replica's
    section, no section in error."""
    ids = sorted(ids_of)
    texts = {rid: _scrape(replicas[ids_of[rid]].port()) for rid in ids}
    status, _, data = _get_raw(router.port(), "/v2/fleet/metrics")
    fleet_text = data.decode()
    again = {rid: _samples(_scrape(replicas[ids_of[rid]].port()))
             for rid in ids}
    _check(status == 200 and fleet_text.startswith(
        f"# fleet replicas={len(ids)} merged={len(ids)} errors=0"),
        f"router: /v2/fleet/metrics {status}: {fleet_text[:200]}")
    counters = {line.split()[2] for t in texts.values()
                for line in t.splitlines()
                if line.startswith("# TYPE ") and line.split()[3] == "counter"}
    mine = {rid: _samples(t) for rid, t in texts.items()}
    fleet = _samples(fleet_text)
    compared = 0
    for key, value in fleet.items():
        if key[0] not in counters:
            continue
        if any(mine[r].get(key, 0.0) != again[r].get(key, 0.0) for r in ids):
            continue  # moved between the scrapes
        want = sum(mine[r].get(key, 0.0) for r in ids)
        # Exact for counts; a sum of seconds may round in its last bit.
        _check(abs(value - want) <= 1e-12 * max(1.0, abs(want)),
               f"router: fleet {key} = {value}, the replicas' own sum {want}")
        compared += 1
    execs = {m: _sample_sum(fleet, "tpu_inference_exec_count", model=m)
             for m in ("bert_long", "tiny_gpt_long", DLRM_MODEL)}
    _check(compared > 20 and execs["bert_long"] > 0,
           f"router: {compared} counters compared, executions {execs}")
    status, prof = _get(router.port(), "/v2/fleet/profile")
    _check(status == 200 and sorted(prof["replicas"]) == ids
           and prof["errors"] == {} and prof["fleet"]["replica_count"]
           == len(ids), f"router: /v2/fleet/profile {status} "
           f"{sorted(prof.get('replicas', {}))} {prof.get('errors')}")
    status, evts = _get(router.port(), "/v2/fleet/events?limit=500")
    _check(status == 200 and sorted(evts["cursors"]) == ids
           and evts["events"] and all(e["replica"] in ids
                                      for e in evts["events"]),
           f"router: /v2/fleet/events {status} {evts.get('cursors')}")
    # One request's stitched trace, for each replica that served.
    for rid, tid in trace_ids.items():
        status, doc = _get(router.port(),
                           f"/v2/trace/requests?trace_id={tid}")
        events = doc["traceEvents"]
        pid_of = {e["args"]["name"]: e["pid"] for e in events
                  if e.get("ph") == "M"}
        proxy = [e for e in events if e["name"] == "router:proxy"
                 and e["args"]["outcome"] == "ok"]
        root = [e for e in events if e["name"] == "bert_long:request"]
        _check(status == 200 and {"router:request", "router:select"}
               <= {e["name"] for e in events} and len(proxy) == 1
               and proxy[0]["pid"] == pid_of[f"replica {rid}"]
               and len(root) == 1 and root[0]["pid"] == proxy[0]["pid"]
               and root[0]["args"]["parent_span_id"]
               == proxy[0]["args"]["span_id"]
               and {"queue", "compute_infer"} <= {
                   e["name"] for e in events if e["pid"] == proxy[0]["pid"]},
               f"router: stitched trace {tid} on {rid}: {status} "
               f"{[(e['name'], e.get('pid')) for e in events]}")
    status, plan = _get(router.port(), "/v2/router/placement")
    _check(status == 200 and sorted(plan["plan"]) == ids
           and "bert_long" in plan["costs_device_s"],
           f"router: /v2/router/placement {status} {plan}")
    status, _, data = _post(router.port(), "/v2/debug/capture",
                            json.dumps({"note": "chip_smoke"}).encode(),
                            {"Content-Type": "application/json"})
    capture = json.loads(data)
    _check(status == 200 and sorted(capture["replicas"]) == ids
           and all("error" not in v and (v.get("id") or v.get("deduped"))
                   for v in capture["replicas"].values()),
           f"router: /v2/debug/capture {status} {capture}")
    status, bundle = _get(router.port(),
                          f"/v2/debug/bundles/{capture['bundle']['id']}")
    bad = {k: v for k, v in bundle["sections"].items()
           if isinstance(v, dict) and "error" in v}
    _check(status == 200 and not bad and sorted(bundle["replicas"]) == ids,
           f"router: bundle {status} sections in error {bad}")
    print(f"router: /v2/fleet/metrics = each of {compared} counters summed "
          f"over the {len(ids)} replicas' own /metrics (executions {execs}); "
          f"/v2/fleet/profile and /v2/fleet/events per replica; stitched "
          f"traces of {len(trace_ids)} requests with each replica's phase "
          f"spans under the attempt that carried them; placement plan "
          f"{plan['plan']}; capture {capture['incident']}: router bundle "
          f"{capture['bundle']['id']} ({capture['bundle']['bytes']} B, "
          f"{capture['bundle']['capture_ms']} ms) with "
          f"{len(capture['replicas'])} replica bundles, no section in error",
          flush=True)
    return {"capture_ms": capture["bundle"]["capture_ms"]}


def _router_dlrm(torch, router: _Proc, dlrm) -> float:
    """dlrm_mlperf through the router (the two child replicas, which alone
    serve it), each score within ``DLRM_ATOL`` of the plain path."""
    rng = np.random.default_rng(41)
    reqs = [_mlperf_csr(rng) for _ in range(ROUTER_DLRM)]
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        outs = list(pool.map(lambda r: _router_infer(
            router.port(), DLRM_MODEL, r, binary=True), reqs))
    worst = 0.0
    for (status, headers, out), want in zip(outs,
                                            _dlrm_plain(torch, dlrm, reqs)):
        _check(status == 200, f"router: {DLRM_MODEL} HTTP {status}: {out}")
        got = out["OUTPUT0"]
        _check(got.shape == (1, 1) and bool(np.isfinite(got).all()),
               f"router: {DLRM_MODEL} {got.shape}")
        worst = max(worst, float(np.abs(got - want).max()))
    _check(worst <= DLRM_ATOL, f"router: {DLRM_MODEL} scores off the plain "
           f"path by {worst} (tolerance {DLRM_ATOL})")
    print(f"router: {len(reqs)} {DLRM_MODEL} requests through the router, "
          f"served by {sorted({h['X-Tpu-Replica'] for _, h, _ in outs})}, "
          f"max |served - plain| {worst} (tolerance {DLRM_ATOL})", flush=True)
    return worst


def _router_status(router: _Proc) -> dict:
    status, body = _get(router.port(), "/v2/router/status")
    _check(status == 200, f"router: /v2/router/status {status}")
    return body


def _router_failover(router: _Proc, victim: _Proc, victim_id: str,
                     reqs: list, per: dict, before: dict) -> dict:
    """Step 4: SIGKILL the launcher's replica under traffic: the clients
    see no error and the router's breaker for it opens. Its executions
    are read off its /metrics just before the kill."""
    stop = threading.Event()
    url = router.urls["router"]
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        load = pool.submit(_client_load, url, reqs, 0, 4, stop)
        time.sleep(1.0)
        executed = _launcher_execs(victim.port(), before, per)
        os.kill(victim.pid, signal.SIGKILL)
        t_kill = time.monotonic()
        opened_ms = None
        while time.monotonic() - t_kill < 30:
            if _router_status(router)["replicas"][victim_id][
                    "breaker"] == "open":
                opened_ms = (time.monotonic() - t_kill) * 1e3
                break
            time.sleep(0.01)
        time.sleep(ROUTER_FAILOVER_S)
        stop.set()
        walls, errors, worst = load.result()
    victim.wait_exit(30)
    _check(not errors, f"router: clients saw {len(errors)} errors through "
           f"the SIGKILL: {errors[:3]}")
    _check(opened_ms is not None, "router: the killed replica's breaker "
           "never opened")
    print(f"router: SIGKILL of {victim.name} ({victim_id}) under "
          f"{len(walls)} bert_long requests: 0 client errors, its breaker "
          f"open {opened_ms:.1f} ms after the kill; max |served - plain| "
          f"{worst}", flush=True)
    return {"opened_ms": round(opened_ms, 3), "executed": executed,
            "requests": len(walls)}


def _router_drain(router: _Proc, child: _Proc, child_id: str,
                  last_id: str, reqs: list) -> dict:
    """Step 5: POST /v2/router/drain on one child under traffic ends
    clean, drops no request, and the child exits 0; a drain of the last
    replica is refused."""
    stop = threading.Event()
    url = router.urls["router"]
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        load = pool.submit(_client_load, url, reqs, 0, 2, stop)
        time.sleep(0.5)
        status, _, data = _post(router.port(), "/v2/router/drain",
                                json.dumps({
                                    "replicas": [child_id],
                                    "deadline_s": ROUTER_DRAIN_DEADLINE_S,
                                }).encode())
        rc = child.wait_exit(ROUTER_EXIT_S)
        time.sleep(0.5)
        stop.set()
        walls, errors, _ = load.result()
    (report,) = json.loads(data)["reports"]
    _check(status == 200 and report["outcome"] == "clean"
           and report["saw_draining"], f"router: drain {status} {report}")
    _check(rc == 0, f"router: the drained child exited {rc}")
    _check(not errors, f"router: the drain dropped {len(errors)} requests: "
           f"{errors[:3]}")
    eligible = _router_status(router)["eligible"]
    _check(child_id not in eligible, f"router: {child_id} still eligible")
    t0 = time.monotonic()
    status, _, data = _post(router.port(), "/v2/router/drain",
                            json.dumps({"replicas": [last_id],
                                        "deadline_s": 5}).encode())
    (refused,) = json.loads(data)["reports"]
    _check(status == 500 and refused["outcome"] == "skipped",
           f"router: a drain of the last replica answered {status} {refused}")
    print(f"router: rolling drain of {child.name} ({child_id}) under "
          f"{len(walls)} bert_long requests: {report['outcome']} in "
          f"{report['step_s']} s, 0 dropped, the child exited 0; a drain of "
          f"the last replica refused ({refused['outcome']}, "
          f"{time.monotonic() - t0:.1f} s)", flush=True)
    return {"drain_s": report["step_s"]}


def _router_latency(router: _Proc, direct: _Proc, reqs: list) -> dict:
    """bert_long wall ms at concurrency 8 through the router and straight
    to one replica (the port's HTTP client), then the router's added ms: a
    request pinned by X-Sequence-Id to one replica, through the router and
    straight to that replica in turns."""
    from client_tpu_torch.router.core import rendezvous_pick

    out = {}
    for name, url in (("router", router.urls["router"]),
                      ("direct", direct.urls["http"]),
                      ("router_2", router.urls["router"]),
                      ("direct_2", direct.urls["http"])):
        walls, errors, _ = _client_load(url, reqs, ROUTER_TIMED, ROUTER_CONC)
        _check(not errors, f"router: {name} errors {errors[:3]}")
        out.setdefault(name.split("_")[0], []).extend(walls)
    eligible = _router_status(router)["eligible"]
    sid = next(s for s in range(1, 1000)
               if rendezvous_pick(sorted(eligible), s)
               == f"127.0.0.1:{direct.port()}")
    body, headers = _binary_request(reqs[0][0][:1], reqs[0][1][:1])
    turns = {"router": [], "direct": []}
    for i in range(2 * ROUTER_ADDED):
        way = ("router", "direct")[i % 2]
        port = router.port() if way == "router" else direct.port()
        t0 = time.perf_counter()
        status, rheaders, _ = _post(port, "/v2/models/bert_long/infer", body,
                                    dict(headers, **{"X-Sequence-Id": str(sid)}))
        turns[way].append((time.perf_counter() - t0) * 1e3)
        _check(status == 200 and (way == "direct" or rheaders[
            "X-Tpu-Replica"] == f"127.0.0.1:{direct.port()}"),
            f"router: pinned request {status} {rheaders}")
    added = float(np.median(turns["router"]) - np.median(turns["direct"]))
    return {"router_ms": _percentiles(out["router"]),
            "direct_ms": _percentiles(out["direct"]),
            "added_ms": round(added, 3),
            "pinned_ms": {k: round(float(np.median(v)), 3)
                          for k, v in turns.items()}}


def router_phase(torch, smi: str) -> dict:
    """Step 17 (see the module's docstring): three replica processes on
    the card behind ``python -m client_tpu_torch.router``. Returns each
    kernel's launches in the phase."""
    import tempfile

    from client_tpu_torch.models import _REGISTRY, model_names
    from client_tpu_torch.models.dlrm import DlrmBackend

    model_names()  # imports every family, so that the registry is full
    t_phase = time.monotonic()
    device = torch.device("cuda")
    root = Path(__file__).resolve().parent
    (root / "build").mkdir(exist_ok=True)
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_router_",
                                    dir=root / "build"))
    env = dict(os.environ, CLIENT_TPU_BLACKBOX=json.dumps(
        {"dir": str(workdir / "bundles")}))
    procs: dict[str, _Proc] = {}
    try:
        for i in (1, 2):
            procs[f"child{i}"] = _Proc(
                f"child{i}", [sys.executable, str(root / "chip_smoke.py"),
                              "--replica-child", str(workdir / f"child{i}")],
                env, root)
        procs["launcher"] = _Proc("launcher", [
            sys.executable, "-m", "client_tpu_torch.server",
            "--zoo", ROUTER_ZOO, "--http-port", "0", "--grpc-port", "0",
            "--drain-deadline", str(ROUTER_DRAIN_DEADLINE_S)], env, root)
        # The plain paths' models, on the card while the replicas load.
        bert = _REGISTRY["bert_long"](device)
        seq = bert.config.input[0].dims[0]
        gpt = _REGISTRY["tiny_gpt_long"]("cpu")
        gpt_cfg = {"max_seq_len": gpt.max_seq_len,
                   "max_streams": gpt.max_streams}
        per = {"flash_attention": len(bert.layers),
               "flash_attention_fp32": gpt.n_layers,
               "decode_wave_attention": gpt.n_layers, "ring_all_reduce": 1}
        del gpt
        dlrm = DlrmBackend(name=DLRM_MODEL, device=device,
                           emb_devices=[device] * 2, **MLPERF_DLRM)
        reqs = _bert_requests(torch, bert, seq, ROUTER_CONC * ROUTER_ROUNDS,
                              17, device)
        deadline = time.monotonic() + ROUTER_BOOT_S
        for proc in procs.values():
            proc.wait_up(("http", "grpc"), deadline)
        replicas = dict(procs)
        ids_of = {url: name for name, p in replicas.items()
                  for url in [p.urls["http"]]}
        launcher_before = _samples(_scrape(procs["launcher"].port()))
        procs["router"] = _Proc("router", [
            sys.executable, "-m", "client_tpu_torch.router", "--port", "0",
            "--poll-interval", "0.5"] + [
            a for name, p in replicas.items()
            for a in ("--replica", f"http://{p.urls['http']}@{p.pid}")],
            env, root)
        router = procs["router"]
        router.wait_up(("router",), deadline)
        with open(f"/proc/{router.pid}/maps") as f:
            maps = f.read()
        _check("libtorch" not in maps, "router: the router process mapped "
               "libtorch")
        t_up = time.monotonic() - t_phase
        named = ", ".join(f"{n} {p.urls['http']}" for n, p in replicas.items())
        print(f"router: 3 replicas ({named}) and the router at "
              f"{router.urls['router']} (no torch in its process) up in "
              f"{t_up:.1f} s on {device}", flush=True)

        bert_done = _router_bert(torch, router, replicas, reqs, ids_of)
        _router_grpc_trailer(replicas["child1"], reqs[0])
        latency = _router_latency(router, replicas["child1"], reqs)
        print(f"router: bert_long wall ms at concurrency {ROUTER_CONC}: "
              f"through the router {latency['router_ms']}, straight to "
              f"child1 {latency['direct_ms']}; pinned one-row requests "
              f"{latency['pinned_ms']}, the router's added ms "
              f"{latency['added_ms']}", flush=True)
        _router_sequences(router, list(ids_of))
        fleet = _router_fleet(router, replicas, ids_of,
                              bert_done["trace_ids"])
        launcher_id = procs["launcher"].urls["http"]
        failover = _router_failover(router, procs["launcher"], launcher_id,
                                    reqs, per, launcher_before)
        # The children alone from here: their own counts hold every
        # kernel's launches, K1 fp32's, K2's and K3's included.
        _router_streams(torch, router, gpt_cfg, device)
        dlrm_err = _router_dlrm(torch, router, dlrm)
        del dlrm
        child1_id, child2_id = (procs["child1"].urls["http"],
                                procs["child2"].urls["http"])
        drained = _router_drain(router, procs["child1"], child1_id,
                                child2_id, reqs)
        procs["child2"].proc.send_signal(signal.SIGTERM)
        rc = procs["child2"].wait_exit(ROUTER_EXIT_S)
        _check(rc == 0, f"router: child2 exited {rc} after SIGTERM")
        procs["router"].stop()
    except BaseException:
        for name, proc in procs.items():
            print(f"router: {name} (exit {proc.proc.poll()}) last lines:",
                  *proc.lines[-30:], sep="\n  ", flush=True)
        raise
    finally:
        for proc in procs.values():
            proc.stop()
        for name, proc in procs.items():
            for line in proc.lines:
                if line.startswith("replica-child"):
                    print(f"router: {name}: {line}", flush=True)
    children = [json.loads((workdir / f"child{i}" / "result.json")
                           .read_text()) for i in (1, 2)]
    shutil.rmtree(workdir, ignore_errors=True)
    names = ("flash_attention", "flash_attention_fp32",
             "decode_wave_attention", "ring_all_reduce")
    launches = {k: sum(c["launches"][k] for c in children) for k in names}
    for k in names:
        _check(launches[k] > 0, f"router: {k} launched {launches[k]} times "
               "in the children")
    print(f"router: launches {launches} (the children's own counts, each "
          f"held equal to its executions x launches per execution when it "
          f"exited)", flush=True)
    print(f"router: launcher_execs {json.dumps(failover['executed'])} (the "
          f"launcher replica's executions read on its /metrics before the "
          f"kill, and launches per execution times them; not counted, and "
          f"not in the launches)", flush=True)
    observation = {"card": smi, **latency,
                   "breaker_open_ms": failover["opened_ms"],
                   "drain_s": drained["drain_s"],
                   "served": bert_done["served"],
                   "bert_max_err": bert_done["max_err"],
                   "dlrm_max_err": dlrm_err,
                   "capture_ms": fleet["capture_ms"],
                   "load_report_us": [c["load_report_us"] for c in children],
                   "launcher_execs": failover["executed"]["execs"],
                   "failover_requests": failover["requests"],
                   "up_s": round(t_up, 1)}
    print(f"router observation: {json.dumps(observation)}", flush=True)
    print(f"router: phase passed in {time.monotonic() - t_phase:.1f} s; "
          f"{smi}", flush=True)
    return launches


def _load_report_us(engine, max_age_s: float | None, n: int = 2000) -> float:
    """Mean µs to build one ``X-Tpu-Load`` header as a response does:
    ``engine.load_report(max_age_s)`` and ``encode_header`` (``0.0``
    rebuilds the report each call, ``None`` takes the 50 ms cache)."""
    from client_tpu_torch.protocol.loadreport import encode_header

    t0 = time.perf_counter()
    for _ in range(n):
        encode_header(engine.load_report(max_age_s))
    return round((time.perf_counter() - t0) / n * 1e6, 3)


def replica_child(argv: list[str]) -> int:
    """``--replica-child WORKDIR``: one replica of the router
    phase: ``bert_long``, ``tiny_gpt_long``, ``simple_sequence`` and
    ``dlrm_mlperf`` (2 shards) behind the port's HTTP and gRPC servers,
    drained on SIGTERM. When the drain ends it holds each kernel's
    launches against its executions, writes them to
    ``WORKDIR/result.json``, prints them and exits 0."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from client_tpu_torch.admission.drain import install_sigterm_handler
    from client_tpu_torch.engine import TorchEngine
    from client_tpu_torch.models import build_repository
    from client_tpu_torch.models.dlrm import DlrmBackend
    from client_tpu_torch.ops import decode_attention as da
    from client_tpu_torch.ops import flash_attention as fa
    from client_tpu_torch.parallel import kv_shard as ks
    from client_tpu_torch.server import (
        GrpcInferenceServer,
        HttpInferenceServer,
    )

    workdir = Path(argv[0])
    workdir.mkdir(parents=True, exist_ok=True)
    device = torch.device("cuda")
    repo = build_repository(ROUTER_ZOO.split(","))
    repo.register(DLRM_MODEL, lambda dev: DlrmBackend(
        name=DLRM_MODEL, device=dev, emb_devices=[dev] * 2, **MLPERF_DLRM))
    engine = TorchEngine(repo, device=device)
    layers = {"bert_long": len(engine.repository.get("bert_long")
                               .backend.layers),
              "tiny_gpt_long": engine.repository.get("tiny_gpt_long")
              .backend.n_layers}
    http_server = HttpInferenceServer(engine, port=0).start()
    grpc_server = GrpcInferenceServer(engine, port=0).start()
    load_report_us = {way: _load_report_us(engine, age)
                      for way, age in (("built", 0.0), ("cached", None))}
    fa.launches = fa.launches_fp32 = da.launches = ks.launches = 0
    reports = []
    drained = install_sigterm_handler(
        engine, http_servers=[http_server], grpc_servers=[grpc_server],
        deadline_s=ROUTER_DRAIN_DEADLINE_S, on_done=reports.append)
    print(f"serving http at {http_server.url}", flush=True)
    print(f"serving grpc at {grpc_server.url}", flush=True)
    drained.wait()
    launches = {"flash_attention": fa.launches,
                "flash_attention_fp32": fa.launches_fp32,
                "decode_wave_attention": da.launches,
                "ring_all_reduce": ks.launches}
    execs = {s["name"]: s["execution_count"]
             for s in engine.model_statistics()["model_stats"]}
    snap = engine.profiler.snapshot(model="tiny_gpt_long")
    waves = sum(w["dispatches"] for w in snap["models"].get(
        "tiny_gpt_long:1", {}).get("decode_waves", ()))
    per = {"flash_attention": (layers["bert_long"], execs["bert_long"]),
           "flash_attention_fp32": (layers["tiny_gpt_long"],
                                    execs["tiny_gpt_long"] - waves),
           "decode_wave_attention": (layers["tiny_gpt_long"], waves),
           "ring_all_reduce": (1, execs[DLRM_MODEL])}
    _check(reports and reports[0]["clean"], f"replica-child: drain {reports}")
    for name, (k, n) in per.items():
        _check(launches[name] == k * n, f"replica-child: {name}: "
               f"{launches[name]} launches, {k} x {n} executions")
    (workdir / "result.json").write_text(json.dumps(
        {"launches": launches, "execs": execs, "waves": waves,
         "load_report_us": load_report_us}))
    print(f"replica-child: launches {launches} = per-execution counts x "
          f"executions {per}; drain {reports[0]}", flush=True)
    return 0


# -- mc phase -------------------------------------------------------------------

# The six sharded families, each on a mesh that repeats the one card.
MC_MESHES = {
    "bert_base_mc": {"dp": 2, "tp": 4},
    "bert_long_mc": {"dp": 2, "sp": 4},
    "tiny_gpt_mc": {"tp": 8},
    "moe_gpt_mc": {"ep": 2, "tp": 4},
    "moe_lm_mc": {"dp": 2, "ep": 2, "tp": 2},
    "pipelined_lm_mc": {"dp": 2, "pp": 4},
}
MC_FORWARD = ("bert_base_mc", "bert_long_mc", "moe_lm_mc", "pipelined_lm_mc")
MC_GPT = ("tiny_gpt_mc", "moe_gpt_mc")
MC_TOKENS = 16
# Sharded LM forwards vs their degree-1 plain run on the same weights: fp32
# throughout (TF32 off), logits of magnitude ~1; the tp partials, the
# expert outputs and the batch's GEMM shapes sum in another order.
MC_LM_ATOL = 1e-4


def _mc_build(name: str, mesh, device, **kw):
    """One family on ``mesh`` at its registered widths."""
    from client_tpu_torch.parallel import serving as sv

    cls = {"bert_base_mc": sv.ShardedBertBackend,
           "bert_long_mc": sv.LongContextBertBackend,
           "tiny_gpt_mc": sv.ShardedTinyGptBackend,
           "moe_gpt_mc": sv.MoeGptBackend,
           "moe_lm_mc": sv.MoeLmBackend,
           "pipelined_lm_mc": sv.PipelinedLmBackend}[name]
    return cls(mesh, device=device, **kw)


def _mc_plain(name: str, backend):
    """The family's unsharded plain path on the same weights: BERT as the
    plain ``BertBackend`` (einsum attention), the others on a degree-1 mesh
    (one shard), the GPTs with K2's plain version (``attn_impl=
    "reference"``)."""
    from client_tpu_torch.models.bert import BertBackend
    from client_tpu_torch.parallel import mesh as mm

    if name.startswith("bert"):
        kw = {"max_batch_size": backend.config.max_batch_size,
              "seq_len": backend.config.input[0].dims[0]}
        plain = BertBackend(name=f"{name}_plain", device="cuda", **kw)
    else:
        axes = tuple(MC_MESHES[name])
        extra = {"attn_impl": "reference"} if name in MC_GPT else {}
        plain = _mc_build(name, mm.make_mesh(axes=axes, devices=["cuda"]),
                          "cuda", **extra)
    plain.load_jax_params(backend.params_to_jax())
    return plain


def _mc_inputs(name: str, backend, rng, rows: int) -> dict[str, np.ndarray]:
    seq = backend.config.input[0].dims[0]
    if name.startswith("bert"):
        vocab = backend.tok_embed.shape[0]
        mask = np.ones((rows, seq), np.int32)
        for r in range(rows):
            mask[r, int(rng.integers(seq // 4, seq + 1)):] = 0
        return {"input_ids": rng.integers(0, vocab, (rows, seq)).astype(
            np.int32), "attention_mask": mask}
    return {"INPUT_IDS": rng.integers(0, backend.vocab, (rows, seq)).astype(
        np.int32)}


def _mc_direct(torch, plain, inputs: dict, pad_to: int) -> dict:
    """``plain`` run directly on ``inputs`` padded with zero rows to
    ``pad_to`` (the served bucket), the padding dropped from the answer."""
    rows = next(iter(inputs.values())).shape[0]
    feed = {k: torch.from_numpy(np.pad(v, [(0, pad_to - rows), (0, 0)])).to(
        "cuda") for k, v in inputs.items()}
    with torch.inference_mode():
        out = plain(feed)
    return {k: v[:rows].float().cpu().numpy() for k, v in out.items()}


def _mc_err(got: dict, want: dict) -> float:
    return max(float(np.abs(got[k] - want[k]).max()) for k in want)


def mc_phase(torch, smi: str) -> dict:
    """The six ``*_mc`` families on meshes that repeat the card, served over
    HTTP and gRPC from one engine: forward answers against each family's
    unsharded plain path run directly on the same weights, streams token
    for token against the plain path; then the registered degree-1
    builders loaded by name. K2 (head dim 32) once per tp shard and layer
    of every decode wave."""
    from client_tpu_torch.engine import TorchEngine
    from client_tpu_torch.engine.repository import ModelRepository
    from client_tpu_torch.models import build_repository
    from client_tpu_torch.ops import decode_attention as da
    from client_tpu_torch.ops import flash_attention as fa
    from client_tpu_torch.parallel import kv_shard as ks
    from client_tpu_torch.parallel import mesh as mm
    from client_tpu_torch.server import (
        GrpcInferenceServer,
        HttpInferenceServer,
    )

    meshes = {name: mm.make_mesh(
        axes=tuple(sizes), axis_sizes=sizes,
        devices=["cuda"] * int(np.prod(list(sizes.values()))))
        for name, sizes in MC_MESHES.items()}
    repo = ModelRepository()
    for name in MC_MESHES:
        repo.register(name, lambda d, name=name: _mc_build(
            name, meshes[name], d))
    t0 = time.monotonic()
    engine = TorchEngine(repo, device="cuda")
    server = HttpInferenceServer(engine, port=0).start()
    grpc_server = GrpcInferenceServer(engine, port=0).start()
    backends = {n: engine.repository.get(n).backend for n in MC_MESHES}
    plains = {n: _mc_plain(n, backends[n]) for n in MC_MESHES}
    arenas = {n: [list(t.shape) for t in engine._schedulers[n]._arena.k]
              for n in MC_GPT}
    print(f"mc: engine, both servers and the 6 plain paths up in "
          f"{time.monotonic() - t0:.1f} s; meshes "
          f"{ {n: m.shape for n, m in meshes.items()} } on the card; "
          f"head-sharded arenas (k per tp shard) {arenas}", flush=True)
    channel, stub = _grpc_channel(grpc_server.url)
    rng = np.random.default_rng(19)
    try:
        fa.launches = fa.launches_fp32 = da.launches = ks.launches = 0
        for dim in da.launches_by_head_dim:
            da.launches_by_head_dim[dim] = 0
        # Forward families: BERT and the pipelined LM concurrently over
        # HTTP (dynamic batching forms their batches); moe_lm_mc one
        # request at a time, since its routing depends on the batch.
        reqs = [(name, _mc_inputs(name, backends[name], rng, rows), i % 2)
                for name in MC_FORWARD for i, rows in enumerate((1, 3, 4, 2))]
        t0 = time.monotonic()
        together = [r for r in reqs if r[0] != "moe_lm_mc"]
        with concurrent.futures.ThreadPoolExecutor(len(together)) as pool:
            got = dict(zip(map(id, together), pool.map(
                lambda r: _http_infer(server.port, r[0], r[1], bool(r[2])),
                together)))
        for r in reqs:
            if r[0] == "moe_lm_mc":
                got[id(r)] = _http_infer(server.port, r[0], r[1], bool(r[2]))
        errs = {n: 0.0 for n in MC_FORWARD}
        for r in reqs:
            name, inputs, _ = r
            status, out = got[id(r)]
            _check(status == 200, f"{name}: HTTP {status} {out}")
            rows = next(iter(inputs.values())).shape[0]
            bucket = engine.repository.get(name).pick_bucket(rows)
            want = _mc_direct(torch, plains[name], inputs, bucket)
            _check(all(out[k].shape == want[k].shape for k in want),
                   f"{name}: shapes {[(k, out[k].shape) for k in out]}")
            _check(all(np.isfinite(out[k]).all() for k in want),
                   f"{name}: non-finite output")
            err = _mc_err(out, want)
            tol = SERVED_ATOL if name.startswith("bert") else MC_LM_ATOL
            _check(err <= tol, f"{name} rows {rows}: served vs plain {err} "
                   f"(tolerance {tol})")
            errs[name] = max(errs[name], err)
            # The same request over gRPC, alone.
            code, gout = _grpc_infer(stub, name, inputs)
            _check(code.name == "OK", f"{name} over gRPC: {code} {gout}")
            gerr = _mc_err(gout, want)
            _check(gerr <= tol, f"{name} over gRPC vs plain {gerr}")
        print(f"mc: {len(reqs)} forward requests over HTTP and again over "
              f"gRPC in {time.monotonic() - t0:.1f} s; max error against "
              f"the unsharded plain path {errs} (tolerances: BERT "
              f"{SERVED_ATOL}, LMs {MC_LM_ATOL})", flush=True)

        # Generative families: concurrent SSE streams, then gRPC streams.
        sampled = {"temperature": 0.8, "top_k": 24, "top_p": 0.9}
        streams = []  # (model, prompt, params)
        for name in MC_GPT:
            backend = backends[name]
            longest = backend.max_seq_len - MC_TOKENS - 1
            for i, n in enumerate(sorted({1, 3, 9, 20, longest // 2,
                                          longest})):
                params = {**sampled, "seed": 500 + i} if i == 2 else {}
                streams.append((name, rng.integers(
                    0, backend.vocab, n).tolist(), params))
        t0 = time.monotonic()
        with concurrent.futures.ThreadPoolExecutor(len(streams)) as pool:
            http_results = list(pool.map(lambda r: _stream(
                server.port, r[0], {
                    "inputs": [{"name": "INPUT_IDS", "datatype": "INT32",
                                "shape": [len(r[1])], "data": r[1]}],
                    "parameters": {"max_tokens": MC_TOKENS, **r[2]}}),
                streams))
        http_k2 = da.launches
        rpcs = [[(f"m{i}", *s[:2], {"max_tokens": MC_TOKENS, **s[2],
                                     **({"response_coalesce": True}
                                        if i % 3 == 0 else {})})
                 for i, s in enumerate(streams) if i % 2 == j]
                for j in range(2)]
        by_id = _grpc_stream_rpcs(grpc_server.url, rpcs)
        grpc_results = [by_id[f"m{i}"][0] for i in range(len(streams))]
        wall = time.monotonic() - t0
        k2 = da.launches
        for (name, prompt, params), (toks, _, _), gtoks in zip(
                streams, http_results, grpc_results):
            plain = plains[name]
            want = _direct_stream(torch, plain, plain.init_arena(1), prompt,
                                  MC_TOKENS, params)
            _check(toks == want and gtoks == want,
                   f"{name} prompt of {len(prompt)} {params or 'greedy'}: "
                   f"SSE {toks}, gRPC {gtoks}, plain {want}")
        per_wave = {n: backends[n].n_layers * meshes[n].shape["tp"]
                    for n in MC_GPT}
        step = math.gcd(*per_wave.values())
        _check(k2 > http_k2 > 0 and http_k2 % step == 0 and k2 % step == 0,
               f"K2 launches {http_k2} over SSE, {k2} with gRPC: not "
               f"multiples of {step}")
        _check(da.launches_by_head_dim.get(64, 0) == 0 and
               da.launches_by_head_dim.get(32, 0) == k2,
               f"K2 by head dim {da.launches_by_head_dim}")
        _check((fa.launches, fa.launches_fp32, ks.launches) == (0, 0, 0),
               "a kernel other than K2 ran on the mc path: K1 "
               f"{fa.launches}/{fa.launches_fp32}, K3 {ks.launches}")
        n_tokens = sum(len(t) for t, _, _ in http_results) + sum(
            map(len, grpc_results))
        print(f"mc: {len(streams)} streams over SSE and again over gRPC "
              f"(2 RPCs), {n_tokens} tokens in {wall:.1f} s, every one "
              f"equal to the plain path token for token; K2 (head dim 32) "
              f"launched {k2} times ({http_k2} over SSE), {per_wave} per "
              f"decode wave; {smi} (printed, not claimed)", flush=True)

        # One decode wave run directly: K2 exactly once per tp shard and
        # layer.
        for name in MC_GPT:
            backend = backends[name]
            arena = backend.init_arena(2)
            lanes = backend.lane_params([0, 0], [0.0, 0.0], [0, 0],
                                        [1.0, 1.0])
            before = da.launches
            backend.decode(arena, backend.wave_index(arena, [0, 1], [3, 0]),
                           lanes, False)
            _check(da.launches - before == per_wave[name],
                   f"{name}: one wave launched K2 {da.launches - before} "
                   f"times, not {per_wave[name]}")
        direct_k2 = da.launches - k2

        # The registered degree-1 builders, loaded by name.
        t0 = time.monotonic()
        reg = TorchEngine(build_repository(list(MC_MESHES)), device="cuda")
        try:
            for name in MC_FORWARD:
                inputs = _mc_inputs(name, backends[name], rng, 2)
                out = reg.infer(_infer_request(name, inputs),
                                timeout_s=600).outputs
                mine = reg.repository.get(name).backend
                _check(mine.mesh.size == 1, f"{name}: mesh {mine.mesh}")
                want = _mc_direct(torch, plains[name], inputs, 2)
                tol = SERVED_ATOL if name.startswith("bert") else MC_LM_ATOL
                err = _mc_err(out, want)
                _check(err <= tol, f"registered {name} vs the sharded "
                       f"family's plain path: {err}")
            reg_before = da.launches
            for name in MC_GPT:
                prompt = [1, 2, 3]
                toks = _engine_stream(reg, name, prompt, MC_TOKENS)
                plain = plains[name]
                want = _direct_stream(torch, plain, plain.init_arena(1),
                                      prompt, MC_TOKENS, {})
                _check(toks == want, f"registered {name}: {toks} != {want}")
            reg_k2 = da.launches - reg_before
            _check(reg_k2 > 0, "the registered GPTs launched no K2")
        finally:
            reg.shutdown()
        print(f"mc: the 6 registered builders (degree-1 meshes) loaded by "
              f"name and answered like the sharded families' weights in "
              f"{time.monotonic() - t0:.1f} s; K2 {reg_k2} launches",
              flush=True)
        return {"decode_wave_attention_hd32": k2 + direct_k2 + reg_k2,
                "http_launches": http_k2}
    finally:
        channel.close()
        grpc_server.stop()
        server.stop()
        engine.shutdown()


def _infer_request(model: str, inputs: dict):
    from client_tpu_torch.engine import InferRequest

    return InferRequest(model_name=model, inputs=dict(inputs))


def _engine_stream(engine, model: str, prompt: list, n: int) -> list[int]:
    """One greedy stream straight through ``engine.async_infer``."""
    import threading

    from client_tpu_torch.engine import InferRequest

    toks, errs, done = [], [], threading.Event()

    def cb(resp):
        if resp.error is not None:
            errs.append(resp.error)
            done.set()
        elif resp.final:
            done.set()
        else:
            toks.append(int(resp.outputs["TOKEN"][0]))

    engine.async_infer(InferRequest(
        model_name=model, inputs={"INPUT_IDS": np.asarray(prompt, np.int32)},
        parameters={"max_tokens": n}), cb)
    _check(done.wait(600), f"{model}: stream stalled")
    _check(not errs, f"{model}: {errs}")
    return toks


def wave_phase(torch, smi: str) -> None:
    """``--kernels``: the per-wave host/device split (:func:`_wave_split`)
    of ``tiny_gpt_long`` at its registered size, built directly, over one
    arena and over 2 shards on the card, without the engine."""
    from client_tpu_torch.models.generate import TinyGptBackend
    from client_tpu_torch.parallel import kv_shard as ks

    for shards in (1, 2):
        backend = TinyGptBackend(
            name="tiny_gpt_long" if shards == 1 else "tiny_gpt_long_kv2",
            max_seq_len=2048, max_streams=16, attention_impl="flash",
            attn_impl="fused", kv_shards=shards, device="cuda")
        if shards > 1:
            backend._kv_mesh = ks.kv_mesh(shards, ["cuda"] * shards)
        _wave_split(torch, backend, smi)


def main(argv: list[str]) -> int:
    if argv[:1] == ["--clients-child"]:  # the clients phase's other process
        return clients_child(argv[1:])
    if argv[:1] == ["--incident-child"]:  # the incident phase's process
        return incident_child(argv[1:])
    if argv[:1] == ["--replica-child"]:  # a router phase replica
        return replica_child(argv[1:])
    import torch

    kernels_only = argv == ["--kernels"]
    mc_only = argv == ["--mc"]
    if argv and not (kernels_only or mc_only):
        print("usage: python3 chip_smoke.py [--kernels | --mc]",
              file=sys.stderr)
        return 2

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from client_tpu_torch.ops import cuda_build
    except ImportError as exc:
        print(f"chip_smoke: run from the root of a checkout ({exc})",
              file=sys.stderr)
        return 1

    t_start = time.monotonic()
    name = torch.cuda.get_device_name(0)
    smi = _nvidia_smi()
    print(f"device: {name}, {torch.cuda.device_count()} visible; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    t0 = time.monotonic()
    built = cuda_build.build(["flash_attention", "decode_attention",
                              "ring_all_reduce"])
    print(f"set-up: kernels built in {time.monotonic() - t0:.1f} s {built}",
          flush=True)
    census = _sass_census(cuda_build)

    if mc_only:
        hd32 = kernel_phase_decode_hd32(torch, cuda_build)
        mc = mc_phase(torch, smi)
        hd32["launches"] = mc["decode_wave_attention_hd32"]
        hd32["http_launches"] = mc["http_launches"]
        print(json.dumps({"kernels": [hd32]}), flush=True)
        print(smi, flush=True)
        return 0
    kernels = [kernel_phase(torch), kernel_phase_fp32(torch),
               kernel_phase_decode(torch, cuda_build),
               kernel_phase_ring(torch, cuda_build)]
    kernels[0]["sass"], kernels[1]["sass"] = census["bf16"], census["fp32"]
    # K2's head-dim-32 instantiation, its own entry of the kernels line.
    hd32 = kernel_phase_decode_hd32(torch, cuda_build)
    torch.cuda.empty_cache()
    if kernels_only:
        wave_phase(torch, smi)
        print(json.dumps({"kernels": kernels + [hd32]}), flush=True)
        print(smi, flush=True)
        return 0
    # Each path's counts: the HTTP requests alone ("http_launches"), then
    # with the same path's gRPC requests on the same engine ("launches").
    served = serve_phase(torch)
    kernels[0]["launches"] = served["launches"]
    kernels[0]["http_launches"] = served["http_launches"]
    generated = generate_phase(torch, smi)
    kernels[1]["launches"] = generated["flash_attention_fp32"]
    kernels[2]["launches"] = generated["decode_wave_attention"]
    kernels[1]["http_launches"] = generated["http_launches"][
        "flash_attention_fp32"]
    kernels[2]["http_launches"] = generated["http_launches"][
        "decode_wave_attention"]
    sharded = sharded_phase(torch, smi)
    kernels[3]["launches"] = sharded["ring_all_reduce"]
    kernels[3]["http_launches"] = sharded["http_launches"]
    for kernel in kernels:
        _check(kernel["launches"] > kernel["http_launches"] > 0,
               f"{kernel['name']}: {kernel['launches']} launches with gRPC, "
               f"{kernel['http_launches']} over HTTP alone")
    torch.cuda.empty_cache()
    vision_phase(torch, smi)
    torch.cuda.empty_cache()
    # K3's second call site: the row-sharded DLRM's pooled bags.
    stateful = stateful_phase(torch, smi)
    kernels[3]["launches"] += stateful["ring_all_reduce"]
    kernels[3]["http_launches"] += stateful["http_launches"]
    _check(stateful["ring_all_reduce"] > stateful["http_launches"] > 0,
           f"ring_all_reduce in the stateful phase: {stateful}")
    torch.cuda.empty_cache()
    # K1 again: bert_long with its inputs and outputs in shm regions.
    shm = shm_phase(torch, smi)
    kernels[0]["launches"] += shm["launches"]
    kernels[0]["shm_launches"] = shm["launches"]
    torch.cuda.empty_cache()
    # Every kernel again, from the port's own clients in another process.
    clients = clients_phase(torch, smi)
    for kernel in kernels:
        kernel["clients_launches"] = clients[kernel["name"]]
        kernel["launches"] += clients[kernel["name"]]
    torch.cuda.empty_cache()
    # Every kernel again, through models loaded, unloaded and reloaded.
    repository = repository_phase(torch, smi)
    for kernel in kernels:
        kernel["repository_launches"] = repository[kernel["name"]]
        kernel["launches"] += repository[kernel["name"]]
    torch.cuda.empty_cache()
    # Every kernel again, its launches held against the executions that
    # /metrics reports, with the tracing, fault and profiler planes.
    observed = observability_phase(torch, smi)
    for kernel in kernels:
        kernel["observability_launches"] = observed[kernel["name"]]
        kernel["launches"] += observed[kernel["name"]]
    torch.cuda.empty_cache()
    # Every kernel again, through models restored from checkpoints.
    weights = weights_phase(torch, smi)
    for kernel in kernels:
        kernel["weights_launches"] = weights[kernel["name"]]
        kernel["launches"] += weights[kernel["name"]]
    torch.cuda.empty_cache()
    # Every kernel again, under deadlines, admission, the census planes and
    # a drain with streams in flight.
    overload = overload_phase(torch, smi)
    for kernel in kernels:
        kernel["overload_launches"] = overload[kernel["name"]]
        kernel["launches"] += overload[kernel["name"]]
    torch.cuda.empty_cache()
    # Every kernel again: warm-up, QoS lanes, the autotuner's promotion.
    tuning = tuning_phase(torch, smi)
    for kernel in kernels:
        kernel["tuning_launches"] = tuning[kernel["name"]]
        kernel["launches"] += tuning[kernel["name"]]
    torch.cuda.empty_cache()
    # Every kernel again, under lockdep in another process: the slot ring,
    # staged datasets, a dead producer and the incident blackbox.
    incident = incident_phase(torch, smi)
    for kernel in kernels:
        kernel["incident_launches"] = incident[kernel["name"]]
        kernel["launches"] += incident[kernel["name"]]
    torch.cuda.empty_cache()
    # Every kernel again, in three replica processes behind the router.
    routed = router_phase(torch, smi)
    for kernel in kernels:
        kernel["router_launches"] = routed[kernel["name"]]
        kernel["launches"] += routed[kernel["name"]]
    torch.cuda.empty_cache()
    # The six *_mc families on meshes that repeat the card: K2 at head dim
    # 32, once per tp shard and layer of every decode wave.
    mc = mc_phase(torch, smi)
    hd32["launches"] = mc["decode_wave_attention_hd32"]
    hd32["http_launches"] = mc["http_launches"]
    kernels.append(hd32)
    for kernel in kernels:
        # Shorter aliases of the two keys above.
        kernel["launched"] = kernel["launches"]
        kernel["max_err"] = kernel["max_abs_err"]
    print(f"chip_smoke: all phases passed in "
          f"{time.monotonic() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
