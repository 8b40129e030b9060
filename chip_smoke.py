#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one NVIDIA GPU.

    python3 chip_smoke.py                 # N = 2^25 100-byte records
    python3 chip_smoke.py --n-log2 20     # a quick, smaller run
    python3 chip_smoke.py --profile DIR   # + a profiled warm rerun of each
                                          #   path, traces written to DIR

Phases, in order (any failure ends the script with a non-zero exit):

1. the card's name and power limit (``nvidia-smi``);
2. build the Hopper kernels K1 (partition rank), K3 (bitonic sort), K2
   (radix sort) and K4 (bucket histogram) from
   ``src/repro_torch/kernels/csrc`` with ``nvcc``, all at once, printing
   seconds and the ``-Xptxas -v`` lines;
3. hold each kernel against its plain PyTorch version on the card, at the
   shapes the paths below give it and at edge cases, and time kernel,
   plain version and the nearest single PyTorch call (CUDA events, median
   of 10 warm runs) beside the memory bound. K3 also at its design's
   edges (rows of T - 1, T, T + 1 for its 8192-element tile, 1 to 4
   merge passes, all-equal, all-maximum, sorted and reversed rows, 65535
   rows of 3), keys-only against ``ref.sort_segments_ref``, timed on
   random keys and on the main path's own stage-2 sort input at the flat
   and the grid shape, with its CUDA launches per call counted by
   ``torch.profiler``. K2 also at its design's edges (rows of T - 1, T,
   T + 1, 2 T + 1 and 9 T + 5 for its 8192-element tile, all-equal,
   all-maximum, sorted and reversed rows, a wordcount-like row, 65535
   rows of 3, keys-only, inputs untouched, and a 2^24-element row sorted
   three times bit-identically), timed at (8, 2^25 + 8) and (8, 2^23 + 8)
   with its CUDA launches and memsets per call counted by
   ``torch.profiler`` and held to ``radix_plan``; its phase line also
   gives the time its design's 68 B/element would take at the card's
   memory rate (computed like the bound, not measured; it stays out of
   the kernel table). K1 also at its tile's edges in both forms (T - 1
   to 9 T + 5 for 1 to 4096 destinations), one destination for all, none
   in range, the int32 extremes, 65535 rows, a count past 2^24 and a
   2^24-id row ranked three times identically, timed at each of its six
   path shapes; K4 at its chunk's edges, with rows and 1-D views that
   start off a 16-byte boundary, timed at (8, 2^22) with 8 buckets and
   (1, 2^25) with 256. For K1, K2 and K4 the CUDA launches and memsets
   of one call are counted by ``torch.profiler`` and held to the plan,
   and the profiler's kernel and memset time of a call is given beside
   the CUDA-event window, so that host time inside the window shows;
4. K4's path, its entry point ``kernels.ops.bucket_histogram`` (on no
   dataflow path, as in the JAX package), on the main path's stage-1
   bucket ids;
5. the main path: ``Dataflow.source().sort(...)`` over 8 stacked ranks of
   100-byte records ``{"key": int32, "value": uint8[96]}``, bitonic
   pinned; checks a globally sorted permutation with every value row
   still beside its key and no drops, and that K1 and K3 ran;
6. the wide-area path: the same pipeline and records on the ``(dc, node)
   = (2, 4)`` grid of ranks (the two-level hierarchical shuffle); the
   same checks, the same sorted keys as phase 5, K1 3 times, K3 once, two
   ``all_to_all``; cold and warm wall time and the WAN profile of both
   plans;
7. MapReduce wordcount: ``map -> shuffle(default_hash) ->
   reduce(reduce_by_key_sum(algo="radix"))`` over 8 ranks on 2^(n+1)
   Zipf(1.1) word ids in a 2^20-word vocabulary; every (word, count) must
   equal ``np.bincount`` of the input, and K2 must run (radix is pinned,
   so the path always measures K2); K2 is then held against its plain
   version and timed on the reduce's own sort input, beside the library
   call and its bound;
8. the ``terasort()`` shim three ways — ``sort_algo="radix"`` (K2 must
   run), ``buckets_per_device=4``, and ``hadoop_style_sort`` against
   ``terasort`` — and the autotuner's choice for the main-path cell;
9. the host path: Terasort over Sector files. ``make_sector`` builds 8
   slaves in a temporary directory on the local disk (removed at the
   end), replication 2 with the ``ReplicationDaemon``; phase 5's records
   are uploaded as 8 slices, and 8 SPEs run
   ``Dataflow.source(codec).sort(key, num_buckets=8)``
   through ``HostExecutor`` on the card: phase 0 splits each slice into
   bucket files with K1, phase 1 sorts each bucket file with K2. Checks a
   globally sorted permutation with each value row beside its key, keys
   equal to ``torch.sort`` of the input's and to phase 5's, no errors, K1 once per phase-0 segment and K2 once per phase-1
   bucket file; prints the wall of that one run (its warm rerun went
   for the script's time limit), records/s, the per-phase split, the
   slaves' write, md5 and ``used_bytes`` seconds, disk bytes written and
   peak device memory (``--profile``: the device busy share of a warm
   run); holds K1 and K2 to their plain
   versions at this path's shapes; then sorts a 2^20-record prefix again
   with one SPE crashing after its first segment (same output, retries
   > 0);
10. ``stream-wordcount-storm``: phase 7's pipeline as a
    ``Dataflow.stream_source()`` through ``StreamExecutor`` over 8 ranks:
    phase 7's 2^26 words cut into 256 requests of 2^18 from tenants
    ``free``, ``pro`` and ``enterprise`` (weights 1:3:4, backlogged),
    ``micro_batch = 2^21``, a carry of 2^18 rows a rank, 34 steps on a
    virtual clock of 1.0 a step under ``ChaosSchedule([lose_batch@4,
    lose_device@10, kill_slave@16 (wipe), rejoin_slave@24], seed=7)``,
    with ``attach_sector`` on 8 slaves (replication 2, a temporary
    directory removed at the end), a ``FailureDetector`` (suspect 0.5,
    down 1.5) and a ``ReplicationDaemon``. Checks the final snapshot
    against ``np.bincount`` of the 2^26 words, exactly-once delivery, no
    drops, the four faults, 2 recoveries, 2 cache misses, 4 ranks after
    the shrink, and K1 and K2 once a delivered batch; prints batch walls
    (p50/p99 on 8 and on 4 ranks, the recovery), words/s, each
    boundary's checkpoint bytes and upload seconds, peak memory; then
    the same stream fault-free without Sector (the stream's own rate;
    ``--profile``: the busy share of one more batch of each run);
11. ``batch-chaos``: phase 5's records segmented with no fault, then
    losing a rank at boundary 0 (resumes on 4 ranks), the ``(2, 4)`` grid
    losing one at boundary 0 (resumes on ``(2, 2)``), each giving phase
    5's sorted keys with the value rows beside them; the wordcount losing
    a rank between shuffle and reduce, equal to ``np.bincount``; the host
    sort of a 2^20-record prefix with ``kill_slave(phase=1, wipe=True)``
    and with ``drop_bucket(phase=1)``, equal to the fault-free run. Prints
    each run's wall beside the fault-free warm wall and the checkpoints'
    bytes and seconds (snapshot and restore). Phase 3 holds K1, K3 and K2
    at the shapes these two phases give them too;
12. ``serve-qwen2-moe``: Qwen1.5-MoE-A2.7B at its published config (24
    layers, d_model 2048, 60 experts padded to 64, top-4, 4 shared
    experts, vocabulary 151936), random weights drawn on the card from
    ``--seed`` (matrix weights bfloat16, 29.7 GB). (1) The grid prefill:
    8 prompts of 1024 tokens into caches of 1040 on ``Ranks(shape=(1,
    8), axes=("data", "model"))``, capacity factor 1.25, each MoE layer
    dispatching its tokens through the Sphere bucket shuffle (K1 for the
    send pack and for the per-expert regroup: exactly 48 launches a
    prefill), cold and warm, then 8 greedy decode steps (16 until the
    script's time limit needed the room) from those
    caches; prints walls, prefill tokens/s, ``moe_dropped``, ``moe_aux``,
    decode step p50, peak memory. (2) Held: layer 0's MoE at ``x`` of
    (2, 512, 2048) and capacity factor 8 drops nothing on the grid and
    stays within 0.3 of the dense dispatch; the 24-layer grid prefill at
    capacity factor 8 of 2 prompts of 512, dropping nothing, gives the
    next token of the dense prefill at the no-drop capacity factor (E / k
    + 1 = 16: the random routers send up to half the tokens to one
    expert, more than the dense dispatch holds at 8) wherever the dense
    top-2 margin exceeds 0.3 and the prompt's
    last token took the same experts in every layer of both runs (the
    largest logit difference and the rerouted layers printed; the sphere
    path ships routing probabilities in bfloat16, so a token near a tie
    may take another expert); two more grid prefills at 1.25 give logits
    identical to the bit. (3) ``ServeEngine``: the launcher's traffic (4
    slots, ``max_len`` 128, prompts of 4-12 tokens from
    ``default_rng(0)``, 12 new tokens, greedy), 8 requests so that slots
    refill: all complete, every token below the vocabulary; prints wall,
    tokens/s, step p50/p99, peak memory. Then the same traffic at a
    no-drop capacity factor (E / k + 1 = 16: at 1.25 a decode step of 4
    slots keeps one token an expert, so a token's experts depend on its
    batch), whose
    first two requests must give, at every step whose reference top-2
    margin exceeds 0.25, the token of a full ``lm_forward`` without
    caches over the same prefix. Phase 3 holds K1 at this phase's two
    shapes.
13. ``serve-model-zoo``: the other five families at their published
    configs (``configs/*.py``; MiniCPM3 at 16 of its 62 layers,
    Zamba2 at 19 of its 38 and xLSTM at 6 of its 12 since phase 19
    needed the room, ``ZOO_LAYERS``), random weights drawn on the card
    from ``--seed``, one model at a time, each freed before the next:
    minicpm3_4b (MLA), xlstm_125m (mLSTM + sLSTM), zamba2_1_2b (Mamba2 +
    shared attention), whisper_small (enc-dec) and internvl2_1b (VLM).
    (1) A prefill of 8 prompts of 1024 tokens into caches of 1040
    (internvl2: 256 image embeddings, then 768 text tokens; whisper: 8 x
    1500 frames, its native 30 s, and decoder prompts of 448 tokens,
    Whisper's text context, into caches of 464), cold and warm, then 16
    greedy decode steps; prints walls, prefill tokens/s, decode step p50
    and peak memory. (2) Two more warm prefills give logits identical to
    the bit; a full forward without caches over each prompt and its
    decoded tokens (for whisper the teacher-forced ``decode_stack``) gives
    the emitted token wherever its top-2 margin exceeds 0.25, or twice
    the decode's own rounding spread where that is larger, and logits
    within that same margin of the decode's: the spread is the largest
    logit difference between the batch's decode and each prompt's decode
    alone, fed the same tokens (the decode computes the full forward's
    function exactly, ``tests/test_torch_zoo_models.py``; only the
    products' shapes, so their rounding, differ, and a deep random stack
    amplifies it). The largest logit difference and the spread are
    printed. (3) ``ServeEngine`` with phase 12's
    traffic (frames for whisper, drawn as the launcher draws them): all
    8 requests complete, every token below the vocabulary. No kernel
    lies on these paths: every model's run reads zero launches of each.
14. ``train``: (1) ``train-tinyllama-1.1b``: TinyLlama-1.1B at its
    published width, its depth cut 22 -> 11 layers as phase 16's (the
    script's time limit), through ``repro_torch.launch.train.train``, the
    launcher's main path: a Sector deployment of 4 slaves with
    replication 2 in a ``tempfile.mkdtemp()`` directory, the synthetic
    corpus as 8 Sector slices, ``SectorDataPipeline`` batches of 8
    sequences of 2048 tokens, AdamW at the launcher's settings (lr 3e-3,
    warmup 20), 8 steps (16 before phase 18's room was made) with an
    async checkpoint at step 4 and the final blocking one (float32
    parameters, ``m`` and ``v``: 12 bytes a parameter; each slice
    uploaded and replicated by its own thread). Checks every loss and
    gradient norm finite, the first loss within 1.0 of ln(32000), zero
    kernel launches (the dense path has none, as in the JAX package);
    then one more batch: the same step twice from one state gives the
    same bits, and the final checkpoint restored into a fresh state
    (every slice's bytes checked against the manifest's MD5 by the
    restore, in a thread pool, and the index's MD5 of each slice equal
    to the manifest's; the state equal to the saved one to the bit)
    gives the same step to the bit. Prints step wall p50/p99, tokens/s,
    peak memory, checkpoint bytes, save, upload and restore seconds, the
    async upload's overlap with the steps, the Sector root's free disk
    and file system. (2)
    ``train-qwen2-moe-grid-1x8``: Qwen1.5-MoE-A2.7B at its published
    width with its depth cut to 2 layers (the one cut; 24 layers would
    need about 230 GB of training state), 3 steps of 8 x 1024 tokens on
    phase 12's ``(1, 8)`` grid: K1 4 times a MoE layer a step (the send
    pack and the regroup, in the forward and in the remat recompute),
    read from zero every step; the routed experts get no gradient (the
    shuffle's byte framing is not differentiable, as in the JAX package)
    and their update is the weight decay alone, ``w - lr * (wd * w)``, to
    the bit; every other leaf a non-zero gradient. Then the dense
    dispatch (no grid) gives every expert a gradient. Prints step wall,
    tokens/s, peak memory and ``moe_dropped``. Phase 3 holds K1 at this
    path's shapes (phase 12's).
15. ``ranks``: phases 5, 6, 7 and one MoE layer of phase 12's model as 8
    processes on the card (``repro_torch.comm.spawn_ranks``, one
    ``ProcessRanks`` each, ``backend="gloo"`` over CUDA tensors: NCCL
    takes one card a rank). Phase 5 wrote its records, phase 7 its words
    and phase 5 its sorted keys once to ``/dev/shm`` as ``.npy``; each
    process reads its rows. First the stacked backend reruns the four
    paths on those inputs (cold counts, warm wall) while the processes
    start and read their rows; then the processes run: the flat and the ``(dc, node)`` sort of the 2^25 records (K1,
    K3), the wordcount (K1, K2) and one Qwen1.5-MoE-A2.7B layer at its
    published width (60 experts padded to 64, top-4, capacity factor
    1.25) on 8 x 1024 tokens over ``(1, 8)``, each process holding the 8
    experts its spec gives it (K1 twice). Checks: the sorted keys equal
    phase 5's, every record delivered once beside its value; the word
    counts equal ``np.bincount``; each process's K1/K3/K2 launches and
    collective counts equal the stacked run's; the MoE routing, the
    per-expert counts and the drops exact, ``moe_aux`` within 1e-6
    relative, the output within one bfloat16 ulp of its largest value.
    A one-rank NCCL group runs the collectives against ``Ranks(1)``.
    Prints each path's cold and warm wall against the stacked one's,
    each collective's host seconds and the bytes each process hands to
    gloo per hop, and each process's peak memory. A process that raises
    or outlasts its limit fails the phase.
Phases 16-18 (and 19) share one spawn of 8 processes for their seven
    cells (and phase 19's three)
    (``train_grid_path``: the processes start first and train the cells
    one after another in ``GRID_CELL_ORDER``, each as soon as its
    reference on the card is done, while the next reference runs beside
    them (its own time and the cell's both read with the other running);
    phase 17's MoE cell on a ``(1, 8)`` grid built over the same
    processes and the others on ``(2, 4)``; then every cell is checked
    and printed under its phase's line), so that the processes start and
    warm up once and the references take no time of their own.
16. ``train_ranks``: TinyLlama-1.1B at its published width (d 2048, 32
    heads, 4 KV heads, d_ff 5632, vocab 32000, remat), its depth cut 22
    -> 11 layers to leave phase 17 room in the time limit, trained
    2 steps (3 before phase 18's room was made) as 8 processes on
    ``(data, model) = (2, 4)`` (``backend="gloo"`` over CUDA tensors,
    chosen by name: NCCL takes one card a rank), on the launcher's
    first 2 batches at 16 steps (8 x 2048 tokens; phase
    14's corpus before its cut to 8 steps) at the launcher's lr and
    warmup. First the one-process step on the card: its initial float32
    weights (phase 14's, seed 0) written to ``/dev/shm``, the first
    batch's gradient of a few leaves, 2 steps, the parameters after
    them; its memory freed. Then each process cuts its shards of the
    parameters (by their specs) and of the moments (ZeRO-1) from the
    saved weights (``init_train_state(..., ranks=)``) and runs
    ``jit_train_step``: heads sharded over ``model``, the batch over
    ``data``. Checks: every process's losses, norms and lrs the same
    bits; the first loss within 2e-3 and the second within 5e-3,
    ``grad_norm`` within 5e-3 relative of the one process's; the first
    step's gradient blocks within 3% of each leaf's largest value (the
    embedding's within 25%); the two wider bounds are full width's,
    stated with their measurement and cause at
    ``TRAIN_ATOL_LOSS_STEPPED``, and the one process's own floor (its
    gradient over two halves of the batch, its steps over two micro
    batches) is printed beside them; the parameters after 2 steps inside
    the trainer tests' rule (every one within ``2 * sum(lr)``, 99% within
    0.05 and half within 0.005 of it), each distinct block held by the
    first process that holds it against the reference's block; each
    process's parameter and moment bytes equal to the specs' arithmetic;
    the collectives of every step equal to the count from the layer
    count (``train_collectives``), none an ``all_gather`` over
    ``model``. Prints the warm step wall against the one process's, the
    last step's gloo bytes and seconds by op and axis, the peak memory a
    process. Then the checkpoints (``rank_checkpoint``, printed as the
    line's ``checkpoint``): the state after the 2 steps (550.0 M
    parameters x 12 B = 6.60 GB) saved by the 8 processes into a Sector
    deployment they share (4 slaves, replication 2, 4 slices: the
    launcher's; its root on ``/dev/shm``), the upload on the background
    thread (``SectorCheckpointer.save(..., blocking=False, ranks=,
    specs=)``); restored onto ``(data, model) = (4, 2)`` built over the
    same processes (``train.elastic.remesh_state``; the first checkpoint
    then deleted); saved again from ``(4, 2)``. No step runs on ``(4,
    2)``. Checks: the second checkpoint's slice MD5s, sizes and leaf
    table equal the first's; the leaf table is the one-process save's
    for the config (``leaf_table`` of the state on the ``meta`` device);
    every process's restored blocks have the ``(4, 2)`` specs' shapes
    and bytes, on its card; every slice has 2 holders; the Sector root
    stays below 40 GB. Prints the save, exchange, upload and restore
    seconds, each process's gloo bytes and seconds, and the root's bytes
    after each save with its file system. A process that raises or
    outlasts its limit fails the phase. Besides (the line
    ``train_ranks_split_kv``), ``train-tinyllama-1.1b-1x8-8proc-1xH100``:
    TinyLlama-1.1B at its published width, depth cut 22 -> 4, on
    ``(data, model) = (1, 8)``, where its 4 KV heads split over the 8
    model ranks (the split-dim KV layout: each process projects 32 of a
    KV head's 64 columns, gathers the keys and values whole over
    ``model`` before rope, its ``reduce_scatter`` in the backward, and
    attends its 4 query heads against the one KV head they use), 2 steps
    on 8 x 1024 tokens of the corpus at the launcher's optimizer,
    against the one-process step under phase 16's bounds but for the
    gradients' absolute term (``SPLIT_KV_BOUNDS``), the first and last
    layers' ``wq``, ``wk``, ``wv`` and ``wo`` among the held leaves; the reference also reads the planted faults of phase 18
    (half the batch's gradient halved, the steps without their update),
    and the phase fails where one reads within its bound.
17. ``train_ranks_families``: two paths, each as 8 gloo processes on
    ``cuda:0`` checked as phase 16 is (the MoE cell's printed as
    ``train_ranks_families_moe``, MiniCPM3's as
    ``train_ranks_families_mla``). (1)
    ``train-qwen2-moe-a2.7b-1x8-8proc-1xH100``: phase 14's MoE cell
    (Qwen1.5-MoE-A2.7B at its published width, 2 layers, its weights
    from the seed, its batch of 8 x 1024 uniform tokens three times, its
    optimizer) on ``(data, model) = (1, 8)``, against phase 14's stacked
    ``(1, 8)`` step rerun here: the 64 padded experts 8 a process, the
    shared experts and 2 attention heads a process column- and
    row-parallel, each process dispatching its 128 positions of every
    sequence through the sphere shuffle (K1 in the send pack and the
    regroup, 4 times a MoE layer a step with the remat recompute, counted
    in every process) and gathering the outputs over ``model``. Checks
    besides phase 16's: the first step's ``moe_aux`` and ``moe_dropped``
    the stacked step's (a few near-tie tokens may route elsewhere: 0.1%
    of the routed choices), the routed experts' gradient zero and their
    blocks after 3 steps equal to the stacked step's decay-only update
    to the bit, the router's first-step gradient held like every other
    leaf's. (2) ``train-minicpm3-4b-2x4-8proc-1xH100``: MiniCPM3-4B at
    its published width (MLA, 40 heads, q rank 768, kv rank 256), depth
    cut 62 -> 8, on ``(2, 4)``, 10 heads a model rank, phase 16's corpus
    batch (8 x 2048 tokens; 1 step, 2 before phase 19's room was made,
    3 before phase 18's) and optimizer, against the one-process step.
    Both models are
    far more sensitive to rounding at full width than the smoke configs,
    so the bounds are fixed numbers stated with
    their measurement (``MOE_RANKS_BOUNDS``, ``MLA_RANKS_BOUNDS``), and
    each but the CPU tests' own is shown able to fail: the reference also
    reads two planted faults, the gradient of the first half of the
    batch's rows halved (a partial gradient whose sum over two ranks is
    missing) and, for the MoE's repeated batch, the steps without their
    update, and the phase fails where a fault reads within its bound.
    MLA is held at its first step only (loss, norm, the last layer's
    gradients): past it the full-width model is chaotic, so it takes
    that one step (its parameters after it printed, not compared; its
    wall, read with the collective log on, is its warm step's). Prints
    each
    path's warm step against its reference, gloo bytes and seconds by op
    and axis, the peak memory a process and K1's launches.
18. ``train_ranks_cells``: four families as 8 gloo processes on
    ``cuda:0`` on ``(data, model) = (2, 4)`` (each process trains a
    cell, frees it, trains the next; the lines printed as
    ``train_ranks_cells_<family>``), each against the one-process step
    on the card and checked as phase 16 is. (1)
    ``train-xlstm-125m-2x4-8proc-1xH100``: xLSTM-125M at its published
    width (d 768, d_in 1536, 4 heads, chunk 256), depth cut 12 -> 6 (5
    mLSTM and the sLSTM at layer 5), one mLSTM head a model rank (the
    ``[z | x]`` exchange, q, k, v and gates summed by
    ``reduce_scatter``, the norm's squares summed), sLSTM's gates and
    output gathered around its recurrence, which every model rank runs
    whole. (2)
    ``train-zamba2-1.2b-2x4-8proc-1xH100``: Zamba2-1.2B at its published
    width (d 2048, d_in 4096, 64 SSM heads, state 64; the shared block's
    32 heads and d_ff 8192), depth cut 38 -> 6 (the shared block at
    layer 5), 16 SSM heads and 8 attention heads a model rank.
    Each trains 2 steps on 8 x 1024 tokens of phase 16's corpus. (3)
    ``train-whisper-small-2x4-8proc-1xH100``: Whisper-small at its
    published width (d 768, 12 heads, d_ff 3072, vocab 51865, 1500
    encoder frames), depth cut 12 + 12 -> 6 + 6, its 12 heads against
    ``tp_size`` 16 in the sequence layout (375 encoder frames and 112
    decoder positions of query rows a model rank; the cross-attention
    over all 1500 frames, their keys and values each rank's products of
    the encoder output, which enters the decoder through one
    ``copy_to``): 8 rows of stub frames drawn on the card from the seed,
    448 tokens of the corpus under a ``loss_mask`` of transcript lengths
    64-448 drawn from the seed, the loss the global masked mean. (4)
    ``train-internvl2-1b-2x4-8proc-1xH100``: InternVL2-1B's LM at its
    published width (d 896, 14 heads, 2 KV heads, d_ff 4864, vocab
    151655), depth cut 24 -> 12, sequence layout: 8 rows of 256 image
    embeddings drawn on the card in front of 768 tokens of the corpus,
    the loss on the text. All at the launcher's lr and warmup. The
    reference also reads the one process's own floor (its first gradient
    over two halves of the batch, its steps over two micro batches) and
    two planted faults: the gradient of the batch's first half of rows
    halved, and the steps without their update. The bounds are fixed
    numbers stated with their measurement (``SSM_RANKS_BOUNDS``;
    ``ENCDEC_RANKS_BOUNDS``, the same, fixed before the new cells' first
    reading), with no absolute term on the gradients; each held reading
    is printed beside its bound, its planted fault and the floor, and the
    phase fails where a fault reads within its bound. Checks as phase
    16's: the processes' metrics the same bits, the first step's loss,
    norm and named leaves' gradients, the second step's loss and norm,
    the parameters after 2 steps by the trainer tests' rule, the state's
    bytes, the collectives a step (``train_collectives``, the mask's
    count among them) and the ``all_gather``s over ``model`` of
    activations only (``model_gathers``). Prints each path's cold and
    warm step against the one process's, gloo bytes and seconds by op
    and axis, the peak memory a process and, for Whisper, each data
    rank's unmasked tokens.
19. ``serve_ranks``: serving as 8 processes, in phases 16-18's spawn
    after their cells (each cell handed over as its reference on the
    card ends, one ahead, as theirs are; the lines printed as
    ``serve_ranks_<cell>``). Each process holds its blocks of the
    weights (``init(..., ranks=)``: each tensor drawn whole on the card
    from the seed, the block its spec gives the process kept), its data
    rows of the prompts (every data rank the whole row of a batch of
    one) and its blocks of the caches (``init_caches(..., ranks=)``, as
    the JAX package's ``cache_specs`` lay them out), prefills through
    ``prefill`` and decodes ``DECODE_STEPS`` steps through
    ``decode_step`` teacher-forced on the reference's greedy tokens.
    The first four cells prefill phase 12's 8 prompts of 1024 tokens
    into caches of 1040 slots. (1)
    ``serve-tinyllama-1.1b-2x4-8proc-1xH100``: TinyLlama-1.1B whole
    (22 layers) on ``(2, 4)``, 8 heads and 1 of the 4 KV heads a model
    rank; the caches keep every KV head (``cache_specs`` shard KV heads
    only where 16 divides them), so each layer gathers the new keys and
    values over ``model``, writes every head and reads its own back.
    (2) ``serve-minicpm3-4b-2x4-8proc-1xH100``: MiniCPM3-4B at phase
    17's 8 layers on ``(2, 4)``, 10 MLA heads a model rank over the
    latent cache every rank writes whole. (3)
    ``serve-qwen2-moe-a2.7b-1x8-8proc-1xH100``: phase 12's
    Qwen1.5-MoE-A2.7B (24 layers, its weights and prompts) on ``(1,
    8)``: the prefill through the sphere shuffle (K1 twice a MoE layer
    in every process), every decode step through the expert-sharded
    dense dispatch (8 experts a process, the capacity counted over the
    whole batch). (4) ``serve-xlstm-125m-2x4-8proc-1xH100``: xLSTM-125M
    whole (12 layers) on ``(2, 4)``: one mLSTM head a model rank, its
    states kept whole in the caches (16 does not divide the 4 heads), so
    each mLSTM layer gathers the new states over ``model``; the conv
    windows the rank's channels; sLSTM's state whole on every rank,
    whose recurrence each runs whole. (5)
    ``serve-zamba2-1.2b-long-500k-2x4-8proc-1xH100``: Zamba2-1.2B at 12
    of its 38 layers (the shared block at layers 5 and 11) at
    ``long_500k``'s batch of one and 524288 slots on ``(2, 4)``: a prompt
    of 64 tokens, decoded at positions 262140-262147; the shared block's
    caches time-sharded over ``data`` (each data rank 262144 slots, 8 of
    the 32 KV heads a model rank: 1.07 GB of the 8.6 GB a process), each
    new position written only into the block that holds its slot, the
    blocks' scores combined by a ``pmax`` and two sums over ``data``;
    Mamba2's 64 heads owned, 16 a rank. (6)
    ``serve-tinyllama-1.1b-1x8-8proc-1xH100``: TinyLlama-1.1B at phase
    16's 11 layers on ``(1, 8)``, its 4 KV heads split over the 8 model
    ranks: each layer gathers the new keys' and values' columns whole
    over ``model`` (one ``all_gather``) before rope and writes every
    head into the caches, which keep every KV head; 4 decode steps. The
    references on the card: the
    one process's prefill and greedy decode (the MoE: phase 12's stacked
    grid prefill on ``Ranks(1, 8)`` and its decode), with planted faults
    read: a decode step from caches whose layer 0 was left unwritten,
    the largest attention cache entry at the last step's slot (a write
    skipped), and the recurrent layers' change at the last step (a state
    not written back). Checks: every call's logits, every written
    attention cache slot and every recurrent leaf (relative to its
    largest entry) within ``SERVE_RANKS_BOUNDS``, each below its fault's
    reading; ``pos`` equal and empty slots zero; ``moe_dropped`` the
    reference's; each decode step's collectives ``serve_collectives``';
    K1 as said and none in a decode step; each process's cache bytes the
    specs'. Prints the prefill wall and tokens/s, the decode step p50,
    the collectives of the prefill and of a decode step by op and axis
    (gloo bytes and host seconds), the peak memory and the weight and
    cache bytes a process, beside the reference's walls.

20. ``dryrun_check``: the dry run (``repro_torch.launch.dryrun``) held
    to the card. A subprocess, started after the build and running on
    the CPU beside the phases after it, traces phase 16's steps on fake
    grids (``dryrun.trace``: a ``fake`` process group and
    ``FakeTensorMode``, rank 0's program; ``DRYRUN_CELLS``): TinyLlama-1.1B
    at 11 layers, 8 x 2048 tokens on ``(2, 4)``, and its split-dim KV
    cell, 4 layers, 8 x 1024 tokens on ``(1, 8)``, each with phase 16's
    remat, no master copy and ZeRO-1. Checks: each trace's collectives
    by op and axes (calls and bytes) equal to the logged step of its
    cell's process 0 exactly, and its peak live bytes within
    ``DRYRUN_PEAK_SHARE`` of every process's
    ``torch.cuda.max_memory_allocated()`` over the cell's steps (the
    lines ``dryrun_check`` and ``dryrun_check_split_kv``). Prints
    both, the trace's seconds and each process's memory at the start of
    the steps beside the trace's state bytes.

Each path's launch counts are read from zero: every count is reset just
before the path runs and read just after. The last lines are the
script's total seconds, the kernel table as one JSON object, the ``nvidia-smi`` name/power line, and
``{"ok": true, "device": {...}}``. Imports nothing of JAX and nothing of
the JAX package.
"""

from __future__ import annotations

import argparse
import atexit
import contextlib
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

#: H100 SXM device-memory rate (NVIDIA data sheet), bytes/s.
HBM_BYTES_PER_S = 3.35e12
WORLD = 8
GRID = (2, 4)                # the wide-area (dc, node) grid of the 8 ranks
VALUE_BYTES = 96             # + the 4-byte key = one 100-byte record
VOCAB = 1 << 20              # wordcount vocabulary
ZIPF_A = 1.1
TIMED_ITERS = 10
#: bytes a kv element moves through K2's one-sweep design: 4 for the
#: histogram's read of the keys, 16 in each of the 4 digit passes
K2_BYTES_PER_KV = 4 + 4 * 16
#: phase 12: Qwen1.5-MoE-A2.7B served at its published config; the grid
#: prefill's prompts, their length and the caches' length; decode steps;
#: the engine's traffic (the launcher's, with 8 requests)
SERVE_ARCH = "qwen2_moe_a2_7b"
SERVE_GRID = (1, 8)            # ("data", "model"): 8 expert ranks
PREFILL_PROMPTS, PREFILL_LEN, PREFILL_MAX_LEN = 8, 1024, 1040
DECODE_STEPS = 8
SERVE_REQUESTS, SERVE_SLOTS, SERVE_MAX_LEN, SERVE_NEW = 8, 4, 128, 12
#: the CPU tests' bounds between two paths of one model: the sphere
#: against the dense dispatch (tests/test_spmd.py, 0.3) and decoding
#: through caches against a full forward (tests/test_models.py, 0.25)
SPHERE_DENSE_TOL, DECODE_TOL = 0.3, 0.25
#: the held checks' capacity factor: no token dropped (tests/test_spmd.py)
CHECK_CF = 8.0
#: phase 13: the other five families at their published configs; whisper's
#: decoder prompts are its published text context
#: their depths where phase 19's room in the script's time limit cut them
#: (MiniCPM3 62 -> 16, Zamba2 38 -> 19, xLSTM 12 -> 6: every block kind
#: and, for Zamba2, 3 of the shared block's 6 points kept; MiniCPM3 at
#: 31 until phase 19's recurrent cells needed more room; phase 19 serves
#: xLSTM whole and Zamba2 at 12 layers on one card as its references)
ZOO_LAYERS = {"minicpm3_4b": 16, "zamba2_1_2b": 19, "xlstm_125m": 6}
ZOO_ARCHS = ("minicpm3_4b", "xlstm_125m", "zamba2_1_2b", "whisper_small",
             "internvl2_1b")
WHISPER_PROMPT_LEN = 448
#: phase 10: its words, words a micro-batch (8 requests of 2^18), the
#: carry's rows a rank, the 256 requests' tenants and weights, the steps
STREAM_WORDS = 1 << 26
STREAM_BATCH = 1 << 21
STREAM_REQUEST = 1 << 18
STREAM_CARRY = 1 << 18
TENANTS = {"free": 1.0, "pro": 3.0, "enterprise": 4.0}
STREAM_STEPS = 34
#: phase 14: TinyLlama-1.1B at its published width through the launcher's
#: functions, its depth cut 22 -> 11 as phase 16's (8 sequences of its
#: 2048-token context, 8 steps, an async save at step 4, the launcher's
#: lr and warmup); Qwen1.5-MoE-A2.7B at its published width with its
#: depth cut to 2 layers, 3 steps on phase 12's grid and prompts
TRAIN_ARCH = "tinyllama_1_1b"
TRAIN_LAUNCH_LAYERS = 11
TRAIN_LAUNCH_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_CKPT_EVERY = 8, 8, 2048, 4
#: the schedule's ``total_steps`` and the corpus's length that phases
#: 16-18 build from: the launcher's at 16 steps, phase 14's before its cut
#: to 8 (``synthetic_tokens`` draws another corpus for another length)
TRAIN_STEPS = 16
TRAIN_LR = 3e-3
MOE_TRAIN_LAYERS, MOE_TRAIN_STEPS = 2, 3
#: phase 15: the 8 processes' time limit, and the MoE layer's bound
#: against the stacked one: one bfloat16 ulp of the output's largest value
RANKS_TIMEOUT_S = 600
MOE_RANKS_TOL = 2.0 ** -7
#: phase 16: TinyLlama-1.1B at its published width, depth cut 22 -> 11
#: (phase 17's room in the script's time limit; at 6 layers its first
#: grad_norm reads 0.67%, and so does the one process against its own two
#: micro batches: beyond the 0.5% held), trained as 8 processes on the
#: (data, model) grid, against the one-process step on phase 14's first
#: batches, 2 steps (3 before phase 18's room was made; phase 17's
#: MiniCPM3 takes the same batches; every (2, 4) cell of phases 16-18
#: trains 2 steps, in one spawn); the CPU tests' bounds
#: (tests/test_torch_train_dist.py)
TRAIN_RANKS_GRID = (2, 4)
TRAIN_RANKS_LAYERS = 11
TRAIN_RANKS_STEPS = 2
#: the order in which phases 16-18's processes train their cells, each
#: beside the next cell's reference on the card: a cell and the next
#: reference together at most about 60 GB of the card's 80 (the
#: processes' peak memory and the references' as read on an NVIDIA H100
#: 80GB HBM3: zamba2 13 and 9 GB, the MoE 37 and 44, Whisper 12 and 6,
#: TinyLlama 38 and 31, xLSTM 9 and 10, InternVL2 21 and 24, MiniCPM3
#: 44 and 34), a short reference first, beside the processes' start;
#: and the one spawn's time limit, the references included
GRID_CELL_ORDER = ("zamba2_1_2b", "qwen2_moe_a2_7b", "whisper_small",
                   "tinyllama_1_1b", "xlstm_125m", "internvl2_1b",
                   "minicpm3_4b")
GRID_TIMEOUT_S = 900
#: phase 20: the share of a process's peak memory over phase 16's steps
#: (``torch.cuda.max_memory_allocated``) within which the dry run's trace
#: of the step must read its peak live bytes. The trace counts each
#: tensor's storage bytes; the card's allocator also holds what no
#: tensor of the program shows: its blocks rounded up to 512 bytes, the
#: cuBLAS and cuBLASLt workspaces of each thread that runs products
#: (the forward's and autograd's), the scratch CUDA kernels take from
#: it, and whatever tensors earlier cells left alive in the process.
#: Phase 16's readings on an NVIDIA H100 80GB HBM3 at 700 W before this
#: phase (4.754e9 to 4.761e9 bytes) lie 5.4-5.5% above the trace's
#: 4.4997e9 bytes; its split-dim KV cell's, alone on the card
#: (1.6302e9 to 1.6312e9), 4.7-4.8% above 1.5531e9
DRYRUN_PEAK_SHARE = 0.10
#: phase 16's checkpoints: the state after its steps saved from (2, 4) as
#: 4 slices (the launcher's), restored onto (4, 2) and saved again; the
#: Sector root's bound (/dev/shm is host memory: 2 x 7.39 GB a checkpoint
#: at replication 2, one checkpoint held at a time)
CKPT_RANKS_GRID = (4, 2)
CKPT_SLICES = 4
CKPT_ROOT_LIMIT = 40e9
TRAIN_ATOL_LOSS, TRAIN_RTOL_GNORM = 2e-3, 5e-3
TRAIN_RTOL_GRAD, TRAIN_ATOL_GRAD = 0.03, 1e-3
#: the two bounds full width needs wider than the CPU tests' (measured on
#: an NVIDIA H100 80GB HBM3 at 700 W): the loss after a step (2.6e-3 at
#: step 2, and 4.8e-3 between the one process's steps over the whole
#: batch and over two micro batches: AdamW's first update moves a
#: weight by lr * sign(g), so each gradient whose rounding flips its sign
#: moves it by 2 lr, over 1.03e9 weights, and the launcher's lr makes the
#: loss climb, 10.86 -> 11.87, with a norm of 116 at step 2), and the
#: embedding's gradient (11.2% of its largest value, and 11.1% between
#: the one process's gradient and the mean of its two halves': the one
#: process sums a token's rows in bfloat16, ``emb.to(bfloat16)[tokens]``'s
#: scatter-add, over up to ~1560 repeats of a Zipf token; the processes
#: sum a quarter of the vocabulary over half the rows each)
TRAIN_ATOL_LOSS_STEPPED = 5e-3
TRAIN_RTOL_GRAD_EMBED = 0.25
TRAIN_RANKS_BOUNDS = {
    "loss_first": TRAIN_ATOL_LOSS, "grad_norm_rel_first": TRAIN_RTOL_GNORM,
    "loss": TRAIN_ATOL_LOSS_STEPPED, "grad_norm_rel": TRAIN_RTOL_GNORM,
    "grad_rtol": TRAIN_RTOL_GRAD, "grad_atol": TRAIN_ATOL_GRAD,
    "grad_rtol_leaf": {"embed": TRAIN_RTOL_GRAD_EMBED},
    "params": {"max_over_sum_lr": 2.0, "share_beyond_0.05_sum_lr": 0.01,
               "share_beyond_0.005_sum_lr": 0.5}}
#: phase 16's split-dim KV cell: TinyLlama-1.1B at its published width,
#: depth cut 22 -> 4, on (1, 8), where its 4 KV heads split over 8 model
#: ranks (each process holds half a KV head's 64 columns, gathered whole
#: before rope): 2 steps on 8 x 1024 tokens of phase 16's corpus at the
#: launcher's optimizer, against the one-process step under
#: ``TRAIN_RANKS_BOUNDS``, beside the planted faults; the leaves whose
#: first-step gradient blocks are held (the first and the last layer's
#: attention)
SPLIT_KV_GRID = (1, 8)
SPLIT_KV_LAYERS, SPLIT_KV_SEQ = 4, 1024
#: its bounds: phase 16's without the gradients' absolute term, whose
#: 1e-3 exceeds the last layer's whole ``wq`` and ``wk`` gradients at
#: init (largest entries 8.5e-4 and 1.0e-3 on an NVIDIA H100 80GB HBM3
#: at 700 W), where the planted faults would read within it; each held
#: leaf within 3% of its largest value (the processes read 0.1-1.1%,
#: the half-batch fault 31-64%)
SPLIT_KV_BOUNDS = dict(TRAIN_RANKS_BOUNDS, grad_atol=0.0)
SPLIT_KV_GRAD_LEAVES = (
    "embed", "final_ln", "blocks.0.attn.wq", "blocks.0.attn.wk",
    "blocks.0.attn.wv", "blocks.0.attn.wo", "blocks.3.attn.wq",
    "blocks.3.attn.wk", "blocks.3.attn.wv", "blocks.3.attn.wo",
    "blocks.3.mlp.w_down")
#: phase 20's traced cells: phase line, depth, grid, positions a row
DRYRUN_CELLS = {
    "train_ranks": (TRAIN_RANKS_LAYERS, TRAIN_RANKS_GRID, TRAIN_SEQ),
    "train_ranks_split_kv": (SPLIT_KV_LAYERS, SPLIT_KV_GRID,
                             SPLIT_KV_SEQ)}
#: leaves whose first-step gradient blocks are held to the one process's
TRAIN_GRAD_LEAVES = ("embed", "final_ln", "blocks.0.ln1", "blocks.0.attn.wq",
                     "blocks.0.attn.wk", "blocks.5.attn.wo",
                     "blocks.10.mlp.w_gate", "blocks.10.mlp.w_down")
#: phase 17: phase 14's MoE cell (Qwen1.5-MoE-A2.7B, 2 layers, (1, 8)) and
#: MiniCPM3-4B at its published width, depth cut 62 -> 8, on (2, 4), each
#: trained as 8 processes; the leaves whose first-step gradient blocks
#: are held to the reference's (the routed experts': zero)
MOE_RANKS_GRAD_LEAVES = ("embed", "final_ln", "blocks.0.attn.wq",
                         "blocks.1.attn.wo", "blocks.0.ln2",
                         "blocks.0.moe.router", "blocks.1.moe.router",
                         "blocks.0.moe.ws_gate", "blocks.1.moe.ws_down",
                         "blocks.1.moe.shared_gate", "blocks.0.moe.w_gate",
                         "blocks.1.moe.w_down")
MLA_TRAIN_ARCH, MLA_TRAIN_LAYERS = "minicpm3_4b", 8
#: MiniCPM3's steps as 8 processes: only the first is held (past it the
#: full-width model is chaotic), so one since phase 19 needed the room
MLA_TRAIN_STEPS = 1
#: phase 17's bounds for the MoE path against the stacked step (measured
#: on an NVIDIA H100 80GB HBM3 at 700 W; beside each, in brackets, how far
#: the stacked step moved when rerun with the models' products in
#: float32, a sample of what rounding alone does at this width): the
#: CPU tests' bounds for the first step's loss and norm (2.2e-4 and
#: 4.0e-4 measured); the later losses 6.9e-3 and 1.2e-2 (1.4e-3, 1.7e-2),
#: norms 0.79% and 0.08% (0.39%, 0.31%); the first step's gradients up to
#: 8.4% of a leaf's largest value (8.6%), the embedding's 20.4% (15.7%),
#: with no absolute term (the CPU tests' 1e-3 exceeds the routers' whole
#: gradient); after 3 steps 1.2% of the parameters beyond 0.05 * sum(lr)
#: (2.1%); ``moe_aux`` 1e-4 relative and 2 of 65536 routed choices
#: dropped otherwise (near-tie tokens routed elsewhere).
MOE_RANKS_BOUNDS = {
    "loss_first": TRAIN_ATOL_LOSS, "grad_norm_rel_first": TRAIN_RTOL_GNORM,
    "loss": 0.05, "grad_norm_rel": 0.02,
    "grad_rtol": 0.15, "grad_rtol_leaf": {"embed": 0.3},
    "params": {"max_over_sum_lr": 2.0, "share_beyond_0.05_sum_lr": 0.05,
               "share_beyond_0.005_sum_lr": 0.5},
    "moe_aux_rel": 1e-3, "moe_dropped_share": 1e-3}
#: the MLA path's bounds against the one-process step: its first step
#: only. Rerun with float32 products, the one process moved its first
#: step's loss by 1.2e-3 and its norm by 0.9%, the last layer's
#: ``wo``'s and ``w_down``'s gradients by 5.0% and 7.1% of their largest
#: values, but layer 0's by 65-85% and layer 3's ``wk_up``'s by 67%: each
#: layer's attention backward amplifies rounding, so only the last
#: layer's leaves and ``final_ln`` are held, with no absolute term. The
#: processes: ``final_ln`` and the last layer's norms, ``wkv_down``,
#: ``wv_up``, ``wo`` and ``w_down`` 1.0-7.9% of their largest values,
#: its query path (``wq_down``, ``q_norm``, ``wq_up``) and ``wk_up``,
#: which reach the loss through the softmax's backward, 15-27%. After
#: one update the step-3 loss moved by 0.20 and 79% of the parameters by
#: more than 0.05 * sum(lr): no later step is compared.
MLA_QK_LEAVES = ("blocks.7.attn.wq_down", "blocks.7.attn.q_norm",
                 "blocks.7.attn.wq_up", "blocks.7.attn.wk_up")
MLA_RANKS_BOUNDS = {
    "loss_first": TRAIN_ATOL_LOSS, "grad_norm_rel_first": TRAIN_RTOL_GNORM,
    "grad_rtol": 0.1, "grad_rtol_leaf": dict.fromkeys(MLA_QK_LEAVES, 0.4)}
MLA_RANKS_GRAD_LEAVES = ("final_ln", "blocks.7.ln1",
                         "blocks.7.attn.wq_down", "blocks.7.attn.q_norm",
                         "blocks.7.attn.wkv_down", "blocks.7.attn.kv_norm",
                         "blocks.7.attn.wq_up", "blocks.7.attn.wk_up",
                         "blocks.7.attn.wv_up", "blocks.7.attn.wo",
                         "blocks.7.mlp.w_down")
#: phase 18: xLSTM-125M at its published width with its depth cut 12 ->
#: 6 (5 mLSTM layers and the sLSTM at layer 5; whole until phase 19's
#: xLSTM cell needed the room: its sLSTM loop is host-bound, and its
#: reference's steps outlasted the processes' previous cell) and
#: Zamba2-1.2B at its published width with its depth cut 38 -> 6 (one
#: point of the shared block, at layer 5; 12 layers and a second point
#: at layer 11 until the script's time limit needed the room), each
#: trained 2 steps as 8 processes on
#: (2, 4) on 8 x 1024 tokens of phase 16's corpus, against the one-process
#: step; by architecture: (the cell, depth or None, the leaves whose
#: first-step gradient blocks are held)
SSM_RANKS_SEQ = 1024
SSM_RANKS_CELLS = {
    "xlstm_125m": ("train-xlstm-125m-2x4-8proc-1xH100", 6, (
        "embed", "final_ln", "blocks.0.cell.up_proj", "blocks.0.cell.wqkv",
        "blocks.0.cell.wif", "blocks.4.cell.norm", "blocks.4.cell.wqkv",
        "blocks.5.cell.w_gates", "blocks.5.cell.r_gates",
        "blocks.5.cell.norm", "blocks.5.cell.out_proj")),
    "zamba2_1_2b": ("train-zamba2-1.2b-2x4-8proc-1xH100", 6, (
        "embed", "final_ln", "blocks.0.mamba.in_zx", "blocks.0.mamba.in_bcdt",
        "blocks.5.mamba.in_zx", "blocks.5.mamba.in_bcdt",
        "blocks.5.mamba.a_log", "blocks.5.mamba.dt_bias",
        "blocks.5.mamba.d_skip", "blocks.5.mamba.norm",
        "blocks.5.mamba.out_proj", "shared_attn.attn.wq",
        "shared_attn.mlp.w_down"))}
#: phase 18's bounds against the one-process step (measured on an NVIDIA
#: H100 80GB HBM3 at 700 W; PERF.md section 6 has each reading): the CPU
#: tests' for the first step's loss and norm (read: 1e-5 and 0.12% for
#: xLSTM, 4.4e-4 and 0.003% for zamba2); phase 16's full-width 5e-3 for
#: the second step's loss (read: 1.4e-3 and 2.7e-4; the one process
#: against its own steps over two micro batches, 1.6e-3 for xLSTM); the
#: second step's norm 2% and each held leaf's first gradient 15% of its
#: largest value, with no absolute term (the per-head vectors' whole
#: gradients lie below the CPU tests' 1e-3): rerun with the models'
#: products in float32, the one process moved its first gradients by
#: 3.2-11.5% (xLSTM) and 1.4-9.6% (zamba2) of their largest values and
#: xLSTM's norm by 1.1%, a sample of what rounding alone does at these
#: widths; the processes read up to 7.1% and 0.62% (xLSTM through
#: autograd's sLSTM backward, 0.14% through the hand-written one; zamba2,
#: set before its first reading: 6.0% and 0.012%); half the batch's
#: gradient reads 0.48-1.03 and 0.30. The parameters after 2 steps: the
#: trainer tests' rule (99% within 0.05 and half within 0.005 of
#: sum(lr)) cannot hold at full width, where the launcher's warmup lr
#: (1.5e-4, then 3e-4) moves each weight by about lr * sign(g): the one
#: process against its own steps over two micro batches has 16% of
#: xLSTM's parameters beyond 0.05 sum(lr) and 64% beyond 0.005 sum(lr)
#: (zamba2 2.5% and 38%; the processes 31% and 80%, zamba2 5.8% and
#: 55%), so the shares are held at about twice xLSTM's readings, below
#: the steps without their update (94% and 95%); every weight within
#: 2.5 sum(lr) (two sign flips give 2, read 1.999)
SSM_RANKS_BOUNDS = {
    "loss_first": TRAIN_ATOL_LOSS, "grad_norm_rel_first": TRAIN_RTOL_GNORM,
    "loss": TRAIN_ATOL_LOSS_STEPPED, "grad_norm_rel": 0.02,
    "grad_rtol": 0.15,
    "params": {"max_over_sum_lr": 2.5, "share_beyond_0.05_sum_lr": 0.6,
               "share_beyond_0.005_sum_lr": 0.95}}
#: phase 18's enc-dec and VLM cells (in phase 18's spawn):
#: Whisper-small and InternVL2-1B at their published widths, depths cut
#: (Whisper 12 + 12 -> 6 + 6 layers, InternVL2 24 -> 12) to fit the
#: script's time limit, each trained 2 steps as 8 processes on (2, 4)
#: against the one-process step; by architecture: (the cell, the
#: config's cuts, the leaves whose first-step gradient blocks are held).
#: Whisper: 8 rows of 1500 stub frames drawn on the card from the seed,
#: 448 decoder tokens of phase 16's corpus (its published text context,
#: ``WHISPER_PROMPT_LEN``) under a ``loss_mask`` of transcript lengths
#: drawn from the seed, 64 to 448 tokens a row; InternVL2: 8 rows of 256
#: image embeddings drawn on the card in front of 768 text tokens of the
#: corpus
ENCDEC_RANKS_CELLS = {
    "whisper_small": ("train-whisper-small-2x4-8proc-1xH100",
                      {"enc_layers": 6, "num_layers": 6}, (
        "embed", "final_ln", "enc_ln", "enc_blocks.0.attn.wq",
        "enc_blocks.5.attn.wo", "enc_blocks.5.mlp.w_up",
        "dec_blocks.0.self_attn.wq", "dec_blocks.5.self_attn.wv",
        "dec_blocks.5.ln_x", "dec_blocks.5.cross_attn.wq",
        "dec_blocks.5.cross_attn.wk", "dec_blocks.5.cross_attn.wo",
        "dec_blocks.5.mlp.w_down")),
    "internvl2_1b": ("train-internvl2-1b-2x4-8proc-1xH100",
                     {"num_layers": 12}, (
        "embed", "final_ln", "img_proj", "blocks.0.ln1",
        "blocks.0.attn.wq", "blocks.0.attn.wk", "blocks.11.attn.wv",
        "blocks.11.attn.wo", "blocks.11.mlp.w_gate",
        "blocks.11.mlp.w_down"))}
WHISPER_TRANSCRIPT_MIN = 64
VLM_TEXT_LEN = 768
#: the enc-dec and VLM cells' bounds, fixed before their first reading:
#: phase 18's SSM and hybrid bounds (``SSM_RANKS_BOUNDS``, set from
#: their one process's float32-products sample at full width: the first
#: gradients moved 1.4-11.5% by rounding alone), unchanged; each
#: held reading is printed beside the one process's own floor (its steps
#: over two micro batches) and the planted half-batch fault, and the
#: phase fails where a fault reads within its bound
ENCDEC_RANKS_BOUNDS = dict(SSM_RANKS_BOUNDS)
#: phase 19: serving as 8 processes in phases 16-18's spawn, after their
#: cells: (phase line, cell, arch, (data, model) grid, depth or None for
#: the published one). Each prefills its prompts into its caches
#: (``serve_shape``: phase 12's 8 prompts of 1024 tokens into 1040 slots
#: unless ``SERVE_RANKS_SHAPES`` says otherwise) and decodes
#: ``DECODE_STEPS`` steps teacher forced on its reference's greedy
#: tokens: TinyLlama-1.1B whole (the heads layout; its 4 KV heads kept
#: whole in the caches, gathered over ``model`` a layer), MiniCPM3-4B at
#: phase 17's 8 layers (MLA, 10 heads a process), Qwen1.5-MoE-A2.7B whole
#: (phase 12's model and prompts: the sphere prefill with K1, the decode
#: through the expert-sharded dense dispatch), xLSTM-125M whole (10
#: mLSTM layers whose 4 heads the caches keep whole, gathered over
#: ``model`` a layer; 2 sLSTM layers) and Zamba2-1.2B at 12 of its 38
#: layers (two points of the shared block) at ``long_500k``'s batch of
#: one and 524288 slots: the shared block's caches time-sharded over
#: ``data``, its 32 KV heads over ``model``, Mamba2's 64 heads owned by
#: rank; and TinyLlama-1.1B at phase 16's 11 layers on (1, 8), its 4 KV
#: heads split over the 8 model ranks (the split-dim KV layout: half a
#: KV head's columns a process, gathered whole a layer, every head
#: written into the caches)
SERVE_RANKS_CELLS = (
    ("serve_ranks_tinyllama", "serve-tinyllama-1.1b-2x4-8proc-1xH100",
     TRAIN_ARCH, TRAIN_RANKS_GRID, None),
    ("serve_ranks_mla", "serve-minicpm3-4b-2x4-8proc-1xH100",
     MLA_TRAIN_ARCH, TRAIN_RANKS_GRID, MLA_TRAIN_LAYERS),
    ("serve_ranks_moe", "serve-qwen2-moe-a2.7b-1x8-8proc-1xH100",
     SERVE_ARCH, SERVE_GRID, None),
    ("serve_ranks_xlstm", "serve-xlstm-125m-2x4-8proc-1xH100",
     "xlstm_125m", TRAIN_RANKS_GRID, None),
    ("serve_ranks_zamba2_long",
     "serve-zamba2-1.2b-long-500k-2x4-8proc-1xH100", "zamba2_1_2b",
     TRAIN_RANKS_GRID, 12),
    ("serve_ranks_split_kv", "serve-tinyllama-1.1b-1x8-8proc-1xH100",
     TRAIN_ARCH, SPLIT_KV_GRID, TRAIN_RANKS_LAYERS))
#: the cells whose shape is not phase 12's: Zamba2-1.2B at long_500k, one
#: row into its 524288 slots (8.6 GB of caches, 1.07 GB a process), a
#: prompt of 64 (the prefill attends over the whole cache: a longer
#: prompt's float32 scores would not fit the 8 processes and the
#: reference on one card), decoded at 262140-262147, which straddle the
#: boundary of the two data ranks' time blocks; TinyLlama's, MiniCPM3's
#: and the MoE's 4 decode steps, not 8, since the two cells above needed
#: the room in the script's time limit (PERF.md has their readings at 8)
SERVE_RANKS_SHAPES = {
    "serve_ranks_zamba2_long": {"prompts": 1, "prompt_len": 64,
                                "cache_len": 524288, "first_pos": 262140},
    **{line: {"steps": 4} for line in ("serve_ranks_tinyllama",
                                       "serve_ranks_mla", "serve_ranks_moe",
                                       "serve_ranks_split_kv")}}
#: phase 19's bounds against the reference, by cell: the logits
#: (float32, the real vocabulary) over every call, each written
#: attention cache slot, each recurrent cache leaf relative to its
#: largest entry, and the MoE's share of routed choices that differ
SERVE_RANKS_BOUNDS = {
    "serve_ranks_tinyllama": {"logits": 0.25, "cache": 0.25},
    "serve_ranks_mla": {"logits": 1.5, "cache": 2.0},
    "serve_ranks_moe": {"logits": 2.25, "cache": 1.0,
                        "moved_share": 0.12},
    "serve_ranks_xlstm": {"logits": 0.75, "state": 0.15},
    "serve_ranks_zamba2_long": {"logits": 0.25, "cache": 0.25,
                                "state": 0.15},
    "serve_ranks_split_kv": {"logits": 0.25, "cache": 0.25}}
#: phase 15's paths in the kernel table
RANKED_PATHS = (("flat", "dataflow sort, flat"),
                ("grid", "dataflow sort, (dc, node)"),
                ("wordcount", "wordcount"),
                ("moe", "one Qwen1.5-MoE-A2.7B layer on (1, 8)"))


def log(*parts) -> None:
    print(*parts, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int = TIMED_ITERS) -> float:
    """Median device time of ``fn`` in ms (CUDA events, 2 warm-up runs)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


class Check:
    """Collects one kernel's comparison against its plain version."""

    def __init__(self, name: str):
        self.name = name
        self.max_abs_err = 0
        self.cases = 0

    def equal(self, what: str, got, want, mask=None) -> None:
        """Exact comparison (tolerance 0: all data here is integer or a
        permutation of the input); records the max |got - want|."""
        import torch
        if got.shape != want.shape:
            raise AssertionError(f"{self.name} {what}: shape {tuple(got.shape)}"
                                 f" != {tuple(want.shape)}")
        a, b = as_wide(got), as_wide(want)
        diff = torch.where(a == b, 0, (a - b).abs())    # inf == inf
        if mask is not None:
            diff = diff[mask]
        err = diff.max().item() if diff.numel() else 0
        if err != 0:
            raise AssertionError(f"{self.name} {what}: max |kernel - plain| "
                                 f"= {err} (tolerance 0)")
        self.max_abs_err = max(self.max_abs_err, err)
        self.cases += 1


def as_wide(t):
    """float64 for float keys (so -0.0 == +0.0), exact int64 otherwise."""
    import torch
    if t.dtype.is_floating_point:
        return t.to(torch.float64)
    if t.dtype == torch.uint32:
        return t.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return t.to(torch.int64)


# -- phase 3: kernels against their plain versions ------------------------------


def pairs_sorted(torch, keys, vals):
    """Each row's multiset of (key, value) pairs as sorted int64 codes
    (key in sortable-bit order, then payload bits). K3 pads nothing in
    memory, so pairs keyed by the dtype maximum are compared too."""
    from repro_torch.kernels.radix_sort import key_to_sortable_bits
    kb = key_to_sortable_bits(keys).view(torch.int32).to(torch.int64)
    kb = kb & 0xFFFFFFFF
    code = (kb << 32) | (vals.view(torch.int32).to(torch.int64) & 0xFFFFFFFF)
    return torch.sort(code, dim=-1).values


def make_keys(torch, gen, shape, dtype, dev):
    if dtype == torch.float32:
        return torch.randn(shape, generator=gen, device=dev)
    bits = torch.randint(-(1 << 31), (1 << 31) - 1, shape, generator=gen,
                         device=dev, dtype=torch.int32)
    return bits if dtype == torch.int32 else bits.view(torch.uint32)


class Shapes:
    """The shapes each path gives the kernels, from the record counts."""

    def __init__(self, n_log2: int):
        self.n = 1 << n_log2
        self.n_local = self.n // WORLD
        cap = int(self.n_local / WORLD * 2.0) + 1
        self.recv = WORLD * cap                   # flat stage-2 segment
        dcs, nodes = GRID
        self.cap_a = int(self.n_local / nodes * 2.0) + 1
        self.cap_b = int(self.n_local / dcs * 2.0) + 1
        self.staged = nodes * self.cap_a          # stage-B send rows
        self.recv_grid = dcs * self.cap_b         # grid stage-2 segment
        self.words = 2 * self.n                   # wordcount input
        self.words_local = self.words // WORLD
        # the shuffle stage's default capacity_factor is 4
        self.wc_recv = WORLD * (int(self.words_local / WORLD * 4.0) + 1)
        # phase 11: after a lost rank the sorts resume on 4 ranks (flat) or
        # the (2, 2) grid, 2 buckets a rank, each rank holding twice the
        # records; the wordcount lost at boundary 1 reduces on 4 ranks
        half = WORLD // 2
        self.r_local = self.n // half
        self.r_recv = half * (int(self.r_local / half * 2.0) + 1)
        self.r_staged = 2 * (int(self.r_local / 2 * 2.0) + 1)
        self.r_recv_grid = 2 * (int(self.r_local / 2 * 2.0) + 1)
        self.r_wc_recv = 2 * self.wc_recv
        # phase 10: the stream's reduce rows, received slots plus the carry
        self.s_local = STREAM_BATCH // WORLD
        self.s_rows = (WORLD * (int(self.s_local / WORLD * 4.0) + 1)
                       + STREAM_CARRY)
        self.s_rows_4 = (half * (int(2 * self.s_local / half * 4.0) + 1)
                         + 2 * STREAM_CARRY)


def new_path_shapes(sh: Shapes):
    """(kernel, where, (rows, len), destinations) of every launch shape
    phases 10 and 11 add: the resumed sorts, the resumed wordcount's
    reduce and the stream's shuffle and reduce, on 8 and on 4 ranks."""
    half = WORLD // 2
    return [("partition", "resumed flat send pack", (half, sh.r_local), half),
            ("partition", "resumed flat stage-2 regroup", (half, sh.r_recv),
             2),
            ("partition", "resumed (2, 2) stage A", (half, sh.r_local), 2),
            ("partition", "resumed (2, 2) stage B", (half, sh.r_staged), 2),
            ("partition", "resumed (2, 2) stage-2 regroup",
             (half, sh.r_recv_grid), 2),
            ("partition", "stream shuffle, 8 ranks", (WORLD, sh.s_local),
             WORLD),
            ("partition", "stream shuffle, 4 ranks", (half, 2 * sh.s_local),
             half),
            ("bitonic_sort", "resumed flat stage-2 sort", (WORLD, sh.r_recv),
             0),
            ("bitonic_sort", "resumed (2, 2) stage-2 sort",
             (WORLD, sh.r_recv_grid), 0),
            ("radix_sort", "resumed wordcount reduce", (half, sh.r_wc_recv),
             0),
            ("radix_sort", "stream reduce, 8 ranks", (WORLD, sh.s_rows), 0),
            ("radix_sort", "stream reduce, 4 ranks", (half, sh.s_rows_4), 0)]


def check_new_shapes(torch, dev, gen, sh: Shapes, checks, words):
    """Phase 3, continued: K1, K3 and K2 against their plain versions
    (tolerance 0) at the shapes a lost rank and the stream give them
    (:func:`new_path_shapes`), each timed beside its bound. K1's ids are
    random over its destinations plus the overflow one; K3's rows hold a
    quarter of real keys inside one bucket's range of the default
    splitters, then the int32 maximum, as a resumed regroup gives them;
    K2's rows hold Zipf word ids below 2^20, drawn at random from phase
    7's ``words`` (numpy's Zipf draw takes about a minute at these
    shapes), then the int32 maximum."""
    from repro_torch.kernels import partition, radix_sort, ref
    from repro_torch.kernels.bitonic_sort import sort_kv_segments_bitonic
    pool = torch.from_numpy(words).to(dev)
    out = []
    for name, where, shape, nd in new_path_shapes(sh):
        chk = checks[name][0]
        rows, n = shape
        if name == "partition":
            dest = torch.randint(0, nd + 1, shape, generator=gen, device=dev,
                                 dtype=torch.int32)
            rank, counts = partition.partition_rank(dest, nd)
            rrank, rcounts = ref.partition_rank_ref(dest, nd)
            chk.equal(f"counts {where} {shape}", counts, rcounts)
            chk.equal(f"rank {where} {shape}", rank, rrank, mask=dest < nd)
            del rank, counts, rrank, rcounts
            out.append({"kernel": name, "path": where, "shape": list(shape),
                        "num_dest": nd,
                        "ms": time_ms(torch, lambda: partition.partition_rank(
                            dest, nd)),
                        "bound_ms": bound_ms(8 * dest.numel() + 4 * rows * nd)})
            del dest
            continue
        vals = torch.arange(n, dtype=torch.int32, device=dev).expand(
            rows, n).contiguous()
        if name == "bitonic_sort":
            span = (1 << 31) // rows
            keys = torch.randint(0, span, shape, generator=gen, device=dev,
                                 dtype=torch.int32)
            keys += torch.arange(rows, device=dev,
                                 dtype=torch.int32)[:, None] * span
            keys[:, n // 4:] = 0x7FFFFFFF
            gk, gv = sort_kv_segments_bitonic(keys, vals)
            rk, rv = ref.sort_kv_segments_ref(keys, vals)
            chk.equal(f"keys {where} {shape}", gk, rk)
            chk.equal(f"(key, value) multiset {where} {shape}",
                      pairs_sorted(torch, gk, gv), pairs_sorted(torch, rk, rv))
            fn = sort_kv_segments_bitonic
        else:
            keys = pool[torch.randint(0, pool.numel(), shape, generator=gen,
                                      device=dev)]
            keys[:, n // 2:] = 0x7FFFFFFF
            gk, gv = radix_sort.sort_kv_segments_radix(keys, vals)
            rk, rv = radix_sort.sort_kv_segments_radix_ref(keys, vals)
            chk.equal(f"keys {where} {shape}", gk, rk)
            chk.equal(f"values {where} {shape}", gv, rv)
            fn = radix_sort.sort_kv_segments_radix
        del gk, gv, rk, rv
        out.append({"kernel": name, "path": where, "shape": list(shape),
                    "ms": time_ms(torch, lambda: fn(keys, vals)),
                    "bound_ms": bound_ms(16 * keys.numel())})
        del keys, vals
        torch.cuda.empty_cache()
    del pool
    return out


def moe_shapes() -> dict:
    """K1's two shapes in one MoE layer of phase 12's grid prefill, by the
    formulas of ``moe_apply_sphere``: the send pack of each rank's tokens
    times top-k, and the regroup of the received rows per local expert."""
    from repro_torch.configs import get_config
    from repro_torch.models.moe import padded_experts
    cfg = get_config(SERVE_ARCH)
    ep = SERVE_GRID[1]
    ranks = SERVE_GRID[0] * ep
    sends = PREFILL_PROMPTS * PREFILL_LEN // ranks * cfg.top_k
    cap = int(sends / ep * cfg.capacity_factor) + 1
    e_loc = padded_experts(cfg, ep) // ep
    recv = ep * cap
    return {"send": (ranks, sends), "send_dest": ep, "capacity": cap,
            "regroup": (ranks, recv), "regroup_dest": e_loc,
            "regroup_capacity": int(recv / e_loc * cfg.capacity_factor) + 1}


def k1_path_shapes(sh: Shapes):
    """(where, rows x ids, destinations) of every K1 launch on the paths."""
    m = moe_shapes()
    return [("flat send pack", (WORLD, sh.n_local), WORLD),
            ("flat stage-2 regroup", (WORLD, sh.recv), 1),
            ("grid stage A (node hop)", (WORLD, sh.n_local), GRID[1]),
            ("grid stage B (dc hop)", (WORLD, sh.staged), GRID[0]),
            ("grid stage-2 regroup", (WORLD, sh.recv_grid), 1),
            ("wordcount shuffle", (WORLD, sh.words_local), WORLD),
            (f"MoE send pack, capacity {m['capacity']}", m["send"],
             m["send_dest"]),
            (f"MoE per-expert regroup, capacity {m['regroup_capacity']}",
             m["regroup"], m["regroup_dest"])]


def check_partition(torch, dev, gen, sh: Shapes):
    """K1 against its plain version, tolerance 0: the paths' shapes, its
    tile's edges in both forms (12288 ids up to 1024 destinations, 3072
    above), one destination for all, none in range, the int32 extremes,
    65535 rows, a count past 2^24 and a long row ranked three times
    identically. Timed at every path shape beside its bound, with its
    launches and memsets held to ``partition_plan``."""
    from repro_torch.kernels import partition, ref
    chk = Check("partition_rank")
    i32 = torch.iinfo(torch.int32)

    def compare(what, dest, nd):
        rank, counts = partition.partition_rank(dest, nd)
        rrank, rcounts = ref.partition_rank_ref(dest, nd)
        ok = (dest >= 0) & (dest < nd)
        chk.equal(f"counts {what} D={nd}", counts, rcounts)
        chk.equal(f"rank {what} D={nd}", rank, rrank, mask=ok)
        chk.equal(f"rank 0 out of range {what} D={nd}", rank,
                  torch.zeros_like(rank), mask=~ok)
        return rank, counts

    cases = [(shape, nd, nd + 1) for _, shape, nd in k1_path_shapes(sh)]
    cases += [((WORLD, sh.recv), 4, 5),                   # regroup, bpd = 4
              ((3, 5000), 9, 12), ((17, 33), 1, 3), ((1, 4097), 4096, 4096),
              ((2, 1), 8, 9)]
    for nd in (1, 8, 256, 1025, 4096):
        t = partition.partition_plan(1, 1, nd).tile
        cases += [((3, s), nd, nd + 2)
                  for s in (t - 1, t, t + 1, 2 * t + 1, 9 * t + 5)]
    for shape, nd, hi in cases:
        dest = torch.randint(-2, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32)
        compare(str(shape), dest, nd)
        del dest
    for nd in (8, 4096):
        s = 9 * partition.partition_plan(1, 1, nd).tile + 5
        for what, fill in (("all first", 0), ("all last", nd - 1),
                           ("none in range", nd), ("extremes", i32.min)):
            dest = torch.full((2, s), fill, dtype=torch.int32, device=dev)
            if what == "none in range":
                dest[:, ::2] = -1
                dest[:, ::3] = i32.max
            if what == "extremes":
                dest[:, ::2] = i32.max
                dest[:, ::7] = nd // 2
            compare(f"{what} (2, {s})", dest, nd)
    dest = torch.randint(-1, 9, (partition.MAX_ROWS, 3), generator=gen,
                         device=dev, dtype=torch.int32)
    compare(f"{partition.MAX_ROWS} rows of 3", dest, 8)
    # counts stay exact past 2^24 (a float32 accumulator would not)
    n = (1 << 24) + 9
    dest = torch.zeros((1, n), dtype=torch.int32, device=dev)
    dest[0, :5] = 1
    rank, counts = partition.partition_rank(dest, 4)
    want = torch.tensor([[n - 5, 5, 0, 0]], dtype=torch.int32, device=dev)
    chk.equal("counts past 2^24", counts, want)
    chk.equal("rank past 2^24", rank[0, -1:],
              torch.tensor([n - 6], dtype=torch.int32, device=dev))
    # a race in the look-back would show as a difference between runs
    dest = torch.randint(-1, 257, (1, 1 << 24), generator=gen, device=dev,
                         dtype=torch.int32)
    first = compare("2^24 row", dest, 256)
    for rep in (2, 3):
        again = partition.partition_rank(dest, 256)
        chk.equal(f"2^24 row, run {rep} rank", again[0], first[0])
        chk.equal(f"2^24 row, run {rep} counts", again[1], first[1])
    del dest, rank, first, again
    torch.cuda.synchronize()

    # timing at every path shape: random ids in [0, D], D standing for an
    # empty slot or the overflow destination
    shapes = []
    for where, shape, nd in k1_path_shapes(sh):
        dest = torch.randint(0, nd + 1, shape, generator=gen, device=dev,
                             dtype=torch.int32)
        plan = partition.partition_plan(*shape, nd)
        row = {"path": where, "shape": list(shape), "num_dest": nd,
               "ms": time_ms(torch,
                             lambda: partition.partition_rank(dest, nd)),
               # read ids once, write ranks and counts once
               "bound_ms": bound_ms(8 * dest.numel() + 4 * shape[0] * nd),
               "tile": plan.tile, "scratch_bytes": plan.scratch_bytes,
               **held_to_plan(torch, lambda: partition.partition_rank(dest,
                                                                      nd),
                              plan, "k1::", "K1")}
        if not shapes:      # the send path: the row of the kernel table
            offs = (torch.arange(WORLD, device=dev, dtype=torch.int32)[:, None]
                    * (nd + 1))
            # the plain version takes about a second a call: 3 timed
            row["plain_ms"] = time_ms(
                torch, lambda: ref.partition_rank_ref(dest, nd), iters=3)
            row["library_ms"] = time_ms(torch, lambda: torch.bincount(
                (dest + offs).reshape(-1), minlength=WORLD * (nd + 1)))
            row["library_call"] = "torch.bincount (histogram half only)"
        shapes.append(row)
        del dest
    timing = {**shapes[0], "shapes": shapes}
    return chk, timing


def check_bucket_hist(torch, dev, gen, sh: Shapes):
    """K4 against its plain version, tolerance 0: the stage-1 shape, one
    long row, a grid of small shapes and bucket counts, its chunk's edges
    (rows whose length is no multiple of 4 and 1-D views that start off a
    16-byte boundary), one bucket for all, none in range, the int32
    extremes, 65535 rows, and one bucket counting past 2^24. Timed at both
    shapes beside its bound and ``torch.bincount``, with its launches and
    memsets held to ``hist_plan``."""
    from repro_torch.kernels import bucket_hist, ref
    chk = Check("bucket_hist")
    i32 = torch.iinfo(torch.int32)

    def compare(what, ids, nb):
        got = bucket_hist.bucket_histogram(ids, nb)
        chk.equal(what, got, ref.bucket_histogram_ref(ids, nb))

    stage1 = torch.randint(-1, WORLD, (WORLD, sh.n_local), generator=gen,
                           device=dev, dtype=torch.int32)
    compare(f"stage-1 ids {tuple(stage1.shape)} B={WORLD}", stage1, WORLD)
    long_row = torch.randint(0, 256, (1, sh.n), generator=gen, device=dev,
                             dtype=torch.int32)
    compare(f"one row {tuple(long_row.shape)} B=256", long_row, 256)
    for n in (0, 1, 7, 4097):
        for nb in (1, 4, 17, 128, 513, 4096):
            ids = torch.randint(-2, nb + 2, (2, n), generator=gen, device=dev,
                                dtype=torch.int32)
            compare(f"(2, {n}) B={nb}", ids, nb)
            compare(f"({n},) B={nb}", ids[0], nb)
    c = bucket_hist.MIN_CHUNK
    for nb in (1, 8, 256, 1025, 4096):
        for n in (c - 1, c, c + 1, 2 * c + 1, 512 * c + 5):
            rows = 3 if n < 512 * c else 1
            ids = torch.randint(-2, nb + 2, (rows, n), generator=gen,
                                device=dev, dtype=torch.int32)
            compare(f"chunk edge ({rows}, {n}) B={nb}", ids, nb)
            compare(f"chunk edge, last row as 1-D ({n},) B={nb}", ids[-1], nb)
    for nb in (1, 4, 4096):
        edge = torch.tensor([-1, nb, i32.min, i32.max, 0, nb - 1, -nb],
                            dtype=torch.int32, device=dev).repeat(3, 1000)
        compare(f"ids -1, B, INT32_MIN/MAX B={nb}", edge, nb)
        for what, fill in (("all first", 0), ("all last", nb - 1),
                           ("none in range", nb)):
            ids = torch.full((2, 3 * c + 7), fill, dtype=torch.int32,
                             device=dev)
            if what == "none in range":
                ids[:, ::2] = -1
                ids[:, ::3] = i32.max
            compare(f"{what} (2, {3 * c + 7}) B={nb}", ids, nb)
    ids = torch.randint(-1, 9, (bucket_hist.MAX_ROWS, 3), generator=gen,
                        device=dev, dtype=torch.int32)
    compare(f"{bucket_hist.MAX_ROWS} rows of 3 B=8", ids, 8)
    n = 1 << 25
    ones = torch.zeros((n + 5,), dtype=torch.int32, device=dev)
    ones[n:] = 1
    want = torch.tensor([n, 5, 0, 0], dtype=torch.int32, device=dev)
    chk.equal("2^25 zeros and five ones",
              bucket_hist.bucket_histogram(ones, 4), want)
    chk.equal("2^25 zeros and five ones (plain)",
              ref.bucket_histogram_ref(ones, 4), want)
    del ones, ids
    torch.cuda.synchronize()

    def library(ids, nb):
        """One ``torch.bincount`` over row-offset ids; ids out of range
        were moved to the spare last bin beforehand (not timed)."""
        rows = ids.shape[0]
        offs = torch.arange(rows, device=dev, dtype=torch.int32)[:, None] * nb
        flat = torch.where((ids >= 0) & (ids < nb), ids + offs,
                           rows * nb).reshape(-1)
        return lambda: torch.bincount(flat, minlength=rows * nb + 1)

    def timed(ids, nb):
        plan = bucket_hist.hist_plan(*ids.shape, nb)
        return {"shape": list(ids.shape), "num_buckets": nb,
                "ms": time_ms(torch,
                              lambda: bucket_hist.bucket_histogram(ids, nb)),
                "plain_ms": time_ms(torch,
                                    lambda: ref.bucket_histogram_ref(ids, nb)),
                "library_ms": time_ms(torch, library(ids, nb)),
                "library_call": "torch.bincount of row-offset ids",
                # read ids once, write counts once
                "bound_ms": bound_ms(4 * ids.numel() + 4 * ids.shape[0] * nb),
                "chunk": plan.chunk, "blocks": plan.blocks,
                **held_to_plan(torch,
                               lambda: bucket_hist.bucket_histogram(ids, nb),
                               plan, "k4::", "K4")}

    timing = timed(stage1, WORLD)
    timing["one_row"] = timed(long_row, 256)
    return chk, timing


def check_sort(torch, dev, gen, kernel: str, seg_lens, time_len: int,
               stage2_real: int = 0):
    """K2 or K3 against its plain version (tolerance 0) and timed.
    ``stage2_real``: for K3, the real keys per row of the main path's
    stage-2 sort input (the rest of the row is the int32 maximum)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.bitonic_sort import (sort_kv_segments_bitonic,
                                                  sort_segments_bitonic)
    from repro_torch.kernels.radix_sort import (sort_kv_segments_radix,
                                                sort_kv_segments_radix_ref,
                                                sort_segments_radix)
    stable = kernel == "radix_sort"
    fn = sort_kv_segments_radix if stable else sort_kv_segments_bitonic
    plain = sort_kv_segments_radix_ref if stable else ref.sort_kv_segments_ref
    chk = Check(kernel)

    def compare(what, keys, vals):
        keys_in, vals_in = keys.clone(), vals.clone()
        gk, gv = fn(keys, vals)
        rk, rv = plain(keys, vals)
        chk.equal(f"keys {what}", gk, rk)
        chk.equal(f"input keys untouched {what}", keys.view(torch.int32),
                  keys_in.view(torch.int32))
        chk.equal(f"input values untouched {what}", vals, vals_in)
        if stable:
            chk.equal(f"key bits {what}", gk.view(torch.int32),
                      rk.view(torch.int32))
            chk.equal(f"values {what}", gv, rv)
            chk.equal(f"keys-only {what}",
                      sort_segments_radix(keys).view(torch.int32),
                      rk.view(torch.int32))
        else:
            chk.equal(f"(key, value) multiset {what}",
                      pairs_sorted(torch, gk, gv), pairs_sorted(torch, rk, rv))
            chk.equal(f"keys-only {what}", sort_segments_bitonic(keys),
                      ref.sort_segments_ref(keys))

    def numbered(shape):
        return torch.arange(shape[0] * shape[1], dtype=torch.int32,
                            device=dev).reshape(shape)

    for dtype in (torch.int32, torch.uint32, torch.float32):
        for shape in ((3, 1), (17, 3), (3, 1000), (5, 4097), (2, 70001),
                      (1, 1 << 16)):
            keys = make_keys(torch, gen, shape, dtype, dev)
            compare(f"{dtype} {shape}", keys, numbered(shape))
    # duplicate runs, the dtype maximum, +-0.0 and +-inf
    dup = torch.randint(0, 4, (4, 9000), generator=gen, device=dev,
                        dtype=torch.int32)
    dup[:, ::7] = 0x7FFFFFFF
    compare("duplicates + int32 max", dup, numbered(dup.shape))
    f = torch.tensor([[0.0, -0.0, 1.0, -0.0, float("inf"), 0.0, -1.0,
                       float("-inf"), -0.0, 0.0]] * 3, device=dev)
    compare("+-0.0 and inf", f, numbered(f.shape))
    u = torch.full((2, 5000), -1, dtype=torch.int32, device=dev)
    u[:, ::3] = 5
    compare("uint32 max", u.view(torch.uint32), numbered(u.shape))
    if stable:
        radix_edges(torch, dev, gen, compare, numbered, chk)
    else:
        bitonic_edges(torch, dev, gen, compare, numbered)

    def path_rows(seg_len):
        """Keys of valid records with sentinel padding, as the paths give
        them: the stage-2 segments and the wordcount's receive rows."""
        keys = torch.randint(0, (1 << 31) - 1, (WORLD, seg_len),
                             generator=gen, device=dev, dtype=torch.int32)
        keys[:, seg_len - seg_len // 9:] = 0x7FFFFFFF
        vals = torch.arange(seg_len, dtype=torch.int32,
                            device=dev).expand(WORLD, -1).contiguous()
        return keys, vals

    for seg_len in seg_lens:
        keys, vals = path_rows(seg_len)
        compare(f"path rows {(WORLD, seg_len)}", keys, vals)
        del keys, vals
        if not stable:
            keys, vals = stage2_rows(torch, gen, dev, seg_len, stage2_real)
            compare(f"stage-2 input {(WORLD, seg_len)}", keys, vals)
            del keys, vals
    torch.cuda.synchronize()

    def timed(keys, vals):
        return sort_timing(torch, fn, plain, keys, vals,
                           K2_BYTES_PER_KV if stable else 0)

    if stable:
        keys, vals = path_rows(time_len)
        timing = {"data": "random int32 keys, the last ninth of each row "
                          "the int32 maximum", **timed(keys, vals),
                  **radix_launches(torch, keys, vals)}
        del keys, vals
        timing["other_shapes"] = [
            {"data": "random int32 keys, the same kind",
             **timed(*path_rows(n))} for n in seg_lens if n != time_len]
        return chk, timing
    keys = torch.randint(0, (1 << 31) - 1, (WORLD, time_len), generator=gen,
                         device=dev, dtype=torch.int32)
    vals = torch.arange(time_len, dtype=torch.int32,
                        device=dev).expand(WORLD, -1).contiguous()
    timing = {"data": "random int32 keys", **timed(keys, vals),
              **bitonic_launches(torch, keys, vals)}
    del keys, vals
    timing["on_path_rows"] = []
    for seg_len in seg_lens:
        keys, vals = stage2_rows(torch, gen, dev, seg_len, stage2_real)
        timing["on_path_rows"].append(
            {"data": f"stage-2 input: {stage2_real} real keys a row, then "
                     f"the int32 maximum", **timed(keys, vals)})
        del keys, vals
    return chk, timing


def sort_timing(torch, fn, plain, keys, vals, design_bytes: int = 0):
    """Kernel, plain version and ``torch.sort(stable=True)`` + ``gather``
    on one (keys, values) input, beside the 16 B/element bound (keys and
    values read once, written once) and, given ``design_bytes`` per
    element, the time the design's own traffic would take at the same
    rate (K2: 68 B, one read of the keys for the histogram, then every
    pass reads and writes both), computed like the bound, not measured."""
    def library():
        s = torch.sort(keys, dim=-1, stable=True)
        return s.values, torch.gather(vals, -1, s.indices)

    out = {"shape": list(keys.shape),
           "ms": time_ms(torch, lambda: fn(keys, vals)),
           "plain_ms": time_ms(torch, lambda: plain(keys, vals)),
           "library_ms": time_ms(torch, library),
           "library_call": "torch.sort(stable=True) + torch.gather",
           "bound_ms": bound_ms(16 * keys.numel())}
    if design_bytes:
        out["design_traffic_ms"] = bound_ms(design_bytes * keys.numel())
    return out


def radix_edges(torch, dev, gen, compare, numbered, chk):
    """K2 at its design's edges: rows one short of, at and one past its
    tile T, and of 2 T + 1 and 9 T + 5 (the look-back walks over earlier
    tiles); all-equal, all the dtype maximum, sorted and reversed rows; a
    wordcount-like row (three quarters the int32 maximum, the rest Zipf
    word ids below 2^20); 65535 rows of 3; and one 2^24-element row sorted
    three times, bit-identical each time (a race in the look-back would
    show as a difference)."""
    import numpy as np
    from repro_torch.kernels import ref
    from repro_torch.kernels.radix_sort import (MAX_ROWS, TILE,
                                                sort_kv_segments_radix)
    tops = {torch.int32: 0x7FFFFFFF, torch.uint32: -1,
            torch.float32: float("inf")}
    for dtype in (torch.int32, torch.uint32, torch.float32):
        for s in (TILE - 1, TILE, TILE + 1, 2 * TILE + 1, 9 * TILE + 5):
            shape = (3, s)
            keys = make_keys(torch, gen, shape, dtype, dev)
            bits = keys.view(torch.int32)
            bits[:, ::5] = bits[:, :1].clone()     # duplicate runs
            compare(f"{dtype} tile edge {shape}", keys, numbered(shape))
        shape = (2, 9 * TILE + 5)
        keys = make_keys(torch, gen, shape, dtype, dev)
        up = ref.sort_segments_ref(keys).view(torch.int32)
        cases = {
            "all equal": keys.view(torch.int32)[:, :1].expand(shape)
            .contiguous(),
            "all maximum": torch.full(
                shape, tops[dtype], device=dev,
                dtype=torch.float32 if dtype == torch.float32
                else torch.int32).view(torch.int32),
            "sorted": up,
            "reversed": up.flip(-1).contiguous()}
        for what, k in cases.items():
            compare(f"{dtype} {what} {shape}", k.view(dtype), numbered(shape))
    rng = np.random.default_rng(5)
    s = 40 * TILE + 17
    words = ((rng.zipf(ZIPF_A, size=(4, s)) - 1) % VOCAB).astype(np.int32)
    keys = torch.from_numpy(words).to(dev)
    run = s // 32
    for r in range(32):                  # 8 source ranks of 4 slots each
        keys[:, r * run + run // 4:(r + 1) * run] = 0x7FFFFFFF
    compare(f"wordcount-like rows {tuple(keys.shape)}", keys,
            numbered(keys.shape))
    keys = make_keys(torch, gen, (MAX_ROWS, 3), torch.int32, dev)
    compare(f"{MAX_ROWS} rows of 3", keys, numbered(keys.shape))
    s = 1 << 24
    keys = torch.randint(0, 1 << 12, (1, s), generator=gen, device=dev,
                         dtype=torch.int32)
    vals = numbered((1, s))
    first = sort_kv_segments_radix(keys, vals)
    for rep in (2, 3):
        again = sort_kv_segments_radix(keys, vals)
        chk.equal(f"2^24 row, run {rep} key bits", again[0], first[0])
        chk.equal(f"2^24 row, run {rep} values", again[1], first[1])
    compare("2^24 row", keys, vals)


def device_events(torch, call, expected, sessions: int = 5):
    """The device events (kernels, memsets, copies) one ``call()`` makes,
    as (name, ms) from ``torch.profiler``, the names of the CUDA runtime
    calls it made on the host, and the profiler sessions it took. A session
    can lose device events (on the H100 most often its first one: 1 or 2
    of K2's 5 launches were seen in 2 of 17 processes, K1's memset or
    K3's first launch in 5 sessions of 5 at some shapes), so each session
    starts with a fill of its own and counts only what follows the call's
    start. A session never adds an event, so one for which
    ``expected(device names, runtime names)`` fails is followed by
    another, up to ``sessions``; the caller holds the last one to its
    plan."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    warm = torch.empty(1, dtype=torch.int8, device="cuda")
    for n in range(1, sessions + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            # the session's first device event is the one most often lost
            # (K3's first launch, K1's memset): let it be this fill's
            warm.fill_(1)
            torch.cuda.synchronize()
            with record_function("held_call"):
                out = call()
            torch.cuda.synchronize()
        del out
        start = min(e.time_range.start for e in prof.events()
                    if e.name == "held_call")
        mine = [e for e in prof.events()
                if e.time_range.start >= start and e.name != "held_call"]
        events = [(e.name, (e.time_range.end - e.time_range.start) / 1e3)
                  for e in mine if e.device_type == DeviceType.CUDA]
        runtime = [e.name for e in mine if e.device_type == DeviceType.CPU
                   and e.name.startswith("cuda")]
        if expected([name for name, _ in events], runtime):
            break
    return events, runtime, n


def held_to_plan(torch, call, plan, tag: str, what: str,
                 reps: int = TIMED_ITERS):
    """CUDA launches and memsets one ``call()`` makes, counted by
    ``torch.profiler`` and held to ``plan``: the device's kernel events
    whose name holds ``tag``, and the ``cudaMemsetAsync`` calls the host
    made (the device's memset events, which a session can lose, may not
    outnumber them); no other device event may come from the call. Then
    the device time of a call's own kernels and memsets from the
    profiler: their summed durations over ``reps`` calls in one session,
    over ``reps``, a lost memset counted at the mean of the seen ones (set
    beside the CUDA-event window of ``time_ms``, it shows the host time
    inside that window)."""
    def split(names):
        kernels = [n for n in names if tag in n]
        memsets = [n for n in names if n.startswith("Memset")]
        return kernels, memsets, [n for n in names
                                  if n not in kernels and n not in memsets]

    def as_planned(names, runtime, calls=1):
        kernels, memsets, other = split(names)
        return (len(kernels) == calls * plan.cuda_launches
                and runtime.count("cudaMemsetAsync") == calls * plan.memsets
                and len(memsets) <= calls * plan.memsets and not other)

    events, runtime, sessions = device_events(torch, call, as_planned)
    names = [n for n, _ in events]
    kernels, memsets, other = split(names)
    if not as_planned(names, runtime):
        raise AssertionError(
            f"one {what} call made {len(kernels)} CUDA launches and "
            f"{runtime.count('cudaMemsetAsync')} memsets "
            f"({len(memsets)} seen on the device), its plan says "
            f"{plan.cuda_launches} and {plan.memsets}; other device events: "
            f"{other}")

    def repeated():
        for _ in range(reps):
            call()

    timed, timed_runtime, timed_sessions = device_events(
        torch, repeated, lambda n, r: as_planned(n, r, reps))
    kernel_ms = sum(ms for n, ms in timed if tag in n) / reps
    seen = [ms for n, ms in timed if n.startswith("Memset")]
    memset_ms = (statistics.mean(seen) * plan.memsets if seen else 0.0)
    return {"cuda_launches_per_call": len(kernels),
            "memsets_per_call": runtime.count("cudaMemsetAsync"),
            "device_memsets_seen": len(memsets),
            "launch_names": sorted(set(n.split("(")[0] for n in kernels)),
            "profiler_sessions": sessions,
            "profiler_kernel_ms": kernel_ms, "profiler_memset_ms": memset_ms,
            "profiler_ms": kernel_ms + memset_ms,
            "profiler_memsets_seen": f"{len(seen)} of {reps * plan.memsets}",
            "profiler_timed_sessions": timed_sessions,
            "profiler_timed_as_planned": as_planned(
                [n for n, _ in timed], timed_runtime, reps)}


def radix_launches(torch, keys, vals):
    """CUDA launches and memsets one K2 call makes, held to
    ``radix_plan``; no other device event may come from the call."""
    from repro_torch.kernels.radix_sort import (radix_plan,
                                                sort_kv_segments_radix)
    plan = radix_plan(*keys.shape, kv=True)
    out = held_to_plan(torch, lambda: sort_kv_segments_radix(keys, vals),
                       plan, "k2::", "K2")
    return {"tile": plan.tile, **out, "scratch_bytes": plan.scratch_bytes}


def bitonic_edges(torch, dev, gen, compare, numbered):
    """K3 at its design's edges: rows one short of, at and one past the
    block-sort tile T, with 2, 3 and 4 merge passes (the result comes from
    either scratch buffer), all-equal, all-maximum (the padding sentinel),
    sorted and reversed rows, and 65535 rows of 3."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.bitonic_sort import MAX_ROWS, TILE
    tops = {torch.int32: 0x7FFFFFFF, torch.uint32: -1,
            torch.float32: float("inf")}
    for dtype in (torch.int32, torch.uint32, torch.float32):
        for s in (TILE - 1, TILE, TILE + 1, 2 * TILE + 1, 4 * TILE + 1,
                  9 * TILE + 5):
            shape = (3, s)
            keys = make_keys(torch, gen, shape, dtype, dev)
            bits = keys.view(torch.int32)          # uint32 has few ops
            bits[:, ::5] = bits[:, :1].clone()     # duplicate runs
            compare(f"{dtype} tile edge {shape}", keys, numbered(shape))
        for s in (2 * TILE + 1, 4 * TILE + 1):
            shape = (2, s)
            keys = make_keys(torch, gen, shape, dtype, dev)
            bits = keys.view(torch.int32)
            up = ref.sort_segments_ref(keys).view(torch.int32)
            cases = {
                "all equal": bits[:, :1].expand(shape).contiguous(),
                "all maximum": torch.full(
                    shape, tops[dtype], device=dev,
                    dtype=torch.float32 if dtype == torch.float32
                    else torch.int32).view(torch.int32),
                "sorted": up,
                "reversed": up.flip(-1).contiguous()}
            for what, k in cases.items():
                compare(f"{dtype} {what} {shape}", k.view(dtype),
                        numbered(shape))
    keys = make_keys(torch, gen, (MAX_ROWS, 3), torch.int32, dev)
    compare(f"{MAX_ROWS} rows of 3", keys, numbered(keys.shape))


def stage2_rows(torch, gen, dev, seg_len: int, real: int):
    """The main path's stage-2 sort input (``dataflow.py``, the regroup's
    ``seg_keys``): each rank's ``real`` received keys, all inside its
    bucket's range of the default splitters, in the prefix of the row, the
    rest the int32 maximum; payload = slot index."""
    span = (1 << 31) // WORLD
    keys = torch.randint(0, span, (WORLD, seg_len), generator=gen, device=dev,
                         dtype=torch.int32)
    keys += torch.arange(WORLD, device=dev, dtype=torch.int32)[:, None] * span
    keys[:, real:] = 0x7FFFFFFF
    vals = torch.arange(seg_len, dtype=torch.int32,
                        device=dev).expand(WORLD, -1).contiguous()
    return keys, vals


def bitonic_launches(torch, keys, vals):
    """CUDA launches one K3 call makes, counted by ``torch.profiler`` from
    the device's kernel events and held to the wrapper's pass plan, and
    the call's device memory beyond its inputs."""
    from repro_torch.kernels.bitonic_sort import (pass_plan,
                                                  sort_kv_segments_bitonic)
    plan = pass_plan(*keys.shape)

    def k3(events):
        return [n for n in events if "k3::" in n]

    events, _, sessions = device_events(
        torch, lambda: sort_kv_segments_bitonic(keys, vals),
        lambda ev, _: len(k3(ev)) == plan.cuda_launches)
    names = k3([n for n, _ in events])
    if len(names) != plan.cuda_launches:
        raise AssertionError(f"one K3 call made {len(names)} CUDA launches, "
                             f"its plan says {plan.cuda_launches}: {names}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = sort_kv_segments_bitonic(keys, vals)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    del out
    return {"merge_passes": plan.merge_passes, "tile": plan.tile,
            "cuda_launches_per_call": len(names),
            "launch_names": sorted(set(n.split("(")[0] for n in names)),
            "profiler_sessions": sessions, "call_device_bytes": extra}


# -- phases 4 to 8 ---------------------------------------------------------------


def kernels():
    from repro_torch.kernels import bitonic_sort, bucket_hist, partition, \
        radix_sort
    return (partition.KERNEL, bitonic_sort.KERNEL, radix_sort.KERNEL,
            bucket_hist.KERNEL)


def reset_launches() -> None:
    for k in kernels():
        k.launches = 0


def read_launches() -> dict:
    return {k.name: k.launches for k in kernels()}


def make_records(torch, dev, gen, n: int):
    """N 100-byte records; the first 4 value bytes carry the input index."""
    n_local = n // WORLD
    keys = torch.randint(0, (1 << 31) - 1, (WORLD, n_local), generator=gen,
                         device=dev, dtype=torch.int32)
    value = torch.randint(0, 256, (WORLD, n_local, VALUE_BYTES),
                          generator=gen, device=dev, dtype=torch.uint8)
    index = torch.arange(n, dtype=torch.int32, device=dev)
    value[..., :4] = index.view(torch.uint8).reshape(WORLD, n_local, 4)
    return keys, value


def entry_point_k4(torch, dev, keys):
    """K4's path: ``kernels.ops.bucket_histogram`` on the main path's
    stage-1 bucket ids (the range partition against the default
    splitters)."""
    from repro_torch.kernels import ops as kops
    from repro_torch.sphere.dataflow import default_splitters
    spl = torch.from_numpy(default_splitters(WORLD)).to(dev)
    bucket = torch.searchsorted(spl, keys, right=True, out_int32=True)
    reset_launches()
    counts = kops.bucket_histogram(bucket, WORLD)
    torch.cuda.synchronize()
    launches = read_launches()
    offs = torch.arange(WORLD, device=dev, dtype=torch.int64)[:, None] * WORLD
    want = torch.bincount((bucket + offs).reshape(-1),
                          minlength=WORLD * WORLD).reshape(WORLD, WORLD)
    if not torch.equal(counts.to(torch.int64), want):
        raise AssertionError("bucket_histogram of the stage-1 ids differs "
                             "from torch.bincount")
    if int(counts.sum()) != keys.numel() or launches["bucket_hist"] != 1:
        raise AssertionError(f"K4 entry point: {int(counts.sum())} ids "
                             f"counted, launches {launches}")
    return {"phase": "bucket_histogram_entry_point",
            "shape": list(bucket.shape), "num_buckets": WORLD,
            "per_bucket": counts.sum(dim=0).tolist(), "launches": launches}


def check_sorted_permutation(torch, res, keys, value, what: str):
    """The checks of a 100-byte sort: no drops, every record once, globally
    sorted, each value row beside its key. Returns the sorted keys."""
    from repro_torch.core.sort import SortResult, is_globally_sorted
    n = keys.numel()
    valid = res.valid
    out_k = res.records["key"][valid]
    out_v = res.records["value"][valid]
    dropped = int(res.dropped)
    if dropped != 0:
        raise AssertionError(f"{what} dropped {dropped} records")
    if out_k.numel() != n:
        raise AssertionError(f"{what}: {out_k.numel()} valid records, "
                             f"expected {n}")
    if not is_globally_sorted(SortResult(res.records["key"], None, valid,
                                         res.dropped), valid.shape[0]):
        raise AssertionError(f"{what} output is not globally sorted")
    idx = out_v[:, :4].contiguous().view(torch.int32).reshape(-1).to(torch.int64)
    if not torch.equal(torch.sort(idx).values,
                       torch.arange(n, device=keys.device, dtype=torch.int64)):
        raise AssertionError(f"{what}: delivered records are not a "
                             f"permutation")
    if not torch.equal(keys.reshape(-1)[idx], out_k):
        raise AssertionError(f"{what}: a delivered key does not match its "
                             f"record")
    if not torch.equal(value.reshape(n, VALUE_BYTES)[idx], out_v):
        raise AssertionError(f"{what}: a delivered value row does not match "
                             f"its key")
    return out_k


def run_path(torch, ex, df, records):
    """One cold run of ``df``: launch counts read from zero, host wall
    time ending in a synchronize, peak device memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    a2a = ex.ranks.collectives["all_to_all"]
    t0 = time.perf_counter()
    res = ex.run(df, records)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return res, {"wall_ms": wall * 1e3, "launches": read_launches(),
                 "all_to_all": ex.ranks.collectives["all_to_all"] - a2a,
                 "peak_mem_bytes": torch.cuda.max_memory_allocated()}


def main_path(torch, keys, value, profile_dir=None):
    from repro_torch.comm import Ranks
    from repro_torch.sphere.dataflow import Dataflow, SPMDExecutor

    n = keys.numel()
    df = Dataflow.source().sort(key=lambda r: r["key"], num_buckets=WORLD,
                                capacity_factor=2.0)
    ex = SPMDExecutor(Ranks(WORLD), sort_algo="bitonic")
    res, run = run_path(torch, ex, df, {"key": keys, "value": value})
    sorted_keys = check_sorted_permutation(torch, res, keys, value,
                                           "main path").clone()
    for name in ("partition", "bitonic_sort"):
        if run["launches"][name] == 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"main path")
    out = {"phase": "main_path", "records": n, "record_bytes": 4 + VALUE_BYTES,
           "ranks": WORLD, "sort_algo": "bitonic",
           "records_per_s": n / run["wall_ms"] * 1e3, **run,
           "dropped": int(res.dropped), "cache": ex.cache_info()._asdict()}
    del res
    if profile_dir:
        out["profile"] = profile_run(
            torch, lambda: ex.run(df, {"key": keys, "value": value}),
            profile_dir, "main_path")
    torch.cuda.empty_cache()
    return out, sorted_keys


def grid_path(torch, keys, value, flat_sorted_keys, profile_dir=None):
    """The wide-area path: the main path's pipeline and records on the
    ``(dc, node)`` grid, so each shuffle is the two-level exchange."""
    from repro_torch.comm import Ranks
    from repro_torch.core.shuffle import ShufflePlan
    from repro_torch.sphere.dataflow import Dataflow, SPMDExecutor

    n = keys.numel()
    grid = Ranks(shape=GRID, axes=("dc", "node"))
    df = Dataflow.source().sort(key=lambda r: r["key"], num_buckets=WORLD,
                                capacity_factor=2.0)
    ex = SPMDExecutor(grid, sort_algo="bitonic")
    res, run = run_path(torch, ex, df, {"key": keys, "value": value})
    out_k = check_sorted_permutation(torch, res, keys, value,
                                     "wide-area path")
    if not torch.equal(out_k, flat_sorted_keys):
        raise AssertionError("wide-area sorted keys differ from the flat "
                             "path's")
    want = {"partition": 3, "bitonic_sort": 1}
    got = {k: run["launches"][k] for k in want}
    if got != want or run["all_to_all"] != 2:
        raise AssertionError(f"wide-area path launched {run['launches']} "
                             f"with {run['all_to_all']} all_to_all; expected "
                             f"{want} and 2")
    del res, out_k
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm = ex.run(df, {"key": keys, "value": value})
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    del warm
    n_local = n // WORLD
    hier = ShufflePlan.for_ranks(grid, WORLD, n_local, 2.0)
    flat = ShufflePlan.for_ranks(Ranks(WORLD), WORLD, n_local, 2.0)
    wan = {name: {meta: plan.wan_profile(*GRID, 4 + VALUE_BYTES,
                                         wire_meta=meta)
                  for meta in ("full", "min")}
           for name, plan in (("hierarchical", hier), ("flat", flat))}
    if (wan["hierarchical"]["min"]["wan_tiles"] != GRID[0] - 1
            or wan["flat"]["min"]["wan_tiles"] != (GRID[0] - 1) * GRID[1]):
        raise AssertionError(f"WAN tiles per rank: {wan}")
    out = {"phase": "wide_area_path", "records": n, "grid": list(GRID),
           "axes": ["dc", "node"], "sort_algo": "bitonic",
           "records_per_s": n / run["wall_ms"] * 1e3, **run,
           "warm_wall_ms": warm_ms, "warm_records_per_s": n / warm_ms * 1e3,
           "same_keys_as_flat": True, "cache": ex.cache_info()._asdict(),
           "plans": {"hierarchical": [hier.axes, hier.capacities],
                     "flat": [flat.axes, flat.capacities]},
           "wan_profile": wan}
    if profile_dir:
        out["profile"] = profile_run(
            torch, lambda: ex.run(df, {"key": keys, "value": value}),
            profile_dir, "wide_area_path")
    torch.cuda.empty_cache()
    return out


def draw_words(seed: int, n: int):
    """The wordcount's input, drawn once for phases 7, 10 and 11: ``n``
    Zipf(1.1) word ids folded into the 2^20-word vocabulary."""
    import numpy as np
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    words = ((rng.zipf(ZIPF_A, size=n) - 1) % VOCAB).astype(np.int32)
    return words, time.perf_counter() - t0


def wordcount_emit(rec):
    import torch
    return {"key": rec["word"], "value": torch.ones_like(rec["word"])}


def wordcount_count(rec, valid):
    from repro_torch.core.mapreduce import reduce_by_key_sum
    k, s, d = reduce_by_key_sum(rec["key"], rec["value"], valid,
                                algo="radix")
    return {"key": k, "value": s}, k >= 0, d


def check_word_counts(words, keys, counts, what: str) -> None:
    """Every (word, count) equal to ``np.bincount`` of the input, each word
    on one rank only."""
    import numpy as np
    want = np.bincount(words, minlength=VOCAB)
    if np.unique(keys).size != keys.size:
        raise AssertionError(f"{what}: a word was reduced on two ranks")
    got = np.zeros(VOCAB, np.int64)
    got[keys] = counts
    if not np.array_equal(got, want):
        bad = int((got != want).sum())
        raise AssertionError(f"{what} differs from np.bincount on {bad} "
                             f"words")
    if keys.size != int((want > 0).sum()):
        raise AssertionError(f"{what}: wrong number of distinct words")


def wordcount_path(torch, dev, words, gen_s, sh: Shapes, profile_dir=None):
    """MapReduce wordcount over 8 ranks, the reduce's sort pinned to K2."""
    import numpy as np
    from repro_torch.comm import Ranks
    from repro_torch.core.mapreduce import default_hash
    from repro_torch.sphere.dataflow import Dataflow, SPMDExecutor

    n_words = sh.words
    word_t = torch.from_numpy(words).reshape(WORLD, -1).to(dev)
    shuffled = (Dataflow.source()
                .map(wordcount_emit)
                .shuffle(by=lambda r: default_hash(r["key"], WORLD),
                         num_buckets=WORLD))
    df = shuffled.reduce(wordcount_count)
    ex = SPMDExecutor(Ranks(WORLD))
    res, run = run_path(torch, ex, df, {"word": word_t})
    if run["launches"]["radix_sort"] == 0 or run["launches"]["partition"] == 0:
        raise AssertionError(f"wordcount launched {run['launches']}")
    dropped = int(res.dropped)
    keys = res.records["key"][res.valid].cpu().numpy()
    counts = res.records["value"][res.valid].cpu().numpy()
    want = np.bincount(words, minlength=VOCAB)
    if dropped != 0:
        raise AssertionError(f"wordcount dropped {dropped}")
    check_word_counts(words, keys, counts, "wordcount")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm = ex.run(df, {"word": word_t})
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    del warm, res
    out = {"phase": "wordcount", "words": n_words, "vocab": VOCAB,
           "zipf": ZIPF_A, "ranks": WORLD, "reduce_sort": "radix",
           "distinct_words": int(keys.size), "top_word_share":
           float(want.max() / n_words), "dropped": dropped,
           "words_per_s": n_words / run["wall_ms"] * 1e3, **run,
           "warm_wall_ms": warm_ms, "warm_words_per_s": n_words / warm_ms
           * 1e3, "numpy_words_s": gen_s, "recv_rows_per_rank": sh.wc_recv}
    out["k2_on_path_rows"] = radix_on_reduce_input(torch, ex, shuffled,
                                                   word_t)
    if profile_dir:
        out["profile"] = profile_run(
            torch, lambda: ex.run(df, {"word": word_t}), profile_dir,
            "wordcount")
    torch.cuda.empty_cache()
    return out


def radix_on_reduce_input(torch, ex, shuffled, word_t):
    """K2 against its plain version, tolerance 0, on the wordcount's own
    sort input: every rank's received keys with the int32 maximum in the
    empty slots, as ``reduce_by_key_sum`` hands them to the sort. Word ids
    below 2^20 and mostly-empty rows make its scatters far more regular
    than the random keys of phase 3."""
    from repro_torch.kernels.radix_sort import (sort_kv_segments_radix,
                                                sort_kv_segments_radix_ref)
    res = ex.run(shuffled, {"word": word_t})
    keys = torch.where(res.valid, res.records["key"], 0x7FFFFFFF).contiguous()
    del res
    vals = torch.arange(keys.shape[1], dtype=torch.int32,
                        device=keys.device).expand(WORLD, -1).contiguous()
    chk = Check("radix_sort")
    gk, gv = sort_kv_segments_radix(keys, vals)
    rk, rv = sort_kv_segments_radix_ref(keys, vals)
    chk.equal("keys on the reduce input", gk, rk)
    chk.equal("values on the reduce input", gv, rv)
    del gk, gv, rk, rv

    return {"data": "the wordcount's own sort input", "cases": chk.cases,
            "max_abs_err": chk.max_abs_err,
            "valid_share": float((keys != 0x7FFFFFFF).float().mean()),
            **sort_timing(torch, sort_kv_segments_radix,
                          sort_kv_segments_radix_ref, keys, vals,
                          K2_BYTES_PER_KV)}


def host_input(torch, keys, value):
    """Phase 5's input records, packed into 100-byte rows on the card and
    copied to the host once: ``WORLD`` numpy slices, the Sector files of
    phase 9."""
    import numpy as np
    from repro_torch.core.records import RecordCodec
    codec = RecordCodec.from_fields({"key": "int32",
                                     "value": ("uint8", (VALUE_BYTES,))})
    rows = codec.pack({"key": keys.reshape(-1),
                       "value": value.reshape(-1, VALUE_BYTES)})
    block = rows.cpu().numpy()
    del rows
    return codec, np.array_split(block, WORLD)


def filesystem_of(path: str) -> str:
    """'<mount point> <type>' of the file system holding ``path``."""
    best = ("?", "?")
    real = os.path.realpath(path)
    with open("/proc/mounts") as f:
        for line in f:
            parts = line.split()
            mnt = parts[1]
            if (real == mnt or real.startswith(mnt.rstrip("/") + "/")) \
                    and len(mnt) >= len(best[0].rstrip("?")):
                best = (mnt, parts[2])
    return " ".join(best)


class SectorDeployment:
    """``make_sector`` over ``WORLD`` slaves in a temporary directory on the
    machine's local disk (removed by :meth:`close`), replication 2, the
    input uploaded as ``WORLD`` slices and replicated, one SPE per slave."""

    def __init__(self, slices, tag: str):
        import shutil
        import tempfile
        from repro_torch.launch.train import make_sector
        self.root = tempfile.mkdtemp(prefix=f"chip_smoke_sector_{tag}_")
        self.free_bytes = shutil.disk_usage(self.root).free
        self.fs = filesystem_of(self.root)
        # input and one run's bucket files, each twice (replication 2)
        need = 4 * sum(s.nbytes for s in slices)
        if self.free_bytes < need + (1 << 30):
            self.close()
            raise RuntimeError(f"{self.root} ({self.fs}) has "
                               f"{self.free_bytes} bytes free; the host "
                               f"path needs {need} and 1 GiB to spare")
        try:
            self.master, self.client, self.daemon = make_sector(
                self.root, num_slaves=WORLD, replication=2)
            t0 = time.perf_counter()
            self.client.upload_dataset("/terasort/in",
                                       [s.tobytes() for s in slices])
            self.daemon.run_until_stable()
            self.setup_s = time.perf_counter() - t0
        except BaseException:
            self.close()
            raise
        self.paths = [f"/terasort/in.{i:05d}" for i in range(len(slices))]

    def spes(self, fail_after=None):
        from repro_torch.sphere.spe import SPE
        return [SPE(i, self.master.slaves[i].address, self.master,
                    self.client.session_id,
                    fail_after=(fail_after or {}).get(i))
                for i in range(WORLD)]

    def host_rates(self, block) -> dict:
        """GB/s of the host work each bucket byte meets on this machine,
        on one slice: ``tobytes``, md5 (every slave write hashes), a file
        write and a read back on the deployment's file system."""
        import hashlib
        path = os.path.join(self.root, "rate_probe")
        t0 = time.perf_counter()
        data = block.tobytes()
        t1 = time.perf_counter()
        hashlib.md5(data).hexdigest()
        t2 = time.perf_counter()
        with open(path, "wb") as f:
            f.write(data)
        t3 = time.perf_counter()
        with open(path, "rb") as f:
            f.read()
        t4 = time.perf_counter()
        os.remove(path)
        gb = len(data) / 1e9
        return {"bytes": len(data), "tobytes_gb_s": gb / (t1 - t0),
                "md5_gb_s": gb / (t2 - t1), "write_gb_s": gb / (t3 - t2),
                "read_gb_s": gb / (t4 - t3)}

    def disk_bytes(self) -> int:
        return sum(s.used_bytes() for s in self.master.slaves.values())

    def drop_scratch(self) -> None:
        """Delete every bucket file of earlier runs (disk space)."""
        for meta in self.client.ls("/.dataflow"):
            self.client.delete(meta.path)

    def close(self) -> None:
        import shutil
        shutil.rmtree(self.root, ignore_errors=True)


class TimedDaemon:
    """The executor's replication daemon, timed: ``seconds`` of
    ``run_until_stable`` (the replication half of ``materialize_s``)."""

    def __init__(self, daemon):
        self.daemon = daemon
        self.seconds = 0.0

    def run_until_stable(self):
        t0 = time.perf_counter()
        made = self.daemon.run_until_stable()
        self.seconds += time.perf_counter() - t0
        return made


class SlaveClock:
    """While entered, the seconds and calls of every slave's
    ``write_file`` and, inside it, of its md5, and of ``used_bytes`` (a
    walk of the slave's directory, by every write and by the master's
    placement): the host work each Sector write costs, measured on the
    path."""

    NAMES = ("write_file", "md5", "used_bytes")

    def __init__(self):
        self.seconds = dict.fromkeys(self.NAMES, 0.0)
        self.calls = dict.fromkeys(self.NAMES, 0)

    def _timed(self, name, fn):
        def timed(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                self.seconds[name] += time.perf_counter() - t0
                self.calls[name] += 1
        return timed

    def __enter__(self):
        from repro_torch.sector import slave
        self._saved = [(slave, "_md5", slave._md5),
                       (slave.SlaveNode, "used_bytes",
                        slave.SlaveNode.used_bytes),
                       (slave.SlaveNode, "write_file",
                        slave.SlaveNode.write_file)]
        for owner, attr, fn in self._saved:
            setattr(owner, attr, self._timed(attr.lstrip("_"), fn))
        return self

    def __exit__(self, *exc):
        for owner, attr, fn in self._saved:
            setattr(owner, attr, fn)

    def report(self) -> dict:
        return {"seconds": dict(self.seconds), "calls": dict(self.calls)}


def span_seconds(tracer) -> dict:
    """Seconds of the host run's spans by phase: the SPEs' reads (download,
    copy to the card, unpack) and UDFs (the phase's device work, ending
    in the copy of the bucket rows to the host in phase 0; phase 1's
    output stays on the card unsynchronised), and the bucket files'
    upload and replication."""
    spans = tracer.buffer.spans()
    by_id = {sp.span_id: sp for sp in spans}
    out = {}
    for sp in spans:
        if sp.duration is None:
            continue
        cur = sp
        while cur is not None and not cur.name.startswith("phase["):
            cur = by_id.get(cur.parent_id)
        if cur is None:
            continue
        name = ("hop_buckets" if sp.name.startswith("hop[") else
                "segments" if sp.name.startswith("segment[") else sp.name)
        if name in ("spe.read", "spe.udf", "segments", "hop_buckets"):
            row = out.setdefault(cur.name, {})
            row[name] = row.get(name, 0.0) + sp.duration
    return out


def host_path(torch, dev, codec, slices, flat_sorted_keys, checks,
              profile_dir=None):
    """Phase 9: Terasort over Sector files through ``HostExecutor`` — the
    paper's own data plane. Phase 0 decodes each input slice on the card
    and splits it into bucket files with K1; phase 1 sorts each bucket
    file with K2. Checks, the wall, the per-phase split, the spans and
    the slaves' writes of that one traced run, disk bytes, peak memory; then K1 and K2 against their plain versions at
    the shapes this path gave them; then a small run with a crashing
    SPE."""
    import numpy as np
    from repro_torch.kernels import partition, radix_sort, ref
    from repro_torch.obs.trace import Tracer
    from repro_torch.sphere.dataflow import Dataflow, HostExecutor

    n = sum(s.shape[0] for s in slices)
    df = Dataflow.source(codec).sort(key=lambda r: r["key"],
                                     num_buckets=WORLD)
    rows = torch.from_numpy(np.concatenate(slices)).to(dev)
    inp = codec.unpack(rows)
    in_keys = inp["key"].clone()
    in_value = inp["value"]
    want_keys = torch.sort(in_keys).values
    del rows, inp
    if not torch.equal(want_keys, flat_sorted_keys.to(dev)):
        raise AssertionError("torch.sort of the host input differs from "
                             "phase 5's sorted keys")
    sector = SectorDeployment(slices, "big")
    try:
        daemon = TimedDaemon(sector.daemon)
        disk0 = sector.disk_bytes()
        ex = HostExecutor(sector.master, sector.client, sector.spes(),
                          daemon=daemon)
        tracer = Tracer()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        with SlaveClock() as slave_clock:
            t0 = time.perf_counter()
            res = ex.run(df, sector.paths, trace=tracer)
            torch.cuda.synchronize()
            cold = time.perf_counter() - t0
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated()
        disk_written = sector.disk_bytes() - disk0
        segs = [p["segments"] for p in res.phase_times]
        check_host_result(torch, res, in_keys, in_value, want_keys,
                          "host path")
        want = {"partition": segs[0], "radix_sort": segs[1]}
        got = {k: launches[k] for k in want}
        if got != want or launches["bitonic_sort"] or launches["bucket_hist"]:
            raise AssertionError(f"host path launched {launches}; expected "
                                 f"K1 once per phase-0 segment and K2 once "
                                 f"per phase-1 bucket file: {want}")
        phases = [{k: p[k] for k in ("phase", "terminator", "seconds",
                                     "engine_s", "materialize_s",
                                     "segments")} for p in res.phase_times]
        del res
        out = {"phase": "host_sector_terasort", "records": n,
               "record_bytes": codec.nbytes, "slaves": WORLD,
               "replication": 2, "spes": WORLD, "buckets": WORLD,
               "segments": segs, "launches": launches,
               "wall_ms": cold * 1e3, "records_per_s": n / cold,
               "phase_times": phases, "replication_s": daemon.seconds,
               "spans_s": span_seconds(tracer),
               "slave_writes": slave_clock.report(),
               "setup_s": sector.setup_s,
               "disk_bytes_written": disk_written,
               "disk_free_bytes_before": sector.free_bytes,
               "disk": f"{sector.root} on {sector.fs}",
               "peak_mem_bytes": peak, "errors": 0, "data_errors": 0,
               "host_rates": sector.host_rates(slices[0]),
               "same_keys_as_flat": True}
        if profile_dir:
            def once():
                sector.drop_scratch()
                return ex.run(df, sector.paths)
            sector.drop_scratch()
            out["profile"] = profile_run(torch, once, profile_dir,
                                         "host_sector_terasort")
    finally:
        sector.close()
    del in_keys, in_value, want_keys
    torch.cuda.empty_cache()

    # K1 and K2 held to their plain versions at this path's shapes
    seg_n = slices[0].shape[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    ids = torch.randint(0, WORLD, (seg_n,), generator=gen, device=dev,
                        dtype=torch.int32)
    k1 = checks["partition"][0]
    rank, counts = partition.partition_rank(ids, WORLD)
    rrank, rcounts = ref.partition_rank_ref(ids, WORLD)
    k1.equal("host bucket split ranks", rank, rrank)
    k1.equal("host bucket split counts", counts, rcounts)
    keys = torch.randint(0, (1 << 31) - 1, (1, seg_n), generator=gen,
                         device=dev, dtype=torch.int32)
    pos = torch.arange(seg_n, dtype=torch.int32, device=dev)[None]
    k2 = checks["radix_sort"][0]
    gk, gv = radix_sort.sort_kv_segments_radix(keys, pos)
    rk, rv = radix_sort.sort_kv_segments_radix_ref(keys, pos)
    k2.equal("host stage-2 keys", gk, rk)
    k2.equal("host stage-2 order", gv, rv)
    out["kernels_at_path_shapes"] = [
        {"name": "partition", "shape": [1, seg_n], "num_dest": WORLD,
         "ms": time_ms(torch, lambda: partition.partition_rank(ids, WORLD)),
         "plain_ms": time_ms(torch, lambda: ref.partition_rank_ref(
             ids, WORLD), iters=3),
         "library_ms": time_ms(torch, lambda: torch.bincount(
             ids, minlength=WORLD)),
         "bound_ms": bound_ms(8 * seg_n + 4 * WORLD)},
        {"name": "radix_sort", "shape": [1, seg_n],
         "ms": time_ms(torch, lambda: radix_sort.sort_kv_segments_radix(
             keys, pos)),
         "plain_ms": time_ms(torch, lambda: radix_sort.
                             sort_kv_segments_radix_ref(keys, pos), iters=3),
         "library_ms": time_ms(torch, lambda: torch.sort(
             keys, dim=1, stable=True)),
         "bound_ms": bound_ms(16 * seg_n)}]
    del ids, rank, counts, rrank, rcounts, keys, pos, gk, gv, rk, rv
    out["crash_run"] = host_crash_run(torch, dev, codec, slices, df)
    torch.cuda.empty_cache()
    return out


def check_host_result(torch, res, in_keys, in_value, want_keys, what: str):
    """A host sort's output: no errors, every record once, globally sorted,
    each value row beside its key, keys equal to ``torch.sort`` of the
    input's."""
    if res.errors or res.data_errors:
        raise AssertionError(f"{what}: errors {res.errors}, data_errors "
                             f"{res.data_errors}")
    out_k, out_v = res.records["key"], res.records["value"]
    n = in_keys.numel()
    if out_k.numel() != n or not bool(res.valid.all()):
        raise AssertionError(f"{what}: {out_k.numel()} records, expected {n}")
    if not torch.equal(out_k, want_keys):
        raise AssertionError(f"{what}: keys differ from torch.sort of the "
                             f"input keys")
    idx = out_v[:, :4].contiguous().view(torch.int32).reshape(-1).to(
        torch.int64)
    if not torch.equal(torch.sort(idx).values,
                       torch.arange(n, device=idx.device, dtype=torch.int64)):
        raise AssertionError(f"{what}: delivered records are not a "
                             f"permutation")
    if not torch.equal(in_keys[idx], out_k) or not torch.equal(
            in_value[idx], out_v):
        raise AssertionError(f"{what}: a delivered value row does not match "
                             f"its key")


def by_index(torch, res):
    """A sort's records ordered by the input index in their first value
    bytes."""
    idx = res.records["value"][:, :4].contiguous().view(torch.int32)
    order = torch.argsort(idx.reshape(-1))
    return res.records["key"][order], res.records["value"][order]


def host_crash_run(torch, dev, codec, slices, df, n_small: int = 1 << 20):
    """The host sort of a small prefix of the input twice: once as is, then
    with the SPE that did the most segments crashing after its first
    (``fail_after=1``). The same sorted keys and the same records, and
    the retry must show."""
    from repro_torch.sphere.dataflow import HostExecutor
    per = n_small // WORLD
    small = [s[:per] for s in slices]
    n_small = sum(s.shape[0] for s in small)
    sector = SectorDeployment(small, "small")
    try:
        spes = sector.spes()
        base = HostExecutor(sector.master, sector.client, spes,
                            daemon=sector.daemon).run(df, sector.paths)
        busiest = max(spes, key=lambda s: (s.segments_done, -s.spe_id))
        crashing = sector.spes(fail_after={busiest.spe_id: 1})
        res = HostExecutor(sector.master, sector.client, crashing,
                           daemon=sector.daemon).run(df, sector.paths)
        if res.retries < 1 or res.errors or res.data_errors:
            raise AssertionError(f"crash run: retries {res.retries}, errors "
                                 f"{res.errors}")
        # equal keys may come out in another order: a re-pooled segment
        # reaches the bucket files later (arrival order, as in the JAX
        # package), so records are compared by their input index
        if not torch.equal(res.records["key"], base.records["key"]):
            raise AssertionError("crash run: keys differ from the run "
                                 "without the crash")
        for f, (a, b) in zip(("key", "value"), zip(by_index(torch, res),
                                                   by_index(torch, base))):
            if not torch.equal(a, b):
                raise AssertionError(f"crash run: {f} of a record differs "
                                     f"from the run without the crash")
        return {"records": n_small, "crashing_spe": busiest.spe_id,
                "retries": res.retries, "same_output": True}
    finally:
        sector.close()


def profile_run(torch, run_once, out_dir: str, name: str):
    """Two more runs of a path (``run_once()``): one warm (steady-state
    wall time), one under ``torch.profiler``. From the profiled run alone: the time of
    every device-side event (kernels, copies, fills; an operator's own row
    is left out so that no time is counted twice), the union of their
    intervals, and that union's share of the profiled run's wall time.
    Writes the Chrome trace to ``out_dir/<name>_trace.json``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_once()
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_once()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, f"{name}_trace.json"))
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        raise AssertionError("the profiler recorded no device event")
    by_name = {}
    busy_us, cur_start, cur_end = 0.0, spans[0][0], spans[0][1]
    for start, end, name in spans:
        us, calls = by_name.get(name, (0.0, 0))
        by_name[name] = (us + end - start, calls + 1)
        if start > cur_end:
            busy_us += cur_end - cur_start
            cur_start = start
        cur_end = max(cur_end, end)
    busy_us += cur_end - cur_start
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    return {"warm_wall_ms": warm * 1e3, "profiled_wall_ms": prof_wall * 1e3,
            "device_event_ms": sum(us for us, _ in by_name.values()) / 1e3,
            "device_busy_ms": busy_us / 1e3,
            "device_span_ms": (spans[-1][1] - spans[0][0]) / 1e3,
            "device_busy_share": busy_us / 1e3 / (prof_wall * 1e3),
            "top": [{"op": k[:90], "ms": us / 1e3, "calls": c}
                    for k, (us, c) in rows[:25]]}


def shim_runs(torch, dev, gen, n_log2: int):
    from repro_torch.comm import Ranks
    from repro_torch.core.sort import (hadoop_style_sort, is_globally_sorted,
                                       terasort)
    from repro_torch.kernels import autotune, radix_sort

    ranks = Ranks(WORLD)
    out = {}

    def run(n, **kw):
        keys = torch.randint(0, (1 << 31) - 1, (WORLD, n // WORLD),
                             generator=gen, device=dev, dtype=torch.int32)
        payload = torch.arange(n, dtype=torch.int32,
                               device=dev).reshape(WORLD, -1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = terasort(keys, payload, ranks, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        vk, vp = res.keys[res.valid], res.payload[res.valid]
        ok = (int(res.dropped) == 0 and vk.numel() == n
              and is_globally_sorted(res, WORLD)
              and torch.equal(keys.reshape(-1)[vp.to(torch.int64)], vk)
              and torch.equal(torch.sort(vp).values, payload.reshape(-1)))
        if not ok:
            raise AssertionError(f"terasort {kw} at N={n}: not a sorted "
                                 f"permutation without drops")
        return keys, payload, res, wall

    n = 1 << n_log2
    radix_sort.KERNEL.launches = 0
    _, _, _, wall = run(n, sort_algo="radix")
    radix_launches = radix_sort.KERNEL.launches
    if radix_launches == 0:
        raise AssertionError("sort_algo='radix' did not launch the radix "
                             "kernel")
    out["radix"] = {"records": n, "wall_ms": wall * 1e3,
                    "launches": radix_launches}
    _, _, _, wall = run(n, buckets_per_device=4)
    out["bpd4"] = {"records": n, "wall_ms": wall * 1e3}

    nh = 1 << min(n_log2, 22)
    keys, payload, a, _ = run(nh)
    hadoop_style_sort(keys, payload, ranks)   # the autotuner measures here
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    b = hadoop_style_sort(keys, payload, ranks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not torch.equal(a.keys[a.valid], b.keys[b.valid]):
        raise AssertionError("hadoop_style_sort keys differ from terasort's")
    out["hadoop"] = {"records": nh, "wall_ms": wall * 1e3}

    seg_cap = WORLD * (int(n // WORLD / WORLD * 2.0) + 1)
    choice = autotune.choose(WORLD, seg_cap, torch.int32, device=dev)
    out["autotune"] = {"cell": autotune.cell_key(WORLD, seg_cap, torch.int32,
                                                 True, "cuda"),
                       "algo": choice.algo, "source": choice.source,
                       "melem": dict(choice.melem),
                       "skipped": dict(choice.skipped)}
    return out, radix_launches


# -- phases 10 and 11: a stream through a fault storm, faults in batch paths -----


def stream_pipeline():
    """Phase 7's pipeline as a stream: map -> shuffle(default_hash, 8
    buckets, capacity_factor 4) -> reduce(reduce_by_key_sum(radix))."""
    from repro_torch.core.mapreduce import default_hash
    from repro_torch.sphere.dataflow import Dataflow
    return (Dataflow.stream_source()
            .map(wordcount_emit)
            .shuffle(by=lambda r: default_hash(r["key"], WORLD),
                     num_buckets=WORLD, capacity_factor=4.0)
            .reduce(wordcount_count))


def storm_schedule():
    from repro_torch.sphere.chaos import ChaosSchedule, FaultPlan
    return ChaosSchedule([
        FaultPlan(kind="lose_batch", at_batch=4),
        FaultPlan(kind="lose_device", at_batch=10),
        FaultPlan(kind="kill_slave", at_batch=16, wipe=True),
        FaultPlan(kind="rejoin_slave", at_batch=24),
    ], seed=7)


def percentile(xs, q):
    import numpy as np
    return float(np.percentile(np.asarray(xs), q)) if xs else None


def stream_run(torch, words, storm: bool, profile_dir=None):
    """One run of phase 10's stream over the 2^26 words, cut into 256
    requests of 2^18 from tenants ``free``, ``pro`` and ``enterprise``
    (32, 96 and 128 requests, their 1:3:4 weights, all admitted up front so
    every queue stays backlogged) at ``micro_batch = 2^21`` and a carry of
    2^18 rows a rank, on a virtual clock of 1.0 a step. ``storm``: the
    four-fault schedule and the Sector deployment (8 slaves, replication 2,
    a FailureDetector and a ReplicationDaemon on the virtual clock), the
    boundaries' uploads timed; else neither. Checks the final snapshot
    against ``np.bincount``, exactly-once delivery, no drops, the faults,
    recoveries, cache misses, the grid after the shrink, and K1 and K2
    once a delivered batch (counted from zero; the carry's schema probe
    apart)."""
    import collections
    import shutil
    import tempfile
    import numpy as np
    from repro_torch.comm import Ranks
    from repro_torch.core.retry import RetryPolicy
    from repro_torch.launch.train import make_sector
    from repro_torch.sector.master import FailureDetector, ReplicationDaemon
    from repro_torch.sphere.dataflow import SPMDExecutor
    from repro_torch.sphere.streaming import StreamExecutor, TenantQueue

    requests = words.reshape(-1, STREAM_REQUEST)
    n_req = requests.shape[0]
    per_batch = STREAM_BATCH // STREAM_REQUEST
    pattern = [t for t, w in TENANTS.items() for _ in range(int(w))]
    if len(pattern) != per_batch:
        raise AssertionError(f"tenant weights {TENANTS} do not fill a batch")
    queue = TenantQueue(quantum=float(STREAM_REQUEST), capacity=n_req,
                        max_requeues=5,
                        retry_policy=RetryPolicy(base=0.25, cap=2.0,
                                                 jitter=0.1, seed=3))
    for name, w in TENANTS.items():
        queue.register(name, weight=w)
    vclock = {"now": 0.0}
    schedule = storm_schedule() if storm else None
    ex = StreamExecutor(SPMDExecutor(Ranks(WORLD)), stream_pipeline(),
                        micro_batch=STREAM_BATCH,
                        carry_capacity=STREAM_CARRY, queue=queue,
                        clock=lambda: vclock["now"], chaos=schedule)
    root = tempfile.mkdtemp(prefix="chip_smoke_stream_") if storm else None
    uploads, boundaries = [], []
    try:
        if storm:
            master, client, _ = make_sector(root, num_slaves=WORLD,
                                            replication=2)
            det = FailureDetector(master, suspect_after=0.5, down_after=1.5,
                                  clock=lambda: vclock["now"])
            daemon = ReplicationDaemon(master, clock=lambda: vclock["now"],
                                       detector=det)
            ex.attach_sector(master, client, daemon=daemon, detector=det,
                             retain=8)
            upload, boundary = client.upload, ex._sector_boundary

            def timed_upload(path, data):
                t0 = time.perf_counter()
                meta = upload(path, data)
                uploads.append({"path": path, "bytes": len(data),
                                "upload_s": time.perf_counter() - t0})
                return meta

            def timed_boundary(ckpt, now, tr):
                t0 = time.perf_counter()
                boundary(ckpt, now, tr)
                boundaries.append(time.perf_counter() - t0)

            client.upload = timed_upload
            ex._sector_boundary = timed_boundary
        for i in range(n_req):
            ex.submit({"word": requests[i]}, tenant=pattern[i % per_batch])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        steps, delivered, dropped = [], collections.Counter(), []
        t_run = time.perf_counter()
        for step in range(STREAM_STEPS):
            if not storm and not queue.pending():
                break               # no fault: 32 steps deliver everything
            vclock["now"] = float(step)
            ranks = ex.inner.axis_size
            t0 = time.perf_counter()
            b = ex.step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            lost = b is None or not b.delivered
            steps.append({"step": step, "ranks_before": ranks,
                          "ranks": ex.inner.axis_size, "wall_s": wall,
                          "lost": lost})
            if b is not None:
                dropped.append(b.dropped)
                for tk in b.delivered:
                    delivered[tk.req_id] += 1
        run_s = time.perf_counter() - t_run
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated()
        st = ex.stats()
        snap = ex.carry_state()
        check_word_counts(words, snap["key"], snap["value"],
                          "stream snapshot")
        if queue.pending() or len(delivered) != n_req:
            raise AssertionError(f"{len(delivered)} of {n_req} requests "
                                 f"delivered in {STREAM_STEPS} steps, "
                                 f"{queue.pending()} pending")
        if max(delivered.values()) != 1 or any(dropped):
            raise AssertionError(f"a request delivered twice or records "
                                 f"dropped: {max(delivered.values())}, "
                                 f"{dropped}")
        n_lost = sum(s["lost"] for s in steps)
        done = len(steps) - n_lost
        want_lost, want_rec, want_miss, want_ranks = (
            (2, 2, 2, WORLD // 2) if storm else (0, 0, 1, WORLD))
        if (n_lost, st["recoveries"], st["cache"]["misses"],
                ex.inner.axis_size) != (want_lost, want_rec, want_miss,
                                        want_ranks):
            raise AssertionError(
                f"stream: {n_lost} lost steps, {st['recoveries']} "
                f"recoveries, {st['cache']['misses']} cache misses, "
                f"{ex.inner.axis_size} ranks at the end; expected "
                f"{(want_lost, want_rec, want_miss, want_ranks)}")
        if storm and schedule.fired_count != 4:
            raise AssertionError(f"{schedule.fired_count} of 4 faults fired: "
                                 f"{schedule.events}")
        path = {k: launches[k] - ex.init_launches.get(k, 0) for k in launches}
        want = {"partition": done, "bitonic_sort": 0, "radix_sort": done,
                "bucket_hist": 0}
        if path != want:
            raise AssertionError(f"stream launched {path} over {done} "
                                 f"delivered batches (the carry's probe: "
                                 f"{ex.init_launches}); expected {want}")
        ok = [s for s in steps if not s["lost"]]
        first4 = next((s["step"] for s in ok if s["ranks"] == WORLD // 2),
                      None)
        steady8 = [s["wall_s"] for s in ok
                   if s["ranks"] == WORLD and s["step"] > 0]
        steady4 = [s["wall_s"] for s in ok
                   if s["ranks"] == WORLD // 2 and s["step"] != first4]
        out = {"run": "storm" if storm else "clean, no Sector",
               "requests": n_req, "words": int(words.size),
               "micro_batch": STREAM_BATCH, "carry_rows_per_rank":
               STREAM_CARRY, "steps": len(steps), "lost_steps": n_lost,
               "delivered_batches": done, "run_s": run_s,
               "stream_run_seconds": st["run_seconds"],
               "words_per_s": st["records_per_s"],
               "wall_words_per_s": words.size / run_s,
               "first_batch_ms": steps[0]["wall_s"] * 1e3,
               "steady_p50_ms_8_ranks": percentile(steady8, 50) * 1e3,
               "steady_p99_ms_8_ranks": percentile(steady8, 99) * 1e3,
               "recoveries": st["recoveries"], "cache": st["cache"],
               "launches": path, "init_launches": ex.init_launches,
               "peak_mem_bytes": peak,
               "tenants": {k: {f: v[f] for f in ("delivered", "requeues",
                                                   "records_served")}
                           for k, v in st["tenants"].items()},
               "step_walls_ms": [round(s["wall_s"] * 1e3, 3) for s in steps]}
        if storm:
            lose = next(s for s in steps if s["step"] == 10)
            out.update({
                "steady_p50_ms_4_ranks": percentile(steady4, 50) * 1e3,
                "steady_p99_ms_4_ranks": percentile(steady4, 99) * 1e3,
                "lose_device_step_ms": lose["wall_s"] * 1e3,
                "first_batch_on_4_ranks_ms": next(
                    s["wall_s"] for s in steps if s["step"] == first4) * 1e3,
                "events": list(schedule.events),
                "detector": dict(det.stats), "master": dict(master.stats),
                "checkpoint_bytes": [u["bytes"] for u in uploads],
                "checkpoint_upload_s": [u["upload_s"] for u in uploads],
                "boundary_s": boundaries,
                "boundary_p50_s": percentile(boundaries, 50),
                "sector_root": filesystem_of(root)})
        if profile_dir:
            # after the checks: one more batch of 8 requests, twice (warm,
            # then profiled), with the Sector boundary in the storm run
            def one_batch():
                for i in range(per_batch):
                    ex.submit({"word": requests[i]},
                              tenant=pattern[i % per_batch])
                vclock["now"] += 1.0
                return ex.step()
            out["profile"] = profile_run(
                torch, one_batch, profile_dir,
                "stream_storm_batch" if storm else "stream_steady_batch")
        return out
    finally:
        if root is not None:
            shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()


def stream_storm(torch, words, profile_dir=None):
    """Phase 10: the stream through the four-fault storm with Sector
    attached, then the same stream fault-free without Sector (the
    stream's own rate)."""
    t0 = time.perf_counter()
    storm = stream_run(torch, words, storm=True, profile_dir=profile_dir)
    clean = stream_run(torch, words, storm=False, profile_dir=profile_dir)
    return {"phase": "stream_wordcount_storm", "storm": storm,
            "clean": clean, "phase_s": time.perf_counter() - t0}


class CheckpointClock:
    """While entered, the seconds and bytes of every ``HopCheckpoint``
    snapshot (records packed on the card, one copy to the host) and
    restore (one copy back, unpacked and re-stacked there), each fenced
    by ``torch.cuda.synchronize``."""

    def __init__(self, torch):
        self.torch = torch
        self.snapshots, self.restores = [], []

    def __enter__(self):
        from repro_torch.sphere.chaos import HopCheckpoint
        self._saved = {k: HopCheckpoint.__dict__[k]
                       for k in ("snapshot", "restore")}
        snap = self._saved["snapshot"].__func__
        restore = self._saved["restore"]
        clock, torch = self, self.torch

        def snapshot(cls, records, valid, hop, dropped):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ck = snap(cls, records, valid, hop, dropped)
            clock.snapshots.append({
                "hop": hop, "bytes": ck.payload.nbytes + ck.valid.nbytes,
                "s": time.perf_counter() - t0})
            return ck

        def timed_restore(ck, ranks, axes):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = restore(ck, ranks, axes)
            torch.cuda.synchronize()
            clock.restores.append({
                "hop": ck.hop, "bytes": ck.payload.nbytes + ck.valid.nbytes,
                "ranks": list(ranks.shape), "s": time.perf_counter() - t0})
            return out

        HopCheckpoint.snapshot = classmethod(snapshot)
        HopCheckpoint.restore = timed_restore
        return self

    def __exit__(self, *exc):
        from repro_torch.sphere.chaos import HopCheckpoint
        for k, v in self._saved.items():
            setattr(HopCheckpoint, k, v)


def chaos_run(torch, ex, df, records, plan):
    """One segmented run under ``plan``: launches from zero, wall, peak
    memory, the checkpoints' bytes and seconds."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with CheckpointClock(torch) as clock:
        t0 = time.perf_counter()
        res = ex.run(df, records, chaos=plan)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return res, {"fault": f"{plan.kind}@{plan.phase}",
                 "wall_ms": wall * 1e3, "launches": read_launches(),
                 "recoveries": res.recoveries, "events": list(plan.events),
                 "ranks_after": list(res.valid.shape[:1]),
                 "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                 "snapshots": clock.snapshots, "restores": clock.restores}


def warm_wall_ms(torch, ex, df, records) -> float:
    """The fault-free one-pass run's warm wall (a cold run first)."""
    ex.run(df, records)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ex.run(df, records)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def expect(run, what, want, recoveries):
    got = {k: run["launches"][k] for k in ("partition", "bitonic_sort",
                                            "radix_sort", "bucket_hist")}
    if got != want or run["recoveries"] != recoveries:
        raise AssertionError(f"{what}: launched {got} with "
                             f"{run['recoveries']} recoveries; expected "
                             f"{want} and {recoveries}")


def batch_chaos(torch, dev, codec, slices, flat_sorted, words):
    """Phase 11: faults in the batch paths. The Terasort main path
    segmented with no fault and with ``lose_device`` at boundary 0 (resumes
    on 4 ranks), the ``(dc, node)`` sort losing a rank at boundary 0
    (resumes on ``(2, 2)``), the wordcount losing one at boundary 1
    (between the shuffle and the reduce), each against the fault-free
    result; then the host sort of a 2^20-record prefix under Sector faults
    at boundary 1 (``kill_slave`` with its disk, ``drop_bucket``)."""
    import numpy as np
    from repro_torch.comm import Ranks
    from repro_torch.core.mapreduce import default_hash
    from repro_torch.sphere.chaos import FaultPlan
    from repro_torch.sphere.dataflow import Dataflow, SPMDExecutor

    t_phase = time.perf_counter()
    rows = torch.from_numpy(np.concatenate(slices)).to(dev)
    inp = codec.unpack(rows)
    keys = inp["key"].reshape(WORLD, -1).clone()
    value = inp["value"].reshape(WORLD, -1, VALUE_BYTES).clone()
    del rows, inp
    flat_sorted = flat_sorted.to(dev)
    records = {"key": keys, "value": value}
    df = Dataflow.source().sort(key=lambda r: r["key"], num_buckets=WORLD,
                                capacity_factor=2.0)
    out = {"phase": "batch_chaos", "runs": []}

    def sorted_run(ex, plan, what, want, recoveries, ranks_after):
        res, run = chaos_run(torch, ex, df, records, plan)
        out_k = check_sorted_permutation(torch, res, keys, value, what)
        if not torch.equal(out_k, flat_sorted):
            raise AssertionError(f"{what}: sorted keys differ from phase 5's")
        if run["ranks_after"] != [ranks_after]:
            raise AssertionError(f"{what}: ended on {run['ranks_after']} "
                                 f"ranks, expected {ranks_after}")
        expect(run, what, want, recoveries)
        del res, out_k
        torch.cuda.empty_cache()
        return {"run": what, **run}

    ex = SPMDExecutor(Ranks(WORLD), sort_algo="bitonic")
    warm = warm_wall_ms(torch, ex, df, records)
    k13 = {"partition": 2, "bitonic_sort": 1, "radix_sort": 0,
           "bucket_hist": 0}
    for plan, rec, ranks in ((FaultPlan(kind="none"), 0, WORLD),
                             (FaultPlan(kind="lose_device", phase=0, seed=0),
                              1, WORLD // 2)):
        run = sorted_run(ex, plan, f"terasort, {plan.kind}", k13, rec, ranks)
        run["fault_free_warm_ms"] = warm
        out["runs"].append(run)
    del ex
    torch.cuda.empty_cache()

    ex = SPMDExecutor(Ranks(shape=GRID, axes=("dc", "node")),
                      sort_algo="bitonic")
    warm = warm_wall_ms(torch, ex, df, records)
    run = sorted_run(ex, FaultPlan(kind="lose_device", phase=0, seed=0),
                     "(dc, node) terasort, lose_device", {
                         "partition": 3, "bitonic_sort": 1, "radix_sort": 0,
                         "bucket_hist": 0}, 1, WORLD // 2)
    if run["events"][-1] != "resumed hop 0 on mesh {'dc': 2, 'node': 2}":
        raise AssertionError(f"grid resume: {run['events']}")
    run["fault_free_warm_ms"] = warm
    out["runs"].append(run)
    del ex, records, keys, value, flat_sorted
    torch.cuda.empty_cache()

    word_t = torch.from_numpy(words).reshape(WORLD, -1).to(dev)
    wdf = (Dataflow.source().map(wordcount_emit)
           .shuffle(by=lambda r: default_hash(r["key"], WORLD),
                    num_buckets=WORLD)
           .reduce(wordcount_count))
    ex = SPMDExecutor(Ranks(WORLD))
    warm = warm_wall_ms(torch, ex, wdf, {"word": word_t})
    res, run = chaos_run(torch, ex, wdf, {"word": word_t},
                         FaultPlan(kind="lose_device", phase=1, seed=0))
    if int(res.dropped) != 0:
        raise AssertionError(f"resumed wordcount dropped {int(res.dropped)}")
    check_word_counts(words, res.records["key"][res.valid].cpu().numpy(),
                      res.records["value"][res.valid].cpu().numpy(),
                      "resumed wordcount")
    expect(run, "wordcount, lose_device at boundary 1", {
        "partition": 1, "bitonic_sort": 0, "radix_sort": 1,
        "bucket_hist": 0}, 1)
    del res, word_t, ex
    torch.cuda.empty_cache()
    out["runs"].append({"run": "wordcount, lose_device at boundary 1",
                        "fault_free_warm_ms": warm, **run})
    out["host"] = host_chaos_runs(torch, codec, slices)
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def host_chaos_runs(torch, codec, slices, n_small: int = 1 << 20):
    """The phase 9 sort of a 2^20-record prefix: fault-free, then with
    ``kill_slave(phase=1, wipe=True)`` and with ``drop_bucket(phase=1)``,
    each in a fresh deployment, held to the fault-free keys and records."""
    from repro_torch.sphere.chaos import FaultPlan
    from repro_torch.sphere.dataflow import Dataflow, HostExecutor
    per = n_small // WORLD
    small = [s[:per] for s in slices]
    df = Dataflow.source(codec).sort(key=lambda r: r["key"],
                                     num_buckets=WORLD)
    runs, base = [], None
    for plan in (None, FaultPlan(kind="kill_slave", phase=1, wipe=True),
                 FaultPlan(kind="drop_bucket", phase=1)):
        sector = SectorDeployment(small, "chaos")
        try:
            ex = HostExecutor(sector.master, sector.client, sector.spes(),
                              daemon=sector.daemon)
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            res = ex.run(df, sector.paths, chaos=plan)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_launches()
        finally:
            sector.close()
        what = "fault-free" if plan is None else plan.kind
        if res.errors or res.data_errors:
            raise AssertionError(f"host {what}: errors {res.errors}")
        segs = [p["segments"] for p in res.phase_times]
        if launches["partition"] < segs[0] or launches["radix_sort"] < 1:
            raise AssertionError(f"host {what}: launched {launches}")
        if base is None:
            base = res
        else:
            if not plan.fired:
                raise AssertionError(f"host {what}: the fault did not fire")
            if not torch.equal(res.records["key"], base.records["key"]):
                raise AssertionError(f"host {what}: keys differ from the "
                                     f"fault-free run")
            for f, (a, b) in zip(("key", "value"), zip(
                    by_index(torch, res), by_index(torch, base))):
                if not torch.equal(a, b):
                    raise AssertionError(f"host {what}: {f} of a record "
                                         f"differs from the fault-free run")
        runs.append({"run": what, "records": n_small, "wall_ms": wall * 1e3,
                     "retries": res.retries, "recoveries": res.recoveries,
                     "events": list(plan.events) if plan else [],
                     "launches": launches, "segments": segs})
    return runs


# -- phase 12: serving Qwen1.5-MoE-A2.7B ------------------------------------------


def top2_margin(torch, logits):
    """top-1 minus top-2 of each row of ``logits`` (over the vocabulary)."""
    top = torch.topk(logits.float(), 2, dim=-1).values
    return top[..., 0] - top[..., 1]


def timed_serve(torch, model, params, prompts, vocab, frames=None):
    """The engine over ``prompts`` (with ``frames`` for an enc-dec model):
    each step timed to a synchronize, and for each emitted token the
    logits row behind it (the step's last decode is the one that
    emits)."""
    from repro_torch.serve import Request, ServeEngine
    eng = ServeEngine(model, params, batch_slots=SERVE_SLOTS,
                      max_len=SERVE_MAX_LEN)
    reqs = [Request(i, p, max_new_tokens=SERVE_NEW,
                    frames=None if frames is None else frames[i])
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    rows = {r.req_id: [] for r in reqs}
    last = {}
    inner_decode, inner_step = eng._decode, eng.step

    def decode(tokens, pos):
        logits = inner_decode(tokens, pos)
        last["step"] = (logits[:, 0, :vocab], list(eng.active))
        return logits

    step_ms = []

    def step():
        last.clear()
        t = time.perf_counter()
        done = inner_step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        if last:
            logits, active = last["step"]
            for s, req in enumerate(active):
                if req is not None:
                    rows[req.req_id].append(logits[s].float())
        return done

    eng._decode, eng.step = decode, step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    report = eng.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tokens = sum(len(r.out_tokens) for r in report)
    if not report.completed or len(report) != len(prompts):
        raise AssertionError(f"engine: {len(report)} of {len(prompts)} "
                             f"requests done, {len(report.unfinished)} not")
    if any(len(r.out_tokens) != SERVE_NEW for r in reqs):
        raise AssertionError("a request ended short of its new tokens")
    bad = [t for r in reqs for t in r.out_tokens if not 0 <= t < vocab]
    if bad:
        raise AssertionError(f"tokens outside the vocabulary: {bad[:8]}")
    return reqs, rows, {
        "requests": len(prompts), "slots": SERVE_SLOTS,
        "max_len": SERVE_MAX_LEN, "new_tokens": tokens,
        "engine_steps": len(step_ms), "wall_s": wall,
        "tokens_per_s": tokens / wall,
        "step_ms_p50": percentile(step_ms, 50),
        "step_ms_p99": percentile(step_ms, 99),
        "peak_mem_bytes": torch.cuda.max_memory_allocated()}


def serve_path(torch, dev, seed: int):
    """Phase 12 (see the module docstring)."""
    import dataclasses
    import numpy as np
    from repro_torch.comm import Ranks
    from repro_torch.configs import get_config
    from repro_torch.models import build, moe, transformer
    from repro_torch.models.layers import padded_vocab

    t_phase = time.perf_counter()
    cfg = get_config(SERVE_ARCH)
    model = build(cfg)
    v = cfg.vocab
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(gen, dev)
    torch.cuda.synchronize()
    out = {"phase": "serve_qwen2_moe", "arch": cfg.arch_id,
           "layers": cfg.num_layers, "d_model": cfg.d_model,
           "experts": cfg.num_experts, "top_k": cfg.top_k,
           "shared_experts": cfg.n_shared_experts, "vocab": v,
           "init_s": time.perf_counter() - t0,
           "params": sum(p.numel() for p in params.parameters()),
           "weight_bytes": sum(p.numel() * p.element_size()
                               for p in params.parameters()),
           "bf16_weight_bytes": sum(p.numel() * p.element_size()
                                    for p in params.parameters()
                                    if p.dtype == torch.bfloat16),
           "init_peak_mem_bytes": torch.cuda.max_memory_allocated()}
    rk = Ranks(shape=SERVE_GRID, axes=("data", "model"), device=dev)
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(
        0, v, (PREFILL_PROMPTS, PREFILL_LEN)).astype(np.int32)).to(dev)

    # (1) the grid prefill through the entry point, cold and warm
    def prefill():
        caches = model.init_caches(PREFILL_PROMPTS, PREFILL_MAX_LEN, dev)
        torch.cuda.synchronize()
        reset_launches()
        t = time.perf_counter()
        logits, caches = model.prefill(params, {"tokens": toks}, caches,
                                       ranks=rk)
        torch.cuda.synchronize()
        return logits, caches, (time.perf_counter() - t) * 1e3, \
            read_launches()

    torch.cuda.reset_peak_memory_stats()
    cold, caches, cold_ms, launches = prefill()
    del caches
    logits, caches, warm_ms, warm_launches = prefill()
    want = {"partition": 2 * cfg.num_layers, "bitonic_sort": 0,
            "radix_sort": 0, "bucket_hist": 0}
    for run in (launches, warm_launches):
        if run != want:
            raise AssertionError(f"grid prefill launched {run}; one prefill "
                                 f"runs K1 twice a MoE layer: {want}")
    if logits.shape != (PREFILL_PROMPTS, 1, padded_vocab(v)) \
            or not torch.isfinite(logits[..., :v]).all() \
            or not (logits[..., v:] == -1e30).all():
        raise AssertionError("prefill logits: not finite, or padded "
                             "columns not masked")
    tokens = PREFILL_PROMPTS * PREFILL_LEN
    out.update({"grid": list(SERVE_GRID), "prompts": PREFILL_PROMPTS,
                "prompt_len": PREFILL_LEN, "cache_len": PREFILL_MAX_LEN,
                "capacity_factor": cfg.capacity_factor,
                "moe_shapes": moe_shapes(),
                "prefill_cold_ms": cold_ms, "prefill_warm_ms": warm_ms,
                "prefill_tokens_per_s": tokens / warm_ms * 1e3,
                "prefill_k1_launches": launches["partition"],
                "launches": launches,
                "prefill_peak_mem_bytes": torch.cuda.max_memory_allocated()})

    nxt = logits[:, -1, :v].argmax(-1).to(torch.int32)
    step_ms = []
    for t in range(DECODE_STEPS):
        pos = torch.full((PREFILL_PROMPTS, 1), PREFILL_LEN + t,
                         dtype=torch.int32, device=dev)
        t0 = time.perf_counter()
        lg, caches = model.decode_step(params, caches,
                                       {"tokens": nxt[:, None], "pos": pos})
        nxt = lg[:, -1, :v].argmax(-1).to(torch.int32)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if not torch.isfinite(lg[..., :v]).all():
            raise AssertionError(f"decode step {t}: logits not finite")
    if int(caches["pos"].max()) != PREFILL_LEN + DECODE_STEPS - 1:
        raise AssertionError("decode steps did not fill the caches")
    del caches
    out.update({"decode_steps": DECODE_STEPS, "decode_batch": PREFILL_PROMPTS,
                "decode_step_ms_p50": percentile(step_ms, 50),
                "decode_step_ms_max": max(step_ms)})

    # the same prefill twice more, with its aux: bit-identical logits
    for rep in range(2):
        caches = model.init_caches(PREFILL_PROMPTS, PREFILL_MAX_LEN, dev)
        lg, _, aux = transformer.lm_forward(params, cfg, toks, caches=caches,
                                            ranks=rk, last_only=True)
        del caches
        for what, other in (("the cold prefill", cold),
                            ("the warm prefill", logits)):
            if not torch.equal(lg, other):
                raise AssertionError(
                    f"grid prefill run {rep + 3} differs from {what}: max "
                    f"|diff| {float((lg - other).abs().max())}")
    out.update({"repeats_bit_identical": 4,
                "moe_dropped": float(aux["moe_dropped"]),
                "moe_aux": float(aux["moe_aux"])})
    del cold, logits, lg

    # (2) held: layer 0 and the whole model against the dense dispatch
    cfg8 = dataclasses.replace(cfg, capacity_factor=CHECK_CF)
    # a capacity at which no dispatch can drop: an expert's capacity
    # n * k / E * cf is then at least the n tokens
    cfg_nd = dataclasses.replace(
        cfg, capacity_factor=float(-(-cfg.num_experts // cfg.top_k) + 1))
    x = torch.from_numpy(rng.standard_normal(
        (2, 512, cfg.d_model)).astype(np.float32)).to(dev).bfloat16()
    layer0 = params.blocks[0].moe
    model8 = build(cfg8)
    ys, aux_s = moe.moe_apply_sphere(layer0, x, cfg8, rk, ("data",))
    yd, _ = moe.moe_apply_dense(layer0, x, cfg8)
    layer_err = float((ys.float() - yd.float()).abs().max())
    if int(aux_s["moe_dropped"]) != 0 or layer_err > SPHERE_DENSE_TOL:
        raise AssertionError(f"layer 0 at capacity factor 8: dropped "
                             f"{int(aux_s['moe_dropped'])}, max |sphere - "
                             f"dense| {layer_err} (bound {SPHERE_DENSE_TOL})")
    del x, ys, yd
    toks2 = toks[:2, :512].contiguous()
    s2 = toks2.shape[1]
    # every token's expert choice in every layer, in both runs: the
    # sphere path ships routing probabilities in bfloat16, so a token near
    # a tie between its k-th and (k+1)-th expert may be routed otherwise in
    # a later layer, and its logits then rightly differ
    picks = {"grid": [], "dense": []}
    real_route = moe._route

    def route(p, x_flat, c):
        top_i, top_p, aux = real_route(p, x_flat, c)
        if top_i.dim() == 3:       # the grid: rank j holds (b, s_loc) of
            r, _, k = top_i.shape  # sequence block j
            ids = top_i.reshape(r, 2, -1, k).transpose(0, 1).reshape(-1, k)
        else:                      # dense: (b * s, k)
            ids = top_i
        picks[run].append(torch.sort(ids, dim=-1).values)
        return top_i, top_p, aux

    moe._route = route
    try:
        run = "grid"
        grid, _, aux_g = transformer.lm_forward(
            params, cfg8, toks2, caches=model8.init_caches(2, s2, dev),
            ranks=rk)
        run = "dense"
        dense, _, aux_d = transformer.lm_forward(
            params, cfg_nd, toks2, caches=model8.init_caches(2, s2, dev))
    finally:
        moe._route = real_route
    drops = [float(aux_g["moe_dropped"]), float(aux_d["moe_dropped"])]
    if drops != [0.0, 0.0]:
        raise AssertionError(f"the grid at capacity factor "
                             f"{cfg8.capacity_factor} and the dense dispatch "
                             f"at {cfg_nd.capacity_factor} dropped {drops}")
    # layers in which each token's experts differ between the runs, (2, s)
    rerouted = sum((g != d).any(dim=-1).to(torch.int32)
                   for g, d in zip(picks["grid"], picks["dense"])
                   ).reshape(2, s2)
    grid, dense = grid[..., :v], dense[..., :v]
    margins = top2_margin(torch, dense)
    same = grid.argmax(-1) == dense.argmax(-1)
    last = [(float(margins[i, -1]), int(rerouted[i, -1])) for i in range(2)]
    held = [i for i, (m, r) in enumerate(last)
            if m > SPHERE_DENSE_TOL and r == 0]
    if not all(bool(same[i, -1]) for i in held):
        raise AssertionError(f"24-layer grid prefill at capacity factor 8: "
                             f"next token differs from the dense prefill's "
                             f"at (margin, rerouted layers) {last}")
    # every position, as a record (not held): where the dense margin
    # exceeds the bound and the token took the same experts throughout
    clear = (margins > SPHERE_DENSE_TOL) & (rerouted == 0)
    out["held"] = {
        "layer0_sphere_vs_dense_max_abs": layer_err,
        "layer0_dropped": int(aux_s["moe_dropped"]),
        "model_dropped_grid_dense": drops,
        "dense_capacity_factor": cfg_nd.capacity_factor,
        "model_next_token_margin_rerouted": last,
        "model_next_tokens_held": len(held),
        "model_next_tokens_equal": [bool(same[i, -1]) for i in range(2)],
        "model_last_max_logit_diff":
            float((grid[:, -1] - dense[:, -1]).abs().max()),
        "all_positions": {
            "max_logit_diff": float((grid - dense).abs().max()),
            "token_layers_rerouted": int(rerouted.sum()),
            "token_layers": 2 * s2 * cfg.num_layers,
            "tokens_never_rerouted": int((rerouted == 0).sum()),
            "clear_positions": int(clear.sum()),
            "clear_positions_equal": int((same & clear).sum()),
            "positions_equal": int(same.sum()), "positions": 2 * s2}}
    del grid, dense, picks

    # (3) the engine: the launcher's traffic, published capacity factor
    draw = np.random.default_rng(0)
    prompts = [draw.integers(0, v, size=draw.integers(4, 12)).astype(
        np.int32) for _ in range(SERVE_REQUESTS)]
    _, _, out["serve"] = timed_serve(torch, model, params, prompts, v)
    # the same traffic at the no-drop capacity: the first two requests'
    # tokens against full forwards without caches over the same prefix
    cfg16 = cfg_nd
    reqs, rows, out["serve_no_drop"] = timed_serve(
        torch, build(cfg16), params, prompts, v)
    held = agree = steps = 0
    diff = 0.0
    for r in reqs[:2]:
        for i, tok in enumerate(r.out_tokens):
            prefix = list(map(int, r.prompt)) + r.out_tokens[:i]
            ref, _, _ = transformer.lm_forward(
                params, cfg16, torch.tensor([prefix], dtype=torch.int32,
                                            device=dev), last_only=True)
            ref = ref[0, -1, :v].float()
            steps += 1
            agree += int(int(ref.argmax()) == tok)
            diff = max(diff, float((ref - rows[r.req_id][i]).abs().max()))
            if float(top2_margin(torch, ref)) > DECODE_TOL:
                held += 1
                if int(ref.argmax()) != tok:
                    raise AssertionError(
                        f"request {r.req_id} token {i}: the engine gave "
                        f"{tok}, a full forward {int(ref.argmax())}")
    out["greedy_check"] = {"steps": steps, "held": held, "agree": agree,
                           "max_logit_diff": diff, "tolerance": DECODE_TOL}
    del params
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# -- phase 13: the rest of the model zoo ------------------------------------------


def zoo_inputs(torch, dev, gen, cfg, rng):
    """The prefill batch of phase 13 (see the module docstring): tokens
    from ``rng``, frames or image embeddings drawn on the card."""
    import numpy as np
    B = PREFILL_PROMPTS
    if cfg.family == "audio":
        text = WHISPER_PROMPT_LEN
    else:
        text = PREFILL_LEN - cfg.img_tokens
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (B, text)).astype(np.int32)).to(dev)}
    if cfg.family == "audio":
        batch["frames"] = torch.randn((B, cfg.enc_seq, cfg.d_model),
                                      generator=gen, device=dev).bfloat16()
    if cfg.family == "vlm":
        batch["img_embeds"] = torch.randn((B, cfg.img_tokens, cfg.d_model),
                                          generator=gen,
                                          device=dev).bfloat16()
    return batch


def zoo_reference(torch, params, cfg, batch, emitted, enc_out, n_rows):
    """Logits of a full forward without caches over each prompt and its
    emitted tokens, at the last ``n_rows`` positions (float32, the
    vocabulary only)."""
    from repro_torch.models import encdec, transformer
    from repro_torch.models.layers import lm_logits, rms_norm
    toks = torch.cat([batch["tokens"], emitted], dim=1)
    if cfg.family == "audio":
        logits, _ = encdec.decode_stack(params, cfg, toks, enc_out)
        return logits[:, -n_rows:, :cfg.vocab].float()
    x = transformer.embed_inputs(params, cfg, toks, batch.get("img_embeds"))
    B, S = x.shape[:2]
    q_pos = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    x, _, _ = transformer.forward(params, cfg, x, q_pos)
    x = rms_norm(x[:, -n_rows:], params.final_ln, cfg.norm_eps)
    return lm_logits(params.embed, x, cfg.logit_cap,
                     cfg.vocab)[..., :cfg.vocab].float()


def decode_spread(torch, model, params, cfg, batch, emitted, rows, enc_out,
                  max_len: int, n_pos: int) -> float:
    """The card's own rounding spread of the decode: each prompt prefilled
    and decoded alone (batch 1: other product shapes, so other rounding),
    fed the batch run's tokens; the largest logit difference from the
    batch run's ``rows``."""
    v = cfg.vocab
    dev = batch["tokens"].device
    spread = 0.0
    for i in range(batch["tokens"].shape[0]):
        caches = model.init_caches(1, max_len, dev)
        lg, caches = model.prefill(
            params, {k: x[i:i + 1] for k, x in batch.items()}, caches)
        alone = [lg[:, -1, :v].float()]
        for t in range(emitted.shape[1] - 1):
            step = {"tokens": emitted[i:i + 1, t:t + 1],
                    "pos": torch.full((1, 1), n_pos + t, dtype=torch.int32,
                                      device=dev)}
            if enc_out is not None:
                step["enc_out"] = enc_out[i:i + 1]
            lg, caches = model.decode_step(params, caches, step)
            alone.append(lg[:, -1, :v].float())
        del caches
        spread = max(spread, float((torch.stack(alone, 1)[0]
                                    - rows[i]).abs().max()))
    return spread


def zoo_model(torch, dev, arch: str, seed: int):
    """One model of phase 13: build and draw it, prefill, decode, the held
    checks, the engine; every kernel's launches read zero."""
    import dataclasses
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import build, encdec
    from repro_torch.models.layers import padded_vocab

    t_model = time.perf_counter()
    cfg = get_config(arch)
    if arch in ZOO_LAYERS:
        cfg = dataclasses.replace(cfg, num_layers=ZOO_LAYERS[arch])
    model = build(cfg)
    v = cfg.vocab
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    reset_launches()
    # the engines' timing wrappers hold their models in reference cycles:
    # collect the previous phase's model before measuring this one
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(gen, dev)
    torch.cuda.synchronize()
    out = {"phase": "serve_model_zoo", "arch": arch, "family": cfg.family,
           "attn_type": cfg.attn_type, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "vocab": v,
           "init_s": time.perf_counter() - t0,
           "params": sum(p.numel() for p in params.parameters()),
           "weight_bytes": sum(p.numel() * p.element_size()
                               for p in params.parameters())}
    rng = np.random.default_rng(seed)
    batch = zoo_inputs(torch, dev, gen, cfg, rng)
    text = batch["tokens"].shape[1]
    n_pos = text + (cfg.img_tokens if cfg.family == "vlm" else 0)
    max_len = n_pos + DECODE_STEPS

    def prefill():
        caches = model.init_caches(PREFILL_PROMPTS, max_len, dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, caches = model.prefill(params, batch, caches)
        torch.cuda.synchronize()
        return logits[:, -1:], caches, (time.perf_counter() - t) * 1e3

    # (1) prefill, cold and warm, then the decode
    torch.cuda.reset_peak_memory_stats()
    cold, caches, cold_ms = prefill()
    del caches
    logits, caches, warm_ms = prefill()
    if logits.shape != (PREFILL_PROMPTS, 1, padded_vocab(v)) \
            or not torch.isfinite(logits[..., :v]).all() \
            or not (logits[..., v:] == -1e30).all():
        raise AssertionError(f"{arch} prefill logits: shape "
                             f"{tuple(logits.shape)}, not finite, or padded "
                             f"columns not masked")
    out.update({"prompts": PREFILL_PROMPTS, "prompt_tokens": text,
                "positions": n_pos, "cache_len": max_len,
                "prefill_cold_ms": cold_ms, "prefill_warm_ms": warm_ms,
                "prefill_tokens_per_s":
                    PREFILL_PROMPTS * n_pos / warm_ms * 1e3,
                "prefill_peak_mem_bytes": torch.cuda.max_memory_allocated()})
    if cfg.family == "audio":
        out["frames"] = [PREFILL_PROMPTS, cfg.enc_seq]
    enc_out = (encdec.encode(params, cfg, batch["frames"])
               if cfg.family == "audio" else None)
    nxt = logits[:, -1, :v].argmax(-1).to(torch.int32)
    emitted, rows, step_ms = [nxt], [logits[:, -1, :v].float()], []
    for t in range(DECODE_STEPS):
        step = {"tokens": nxt[:, None],
                "pos": torch.full((PREFILL_PROMPTS, 1), n_pos + t,
                                  dtype=torch.int32, device=dev)}
        if enc_out is not None:
            step["enc_out"] = enc_out
        t0 = time.perf_counter()
        lg, caches = model.decode_step(params, caches, step)
        nxt = lg[:, -1, :v].argmax(-1).to(torch.int32)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if not torch.isfinite(lg[..., :v]).all():
            raise AssertionError(f"{arch} decode step {t}: logits not "
                                 f"finite")
        emitted.append(nxt)
        rows.append(lg[:, -1, :v].float())
    del caches
    out.update({"decode_steps": DECODE_STEPS,
                "decode_batch": PREFILL_PROMPTS,
                "decode_step_ms_p50": percentile(step_ms, 50),
                "decode_step_ms_max": max(step_ms),
                "decode_tokens_per_s": PREFILL_PROMPTS * DECODE_STEPS
                                       / sum(step_ms) * 1e3})

    # (2) held: the same prefill twice more, identical to the bit; the
    # decode against a full forward over the same prefixes
    for rep in range(2):
        lg, caches, _ = prefill()
        del caches
        for what, other in (("the cold prefill", cold),
                            ("the warm prefill", logits)):
            if not torch.equal(lg, other):
                raise AssertionError(
                    f"{arch} prefill run {rep + 3} differs from {what}: max "
                    f"|diff| {float((lg - other).abs().max())}")
    del cold, lg
    emitted = torch.stack(emitted, dim=1)              # (B, steps + 1)
    rows = torch.stack(rows, dim=1)                    # (B, steps + 1, v)
    ref = zoo_reference(torch, params, cfg, batch, emitted[:, :-1], enc_out,
                        DECODE_STEPS + 1)
    floor = decode_spread(torch, model, params, cfg, batch, emitted, rows,
                          enc_out, max_len, n_pos)
    tol = max(DECODE_TOL, 2 * floor)
    if not float((rows - ref).abs().max()) <= tol:
        raise AssertionError(f"{arch}: the decode's logits differ from a "
                             f"full forward's by "
                             f"{float((rows - ref).abs().max())} > {tol} "
                             f"(spread {floor})")
    margins = top2_margin(torch, ref)
    same = ref.argmax(-1) == emitted.long()
    clear = margins > tol
    diff = (rows - ref).abs().amax(-1)                 # (B, steps + 1)
    bad = (clear & ~same).nonzero().tolist()
    out["held"] = {"repeats_bit_identical": 4,
                   "prefill_vs_full_max_diff": float(diff[:, 0].max()),
                   "positions": int(same.numel()),
                   "held_positions": int(clear.sum()),
                   "equal_positions": int(same.sum()),
                   "max_logit_diff": float(diff.max()),
                   "logit_diff_by_step": diff.amax(0).tolist(),
                   "max_abs_logit": float(ref.abs().max()),
                   "decode_spread": floor,
                   "decode_tol": DECODE_TOL, "held_margin": tol,
                   # (prompt, step, margin, logit diff) where a held token
                   # differs
                   "failed": [(b, t, float(margins[b, t]),
                               float(diff[b, t])) for b, t in bad]}
    del rows, ref, enc_out, batch

    # (3) the engine: phase 12's traffic, frames as the launcher draws them
    draw = np.random.default_rng(0)
    prompts, frames = [], []
    for _ in range(SERVE_REQUESTS):
        prompts.append(draw.integers(0, v, size=draw.integers(4, 12)).astype(
            np.int32))
        if cfg.family == "audio":
            frames.append(draw.standard_normal(
                (cfg.enc_seq, cfg.d_model)).astype(np.float32))
    _, _, out["serve"] = timed_serve(torch, model, params, prompts, v,
                                     frames if frames else None)
    out["launches"] = read_launches()
    if any(out["launches"].values()):
        raise AssertionError(f"{arch}: launched {out['launches']}; no "
                             f"kernel lies on this path")
    del params
    out["phase_s"] = time.perf_counter() - t_model
    return out


def zoo_path(torch, dev, seed: int):
    """Phase 13 (see the module docstring): one JSON line a model; a
    model whose decode disagrees with its full forward fails the phase
    after every model has run."""
    runs = []
    for arch in ZOO_ARCHS:
        runs.append(zoo_model(torch, dev, arch, seed))
        log(json.dumps(runs[-1]))
    failed = {r["arch"]: (r["held"]["held_margin"], r["held"]["failed"])
              for r in runs if r["held"]["failed"]}
    if failed:
        raise AssertionError(f"the decode's token differs from a full "
                             f"forward's where its margin exceeds the held "
                             f"margin: (held margin, [(prompt, step, margin, "
                             f"logit diff)]) {failed}")
    return runs


# -- phase 14: training ------------------------------------------------------------


def state_tensors(model, params, opt) -> dict:
    """Every tensor of a train state by name: parameters, moments, step."""
    from repro_torch.models.convert import named_leaves
    out = {f"params.{n}": p for n, p in
           named_leaves(params, model.cfg).items()}
    for k in ("m", "v"):
        out.update({f"{k}.{n}": t for n, t in opt[k].items()})
    out["step"] = opt["step"]
    return out


def bit_digest(torch, tensors: dict) -> dict:
    """Two int64 sums of each tensor's 32-bit words (plain and position
    weighted): equal states give equal digests."""
    out = {}
    for name, t in tensors.items():
        w = t.detach().reshape(-1).view(torch.int32).to(torch.int64)
        idx = torch.arange(w.numel(), device=w.device) % 65521 + 1
        out[name] = (int(w.sum()), int((w * idx).sum()))
    return out


def state_diff(torch, a: dict, b: dict) -> dict:
    """Tensors that differ between two states, with their max |a - b|."""
    out = {}
    for name, t in a.items():
        if not torch.equal(t, b[name]):
            out[name] = float((t.float() - b[name].float()).abs().max())
    return out


def written_bytes() -> int:
    """Bytes this process has passed to ``write`` (``wchar`` of
    ``/proc/self/io``): what phase 14 adds to the machine's disk."""
    with open("/proc/self/io") as f:
        for line in f:
            if line.startswith("wchar:"):
                return int(line.split()[1])
    return 0


def sector_root(need: int, fallback_need=None):
    """A directory for phase 14's and 16's Sector slaves: on ``/dev/shm``
    (a RAM file system: a checkpoint's writes do not count against the
    machine's disk) when it holds ``need`` bytes, else when it holds
    ``fallback_need``, else on the temporary directory's disk. Returns
    (root, its free bytes, whether ``need`` fits)."""
    import shutil
    import tempfile
    wants = [need] + ([] if fallback_need is None else [fallback_need])
    for base in ("/dev/shm", None):
        if base is not None and not os.path.isdir(base):
            continue
        free = shutil.disk_usage(base or tempfile.gettempdir()).free
        if any(free >= want for want in wants) or base is None:
            return (tempfile.mkdtemp(prefix="chip_smoke_train_", dir=base),
                    free, free >= need)
    raise AssertionError("unreachable")


def host_memory() -> dict:
    info = {}
    with open("/proc/meminfo") as f:
        for line in f:
            k, v = line.split(":")
            if k in ("MemTotal", "MemAvailable"):
                info[k] = int(v.split()[0]) * 1024
    return info


class CkptClock:
    """Times the checkpointer's saves (the synchronous host copy), uploads
    (the thread's part, async or not) and waits (the loop blocked on a
    pending upload), by wrapping the class's methods for one run."""

    def __init__(self):
        from repro_torch.train.checkpoint import SectorCheckpointer as C
        self.cls = C
        self.orig = {k: getattr(C, k) for k in ("save", "_upload", "wait")}
        self.events = []

        def timed(name):
            fn = self.orig[name]

            def run(ck, *a, **kw):
                t0 = time.perf_counter()
                try:
                    return fn(ck, *a, **kw)
                finally:
                    self.events.append((name, a[0] if a and name != "wait"
                                        else None, t0, time.perf_counter()))
            return run
        for k in self.orig:
            setattr(C, k, timed(k))

    def close(self) -> None:
        for k, fn in self.orig.items():
            setattr(self.cls, k, fn)

    def report(self) -> dict:
        """Seconds of each save (its host copy; a blocking save's upload
        too) and upload, the loop's waits, and the async upload's
        seconds beside the train steps (until the loop's wait) and
        after them (blocked in that wait)."""
        ev = {n: [(s, t0, t1) for m, s, t0, t1 in self.events if m == n]
              for n in ("save", "_upload", "wait")}
        out = {"save_s": {str(s): t1 - t0 for s, t0, t1 in ev["save"]},
               "upload_s": {str(s): t1 - t0 for s, t0, t1 in ev["_upload"]},
               "wait_s": sum(t1 - t0 for _, t0, t1 in ev["wait"])}
        if len(ev["_upload"]) > 1:
            _, u0, u1 = ev["_upload"][0]
            w0 = min(t0 for _, t0, _ in ev["wait"] if t0 > u0)
            out.update({"async_upload_s": u1 - u0,
                        "async_overlap_s": min(u1, w0) - u0,
                        "async_blocked_s": max(0.0, u1 - w0)})
        return out


def train_tinyllama(torch, dev, seed: int) -> dict:
    """Phase 14 (1): the launcher's main path at TinyLlama's published
    width (see the module docstring)."""
    import copy
    import dataclasses
    import math
    import shutil
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch_train
    from repro_torch.models.transformer import DecoderLM
    from repro_torch.train.trainer import (init_train_state,
                                           load_state_tree, state_tree)

    cfg = dataclasses.replace(get_config(TRAIN_ARCH),
                              num_layers=TRAIN_LAUNCH_LAYERS)
    n_params = sum(p.numel() for p in DecoderLM(
        cfg, torch.device("meta")).parameters())
    # a saved state is 12 bytes a parameter (float32 params, m, v),
    # stored twice (replication 2), mid-run and at the end
    state = 12 * n_params
    root, free, full = sector_root(4 * state + (4 << 30),
                                   2 * state + (4 << 30))
    mem = host_memory()
    written0 = written_bytes()
    out = {"phase": "train_tinyllama", "arch": cfg.arch_id,
           "cut": grid_cut(cfg),
           "layers": cfg.num_layers, "d_model": cfg.d_model,
           "vocab": cfg.vocab, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "steps": TRAIN_LAUNCH_STEPS, "lr": TRAIN_LR,
           "sector_root": root, "sector_root_free_bytes": free,
           "sector_fs": filesystem_of(root),
           "host_mem": mem}
    ckpt_every = TRAIN_CKPT_EVERY
    clock = CkptClock()
    try:
        # the host holds one saved state at a time, and a quarter more
        # on restore
        if free < 2 * state + (4 << 30) \
                or mem["MemAvailable"] < 1.5 * state + (8 << 30):
            raise RuntimeError(f"{root} has {free} bytes free and the host "
                               f"{mem['MemAvailable']} available; one "
                               f"checkpoint of {state} bytes does not fit")
        if not full:
            ckpt_every = TRAIN_LAUNCH_STEPS + 1
            out["save_cut"] = (f"no mid-run save: {free} bytes free under "
                          f"{root}")
        reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run = launch_train.train(
            cfg, steps=TRAIN_LAUNCH_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
            lr=TRAIN_LR, ckpt_every=ckpt_every, workdir=root, device=dev,
            log=log)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = read_launches()
        ck_times = clock.report()
        clock.close()
        model, params, opt = run["model"], run["params"], run["opt"]
        losses, metrics = run["losses"], run["metrics"]
        ckpt, client = run["ckpt"], run["client"]
        manifest = json.loads(client.download(
            f"/ckpt/run0/step_{TRAIN_LAUNCH_STEPS:08d}/MANIFEST.json"))
        state_bytes = manifest["total_bytes"]
        if any(v for v in launches.values()):
            raise AssertionError(f"the dense model's training launched "
                                 f"{launches}; its path runs no kernel")
        if not all(math.isfinite(x) for x in losses) or not all(
                math.isfinite(m["grad_norm"]) for m in metrics):
            raise AssertionError(f"losses {losses} or grad norms "
                                 f"{[m['grad_norm'] for m in metrics]} "
                                 f"not finite")
        if abs(losses[0] - math.log(cfg.vocab)) > 1.0:
            raise AssertionError(f"first loss {losses[0]} is not within "
                                 f"1.0 of ln({cfg.vocab})")
        want_steps = sorted({TRAIN_LAUNCH_STEPS} | (
            {ckpt_every} if ckpt_every <= TRAIN_LAUNCH_STEPS else set()))
        if ckpt.list_steps() != want_steps:
            raise AssertionError(f"checkpoints {ckpt.list_steps()} != "
                                 f"{want_steps}")
        step_ms = [s * 1e3 for s in run["step_s"]]
        out.update({
            "params": n_params, "launches": launches, "run_s": run_s,
            "losses": losses, "grad_norms": [m["grad_norm"]
                                             for m in metrics],
            "step_ms": step_ms, "step_ms_p50": percentile(step_ms, 50),
            "step_ms_p99": percentile(step_ms, 99),
            "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ
            / percentile(step_ms, 50) * 1e3,
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "ckpt_bytes": state_bytes, "ckpt_steps": ckpt.list_steps(),
            "ckpt_every": ckpt_every, **ck_times,
            "sector_used_bytes": sum(s.used_bytes() for s in
                                     run["master"].slaves.values()),
            "process_written_bytes": written_bytes() - written0})

        # one more batch; the state in memory before the extra step
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in next(iter(run["pipe"])).items()}
        step_fn = run["step_fn"]
        pre = bit_digest(torch, state_tensors(model, params, opt))
        # (a) the same step twice from one state
        twin = copy.deepcopy(params)
        twin_opt = {k: ({n: t.clone() for n, t in v.items()}
                        if isinstance(v, dict) else v.clone())
                    for k, v in opt.items()}
        torch.cuda.reset_peak_memory_stats()
        step_fn(twin, twin_opt, batch)
        step_fn(params, opt, batch)
        after = state_tensors(model, params, opt)
        repeat = state_diff(torch, after,
                            state_tensors(model, twin, twin_opt))
        del twin, twin_opt
        gc.collect()
        torch.cuda.empty_cache()
        # (b) the final checkpoint restored into a fresh state, every
        # slice's MD5 verified, then the same step from it
        fresh, fresh_opt = init_train_state(
            model, torch.Generator(device=dev).manual_seed(seed + 1), dev)
        # the index's MD5 of each slice is the manifest's; the restore
        # checks every slice's bytes against the manifest's MD5
        md5_ok = [client.stat(sm["path"]).md5 == sm["md5"]
                  for sm in manifest["slices"]]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tree, step = ckpt.restore(state_tree(model, fresh, fresh_opt),
                                  device=dev)
        load_state_tree(model, fresh, fresh_opt, tree)
        del tree
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        restored_equal = bit_digest(
            torch, state_tensors(model, fresh, fresh_opt)) == pre
        step_fn(fresh, fresh_opt, batch)
        resumed = state_diff(torch, after,
                             state_tensors(model, fresh, fresh_opt))
        out.update({"restore_s": restore_s, "restored_step": step,
                    "slices_md5_ok": md5_ok,
                    "restored_equal_bitwise": restored_equal,
                    "repeat_differs": repeat, "resume_differs": resumed,
                    "extra_steps_peak_mem_bytes":
                        torch.cuda.max_memory_allocated()})
        if not all(md5_ok) or step != TRAIN_LAUNCH_STEPS or not restored_equal:
            raise AssertionError(f"restore: md5s {md5_ok}, step {step}, "
                                 f"equal to the saved state "
                                 f"{restored_equal}")
        if repeat:
            raise AssertionError(f"the same step twice from one state "
                                 f"differs: {repeat}")
        if resumed:
            raise AssertionError(f"the step from the restored state "
                                 f"differs from the step in memory: "
                                 f"{resumed}")
        del fresh, fresh_opt, run, params, opt, batch
    finally:
        clock.close()
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    return out


def moe_train_setup(torch, seed: int):
    """Phase 14's MoE cell, shared with phase 17: Qwen1.5-MoE-A2.7B at its
    published width cut to ``MOE_TRAIN_LAYERS`` layers, its batch (CPU
    tensors) and its optimizer. The batch is phase 12's prompts: uniform
    tokens spread the random router's choices over every expert (the
    corpus's Zipf tokens repeat, and leave some experts without a
    token)."""
    import dataclasses
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.train.optimizer import AdamWConfig
    cfg = dataclasses.replace(get_config(SERVE_ARCH),
                              num_layers=MOE_TRAIN_LAYERS)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (PREFILL_PROMPTS, PREFILL_LEN + 1))
    toks = torch.from_numpy(toks.astype(np.int32))
    batch = {"tokens": toks[:, :-1].contiguous(),
             "labels": toks[:, 1:].contiguous()}
    opt_cfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=20,
                          total_steps=MOE_TRAIN_STEPS)
    return cfg, batch, opt_cfg


def train_moe_grid(torch, dev, seed: int) -> dict:
    """Phase 14 (2): Qwen1.5-MoE-A2.7B at its published width, 2 layers,
    on ``(1, 8)``: K1 in every MoE layer, the routed experts' missing
    gradients and decay-only updates; then one step of the dense
    dispatch."""
    import math
    from repro_torch.comm import Ranks
    from repro_torch.models import build
    from repro_torch.models.convert import named_leaves
    from repro_torch.train.optimizer import adamw_update
    from repro_torch.train.trainer import (build_train_step,
                                           init_train_state, loss_and_grads)

    cfg, batch, opt_cfg = moe_train_setup(torch, seed)
    model = build(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params, opt = init_train_state(model, gen, dev)
    leaves = named_leaves(params, cfg)
    routed = [n for n in leaves if n.split(".")[-1] in
              ("w_gate", "w_up", "w_down")]
    batch = {k: v.to(dev) for k, v in batch.items()}
    rk = Ranks(shape=SERVE_GRID, axes=("data", "model"), device=dev)
    step_fn = build_train_step(model, opt_cfg, rk)
    out = {"phase": "train_qwen2_moe_grid", "arch": cfg.arch_id,
           "layers": cfg.num_layers, "cut": "layers 24 -> 2",
           "d_model": cfg.d_model, "experts": cfg.num_experts,
           "top_k": cfg.top_k, "vocab": cfg.vocab,
           "capacity_factor": cfg.capacity_factor,
           "grid": list(SERVE_GRID), "batch": PREFILL_PROMPTS,
           "seq": PREFILL_LEN,
           "params": sum(p.numel() for p in params.parameters())}
    tokens = PREFILL_PROMPTS * PREFILL_LEN
    step_ms, launches, dropped, losses, decay_only = [], [], [], [], []
    want_k1 = 4 * cfg.num_layers
    for i in range(MOE_TRAIN_STEPS):
        before = {n: leaves[n].detach().clone() for n in routed}
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        if i == 0:
            # the train step's two halves, to read the gradients
            loss, metrics, grads = loss_and_grads(model, params, batch, rk)
            with_grad = [n for n in routed if grads[n] is not None
                         and bool(grads[n].any())]
            without = [n for n in leaves if n not in routed
                       and (grads[n] is None or not bool(grads[n].any()))]
            _, _, om = adamw_update(opt_cfg, leaves, grads, opt)
            metrics = dict(metrics, **om, loss=loss)
            del grads
        else:
            _, _, metrics = step_fn(params, opt, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        launches.append(read_launches())
        dropped.append(float(metrics["moe_dropped"]))
        losses.append(float(metrics["loss"]))
        # a zero gradient leaves m and v at zero, so AdamW's step is
        # w - lr * (0 / (sqrt(0) + eps) + wd * w): the decay alone,
        # w * (1 - lr * wd) in the optimizer's own rounding
        lr, wd = metrics["lr"], opt_cfg.weight_decay
        with torch.no_grad():
            decay_only.append(all(torch.equal(
                leaves[n], before[n] - lr * (wd * before[n]))
                for n in routed))
            factor_err = max(float((leaves[n] - before[n] * (1 - lr * wd))
                                   .abs().max()) for n in routed)
        del before
    if with_grad or without:
        raise AssertionError(f"routed experts with a gradient: {with_grad}; "
                             f"other leaves without one: {without}")
    if not all(decay_only):
        raise AssertionError(f"the routed experts' update is not the "
                             f"decay alone: {decay_only}")
    for run in launches:
        if run != {"partition": want_k1, "bitonic_sort": 0,
                   "radix_sort": 0, "bucket_hist": 0}:
            raise AssertionError(f"a grid train step launched {run}; K1 "
                                 f"runs 4 times a MoE layer with remat "
                                 f"({want_k1})")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"losses {losses}")
    grid_peak = torch.cuda.max_memory_allocated()

    # one step of the dense dispatch: every real expert gets a gradient
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    loss, metrics, grads = loss_and_grads(model, params, batch)
    torch.cuda.synchronize()
    dense_ms = (time.perf_counter() - t0) * 1e3
    dense_launches = read_launches()
    no_grad = [n for n in routed if grads[n] is None or not bool(
        (grads[n][:cfg.num_experts].flatten(1).abs().amax(1) > 0).all())]
    del grads
    if no_grad or any(dense_launches.values()):
        raise AssertionError(f"dense dispatch: experts without a gradient "
                             f"in {no_grad}; launches {dense_launches}")
    out.update({"step_ms": step_ms, "step_ms_p50": percentile(step_ms, 50),
                "tokens_per_s": tokens / percentile(step_ms, 50) * 1e3,
                "losses": losses, "moe_dropped": dropped,
                "routed_choices": tokens * cfg.top_k * cfg.num_layers,
                "launches": launches, "k1_launches":
                    sum(r["partition"] for r in launches),
                "decay_only_bitwise": decay_only,
                "decay_vs_factor_max_abs": factor_err,
                "peak_mem_bytes": grid_peak,
                "dense_loss_and_grads_ms": dense_ms,
                "dense_loss": float(loss),
                "dense_moe_dropped": float(metrics["moe_dropped"]),
                "dense_peak_mem_bytes": torch.cuda.max_memory_allocated()})
    del params, opt, leaves, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_profile(torch, dev, seed: int, out_dir: str) -> list:
    """``--profile``: one train step of each phase-14 cell (random batch,
    after two warm steps) split by CUDA events into the forward
    (``train_loss``), the backward (``torch.autograd.grad``, the remat
    recompute in it) and the AdamW update, then a warm and a profiled
    step (:func:`profile_run`)."""
    import dataclasses
    import numpy as np
    from repro_torch.comm import Ranks
    from repro_torch.configs import get_config
    from repro_torch.models import build
    from repro_torch.models.convert import named_leaves
    from repro_torch.train.optimizer import AdamWConfig, adamw_update
    from repro_torch.train.trainer import init_train_state

    rows = []
    for cell in ("train-tinyllama-1.1b", "train-qwen2-moe-grid-1x8"):
        if cell.startswith("train-tinyllama"):
            cfg = dataclasses.replace(get_config(TRAIN_ARCH),
                                      num_layers=TRAIN_LAUNCH_LAYERS)
            ranks = None
            shape = (TRAIN_BATCH, TRAIN_SEQ)
        else:
            cfg = dataclasses.replace(get_config(SERVE_ARCH),
                                      num_layers=MOE_TRAIN_LAYERS)
            ranks = Ranks(shape=SERVE_GRID, axes=("data", "model"),
                          device=dev)
            shape = (PREFILL_PROMPTS, PREFILL_LEN)
        model = build(cfg)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        params, opt = init_train_state(model, gen, dev)
        leaves = named_leaves(params, cfg)
        toks = torch.from_numpy(np.random.default_rng(seed).integers(
            0, cfg.vocab, (shape[0], shape[1] + 1)).astype(np.int32)).to(dev)
        batch = {"tokens": toks[:, :-1].contiguous(),
                 "labels": toks[:, 1:].contiguous()}
        opt_cfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=20, total_steps=100)

        def step():
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            loss, _ = model.train_loss(params, batch, ranks)
            ev[1].record()
            grads = torch.autograd.grad(loss, list(leaves.values()),
                                        allow_unused=True)
            ev[2].record()
            adamw_update(opt_cfg, leaves, dict(zip(leaves, grads)), opt)
            ev[3].record()
            ev[3].synchronize()
            return [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]

        for _ in range(2):
            step()
        split = step()
        torch.cuda.reset_peak_memory_stats()
        prof = profile_run(torch, step, out_dir, cell)
        rows.append({"phase": "train_profile", "cell": cell,
                     "forward_ms": split[0], "backward_ms": split[1],
                     "adamw_ms": split[2],
                     "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                     **prof})
        log(json.dumps(rows[-1]))
        del params, opt, leaves, step
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def train_path(torch, dev, seed: int, profile_dir=None) -> dict:
    """Phase 14 (see the module docstring)."""
    t0 = time.perf_counter()
    written = written_bytes()
    dense = train_tinyllama(torch, dev, seed)
    log(json.dumps(dense))
    moe = train_moe_grid(torch, dev, seed)
    log(json.dumps(moe))
    out = {"phase": "train_total", "phase_s": time.perf_counter() - t0,
           "written_before_bytes": written,
           "written_bytes": written_bytes() - written,
           "tinyllama": dense, "moe": moe}
    if profile_dir:
        out["profile"] = train_profile(torch, dev, seed, profile_dir)
    return out


# -- phase 15: the paths as 8 processes, one rank each, through gloo ------------


def ranks_dir() -> str:
    """Phase 15's directory of ``.npy`` inputs and outputs: on
    ``/dev/shm`` (a RAM file system) when there is one."""
    import tempfile
    base = "/dev/shm" if os.path.isdir("/dev/shm") else None
    return tempfile.mkdtemp(prefix="chip_smoke_ranks_", dir=base)


def save_npy(directory: str, name: str, t) -> None:
    """``t`` (a tensor or numpy array) as ``directory/name.npy``, once."""
    import numpy as np
    a = t.cpu().numpy() if hasattr(t, "cpu") else np.asarray(t)
    np.save(os.path.join(directory, name + ".npy"), a)


def load_tensor(torch, directory: str, name: str, dev):
    """``directory/name.npy`` on ``dev``."""
    import numpy as np
    return torch.from_numpy(np.array(load_npy(directory, name))).to(dev)


def load_npy(directory: str, name: str):
    """A read-only memmap of ``directory/name.npy`` (``np.array`` it for a
    writable copy)."""
    import numpy as np
    return np.load(os.path.join(directory, name + ".npy"), mmap_mode="r")


def comm_summary(log) -> dict:
    """A rank's collective log (``ProcessRanks.log``) by op: calls, host
    seconds and bytes, and each call as a hop."""
    out = {}
    for e in log:
        s = out.setdefault(e["op"], {"calls": 0, "seconds": 0.0, "bytes": 0,
                                     "hops": []})
        s["calls"] += 1
        s["seconds"] += e["seconds"]
        s["bytes"] += e["bytes"]
        s["hops"].append({"axes": e["axes"], "bytes": e["bytes"],
                          "seconds": e["seconds"]})
    return out


def timed_rank_run(torch, ranks, run):
    """``run()`` once from a barrier to this rank's synchronised end, its
    kernel launches and collectives counted from zero and its collectives
    logged; then once more, the warm wall, with no log. Returns (result of
    the first run, stats)."""
    import torch.distributed as dist
    ranks.collectives.clear()
    reset_launches()
    ranks.log = []
    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run()
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    stats = {"cold_ms": cold * 1e3, "launches": read_launches(),
             "collectives": dict(ranks.collectives),
             "comm": comm_summary(ranks.log)}
    ranks.log = None
    return res, stats


def warm_rank_ms(torch, run) -> float:
    import torch.distributed as dist
    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run()
    torch.cuda.synchronize()
    del res
    return (time.perf_counter() - t0) * 1e3


def rank_sort(torch, ranks, keys, value, directory: str, tag: str) -> dict:
    """Phase 5's (or, on the ``(dc, node)`` grid, phase 6's) sort in one
    process: its valid rows written to ``directory`` for the parent."""
    from repro_torch.sphere.dataflow import Dataflow, SPMDExecutor
    df = Dataflow.source().sort(key=lambda r: r["key"], num_buckets=WORLD,
                                capacity_factor=2.0)
    ex = SPMDExecutor(ranks, sort_algo="bitonic")
    recs = {"key": ranks.stack(keys), "value": ranks.stack(value)}
    res, stats = timed_rank_run(torch, ranks, lambda: ex.run(df, recs))
    valid = res.valid[0]
    save_npy(directory, f"{tag}_key_{ranks.rank}", res.records["key"][0][valid])
    save_npy(directory, f"{tag}_value_{ranks.rank}",
             res.records["value"][0][valid])
    stats["dropped"] = int(res.dropped)
    del res, valid
    stats["warm_ms"] = warm_rank_ms(torch, lambda: ex.run(df, recs))
    return stats


def rank_wordcount(torch, ranks, words) -> dict:
    """Phase 7's wordcount in one process; its (word, count) rows."""
    from repro_torch.core.mapreduce import default_hash
    from repro_torch.sphere.dataflow import Dataflow, SPMDExecutor
    df = (Dataflow.source().map(wordcount_emit)
          .shuffle(by=lambda r: default_hash(r["key"], WORLD),
                   num_buckets=WORLD)
          .reduce(wordcount_count))
    ex = SPMDExecutor(ranks)
    recs = {"word": ranks.stack(words.reshape(WORLD, -1))}
    res, stats = timed_rank_run(torch, ranks, lambda: ex.run(df, recs))
    valid = res.valid[0]
    stats["keys"] = res.records["key"][0][valid].cpu().numpy()
    stats["counts"] = res.records["value"][0][valid].cpu().numpy()
    stats["dropped"] = int(res.dropped)
    del res, valid
    stats["warm_ms"] = warm_rank_ms(torch, lambda: ex.run(df, recs))
    return stats


def moe_layer_inputs(torch, dev, seed: int):
    """One MoE layer of phase 12's model at its published config: its
    weights drawn from ``seed`` on ``dev``, and 8 x 1024 tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = get_config(SERVE_ARCH)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    layer = moe.MoE(cfg, device=dev)
    layer.init_weights(gen)
    x = torch.randn((PREFILL_PROMPTS, PREFILL_LEN, cfg.d_model),
                    generator=gen, device=dev).to(torch.bfloat16)
    return cfg, layer, x


def rank_moe(torch, ranks, seed: int) -> dict:
    """One Qwen1.5-MoE-A2.7B layer on ``(1, 8)`` in one process: the
    process keeps its 8 experts, cut by their spec, and returns its block
    of the output, its routing and per-expert counts."""
    from repro_torch.models import moe
    cfg, layer, x = moe_layer_inputs(torch, ranks.device, seed)
    full = dict(layer.named_parameters())
    params = moe.local_params(full, layer.specs, ranks)
    params = {k: v.clone() for k, v in params.items()}  # own the shard only
    del layer, full
    torch.cuda.empty_cache()

    def run():
        with torch.no_grad():
            return moe.moe_apply_sphere(params, x, cfg, ranks, ("data",))
    (out, metrics), stats = timed_rank_run(torch, ranks, run)
    block = moe.token_block(x, *ranks.shape, ranks.rank)
    with torch.no_grad():
        top_i, _, _ = moe._route(params, block.reshape(-1, cfg.d_model), cfg)
    stats.update({
        "out": out.cpu(), "aux": float(metrics["moe_aux"]),
        "dropped": int(metrics["moe_dropped"]), "top_i": top_i.cpu(),
        "experts_held": int(params["w_gate"].shape[0]),
        "expert_bytes": sum(params[k].numel() * params[k].element_size()
                            for k in ("w_gate", "w_up", "w_down"))})
    del out
    stats["warm_ms"] = warm_rank_ms(torch, run)
    return stats


def rank_paths(ranks, directory: str, seed: int) -> dict:
    """Phase 15 in one of the 8 processes (``ranks``: its ``(8,)`` grid;
    the ``(dc, node)`` and ``(data, model)`` grids are built over the same
    process group). Starts once the parent's stacked runs are done."""
    import torch
    from repro_torch.comm import ProcessRanks
    dev = ranks.device
    out = {"rank": ranks.rank, "device": str(dev)}
    keys, value = load_npy(directory, "keys"), load_npy(directory, "value")
    wait_file(os.path.join(directory, "go"),
              os.path.join(directory, "abort"))
    torch.cuda.reset_peak_memory_stats(dev)
    out["flat"] = rank_sort(torch, ranks, keys, value, directory, "flat")
    grid = ProcessRanks(GRID, ("dc", "node"), device=dev)
    out["grid"] = rank_sort(torch, grid, keys, value, directory, "grid")
    torch.cuda.empty_cache()
    out["wordcount"] = rank_wordcount(torch, ranks,
                                      load_npy(directory, "words"))
    torch.cuda.empty_cache()
    moe_grid = ProcessRanks(SERVE_GRID, ("data", "model"), device=dev)
    out["moe"] = rank_moe(torch, moe_grid, seed)
    out["peak_mem_bytes"] = torch.cuda.max_memory_allocated(dev)
    return out


def stacked_warm(torch, ex, df, records):
    """Cold run (launches and collectives from zero), then the warm wall,
    on stacked ranks."""
    ex.ranks.collectives.clear()
    res, run = run_path(torch, ex, df, records)
    run["collectives"] = dict(ex.ranks.collectives)
    del res
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = ex.run(df, records)
    torch.cuda.synchronize()
    run["warm_wall_ms"] = (time.perf_counter() - t0) * 1e3
    del res
    return run


def stacked_references(torch, dev, directory: str, seed: int) -> dict:
    """The stacked backend's runs of phase 15's four paths on the same
    inputs, read back from ``directory``: cold counts and warm walls, and
    the MoE layer's output, routing, aux and drops."""
    from repro_torch.comm import Ranks
    from repro_torch.core.mapreduce import default_hash
    from repro_torch.models import moe
    from repro_torch.sphere.dataflow import Dataflow, SPMDExecutor
    out = {}
    keys = load_tensor(torch, directory, "keys", dev)
    value = load_tensor(torch, directory, "value", dev)
    df = Dataflow.source().sort(key=lambda r: r["key"], num_buckets=WORLD,
                                capacity_factor=2.0)
    for tag, ranks in (("flat", Ranks(WORLD)),
                       ("grid", Ranks(shape=GRID, axes=("dc", "node")))):
        out[tag] = stacked_warm(torch, SPMDExecutor(ranks,
                                                    sort_algo="bitonic"),
                                df, {"key": keys, "value": value})
        torch.cuda.empty_cache()
    del keys, value
    words = load_tensor(torch, directory, "words", dev).reshape(WORLD, -1)
    wc = (Dataflow.source().map(wordcount_emit)
          .shuffle(by=lambda r: default_hash(r["key"], WORLD),
                   num_buckets=WORLD)
          .reduce(wordcount_count))
    out["wordcount"] = stacked_warm(torch, SPMDExecutor(Ranks(WORLD)), wc,
                                    {"word": words})
    del words
    torch.cuda.empty_cache()
    cfg, layer, x = moe_layer_inputs(torch, dev, seed)
    params = dict(layer.named_parameters())
    grid = Ranks(shape=SERVE_GRID, axes=("data", "model"))

    def run():
        with torch.no_grad():
            return moe.moe_apply_sphere(params, x, cfg, grid, ("data",))
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    o, m = run()
    torch.cuda.synchronize()
    cold = (time.perf_counter() - t0) * 1e3
    launches = read_launches()
    collectives = dict(grid.collectives)
    with torch.no_grad():
        top_i, _, _ = moe._route(params, x.reshape(-1, cfg.d_model), cfg)
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    out["moe"] = {"wall_ms": cold, "warm_wall_ms":
                  (time.perf_counter() - t0) * 1e3, "launches": launches,
                  "collectives": collectives, "out": o.cpu(),
                  "aux": float(m["moe_aux"]), "dropped": int(m["moe_dropped"]),
                  "top_i": top_i.cpu(), "e_pad": params["w_gate"].shape[0],
                  "capacity_factor": cfg.capacity_factor}
    del layer, params, x, o
    torch.cuda.empty_cache()
    return out


def check_rank_sort(torch, dev, directory: str, tag: str, want_keys,
                    what: str) -> None:
    """The processes' valid rows, in rank order: the keys of phase 5 in
    order, and every input record once, its value beside its key."""
    import types
    import numpy as np
    k = torch.from_numpy(np.concatenate(
        [load_npy(directory, f"{tag}_key_{r}") for r in range(WORLD)])).to(dev)
    v = torch.from_numpy(np.concatenate(
        [load_npy(directory, f"{tag}_value_{r}") for r in range(WORLD)])).to(dev)
    if not torch.equal(k, want_keys):
        raise AssertionError(f"{what}: sorted keys differ from phase 5's")
    keys = load_tensor(torch, directory, "keys", dev)
    value = load_tensor(torch, directory, "value", dev)
    res = types.SimpleNamespace(
        records={"key": k[None], "value": v[None]},
        valid=torch.ones((1, k.numel()), dtype=torch.bool, device=dev),
        dropped=torch.zeros((), dtype=torch.int32))
    check_sorted_permutation(torch, res, keys, value, what)


def per_rank_equal(results, path: str, field: str, want, what: str):
    got = [r[path][field] for r in results]
    if any(g != want for g in got):
        raise AssertionError(f"{what}: {field} per process {got}, stacked "
                             f"{want}")


def nccl_world_one(torch) -> dict:
    """The collectives over a one-rank NCCL group in this process, against
    ``Ranks(1)`` on the card: the NCCL code path, launched once."""
    import datetime
    import torch.distributed as dist
    from repro_torch.comm import ProcessRanks, Ranks, free_port
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=120))
    try:
        pr = ProcessRanks((1,), ("data",), backend="nccl")
        st = Ranks(1)
        x = torch.arange(12, dtype=torch.float32, device="cuda").reshape(
            1, 1, 12)
        for name, fn in (("all_to_all", lambda r: r.all_to_all(x)),
                         ("psum", lambda r: r.psum(x)),
                         ("all_gather", lambda r: r.all_gather(x)),
                         ("axis_index", lambda r: r.axis_index())):
            if not torch.equal(fn(pr), fn(st)):
                raise AssertionError(f"nccl {name} differs from Ranks(1)")
        if dict(pr.collectives) != dict(st.collectives):
            raise AssertionError("nccl collective counts differ")
        return {"backend": pr.backend, "device": str(pr.device),
                "collectives": dict(pr.collectives)}
    finally:
        dist.destroy_process_group()


class SpawnBeside:
    """``spawn_ranks(*args, **kwargs)`` on a thread, so that this process
    works on the card while the processes start; they wait for files this
    process writes into ``ready_dir`` (:func:`wait_file`), and an
    ``abort`` file there stops them."""

    def __init__(self, ready_dir: str, *args, **kwargs):
        import threading
        from repro_torch.comm import spawn_ranks
        self.abort = os.path.join(ready_dir, "abort")
        self.box = {}

        def run():
            t0 = time.perf_counter()
            try:
                self.box["out"] = spawn_ranks(*args, **kwargs)
            except BaseException as e:      # re-raised by join()
                self.box["error"] = e
            self.box["seconds"] = time.perf_counter() - t0

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()

    def alive(self) -> bool:
        return self.thread.is_alive()

    def join(self):
        """(each rank's result, the spawn's seconds), or its error."""
        self.thread.join()
        if "error" in self.box:
            raise self.box["error"]
        return self.box["out"], self.box["seconds"]

    def stop(self, error: BaseException):
        """After ``error`` in this process: stop the processes, and raise
        the spawn's own error if that is what ended the wait, else
        ``error``."""
        spawn_failed = not self.alive() and "error" in self.box
        open(self.abort, "w").close()
        self.thread.join()
        raise (self.box["error"] if spawn_failed else error)


def ranks_path(torch, dev, directory: str, seed: int, flat_sorted) -> dict:
    """Phase 15 (see the module docstring): the 8 processes start while
    the stacked runs go, then run once those are done; then the
    checks."""
    import numpy as np
    from repro_torch.models.registry import meta_params

    t_phase = time.perf_counter()
    spawn = SpawnBeside(directory, rank_paths, (WORLD,), ("data",),
                        backend="gloo", timeout_s=RANKS_TIMEOUT_S,
                        args=(directory, seed))
    try:
        ref = stacked_references(torch, dev, directory, seed)
        torch.cuda.empty_cache()
        put_file(os.path.join(directory, "go"), True)
        results, spawn_s = spawn.join()
    except BaseException as e:
        spawn.stop(e)
    out = {"phase": "ranks", "processes": WORLD, "backend": "gloo",
           "transport": "gloo over CUDA tensors, staged through host "
                        "memory inside gloo (8 processes share one card; "
                        "NCCL takes one card a rank)",
           "device": nvidia_smi_line(), "spawn_s": spawn_s,
           "peak_mem_bytes_by_process":
               [r["peak_mem_bytes"] for r in results], "paths": {}}
    for tag, what in (("flat", "flat sort, 8 processes"),
                      ("grid", "(dc, node) sort, 8 processes")):
        check_rank_sort(torch, dev, directory, tag, flat_sorted, what)
        for field in ("launches", "collectives"):
            per_rank_equal(results, tag, field, ref[tag][field], what)
        if any(r[tag]["dropped"] for r in results):
            raise AssertionError(f"{what} dropped records")
    torch.cuda.empty_cache()
    words = load_npy(directory, "words")
    check_word_counts(np.asarray(words),
                      np.concatenate([r["wordcount"]["keys"]
                                      for r in results]),
                      np.concatenate([r["wordcount"]["counts"]
                                      for r in results]),
                      "wordcount, 8 processes")
    for field in ("launches", "collectives"):
        per_rank_equal(results, "wordcount", field, ref["wordcount"][field],
                       "wordcount, 8 processes")
    m = ref["moe"]
    moe_out = check_rank_moe(torch, results, m)
    for tag, r in (("flat", ref["flat"]), ("grid", ref["grid"]),
                   ("wordcount", ref["wordcount"]), ("moe", m)):
        warm = [x[tag]["warm_ms"] for x in results]
        comm = [x[tag]["comm"] for x in results]
        out["paths"][tag] = {
            "stacked_cold_ms": r["wall_ms"],
            "stacked_warm_ms": r["warm_wall_ms"],
            "process_cold_ms_max": max(x[tag]["cold_ms"] for x in results),
            "process_warm_ms_max": max(warm),
            "process_warm_ms_by_process": warm,
            "launches_per_process": results[0][tag]["launches"],
            "collectives_per_process": results[0][tag]["collectives"],
            "comm_seconds_max_by_op": {
                op: max(c[op]["seconds"] for c in comm) for op in comm[0]},
            "gloo_bytes_per_process_by_hop": {
                op: [h["bytes"] for h in comm[0][op]["hops"]]
                for op in comm[0]},
            "hop_seconds_max": {
                op: [max(c[op]["hops"][i]["seconds"] for c in comm)
                     for i in range(len(comm[0][op]["hops"]))]
                for op in comm[0]}}
    out["paths"]["moe"].update(moe_out)
    out["nccl_world_1"] = nccl_world_one(torch)
    out["launches"] = {tag: {k: sum(r[tag]["launches"][k] for r in results)
                             for k in results[0][tag]["launches"]}
                       for tag in ("flat", "grid", "wordcount", "moe")}
    for tag, names in (("flat", ("partition", "bitonic_sort")),
                       ("grid", ("partition", "bitonic_sort")),
                       ("wordcount", ("partition", "radix_sort")),
                       ("moe", ("partition",))):
        for name in names:
            if any(r[tag]["launches"][name] == 0 for r in results):
                raise AssertionError(f"{tag}: a process did not launch "
                                     f"{name}")
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# -- phases 16 and 17: decoders trained as 8 processes ------------------------


#: the collectives of a recurrent layer a sharded step, over ``model``
#: (see ``train_collectives``)
RECURRENT_COLLECTIVES = {
    "mamba": {"psum": 6, "all_to_all": 3},
    "mlstm": {"psum": 5, "all_to_all": 3, "reduce_scatter": 2,
              "all_gather": 1},
    "slstm": {"psum": 2, "all_gather": 3}}


def train_collectives(cfg, layout, n_leaves: int, partial: bool,
                      data: int, n_zero=None, masked: bool = False) -> dict:
    """The collectives of one sharded step over a ``(data, model)`` grid
    from the layer pattern, which ``tests/test_torch_train_dist_families.py``
    and ``tests/test_torch_train_dist_ssm.py`` also hold the CPU
    processes to. Over ``model``, an attention layer's forward (zamba2's
    shared block at each of its points, ``layout`` its attention's
    branch): the attention's sums (GQA by head: ``wo``'s; MLA: the rope
    query's and ``wo``'s; by sequence: none, an ``all_gather`` of the
    query rows instead); the MLP's row-parallel sum, or the MoE's
    dispatch (two ``all_to_all``s, the drop count's ``psum``), its
    ``moe_aux`` mean, the shared experts' sum and one ``all_gather`` of
    its output blocks; over ``data`` the first row's ``moe_aux`` and
    drops where there are several rows. The remat recompute stops at the
    block's last saved tensor: it reruns the attention's collectives, the
    dispatch's first ``all_to_all`` and drop count and the shared
    experts' sum, not the MLP's sum, the combine, the aux sums or the
    output gather. The backward sums each ``copy_to``'s gradient: the
    attention's input (MLA: its latents and its rope query), the MLP's
    or MoE's input. The split-dim KV layout adds the new keys' and
    values' ``all_gather`` forward and in the recompute and its
    ``reduce_scatter`` in the backward; MLA's split heads the four
    ``all_to_all``s that move the pieces of heads (``wq_up``'s,
    ``wk_up``'s and ``wv_up``'s products to their owners, the output
    back before ``wo``) forward, in the recompute and, inverse, in the
    backward. A recurrent layer (``RECURRENT_COLLECTIVES``):
    Mamba2's ``[z | x]`` exchange, the norm's square sum and
    ``out_proj``'s sum forward, the exchange and the square sum again in
    the recompute, and in the backward the square sum, the exchange and
    the two ``copy_to`` gradients (the input's, B, C and dt's); mLSTM the
    same but for B, C and dt, with its q, k, v and gates'
    ``reduce_scatter`` forward and in the recompute and its
    ``all_gather`` in the backward; sLSTM the gates' and the output's
    ``all_gather`` forward, the gates' again in the recompute, and its
    two ``copy_to`` gradients. The enc-dec: each encoder layer an
    attention layer's; each decoder layer one's with a second attention,
    the cross-attention, whose collectives are the self-attention's (its
    keys and values are this rank's products of the encoder output, which
    enters the decoder once: one ``copy_to`` gradient a step). Around the
    layers: the embedding's sum,
    the cross-entropy's ``pmax`` and sum and its logits' ``copy_to``;
    after the backward one ``psum`` of the partial leaves' gradients
    where there are any (the router; replicated GQA leaves; the
    recurrent blocks' per-head vectors), over ``data`` (with more than
    one data rank) one ``reduce_scatter`` and one ``all_gather`` a leaf
    ZeRO-1 shards (``n_zero`` of the ``n_leaves``, default all) and one
    ``psum`` each of the others, and one ``psum`` each of the norm's
    squares and of the metrics over ``data``; with ``masked`` and more
    than one data rank, one ``psum`` of the loss mask's count."""
    from repro_torch.models.transformer import (_shared_attn_points,
                                                layer_pattern)
    mla = cfg.attn_type == "mla"
    attn_fwd = 0 if layout in (None, "sequence") else 2 if mla else 1
    attn_bwd = 2 if mla else 1
    if cfg.family == "moe":
        ffn_fwd = 2 + (data > 1) + bool(cfg.n_shared_experts)
        ffn_re = 1 + bool(cfg.n_shared_experts)
        gathers, a2a = 1, 3
    else:
        ffn_fwd, ffn_re, gathers, a2a = 1, 0, 0, 0
    seq_gathers = 2 if layout in ("sequence", "split_kv") else 0
    attention = {"psum": attn_fwd + ffn_fwd + attn_fwd + ffn_re + attn_bwd
                 + 1, "all_gather": gathers + seq_gathers,
                 "all_to_all": a2a + 12 * (layout == "split_heads"),
                 "reduce_scatter": int(layout == "split_kv")}
    n_zero = n_leaves if n_zero is None else n_zero
    zero = n_zero if data > 1 else 0
    plain = n_leaves - n_zero if data > 1 else 0
    out = {"psum": 1 + 2 + int(partial) + 1 + (data > 1) + plain
           + (masked and data > 1),
           "pmax": 1, "all_gather": zero, "reduce_scatter": zero,
           "all_to_all": 0}
    if cfg.family == "audio":
        cross = {"psum": 2 * attn_fwd + attn_bwd, "all_gather": seq_gathers}
        decoder = {op: attention.get(op, 0) + cross.get(op, 0)
                   for op in attention}
        kinds = ["enc"] * cfg.enc_layers + ["dec"] * cfg.num_layers
        out["psum"] += 1
    else:
        decoder = None
        kinds = layer_pattern(cfg) + ["shared_attn"] * len(
            _shared_attn_points(cfg))
    for kind in kinds:
        layer = decoder if kind == "dec" else RECURRENT_COLLECTIVES.get(
            kind, attention)
        for op, n in layer.items():
            out[op] += n
    return {k: v for k, v in out.items() if v}


#: the collectives of a recurrent layer a decode step over ``model``
#: (see ``serve_collectives``), without the state gathers
SERVE_RECURRENT = {"mamba": {"psum": 2, "all_to_all": 1},
                   "mlstm": {"psum": 2, "all_to_all": 1,
                             "reduce_scatter": 1},
                   "slstm": {"all_gather": 2}}


def serve_layout(cfg, model: int):
    """The attention layout (``attention.tp_layout``) of ``cfg``'s serving
    over ``model`` ranks: its decoder's attention, zamba2's shared
    block's; None without attention (xLSTM)."""
    from repro_torch.models.attention import tp_layout
    from repro_torch.models.registry import meta_params
    from repro_torch.models.transformer import ATTN_KINDS
    p = meta_params(cfg)
    if cfg.family == "audio":
        attn = p.dec_blocks[0].self_attn
    elif "shared_attn" in p:
        attn = p.shared_attn.attn
    else:
        attn = next((b.attn for b in p.blocks if b.kind in ATTN_KINDS), None)
    return None if attn is None else tp_layout(cfg, attn, model)


def serve_collectives(cfg, layout, data: int, one_row: bool = False
                      ) -> dict:
    """The collectives of one decode step over a ``(data, model)`` grid
    from the layer pattern, which ``tests/test_torch_serve_dist.py`` and
    ``tests/test_torch_serve_dist_recurrent.py`` also hold the CPU
    processes to: the embedding's sum over ``model``; an attention
    layer's (zamba2's shared block at each of its points) sums (GQA by
    head: ``wo``'s; MLA: the rope query's and ``wo``'s; by sequence:
    none, one position is attended whole), and in the heads layout one
    ``all_gather`` of the new keys and values where the cache keeps
    every KV head and ``wk`` shards them, and in the split-dim KV layout
    (the columns of a head gathered whole); MLA's split heads their four
    ``all_to_all``s; at a batch of one
    (``one_row``) over more than one data rank, not sliding-window, the
    time-sharded cache's ``pmax`` and two sums over ``data``; the MLP's
    row-parallel sum, or the MoE's expert-sharded dense dispatch: one
    sum of the routed and the shared experts' parts and, with more than
    one data rank, one ``all_gather`` of the per-expert counts over
    ``data``; the enc-dec's decoder layers a self- and a cross-attention
    each (no cache, so no gather, in the latter); a recurrent layer
    (``SERVE_RECURRENT``): Mamba2's ``[z | x]`` exchange, its norm's and
    ``out_proj``'s sums, mLSTM's the same with its q, k, v and gates'
    ``reduce_scatter``, and one ``all_gather`` of the new states where
    the cache keeps every head (16 not dividing them); sLSTM's gates'
    and output's ``all_gather``, and one of its state where the cache
    shards its heads; the logits gathered over ``model`` once."""
    from repro_torch.models.registry import _kv_spec, _layer_cache_spec
    from repro_torch.models.transformer import (_shared_attn_points,
                                                layer_pattern)
    mla = cfg.attn_type == "mla"
    heads = layout not in (None, "sequence")
    gathered = (layout == "split_kv" or heads and not mla
                and _kv_spec(cfg) is None and cfg.n_kv_heads > 1)
    attn = {"psum": (2 if mla else 1) if heads else 0,
            "all_gather": int(gathered),
            "all_to_all": 4 * (layout == "split_heads")}
    if (one_row and data > 1 and cfg.attn_type != "swa"
            and cfg.family != "audio"):
        attn["psum"] += 2
        attn["pmax"] = 1
    if cfg.family == "moe":
        ffn = {"psum": 1, "all_gather": int(data > 1)}
    else:
        ffn = {"psum": 1}
    layer = {op: attn.get(op, 0) + ffn.get(op, 0)
             for op in set(attn) | set(ffn)}
    if cfg.family == "audio":
        layer["psum"] += int(heads)
        kinds = ["dec"] * cfg.num_layers
    else:
        kinds = layer_pattern(cfg) + ["shared_attn"] * len(
            _shared_attn_points(cfg))
    out = {"psum": 1, "all_gather": 1}
    for kind in kinds:
        ops = dict(SERVE_RECURRENT.get(kind, layer))
        if kind in SERVE_RECURRENT:
            spec = _layer_cache_spec(cfg, kind, 2, ("data",))
            state = spec[{"mamba": "ssm", "mlstm": "C", "slstm": "c"}[kind]]
            if (state[1] is None) == (kind != "slstm"):
                ops["all_gather"] = ops.get("all_gather", 0) + 1
        for op, n in ops.items():
            out[op] = out.get(op, 0) + n
    return {k: v for k, v in out.items() if v}


def model_gathers(cfg, layout, grid, seq: int) -> list:
    """The bytes of each ``all_gather`` over ``model`` a sharded step
    makes (what a process hands to gloo), all of activations: a MoE
    layer's output blocks and the sequence-parallel attention's query
    rows twice (forward and recompute), ``(B / data, S / model, d)``
    bfloat16 (``S`` every position: the VLM's image tokens and its text;
    the enc-dec encoder's frames, and twice the decoder's tokens, for
    the self- and the cross-attention); sLSTM's input gates twice, ``(B
    / data, S, 4 d / model)``, and its output once, ``(B / data, S, d /
    model)``, bfloat16; the gradient of mLSTM's q, k, v and gates, ``(B
    / data, S, (3 d_in + 2 H) / model)`` float32; the split-dim KV
    layout's new keys and values twice, ``(2, B / data, S, KV hd /
    model)`` bfloat16."""
    from repro_torch.models.ssm import mlstm_dims
    from repro_torch.models.transformer import (_shared_attn_points,
                                                layer_pattern)
    data, m = grid
    rows = TRAIN_BATCH // data * seq
    block = rows // m * cfg.d_model * 2
    if cfg.family == "audio":
        if layout != "sequence":
            return []
        frames = TRAIN_BATCH // data * cfg.enc_seq // m * cfg.d_model * 2
        return ([frames] * 2 * cfg.enc_layers
                + [block] * 4 * cfg.num_layers)
    out = []
    for kind in layer_pattern(cfg) + ["shared_attn"] * len(
            _shared_attn_points(cfg)):
        if kind == "moe":
            out.append(block)
        if kind in ("dense", "moe", "shared_attn") and layout == "sequence":
            out += [block] * 2
        if kind in ("dense", "moe", "shared_attn") and layout == "split_kv":
            out += [2 * rows * cfg.n_kv_heads * cfg.hd // m * 2] * 2
        if kind == "slstm":
            out += [rows * 4 * cfg.d_model // m * 2] * 2 + [
                rows * cfg.d_model // m * 2]
        if kind == "mlstm":
            d_in, H, _ = mlstm_dims(cfg)
            out.append(rows * (3 * d_in + 2 * H) // m * 4)
    return out


def train_ranks_batches(torch, cfg, seq: int = TRAIN_SEQ,
                        steps: int = TRAIN_RANKS_STEPS, dev=None,
                        seed: int = 0):
    """The first ``steps`` batches of ``seq`` tokens of the launcher's
    corpus at ``TRAIN_STEPS`` steps, in Sector slices, served by a fresh
    ``SectorDataPipeline`` (the launcher's seed), as int32 tensors; with
    the enc-dec's or the VLM's inputs besides (:func:`family_inputs`,
    drawn on ``dev`` from ``seed``)."""
    import tempfile
    from repro_torch.data import (SectorDataPipeline, synthetic_tokens,
                                  upload_token_dataset)
    from repro_torch.launch.train import make_sector
    root = tempfile.mkdtemp(prefix="chip_smoke_train_ranks_",
                            dir="/dev/shm" if os.path.isdir("/dev/shm")
                            else None)
    try:
        master, client, daemon = make_sector(root)
        toks = synthetic_tokens(TRAIN_BATCH * (TRAIN_SEQ + 1)
                                * (TRAIN_STEPS + 8), cfg.vocab)
        upload_token_dataset(client, "/corpus/train", toks, num_slices=8)
        daemon.run_until_stable()
        it = iter(SectorDataPipeline(master, client, "/corpus/train",
                                     batch=TRAIN_BATCH, seq_len=seq))
        batches = [{k: torch.from_numpy(v) for k, v in next(it).items()}
                   for _ in range(steps)]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if cfg.family in ("audio", "vlm"):
        family_inputs(torch, dev, cfg, batches, seed)
    return batches


def family_inputs(torch, dev, cfg, batches, seed: int) -> None:
    """The enc-dec's and the VLM's inputs besides the tokens, added to
    each batch in place (CPU tensors): the stub frames or image
    embeddings drawn on the card from ``seed`` as phase 13's
    ``zoo_inputs`` draws them; the enc-dec's ``loss_mask`` of transcript
    lengths from ``WHISPER_TRANSCRIPT_MIN`` to the batch's length drawn
    from ``seed``, the padding after each masked."""
    import numpy as np
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    rng = np.random.default_rng(seed)
    for b in batches:
        B, S = b["tokens"].shape
        if cfg.family == "audio":
            b["frames"] = torch.randn(
                (B, cfg.enc_seq, cfg.d_model), generator=gen,
                device=dev).bfloat16().cpu()
            lengths = rng.integers(WHISPER_TRANSCRIPT_MIN, S + 1, B)
            b["loss_mask"] = torch.from_numpy(
                (np.arange(S)[None] < lengths[:, None]).astype(np.float32))
        else:
            b["img_embeds"] = torch.randn(
                (B, cfg.img_tokens, cfg.d_model), generator=gen,
                device=dev).bfloat16().cpu()


def train_ranks_reference(torch, dev, cfg, batches, opt_cfg, directory: str,
                          grad_leaves, grid=None, floor: bool = True,
                          faults: bool = False, seed: int = 0) -> dict:
    """The reference step on the card: one process, or the stacked
    ``Ranks`` of ``grid`` (``("data", "model")``). Its initial float32
    weights (drawn from ``seed``) written to ``directory`` as
    ``init.<leaf>.npy``, the steps (losses, norms, lrs, metrics, walls,
    peak memory), the first step's gradient of ``grad_leaves`` (read
    through the step's ``on_grads``) and the parameters after the steps
    as ``final.<leaf>.npy``. With ``floor`` a rounding floor (phases 16
    and 18): the one process against itself, the same steps with each
    batch as two micro batches (the gradient's sums grouped as two data
    ranks group them; each step's loss taken on the whole batch first),
    its first gradient the mean of the two halves'; with a ``loss_mask``
    each micro batch's mean over its own unmasked count, as the JAX
    package's scan takes them, so there the floor holds that weighting
    besides rounding). With ``faults``
    (phases 17 and 18) the planted faults' readings (``controls``): the
    gradient of each batch's first half of rows, halved, against the
    step's (the first step's held leaves, each's error over its largest
    value, and every step's norm's relative error), and the parameters
    after the steps against the initial ones (no update) by the trainer
    tests' rule. The card's memory is freed before returning."""
    from repro_torch.comm import Ranks
    from repro_torch.models import build
    from repro_torch.models.convert import named_leaves
    from repro_torch.train.trainer import (build_train_step,
                                           init_train_state, loss_and_grads)
    model = build(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    rk = (None if grid is None else
          Ranks(shape=grid, axes=("data", "model"), device=dev))
    params, opt = init_train_state(model, gen, dev)
    leaves = named_leaves(params, cfg)
    for name, p in leaves.items():
        save_npy(directory, f"init.{name}", p.detach())
    on_dev = [{k: v.to(dev) for k, v in b.items()} for b in batches]
    out = {"losses": [], "grad_norms": [], "lrs": [], "step_ms": [],
           "metrics": []}
    kept = {}

    def keep(g):
        kept.update({n: (torch.zeros(leaves[n].shape) if g[n] is None
                         else g[n].float().cpu()) for n in grad_leaves})

    # with one batch repeated the steps without their update read the
    # later steps' faults (below)
    repeated = all(torch.equal(b["tokens"], batches[0]["tokens"])
                   for b in batches)
    half_leaves, half_norms = {}, []
    step = build_train_step(model, opt_cfg, rk)
    torch.cuda.reset_peak_memory_stats()
    for i, b in enumerate(on_dev):
        if faults and (i == 0 or not repeated):
            # a planted fault, not a check: half the batch's rows (data
            # row 0's alone), its gradient halved
            _, _, g = loss_and_grads(
                model, params, {k: v[:v.shape[0] // 2] for k, v in b.items()},
                rk)
            half_norms.append(grads_norm(torch, g) / 2)
            if i == 0:
                half_leaves = {n: g[n].float().cpu() / 2 for n in grad_leaves
                               if g[n] is not None}
            del g
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, m = step(params, opt, b, on_grads=keep if i == 0 else None)
        torch.cuda.synchronize()
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["metrics"].append({k: float(v) for k, v in m.items()})
        for k, key in (("losses", "loss"), ("grad_norms", "grad_norm"),
                       ("lrs", "lr")):
            out[k].append(float(m[key]))
    out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    grads = out["grads"] = dict(kept)
    for name, p in leaves.items():
        save_npy(directory, f"final.{name}", p.detach())
    out["n_params"] = sum(p.numel() for p in leaves.values())
    del opt
    if faults:
        norms = out["grad_norms"]
        out["controls"] = {"half_batch": {
            "grad_max_err_over_leaf_max": {
                n: float((half_leaves[n] - w).abs().max() / w.abs().max())
                for n, w in grads.items() if n in half_leaves},
            "grad_norm_rel": abs(half_norms[0] - norms[0]) / norms[0],
            "later_grad_norm_rel": min(
                (abs(h - a) / a for h, a in zip(half_norms[1:], norms[1:])),
                default=None)}}
        del half_leaves
        # a planted fault, not a check: the steps without their update
        # (with one batch repeated, the first step's loss and norm again)
        no_update = out["controls"]["no_update"] = {"params": rule_counts(
            ((load_tensor(torch, directory, f"init.{n}", dev), p)
             for n, p in leaves.items()), sum(out["lrs"]))}
        if repeated and len(batches) > 1:
            no_update["loss"] = min(abs(a - out["losses"][0])
                                    for a in out["losses"][1:])
            no_update["grad_norm_rel"] = min(
                abs(a - out["grad_norms"][0]) / a
                for a in out["grad_norms"][1:])
    if floor:
        # the rounding floor, not a check: the same steps in the one
        # process with each batch as two micro batches
        gen.manual_seed(seed)
        twin, twin_opt = init_train_state(model, gen, dev)
        step2 = build_train_step(model, opt_cfg, accum_steps=2)
        norms, losses = [], []
        kept.clear()
        for i, b in enumerate(on_dev):
            with torch.no_grad():
                losses.append(float(model.train_loss(twin, b)[0]))
            _, _, m = step2(twin, twin_opt, b,
                            on_grads=keep if i == 0 else None)
            norms.append(float(m["grad_norm"]))
        twins = named_leaves(twin, cfg)
        out["accum2_floor"] = {
            "losses": losses, "grad_norms": norms,
            "loss_max_abs_diff": max(abs(a - b) for a, b in
                                     zip(losses, out["losses"])),
            "grad_norm_max_rel_diff": max(abs(a - b) / abs(b) for a, b in
                                          zip(norms, out["grad_norms"])),
            "grad_max_err_over_leaf_max": {
                n: float((kept[n] - grads[n]).abs().max()
                         / grads[n].abs().max()) for n in grads},
            "params": rule_counts(((twins[n], p) for n, p in
                                   leaves.items()), sum(out["lrs"]))}
        del twin, twin_opt, twins, step2
    del params, leaves, step, model, on_dev
    gc.collect()
    torch.cuda.empty_cache()
    return out


def grads_norm(torch, grads: dict) -> float:
    """The global norm of ``{name: gradient or None}``."""
    return sum(float(torch.linalg.vector_norm(g.float())) ** 2
               for g in grads.values() if g is not None) ** 0.5


def rule_counts(pairs, sum_lr: float) -> dict:
    """The trainer tests' rule (tests/test_torch_train.py) over ``(got,
    want)`` parameter pairs, by counts: "99% within 0.05 * sum(lr)" is
    "at most 1% beyond it", "half within 0.005 * sum(lr)" at most half
    beyond."""
    return rule_shares(rule_tally(pairs, sum_lr), sum_lr)


def rule_tally(pairs, sum_lr: float) -> dict:
    """The rule's raw counts over ``(got, want)`` pairs: elements, the
    largest difference, and how many lie beyond 0.05 and 0.005 of
    ``sum_lr``; tallies of disjoint blocks add up."""
    n = beyond_5 = beyond_05 = 0
    top = 0.0
    for got, want in pairs:
        d = (got.detach() - want.detach()).abs()
        n += d.numel()
        top = max(top, float(d.max()))
        beyond_5 += int((d > 0.05 * sum_lr).sum())
        beyond_05 += int((d > 0.005 * sum_lr).sum())
    return {"elements": n, "max": top, "beyond_5": beyond_5,
            "beyond_05": beyond_05}


def rule_shares(t: dict, sum_lr: float) -> dict:
    return {"elements": t["elements"], "max_over_sum_lr": t["max"] / sum_lr,
            "share_beyond_0.05_sum_lr": t["beyond_5"] / t["elements"],
            "share_beyond_0.005_sum_lr": t["beyond_05"] / t["elements"]}


def comm_by_op_axis(log) -> dict:
    """A step's collective log summed by ``op`` over ``axes``: calls,
    bytes handed to gloo and host seconds."""
    out = {}
    for e in log:
        s = out.setdefault(f"{e['op']} over {','.join(e['axes'])}",
                           {"calls": 0, "bytes": 0, "seconds": 0.0})
        s["calls"] += 1
        s["bytes"] += e["bytes"]
        s["seconds"] += e["seconds"]
    return out


def rank_train(ranks, directory: str, batches, opt_cfg, sum_lr: float,
               cfg, grad_leaves, ckpt_root=None) -> dict:
    """One of the 8 processes of phase 16 or 17: this process's shards
    cut from the initial weights in ``directory``, the sharded steps (the
    last with its collectives logged, K1's launches counted from zero
    each step), its state's bytes, the first step's gradient blocks of
    ``grad_leaves``; with ``ckpt_root`` the state after the steps saved,
    restored onto another grid and saved again (:func:`rank_checkpoint`);
    then its parameter blocks after the steps against
    the reference's (``final.<leaf>.npy``), each distinct block on the
    first process holding it (the rule's tally), and its routed experts'
    blocks to the bit."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.comm import spec_axes
    from repro_torch.kernels import partition
    from repro_torch.models import build
    from repro_torch.models.convert import named_leaves
    from repro_torch.models.registry import meta_params
    from repro_torch.train.trainer import init_train_state, jit_train_step
    dev = ranks.device
    model = build(cfg)
    shapes = {n: tuple(p.shape)
              for n, p in meta_params(cfg).named_parameters()}
    t0 = time.perf_counter()
    source = {n: load_npy(directory, f"init.{n}") for n in shapes}
    params, opt = init_train_state(model, ranks=ranks, source=source)
    load_s = time.perf_counter() - t0
    step_fn, (p_specs, opt_specs, _) = jit_train_step(model, opt_cfg, ranks)
    out = {"rank": ranks.rank, "device": str(dev), "load_s": load_s,
           "losses": [], "grad_norms": [], "lrs": [], "metrics": [],
           "step_ms": [], "counts": [], "k1_launches": []}
    kept = {}

    def keep(grads, specs):
        kept.update({n: (grads[n].cpu(), specs[n]) for n in grad_leaves})

    torch.cuda.reset_peak_memory_stats(dev)
    out["mem_at_reset_bytes"] = torch.cuda.memory_allocated(dev)
    last = len(batches) - 1
    for i, b in enumerate(batches):
        ranks.collectives.clear()
        ranks.log = [] if i == last else None
        dist.barrier()
        torch.cuda.synchronize(dev)
        before = partition.KERNEL.launches
        t0 = time.perf_counter()
        _, _, m = step_fn(params, opt, b, on_grads=keep if i == 0 else None)
        torch.cuda.synchronize(dev)
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["k1_launches"].append(partition.KERNEL.launches - before)
        out["counts"].append(dict(ranks.collectives))
        out["metrics"].append({k: float(v) for k, v in m.items()})
        for k, key in (("losses", "loss"), ("grad_norms", "grad_norm"),
                       ("lrs", "lr")):
            out[k].append(float(m[key]))
    out["comm_last_step"] = comm_by_op_axis(ranks.log)
    out["model_all_gather_bytes"] = [e["bytes"] for e in ranks.log
                                     if e["op"] == "all_gather"
                                     and "model" in e["axes"]]
    ranks.log = None
    out["peak_mem_bytes"] = torch.cuda.max_memory_allocated(dev)
    if ckpt_root is not None:
        out["checkpoint"] = rank_checkpoint(ranks, model, params, opt,
                                            ckpt_root)
    leaves = named_leaves(params, cfg)
    out["param_bytes"] = sum(p.numel() * 4 for p in leaves.values())
    out["moment_bytes"] = {k: sum(t.numel() * 4 for t in opt[k].values())
                           for k in ("m", "v")}
    out["grads"] = kept
    del opt
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    pairs, routed = [], []
    for name, p in leaves.items():
        spec = p_specs[name]
        named = spec_axes(spec)
        if any(c for a, c in zip(ranks.axes, ranks.coords)
               if a not in named):
            continue
        want = torch.from_numpy(np.array(ranks.local_shard(
            load_npy(directory, f"final.{name}"), spec))).to(dev)
        pairs.append((p, want))
        if name.split(".")[-1] in ("w_gate", "w_up", "w_down") \
                and ".moe." in name:
            routed.append(bool(torch.equal(p.detach(), want)))
    out["params_tally"] = rule_tally(pairs, sum_lr)
    out["routed_equal"] = routed
    out["compare_s"] = time.perf_counter() - t0
    return out


def rank_checkpoint(ranks, model, params, opt, root: str) -> dict:
    """Phase 16's checkpoints, in one of its 8 processes: the state after
    the steps saved from ``ranks``' grid into a Sector deployment the
    processes share under ``root`` (4 slaves, replication 2, the
    launcher's), its upload on the background thread; restored onto
    ``CKPT_RANKS_GRID`` built over the same processes (the first
    checkpoint then deleted); saved again from there. Seconds, gloo bytes
    by op and axis, the restored blocks' shapes and bytes against the new
    grid's specs, the Sector root's bytes after each save, and (process
    0) both manifests and the slices' holders."""
    import json
    import math
    import torch
    from repro_torch.comm import ProcessRanks
    from repro_torch.launch.train import shared_sector
    from repro_torch.models.convert import flatten, named_leaves
    from repro_torch.models.registry import meta_params
    from repro_torch.train.checkpoint import SectorCheckpointer
    from repro_torch.train.elastic import grid_state_specs, remesh_state
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.trainer import (_local_shape, make_state_shardings,
                                           state_tree)
    dev, cfg = ranks.device, model.cfg
    sector, client, _ = shared_sector(root, ranks, lambda c: None)
    ckpt = SectorCheckpointer(client, "/ckpt/run0", num_slices=CKPT_SLICES)
    prefix = "/ckpt/run0/step_{:08d}/"
    out = {"rank": ranks.rank, "root_bytes": []}

    def timed(grid, fn):
        grid.log = []
        torch.cuda.synchronize(dev)
        grid.barrier()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
        gloo = comm_by_op_axis(grid.log)
        grid.log = None
        grid.barrier()
        if ranks.rank == 0:
            out["root_bytes"].append(sum(s.used_bytes()
                                         for s in sector.slaves.values()))
        return res, dict(ckpt.timings, seconds=seconds, gloo=gloo)

    def save_async():
        ckpt.save(1, state_tree(model, params, opt), blocking=False,
                  ranks=ranks, specs=grid_state_specs(model, ranks))
        returned = time.perf_counter()
        ckpt.wait()
        return returned

    t0 = time.perf_counter()
    returned, out["save"] = timed(ranks, save_async)
    out["save"]["returned_s"] = returned - t0
    first = json.loads(client.download(prefix.format(1) + "MANIFEST.json"))
    new = ProcessRanks(CKPT_RANKS_GRID, ranks.axes, backend=ranks.backend,
                       device=dev)
    meta = meta_params(cfg).trainable()
    like = state_tree(model, meta, init_opt_state(named_leaves(meta, cfg)))
    new_specs = grid_state_specs(model, new)
    (tree, step), out["restore"] = timed(
        new, lambda: remesh_state(ckpt, like, new, new_specs))
    # the restored blocks against the new grid's specs
    p_specs, opt_specs = make_state_shardings(
        model, dict(zip(new.axes, new.shape)))
    shapes = {n: tuple(p.shape) for n, p in meta.named_parameters()}
    got = {"params": flatten(tree["params"]), "m": flatten(tree["opt"]["m"]),
           "v": flatten(tree["opt"]["v"])}
    specs = {"params": p_specs, "m": opt_specs["m"], "v": opt_specs["v"]}
    bad = [f"{k}.{n}" for k in got for n in shapes
           if tuple(got[k][n].shape) != _local_shape(shapes[n], specs[k][n],
                                                     new)
           or got[k][n].device != dev]
    out.update({
        "restored_step": step, "shape_faults": bad,
        "restored_bytes": sum(t.numel() * t.element_size()
                              for k in got for t in got[k].values()),
        "want_bytes": sum(4 * math.prod(_local_shape(shapes[n], specs[k][n],
                                                     new))
                          for k in specs for n in shapes),
        "restored_step_leaf": int(tree["opt"]["step"])})
    # the first checkpoint, read, goes: the root holds one at a time
    for fm in client.ls(prefix.format(1)):
        if ranks.rank == 0:
            client.delete(fm.path)
        else:
            sector.forget(fm.path)
    new.barrier()
    _, out["resave"] = timed(new, lambda: ckpt.save(2, tree, ranks=new,
                                                    specs=new_specs))
    del tree, got
    if ranks.rank == 0:
        second = json.loads(client.download(prefix.format(2)
                                            + "MANIFEST.json"))
        out.update({"first": first, "second": second,
                    "holders": [sorted(client.stat(s["path"]).locations)
                                for s in second["slices"]],
                    "fs": filesystem_of(root)})
    gc.collect()
    torch.cuda.empty_cache()
    return out


def check_rank_checkpoint(cfg, results) -> tuple:
    """Phase 16's checkpoint checks: (the numbers printed, failures). The
    second checkpoint's slices, MD5s and leaf table equal the first's;
    the leaf table is the one-process save's for ``cfg`` (the
    ``leaf_table`` of the state on the ``meta`` device); every process's
    restored blocks have the new grid's shapes, bytes and device; every
    slice has 2 holders; the Sector root stays below
    ``CKPT_ROOT_LIMIT``."""
    from repro_torch.models import build
    from repro_torch.models.convert import named_leaves
    from repro_torch.models.registry import meta_params
    from repro_torch.train.checkpoint import leaf_table
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.trainer import state_tree
    ck = [r["checkpoint"] for r in results]
    c0, failures = ck[0], []
    meta = meta_params(cfg).trainable()       # float32, as trained
    table = leaf_table(state_tree(build(cfg), meta, init_opt_state(
        named_leaves(meta, cfg))))
    first, second = c0["first"], c0["second"]
    if [s["md5"] for s in second["slices"]] != \
            [s["md5"] for s in first["slices"]]:
        failures.append("the checkpoint saved from the new grid has other "
                        "MD5s")
    if [s["nbytes"] for s in second["slices"]] != \
            [s["nbytes"] for s in first["slices"]] \
            or second["leaves"] != first["leaves"]:
        failures.append("the two checkpoints' slices or leaf tables differ")
    if first["leaves"] != table:
        failures.append("the leaf table is not the one-process save's")
    for c in ck:
        if c["shape_faults"] or c["restored_bytes"] != c["want_bytes"] \
                or c["restored_step"] != 1 or c["restored_step_leaf"] \
                != TRAIN_RANKS_STEPS:
            failures.append(f"process {c['rank']}: restored blocks "
                            f"{c['shape_faults'][:3]}, {c['restored_bytes']} "
                            f"bytes against {c['want_bytes']}")
    if any(len(h) != 2 for h in c0["holders"]):
        failures.append(f"slice holders {c0['holders']}")
    peak = max(c0["root_bytes"])
    if peak > CKPT_ROOT_LIMIT:
        failures.append(f"the Sector root held {peak} bytes")

    def by(key, field):
        return [c[key][field] for c in ck]

    line = {
        "grids": {"saved": list(TRAIN_RANKS_GRID),
                  "restored": list(CKPT_RANKS_GRID)},
        "slices": CKPT_SLICES, "replication": 2,
        "state_bytes": first["total_bytes"],
        "md5s": [s["md5"] for s in first["slices"]],
        "md5s_equal": [s["md5"] for s in second["slices"]]
        == [s["md5"] for s in first["slices"]],
        "leaf_table_is_one_process": first["leaves"] == table,
        "save_s": max(by("save", "seconds")),
        "save_returned_s": max(by("save", "returned_s")),
        "restore_s": max(by("restore", "seconds")),
        "resave_s": max(by("resave", "seconds")),
        # each process's part: the exchanges, the slice owners' upload
        # (write, MD5, one more copy), the gather's wait for the slowest
        # upload and the manifest; the owners' read and MD5 check
        "by_process": {
            f"{k}_{f}": by(k, f"{'restore' if k == 'restore' else 'save'}"
                           f"_{f}")
            for k, fs in (("save", ("exchange_s", "upload_s", "gather_s",
                                    "finish_s")),
                          ("restore", ("read_s", "exchange_s")),
                          ("resave", ("exchange_s", "upload_s", "gather_s",
                                      "finish_s")))
            for f in fs},
        "gloo_bytes_by_process": {
            k: [sum(v["bytes"] for v in c[k]["gloo"].values()) for c in ck]
            for k in ("save", "restore", "resave")},
        "gloo_seconds_by_process": {
            k: [sum(v["seconds"] for v in c[k]["gloo"].values())
                for c in ck] for k in ("save", "restore", "resave")},
        "restored_bytes_by_process": [c["restored_bytes"] for c in ck],
        "sector_root_bytes_peak": peak,
        "sector_root_bytes_after_each_save": c0["root_bytes"],
        "sector_fs": c0["fs"], "holders": c0["holders"]}
    return line, failures


def check_train_ranks(torch, cfg, grid, ref, results, grad_leaves,
                      bounds: dict, k1_per_step: int,
                      masked: bool = False) -> tuple:
    """Phase 16's and 17's checks of the processes' ``results`` against
    the reference run ``ref`` within ``bounds``: (the phase line's
    numbers, failures). A quantity whose bound is missing is printed, not
    held (MLA's later steps). Where ``ref`` carries planted faults'
    readings (``controls``), each held bound they reach must be below its
    fault's reading: a check that cannot see the fault fails. ``masked``:
    the batches carry a ``loss_mask`` (its count's ``psum`` a step)."""
    import math
    from repro_torch.comm import shard_slices, spec_axes
    from repro_torch.models import build
    from repro_torch.models.attention import tp_layout
    from repro_torch.models.registry import meta_params
    from repro_torch.train.trainer import (make_state_shardings,
                                           partial_over_model)
    sizes = dict(zip(("data", "model"), grid))
    r0 = results[0]
    failures = []
    controls = ref.get("controls", {})
    seen, table = {}, {}

    def held(what: str, reading: float, bound, control=None,
             floor=None) -> None:
        if bound is None:
            return
        table[what] = {"reading": reading, "bound": bound,
                       "planted_fault": control, "one_process_floor": floor}
        if reading > bound:
            failures.append(f"{what}: {reading} beyond {bound}")
        if control is not None:
            seen[what] = control
            if control <= bound:
                failures.append(f"{what}: a planted fault reads {control}, "
                                f"within the bound {bound}")
    # (1) the loss, the norm, the lr and the metrics
    for r in results:
        for k in ("losses", "grad_norms", "lrs", "metrics"):
            if r[k] != r0[k]:
                failures.append(f"process {r['rank']}'s {k} {r[k]} differ "
                                f"from process 0's {r0[k]}")
    if r0["lrs"] != ref["lrs"]:
        failures.append(f"lrs {r0['lrs']} != {ref['lrs']}")
    dl = [abs(a - b) for a, b in zip(r0["losses"], ref["losses"])]
    dgs = [abs(a - b) / abs(b) for a, b in zip(r0["grad_norms"],
                                               ref["grad_norms"])]
    out = {"loss_abs_diff": dl, "grad_norm_rel_diff": dgs,
           "bounds": bounds}
    half = controls.get("half_batch", {})
    # the one process's own floor (phases 16 and 18), printed beside the
    # bounds: its steps over two micro batches
    fl = ref.get("accum2_floor")
    fdl = fdg = [None] * len(dl)
    if fl is not None:
        fdl = [abs(a - b) for a, b in zip(fl["losses"], ref["losses"])]
        fdg = [abs(a - b) / abs(b) for a, b in zip(fl["grad_norms"],
                                                   ref["grad_norms"])]
    held("the first step's loss", dl[0], bounds["loss_first"], None, fdl[0])
    held("the first step's grad_norm", dgs[0], bounds["grad_norm_rel_first"],
         half.get("grad_norm_rel"), fdg[0])
    no_update = controls.get("no_update", {})
    if len(dl) > 1:
        held("the later losses", max(dl[1:]), bounds.get("loss"),
             no_update.get("loss"), None if fl is None else max(fdl[1:]))
        held("the later grad_norms", max(dgs[1:]),
             bounds.get("grad_norm_rel"),
             no_update.get("grad_norm_rel", half.get("later_grad_norm_rel")),
             None if fl is None else max(fdg[1:]))
    if cfg.family == "moe":
        # the processes' router reads activations rounded otherwise than
        # the stacked step's (float32 sums over ranks, rounded once), so
        # a few near-tie tokens may route elsewhere
        got, want = r0["metrics"][0], ref["metrics"][0]
        choices = TRAIN_BATCH * r0["seq"] * cfg.top_k * cfg.num_layers
        out["first_step_moe"] = {k: [got[k], want[k]]
                                 for k in ("moe_aux", "moe_dropped")}
        held("the first step's moe_dropped",
             abs(got["moe_dropped"] - want["moe_dropped"]),
             bounds["moe_dropped_share"] * choices)
        held("the first step's moe_aux",
             abs(got["moe_aux"] - want["moe_aux"]) / want["moe_aux"],
             bounds["moe_aux_rel"])
    # (2) the first step's gradient blocks: each within its ``rtol`` of
    # the leaf's largest value plus ``grad_atol``
    grad_err, grad_top = {}, {}
    atol = bounds.get("grad_atol", 0.0)
    for n in grad_leaves:
        want = ref["grads"][n]
        worst = 0.0
        for rank, r in enumerate(results):
            got, spec = r["grads"][n]
            sl = shard_slices(want.shape, spec, grid, ("data", "model"), rank)
            worst = max(worst, float((got - want[sl]).abs().max()))
        top = grad_top[n] = float(want.abs().max())
        routed = n.split(".")[-1] in ("w_gate", "w_up", "w_down") \
            and ".moe." in n
        if routed:
            grad_err[n] = worst
            if worst or top:
                failures.append(f"{n}: a routed expert's gradient is not "
                                f"zero ({worst}, reference {top})")
            continue
        grad_err[n] = worst / top
        rtol = bounds.get("grad_rtol_leaf", {}).get(n, bounds["grad_rtol"])
        fault = half.get("grad_max_err_over_leaf_max", {}).get(n)
        held(f"{n}'s first-step gradient", (worst - atol) / top, rtol,
             None if fault is None else fault - atol / top,
             None if fl is None else
             fl["grad_max_err_over_leaf_max"][n] - atol / top)
    out["grad_max_err_over_leaf_max"] = grad_err
    out["grad_leaf_max"] = grad_top
    # (3) the parameters after the steps: the trainer tests' rule over
    # every distinct block, each tallied on the first process holding it
    tally = {k: sum(r["params_tally"][k] for r in results)
             for k in ("elements", "beyond_5", "beyond_05")}
    tally["max"] = max(r["params_tally"]["max"] for r in results)
    pv = rule_shares(tally, sum(ref["lrs"]))
    out["params_vs_reference"] = pv
    moved = no_update.get("params", {})
    for k, bound in bounds.get("params", {}).items():
        held(f"the parameters' {k} after {len(ref['lrs'])} steps", pv[k],
             bound, moved.get(k) if k == "share_beyond_0.05_sum_lr"
             else None, None if fl is None else fl["params"][k])
    out["planted_faults"] = seen
    out["held"] = table
    if cfg.family == "moe":
        routed = [x for r in results for x in r["routed_equal"]]
        out["routed_experts_decay_only_bitwise"] = all(routed)
        if not routed or not all(routed):
            failures.append(f"routed experts after the steps differ from "
                            f"the reference's decay-only update: {routed}")
    # (4) the state's bytes: the specs' arithmetic
    meta = meta_params(cfg)
    shapes = {n: tuple(p.shape) for n, p in meta.named_parameters()}
    p_specs, opt_specs = make_state_shardings(build(cfg), sizes)

    def block_bytes(specs):
        return sum(4 * math.prod(shapes[n]) // math.prod(
            sizes[a] for a in spec_axes(specs[n])) for n in shapes)
    want_p, want_m = block_bytes(p_specs), block_bytes(opt_specs["m"])
    out.update({"param_bytes_per_process": want_p,
                "moment_bytes_per_process": want_m,
                "one_process_state_bytes": 12 * ref["n_params"]})
    for r in results:
        if r["param_bytes"] != want_p or r["moment_bytes"] != {
                "m": want_m, "v": want_m}:
            failures.append(f"process {r['rank']}: {r['param_bytes']} "
                            f"parameter and {r['moment_bytes']} moment "
                            f"bytes, the specs give {want_p} and {want_m} "
                            f"each")
    # (5) the collectives: the count from the layer pattern; over model no
    # all_gather but of activations (``model_gathers``)
    if "enc_blocks" in meta:
        attn = meta.enc_blocks[0].attn
    elif "shared_attn" in meta:
        attn = meta.shared_attn.attn
    else:
        attn = meta.blocks[0].attn if "attn" in meta.blocks[0] else None
    layout = None if attn is None else tp_layout(cfg, attn, sizes["model"])
    partial = any(partial_over_model(n, sp, cfg) for n, sp in p_specs.items())
    n_zero = sum(opt_specs["m"][n] != sp for n, sp in p_specs.items())
    want_c = train_collectives(cfg, layout, len(shapes), partial,
                               sizes["data"], n_zero, masked)
    out["collectives_per_step"] = want_c
    want_g = model_gathers(cfg, layout, grid, r0["seq"])
    for r in results:
        if any(c != want_c for c in r["counts"]) or \
                sorted(r["model_all_gather_bytes"]) != sorted(want_g):
            failures.append(f"process {r['rank']}: collectives "
                            f"{r['counts']} (all_gathers over model: "
                            f"{r['model_all_gather_bytes']}), predicted "
                            f"{want_c} a step and {want_g}")
    # (6) K1 in every process, every step
    out["k1_launches_by_process"] = [r["k1_launches"] for r in results]
    for r in results:
        if r["k1_launches"] != [k1_per_step] * len(ref["lrs"]):
            failures.append(f"process {r['rank']}: K1 launched "
                            f"{r['k1_launches']} a step, {k1_per_step} "
                            f"expected")
    return out, failures


def ranks_phase_line(cfg, grid, ref, results, batches, reference_s,
                     spawn_s) -> dict:
    """The numbers phases 16 and 17 print for one path."""
    r0 = results[0]
    # the warm step: the second (MiniCPM3's only step, cold, logged)
    warm = max(r["step_ms"][-1] for r in results)
    seq = batches[0]["tokens"].shape[1]
    return {"arch": cfg.arch_id, "family": cfg.family,
            "attn": cfg.attn_type, "layers": cfg.num_layers,
            "d_model": cfg.d_model, "heads": cfg.n_heads,
            "kv_heads": cfg.n_kv_heads, "vocab": cfg.vocab,
            "remat": cfg.remat,
            "grid": dict(zip(("data", "model"), grid)),
            "processes": len(results), "backend": "gloo",
            "transport": "gloo over CUDA tensors, chosen by name: 8 "
                         "processes share one card, and NCCL takes one "
                         "card a rank",
            "batch": batches[0]["tokens"].shape[0], "seq": seq,
            "steps": len(batches), "device": nvidia_smi_line(),
            "reference_s": reference_s, "spawn_s": spawn_s,
            "reference": {k: ref[k] for k in (
                "losses", "grad_norms", "lrs", "step_ms", "peak_mem_bytes",
                "metrics", "accum2_floor", "controls") if k in ref},
            "processes_losses": r0["losses"],
            "processes_grad_norms": r0["grad_norms"],
            "processes_metrics": r0["metrics"],
            "step_ms_by_process": [r["step_ms"] for r in results],
            "warm_step_ms_grid": warm,
            "warm_step_ms_reference": ref["step_ms"][-1],
            "grid_over_reference": warm / ref["step_ms"][-1],
            "tokens_per_s_grid": batches[0]["tokens"].numel() / warm * 1e3,
            "load_s_max": max(r["load_s"] for r in results),
            "compare_s_max": max(r["compare_s"] for r in results),
            "peak_mem_bytes_by_process": [r["peak_mem_bytes"]
                                          for r in results],
            "mem_at_reset_bytes_by_process": [r["mem_at_reset_bytes"]
                                              for r in results],
            "comm_last_step_rank0": r0["comm_last_step"]}


# -- phase 19: serving over process ranks -------------------------------------


@contextlib.contextmanager
def forward_drops(out: list):
    """Each ``transformer.forward`` call's ``moe_dropped`` appended to
    ``out`` (the serving calls return the logits and the caches only)."""
    from repro_torch.models import transformer
    real = transformer.forward

    def tapped(*a, **k):
        x, caches, aux = real(*a, **k)
        if "moe_dropped" in aux:
            out.append(float(aux["moe_dropped"]))
        return x, caches, aux

    transformer.forward = tapped
    try:
        yield
    finally:
        transformer.forward = real


@contextlib.contextmanager
def routes_tap(out: list):
    """Each router call's expert ids, every token's sorted (int16, on the
    card), appended to ``out``: the stacked sphere's ``(ranks, tokens,
    k)``, a process's ``(1, tokens, k)``, the dense dispatch's
    ``(tokens, k)``."""
    from repro_torch.models import moe
    real = moe._route

    def tapped(params, x_flat, cfg):
        top_i, top_p, aux = real(params, x_flat, cfg)
        out.append(top_i.sort(dim=-1).values.short())
        return top_i, top_p, aux

    moe._route = tapped
    try:
        yield
    finally:
        moe._route = real


def moved_choices(torch, mine, theirs):
    """Per token, how many of its k experts in ``mine`` are not among
    those of ``theirs`` (both ``(..., tokens, k)``)."""
    same = (mine[..., :, None] == theirs[..., None, :]).any(-1)
    return (~same).sum(-1)


def serve_shape(line: str) -> dict:
    """A phase 19 cell's prompts, their length, the caches' length, the
    decode's first position and its steps: phase 12's (8 prompts of 1024
    tokens into 1040 slots, ``DECODE_STEPS`` steps from 1024) unless
    ``SERVE_RANKS_SHAPES`` says otherwise."""
    return dict({"prompts": PREFILL_PROMPTS, "prompt_len": PREFILL_LEN,
                 "cache_len": PREFILL_MAX_LEN, "first_pos": PREFILL_LEN,
                 "steps": DECODE_STEPS}, **SERVE_RANKS_SHAPES.get(line, {}))


def serve_cells() -> list:
    """Phase 19's cells, one dict a cell: its phase line's name, the
    cell, the config (depth cut where ``SERVE_RANKS_CELLS`` says), the
    grid and the shape (:func:`serve_shape`)."""
    import dataclasses
    from repro_torch.configs import get_config
    out = []
    for line, cell, arch, grid, layers in SERVE_RANKS_CELLS:
        cfg = get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        out.append({"line": line, "cell": cell, "cfg": cfg, "grid": grid,
                    "kind": "serve", "shape": serve_shape(line)})
    return out


def cache_groups(caches) -> list:
    """A model's caches as a list of leaf dicts: a layer-stacked cache as
    one (its leaves lead with the layer axis), a heterogeneous stack's
    per-layer dicts as they are. The attention caches hold ``pos``."""
    return [caches] if isinstance(caches, dict) else list(caches)


def layer0_unwritten(torch, caches):
    """The caches of phase 19's planted fault "layer 0 left unwritten":
    layer 0's entries zero (its state as ``init_caches`` gives it: the
    first layer of every cell is attention, Mamba2 or mLSTM, which start
    at zero), ``pos`` kept. A stacked cache is copied whole; of a list,
    the recurrent layers are copied and the later attention layers shared
    (the fault's decode step writes only the slot that the real step then
    writes again), so that a 524288-slot cache is never held twice."""
    if isinstance(caches, dict):
        fault = {k: c.clone() for k, c in caches.items()}
        for k, c in fault.items():
            if k != "pos":
                c[0] = 0
        return fault
    out = []
    for i, layer in enumerate(caches):
        if i == 0:
            out.append({k: c.clone() if k == "pos" else torch.zeros_like(c)
                        for k, c in layer.items()})
        else:
            out.append(layer if "pos" in layer else
                       {k: c.clone() for k, c in layer.items()})
    return out


def state_change(before: list, after: list) -> float:
    """The planted fault "a recurrent state not written back" at the last
    decode step: for each recurrent layer, its leaves' largest change over
    the step relative to the leaf's largest entry; the smallest over the
    layers (any layer's write skipped reads at least this)."""
    return min(max(float((a[k].float() - b[k].float()).abs().max())
                   / max(float(a[k].float().abs().max()), 1e-30)
                   for k in a) for b, a in zip(before, after))


def serve_ranks_reference(torch, dev, cfg, grid, directory: str,
                          seed: int, shape: dict) -> dict:
    """Phase 19's reference of one cell, on the card in this process:
    the weights drawn from ``seed`` (phase 12's draw, for its MoE), the
    prompts (``shape["prompts"]`` x ``["prompt_len"]`` uniform tokens from
    ``default_rng(seed)``: phase 12's 8 x 1024 but for Zamba2's long
    cell), the prefill into caches of ``["cache_len"]`` slots (the MoE:
    phase 12's stacked grid prefill on ``Ranks(1, 8)``, K1 in the sphere
    shuffle) and ``["steps"]`` greedy steps from position
    ``["first_pos"]`` (the MoE: phase 12's decode, the dense dispatch of
    the whole batch). The planted faults read here: step 0 decoded again
    from the prefill's caches with layer 0 unwritten
    (:func:`layer0_unwritten`); the largest attention cache entry at the
    last step's slot (a write skipped); the recurrent layers' change at
    the last step (:func:`state_change`). Written to ``directory`` for
    the processes: the prompts, the decode's tokens, each call's logits
    (float32, the real vocabulary) and the final caches (bfloat16 as
    their int16 bits; of an attention cache only the written slots,
    ``cache<i>.slots`` their indices)."""
    import numpy as np
    from repro_torch.comm import Ranks
    from repro_torch.models import build
    model = build(cfg)
    v = cfg.vocab
    n_rows, first, steps = (shape["prompts"], shape["first_pos"],
                            shape["steps"])
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = model.init(gen, dev)
    prompts = np.random.default_rng(seed).integers(
        0, v, (n_rows, shape["prompt_len"])).astype(np.int32)
    save_npy(directory, "prompts", prompts)
    toks = torch.from_numpy(prompts).to(dev)
    rk = (Ranks(shape=grid, axes=("data", "model"), device=dev)
          if cfg.family == "moe" else None)
    drops, step_ms, tokens, routes = [], [], [], []
    out = {}
    with torch.inference_mode(), forward_drops(drops), routes_tap(routes):
        caches = model.init_caches(n_rows, shape["cache_len"], dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, caches = model.prefill(params, {"tokens": toks}, caches,
                                   ranks=rk)
        torch.cuda.synchronize()
        out["prefill_ms"] = (time.perf_counter() - t0) * 1e3
        if routes:
            save_npy(directory, "routes_prefill", torch.stack(routes))
            routes.clear()
        logits = [lg[:, -1, :v].float()]
        nxt = logits[0].argmax(-1).to(torch.int32)
        recurrent = [g for g in cache_groups(caches) if "pos" not in g]
        for t in range(steps):
            batch = {"tokens": nxt[:, None], "pos": torch.full(
                (n_rows, 1), first + t, dtype=torch.int32, device=dev)}
            if t == 0:
                fault = layer0_unwritten(torch, caches)
                kept = len(drops)
                lg_f, _ = model.decode_step(params, fault, batch)
                del drops[kept:], fault
                routes.clear()
            if t == steps - 1 and recurrent:
                before = [{k: c.clone() for k, c in g.items()}
                          for g in recurrent]
            tokens.append(nxt)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, caches = model.decode_step(params, caches, batch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            logits.append(lg[:, -1, :v].float())
            if t == 0:
                out["fault_cache_layer0_unwritten"] = float(
                    (lg_f[:, -1, :v].float() - logits[1]).abs().max())
                del lg_f
            nxt = logits[-1].argmax(-1).to(torch.int32)
    attention = [g for g in cache_groups(caches) if "pos" in g]
    last = first + steps - 1
    if attention:
        out["fault_last_write_skipped"] = min(
            float(c[g["pos"] == last].float().abs().max())
            for g in attention for k, c in g.items() if k != "pos")
    if recurrent:
        out["fault_last_state_not_written"] = state_change(before,
                                                           recurrent)
        del before
    if cfg.family == "moe":
        # a planted fault for the routing: each token given its
        # neighbour's experts (the prefill's routing one token off)
        prefill_routes = torch.from_numpy(np.array(load_npy(
            directory, "routes_prefill"))).to(dev)
        out["fault_routes_one_token_off"] = float(moved_choices(
            torch, prefill_routes[..., 1:, :], prefill_routes[..., :-1, :]
        ).sum()) / (prefill_routes[..., 1:, :].numel())
    save_npy(directory, "tokens", torch.stack(tokens))
    if routes:                  # (steps, layers, rows, k)
        save_npy(directory, "routes_decode", torch.stack(routes).reshape(
            steps, cfg.num_layers, n_rows, -1))
    for i, lg in enumerate(logits):
        save_npy(directory, f"logits{i}", lg)
    for i, g in enumerate(cache_groups(caches)):
        idx = None
        if "pos" in g:
            T = g["pos"].shape[-1]
            idx = torch.nonzero((g["pos"].reshape(-1, T) >= 0).any(0))[:, 0]
            save_npy(directory, f"cache{i}.slots", idx)
        for k, c in g.items():
            if idx is not None:
                c = c.index_select(g["pos"].dim() - 1, idx)
            save_npy(directory, f"cache{i}.{k}",
                     c.view(torch.int16) if c.dtype == torch.bfloat16 else c)
    out.update(dropped=drops, decode_step_ms=step_ms,
               decode_step_ms_p50=percentile(step_ms, 50),
               peak_mem_bytes=torch.cuda.max_memory_allocated(),
               logits_finite=all(bool(torch.isfinite(x).all())
                                 for x in logits))
    del params, caches, logits
    return out


def rank_cache_errors(torch, ranks, directory: str, caches, specs,
                      rerouted) -> dict:
    """One process's cache blocks against the reference's: an attention
    cache's ``pos`` equal to the reference's over the block's slots (a
    time block's from its first slot), its written slots' entries
    (bfloat16) within the largest difference returned as
    ``cache_err`` (of the slots of tokens that took the reference's
    experts in every layer, ``rerouted`` marking the others by row and
    slot; all written slots: ``cache_err_all_written``), its empty slots
    zero; a recurrent leaf's largest difference relative to the
    reference's largest entry, ``state_err`` (a state left unwritten
    reads 1)."""
    import numpy as np
    from repro_torch.comm import axis_position
    from repro_torch.models.attention import TimeBlock
    out = {"cache_pos_equal": True, "cache_empty_zero": True}
    dev = ranks.device

    def block(name, spec, dtype):
        w = torch.from_numpy(np.array(ranks.local_shard(
            load_npy(directory, name), spec))).to(dev)
        return w.view(torch.bfloat16) if dtype == torch.bfloat16 else w

    for i, (g, sp) in enumerate(zip(cache_groups(caches),
                                    cache_groups(specs))):
        if "pos" not in g:
            for k, c in g.items():
                want = block(f"cache{i}.{k}", sp[k], c.dtype).float()
                err = float((c.float() - want).abs().max()) / max(
                    float(want.abs().max()), 1e-30)
                out["state_err"] = max(out.get("state_err", 0.0), err)
                by_leaf = out.setdefault("state_err_by_leaf", {})
                by_leaf[k] = max(by_leaf.get(k, 0.0), err)
            continue
        pos = g["pos"]
        ax, T = pos.dim() - 1, pos.shape[-1]
        t0 = (axis_position(ranks, g.axes) * T
              if isinstance(g, TimeBlock) else 0)
        idx = torch.from_numpy(np.array(load_npy(
            directory, f"cache{i}.slots"))).to(dev)
        sel = torch.nonzero((idx >= t0) & (idx < t0 + T))[:, 0]
        local = idx[sel] - t0

        def want(k, dtype):
            # the saved slots carry no time blocks: cut the other dims
            spec = tuple(None if d == ax else e
                         for d, e in enumerate(sp[k]))
            return block(f"cache{i}.{k}", spec, dtype).index_select(ax, sel)
        want_pos = torch.full_like(pos, -1).index_copy_(
            ax, local, want("pos", pos.dtype))
        out["cache_pos_equal"] &= bool(torch.equal(pos, want_pos))
        written = want_pos >= 0
        keep = (rerouted[:, local] == 0).reshape(
            (1,) * (ax - 1) + (pos.shape[ax - 1], local.numel()))
        for k, c in g.items():
            if k == "pos":
                continue
            tail = (1,) * (c.dim() - pos.dim())
            diff = (c.index_select(ax, local).float()
                    - want(k, c.dtype).float()).abs()
            out["cache_err"] = max(out.get("cache_err", 0.0), float(
                (diff * keep.reshape(keep.shape + tail)).max()))
            out["cache_err_all_written"] = max(
                out.get("cache_err_all_written", 0.0), float(diff.max()))
            out["cache_empty_zero"] &= not bool(
                (c * ~written.reshape(written.shape + tail)).any())
    return out


def rank_serve(ranks, directory: str, cfg, seed: int, shape: dict) -> dict:
    """One of phase 19's 8 processes: its blocks of the weights drawn
    from ``seed`` (``init(..., ranks=)``: each tensor whole on the card,
    its block kept) and of the caches (``init_caches(..., ranks=)``), the
    prefill of its data rows of the reference's prompts (every data rank
    the whole row of a batch of one) and the decode teacher-forced on the
    reference's tokens, through ``prefill`` and ``decode_step``; each
    call timed from a barrier to its synchronised end, its collectives
    counted and logged and K1's launches counted; its logits and its
    cache blocks held here against the reference's (what is returned:
    the largest differences, :func:`rank_cache_errors`)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.comm import axis_position
    from repro_torch.kernels import partition
    from repro_torch.models import build
    dev = ranks.device
    model = build(cfg)
    v = cfg.vocab
    n_rows, plen, first = (shape["prompts"], shape["prompt_len"],
                           shape["first_pos"])
    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    params = model.init(gen, ranks=ranks)
    torch.cuda.synchronize(dev)
    out = {"rank": ranks.rank, "init_s": time.perf_counter() - t0,
           "param_bytes": sum(p.numel() * p.element_size()
                              for p in params.parameters()),
           "logits_err": [], "step_ms": [], "counts": [], "k1": []}
    b = n_rows // ranks.axis_size("data") if n_rows > 1 else n_rows
    start = axis_position(ranks, "data") * b if n_rows > 1 else 0
    rows = slice(start, start + b)
    prompts = torch.from_numpy(np.array(
        load_npy(directory, "prompts")[rows])).to(dev)
    tokens = torch.from_numpy(np.array(load_npy(directory, "tokens"))).to(
        dev)[:, rows]
    caches = model.init_caches(n_rows, shape["cache_len"], ranks=ranks)
    out["cache_bytes"] = sum(c.numel() * c.element_size()
                             for g in cache_groups(caches)
                             for c in g.values())
    drops, routes = [], []
    moe = cfg.family == "moe"
    me = axis_position(ranks, "model")
    # each call's routing against the reference's: the expert choices
    # it moved, and the tokens (rows, positions) that took another
    rerouted = torch.zeros((b, shape["cache_len"]), dtype=torch.int32,
                           device=dev)
    out["moved_choices"] = []

    def compare_routes(i):
        if not moe:
            return
        mine = torch.stack(routes)
        routes.clear()
        if i == 0:          # this process's sequence block of every row
            want = torch.from_numpy(np.array(load_npy(
                directory, "routes_prefill")[:, me])).to(dev)
            moved = moved_choices(torch, mine[:, 0], want)
            s_loc = plen // ranks.axis_size("model")
            hit = (moved.sum(0) > 0).reshape(b, s_loc).to(torch.int32)
            rerouted[:, me * s_loc:(me + 1) * s_loc] = hit
            out["moved_choices_prefill_by_layer"] = moved.sum(1).tolist()
        else:
            want = torch.from_numpy(np.array(load_npy(
                directory, "routes_decode")[i - 1][:, rows])).to(dev)
            moved = moved_choices(torch, mine, want)
            rerouted[:, first + i - 1] = (moved.sum(0) > 0).to(torch.int32)
        out["moved_choices"].append(int(moved.sum()))

    def timed(call, i):
        ranks.collectives.clear()
        ranks.log = [] if i <= 1 else None
        before = partition.KERNEL.launches
        dist.barrier()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        lg, new = call()
        torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t0) * 1e3
        out["k1"].append(partition.KERNEL.launches - before)
        out["counts"].append(dict(ranks.collectives))
        if i <= 1:           # the prefill's and the first step's
            out[f"comm_call{i}"] = comm_by_op_axis(ranks.log)
        ranks.log = None
        compare_routes(i)
        want = torch.from_numpy(np.array(load_npy(
            directory, f"logits{i}")[rows])).to(dev)
        out["logits_err"].append(float(
            (lg[:, -1, :v].float() - want).abs().max()))
        return new, ms

    with torch.inference_mode(), forward_drops(drops), routes_tap(routes):
        caches, out["prefill_ms"] = timed(lambda: model.prefill(
            params, {"tokens": prompts}, caches, ranks=ranks), 0)
        for t in range(shape["steps"]):
            batch = {"tokens": tokens[t][:, None], "pos": torch.full(
                (b, 1), first + t, dtype=torch.int32, device=dev)}
            caches, ms = timed(lambda: model.decode_step(
                params, caches, batch, ranks=ranks), t + 1)
            out["step_ms"].append(ms)
    out["peak_mem_bytes"] = torch.cuda.max_memory_allocated(dev)
    out["dropped"] = drops
    if moe:      # the prefill's rerouted positions of every block
        from repro_torch.comm import gather_from
        s_loc = plen // ranks.axis_size("model")
        block = rerouted[:, me * s_loc:(me + 1) * s_loc].contiguous()
        rerouted[:, :plen] = gather_from(ranks, block, "model", 1)
    out["rerouted_tokens"] = int((rerouted > 0).sum())
    out.update(rank_cache_errors(
        torch, ranks, directory, caches,
        model.batch_cache_specs(n_rows, ("data",)), rerouted))
    del params, caches
    return out


def serve_line(cfg, grid, shape, reference_s, spawn_s) -> dict:
    """What phase 19 prints of one cell besides its checks."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import _shard_t
    return {"arch": cfg.arch_id, "family": cfg.family,
            "attn": cfg.attn_type, "layers": cfg.num_layers,
            "published_layers": get_config(cfg.arch_id).num_layers,
            "d_model": cfg.d_model, "heads": cfg.n_heads,
            "kv_heads": cfg.n_kv_heads, "vocab": cfg.vocab,
            "grid": dict(zip(("data", "model"), grid)),
            "processes": math.prod(grid), "backend": "gloo",
            "transport": "gloo over CUDA tensors, chosen by name: 8 "
                         "processes share one card, and NCCL takes one "
                         "card a rank",
            "prompts": shape["prompts"], "prompt_len": shape["prompt_len"],
            "cache_len": shape["cache_len"],
            "decode_positions": [shape["first_pos"],
                                 shape["first_pos"] + shape["steps"] - 1],
            "decode_steps": shape["steps"],
            "cache_time_sharded_over_data": (
                _shard_t(cfg, shape["prompts"]) and grid[0] > 1),
            "teacher_forced_on": "the reference's greedy tokens",
            "reference_kind": (f"stacked Ranks {grid}: phase 12's grid "
                               f"prefill and its decode"
                               if cfg.family == "moe" else "one process"),
            "device": nvidia_smi_line(), "reference_s": reference_s,
            "spawn_s_all_cells": spawn_s}


def check_serve_ranks(cfg, grid, shape, ref, results, bounds) -> tuple:
    """Phase 19's checks of one cell against its reference: every call's
    logits within ``bounds["logits"]``, every written attention cache
    slot within ``["cache"]`` and every recurrent leaf within
    ``["state"]`` relative to its largest entry (each bound below its
    planted fault's reading; a MoE's slots of the tokens that took the
    reference's experts in every layer), ``pos`` equal, empty slots zero;
    a MoE's routing within ``["moved_share"]`` of the reference's expert
    choices and ``moe_dropped`` the reference's at every call that routed
    alike, else within what the moved choices can change (a decode's
    drops depend on the per-expert counts alone, one a moved choice; the
    sphere prefill's on its send and regroup capacities, two); the
    collectives of each decode step ``serve_collectives``', K1 twice a
    MoE layer a prefill in each process and never in a decode step, the
    caches' bytes the specs'. Returns (the checked numbers,
    failures)."""
    from repro_torch.comm import shard_slices
    from repro_torch.models import build
    bad = []
    n_rows, plen, steps = (shape["prompts"], shape["prompt_len"],
                           shape["steps"])
    logits_err = [max(r["logits_err"][i] for r in results)
                  for i in range(steps + 1)]
    got = {"logits": max(logits_err)}
    readings = {"logits": ref["fault_cache_layer0_unwritten"]}
    for what, fault in (("cache", "fault_last_write_skipped"),
                        ("state", "fault_last_state_not_written")):
        if fault in ref:
            got[what] = max(r[f"{what}_err"] for r in results)
            readings[what] = ref[fault]
    for what in got:
        if got[what] > bounds[what]:
            bad.append(f"{what}: {got[what]} > {bounds[what]}")
        if readings[what] <= bounds[what]:
            bad.append(f"{what}: the planted fault reads {readings[what]}, "
                       f"within the bound {bounds[what]}")
    if not all(r["cache_pos_equal"] for r in results):
        bad.append("cache pos differs from the reference's")
    if not all(r["cache_empty_zero"] for r in results):
        bad.append("an empty cache slot is not zero")
    if not ref["logits_finite"]:
        bad.append("the reference's logits are not finite")
    moved = []
    if cfg.family == "moe":
        heads = [r for rank, r in enumerate(results) if rank % grid[1] == 0]
        moved = [sum(r["moved_choices"][0] for r in results)] + [
            sum(r["moved_choices"][i] for r in heads)
            for i in range(1, steps + 1)]
        choices = (n_rows * (plen + steps) * cfg.num_layers
                   * cfg.top_k)
        readings["moved_share"] = ref["fault_routes_one_token_off"]
        if sum(moved) > bounds["moved_share"] * choices:
            bad.append(f"{sum(moved)} of {choices} routed choices differ "
                       f"from the reference's (bound "
                       f"{bounds['moved_share']})")
        if readings["moved_share"] <= bounds["moved_share"]:
            bad.append(f"moved_share: the planted fault reads "
                       f"{readings['moved_share']}, within the bound")
        if any(r["dropped"] != results[0]["dropped"] for r in results):
            bad.append("the processes' moe_dropped differ")
        for i, (n, want) in enumerate(zip(results[0]["dropped"],
                                          ref["dropped"])):
            room = moved[i] * (2 if i == 0 else 1)
            if abs(n - want) > room:
                bad.append(f"call {i}: moe_dropped {n} against the "
                           f"reference's {want}, {moved[i]} choices moved")
    want = serve_collectives(cfg, serve_layout(cfg, grid[1]), grid[0],
                             one_row=n_rows == 1)
    if any(c != want for r in results for c in r["counts"][1:]):
        bad.append(f"decode collectives {results[0]['counts'][1:]} != "
                   f"{want}")
    k1 = [2 * cfg.num_layers if cfg.family == "moe" else 0] + \
        [0] * steps
    if any(r["k1"] != k1 for r in results):
        bad.append(f"K1 launches {[r['k1'] for r in results]} != {k1} a "
                   f"process")
    model = build(cfg)
    whole = cache_groups(model.init_caches(n_rows, shape["cache_len"],
                                           "meta"))
    specs = cache_groups(model.batch_cache_specs(n_rows, ("data",)))
    for rank, r in enumerate(results):
        want_bytes = sum(
            t[shard_slices(t.shape, sp[k], grid, ("data", "model"),
                           rank)].numel() * t.element_size()
            for g, sp in zip(whole, specs) for k, t in g.items())
        if r["cache_bytes"] != want_bytes:
            bad.append(f"process {rank}: cache bytes {r['cache_bytes']} != "
                       f"the specs' {want_bytes}")
    tokens = n_rows * plen
    prefill = max(r["prefill_ms"] for r in results)
    steps = [max(r["step_ms"][t] for r in results)
             for t in range(steps)]
    line = {"logits_max_abs_err_by_call": logits_err,
            "cache_max_abs_err": got.get("cache"),
            "cache_max_abs_err_every_written_slot": max(
                (r.get("cache_err_all_written", 0.0) for r in results)),
            "state_max_rel_err": got.get("state"),
            "state_max_rel_err_by_leaf": {
                k: max(r.get("state_err_by_leaf", {}).get(k, 0.0)
                       for r in results)
                for k in results[0].get("state_err_by_leaf", {})},
            "bounds": bounds, "moved_choices_by_call": moved,
            "moved_choices_prefill_by_layer": [
                sum(layer) for layer in zip(*(
                    r.get("moved_choices_prefill_by_layer", [])
                    for r in results))],
            "rerouted_tokens": results[0]["rerouted_tokens"],
            "planted_fault_readings": readings,
            "moe_dropped_processes": results[0]["dropped"],
            "moe_dropped_reference": ref["dropped"],
            "decode_collectives": want,
            "k1_launches_by_process": [sum(r["k1"]) for r in results],
            "prefill_ms": prefill,
            "prefill_tokens_per_s": tokens / prefill * 1e3,
            "decode_step_ms_p50": percentile(steps, 50),
            "decode_step_ms": steps,
            "reference_prefill_ms": ref["prefill_ms"],
            "reference_decode_step_ms_p50": ref["decode_step_ms_p50"],
            "reference_peak_mem_bytes": ref["peak_mem_bytes"],
            "init_s_max": max(r["init_s"] for r in results),
            "param_bytes_by_process": [r["param_bytes"] for r in results],
            "cache_bytes_by_process": [r["cache_bytes"] for r in results],
            "peak_mem_bytes_by_process": [r["peak_mem_bytes"]
                                          for r in results],
            "comm_prefill_rank0": results[0]["comm_call0"],
            "comm_decode_step_rank0": results[0]["comm_call1"]}
    return line, bad


def cell_file(ready_dir: str, what: str, i: int) -> str:
    """The file by which the parent hands cell ``i`` to the processes
    (``what="cell"``) or the first process reports it done
    (``"done"``)."""
    return os.path.join(ready_dir, f"{what}{i}.pt")


def put_file(path: str, obj) -> None:
    """``torch.save`` of ``obj`` to ``path``, seen whole or not at all."""
    import torch
    torch.save(obj, path + ".tmp", pickle_protocol=4)
    os.replace(path + ".tmp", path)


def wait_file(path: str, abort: str, alive=None) -> None:
    """Poll for ``path``; raise if ``abort`` appears first, or if
    ``alive()`` turns false."""
    while not os.path.exists(path):
        if os.path.exists(abort) or (alive is not None and not alive()):
            raise RuntimeError(f"stopped waiting for {path}")
        time.sleep(0.05)


def rank_train_cells(ranks, ready_dir: str, n_cells: int) -> list:
    """:func:`rank_train` (or phase 19's :func:`rank_serve`) of each cell
    in turn in one process, as soon as
    the parent has handed it over (its kind and arguments in
    ``cell_file(ready_dir, "cell", i)``, written once its reference is
    done), on the cell's ``(data, model)`` grid (a grid other than the
    spawn's built once over the same processes), the card's memory freed
    between them; once every process is done with a cell, the first
    removes its weights' directory and its checkpoints' Sector root (host
    memory: ``/dev/shm``) and reports it done."""
    import torch
    import torch.distributed as dist
    from repro_torch.comm import ProcessRanks
    grids = {tuple(ranks.shape): ranks}
    abort = os.path.join(ready_dir, "abort")
    out = []
    for i in range(n_cells):
        path = cell_file(ready_dir, "cell", i)
        wait_file(path, abort)
        grid, kind, args = torch.load(path, weights_only=False)
        if grid not in grids:
            grids[grid] = ProcessRanks(grid, ranks.axes,
                                       backend=ranks.backend,
                                       device=ranks.device)
        run = rank_serve if kind == "serve" else rank_train
        out.append(run(grids[grid], *args))
        gc.collect()
        torch.cuda.empty_cache()
        dist.barrier()
        if ranks.rank == 0:
            shutil.rmtree(args[0], ignore_errors=True)
            if kind == "train" and args[6] is not None:   # phase 16's
                shutil.rmtree(args[6], ignore_errors=True)
            put_file(cell_file(ready_dir, "done", i), True)
    return out


def grid_cells(torch, seed: int) -> list:
    """The training cells of phases 16, 17 and 18 in the order each
    process trains them, one dict a cell: its phase line's name, the
    cell, its config, grid, batches, optimizer, bounds and held leaves,
    K1's launches a step, whether the reference is the stacked step on
    the grid (else the one process) and whether it reads its own floor
    and the planted faults."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.train.optimizer import AdamWConfig
    launcher = AdamWConfig(lr=TRAIN_LR, warmup_steps=20,
                           total_steps=TRAIN_STEPS)
    # phase 14's MoE cell: its weights, its batch, its optimizer
    moe_cfg, batch, moe_opt = moe_train_setup(torch, seed)
    out = [
        {"line": "train_ranks_families_moe",
         "cell": "train-qwen2-moe-a2.7b-1x8-8proc-1xH100", "cfg": moe_cfg,
         "grid": SERVE_GRID, "stacked": True,
         "batches": [dict(batch) for _ in range(MOE_TRAIN_STEPS)],
         "opt": moe_opt, "bounds": MOE_RANKS_BOUNDS,
         "leaves": MOE_RANKS_GRAD_LEAVES, "floor": False, "faults": True,
         "k1": 4 * moe_cfg.num_layers},
        {"line": "train_ranks",
         "cell": "train-tinyllama-1.1b-2x4-8proc-1xH100",
         "cfg": dataclasses.replace(get_config(TRAIN_ARCH),
                                    num_layers=TRAIN_RANKS_LAYERS),
         "seq": TRAIN_SEQ, "bounds": TRAIN_RANKS_BOUNDS,
         "leaves": TRAIN_GRAD_LEAVES, "floor": True, "faults": False,
         "checkpoint": True},
        {"line": "train_ranks_families_mla",
         "cell": "train-minicpm3-4b-2x4-8proc-1xH100",
         "cfg": dataclasses.replace(get_config(MLA_TRAIN_ARCH),
                                    num_layers=MLA_TRAIN_LAYERS),
         "seq": TRAIN_SEQ, "steps": MLA_TRAIN_STEPS,
         "bounds": MLA_RANKS_BOUNDS, "leaves": MLA_RANKS_GRAD_LEAVES,
         "floor": False, "faults": True}]
    for arch, (cell, layers, leaves) in SSM_RANKS_CELLS.items():
        cfg = get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        out.append({"cell": cell, "cfg": cfg, "seq": SSM_RANKS_SEQ,
                    "bounds": SSM_RANKS_BOUNDS, "leaves": leaves})
    for arch, (cell, cuts, leaves) in ENCDEC_RANKS_CELLS.items():
        cfg = dataclasses.replace(get_config(arch), **cuts)
        seq = WHISPER_PROMPT_LEN if cfg.family == "audio" else VLM_TEXT_LEN
        out.append({"cell": cell, "cfg": cfg, "seq": seq,
                    "bounds": ENCDEC_RANKS_BOUNDS, "leaves": leaves})
    for c in out[3:]:
        c.update(line=f"train_ranks_cells_{c['cfg'].family}", floor=True,
                 faults=True)
    for c in out[1:]:
        c.update(grid=TRAIN_RANKS_GRID, stacked=False, opt=launcher, k1=0)
    out.append({"line": "train_ranks_split_kv",
                "cell": "train-tinyllama-1.1b-1x8-8proc-1xH100",
                "cfg": dataclasses.replace(get_config(TRAIN_ARCH),
                                           num_layers=SPLIT_KV_LAYERS),
                "seq": SPLIT_KV_SEQ, "bounds": SPLIT_KV_BOUNDS,
                "leaves": SPLIT_KV_GRAD_LEAVES, "floor": False,
                "faults": True, "grid": SPLIT_KV_GRID, "stacked": False,
                "opt": launcher, "k1": 0})
    return out


def grid_cut(cfg) -> str:
    """What phases 16-18 cut of ``cfg``'s published config."""
    from repro_torch.configs import get_config
    full = get_config(cfg.arch_id)
    if cfg.family == "audio":
        return (f"encoder and decoder layers {full.enc_layers} + "
                f"{full.num_layers} -> {cfg.enc_layers} + {cfg.num_layers}")
    if cfg.num_layers == full.num_layers:
        return f"none ({cfg.num_layers} layers)"
    return f"layers {full.num_layers} -> {cfg.num_layers}"


def train_grid_path(torch, dev, seed: int) -> dict:
    """Phases 16, 17 and 18 (see the module docstring): one spawn of 8
    processes started first, training every cell in turn as soon as its
    reference on the card is done, while this process computes the next
    reference (one ahead: reference ``i`` waits until cell ``i - 2`` is
    done, so that the card and ``/dev/shm`` hold two cells at a time),
    then each cell's checks. Returns ``{"paths": {line name: line},
    ...}``; every cell is checked and printed before a failure ends the
    run."""
    import tempfile
    from repro_torch.models.registry import meta_params

    t_phase = time.perf_counter()
    out = {"phase": "train_grid", "paths": {}, "references_s": 0.0}
    order = {arch: i for i, arch in enumerate(GRID_CELL_ORDER)}
    cells = sorted(grid_cells(torch, seed),
                   key=lambda c: order[c["cfg"].arch_id]) + serve_cells()
    dirs, failures = [], []
    ready = tempfile.mkdtemp(prefix="chip_smoke_cells_",
                             dir="/dev/shm" if os.path.isdir("/dev/shm")
                             else None)
    spawn = SpawnBeside(ready, rank_train_cells, TRAIN_RANKS_GRID,
                        ("data", "model"), backend="gloo", device=dev.type,
                        timeout_s=GRID_TIMEOUT_S, args=(ready, len(cells)))
    try:
        for i, c in enumerate(cells):
            if i >= 2:
                wait_file(cell_file(ready, "done", i - 2), spawn.abort,
                          spawn.alive)
            if c.get("checkpoint"):
                # phase 16's Sector root: one checkpoint at a time, twice
                # (replication 2), with room to spare
                state = 12 * sum(p.numel() for p in meta_params(
                    c["cfg"]).parameters())
                need = 2 * state + (4 << 30)
                c["ckpt_root"], free, fits = sector_root(need)
                dirs.append(c["ckpt_root"])
                if not fits:
                    raise RuntimeError(f"{c['ckpt_root']} has {free} bytes "
                                       f"free; phase 16's checkpoints need "
                                       f"{need}")
            dirs.append(ranks_dir())
            t0 = time.perf_counter()
            if c.get("kind") == "serve":
                with torch.inference_mode():
                    c["ref"] = serve_ranks_reference(
                        torch, dev, c["cfg"], c["grid"], dirs[-1], seed,
                        c["shape"])
                handed = ("serve", (dirs[-1], c["cfg"], seed, c["shape"]))
            else:
                if "batches" not in c:
                    c["batches"] = train_ranks_batches(
                        torch, c["cfg"], c["seq"],
                        c.get("steps", TRAIN_RANKS_STEPS), dev,
                        seed)
                c["ref"] = train_ranks_reference(
                    torch, dev, c["cfg"], c["batches"], c["opt"], dirs[-1],
                    c["leaves"], grid=c["grid"] if c["stacked"] else None,
                    floor=c["floor"], faults=c["faults"])
                handed = ("train", (dirs[-1], c["batches"], c["opt"],
                                    sum(c["ref"]["lrs"]), c["cfg"],
                                    c["leaves"], c.get("ckpt_root")))
            c["reference_s"] = time.perf_counter() - t0
            out["references_s"] += c["reference_s"]
            gc.collect()
            torch.cuda.empty_cache()
            put_file(cell_file(ready, "cell", i), (c["grid"],) + handed)
        per_rank, spawn_s = spawn.join()
    except BaseException as e:
        spawn.stop(e)
    finally:
        for d in dirs + [ready]:
            shutil.rmtree(d, ignore_errors=True)
    out["spawn_s"] = spawn_s
    for i, c in enumerate(cells):
        if c.get("kind") == "serve":
            results = [r[i] for r in per_rank]
            line, bad = check_serve_ranks(c["cfg"], c["grid"], c["shape"],
                                          c["ref"], results,
                                          SERVE_RANKS_BOUNDS[c["line"]])
            out["paths"][c["line"]] = {
                "cell": c["cell"], "cut": grid_cut(c["cfg"]),
                **serve_line(c["cfg"], c["grid"], c["shape"],
                             c["reference_s"], spawn_s), **line}
            failures += [f"{c['cell']}: {f}" for f in bad]
            continue
        cfg, batches, ref = c["cfg"], c["batches"], c["ref"]
        results = [r[i] for r in per_rank]
        positions = batches[0]["tokens"].shape[1] + (
            cfg.img_tokens if cfg.family == "vlm" else 0)
        for r in results:
            r["seq"] = positions
        line = {"cell": c["cell"], "cut": grid_cut(cfg),
                "reference_kind": (f"stacked Ranks {c['grid']}, phase 14's "
                                   f"step" if c["stacked"] else
                                   "one process"),
                "positions_per_row": positions,
                "spawn_s_all_cells": spawn_s,
                **ranks_phase_line(cfg, c["grid"], ref, results, batches,
                                   c["reference_s"], spawn_s)}
        if cfg.family == "moe":
            line.update(experts=cfg.num_experts, top_k=cfg.top_k,
                        capacity_factor=cfg.capacity_factor,
                        reference_moe_metrics=ref["metrics"])
        if cfg.attn_type == "mla":
            line["heads_per_rank"] = cfg.n_heads // c["grid"][1]
        if c["line"] == "train_ranks_split_kv":
            line.update(layout="split_kv", kv_columns_per_rank=(
                cfg.n_kv_heads * cfg.hd // c["grid"][1]))
        if cfg.family == "audio":
            half = TRAIN_BATCH // c["grid"][0]
            line["encoder_frames"] = cfg.enc_seq
            line["unmasked_tokens_by_step_and_data_rank"] = [
                [int(b["loss_mask"][d * half:(d + 1) * half].sum())
                 for d in range(c["grid"][0])] for b in batches]
        checks, bad = check_train_ranks(
            torch, cfg, c["grid"], ref, results, c["leaves"], c["bounds"],
            c["k1"], "loss_mask" in batches[0])
        line.update(checks)
        if c.get("checkpoint"):
            line["checkpoint"], ck_bad = check_rank_checkpoint(cfg, results)
            bad = bad + [f"checkpoint: {f}" for f in ck_bad]
        line["k1_launches"] = sum(sum(r["k1_launches"]) for r in results)
        out["paths"][c["line"]] = line
        failures += [f"{c['cell']}: {f}" for f in bad]
    out["phase_s"] = time.perf_counter() - t_phase
    if failures:
        for name, line in out["paths"].items():
            log(json.dumps({"phase": name, **line}))
        raise AssertionError("phases 16-18: " + "; ".join(failures))
    return out


# -- phase 20: the dry run held to the card -----------------------------------


def train_ranks_trace(path: str) -> None:
    """Phase 16's steps traced by the dry run, each cell of
    ``DRYRUN_CELLS`` in turn (run in a process of its own: the trace
    holds a fake default process group), their measurements written to
    ``path`` as JSON by phase line."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun
    out = {}
    for line, (layers, grid, seq) in DRYRUN_CELLS.items():
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(TRAIN_ARCH), num_layers=layers)
        got = dryrun.trace(cfg, ShapeSpec(line, seq, TRAIN_BATCH, "train"),
                           grid, ("data", "model"), zero1=True,
                           master=False)
        out[line] = {"calls": got["collectives"]["calls"],
                     "peak_live_bytes": got["peak_live_bytes"],
                     "state_live_bytes": got["state_live_bytes"],
                     "counted_flops": got["flops"],
                     "trace_s": time.perf_counter() - t0}
    with open(path, "w") as f:
        json.dump(out, f)


def start_dryrun_trace() -> tuple:
    """:func:`train_ranks_trace` started in a subprocess on the CPU:
    ``(process, result path, start time)``."""
    import tempfile
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    atexit.register(shutil.rmtree, out_dir, True)
    path = os.path.join(out_dir, "trace.json")
    with open(os.path.join(out_dir, "output.txt"), "w") as output:
        proc = subprocess.Popen(
            [sys.executable, "-c",
             f"import chip_smoke; chip_smoke.train_ranks_trace({path!r})"],
            cwd=HERE, stdout=output, stderr=subprocess.STDOUT)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc, path, time.perf_counter()


def dryrun_check(started: tuple, lines: dict) -> dict:
    """Phase 20: the traces of :func:`start_dryrun_trace` against the
    lines of ``DRYRUN_CELLS`` (``{phase line: line}``): each trace's
    collectives equal to its cell's process 0's logged step, and its
    peak live bytes within ``DRYRUN_PEAK_SHARE`` of each process's;
    raises on a mismatch, after printing the comparisons."""
    proc, path, t0 = started
    proc.wait(timeout=600)
    waited = time.perf_counter() - t0
    if proc.returncode != 0:
        with open(os.path.join(os.path.dirname(path), "output.txt")) as f:
            text = f.read()
        raise AssertionError(f"phase 20: the dry run's trace failed:\n"
                             f"{text[-4000:]}")
    with open(path) as f:
        traced = json.load(f)
    out, bad = {}, []
    for name, line in lines.items():
        got = traced[name]
        card = {k: {"calls": v["calls"], "bytes": v["bytes"]}
                for k, v in line["comm_last_step_rank0"].items()}
        peaks = line["peak_mem_bytes_by_process"]
        shares = [(p - got["peak_live_bytes"]) / p for p in peaks]
        out[name] = {
            "phase": "dryrun_check" + name[len("train_ranks"):],
            "cell": line["cell"], "device": nvidia_smi_line(),
            "trace_s": got["trace_s"], "subprocess_wall_s": waited,
            "collectives_trace": got["calls"],
            "collectives_card_process0": card,
            "collectives_equal": got["calls"] == card,
            "peak_live_bytes_trace": got["peak_live_bytes"],
            "peak_mem_bytes_by_process": peaks,
            "peak_share_above_trace_by_process": shares,
            "peak_share_bound": DRYRUN_PEAK_SHARE,
            "state_live_bytes_trace": got["state_live_bytes"],
            "mem_at_reset_bytes_by_process":
                line["mem_at_reset_bytes_by_process"],
            "counted_flops_trace": got["counted_flops"]}
        log(json.dumps(out[name]))
        if not out[name]["collectives_equal"]:
            bad.append(f"{name}: the trace's collectives differ from the "
                       f"processes' log")
        if max(abs(x) for x in shares) > DRYRUN_PEAK_SHARE:
            bad.append(f"{name}: peak memory: the trace's "
                       f"{got['peak_live_bytes']} against {peaks} (shares "
                       f"{shares})")
    if bad:
        raise AssertionError("phase 20: " + "; ".join(bad))
    return out


def check_rank_moe(torch, results, m) -> dict:
    """Each process's block against the stacked layer: routing, per-expert
    counts and drops exact, ``moe_aux`` within 1e-6 relative, the output
    within ``MOE_RANKS_TOL`` of the stacked output's largest value (one
    bfloat16 ulp there: 8 experts a batched product instead of 64 may
    take another cuBLAS algorithm)."""
    from repro_torch.comm import grid_coords
    want = m["out"]
    b, s, d = want.shape
    k = m["top_i"].shape[-1]
    top = m["top_i"].reshape(b, s, k)
    cols = SERVE_GRID[1]
    scale = want.float().abs().max().item()
    err = 0.0
    per_expert = torch.zeros(m["e_pad"], dtype=torch.int64)
    for rank, r in enumerate(results):
        x = r["moe"]
        _, c = grid_coords(SERVE_GRID, rank)
        sl = (slice(None), slice(c * (s // cols), (c + 1) * (s // cols)))
        if not torch.equal(x["top_i"], top[sl].reshape(-1, k)):
            bad = int((x["top_i"] != top[sl].reshape(-1, k)).any(-1).sum())
            raise AssertionError(f"MoE rank {rank}: {bad} tokens routed "
                                 f"otherwise than on stacked ranks")
        if x["dropped"] != m["dropped"]:
            raise AssertionError(f"MoE rank {rank}: dropped {x['dropped']} "
                                 f"!= {m['dropped']}")
        if abs(x["aux"] - m["aux"]) > 1e-6 * abs(m["aux"]):
            raise AssertionError(f"MoE rank {rank}: moe_aux {x['aux']} != "
                                 f"{m['aux']}")
        e = (x["out"].float() - want[sl].float()).abs().max().item()
        err = max(err, e)
        if e > MOE_RANKS_TOL * scale:
            raise AssertionError(f"MoE rank {rank}: |process - stacked| = "
                                 f"{e} > {MOE_RANKS_TOL} x {scale}")
        if x["experts_held"] != m["e_pad"] // cols:
            raise AssertionError(f"MoE rank {rank} holds "
                                 f"{x['experts_held']} experts")
        per_expert += torch.bincount(x["top_i"].reshape(-1).long(),
                                     minlength=m["e_pad"])
        want_counts = dict(m["collectives"])
        want_counts["psum"] = want_counts.get("psum", 0) + 1
        if x["collectives"] != want_counts:
            raise AssertionError(f"MoE rank {rank}: collectives "
                                 f"{x['collectives']} != {want_counts}")
        if x["launches"]["partition"] != 2:
            raise AssertionError(f"MoE rank {rank}: K1 launched "
                                 f"{x['launches']['partition']} times")
    full = torch.bincount(m["top_i"].reshape(-1).long(),
                          minlength=m["e_pad"])
    if not torch.equal(per_expert, full):
        raise AssertionError("MoE per-expert counts differ")
    return {"max_abs_err": err, "out_max_abs": scale,
            "tolerance": MOE_RANKS_TOL * scale, "dropped": m["dropped"],
            "aux": m["aux"], "capacity_factor": m["capacity_factor"],
            "experts_per_process": results[0]["moe"]["experts_held"],
            "expert_bytes_per_process": results[0]["moe"]["expert_bytes"],
            "tokens": [b, s], "per_expert_tokens_max": int(full.max())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-log2", type=int, default=25,
                    help="log2 of the record count of the sort paths (the "
                         "wordcount reads twice as many words)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="also profile two warm reruns of the flat, the "
                         "wide-area and the wordcount path and a train "
                         "step of each phase-14 cell, and write their "
                         "traces to DIR")
    args = ap.parse_args(argv)

    t_script = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    log(f"device: {smi} | torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    built = build.build_all([k.name for k in kernels()])
    log(json.dumps({"phase": "build", "seconds": time.perf_counter() - t0,
                    "per_source_s": {k: r.seconds for k, r in built.items()}}))
    for name, r in built.items():
        for line in r.ptxas:
            log(f"  {name}: {line}")
    # phase 20's trace, on the CPU beside the phases on the card
    dryrun_trace = start_dryrun_trace()

    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    sh = Shapes(args.n_log2)
    # phase 7's words, drawn first: phase 3 draws K2's Zipf rows from them
    words, gen_s = draw_words(args.seed, sh.words)
    checks = {"partition": check_partition(torch, dev, gen, sh),
              "bitonic_sort": check_sort(torch, dev, gen, "bitonic_sort",
                                         [sh.recv, sh.recv_grid], sh.recv,
                                         stage2_real=sh.n_local),
              "radix_sort": check_sort(torch, dev, gen, "radix_sort",
                                       [sh.recv, sh.wc_recv], sh.wc_recv),
              "bucket_hist": check_bucket_hist(torch, dev, gen, sh)}
    new_shapes = check_new_shapes(torch, dev, gen, sh, checks, words)
    for name, (chk, timing) in checks.items():
        log(json.dumps({"phase": "kernel_check", "name": name,
                        "cases": chk.cases, "max_abs_err": chk.max_abs_err,
                        **timing}))
    log(json.dumps({"phase": "kernel_check_new_shapes",
                    "shapes": new_shapes}))
    torch.cuda.empty_cache()

    keys, value = make_records(torch, dev, gen, sh.n)
    # phase 15's inputs, written once (its processes read their rows)
    rdir = ranks_dir()
    atexit.register(shutil.rmtree, rdir, True)
    save_npy(rdir, "keys", keys)
    save_npy(rdir, "value", value)
    k4 = entry_point_k4(torch, dev, keys)
    log(json.dumps(k4))
    mp, flat_sorted = main_path(torch, keys, value, args.profile)
    log(json.dumps(mp))
    wide = grid_path(torch, keys, value, flat_sorted, args.profile)
    log(json.dumps(wide))
    host_codec, host_slices = host_input(torch, keys, value)
    host_flat = flat_sorted.cpu()
    save_npy(rdir, "flat_sorted", host_flat)
    del keys, value, flat_sorted
    torch.cuda.empty_cache()
    save_npy(rdir, "words", words)
    wc = wordcount_path(torch, dev, words, gen_s, sh, args.profile)
    log(json.dumps(wc))
    shim, radix_launches = shim_runs(torch, dev, gen, args.n_log2)
    log(json.dumps({"phase": "terasort_shim", **shim}))
    t0 = time.perf_counter()
    host = host_path(torch, dev, host_codec, host_slices, host_flat, checks,
                     args.profile)
    host["phase_s"] = time.perf_counter() - t0
    log(json.dumps(host))
    # phase 10 keeps its sizes at any --n-log2: phase 7's words at the
    # default, its own 2^26 words from the same seed otherwise
    stream_words = (words if words.size == STREAM_WORDS
                    else draw_words(args.seed, STREAM_WORDS)[0])
    stream = stream_storm(torch, stream_words, args.profile)
    del stream_words
    log(json.dumps(stream))
    chaos = batch_chaos(torch, dev, host_codec, host_slices, host_flat, words)
    log(json.dumps(chaos))
    del host_slices, host_flat, words
    torch.cuda.empty_cache()
    with torch.inference_mode():
        served = serve_path(torch, dev, args.seed)
    log(json.dumps(served))
    t0 = time.perf_counter()
    with torch.inference_mode():
        zoo = zoo_path(torch, dev, args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    log(json.dumps({"phase": "serve_model_zoo_total",
                    "models": [r["arch"] for r in zoo],
                    "launches": [r["launches"] for r in zoo],
                    "phase_s": time.perf_counter() - t0}))
    trained = train_path(torch, dev, args.seed, args.profile)
    log(json.dumps({k: v for k, v in trained.items()
                    if k not in ("tinyllama", "moe", "profile")}))
    gc.collect()
    torch.cuda.empty_cache()
    flat_sorted = load_tensor(torch, rdir, "flat_sorted", dev)
    ranked = ranks_path(torch, dev, rdir, args.seed, flat_sorted)
    del flat_sorted
    shutil.rmtree(rdir, ignore_errors=True)
    for tag, p in ranked.pop("paths").items():
        log(json.dumps({"phase": f"ranks_{tag}", **p}))
    log(json.dumps(ranked))
    gc.collect()
    torch.cuda.empty_cache()
    grid = train_grid_path(torch, dev, args.seed)
    for name, p in grid["paths"].items():
        log(json.dumps({"phase": name, **p}))
    log(json.dumps({k: grid[k] for k in ("phase", "references_s",
                                         "spawn_s", "phase_s")}))
    dryrun_check(dryrun_trace, {k: grid["paths"][k] for k in DRYRUN_CELLS})
    phase11 = {r["run"]: r["launches"] for r in chaos["runs"]}
    host_faults = {r["run"]: r["launches"] for r in chaos["host"]}

    paths = {
        "partition": {"dataflow sort, flat": mp["launches"]["partition"],
                      "dataflow sort, (dc, node)":
                          wide["launches"]["partition"],
                      "wordcount": wc["launches"]["partition"],
                      "host terasort over Sector, bucket split":
                          host["launches"]["partition"],
                      "stream storm, shuffle":
                          stream["storm"]["launches"]["partition"],
                      **{f"batch chaos: {k}": v["partition"]
                         for k, v in phase11.items()},
                      **{f"host sort, {k}, bucket split": v["partition"]
                         for k, v in host_faults.items()},
                      "Qwen1.5-MoE-A2.7B grid prefill on (1, 8), 24 MoE "
                      "layers: send pack + regroup":
                          served["prefill_k1_launches"],
                      f"Qwen1.5-MoE-A2.7B training on (1, 8), "
                      f"{MOE_TRAIN_LAYERS} MoE layers, {MOE_TRAIN_STEPS} "
                      f"steps with remat: send pack + regroup, forward and "
                      f"recompute": trained["moe"]["k1_launches"],
                      **{f"8 processes: {what}": ranked["launches"][tag][
                          "partition"] for tag, what in RANKED_PATHS},
                      f"8 processes: Qwen1.5-MoE-A2.7B training on (1, 8), "
                      f"{MOE_TRAIN_LAYERS} MoE layers, {MOE_TRAIN_STEPS} "
                      f"steps with remat: send pack + regroup, forward and "
                      f"recompute": grid["paths"]["train_ranks_families_moe"][
                          "k1_launches"],
                      "8 processes: Qwen1.5-MoE-A2.7B served on (1, 8), "
                      "the prefill's 24 MoE layers: send pack + regroup":
                          sum(grid["paths"]["serve_ranks_moe"][
                              "k1_launches_by_process"])},
        "bitonic_sort": {"dataflow sort, flat": mp["launches"]["bitonic_sort"],
                         "dataflow sort, (dc, node)":
                             wide["launches"]["bitonic_sort"],
                         **{f"batch chaos: {k}": v["bitonic_sort"]
                            for k, v in phase11.items()
                            if v["bitonic_sort"]},
                         **{f"8 processes: {what}": ranked["launches"][tag][
                             "bitonic_sort"] for tag, what in RANKED_PATHS
                            if tag in ("flat", "grid")}},
        "radix_sort": {"wordcount reduce_by_key_sum(algo='radix')":
                           wc["launches"]["radix_sort"],
                       "terasort sort_algo='radix'": radix_launches,
                       "host terasort over Sector, stage-2 sort":
                           host["launches"]["radix_sort"],
                       "stream storm, reduce":
                           stream["storm"]["launches"]["radix_sort"],
                       **{f"batch chaos: {k}": v["radix_sort"]
                          for k, v in phase11.items() if v["radix_sort"]},
                       **{f"host sort, {k}, stage-2 sort": v["radix_sort"]
                          for k, v in host_faults.items()},
                       "8 processes: wordcount": ranked["launches"][
                           "wordcount"]["radix_sort"]},
        "bucket_hist": {"kernels.ops.bucket_histogram (entry point; on no "
                        "dataflow path, as in the JAX package)":
                            k4["launches"]["bucket_hist"]},
    }
    rows = []
    for k in kernels():
        chk, timing = checks[k.name]
        rows.append({
            "name": k.name, "route": "cuda", "source": k.source,
            "replaces": k.replaces,
            "launches": sum(paths[k.name].values()),
            "launches_by_path": paths[k.name],
            "path": " + ".join(paths[k.name]),
            "max_abs_err": chk.max_abs_err, "tolerance": 0,
            "ms": timing["ms"],
            "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
            "bound_by": "bytes", "library_ms": timing["library_ms"],
            "shape": timing["shape"], "check": "ok"})
        if k.name == "radix_sort":
            rows[-1]["cuda_launches_per_call"] = \
                timing["cuda_launches_per_call"]
            rows[-1]["shapes"] = [
                {f: r[f] for f in ("data", "shape", "ms", "plain_ms",
                                   "library_ms", "bound_ms")}
                for r in (timing, wc["k2_on_path_rows"],
                          *timing["other_shapes"])]
        if k.name == "partition":
            rows[-1]["cuda_launches_per_call"] = \
                timing["cuda_launches_per_call"]
            rows[-1]["memsets_per_call"] = timing["memsets_per_call"]
            rows[-1]["shapes"] = [
                {f: r[f] for f in ("path", "shape", "num_dest", "ms",
                                   "profiler_ms", "bound_ms")}
                for r in timing["shapes"]]
        if k.name == "bucket_hist":
            rows[-1]["cuda_launches_per_call"] = \
                timing["cuda_launches_per_call"]
            rows[-1]["memsets_per_call"] = timing["memsets_per_call"]
            rows[-1]["shapes"] = [
                {f: r[f] for f in ("shape", "num_buckets", "ms",
                                   "profiler_ms", "plain_ms", "library_ms",
                                   "bound_ms")}
                for r in (timing, timing["one_row"])]
        if k.name == "bitonic_sort":
            rows[-1]["cuda_launches_per_call"] = \
                timing["cuda_launches_per_call"]
            rows[-1]["on_path_rows"] = [
                {f: r[f] for f in ("shape", "ms", "plain_ms", "library_ms",
                                   "bound_ms")}
                for r in timing["on_path_rows"]]
    log(json.dumps({"phase": "total", "seconds":
                    time.perf_counter() - t_script}))
    log(json.dumps({"kernels": rows}))
    log(nvidia_smi_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
