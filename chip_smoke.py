#!/usr/bin/env python3
"""Drive horovod_tpu_torch's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # one GPU
    python3 chip_smoke.py --gpus 4   # and then across 4 GPUs

Phases, each fatal on failure (exit code 1, no result line):

1. versions, and the card's name and power limit from nvidia-smi;
2. build the CUDA kernels from ``horovod_tpu_torch/ops/csrc`` (one nvcc
   per source, started together; nvcc's release line, and each kernel's
   registers and spills from ``-Xptxas -v``);
3. small-input check: three ZeRO-1 int8 + error-feedback steps of a
   narrow ResNet on the GPU agree with the same steps on the CPU (a
   child process, plain versions, gloo);
4. end to end: ResNet-50 at full width (224x224x3, 1000 classes, bf16
   compute, f32 parameters), batch 64, random weights from a seed, a
   world of one over NCCL: (a) ZeRO-1 + int8 + EF + fused Adam, 10 steps;
   (b) allreduce mode + int8 + EF + fused Adam, 5 steps. Losses must be
   finite and fall on the repeated batch, and every kernel of each run's
   path must have launched during it; fused Adam exactly once a step
   (one multi-tensor launch over the flat shard, or over the 161 leaves,
   ``ops.kernels.ADAM_MAX_LEAVES`` a launch). Allreduce mode exchanges the
   tree fused: exactly one ``quantize`` (its roundtrip serves the error
   feedback and the wire), one ``dequant_accumulate_requantize`` and one
   ``dequantize_rows`` a step over the 76 quantizable leaves laid side by
   side as ``[N, S]``, and exactly 5 NCCL calls in the optimizer update
   (two ``all_to_all`` and two ``all_gather`` of the int8 group, one
   ``all_reduce`` of the 85 small f32 leaves; the step's running-stats
   and loss allreduces are counted apart), counted by wrapping the
   ``torch.distributed`` functions ``ops/collective.py`` calls. Every
   kernel-wrapper call of the run is logged with its shape;
5. with ``--gpus N``: phase 4 again across N GPUs of the host (one process
   per GPU, NCCL, each rank on its own 64 rows of one global batch, 4
   steps per mode), and the ZeRO-3 and Adasum runs of phase 7; every rank
   must report the same falling losses and the same parameters;
6. kernels: every call of one step of each run above is replayed on
   fresh inputs at its own shape (the flat buffer's quantize, allreduce
   mode's one quantize, requantize and dequantize over its ``[N, S]``
   buffer, the one Adam launch over the 161 leaves, each gradient at its
   logged offset from a 16-byte boundary, ...) and held against the
   plain PyTorch version:
   bit for bit for the int8 wire, within 2 ULP for every leaf of fused
   Adam, a NaN meeting a NaN. The inputs carry all-zero blocks, exact half-way
   quotients, NaN and infinite blocks. Each mode's replay is timed with
   CUDA events (kernel, plain version, and for fused Adam
   ``torch._fused_adam_`` over the same tensors as a yardstick) beside
   the sum of the calls' bounds; the kernel's replay also as
   ``device_ms``, queued behind a sleep of the card so that the wrappers'
   host time drops out (back to back, ``ms`` reads the slower of the
   host and the card). The 152 quantizes and 76 requantizes
   allreduce mode made a step before its exchange was fused (two per
   quantizable leaf, one per leaf) are replayed and timed the same way,
   as the yardstick of the fused calls (``per_leaf_yardstick`` of the
   ``quantize`` and ``dequant_accumulate_requantize`` rows, outside
   their ``ms``). The requantize's inputs at two or more senders also
   carry a block whose sum has exact half-way quotients. ResNet-50's flat
   buffer is also checked with a tail that does not divide the block and
   with eight synthetic senders (the requantize dividing by none, 3, 6
   and 8), and fused Adam's int8 requantize epilogue (which no training
   path calls) bit for bit at ZeRO-1's shard length, 25,557,032;
7. ZeRO-3 and Adasum on the ResNet-50 step, one GPU: (a) ``zero3``,
   ``DistributedOptimizer(fused_adam(1e-3), shard_params=True)`` with the
   int8 parameter gather (``HOROVOD_FSDP_WIRE=int8``), 10 steps: exactly
   2 ``quantize`` and 2 ``dequantize_rows`` launches a step (the gather
   and the backward's re-gather of the one f32 group) and 1
   ``fused_adam``; img/s and peak memory beside ZeRO-1's. Every ResNet-50
   run ends with one more step split at ``make_train_step``'s phase hook
   (forward, backward, optimizer, loss allreduce) by synchronised host
   timers. (b) ``adasum``,
   ``DistributedOptimizer(fused_adam(1e-3), op=Adasum)``, 5 steps: at a
   world of one the butterfly has no level, so no Adasum kernel runs.
   (c) the Adasum level-1 replay: ResNet-50's gradient trees on the two
   64-row halves of one 128-row batch (rank 0's and rank 1's of a world
   of two) go through the combine rank 0 makes at level 1, by the port's
   own functions: ``_segment_combine`` over the 25,557,032-element f32
   group (161 segments); ``adasum_pair_combine_packed`` over the 161
   leaves packed (``_leaf_table``, ``_pack``) in bf16 (what ``Compression.fp16`` puts
   on the wire) and in f16, one call each; and ``_pair_combine`` per leaf
   in bf16, f16 and f32. The calls are logged; the grouped and the packed
   bf16 ones are counted as the replay's launches, and the 161 per-leaf
   bf16 calls (the compressed route's combines when it ran leaf by leaf)
   are timed as
   the ``per_leaf_yardstick`` of the ``adasum_pair_combine`` row, outside
   its per-step numbers. Every combine is held against its plain version
   on these same correlated operands (where the projection term is
   large); each leaf of the packed combine must equal its per-leaf
   combine bit for bit, in bf16 and f16, and the grouped result the
   per-leaf f32 one (their chunks coincide). With ``--gpus N`` ZeRO-3
   int8, Adasum grouped (``adasum``) and Adasum compressed
   (``adasum_fp16``: ``DistributedOptimizer(fused_adam(1e-3), op=Adasum,
   compression=Compression.fp16)``, the leaves packed in bf16) run 4
   steps each across the N GPUs: every rank the same losses and the same
   unpacked parameters, ``adasum_segment_combine`` launched log2(N) times
   a step by ``adasum`` and ``adasum_pair_combine`` log2(N) times a step
   by ``adasum_fp16``, the other combine never, and each update making
   log2(N) point-to-point exchanges (``batch_isend_irecv``).
   The kernel phase replays these calls too: ``dequantize_rows`` bit for
   bit (NaN and infinite scale blocks included), the Adasum combines
   within rtol 2e-5 / atol 2e-6 (a 16-bit output also within one ULP of
   its type, the f32 value's rounding boundary) and bit-identical across
   two launches; and shapes the path does not give: 8 synthetic senders
   for ``dequantize_rows``, zero operands, lengths that are not a
   multiple of any tile, an operand at an odd element offset, a segment
   of length 1 and an empty one;
8. the LM slice (one GPU, NCCL world of one, matmuls in full f32 where
   f32: TF32 off): TransformerLM at the flagship configuration's full
   width (vocab 32000, dim 1024, depth 12, 16 heads of 64, RoPE, flash
   attention, bf16 compute, f32 parameters, 216,643,584 of them), batch
   8 x 2048 tokens from ``np.random.RandomState(0)``, targets rolled by
   one, ``DistributedOptimizer(adamw(1e-4))`` + ``lm_xent``, 8 steps.
   Losses must be finite and fall on the repeated batch, and the
   ``flash_fwd`` kernel must have launched exactly 12 times a step. It
   prints tokens/s per GPU over steps 2-8 and one more step of the same
   step function split into forward (with the kernel), backward (the
   plain flash backward inside), optimizer and loss allreduce by
   synchronised host timers at ``make_train_step``'s phase hook; the
   plain flash backward of the step's 12 calls is timed alone with CUDA
   events. The kernel phase
   replays the 12 logged ``flash_fwd`` calls of the last step at their
   own shapes and strides against ``flash_fwd_plain`` (``out`` within
   one bf16 ULP, ULPs below 2^-8's counted as 2^-8's, and the elements
   that floor lets through counted; ``lse`` within 1e-5 relative, 1e-5
   absolute below 1: the two sum in different f32 orders), and times them beside ``F.scaled_dot_product_attention``
   over the same tensors (a yardstick the port never calls; it emits no
   lse). Shapes the path does not give are checked too: GQA (16 query
   heads on 4 kv heads), non-causal, T = 1000 (not a multiple of the
   tile), head dim 128 (all four on the bf16 tensor-core kernel), f32
   inputs (the f32 kernel). The build's ``-Xptxas -v`` report gives each
   kernel's registers and spills (``ptxas`` in the ``kernels`` line);
9. the reference's other scaling models (``bench.py --model``), one GPU,
   batch 64, bf16 compute, f32 parameters, random weights, 5 steps each:
   VGG-16 (224x224x3, 32 leaves, 138,357,544 parameters; ``fc0/kernel``
   alone 102,760,448) in ZeRO-1 and in allreduce mode, Inception V3
   (299x299x3, 284 leaves) in ZeRO-1, all int8 + EF + fused Adam (at
   3e-5 for VGG-16, which has no BatchNorm, :data:`ZOO_RUNS`; 1e-3
   elsewhere) (``vgg16_zero1``, ``vgg16_allreduce``,
   ``inception3_zero1``): losses
   finite and falling, the launches :func:`expected_launches` gives for
   their leaf counts, img/s and peak memory; their logged calls go
   through the kernel phase (VGG-16's 138.4 M-element flat buffer,
   the largest any kernel sees, bit for bit) under their own name in
   each row's ``by_mode``, outside the per-step sums;
10. checkpoint save and restore, one GPU, in a child process
   (``torch.use_deterministic_algorithms(True)``, ``CUBLAS_WORKSPACE_
   CONFIG`` set before CUDA starts): ResNet-50 ZeRO-1 + int8 + EF, batch
   64, 3 steps; ``CheckpointManager.save(asynchronous=True)``, one more
   step while it writes, ``wait_until_finished``; a restore into a model
   of other random weights and a fresh state (``consolidate_opt_state``)
   bit-equal, leaf for leaf (params, running stats, count, mu, nu,
   residual), to the state at the save call; 3 steps from it and 3 from
   the saved state kept in memory, losses and every leaf bit-equal; the
   bytes written (``state_nbytes``), the seconds of a synchronous save,
   of the asynchronous save's block of its caller and of a restore; a
   truncated copy and a copy with a NaN leaf skipped by ``latest_step``.
   With ``--gpus N``: a ZeRO-1 state of the N ranks saved, each rank
   into its own directory of which only rank 0's is written (the rows
   gathered to ``[N, s]``), restored on the N bit for bit, and restored
   in a world of one through ``consolidate_opt_state(to_size=1)`` for 2
   steps with finite losses. The checkpoints live in the git-ignored
   ``_smoke_ckpt/`` of the checkout, removed at the end;
11. Horovod's own PyTorch API (``import horovod_tpu_torch.torch as hvd``)
   with the native core, one GPU: the core (``csrc/`` built with g++
   beside the kernels) attached by ``hvd.init(native_core=True)``;
   one forward and backward of ResNet-50 (full width and depth, batch
   64), each of its 161 gradients enqueued by name with
   ``allreduce_async_`` from its post-accumulate-grad hook. Each result
   bit-equal to a sync ``allreduce`` of a copy saved in the hook; NCCL
   ``all_reduce`` calls equal to the plans the core ran, at least 2
   (102.2 MB over the 64 MB threshold); named allgather, broadcast,
   alltoall and reducescatter equal to their sync forms; ``join()`` 0;
   a duplicate name refused. Prints the plans, the cycles the run
   spanned and the time from the last hook to the last completion, and
   the img/s of phase 12's Average steps at this world of one (no hooks,
   no exchange: their baseline);
12. with ``--gpus N``: the frontend trains ResNet-50 across the N GPUs,
   64 rows each, ``hvd.DistributedOptimizer(torch.optim.SGD(lr=0.01,
   momentum=0.9))``, 5 steps in each of Average, Average with
   ``Compression.fp16`` and error feedback, and Adasum, in one world
   without the core and one with it: every rank's parameters
   bit-identical, losses finite and falling, NCCL calls exactly 161 a
   step without the core (one per gradient; Adasum 161 log2(N)
   exchanges), plus the 9 unnamed ``all_reduce`` calls of the norms
   below, and with the core one per plan (the norms ride its allreduce
   plans), ``adasum_pair_combine`` 161
   log2(N) times a step without the core and ``adasum_segment_combine``
   log2(N) times a plan with it (their calls replayed in phase 6 under
   the run's name); img/s per GPU beside the functional optimizer's
   allreduce mode. ``SyncBatchNorm`` at ResNet-50's first BatchNorm
   shape, ``[64, 64, 112, 112]`` a GPU, against ``BatchNorm2d`` over
   the gathered batch: output, input grad, summed weight and bias
   grads, running statistics within 1e-4 of the reference's largest
   magnitude, in both worlds. During each backward every 20th
   parameter's hook also allreduces its gradient's squared norm without
   a name; with the core attached that op goes through the core under a
   generated name, so only the core's thread issues collectives (two
   threads on two communicators in orders that differ between ranks
   hung this phase across four GPUs before); every rank's norms agree,
   each the sum of the ranks' local values. The core world's parameters
   after each mode's first step lie within 5e-2 of the update of the
   world without the core, per tensor. The phase runs
   :data:`FRONTEND_PASSES` times (both worlds each time), each pass's
   seconds printed.

13. bucketed overlap (ResNet-50 at full width, batch 64, int8 + EF,
   fused Adam, 5 steps, one GPU and with ``--gpus N`` across them, 4
   steps): allreduce mode and ZeRO-1 at ``bucket_bytes`` 25 MiB (4
   buckets of ResNet-50's 102.2 MB of f32) and 64 MiB (2), each bucket's
   exchange started from the backward's gradient hooks
   (``make_train_step``'s hook route). Exact launches a step: K of
   ``quantize``, ``dequant_accumulate_requantize`` and
   ``dequantize_rows`` and one ``fused_adam`` pass over the leaves in
   allreduce mode; K of ``quantize`` and ``dequant_accumulate`` and one
   ``fused_adam`` over the K shards in ZeRO-1; NCCL calls in the update
   (the hooks' included) 4K and 2K + 1 (the one trailing all-gather of
   the f32 dtype). One more step compares the hook route's buckets,
   reduced values and new residuals, bit for bit with the same exchange
   re-run after the backward on the same gradients (allreduce mode:
   ``ops.overlap.bucketed_allreduce``), and times the last gradient hook
   to the last bucket's completion with CUDA events; printed with the
   buckets started from the backward (and how many while gradients were
   still to come) and the img/s beside the same mode without overlap;
14. PowerSGD (rank 4, EF): ``lm_flagship`` 4 steps with ``adamw(1e-4)``
   on one GPU (``lm_powersgd``: the factorized leaves exactly those
   the wire-cost rule ``(d0 + m) r < d0 m`` names, the other float
   leaves' grouped int8 exchange once a step, 12 ``flash_fwd`` a step);
   with ``--gpus N`` ResNet-50 ``powersgd`` across them (only the stem
   conv and the head factorize under HWIO; NCCL calls in the update are
   allreduce mode's plus the two factor allreduces); the wire bytes a
   step beside f32's;
15. ``backward_passes_per_step=2`` on ResNet-50 (allreduce mode, int8 +
   EF, fused Adam), one GPU, 4 steps (``multisteps``): a step that does
   not emit makes no NCCL call in the update and launches no kernel,
   one that emits allreduce mode's 5 calls and its launches; then the
   same optimizer under the numerics guard, three updates with the
   guard's own code under ``torch.cuda.set_sync_debug_mode("warn")``:
   exactly one host sync an update (the read of the verdict that keeps
   the host counters ``multi_steps`` branches on on a BAD micro-step;
   every sync's stack is printed);
16. the numerics guard and dynamic loss scaling, one GPU: ResNet-50 at
   batch 64, int8 + EF, fused Adam, in ZeRO-1, in allreduce mode and in
   allreduce mode at 25 MiB from the hooks, each under
   ``DistributedOptimizer(..., loss_scale="dynamic")`` with
   ``HOROVOD_CHAOS=grad_nan_at_step=6``, 8 steps (``zero1_guarded``,
   ``allreduce_guarded``, ``allreduce_guarded_overlap_25MiB``): the
   unguarded mode's launches a step (the guard adds no kernel), the
   optimizer update's NCCL calls the unguarded run's plus the guard's
   one all-gather; at step 6 every parameter (a -0.0 set just before it
   among them) and every inner state tensor (moments, EF residuals)
   bit-equal to step 5's, the scale 2^15 -> 2^14, ``bad_count`` 1 and the
   charge consumed once; under overlap the NaN step and the one after it
   re-run after the backward on the same gradients, bit-equal; from the
   last state, a guarded update of gradients scaled by 2^k bit-equal to
   the unguarded update of the gradients (updates, moments, residuals),
   and the guard's own code (everything but the inner update) run under
   ``torch.cuda.set_sync_debug_mode("error")``, which raises at a host
   sync; then the update alone, unguarded and guarded from the same
   state, timed in turns (CUDA events and a host clock: the guard's cost
   an update). ResNet-50 with bf16 parameters under the guard in allreduce mode
   (``resnet50_bf16_guarded``, 4 steps): B5's bf16 instantiation once a
   step over the 161 bf16 leaves, its replay bit-equal to the plain
   version (the ``fused_adam_bf16`` row of the ``kernels`` line).
   ``lm_flagship`` under ``loss_scale="dynamic"`` (``lm_guarded``, 8
   steps): 12 ``flash_fwd`` a step, no BAD step, the scale unmoved, the
   unguarded LM's NCCL calls plus one, and the update alone timed as
   above. Guarded against unguarded img/s and tokens/s of the same run
   are printed, and the update's cost. The guarded runs' kernel calls
   are replayed against the plain versions as every run's are: a
   guarded state's Adam count is a device tensor, so B5 takes its bias
   corrections through the device buffer there.
17. hierarchical sync and bucketed ZeRO-3 (ResNet-50, batch 64, fused
   Adam). One GPU: ``allreduce_hier``, allreduce mode with int8 + EF on
   the host mesh's axis pair (``DistributedOptimizer(axis=("cross",
   "local"))``, a 1 x 1 ``build_host_mesh``, the hierarchical toggle
   on), 5 steps: losses and parameters bit-equal to ``allreduce`` (one
   rank a group reorders nothing); 2 ``quantize`` a step (the EF
   roundtrip in one launch, the cross hop's exchange), one B4, one B7;
   NCCL calls and bytes sent a step by group (LOCAL, CROSS, WORLD), int8
   bytes on CROSS only. ``zero3_bucketed_25MiB``: ZeRO-3 with the int8
   gather at ``bucket_bytes`` :data:`ZERO3_BUCKET` (4 buckets), 5 steps:
   every bucket gathered twice a step (2K ``quantize``, 2K
   ``dequantize_rows``, 4K ``all_gather``), reduce-scattered once (K),
   one ``fused_adam``; img/s and peak memory beside unbucketed ZeRO-3.
   With the exact gather (``HOROVOD_FSDP_WIRE=none``, ``zero3_exact``)
   bucketed and unbucketed runs of 4 steps bit-equal. With ``--gpus N``
   (N = 4: a 2 x 2 host mesh, ``local=2``): ``allreduce_hier@N`` and
   ``zero1_hier@N`` (the pair's ZeRO-1 route: the chunked roundtrip
   through a flat reduce-scatter), 4 steps: every rank the same losses
   and parameters, NCCL calls and bytes a step by group, int8 bytes on
   CROSS only (none for ZeRO-1), img/s beside the flat mode; and a
   bucketed ZeRO-3 checkpoint of the N ranks (int8 gather, after step 2
   of 3) restored at 2 GPUs and saved, then restored at N: its third step
   bit-equal to the run that never moved (losses, parameters).

18. tensor, sequence, pipeline and expert parallelism
   (``horovod_tpu_torch.parallel``; matmuls in full f32, TF32 off), each
   run on a named-axis mesh (``build_mesh``) of the world's ranks (one
   GPU: every axis of size 1, no NCCL call) after the LM runs, again
   with ``--gpus N`` across the N GPUs (:func:`run_parallel_gpus`):
   ``sp_ring`` and ``sp_ulysses``, ``lm_flagship`` through
   ``make_sp_train_step`` (seq N, and data 2 x seq N/2), 4 steps of
   ``adamw(1e-4)`` on each rank's shard of the batch (the ring launches
   no ``flash_fwd``, Ulysses 12 a step); ``zigzag_attn``, zigzag ring
   attention forward and backward at ``[8, 2048, 16, 64]`` bf16 against
   dense f32 attention on the un-permuted sequence (one bf16 ULP, and
   :data:`ATTN_GRAD_ATOL` of the largest gradient); ``tp_block``,
   ``tp_block_apply`` at one ``lm_flagship_learned`` block with x ``[8,
   2048, 1024]`` f32 against the dense block within :data:`TP_C` times
   the two row-split contractions' rounding bound (the elements over the
   JAX test's dim-32 bar counted), gradients' mean over tp within
   :data:`TP_GRAD_TOL` of the dense block's; ``pp_gpipe`` (and with N >
   1 ``pp_interleaved``, one block a stage), ``lm_flagship_learned``
   through ``make_transformer_pp_train_step``, 8 micro-batches of 1 x
   2048, 4 steps; ``ep_moe_top1``/``ep_moe_top2``,
   ``expert_parallel_moe`` at D 1024, GELU experts of hidden 4096, 8
   experts, 4096 tokens a rank, capacity factor 2.0, forward and
   backward against
   the local per-token reference (:data:`MOE_TOL`). The SP and PP runs'
   first step against ``make_train_step``'s dense flash step from the
   same weights on the same global batch (:data:`FIRST_LOSS_RTOL`; each
   parameter within 2 lr); every step's ``flash_fwd`` launches and NCCL
   calls by axis group exact (:func:`par_expect`); across N GPUs every
   rank the same losses and replicated parameters. Prints tokens/s a GPU
   over the steps after the second, peak memory, the checks' errors, the
   bubble ticks and the dropped tokens; every ``flash_fwd`` call of
   Ulysses and the PP steps is replayed in the kernel phase.
19. resilience (``horovod_tpu_torch.resilience``), ResNet-50 at full
   width, batch 64 a GPU, ZeRO-1 + int8 + EF + fused Adam, as phase 4.
   One GPU: (a) preemption, in child processes with phase 10's
   deterministic kernels: ``resilience.run(..., num_steps=8)`` under
   ``HOROVOD_CHAOS=sigterm_at_step=4`` must exit 75 with a valid
   emergency checkpoint of step 4, a second SIGTERM sent during the
   drain only latched (``resilience_extra_preempt_signals`` 1); a second
   child resumes it and ends bit-equal (every parameter, running stat
   and optimizer leaf) to an uninterrupted 8-step run; drain,
   emergency checkpoint and resume seconds and the checkpoint's bytes
   are printed. (b) rollback: ``elastic.run`` at a world of one under
   ``loss_scale="dynamic"``, the batches of steps 3-5 NaN while the
   replay epoch is 0: three BAD steps, each leaving the parameters and
   the inner optimizer state bit-identical, then ``NumericsRollback`` at
   step 5 to committed step 3 and a replay in epoch 1 (fresh batches)
   that ends finite, ``numerics_rollbacks`` 1 and the health HEALTHY.
   (c) retry: one eager ``allreduce`` under ``collective_fail=1``
   bit-equal to the clean call, ``resilience_retries`` 1. With ``--gpus
   N``, in a world of N (deterministic kernels): 9 steps of
   ``elastic.run`` under :data:`ELASTIC_SPEC` (N -> N-1 -> N): every
   rank's final parameters and running stats bit-equal to each other's
   and to the same schedule driven by hand (N ranks for steps 0-3, N-1
   restored from the snapshot with ``consolidate_opt_state(to_size=
   N-1)`` for 3-6, N again for 6-9); rank 0's metrics (generation 3,
   one shrink, one grow, one rank lost, two resizes); at N-1 ranks
   ZeRO-1's launches a step exact, its last step's calls replayed in the
   kernel phase (``elastic@3``); prints each resize's seconds, the first
   step after it, img/s a GPU at N, N-1, N, the commit's and the
   boundary's ms a step. Then ``min_workers=N`` with one rank failed at
   step 2 raises ``WorldTooSmall`` on every rank after rank 0 wrote a
   valid checkpoint of step 2.
21. serving (``horovod_tpu_torch.serving``), the flagship LM at full
   width, in a world of one: (a) 8 steps under ``ElasticRun(publisher=
   WeightPublisher(KVStoreClient over HTTP), publish_every=4)``:
   generation 1 a keyframe, 2 an int8 delta whose every quantizable
   leaf takes one ``quantize`` launch (logged and replayed in the kernel
   phase as ``serve_delta``), B6 12 a step, and a ``WeightSubscriber``
   over HTTP rebuilding each on the card bit-equal to the publisher's
   decode; (b) an ``InferenceEngine`` (batch 8, page 16, chunk 256,
   2048 positions) on 16 greedy requests of 128-1536 prompt tokens, 64
   new each: the engine's logits within :data:`SERVE_LOGIT_RTOL` of
   ``generate``'s path teacher-forced on the same streams (three
   controls outside it: one perturbed weight, decoding one position
   late, decoding against another row's cache), then the near-tie token bar
   (a row may leave ``generate``'s tokens only where the reference's
   top-2 gap is under twice that measured largest |Δlogit|: the most
   that noise within it can move a difference of two logits); (c) 8
   requests sharing a 1024-token prefix, token-identical to an uncached
   engine with pages aliased; (d) speculative decoding (2-block draft,
   lookahead 4) against (b), its logits within the same bar of (b)'s
   before the near-tie rule may excuse a divergence;
   (e) a ``GenerationRollout`` canary of generation 2 over 1 to a
   verdict, and a ``FleetRouter`` over two replicas (each its own
   subscriber) under ``replica_kill=1``, every request completed once
   and token-identical to (b). With ``--gpus N``: (f) the TP engine over
   a ``tp`` axis of N: teacher-forced logits within
   :data:`TP_LOGIT_RTOL` of the one-GPU engine's (a control with one
   perturbed weight outside it), the same greedy tokens on every rank,
   each decode pass 2 all-reduces a block (plus the split embedding's
   and vocabulary's all-gathers) and none from the control plane.
22. the launcher and the input plane (``tools/launcher_phase.py``'s
   worker, a plain user script): 2,048 synthetic 224x224x3 uint8 images
   from a seed in an ``ArrayShardStore`` of 16 shards, read through a
   ``ResumableLoader`` (prefetch 2, placed on the card) by ResNet-50
   ZeRO-1 + int8 + EF around ``inject_hyperparams(fused_adam)``, batch 64
   a GPU, 2 epochs under ``resilience.run`` (a checkpoint an epoch) with
   the broadcast, metric-average, warmup and metrics callbacks, launched
   by ``python -m horovod_tpu_torch.run -np N --kv-standbys 1``. One GPU:
   (a) the launched run bit-equal to the worker run without the launcher;
   (b) each step's ids the sample index's, each epoch every id once, the
   first batch on the card the store's rows; (c) each step's lr the
   warmup's, in its logged ``fused_adam`` call too (B1, B3, B5 once a
   step; the calls replayed as ``hvdrun@1``); (d) a SIGTERM to the
   launcher while the worker holds step 10: exit 75, then the same
   command resumes at step 11 bit-equal to (a) on (a)'s ids; (e) the
   primary KV store SIGKILLed while rank 0 holds step 12: the standby
   promoted, every rank's client failed over, the later step keys on the
   promoted store, bit-equal to (a); (f) ``shard_corrupt=3:0``: shard 3
   quarantined, each of its samples substituted by the store's rule,
   health SUSPECT naming it, exit 0. Printed: launch to first step (by
   part), loader-fed img/s a GPU beside phase 4's, the wait for a batch,
   the copy to the card, peak memory. With ``--gpus N``: (a)-(c) at N
   ranks against ``testing.run_world``, every rank on its own GPU with
   identical parameters, and (e) at N ranks (``hvdrun@N``).
23. the TensorFlow, Keras, MXNet and Spark frontends and the estimator
   (``tools/frontends_phase.py``): a probe line of which of tensorflow,
   keras, pandas, pyarrow, cloudpickle, mxnet and pyspark import, with
   their versions (a part that needs a package runs exactly when the
   probe finds it, and is fatal on failure); (a) the MXNet bridge in a
   world of one on numpy arrays and a duck-typed NDArray: every result
   its input's kind and exact, every collective handed a tensor on
   ``cuda:0``; (c) with pandas and pyarrow, ``TorchEstimator`` fits and
   transforms a 2-layer MLP at ``num_proc=1``, TF32 off, its weights
   within :data:`P23_WEIGHT_RTOL` of the same fit on the CPU (plain
   PyTorch, the same seed and shards; a control on another shuffle seed
   outside it). With ``--gpus N``: (b) a Spark barrier job of N
   processes without Spark (``testing.run_barrier_job``), each forming
   its world on ``cuda:<local_rank>`` from ``spark._run_barrier_slot``'s
   environment (rank 0 serving the world's store on port 0): the MXNet
   bridge exact on every rank, and with TensorFlow and Keras the TF
   frontend's Adasum identical on every rank, launching B8
   (``frontends@N``); (c) at ``num_proc=N`` through ``run.run``, every
   rank's parameters identical.

With ``--gpus N`` the one-GPU phases that run in child processes go
side by side on the spare cards while this process drives the others on
``cuda:0``: phase 10's child, phase 19's preemption children and phase
20's children one after another on ``cuda:1``, phase 22's one-GPU jobs
on ``cuda:2``; and phase 23's four-GPU jobs run beside phase 22's. Their
checks are bits; their lines say that their times are no readings (the
one-GPU run's are). ``elapsed after ...`` lines mark the parts.

A kernel's ``ms``/``plain_ms``/``bound_ms``/``library_ms`` in the
``{"kernels": [...]}`` line are per step: the sum over one step of each
one-GPU mode that launches it; for the Adasum combines, which no run on
one GPU launches, the level-1 replay's grouped call and its packed bf16
call (one level of each of ``DistributedOptimizer(op=Adasum)``'s
routes), or with ``--gpus N`` rank 0's step of ``adasum`` and
``adasum_fp16`` across the N GPUs. ``by_mode`` splits them.
The ``fused_adam_bf16`` row is B5's bf16 instantiation: its numbers are
the bf16 run's step, its launches that run's (the ``fused_adam`` row
keeps the f32 launches).
``launches`` counts the launches of the main path's runs (with ``--gpus
N`` rank 0's of the N-GPU runs too, as ``mode@N``); a kernel that none of
them launched, as the Adasum combines on one GPU, takes the replay's
grouped and packed bf16 counts, under ``adasum_l1_replay`` in
``launches_by_mode``. A bound is the larger of the bytes
over the memory rate and the operations over the peak rate for the
inputs' type (bf16 tensor cores for ``flash_fwd``'s bf16 dots, the f32
rate outside the tensor cores otherwise); ``flash_fwd``'s operations are
those of the (query, key) pairs the causal mask keeps, whatever the
kernel's tiling. The Adasum combines' bytes read each
operand once, as the bound does for every kernel; their two-pass floor
(both operands read twice) is given beside it as ``two_pass_bound_ms``.
The last two lines of standard output are that record and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import hashlib
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM peak memory bandwidth (NVIDIA data sheet), bytes/s
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM dense f32 rate outside the tensor cores, operations/s
F32_OPS_PER_S = 67e12
#: H100 SXM dense bf16 tensor-core rate, operations/s
BF16_OPS_PER_S = 989e12
#: fused Adam's bar against its plain version
ADAM_ULPS = 2
#: flash_fwd's bars against its plain version: out within one ULP (of bf16;
#: ULPs below 2^-8's are counted as 2^-8's, where the f32 sums' rounding
#: is larger than an ULP), f32 out within 1e-5; lse within 1e-5 relative
#: (absolute below 1: row 0's lse is a single dot product, near 0)
FLASH_ULP_FLOOR = 2.0 ** -8
FLASH_TOL = 1e-5

#: the LM slice: the flagship TransformerLM configuration
LM = dict(vocab=32000, dim=1024, depth=12, heads=16, kv_heads=None,
          mlp_ratio=4, max_len=2048, pos_embedding="rope")
LM_BATCH, LM_SEQ, LM_STEPS = 8, 2048, 8

#: the models trained at full width: the port's class and the input's side
MODELS = {"resnet50": ("ResNet50", 224), "vgg16": ("VGG16", 224),
          "inception3": ("InceptionV3", 299)}
#: the reference's other scaling models (bench.py's --model), one GPU, 5
#: steps each at batch 64: (model, optimizer mode, Adam's learning rate).
#: VGG-16 has no BatchNorm: at 1e-3 Adam's first sign-sized steps throw
#: its loss from 6.91 to 55.9 and back (measured on the card); at 3e-5 it
#: falls step by step
ZOO_RUNS = (("vgg16", "zero1", 3e-5), ("vgg16", "allreduce", 3e-5),
            ("inception3", "zero1", 1e-3))
#: the checkpoint phase's directory, inside the checkout (git-ignored),
#: removed when the smoke ends
CKPT_DIR = os.path.join(ROOT, "_smoke_ckpt")

#: the Adasum combines' bar against their plain versions (tests/test_pallas.py)
ADASUM_RTOL, ADASUM_ATOL = 2e-5, 2e-6

TPU_KERNELS = {
    "quantize": "horovod_tpu/ops/pallas_kernels.py:220",
    "dequant_accumulate": "horovod_tpu/ops/pallas_kernels.py:323",
    "dequant_accumulate_requantize": "horovod_tpu/ops/pallas_kernels.py:354",
    "fused_adam": "horovod_tpu/ops/pallas_kernels.py:673",
    "flash_fwd": "horovod_tpu/ops/flash_attention.py:250",
    "dequantize_rows": "horovod_tpu/ops/pallas_kernels.py:404",
    "adasum_pair_combine": "horovod_tpu/ops/pallas_kernels.py:470",
    "adasum_segment_combine": "horovod_tpu/ops/pallas_kernels.py:556",
}
SOURCES = {
    "quantize": "horovod_tpu_torch/ops/csrc/int8_wire.cu",
    "dequant_accumulate": "horovod_tpu_torch/ops/csrc/int8_wire.cu",
    "dequant_accumulate_requantize": "horovod_tpu_torch/ops/csrc/int8_wire.cu",
    "fused_adam": "horovod_tpu_torch/ops/csrc/fused_adam.cu",
    "flash_fwd": "horovod_tpu_torch/ops/csrc/flash_attention.cu",
    "dequantize_rows": "horovod_tpu_torch/ops/csrc/int8_wire.cu",
    "adasum_pair_combine": "horovod_tpu_torch/ops/csrc/adasum.cu",
    "adasum_segment_combine": "horovod_tpu_torch/ops/csrc/adasum.cu",
}
#: the public wrappers of ops.kernels the path calls, and their kernel
WRAPPERS = {
    "quantize_blockwise": "quantize",
    "quantize_roundtrip": "quantize",
    "dequant_accumulate": "dequant_accumulate",
    "dequant_accumulate_requantize": "dequant_accumulate_requantize",
    "fused_adam_multi": "fused_adam",
    "fused_adam_update": "fused_adam",
    "flash_fwd": "flash_fwd",
    "dequantize_rows": "dequantize_rows",
    "adasum_pair_combine": "adasum_pair_combine",
    "adasum_pair_combine_packed": "adasum_pair_combine",
    "adasum_segment_combine": "adasum_segment_combine",
}
#: kernels each mode's path must launch (Adasum's at a world of one: none
#: of its own, the butterfly has no level; across N GPUs expected_launches
#: fixes the combines' counts; adasum_fp16 runs across N GPUs only)
NEED = {"zero1": ("quantize", "dequant_accumulate", "fused_adam"),
        "allreduce": ("quantize", "dequant_accumulate_requantize",
                      "dequantize_rows", "fused_adam"),
        "allreduce_hier": ("quantize", "dequant_accumulate_requantize",
                           "dequantize_rows", "fused_adam"),
        "zero1_hier": ("quantize", "fused_adam"),
        "zero3": ("quantize", "dequantize_rows", "fused_adam"),
        "zero3_exact": ("fused_adam",),
        "adasum": ("fused_adam",),
        "adasum_fp16": ("adasum_pair_combine", "fused_adam"),
        "powersgd": ("quantize", "dequant_accumulate_requantize",
                     "dequantize_rows", "fused_adam"),
        "lm": ("flash_fwd",),
        "lm_guarded": ("flash_fwd",),
        "bf16": ("fused_adam",),
        "lm_powersgd": ("flash_fwd", "quantize",
                        "dequant_accumulate_requantize", "dequantize_rows")}
#: the torch.distributed functions ops/collective.py calls through its
#: ``dist`` name (one of each renamed pair exists)
DIST_CALLS = ("all_reduce", "all_to_all_single", "all_gather_single",
              "all_gather_into_tensor", "reduce_scatter_single",
              "reduce_scatter_tensor", "broadcast", "batch_isend_irecv")
#: the replays of what a kernel's calls were before they were fused, each
#: a yardstick outside every row's per-step numbers: allreduce mode's
#: per-leaf int8 calls, and the compressed Adasum route's 161 per-leaf
#: bf16 combines of one level
PER_LEAF = "allreduce_per_leaf"
ADASUM_PER_LEAF = "adasum_l1_replay_leaf_bfloat16"
YARDSTICKS = (PER_LEAF, ADASUM_PER_LEAF)
#: the bucketed overlap runs (ResNet-50, int8 + EF, fused Adam): mode and
#: bucket bytes; 25 MiB cuts ResNet-50's 102.2 MB of f32 into 4 buckets,
#: the 64 MiB default into 2
OVERLAP_RUNS = (("allreduce", 25 << 20), ("zero1", 25 << 20),
                ("allreduce", 64 << 20), ("zero1", 64 << 20))
#: PowerSGD's rank in both of its runs
PSGD_RANK = 4
#: the host mesh's axis pair (``DistributedOptimizer(axis=PAIR)``) and its
#: LOCAL size across N GPUs: 2 x 2 at four GPUs of one host (on one GPU
#: the mesh is 1 x 1)
PAIR = ("cross", "local")
HIER_LOCAL = 2
#: the modes on the axis pair, hierarchical allreduce on: allreduce mode
#: (int8 on the cross hop, EF) and ZeRO-1 (the pair's roundtrip route)
HIER_MODES = ("allreduce_hier", "zero1_hier")
#: bucketed ZeRO-3's bucket size: 4 buckets of ResNet-50's 102.2 MB of f32
ZERO3_BUCKET = 25 << 20
#: phase 12's passes across N GPUs, each the world without the core and
#: the one with it
FRONTEND_PASSES = 2
#: the ResNet-50 modes across N GPUs (``--gpus N``)
WORLD_MODES = ("zero1", "allreduce", "zero3", "adasum", "adasum_fp16",
               "powersgd")
#: the one-GPU modes whose replayed step makes a kernel row's numbers
ONE_GPU_MODES = ("zero1", "allreduce", "zero3", "adasum", "lm")
#: the level-1 replay's calls that stand in for the Adasum combines' step
#: on one GPU: the grouped route's, and the compressed route's in bf16
REPLAY_MODES = ("adasum_l1_replay_grouped", "adasum_l1_replay_packed_bfloat16")


def main_modes(gpus: int) -> dict:
    """Each kernel's modes whose replayed step makes its row's per-step
    numbers: the one-GPU runs; for the Adasum combines, which no run on
    one GPU launches, the level-1 replay's grouped and bf16 calls, or
    with ``gpus`` > 1 rank 0's step of the two Adasum runs across them."""
    adasum = (f"adasum@{gpus}", f"adasum_fp16@{gpus}") if gpus > 1 \
        else REPLAY_MODES
    return {k: adasum if k.startswith("adasum") else ONE_GPU_MODES
            for k in TPU_KERNELS}


def child_env(gpu=None, **extra) -> dict:
    """This process's environment for a child process, with ``extra``.
    ``gpu``: the child sees that card alone (with ``--gpus N`` the
    one-GPU phases that run in child processes go side by side on the
    spare cards), without the ZeRO-3 wire knob the foreground's runs set
    around themselves."""
    env = dict(os.environ, **extra)
    if gpu is not None:
        env["CUDA_VISIBLE_DEVICES"] = str(gpu)
        env.pop("HOROVOD_FSDP_WIRE", None)
    return env


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(iters):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / iters


def cuda_device_ms(fn, iters: int = 10) -> float:
    """The card's time for ``fn``: as :func:`cuda_ms`, with the calls
    queued behind a sleep of the card that outlasts their enqueueing, so
    that the host's time a call drops out of the reading."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e9 * (2 * iters * host + 1e-3)))
    s.record()
    for _ in range(iters):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / iters


def _numbers(a, b):
    """``a`` and ``b`` where neither is NaN, after checking that they are
    NaN at the same places (a NaN's payload is not part of the contract:
    PyTorch's CPU and CUDA casts and the CUDA intrinsics differ in it)."""
    import torch

    if not a.is_floating_point():
        return a, b
    nan = torch.isnan(a)
    if not torch.equal(nan, torch.isnan(b)):
        return None
    return a[~nan], b[~nan]


def same_bits(a, b) -> bool:
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    ab = _numbers(a, b)
    if ab is None:
        return False
    a, b = ab
    if a.is_floating_point():
        itype = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
                 torch.float16: torch.int16}
        return torch.equal(a.view(itype[a.dtype]), b.view(itype[b.dtype]))
    return torch.equal(a, b)


def within_ulps(a, b, ulps: int = ADAM_ULPS) -> bool:
    import torch

    ab = _numbers(a, b)
    if ab is None:
        return False
    a, b = ab
    inf = torch.isinf(a) | torch.isinf(b)
    if not torch.equal(a[inf], b[inf]):
        return False
    a, b = a[~inf], b[~inf]
    big = torch.maximum(a.abs(), b.abs())
    spacing = torch.nextafter(big, torch.full_like(big, math.inf)) - big
    return bool(((a - b).abs() <= ulps * spacing).all())


def max_abs(a, b) -> float:
    """Largest |a - b| where both are numbers."""
    d = (a.float() - b.float()).abs()
    d = d[~d.isnan()]
    return float(d.max()) if d.numel() else 0.0


# --------------------------------------------------------------------------
# the kernel calls of the main path


def _signature(wrapper: str, args, kw) -> tuple:
    kernel = WRAPPERS[wrapper]
    if kernel == "quantize":
        return (kernel, wrapper == "quantize_roundtrip", args[0].numel())
    if kernel == "dequant_accumulate":
        return (kernel, *args[0].shape)
    if kernel == "dequant_accumulate_requantize":
        return (kernel, *args[0].shape, kw.get("divisor"))
    if kernel == "flash_fwd":
        q, k, v = args
        return (kernel, tuple(q.shape), tuple(k.shape),
                str(q.dtype).replace("torch.", ""), bool(kw.get("causal")),
                kw.get("sm_scale"), q.stride(), k.stride(), v.stride())
    if kernel == "dequantize_rows":
        return (kernel, *args[0].shape)
    if wrapper == "adasum_pair_combine_packed":
        return (kernel, tuple(int(o) for o in args[2]),
                str(args[0].dtype).replace("torch.", ""))
    if kernel == "adasum_pair_combine":
        return (kernel, args[0].numel(), str(args[0].dtype).replace("torch.", ""))
    if kernel == "adasum_segment_combine":
        return (kernel, tuple(int(o) for o in args[2]))
    # fused_adam: each leaf's length and its g's offset from a 16-byte
    # boundary in elements (Adasum's leaves are views into a group buffer),
    # the step count (a guarded state's is a device tensor, kept as it is:
    # reading it here would sync the step; the replay reads it) and the
    # dtype
    gs = args[0] if wrapper == "fused_adam_multi" else [args[0]]
    item = gs[0].element_size()
    return (kernel, tuple(g.numel() for g in gs),
            tuple(g.data_ptr() % 16 // item for g in gs), args[3],
            tuple(sorted(kw.items())), str(gs[0].dtype).replace("torch.", ""))


@contextlib.contextmanager
def logging_calls(steps: list):
    """Log the shape signature of every call of a kernel wrapper into
    ``steps[-1]`` (the caller appends a list per step). The path reaches
    the wrappers through the ``ops.kernels`` module, so wrapping the
    module's attributes sees every call; :func:`train` checks that the
    log and the launch counters agree."""
    from horovod_tpu_torch.ops import kernels as K
    from horovod_tpu_torch.testing import watching_calls

    with watching_calls(K, WRAPPERS, lambda w, args, kw: steps[-1].append(
            _signature(w, args, kw))):
        yield


def group_name(group) -> str:
    """``WORLD`` (the default group), ``LOCAL`` or ``CROSS`` (the host
    mesh's sub-groups), a named mesh axis's name in capitals (``SEQ``,
    ``TP``, ``PIPE``, ...: :func:`~horovod_tpu_torch.parallel.mesh.
    build_mesh`'s sub-groups), ``CORE`` (the native core's) or
    ``OTHER``."""
    from horovod_tpu_torch import basics

    if group is None:
        return "WORLD"
    mesh, core = basics._state.host_mesh, basics._state.core
    if mesh is not None and group is mesh.local_group:
        return "LOCAL"
    if mesh is not None and group is mesh.cross_group:
        return "CROSS"
    axes = basics._state.mesh
    for name, g in (axes.groups.items() if axes is not None else ()):
        if group is g:
            return name.upper()
    if core is not None and group is core._group:
        return "CORE"
    return "OTHER"


def _sent(name: str, args):
    """The tensor a collective call sends from this rank (None for the
    point-to-point batch)."""
    if name in ("all_reduce", "broadcast"):
        return args[0]
    if name == "batch_isend_irecv":
        return None
    return args[1]


@contextlib.contextmanager
def counting_collectives(counts: dict, where: list, by_group=None):
    """Count every call of the :data:`DIST_CALLS` functions into
    ``counts[where[-1]]`` (the caller pushes a label while inside a part
    of the step); with ``by_group`` also each group's calls and the bytes
    this rank sends on it by dtype (:func:`group_name`).
    ``ops/collective.py`` looks them up through its ``dist`` name at each
    call, so wrapping the module's attributes sees every call."""
    from horovod_tpu_torch.ops import collective as C
    from horovod_tpu_torch.testing import watching_calls

    def count(name, args, kw):
        part = counts.setdefault(where[-1], {})
        part[name] = part.get(name, 0) + 1
        if by_group is not None:
            group = kw.get("group")
            if name == "batch_isend_irecv" and args and args[0]:
                group = args[0][0].group    # the P2P ops carry theirs
            rec = by_group.setdefault(group_name(group),
                                      {"calls": 0, "bytes": {}, "ops": {}})
            rec["calls"] += 1
            rec["ops"][name] = rec["ops"].get(name, 0) + 1
            t = _sent(name, args)
            if t is not None:
                k = str(t.dtype).replace("torch.", "")
                rec["bytes"][k] = (rec["bytes"].get(k, 0)
                                   + t.numel() * t.element_size())

    with watching_calls(C.dist, DIST_CALLS, count):
        yield


def allreduce_nccl_calls(params) -> int:
    """NCCL calls of one allreduce-mode int8 update of ``params``: four
    for each quantizable dtype's exchange (two ``all_to_all``, two
    ``all_gather``), one ``all_reduce`` for each dtype of the rest."""
    from horovod_tpu_torch.compression import Compression

    quant = [Compression.int8.quantizes(p.shape, p.dtype) for p in params]
    return (4 * len({p.dtype for p, q in zip(params, quant) if q})
            + len({p.dtype for p, q in zip(params, quant) if not q}))


def per_leaf_calls(params, n: int) -> list:
    """The int8 kernel calls allreduce mode + EF made a step when it
    exchanged leaf by leaf, for a world of ``n``: per quantizable leaf,
    the residual's quantize (padded to the block), the wire's quantize
    (padded to ``n`` blocks) and one requantize of its ``[n, Lp/n]`` rows."""
    from horovod_tpu_torch.compression import INT8_BLOCK, Compression

    sigs = []
    for p in params:
        if Compression.int8.quantizes(p.shape, p.dtype):
            L = p.numel()
            lp = L + (-L) % (n * INT8_BLOCK)
            sigs += [("quantize", False, L + (-L) % INT8_BLOCK),
                     ("quantize", False, lp),
                     ("dequant_accumulate_requantize", n, lp // n, n)]
    return sigs


def flash_pairs(t_q: int, t_k: int, causal: bool) -> int:
    """The (query, key) pairs attention needs for one (batch, head): all
    of them, or those the causal mask keeps (key index <= query index),
    ``sum_i min(t_k, i + 1)``."""
    if not causal:
        return t_q * t_k
    n = min(t_q, t_k)
    return n * (n + 1) // 2 + (t_q - n) * t_k


def call_bound(sig) -> tuple:
    """``(bytes, operations, operations/s)`` of one call: each input read
    once, each output written once; the operations at the peak rate for
    their type."""
    kernel = sig[0]
    if kernel == "quantize":
        _, roundtrip, L = sig
        return (4 * L + L + 2 * (L // 256) + 4 * L * roundtrip, 4 * L,
                F32_OPS_PER_S)
    if kernel in ("dequant_accumulate", "dequant_accumulate_requantize"):
        n, sp = sig[1], sig[2]
        wire = n * sp + 2 * n * (sp // 256)
        if kernel == "dequant_accumulate":
            return wire + 4 * sp, 2 * n * sp, F32_OPS_PER_S
        return wire + sp + 2 * (sp // 256), 2 * n * sp + 4 * sp, F32_OPS_PER_S
    if kernel == "flash_fwd":
        (b, t_q, h, d), (_, t_k, h_kv, _), dtype, causal = sig[1:5]
        item = 2 if dtype == "bfloat16" else 4
        nbytes = item * d * (2 * b * t_q * h + 2 * b * t_k * h_kv) + 4 * b * h * t_q
        # q.k and p.v: 2 + 2 operations per (q, k, d) of every needed pair
        ops = 4 * d * b * h * flash_pairs(t_q, t_k, causal)
        return nbytes, ops, (BF16_OPS_PER_S if item == 2 else F32_OPS_PER_S)
    if kernel == "dequantize_rows":
        n, sp = sig[1], sig[2]
        return n * sp * (1 + 4) + n * (sp // 256) * 2, n * sp, F32_OPS_PER_S
    if kernel.startswith("adasum"):
        L, item = adasum_len_item(sig)
        # a and b read once, out written once; a*b, a*a, b*b summed (6)
        # and ca*a + cb*b (3) in f32
        return 3 * item * L, 9 * L, F32_OPS_PER_S
    # fused_adam: g, mu, nu read and u, mu', nu' written, in the leaves'
    # dtype; ~12 operations an element, in f32
    L, item = sum(sig[1]), 2 if sig[5] == "bfloat16" else 4
    return 6 * item * L, 12 * L, F32_OPS_PER_S


def adasum_len_item(sig) -> tuple:
    """``(elements, bytes an element)`` of an Adasum combine's call (a
    packed leaf table's elements include its pads)."""
    if sig[0] == "adasum_segment_combine":
        return sig[1][-1], 4
    L = sig[1][-1] if isinstance(sig[1], tuple) else sig[1]
    return L, 4 if sig[2] == "float32" else 2


def two_pass_bound_ms(sigs) -> float:
    """The Adasum combines' floor when both operands are read twice (the
    reduction, then the blend) and the output written once."""
    total = 0.0
    for sig in sigs:
        L, item = adasum_len_item(sig)
        total += 5 * item * L / HBM_BYTES_PER_S
    return total * 1e3


def bound_ms(sigs) -> tuple:
    """The least time for all of ``sigs``: the sum of each call's larger
    of bytes over the memory rate and operations over its peak rate."""
    total, by = 0.0, set()
    for sig in sigs:
        nbytes, ops, rate = call_bound(sig)
        t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / rate
        total += max(t_b, t_o)
        by.add("bytes" if t_b >= t_o else "operations")
    return total * 1e3, "bytes" if by == {"bytes"} else "operations"


def _special_blocks(x, gen) -> None:
    """Overwrite the first blocks of a flat f32 input with edge cases, as
    far as it has blocks and leaving at least one ordinary block: all zero;
    exact half-way quotients (amax 127 gives scale 1); a NaN; infinities."""
    import torch

    half = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, -3.5] * 32,
                        device=x.device)
    nan = torch.randn(256, device=x.device, generator=gen)
    nan[17] = math.nan
    inf = torch.randn(256, device=x.device, generator=gen)
    inf[3], inf[200] = math.inf, -math.inf
    for i, block in enumerate((torch.zeros_like(half), half, nan, inf)):
        if (i + 2) * 256 > x.numel():
            break
        x[i * 256:(i + 1) * 256] = block


def _half_way_block(q, s, b) -> None:
    """Senders' block ``b`` whose sum has exact half-way quotients: rows 0
    and 1 at scale 1, both 127 at the block's first element and row 0 odd
    elsewhere, the other rows zero. The sum's max is 254, so its scale is
    2 / divisor for a power-of-two divisor (or none), and every odd sum
    over it lies on a half-integer."""
    import torch

    i = torch.arange(255, device=q.device)
    q[:, b * 256:(b + 1) * 256] = 0
    s[:, b] = 1.0
    q[:2, b * 256] = 127
    q[0, b * 256 + 1:(b + 1) * 256] = ((i % 63 * 2 + 1)
                                      * (1 - 2 * (i % 2))).to(torch.int8)


def make_call(sig, gen):
    """``(kernel_call, plain_call, compare)`` on fresh inputs on
    ``gen``'s device for one logged call; ``compare(out, ref)`` is None
    when they agree, else a message."""
    import numpy as np
    import torch

    from horovod_tpu_torch.ops import kernels as K

    dev = gen.device
    kernel = sig[0]
    if kernel == "flash_fwd":
        _, qs, ks, dtype, causal, scale, qst, kst, vst = sig
        dtype = getattr(torch, dtype)

        def strided(shape, stride):
            # the logged layout: a view of a buffer just large enough
            n = 1 + sum((a - 1) * st for a, st in zip(shape, stride))
            x = torch.randn(n, device=dev, generator=gen).to(dtype)
            return x.as_strided(shape, stride)

        q, k, v = strided(qs, qst), strided(ks, kst), strided(ks, vst)
        call = (lambda: K.flash_fwd(q, k, v, causal=causal, sm_scale=scale),
                lambda: K.flash_fwd_plain(q, k, v, causal=causal,
                                          sm_scale=scale),
                _flash_close)
        call[0].tensors = (q, k, v, causal, scale)
        return call
    if kernel == "quantize":
        _, roundtrip, L = sig
        x = torch.randn(L, device=dev, generator=gen) * 1e-2
        _special_blocks(x, gen)
        f = K.quantize_roundtrip if roundtrip else K.quantize_blockwise
        return (lambda: f(x), lambda: K.quantize_plain(x, roundtrip=roundtrip),
                _bits)
    if kernel in ("dequant_accumulate", "dequant_accumulate_requantize"):
        n, sp = sig[1], sig[2]
        nb = sp // 256
        q = torch.randint(-127, 128, (n, sp), device=dev, generator=gen,
                          dtype=torch.int8)
        s = (torch.rand(n, nb, device=dev, generator=gen) * 1e-2).to(
            torch.bfloat16)
        q[:, :256], s[:, 0] = 0, 0.0           # an all-zero block
        if nb >= 4:                             # a sender's NaN / inf block
            s[0, 1], s[n - 1, 2] = math.nan, math.inf
        if n >= 2 and nb >= 5:                  # exact half-way quotients
            _half_way_block(q, s, 3)
        if kernel == "dequant_accumulate":
            return (lambda: (K.dequant_accumulate(q, s),),
                    lambda: (K.dequant_accumulate_plain(q, s),), _bits)
        d = sig[3]
        return (lambda: K.dequant_accumulate_requantize(q, s, divisor=d),
                lambda: K.dequant_accumulate_requantize_plain(q, s, divisor=d),
                _bits)
    if kernel == "dequantize_rows":
        n, sp = sig[1], sig[2]
        q = torch.randint(-127, 128, (n, sp), device=dev, generator=gen,
                          dtype=torch.int8)
        s = (torch.rand(n, sp // 256, device=dev, generator=gen) * 1e-2).to(
            torch.bfloat16)
        s[0, 0] = 0.0                           # an all-zero scale block
        if sp // 256 >= 3:                      # a NaN and an inf scale block
            s[0, 1], s[n - 1, 2] = math.nan, math.inf
        return (lambda: (K.dequantize_rows(q, s),),
                lambda: (K.dequantize_rows_plain(q, s),), _bits)
    if kernel == "adasum_pair_combine" and isinstance(sig[1], tuple):
        offsets, dtype = sig[1], getattr(torch, sig[2])
        a = (torch.randn(offsets[-1], device=dev, generator=gen) * 1e-2).to(
            dtype)
        b = (torch.randn(offsets[-1], device=dev, generator=gen) * 1e-2).to(
            dtype)
        return (lambda: (K.adasum_pair_combine_packed(a, b, offsets),),
                lambda: (K.adasum_segment_combine_plain(a, b, offsets),),
                _adasum_close)
    if kernel == "adasum_pair_combine":
        L, dtype = sig[1], getattr(torch, sig[2])
        a = (torch.randn(L, device=dev, generator=gen) * 1e-2).to(dtype)
        b = (torch.randn(L, device=dev, generator=gen) * 1e-2).to(dtype)
        return (lambda: (K.adasum_pair_combine(a, b),),
                lambda: (K.adasum_pair_combine_plain(a, b),), _adasum_close)
    if kernel == "adasum_segment_combine":
        offsets = sig[1]
        a = torch.randn(offsets[-1], device=dev, generator=gen) * 1e-2
        b = torch.randn(offsets[-1], device=dev, generator=gen) * 1e-2
        return (lambda: (K.adasum_segment_combine(a, b, offsets),),
                lambda: (K.adasum_segment_combine_plain(a, b, offsets),),
                _adasum_close)
    _, lengths, offsets, count, kw, dtype = sig
    kw, dtype = dict(kw), getattr(torch, dtype)
    # a guarded state's count is a 0-d device tensor: kept so, the kernel
    # takes its bias corrections through the device buffer, as on the path
    count = count.to(dev) if isinstance(count, torch.Tensor) \
        and count.is_cuda else int(count)
    # g: the leaves at their logged offsets in one buffer; mu, nu fresh
    per = 16 // torch.empty(0, dtype=dtype).element_size()   # a 16-byte group
    slots = [(n + 2 * per - 1) // per * per for n in lengths]  # aligned, room
    starts = np.cumsum([0] + slots)[:-1] + np.asarray(offsets)
    gbuf = (torch.randn(int(starts[-1]) + lengths[-1], device=dev,
                        generator=gen) * 1e-2).to(dtype)
    gs = [gbuf[int(a):int(a) + n] for a, n in zip(starts, lengths)]
    mus = [(torch.randn(n, device=dev, generator=gen) * 1e-3).to(dtype)
           for n in lengths]
    nus = [(torch.rand(n, device=dev, generator=gen) * 1e-6).to(dtype)
           for n in lengths]
    big = [int(a) for a, n in zip(starts, lengths) if n >= 8]
    if big:                                 # a NaN and an inf gradient
        gbuf[torch.tensor([a + i for a in big for i in (1, 5)], device=dev)] = \
            torch.tensor([math.nan, math.inf] * len(big), device=dev,
                         dtype=dtype)
    c = K.adam_constants(kw["lr"], kw["b1"], kw["b2"], kw["eps"],
                         kw["eps_root"], count)
    call = (lambda: sum(K.fused_adam_multi(gs, mus, nus, count, **kw), []),
            lambda: [x for out in zip(*(K.fused_adam_plain(g, m, v, c)
                                        for g, m, v in zip(gs, mus, nus)))
                     for x in out],
            _ulps if dtype == torch.float32 else _bits)
    call[0].tensors = (gs, mus, nus)
    return call


def _bits(out, ref):
    for i, (a, b) in enumerate(zip(out, ref)):
        if not same_bits(a, b):
            return f"output {i} differs (max abs err {max_abs(a, b)})"
    return None


def _adasum_close(out, ref):
    """rtol 2e-5 / atol 2e-6 (the kernel and the plain version sum in
    other orders); a 16-bit element may instead be one ULP of its type
    off, where the f32 value sits on that type's rounding boundary."""
    import torch

    (o,), (r,) = out, ref
    if o.shape != r.shape or o.dtype != r.dtype:
        return f"shape/dtype {o.shape}/{o.dtype} vs {r.shape}/{r.dtype}"
    of, rf = o.float(), r.float()
    if not bool(torch.isfinite(of).all()):
        return "non-finite output"
    bar = ADASUM_ATOL + ADASUM_RTOL * rf.abs()
    if o.dtype != torch.float32:             # one ULP: 8 or 11 significand bits
        bits = 8 if o.dtype == torch.bfloat16 else 11
        _, e = torch.frexp(torch.maximum(of.abs(), rf.abs()))
        bar = torch.maximum(bar, torch.ldexp(torch.ones_like(of), e - bits))
    if bool(((of - rf).abs() > bar).any()):
        return f"off by up to {max_abs(o, r)}"
    return None


def _bf16_ulps(a, b, floor):
    """``(|a - b|, bf16's ULP at the larger of |a|, |b|)`` with magnitudes
    below ``floor`` taken as ``floor``."""
    import torch

    a, b = a.float(), b.float()
    big = torch.maximum(a.abs(), b.abs())
    _, e = torch.frexp(big.clamp_min(floor))
    return (a - b).abs(), torch.ldexp(torch.ones_like(big), e - 8)


def flash_unfloored_misses(out, ref) -> int:
    """Elements of a bf16 ``out`` more than one bf16 ULP from the plain
    version with no floor: how many the floor of the bar lets through."""
    diff, ulp = _bf16_ulps(out[0], ref[0], 2.0 ** -126)
    return int((diff > ulp).sum())


def _flash_close(out, ref):
    import torch

    (o, lse), (ro, rlse) = out, ref
    if o.shape != ro.shape or o.dtype != ro.dtype or lse.shape != rlse.shape:
        return f"shapes/dtypes {o.shape}/{o.dtype} vs {ro.shape}/{ro.dtype}"
    if not (bool(torch.isfinite(o).all()) and bool(torch.isfinite(lse).all())):
        return "non-finite output"
    if o.dtype == torch.bfloat16:
        diff, bar = _bf16_ulps(o, ro, FLASH_ULP_FLOOR)
        if bool((diff > bar).any()):
            worst = float((diff / bar).max())
            return f"out more than one bf16 ULP off ({worst:.2f} ULP)"
    elif max_abs(o, ro) > FLASH_TOL:
        return f"out off by {max_abs(o, ro)}"
    if bool(((lse - rlse).abs() > FLASH_TOL * rlse.abs().clamp_min(1.0)).any()):
        return f"lse off by {max_abs(lse, rlse)}"
    return None


def _ulps(out, ref):
    """``out``/``ref``: the updates, then the mu's, then the nu's."""
    n = len(out) // 3
    for i, (a, b) in enumerate(zip(out, ref)):
        if not within_ulps(a, b):
            return (f"{('update', 'mu', 'nu')[i // n]} of leaf {i % n} more "
                    f"than {ADAM_ULPS} ULP from the plain version (max abs "
                    f"err {max_abs(a, b)})")
    return None


def library_adam_ms(calls, count: int, kw: dict) -> float:
    """``torch._fused_adam_`` over the same tensors as one step's fused
    Adam calls, in one multi-tensor call (a yardstick; the port never
    calls it)."""
    import torch

    gs, mus, nus = ([x for c in calls for x in c.tensors[i]] for i in range(3))
    params = [torch.zeros_like(g) for g in gs]
    m2, v2 = [m.clone() for m in mus], [v.clone() for v in nus]
    steps = [torch.tensor(float(count), device=gs[0].device) for _ in gs]
    return cuda_ms(lambda: torch._fused_adam_(
        params, list(gs), m2, v2, [], steps, lr=kw["lr"], beta1=kw["b1"],
        beta2=kw["b2"], weight_decay=0.0, eps=kw["eps"], amsgrad=False,
        maximize=False))


def library_flash_ms(calls) -> float:
    """``F.scaled_dot_product_attention`` over the same tensors as one
    step's flash_fwd calls, ``[B, H, T, D]`` views (a yardstick the port
    never calls: it emits no lse)."""
    import torch.nn.functional as F

    def run():
        for c in calls:
            q, k, v, causal, scale = c.tensors
            F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=causal, scale=scale,
                enable_gqa=q.shape[2] != k.shape[2])

    return cuda_ms(run)


def kernel_phase(step_calls: dict, main_modes: dict) -> dict:
    """Replay each mode's logged step on fresh inputs: hold every call
    against its plain version, then time the kernel, plain and library
    replays. Returns the per-kernel record, its per-step numbers summed
    over ``main_modes[kernel]``."""
    import torch

    from horovod_tpu_torch.ops import kernels as K

    gen = torch.Generator(device="cuda").manual_seed(1234)
    rows = {k: dict(max_abs_err=0.0, calls_checked=0, by_mode={})
            for k in K.KERNELS}
    for mode, sigs in step_calls.items():
        for kernel in K.KERNELS:
            ks = [s for s in sigs if s[0] == kernel]
            if not ks:
                continue
            calls = [make_call(s, gen) for s in ks]
            row = rows[kernel]
            mode_err = 0.0
            for sig, (run, plain, compare) in zip(ks, calls):
                out, ref = run(), plain()
                bad = compare(out, ref)
                if bad:
                    fail(f"{kernel} at {sig[:3]} ({mode}): {bad}")
                if kernel.startswith("adasum") and not all(
                        map(same_bits, out, run())):
                    fail(f"{kernel} at {sig[:3]} ({mode}): two launches on "
                         "the same inputs differ")
                mode_err = max([mode_err]
                               + [max_abs(a, b) for a, b in zip(out, ref)])
                row["max_abs_err"] = max(row["max_abs_err"], mode_err)
                row["calls_checked"] += 1
                if kernel == "flash_fwd" and out[0].dtype == torch.bfloat16:
                    row["out_elements"] = (row.get("out_elements", 0)
                                           + out[0].numel())
                    row["over_one_unfloored_ulp"] = (
                        row.get("over_one_unfloored_ulp", 0)
                        + flash_unfloored_misses(out, ref))
            b, by = bound_ms(ks)
            lib = None
            if kernel == "fused_adam" and hasattr(torch, "_fused_adam_"):
                lib = library_adam_ms([c[0] for c in calls], int(ks[0][3]),
                                      dict(ks[0][4]))
            elif kernel == "flash_fwd":
                lib = library_flash_ms([c[0] for c in calls])
            row["by_mode"][mode] = dict(
                calls=len(ks), shapes=len(set(ks)),
                ms=cuda_ms(lambda: [c[0]() for c in calls]),
                device_ms=cuda_device_ms(lambda: [c[0]() for c in calls]),
                plain_ms=cuda_ms(lambda: [c[1]() for c in calls]),
                bound_ms=b, bound_by=by, library_ms=lib, max_abs_err=mode_err)
            if kernel.startswith("adasum"):
                row["by_mode"][mode]["two_pass_bound_ms"] = two_pass_bound_ms(ks)
            del calls
            torch.cuda.empty_cache()
    for kernel, row in rows.items():
        main = [row["by_mode"][m] for m in main_modes[kernel]
                if m in row["by_mode"]]
        keys = ("ms", "device_ms", "plain_ms", "bound_ms") + (
            ("two_pass_bound_ms",) if kernel.startswith("adasum") else ())
        for key in keys:
            row[key] = sum(m[key] for m in main)
        row["bound_by"] = ("bytes" if all(m["bound_by"] == "bytes"
                                          for m in main) else "operations")
        libs = [m["library_ms"] for m in main if m["library_ms"] is not None]
        row["library_ms"] = sum(libs) if libs else None
    return rows


def flat_buffer_checks(L: int) -> None:
    """ResNet-50's whole flat buffer, whose length does not divide the
    block, through the padding the path uses; and the reduce-scatter
    epilogues at eight synthetic senders."""
    import torch

    from horovod_tpu_torch.compression import _pad_to_block
    from horovod_tpu_torch.ops import kernels as K

    gen = torch.Generator(device="cuda").manual_seed(99)
    x = torch.randn(L, device=gen.device, generator=gen)
    _special_blocks(x, gen)
    xp = _pad_to_block(x, K.INT8_BLOCK)
    bad = _bits(K.quantize_roundtrip(xp), K.quantize_plain(xp, roundtrip=True))
    if bad:
        fail(f"quantize roundtrip at the flat buffer [{L}]: {bad}")
    s = -(-L // 8)
    sp = s + (-s) % 256
    for sig in (("dequant_accumulate", 8, sp),
                ("dequant_accumulate_requantize", 8, sp, 8),
                ("dequant_accumulate_requantize", 8, sp, 6),
                ("dequant_accumulate_requantize", 8, sp, 3),
                ("dequant_accumulate_requantize", 8, sp, None),
                ("dequantize_rows", 8, sp)):
        run, plain, compare = make_call(sig, gen)
        bad = compare(run(), plain())
        if bad:
            fail(f"{sig} (flat buffer, 8 senders): {bad}")


def adam_epilogue_check(L: int) -> dict:
    """B5's int8 epilogue at ``L`` (ZeRO-1's shard of ResNet-50, whose
    length does not divide the block) and at lengths shorter than a
    block: ``fused_adam_update(..., requant_block=256)`` against its plain
    version, bit for bit (update, moments, q and scales), with a NaN and
    an infinite gradient. Returns what was checked and its time."""
    import torch

    from horovod_tpu_torch.ops import kernels as K

    gen = torch.Generator(device="cuda").manual_seed(17)
    g = torch.randn(L, device=gen.device, generator=gen) * 1e-2
    mu = torch.randn(L, device=gen.device, generator=gen) * 1e-3
    nu = torch.rand(L, device=gen.device, generator=gen) * 1e-6
    g[300], g[1000] = math.nan, math.inf
    kw = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0)
    c = K.adam_constants(**kw, count=3)
    for n in (L, 1000, 7):
        *out, (q, sc) = K.fused_adam_update(g[:n], mu[:n], nu[:n], 3,
                                            requant_block=256, **kw)
        *ref, (rq, rsc) = K.fused_adam_requant_plain(g[:n], mu[:n], nu[:n], c)
        bad = _bits((*out, q, sc), (*ref, rq, rsc))
        if bad:
            fail(f"fused_adam requant epilogue at [{n}]: {bad}")
    return dict(lengths=[L, 1000, 7], bit_equal=True, ms=cuda_ms(
        lambda: K.fused_adam_update(g, mu, nu, 3, requant_block=256, **kw)))


def ptxas_usage(log: str) -> dict:
    """Registers and spills of each kernel, from ``-Xptxas -v``'s report."""
    import re

    usage, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            base = re.search(r"flash_fwd_(?:mma|f32)|[a-z_]+_kernel",
                             m.group(1).split("_cu_")[-1])
            args = re.findall(r"L[ib](\d+)E", m.group(1))
            if base and base.group(0) == "adam_kernel" \
                    and "I13__nv_bfloat16" in m.group(1):   # B5 on bf16
                args = ["bf16"] + args
            name = (base.group(0) if base else m.group(1)) + (
                f"<{', '.join(args)}>" if args else "")
            usage[name] = {}
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            usage[name].update(spill_stores=int(m.group(1)),
                               spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            usage[name]["registers"] = int(m.group(1))
    return usage


def adasum_extra_checks() -> list:
    """The Adasum combines at what the path does not give: zero operands
    (their coefficient is 0, and combine(0, 0) is 0), lengths that are no
    multiple of the kernel's chunk or a warp, an operand at an odd
    element offset (bit-equal to its aligned copy, which the kernel reads
    in vectors), every operand type, a segment of length 1 and an empty
    one, and packed 16-bit leaf tables whose leaves do not start on 16
    bytes. Each within the bar and bit-identical across two launches.
    Returns what was checked."""
    import torch

    from horovod_tpu_torch.ops import kernels as K

    gen = torch.Generator(device="cuda").manual_seed(11)
    dev = gen.device
    done = []

    def check(name, run, plain):
        out, ref = run(), plain()
        bad = _adasum_close(out, ref)
        if bad is None and not all(map(same_bits, out, run())):
            bad = "two launches on the same inputs differ"
        if bad:
            fail(f"adasum extra check {name}: {bad}")
        done.append(name)

    for L in (1, 7, 8193, 1 << 20):
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            buf = torch.randn(2 * L + 1, device=dev, generator=gen).to(dtype)
            a, b = buf[1:L + 1], buf[L + 1:]     # a at an odd element offset
            check(f"pair L={L} {dtype} odd offset",
                  lambda: (K.adasum_pair_combine(a, b),),
                  lambda: (K.adasum_pair_combine_plain(a, b),))
            # element loads at the odd offset, vector loads on the aligned
            # copies: the same groups, so the same bits
            if not same_bits(K.adasum_pair_combine(a, b),
                             K.adasum_pair_combine(a.clone(), b.clone())):
                fail(f"adasum extra check: pair L={L} {dtype} at an odd "
                     "offset differs from its aligned copy")
    z, b = torch.zeros(600, device=dev), torch.randn(600, device=dev,
                                                     generator=gen)
    check("pair zero a", lambda: (K.adasum_pair_combine(z, b),),
          lambda: (K.adasum_pair_combine_plain(z, b),))
    if bool(K.adasum_pair_combine(z, z).any()):
        fail("adasum extra check: combine(0, 0) is not 0")
    offsets = (0, 1000, 1001, 1001, 9500, 30000)   # length 1, empty, tails
    a = torch.randn(offsets[-1], device=dev, generator=gen)
    b = torch.randn(offsets[-1], device=dev, generator=gen)
    a[1001:9500] = 0.0                                # a zero segment of a
    check(f"segments {offsets}",
          lambda: (K.adasum_segment_combine(a, b, offsets),),
          lambda: (K.adasum_segment_combine_plain(a, b, offsets),))
    for dtype in (torch.bfloat16, torch.float16):  # leaves off 16 bytes
        a16, b16 = a.to(dtype), b.to(dtype)
        check(f"packed {dtype} {offsets}",
              lambda: (K.adasum_pair_combine_packed(a16, b16, offsets),),
              lambda: (K.adasum_segment_combine_plain(a16, b16, offsets),))
    return done


def flash_extra_checks() -> list:
    """flash_fwd against its plain version at shapes the path does not
    give: GQA, non-causal, a T that is not a multiple of the tile, head
    dim 128, f32 inputs. Returns the shapes checked."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(7)
    cases = [  # (q shape, kv heads, causal, dtype)
        ((8, 2048, 16, 64), 4, True, "bfloat16"),
        ((8, 2048, 16, 64), 16, False, "bfloat16"),
        ((8, 1000, 16, 64), 16, True, "bfloat16"),
        ((2, 512, 8, 128), 8, True, "bfloat16"),
        ((2, 300, 4, 64), 2, True, "float32"),
    ]
    done = []
    for (b, t, h, d), h_kv, causal, dtype in cases:
        qs, ks = (b, t, h, d), (b, t, h_kv, d)
        strides = lambda sh: (sh[1] * sh[2] * sh[3], sh[2] * sh[3], sh[3], 1)  # noqa: E731
        sig = ("flash_fwd", qs, ks, dtype, causal, d ** -0.5, strides(qs),
               strides(ks), strides(ks))
        run, plain, compare = make_call(sig, gen)
        bad = compare(run(), plain())
        if bad:
            fail(f"flash_fwd at {sig[1:5]}: {bad}")
        done.append(sig[1:5])
        del run, plain
    torch.cuda.empty_cache()
    return done


def flash_bwd_ms(sigs) -> float:
    """CUDA-event time of the plain flash backward of all the logged
    flash_fwd calls of one step, each at its call's shape and strides."""
    import torch

    from horovod_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(5)
    bwd = []
    for sig in sigs:
        run, _, _ = make_call(sig, gen)
        q, k, v, causal, scale = run.tensors
        out, lse = run()
        dout = torch.randn(out.shape, device=out.device,
                           generator=gen).to(out.dtype)
        bwd.append((q, k, v, out, lse, dout, causal, scale))
    return cuda_ms(lambda: [fa.flash_bwd(q, k, v, out, lse, dout, causal=c,
                                         sm_scale=s)
                            for q, k, v, out, lse, dout, c, s in bwd])


# --------------------------------------------------------------------------
# phase 3: a small input, GPU against CPU


def small_run(device: str) -> list:
    """Three ZeRO-1 int8 + EF fused-Adam steps of a narrow f32 ResNet in a
    world of one on ``device``; returns the losses."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import BottleneckBlock, ResNet

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = ResNet([1, 1, 1, 1], BottleneckBlock, num_filters=8,
                   num_classes=10, dtype=torch.float32, seed=7)
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(8, 32, 32, 3, generator=gen)
    y = torch.randint(0, 10, (8,), generator=gen)
    model.to(device)
    x, y = x.to(device), y.to(device)
    tx = hvd.DistributedOptimizer(hvd.fused_adam(1e-2),
                                  compression=hvd.Compression.int8,
                                  error_feedback=True, shard_optimizer=True)
    st = tx.init(model.jax_params())
    step = hvd.make_train_step(model, tx, shard_optimizer=True)
    losses = []
    for _ in range(3):
        st, loss = step(st, x, y)
        losses.append(float(loss))
    return losses


def cpu_reference() -> None:
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    try:
        print(json.dumps(small_run("cpu")))
    finally:
        hvd.shutdown()


# --------------------------------------------------------------------------
# phases 4 and 5: ResNet-50 end to end


def run_steps(mode: str, step, st, x, y, steps: int, label=None):
    """``steps`` calls of ``step(st, x, y)`` with every kernel-wrapper
    call logged, launch counts set to 0 just before; fails unless the
    loss is finite and falls on the repeated batch, the logged calls
    match the launch counts and every kernel of the mode's path launched
    (``NEED[mode]``; ``label`` names the run in messages, default
    ``mode``). Returns ``(st, losses, step seconds, launches, last step's
    calls)``."""
    from horovod_tpu_torch.ops import kernels as K

    need, mode = mode, label or mode

    calls: list = []
    K.reset_launches()                  # count the main path's run only
    losses, times = [], []
    with logging_calls(calls):
        for _ in range(steps):
            calls.append([])
            t0 = time.perf_counter()
            st, loss = step(st, x, y)
            losses.append(float(loss))  # device->host read fences the step
            times.append(time.perf_counter() - t0)
    launches = dict(K.launches)
    if not all(math.isfinite(v) for v in losses):
        fail(f"{mode}: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        fail(f"{mode}: loss did not fall on the repeated batch: {losses}")
    for k in K.KERNELS:
        logged = sum(sig[0] == k for c in calls for sig in c)
        if logged != launches[k]:
            fail(f"{mode}: {launches[k]} launches of {k} but {logged} "
                 "logged calls: a caller bypasses ops.kernels' wrappers")
    for k in NEED[need]:
        if launches[k] < 1:
            fail(f"{mode}: kernel {k} was not launched on the main path "
                 f"({launches})")
    return st, losses, times, launches, calls[-1]


def phase_timer():
    """``(marks, on_phase)``: a ``make_train_step`` phase hook that, once
    ``marks`` holds a start time, synchronises the device and records the
    time each part of the step ends."""
    import torch

    marks: dict = {}

    def on_phase(name):                 # armed only for the split step
        if marks:
            torch.cuda.synchronize()
            marks[name] = time.perf_counter()

    return marks, on_phase


def split_step(mode: str, step, st, x, y, marks) -> tuple:
    """One more step of ``step``, split into forward / backward /
    optimizer / loss allreduce by the phase hook: ``(st, {part: s})``."""
    import torch

    torch.cuda.synchronize()
    marks["start"] = time.perf_counter()
    st, loss = step(st, x, y)
    if not math.isfinite(float(loss)):
        fail(f"{mode}: non-finite loss {float(loss)} in the split step")
    names = list(marks)
    split = {b: marks[b] - marks[a] for a, b in zip(names, names[1:])}
    marks.clear()
    return st, split


def build_model(name: str, seed: int, device):
    """One of :data:`MODELS` at full width: bf16 compute, f32 parameters
    (and head), 1000 classes, random weights from ``seed``."""
    import torch

    from horovod_tpu_torch import models

    return getattr(models, MODELS[name][0])(dtype=torch.bfloat16, seed=seed,
                                            device=device)


def make_tx(mode: str, lr: float = 1e-3, bucket_bytes=None, loss_scale=None):
    """The DistributedOptimizer of each mode, fused Adam at ``lr``
    inside: ZeRO-1 and allreduce mode with int8 + EF (bucketed overlap
    with ``bucket_bytes``; under the numerics guard with ``loss_scale``),
    ZeRO-3 (its gather wire is
    ``HOROVOD_FSDP_WIRE``), Adasum with no compression (the grouped
    butterfly) and with ``Compression.fp16`` (the leaves packed in bf16,
    one combine of the leaf table a level), PowerSGD (rank
    :data:`PSGD_RANK`, EF)."""
    import horovod_tpu_torch as hvd

    adam = hvd.fused_adam(lr)
    if mode in ("zero1", "allreduce") + HIER_MODES:
        return hvd.DistributedOptimizer(
            adam, compression=hvd.Compression.int8, error_feedback=True,
            shard_optimizer=mode.startswith("zero1"),
            bucket_bytes=bucket_bytes, loss_scale=loss_scale,
            axis=PAIR if mode in HIER_MODES else None)
    if mode == "powersgd":
        return hvd.DistributedOptimizer(
            adam, compression=hvd.Compression.powersgd(PSGD_RANK),
            error_feedback=True)
    if mode.startswith("zero3"):
        return hvd.DistributedOptimizer(adam, shard_params=True,
                                        bucket_bytes=bucket_bytes)
    if mode == "adasum_fp16":
        return hvd.DistributedOptimizer(adam, op=hvd.Adasum,
                                        compression=hvd.Compression.fp16)
    return hvd.DistributedOptimizer(adam, op=hvd.Adasum)


def expected_launches(mode: str, n: int, leaves: int, buckets: int = 0
                      ) -> dict:
    """Exact kernel launches a step where the path fixes them: fused Adam
    once over the one f32 shard (ZeRO-1, ZeRO-3; under overlap over the
    ``buckets`` shards) or over all ``leaves``, ``ADAM_MAX_LEAVES`` a
    launch; ZeRO-3's gather runs twice (forward, and the backward's
    recompute) over the one f32 group; allreduce mode's fused int8
    exchange runs once over its one f32 group (PowerSGD's fallback leaves
    too), and under overlap once a bucket; ZeRO-1 quantizes and
    dequant-accumulates once a bucket (once without overlap); Adasum's
    butterfly has log2(N) levels, each one grouped combine (``adasum``)
    or one combine of the packed bf16 leaf table (``adasum_fp16``)."""
    from horovod_tpu_torch.ops import kernels as K

    levels = n.bit_length() - 1
    adam = {"fused_adam": 1 if mode.startswith(("zero1", "zero3"))
            else -(-leaves // K.ADAM_MAX_LEAVES)}
    if mode == "zero3":     # each bucket gathered twice
        k = buckets or 1
        return {"quantize": 2 * k, "dequantize_rows": 2 * k, **adam}
    if mode == "zero3_exact":
        return {"quantize": 0, "dequantize_rows": 0, **adam}
    if mode == "allreduce_hier":    # the EF roundtrip, then the cross hop's
        return {"quantize": 2, "dequant_accumulate": 0,
                "dequant_accumulate_requantize": 1, "dequantize_rows": 1,
                **adam}
    if mode == "zero1_hier":        # the chunked roundtrip, no int8 wire
        return {"quantize": 1, "dequant_accumulate": 0,
                "dequant_accumulate_requantize": 0, "dequantize_rows": 0,
                **adam}
    if mode == "zero1":
        k = buckets or 1
        return {"quantize": k, "dequant_accumulate": k,
                "dequant_accumulate_requantize": 0, "dequantize_rows": 0,
                **adam}
    if mode in ("allreduce", "powersgd"):
        k = buckets or 1
        return {"quantize": k, "dequant_accumulate": 0,
                "dequant_accumulate_requantize": k, "dequantize_rows": k,
                **adam}
    if mode == "adasum":
        return {"adasum_segment_combine": levels, "adasum_pair_combine": 0,
                **adam}
    if mode == "adasum_fp16":
        return {"adasum_segment_combine": 0, "adasum_pair_combine": levels,
                **adam}
    return adam


def expected_exchanges(mode: str, n: int) -> int:
    """Point-to-point exchanges (``batch_isend_irecv``) of one optimizer
    update: one a butterfly level in the Adasum modes, none elsewhere."""
    return n.bit_length() - 1 if mode.startswith("adasum") else 0


def overlap_label(mode: str, bucket_bytes: int) -> str:
    if mode.startswith("zero3"):        # gathered by bucket, no overlap
        return f"{mode}_bucketed_{bucket_bytes >> 20}MiB"
    return f"{mode}_overlap_{bucket_bytes >> 20}MiB"


def counted_exchange(tx, where: list):
    """``tx`` whose bucket exchanges count their collectives as the
    optimizer update's (the backward's hooks start them)."""
    exchange = tx.exchange

    def start(*args, **kw):
        ex = exchange(*args, **kw)
        launch = ex._launch

        def counted_launch(key):
            where.append("update")
            try:
                return launch(key)
            finally:
                where.pop()

        ex._launch = counted_launch
        return ex

    return tx._replace(exchange=start)


def overlap_checks(mode: str, model, step, st, x, y, bucket_bytes: int
                   ) -> tuple:
    """One more step through the gradient hooks, then the same exchange
    re-run after the backward on the same captured gradients: allreduce
    mode through the public ``bucketed_allreduce``, ZeRO-1 through the
    exchange's own per-bucket function; every bucket's reduced values and
    new residual bit for bit. Also times, with CUDA events, the last
    gradient hook to the last bucket's completion, and counts the buckets
    started from the backward. Returns ``(st, record)``."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import optim as O
    from horovod_tpu_torch.ops import overlap as ov

    events: dict = {}
    ready, launch = O.BucketExchange.ready, O.BucketExchange._launch

    def timed_ready(self, i, g):
        events["last_hook"] = torch.cuda.Event(enable_timing=True)
        events["last_hook"].record()
        return ready(self, i, g)

    def timed_launch(self, key):
        launch(self, key)
        events["last_done"] = torch.cuda.Event(enable_timing=True)
        events["last_done"].record(self.stream)

    before = st
    O.BucketExchange.ready, O.BucketExchange._launch = timed_ready, timed_launch
    try:
        st, loss = step(st, x, y)
    finally:
        O.BucketExchange.ready, O.BucketExchange._launch = ready, launch
    torch.cuda.synchronize()
    if not math.isfinite(float(loss)):
        fail(f"{mode}: non-finite loss in the overlap check step")
    ex = step.last_exchange
    done = ex.results()
    grads = model.jax_grads()
    keys = O.tree_keys(grads)
    if mode.startswith("allreduce"):
        red, res = ov.bucketed_allreduce(
            grads, hvd.Average, compression=hvd.Compression.int8,
            bucket_bytes=bucket_bytes, residual=before["residual"])
        hooked = ov.assemble({k: v[0] for k, v in done.items()}, ex.groups,
                             [tuple(grads[k].shape) for k in keys],
                             [grads[k].dtype for k in keys])
        pairs = [(a, red[k]) for a, k in zip(hooked, keys)]
        pairs += [(done[k][1], res[k]) for k in done]
    else:
        pairs = []
        leaves = [grads[k] for k in keys]
        for key, b in ex.groups.items():
            again = ex.run(key, ov.pack_group(leaves, b))
            pairs += [(done[key][0], again[0]), (done[key][1], again[1])]
    for a, b in pairs:
        if not same_bits(a, b):
            fail(f"{mode}: the hook route's exchange differs from the one "
                 "re-run after the backward on the same gradients")
    return st, dict(buckets=len(ex.order), started_in_backward=ex.in_backward,
                    started_with_leaves_pending=ex.early,
                    last_hook_to_done_ms=events["last_hook"].elapsed_time(
                        events["last_done"]),
                    hook_route_bit_equal=True)


def train(mode: str, steps: int, x, y, model_seed: int = 0,
          model_name: str = "resnet50", lr: float = 1e-3,
          bucket_bytes=None) -> dict:
    """``steps`` steps of ``model_name`` (:data:`MODELS`; ResNet-50 by
    default, the run then named ``mode``, else ``<model>_<mode>``) on
    this rank's batch ``x, y`` in one optimizer mode; fails unless the
    loss is finite and falls and every
    kernel of the mode's path launched (exactly as often as
    :func:`expected_launches` says), the optimizer update made exactly
    :func:`expected_exchanges` point-to-point exchanges a step and, in
    allreduce mode, exactly :func:`allreduce_nccl_calls` NCCL calls.
    ``nccl_calls`` is the collective calls a step, in the optimizer update
    and in the rest of the step (running stats, loss);
    ``step_calls`` is the kernel calls
    of the last step; ``split_s`` one more step split into its parts;
    ``checksum`` sums the full parameters (unpacked from the shards under
    ZeRO-3)."""
    import torch

    import horovod_tpu_torch as hvd

    dev = hvd.device()
    label = mode if model_name == "resnet50" else f"{model_name}_{mode}"
    if bucket_bytes:
        label = overlap_label(label, bucket_bytes)
    model = build_model(model_name, model_seed, dev)
    leaves = len(model.jax_params())
    param_bytes = sum(p.numel() * p.element_size()
                      for p in model.jax_params().values())
    nccl_want = allreduce_nccl_calls(list(model.jax_params().values()))
    with torch.no_grad():           # before ZeRO-3 empties the parameters
        logits = model(x)
    if tuple(logits.shape) != (x.shape[0], 1000) or not bool(
            torch.isfinite(logits).all()):
        fail(f"{model_name} logits: shape {tuple(logits.shape)} or "
             "non-finite")
    del logits
    zero3 = mode.startswith("zero3")
    wire = os.environ.pop("HOROVOD_FSDP_WIRE", None)
    if zero3:
        os.environ["HOROVOD_FSDP_WIRE"] = ("none" if mode == "zero3_exact"
                                           else "int8")
    hier = mode in HIER_MODES
    if hier:        # 1 x 1 on one GPU, 2 x 2 at four
        from horovod_tpu_torch.ops import hierarchical
        from horovod_tpu_torch.parallel.mesh import build_host_mesh

        build_host_mesh(local=HIER_LOCAL if hvd.size() > 1 else 1)
        hierarchical.set_hierarchical(True)
    nccl, where, by_group = {}, ["step"], {}
    try:
        tx = make_tx(mode, lr, bucket_bytes)
        if tx.exchange is not None:
            tx = counted_exchange(tx, where)
        update = tx.update

        def counted_update(*args, **kw):    # the optimizer update's calls
            where.append("update")
            try:
                return update(*args, **kw)
            finally:
                where.pop()

        tx = tx._replace(update=counted_update)
        marks, on_phase = phase_timer()
        step = hvd.make_train_step(model, tx,
                                   shard_optimizer=mode.startswith("zero1"),
                                   shard_params=zero3, on_phase=on_phase)
        st = tx.init(step.params if zero3 else model.jax_params())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with counting_collectives(nccl, where, by_group):
            st, losses, times, launches, calls = run_steps(
                mode, step, st, x, y, steps, label=label)
        peak = torch.cuda.max_memory_allocated()
        st, split = split_step(label, step, st, x, y, marks)
        overlap = None
        if bucket_bytes and not zero3:
            st, overlap = overlap_checks(label, model, step, st, x, y,
                                         bucket_bytes)
    finally:
        os.environ.pop("HOROVOD_FSDP_WIRE", None)
        if wire is not None:
            os.environ["HOROVOD_FSDP_WIRE"] = wire
        if hier:
            hierarchical.set_hierarchical(None)
    buckets = 0
    if bucket_bytes:
        buckets = len(step.params.shards) if zero3 else len(
            step.last_exchange.order)
    if bucket_bytes and buckets != -(-param_bytes // bucket_bytes):
        fail(f"{label}: {buckets} buckets of {bucket_bytes} bytes")
    for k, per_step in expected_launches(mode, hvd.size(), leaves,
                                         buckets).items():
        if launches[k] != per_step * steps:
            fail(f"{label}: {launches[k]} launches of {k} in {steps} steps, "
                 f"expected {per_step} a step ({launches})")
    p2p = nccl.get("update", {}).get("batch_isend_irecv", 0)
    if p2p != expected_exchanges(mode, hvd.size()) * steps:
        fail(f"{label}: the optimizer update made {p2p} point-to-point "
             f"exchanges in {steps} steps, expected "
             f"{expected_exchanges(mode, hvd.size())} a step")
    if bucket_bytes:    # per bucket; ZeRO-1's gather once for the dtype
        nccl_want = 4 * buckets if mode == "allreduce" else 2 * buckets + 1
    elif mode == "powersgd":    # every P, every Q', then allreduce mode's
        nccl_want += 2
    if mode in ("allreduce", "powersgd") or (bucket_bytes and not zero3):
        if sum(nccl.get("update", {}).values()) != nccl_want * steps:
            fail(f"{label}: the optimizer update made {nccl.get('update')} "
                 f"NCCL calls in {steps} steps, expected {nccl_want} a step")
    factorized = None
    if mode == "powersgd":
        factorized = sorted(k for k, q in st["q"].items() if q is not None)
        rule = sorted(k for k, p in model.jax_params().items()
                      if hvd.Compression.powersgd(PSGD_RANK).factorizes(
                          tuple(p.shape), p.dtype))
        if factorized != rule or len(rule) != 2:
            fail(f"{label}: factorized leaves {factorized}, the rule says "
                 f"{rule} (the stem conv and the head)")
    if zero3:       # each group gathered twice, reduce-scattered once
        k = len(step.params.shards)
        got = nccl.get("step", {})
        gathers = got.get("all_gather_into_tensor", 0) + got.get(
            "all_gather_single", 0)
        scatters = got.get("reduce_scatter_tensor", 0) + got.get(
            "reduce_scatter_single", 0)
        per_gather = 1 if mode == "zero3_exact" else 2  # int8: q, scales
        if gathers != 2 * k * per_gather * steps or scatters != k * steps:
            fail(f"{label}: {gathers} all-gathers and {scatters} "
                 f"reduce-scatters in {steps} steps of {k} groups")
    if hier:        # the int8 wire rides CROSS only
        int8_on = sorted(g for g, rec in by_group.items()
                         if rec["bytes"].get("int8"))
        want = ["CROSS"] if mode == "allreduce_hier" else []
        if int8_on != want:
            fail(f"{label}: int8 bytes on {int8_on}, expected {want} "
                 f"({by_group})")
    by_group = {g: {"calls": rec["calls"] / steps,
                    "bytes": {k: v / steps for k, v in rec["bytes"].items()}}
                for g, rec in by_group.items()}
    nccl = {part: {k: v / steps for k, v in c.items()}
            for part, c in nccl.items()}
    params = hvd.fsdp_unpack_params(step.params) if zero3 else model.jax_params()
    checksum = float(sum(p.detach().double().sum() for p in params.values()))
    params_sha = hashlib.sha256(b"".join(
        params[k].detach().reshape(-1).float().cpu().numpy().tobytes()
        for k in sorted(params))).hexdigest()
    steady = times[1:] if len(times) > 1 else times
    return dict(mode=label, model=model_name, leaves=leaves,
                params=sum(p.numel() for p in params.values()),
                steps=steps, losses=losses, launches=launches,
                step_s=times, img_per_s=x.shape[0] * len(steady) / sum(steady),
                peak_gib=peak / 2 ** 30, split_s=split, checksum=checksum,
                params_sha=params_sha, nccl_by_group=by_group,
                buckets=buckets,
                nccl_calls=nccl, nccl_update_want=nccl_want, overlap=overlap,
                factorized=factorized, step_calls=calls)


def adasum_replay(x, y) -> dict:
    """The combine rank 0 makes at level 1 of a world of two, on one GPU:
    ResNet-50's gradient trees on ``x, y``'s two halves (rank 0's rows,
    then rank 1's) through the port's own functions: ``_segment_combine``
    (the grouped route, one f32 group); ``adasum_pair_combine_packed``
    over the leaves packed (``_leaf_table``, ``_pack``) in bf16 (the compressed route; ``Compression.fp16``
    puts bf16 on the wire) and in f16; ``_pair_combine`` per leaf in
    bf16, f16 and f32. Every call is logged; the grouped and the packed
    bf16 ones are the replay's launches. Each combine must agree with its
    plain version on the same operands, each packed leaf equal its
    per-leaf combine bit for bit, and the grouped result the per-leaf
    f32 one. ``projection`` is each leaf's ``|a·b| / (2 min(|a|²,
    |b|²))`` over the leaves where both are nonzero (min, median, max):
    how far these correlated halves put the combine from a plain sum;
    ``zero_leaves`` counts the leaves with a zero operand."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import adasum as A
    from horovod_tpu_torch.ops import kernels as K
    from horovod_tpu_torch.optim import tree_keys

    model = build_model("resnet50", 0, hvd.device())
    model.train()
    half = x.shape[0] // 2
    trees = []
    for rows in (slice(0, half), slice(half, None)):
        for p in model.parameters():
            p.grad = None
        hvd.softmax_xent(model(x[rows]), y[rows]).backward()
        g = model.jax_grads()
        # contiguous, as adasum_allreduce hands them to the combine
        trees.append([g[k].contiguous() for k in tree_keys(g)])
    del model
    ga, gb = trees
    sizes = tuple(a.numel() for a in ga)
    wires = (torch.bfloat16, torch.float16)
    dtypes = wires + (torch.float32,)
    name = {d: str(d).replace("torch.", "") for d in dtypes}
    calls: list = []
    modes = []
    K.reset_launches()
    with logging_calls(calls):
        calls.append([])
        modes.append("adasum_l1_replay_grouped")
        (fa, offsets), (fb, _) = A._flatten_group(ga), A._flatten_group(gb)
        grouped = A._segment_combine(fa, fb, offsets)
        packed = {}
        for dtype in wires:
            calls.append([])
            modes.append(f"adasum_l1_replay_packed_{name[dtype]}")
            starts, table = A._leaf_table(sizes, dtype.itemsize)
            pa, pb = (A._pack([t.to(dtype) for t in tree], table)
                      for tree in (ga, gb))
            packed[dtype] = (K.adasum_pair_combine_packed(pa, pb, table), pa,
                             pb, table, starts)
            if dtype == torch.bfloat16:  # the replay's launches
                launches = dict(K.launches)
        leaf = {}
        for dtype in dtypes:
            calls.append([])
            modes.append(f"adasum_l1_replay_leaf_{name[dtype]}")
            leaf[dtype] = [A._pair_combine(a.to(dtype), b.to(dtype))
                           for a, b in zip(ga, gb)]
        torch.cuda.synchronize()
    for k in K.KERNELS:
        logged = sum(sig[0] == k for c in calls for sig in c)
        if logged != K.launches[k]:
            fail(f"adasum_l1: {K.launches[k]} launches of {k} but {logged} "
                 "logged calls")
    want = {"adasum_segment_combine": 1, "adasum_pair_combine": 1}
    if any(launches[k] != v for k, v in want.items()):
        fail(f"adasum_l1: launches {launches}, expected {want}")
    err = 0.0
    ref = K.adasum_segment_combine_plain(fa, fb, offsets)
    bad = _adasum_close((grouped,), (ref,))
    if bad:
        fail(f"adasum_l1: the grouped combine against its plain version: {bad}")
    err = max(err, max_abs(grouped, ref))
    for dtype, (out, pa, pb, table, starts) in packed.items():
        ref = K.adasum_segment_combine_plain(pa, pb, table)
        bad = _adasum_close((out,), (ref,))
        if bad:
            fail(f"adasum_l1: the packed {name[dtype]} combine against its "
                 f"plain version: {bad}")
        err = max(err, max_abs(out, ref))
        for i, (lo, own) in enumerate(zip(starts, leaf[dtype])):
            if not same_bits(out[lo:lo + own.numel()], own.reshape(-1)):
                fail(f"adasum_l1: leaf {i} of the packed {name[dtype]} "
                     "combine differs from its per-leaf combine")
    for dtype in dtypes:
        for i, (a, b, out) in enumerate(zip(ga, gb, leaf[dtype])):
            ref = K.adasum_pair_combine_plain(a.to(dtype), b.to(dtype))
            bad = _adasum_close((out,), (ref,))
            if bad:
                fail(f"adasum_l1: leaf {i} in {name[dtype]} against its plain "
                     f"version: {bad}")
            err = max(err, max_abs(out, ref))
    for i, (lo, hi) in enumerate(zip(offsets, offsets[1:])):
        if not same_bits(grouped[lo:hi], leaf[torch.float32][i].reshape(-1)):
            fail(f"adasum_l1: the grouped combine of leaf {i} differs from "
                 "its per-leaf f32 combine")
    sums = [((a.double() * b.double()).sum(), torch.minimum(
        a.double().square().sum(), b.double().square().sum()))
        for a, b in zip(ga, gb)]
    # over the leaves whose operands are both nonzero (a zero-initialised
    # BatchNorm scale zeroes the gradient of the conv before it)
    proj = torch.stack([dot.abs() / (2 * n) for dot, n in sums if n > 0])
    return dict(mode="adasum_l1_replay", leaves=len(ga),
                group_elements=offsets[-1], launches=launches,
                packed_bit_equal_per_leaf=[name[d] for d in wires],
                max_abs_err_vs_plain=err,
                projection=[float(proj.min()), float(proj.median()),
                            float(proj.max())],
                zero_leaves=sum(int(n == 0) for _, n in sums),
                step_calls=dict(zip(modes, calls)))


def train_lm(steps: int, powersgd_rank=None, loss_scale=None) -> dict:
    """The LM slice: ``steps`` steps of the flagship TransformerLM through
    ``make_train_step`` with ``DistributedOptimizer(adamw(1e-4))`` and
    ``lm_xent``; fails unless the loss is finite and falls and flash_fwd
    launched once per layer and step. Then one more step of the same step
    function, split into its parts (``make_train_step``'s ``on_phase``)
    by synchronised host timers. With ``powersgd_rank`` (run
    ``lm_powersgd``) the optimizer syncs PowerSGD factors with EF: the
    factorized leaves must be those the wire-cost rule names, and the
    other float leaves' int8 exchange runs once a step. With
    ``loss_scale`` (run ``lm_guarded``) the optimizer is under the
    numerics guard with dynamic loss scaling: no step may be BAD and the
    scale stays where it started; after the split step, :func:`update_cost`
    of the guarded update and ``DistributedOptimizer(adamw(1e-4))``'s on
    one more backward's gradients. The optimizer update's NCCL calls are
    counted (``nccl_update``, a step)."""
    import numpy as np
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import TransformerLM

    marks, on_phase = phase_timer()
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 matmuls in f32
    dev = hvd.device()
    model = TransformerLM(**LM, dtype=torch.bfloat16,
                          attention_fn=hvd.flash_attention, seed=0, device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    tok = np.random.RandomState(0).randint(
        0, LM["vocab"], (LM_BATCH, LM_SEQ)).astype(np.int32)
    x = torch.from_numpy(tok).to(dev)
    y = torch.from_numpy(np.roll(tok, -1, axis=1)).to(dev)
    mode = "lm" if powersgd_rank is None else "lm_powersgd"
    if loss_scale is not None:
        mode = "lm_guarded"
    comp = None if powersgd_rank is None else hvd.Compression.powersgd(
        powersgd_rank)
    tx = hvd.DistributedOptimizer(hvd.adamw(1e-4), compression=comp,
                                  error_feedback=comp is not None,
                                  loss_scale=loss_scale)
    st = tx.init(model.jax_params())
    nccl, where = {}, ["step"]
    update = tx.update

    def counted_update(*args, **kw):
        where.append("update")
        try:
            return update(*args, **kw)
        finally:
            where.pop()

    step = hvd.make_train_step(model, tx._replace(update=counted_update),
                               loss_fn=hvd.lm_xent, on_phase=on_phase)
    with torch.no_grad():
        logits = model(x)
    if tuple(logits.shape) != (LM_BATCH, LM_SEQ, LM["vocab"]) or not bool(
            torch.isfinite(logits).all()):
        fail(f"LM logits: shape {tuple(logits.shape)} or non-finite")
    del logits
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with counting_collectives(nccl, where):
        st, losses, times, launches, calls = run_steps(mode, step, st, x, y,
                                                       steps)
    guard = cost = None
    if loss_scale is not None:
        from horovod_tpu_torch.resilience import numerics

        guard = numerics.verdict(st)
        if guard["bad_count"] or guard["loss_scale"] != GUARD_SCALE:
            fail(f"{mode}: a BAD step, or the scale moved: {guard}")
    if launches["flash_fwd"] != LM["depth"] * steps:
        fail(f"{mode}: {launches['flash_fwd']} flash_fwd launches in {steps} "
             f"steps of a depth-{LM['depth']} model ({launches})")
    psgd = None
    if comp is not None:
        for k in ("quantize", "dequant_accumulate_requantize",
                  "dequantize_rows"):
            if launches[k] != steps:
                fail(f"{mode}: {launches[k]} launches of {k} in {steps} "
                     "steps, expected one a step (the fallback leaves' "
                     "grouped int8 exchange)")
        params = model.jax_params()
        rule = sorted(k for k, p in params.items()
                      if comp.factorizes(tuple(p.shape), p.dtype))
        got = sorted(k for k, q in st["q"].items() if q is not None)
        if got != rule or not rule:
            fail(f"{mode}: factorized leaves {got}, the rule says {rule}")
        psgd = dict(rank=powersgd_rank, factorized=len(got),
                    leaves=len(params), **wire_bytes(params, comp))
    peak = torch.cuda.max_memory_allocated()
    st, split = split_step(mode, step, st, x, y, marks)
    if loss_scale is not None:
        from horovod_tpu_torch.resilience import numerics

        params = model.jax_params()
        loss, g = _grads_of(model, x, y, hvd.lm_xent)
        scale = numerics.current_scale(st)
        cost = update_cost({
            "plain": (hvd.DistributedOptimizer(hvd.adamw(1e-4)).update,
                      _int_counts(_clone(st.inner)), g, params, {}),
            "guarded": (tx.update, _clone(st),
                        {k: v * scale.to(v.dtype) for k, v in g.items()},
                        params, {"loss": loss})})
        del params, loss, g
        torch.cuda.empty_cache()
    steady = times[1:]
    return dict(mode=mode, steps=steps, params=n_params, losses=losses,
                launches=launches, step_s=times,
                tokens_per_s=LM_BATCH * LM_SEQ * len(steady) / sum(steady),
                peak_gib=peak / 2 ** 30, split_s=split, powersgd=psgd,
                split_step_s=sum(split.values()), guard=guard,
                update_cost=cost,
                nccl_update={k: v / steps
                             for k, v in nccl.get("update", {}).items()},
                step_calls=calls)


def wire_bytes(params: dict, comp) -> dict:
    """One transfer direction's wire bytes a step of ``params`` under
    ``comp`` (its ``wire_bytes``: P and Q in f32 for a factorized leaf,
    int8 and bf16 scales for the int8 fallback), beside f32."""
    total = sum(comp.wire_bytes(tuple(p.shape), p.dtype)
                for p in params.values())
    f32 = sum(p.numel() * 4 for p in params.values())
    return dict(wire_bytes=total, f32_bytes=f32, wire_over_f32=total / f32)


def train_multisteps(steps: int, x, y) -> dict:
    """``backward_passes_per_step=2`` on ResNet-50 (allreduce mode, int8 +
    EF, fused Adam): the exchange and the update run on every second
    step only. Fails unless a step that does not emit makes no NCCL call
    in the optimizer update and launches no kernel, one that emits makes
    allreduce mode's calls and launches, and the loss falls across an
    emit. Then :func:`multisteps_guard_syncs`."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import kernels as K

    dev = hvd.device()
    model = build_model("resnet50", 0, dev)
    params = model.jax_params()
    tx = hvd.DistributedOptimizer(hvd.fused_adam(1e-3),
                                  compression=hvd.Compression.int8,
                                  error_feedback=True,
                                  backward_passes_per_step=2)
    where = ["step"]
    update = tx.update

    def counted_update(*args, **kw):
        where.append("update")
        try:
            return update(*args, **kw)
        finally:
            where.pop()

    step = hvd.make_train_step(model, tx._replace(update=counted_update))
    st = tx.init(params)
    want = allreduce_nccl_calls(list(params.values()))
    adam = -(-len(params) // K.ADAM_MAX_LEAVES)
    losses, per_step, times = [], [], []
    for i in range(steps):
        nccl: dict = {}
        calls: list = [[]]
        K.reset_launches()
        t0 = time.perf_counter()
        with counting_collectives(nccl, where), logging_calls(calls):
            st, loss = step(st, x, y)
            losses.append(float(loss))
        times.append(time.perf_counter() - t0)
        emit = i % 2 == 1
        got = sum(nccl.get("update", {}).values())
        launches = {k: v for k, v in K.launches.items() if v}
        want_launches = ({"quantize": 1, "dequant_accumulate_requantize": 1,
                          "dequantize_rows": 1, "fused_adam": adam}
                         if emit else {})
        if got != (want if emit else 0) or launches != want_launches:
            fail(f"multisteps step {i}: {got} NCCL calls in the update and "
                 f"launches {launches}, expected "
                 f"{want if emit else 0} and {want_launches}")
        if int(st.mini_step) != (i + 1) % 2:
            fail(f"multisteps step {i}: mini_step {int(st.mini_step)}")
        per_step.append(dict(emit=emit, nccl_update=got, launches=launches))
    # the parameters move only at the first emit: the first two losses
    # are of the same weights (within the forward's own noise)
    if not all(math.isfinite(v) for v in losses) or \
            not losses[-1] < losses[0] or \
            abs(losses[1] - losses[0]) > 1e-3 * abs(losses[0]):
        fail(f"multisteps: losses {losses} (the same until the first emit, "
             "then falling)")
    torch.cuda.synchronize()
    syncs = multisteps_guard_syncs(model, x, y)
    return dict(mode="multisteps", steps=steps, losses=losses,
                per_step=per_step, step_s=times, step_calls=calls[-1],
                guard_host_syncs=syncs,
                launches={k: sum(p["launches"].get(k, 0) for p in per_step)
                          for k in K.KERNELS})


def multisteps_guard_syncs(model, x, y) -> list:
    """The numerics guard over ``backward_passes_per_step=2`` (allreduce
    mode, int8 + EF, fused Adam, ``loss_scale="dynamic"``): three
    updates from a fresh state on one backward's gradients (one that
    does not emit, one that does, one that does not), the inner update
    run quietly and the guard's own code under
    ``torch.cuda.set_sync_debug_mode("warn")``, whose warnings of a
    synchronizing operation are counted. The counters that
    ``multi_steps`` branches on live on the host, so a BAD micro-step's
    keeping them costs the guard one read of its verdict an update.
    Fails unless each update synchronised the host exactly once, and the
    second emitted. Returns the Python stack of each update's syncs,
    innermost first."""
    import traceback
    import warnings

    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.resilience import numerics

    dtx = hvd.DistributedOptimizer(hvd.fused_adam(1e-3),
                                   compression=hvd.Compression.int8,
                                   error_feedback=True,
                                   backward_passes_per_step=2)
    gtx = numerics.guard(dtx._replace(update=_quietly(dtx.update, "warn")),
                         loss_scale="dynamic")
    params = model.jax_params()
    st = gtx.init(params)
    loss, g = _grads_of(model, x, y)
    scale = numerics.current_scale(st)
    g = {k: v * scale.to(v.dtype) for k, v in g.items()}
    per_update = []

    def note(message, *args, **kw):
        if "called a synchronizing" in str(message):
            frames = [f for f in traceback.extract_stack()[:-1][::-1]
                      if not f.filename.endswith("warnings.py")][:6]
            seen.append(" < ".join(f"{os.path.basename(f.filename)}:"
                                   f"{f.lineno}" for f in frames))

    for _ in range(3):
        seen: list = []
        torch.cuda.synchronize()
        with warnings.catch_warnings(), torch.no_grad():
            warnings.simplefilter("always")
            warnings.showwarning = note
            torch.cuda.set_sync_debug_mode("warn")
            try:
                _, st = gtx.update(dict(g), st, params, loss=loss)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        per_update.append(seen)
    if [len(p) for p in per_update] != [1, 1, 1] or \
            int(st.inner.gradient_step) != 1 or int(st.bad_count):
        fail(f"multisteps_guarded: host syncs in the guard's code, by "
             f"update: {per_update} (expected one each: the read of the "
             f"verdict for the host counters); gradient_step "
             f"{int(st.inner.gradient_step)}, bad_count {int(st.bad_count)}")
    return per_update


# --------------------------------------------------------------------------
# phase 16: the numerics guard and dynamic loss scaling


#: the guarded runs' NaN charge (grad_nan_at_step, the guard's counter)
GUARD_NAN = 6
#: steps of each guarded ResNet-50 run: the good ones, the NaN step, one more
GUARD_STEPS = GUARD_NAN + 2
#: the loss scale loss_scale="dynamic" starts at (HOROVOD_NUMERICS_SCALE_INIT)
GUARD_SCALE = 2.0 ** 15
#: the guarded run with bf16 parameters (B5's bf16 kernel on the path)
BF16_STEPS = 4
BF16_MODE = "resnet50_bf16_guarded"


def _int_counts(tree):
    """A state tree with every Adam ``count`` tensor as a Python int: the
    unguarded optimizer's form of the guard's device count."""
    import torch

    if isinstance(tree, dict):
        return type(tree)((k, int(v.item()) if k == "count"
                           and isinstance(v, torch.Tensor) and v.dim() == 0
                           else _int_counts(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        items = [_int_counts(v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else type(tree)(items)
    return tree


def _grads_of(model, x, y, loss_fn=None):
    """One unscaled forward and backward of ``model`` (``loss_fn`` default
    ``softmax_xent``): ``(loss, the gradients as the optimizer's leaves,
    cloned)``."""
    import horovod_tpu_torch as hvd

    model.train()
    for p in model.parameters():
        p.grad = None
    loss = (loss_fn or hvd.softmax_xent)(model(x), y)
    loss.backward()
    return loss.detach(), {k: v.detach().clone()
                           for k, v in model.jax_grads().items()}


def _quietly(update, mode):
    """``update`` run with the sync check off, and ``mode`` set again
    after it: the inner optimizer's update is not the guard's code."""
    import torch

    def quiet(*args, **kw):
        torch.cuda.set_sync_debug_mode(0)
        try:
            return update(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(mode)

    return quiet


#: the update alone with and without the guard: turns of each side, and
#: updates back to back a turn
COST_TURNS, COST_ITERS = 6, 5


def update_cost(sides: dict) -> dict:
    """The optimizer update alone, ``sides`` ``{"plain": ..., "guarded":
    ...}`` each ``(update, state, grads, params, keywords)``: every side
    from its own state, carried from update to update as a training loop
    carries it, on the same gradients (the guarded side's scaled by its
    loss scale). CUDA events around :data:`COST_ITERS` updates back to
    back (the call and its work on the card) and a host clock around
    the same calls (the host's time to issue them), in turns (plain,
    guarded, guarded, plain, ...) for :data:`COST_TURNS` turns. Returns
    each side's ms an update, their medians, and the guard's cost as the
    difference of the medians."""
    import statistics

    import torch

    state = {name: side[1] for name, side in sides.items()}

    def run(name, n):
        update, _, grads, params, kw = sides[name]
        st = state[name]
        for _ in range(n):
            _, st = update(dict(grads), st, params, **kw)
        state[name] = st

    for name in sides:                  # warm up: allocator, plans
        run(name, 2)
    ms = {name: [] for name in sides}
    host = {name: [] for name in sides}
    order = ["plain", "guarded"]
    with torch.no_grad():
        for turn in range(COST_TURNS):
            for name in (order if turn % 2 == 0 else order[::-1]):
                s = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                s.record()
                t0 = time.perf_counter()
                run(name, COST_ITERS)
                host[name].append((time.perf_counter() - t0) * 1e3
                                  / COST_ITERS)
                e.record()
                e.synchronize()
                ms[name].append(s.elapsed_time(e) / COST_ITERS)
    med = {name: statistics.median(v) for name, v in ms.items()}
    med_host = {name: statistics.median(v) for name, v in host.items()}
    return dict(ms=ms, host_ms=host, median_ms=med, median_host_ms=med_host,
                guard_ms=med["guarded"] - med["plain"],
                guard_host_ms=med_host["guarded"] - med_host["plain"])


def guard_checks(mode: str, model, tx, st, x, y, bucket_bytes=None) -> dict:
    """From the guarded run's last state, on the gradients of one more
    backward (unscaled): (a) the guarded update of those gradients scaled
    by the state's loss scale (a power of two) against the unguarded
    optimizer's update of them from the same inner state (its count an
    int: the kernel takes the bias corrections by value there, through
    the device buffer here): every update, moment and residual bit for
    bit; (b) the same guarded update with the inner optimizer's update
    run quietly and the rest — the prepare, the square sums, the
    all-gather, the verdict, the select, the -0.0 discard and the
    scale's arithmetic — under ``torch.cuda.set_sync_debug_mode("error")``,
    which raises at any host sync; (c) :func:`update_cost` of the two
    updates of (a)."""
    import torch

    from horovod_tpu_torch.resilience import numerics

    params = model.jax_params()
    loss, g = _grads_of(model, x, y)
    scale = numerics.current_scale(st)
    if float(scale) != 2.0 ** round(math.log2(float(scale))):
        fail(f"{mode}_guarded: loss scale {float(scale)} is not a power of 2")
    scaled = {k: v * scale.to(v.dtype) for k, v in g.items()}
    plain = make_tx(mode, bucket_bytes=bucket_bytes)
    with torch.no_grad():
        ug, sg = tx.update(dict(scaled), _clone(st), params, loss=loss)
        uu, su = plain.update(dict(g), _int_counts(_clone(st.inner)), params)
    bad = [k for k in ug if not same_bits(ug[k], uu[k])]
    bad_state = _tree_mismatch(_int_counts(sg.inner), su)
    if bad or bad_state:
        fail(f"{mode}_guarded: a good guarded step differs from the unguarded "
             f"step on the same gradients: updates {bad[:5]}, inner state "
             f"leaves {bad_state[:5]}")
    dtx = make_tx(mode, bucket_bytes=bucket_bytes)
    gtx = numerics.guard(dtx._replace(update=_quietly(dtx.update, "error")),
                         loss_scale="dynamic")
    st2 = _clone(st)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        u2, s2 = gtx.update(dict(scaled), st2, params, loss=loss)
    except RuntimeError as e:
        fail(f"{mode}_guarded: the guard's own code synchronised the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    if [k for k in ug if not same_bits(ug[k], u2[k])]:
        fail(f"{mode}_guarded: the guard under the sync check disagrees")
    cost = update_cost({
        "plain": (plain.update, _int_counts(_clone(st.inner)), g, params, {}),
        "guarded": (tx.update, _clone(st), scaled, params, {"loss": loss})})
    return dict(good_step_bit_equal_to_unguarded=True,
                guard_code_host_syncs=0, update_cost=cost)


def _hook_rerun(raw_tx, model, s0, p0, loss, after) -> list:
    """The guarded update of this step's gradients after the backward (the
    exchange re-run on them, not started from the hooks) from the state
    and parameters before the step: where it differs from what the hook
    route gave (``after``: parameters and state), bit for bit."""
    import torch

    with torch.no_grad():
        u, s = raw_tx._replace(exchange=None).update(
            dict(model.jax_grads()), s0, p0, loss=loss)
        p = {k: p0[k] + u[k] for k in p0}
    return _tree_mismatch(p, after[0]) + _tree_mismatch(s, after[1])


def train_guarded(mode: str, x, y, bucket_bytes=None, base=None) -> dict:
    """:data:`GUARD_STEPS` steps of ResNet-50 (batch 64, int8 + EF, fused
    Adam, allreduce mode or ZeRO-1) under ``DistributedOptimizer(...,
    loss_scale="dynamic")`` through ``make_train_step``, with
    ``HOROVOD_CHAOS=grad_nan_at_step=`` :data:`GUARD_NAN` armed. Fails
    unless the losses are finite and fall; the launches are the
    unguarded mode's a step (:func:`expected_launches`: the guard adds no
    kernel); the optimizer update's NCCL calls are the unguarded run's
    (``base``) plus the guard's one all-gather a step; every step but the
    NaN step is good, and the NaN step keeps every parameter (a -0.0 set
    just before it among them) and every inner state tensor (moments,
    EF residuals) bit for bit, halves the scale, makes ``bad_count`` 1
    and consumes the charge once. With ``bucket_bytes`` the buckets start
    from the backward's hooks, and at the NaN step and the good step
    after it the whole update is re-run after the backward on the same
    gradients from the same state: bit-equal. img/s is taken over steps
    1 to ``GUARD_NAN - 1``, before any of those checks. Then
    :func:`guard_checks`."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import collective as C
    from horovod_tpu_torch.ops import kernels as K
    from horovod_tpu_torch.resilience import chaos, numerics

    dev = hvd.device()
    label = f"{mode}_guarded"
    if bucket_bytes:
        label = overlap_label(label, bucket_bytes)
    model = build_model("resnet50", 0, dev)
    leaves = len(model.jax_params())
    raw = make_tx(mode, bucket_bytes=bucket_bytes, loss_scale="dynamic")
    nccl, where = {}, ["step"]
    tx = counted_exchange(raw, where) if raw.exchange is not None else raw
    update = tx.update

    def counted_update(*args, **kw):
        where.append("update")
        try:
            return update(*args, **kw)
        finally:
            where.pop()

    tx = tx._replace(update=counted_update)
    step = hvd.make_train_step(model, tx, shard_optimizer=mode == "zero1")
    st = tx.init(model.jax_params())
    chaos.reset()
    chaos.configure(f"grad_nan_at_step={GUARD_NAN}")
    calls: list = []
    losses, times, verdicts, reruns = [], [], [], {}
    nan = None
    torch.cuda.synchronize()
    K.reset_launches()                  # count the guarded run only
    with counting_collectives(nccl, where), logging_calls(calls):
        for t in range(GUARD_STEPS):
            calls.append([])
            if t == GUARD_NAN:
                with torch.no_grad():
                    model.jax_params()["head/bias"][0] = -0.0
            # after the timed window (steps 1 to GUARD_NAN - 1): the
            # clones grow the allocator, which slows the step they precede
            check = bucket_bytes and t in (GUARD_NAN, GUARD_NAN + 1)
            if t == GUARD_NAN or check:
                s0, p0 = _clone(st), _clone(model.jax_params())
            t0 = time.perf_counter()
            st, loss = step(st, x, y)
            losses.append(float(loss))  # device->host read fences the step
            times.append(time.perf_counter() - t0)
            if check:                   # not counted: the check's own run
                saved, n_calls = dict(K.launches), len(calls[-1])
                where.append("check")
                reruns[t] = _hook_rerun(raw, model, s0, p0, loss,
                                        (model.jax_params(), st))
                where.pop()
                K.launches.update(saved)
                del calls[-1][n_calls:]
                nccl.pop("check", None)
            if t == GUARD_NAN:
                nan = dict(params=_tree_mismatch(p0, model.jax_params()),
                           inner=_tree_mismatch(s0.inner, st.inner),
                           neg0=bool(torch.signbit(
                               model.jax_params()["head/bias"][0])))
            verdicts.append(numerics.note_step(t, st))
    launches = dict(K.launches)
    for k in K.KERNELS:
        logged = sum(sig[0] == k for c in calls for sig in c)
        if logged != launches[k]:
            fail(f"{label}: {launches[k]} launches of {k} but {logged} logged "
                 "calls: a caller bypasses ops.kernels' wrappers")
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        fail(f"{label}: losses {losses} (finite, and falling on the batch)")
    buckets = len(step.last_exchange.order) if bucket_bytes else 0
    for k, per_step in expected_launches(mode, hvd.size(), leaves,
                                         buckets).items():
        if launches[k] != per_step * GUARD_STEPS:
            fail(f"{label}: {launches[k]} launches of {k} in {GUARD_STEPS} "
                 f"steps, expected {per_step} a step ({launches})")
    upd = {k: v / GUARD_STEPS for k, v in nccl.get("update", {}).items()}
    want = dict(base["nccl_calls"].get("update", {}))
    want[C._AG] = want.get(C._AG, 0) + 1
    if upd != want:
        fail(f"{label}: the guarded update made {upd} NCCL calls a step, "
             f"expected the unguarded run's plus one all-gather: {want}")
    bad_steps = [t for t, v in enumerate(verdicts) if v["last_bad"]]
    v = verdicts[GUARD_NAN]
    if bad_steps != [GUARD_NAN] or v["bad_count"] != 1 \
            or v["loss_scale"] != GUARD_SCALE / 2 \
            or verdicts[GUARD_NAN - 1]["loss_scale"] != GUARD_SCALE:
        fail(f"{label}: BAD steps {bad_steps}, verdict at the NaN step {v}")
    if nan["params"] or nan["inner"] or not nan["neg0"]:
        fail(f"{label}: the NaN step changed parameters {nan['params'][:5]} "
             f"or inner state leaves {nan['inner'][:5]}, or the -0.0 "
             f"parameter ({nan['neg0']})")
    if chaos.grad_nan_step() is not None or \
            chaos.injected.get("grad_nan_at_step") != 1:
        fail(f"{label}: the NaN charge was consumed "
             f"{chaos.injected.get('grad_nan_at_step')} times")
    chaos.configure(None)
    if any(reruns.values()):
        fail(f"{label}: the hook route differs from the exchange re-run after "
             f"the backward on the same gradients: {reruns}")
    checks = guard_checks(mode, model, raw, st, x, y, bucket_bytes)
    good = times[1:GUARD_NAN]
    return dict(mode=label, steps=GUARD_STEPS, losses=losses,
                launches=launches, step_s=times,
                img_per_s=x.shape[0] * len(good) / sum(good),
                nccl_calls={part: {k: v / GUARD_STEPS for k, v in c.items()}
                            for part, c in nccl.items()},
                verdicts=[{k: v[k] for k in ("count", "bad_count",
                                             "loss_scale", "last_norm")}
                          for v in verdicts],
                nan_step=dict(step=GUARD_NAN, params_bit_equal=True,
                              inner_state_bit_equal=True, neg0_kept=True,
                              scale_halved=True, charge_consumed_once=True),
                hook_route_bit_equal_steps=sorted(reruns) or None,
                buckets=buckets, **checks, step_calls=calls[-1])


def train_bf16_guarded(x, y) -> dict:
    """ResNet-50 with its parameters in bf16 (the compute was bf16
    already), ``DistributedOptimizer(fused_adam(1e-3), loss_scale=
    "dynamic")`` in allreduce mode (a bf16 leaf rides the plain wire),
    :data:`BF16_STEPS` steps: B5's bf16 instantiation on the main path,
    one launch a step over the 161 bf16 leaves (25,557,032 elements).
    Fails unless every parameter, update and moment is bf16, the losses
    are finite and no step is BAD."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import kernels as K
    from horovod_tpu_torch.resilience import numerics

    dev = hvd.device()
    model = build_model("resnet50", 0, dev).to(torch.bfloat16)
    params = model.jax_params()
    if {p.dtype for p in params.values()} != {torch.bfloat16}:
        fail(f"{BF16_MODE}: parameters not all bf16")
    tx = hvd.DistributedOptimizer(hvd.fused_adam(1e-3), loss_scale="dynamic")
    st = tx.init(params)
    step = hvd.make_train_step(model, tx)
    st, losses, times, launches, calls = run_steps(
        "bf16", step, st, x.to(torch.bfloat16), y, BF16_STEPS,
        label=BF16_MODE)
    v = numerics.verdict(st)
    moments = [m for part in ("mu", "nu") for m in st.inner[part].values()]
    if v["bad_count"] or {m.dtype for m in moments} != {torch.bfloat16}:
        fail(f"{BF16_MODE}: verdict {v}, moment dtypes "
             f"{sorted({str(m.dtype) for m in moments})}")
    adam = -(-len(params) // K.ADAM_MAX_LEAVES)
    if launches["fused_adam"] != adam * BF16_STEPS:
        fail(f"{BF16_MODE}: {launches['fused_adam']} fused_adam launches in "
             f"{BF16_STEPS} steps, expected {adam} a step")
    steady = times[1:]
    return dict(mode=BF16_MODE, steps=BF16_STEPS, losses=losses,
                launches={k: 0 for k in K.KERNELS},
                launches_bf16=launches["fused_adam"], step_s=times,
                img_per_s=x.shape[0] * len(steady) / sum(steady),
                elements=sum(p.numel() for p in params.values()),
                verdict=v, step_calls=calls)


# --------------------------------------------------------------------------
# phase 10: checkpoint save and restore


def _zero1_resnet(seed: int, device):
    """ResNet-50 with ZeRO-1 + int8 + EF + fused Adam: ``(model, tx,
    step)``."""
    import horovod_tpu_torch as hvd

    model = build_model("resnet50", seed, device)
    tx = make_tx("zero1")
    return model, tx, hvd.make_train_step(model, tx, shard_optimizer=True)


def _state_of(model, st) -> dict:
    return {"params": model.jax_params(),
            "batch_stats": model.jax_batch_stats(), "opt": st}


def _clone(tree):
    import torch

    from horovod_tpu_torch.optim import _map_state

    return _map_state(lambda v: v.detach().clone()
                      if isinstance(v, torch.Tensor) else v, tree)


def _tree_mismatch(a, b) -> list:
    """Where two state trees differ: structure, or a leaf's bits."""
    import torch

    from horovod_tpu_torch import pytree

    (la, ta), (lb, tb) = pytree.flatten(a), pytree.flatten(b)
    if ta != tb:
        return ["structure"]
    bad = []
    for i, (x, y) in enumerate(zip(la, lb)):
        if isinstance(x, torch.Tensor):
            if not (isinstance(y, torch.Tensor) and x.shape == y.shape
                    and x.dtype == y.dtype and same_bits(x, y)):
                bad.append(i)
        elif x != y:
            bad.append(i)
    return bad


def _load_state(model, saved: dict) -> None:
    """Copy a state tree's parameters and running stats into ``model``."""
    import torch

    with torch.no_grad():
        for part, views in (("params", model.jax_params()),
                            ("batch_stats", model.jax_batch_stats())):
            for k, v in views.items():
                v.copy_(saved[part][k])


def _restore_into(model, tree, **kw):
    """A restored tree into ``model`` (weights, running stats) and this
    rank's optimizer state, as a user resumes."""
    from horovod_tpu_torch import checkpoint as ck
    from horovod_tpu_torch.models.convert import load_flax_variables

    load_flax_variables(model, tree["params"], tree["batch_stats"])
    return ck.consolidate_opt_state(tree["opt"], model.jax_params(), **kw)


def _skipped_copies(root: str, step: int) -> dict:
    """A truncated copy of ``step_<step>`` (as ``step_1000``) and one with
    a NaN in its first f32 array (``step_1001``): the reason each is
    rejected, and what ``latest_step`` then finds."""
    import shutil

    import numpy as np

    from horovod_tpu_torch import checkpoint as ck

    src = os.path.join(root, f"step_{step}")
    trunc, nan = (os.path.join(root, f"step_{s}") for s in (1000, 1001))
    shutil.copytree(src, trunc)
    npz = os.path.join(trunc, "arrays.npz")
    with open(npz, "r+b") as f:
        f.truncate(os.path.getsize(npz) // 2)
    shutil.copytree(src, nan)
    npz = os.path.join(nan, "arrays.npz")
    with np.load(npz) as z:
        arrays = {k: z[k] for k in z.files}
    k = next(k for k, v in arrays.items() if v.dtype == np.float32)
    arrays[k] = arrays[k].copy()
    arrays[k].reshape(-1)[0] = np.nan
    np.savez(npz, **arrays)
    return {"truncated": ck._checkpoint_invalid_reason(trunc),
            "nan_leaf": ck._checkpoint_invalid_reason(nan),
            "latest_step": ck.latest_step(root),
            "valid_steps": ck.valid_steps(root)}


def checkpoint_child(directory: str) -> None:
    """Phase 10 on one GPU, in a child process whose determinism settings
    (``torch.use_deterministic_algorithms(True)``, ``CUBLAS_WORKSPACE_
    CONFIG`` from its environment, set before CUDA starts) touch no timed
    phase. ResNet-50, ZeRO-1 + int8 + EF, batch 64: 3 steps; an
    asynchronous save with one more step while it writes; a restore into
    a model of other random weights and a fresh state, bit-equal to the
    state at the save call; then 3 steps of each, from the restored state
    and from the saved state kept in memory, bit-equal; a synchronous
    save's time; and a truncated and a NaN copy skipped by
    ``latest_step``. Prints one JSON line."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import checkpoint as ck

    if not os.environ.get("CUBLAS_WORKSPACE_CONFIG"):
        fail("checkpoint: CUBLAS_WORKSPACE_CONFIG must be set before CUDA "
             "starts")
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.benchmark = False
    hvd.init()
    try:
        dev = hvd.device()
        gen = torch.Generator(device=dev).manual_seed(3)
        x = torch.randn(64, 224, 224, 3, device=dev, generator=gen)
        y = torch.randint(0, 1000, (64,), device=dev, generator=gen)
        model, tx, step = _zero1_resnet(0, dev)
        st = tx.init(model.jax_params())
        losses = []
        for _ in range(3):
            st, loss = step(st, x, y)
            losses.append(float(loss))
        saved = _clone(_state_of(model, st))
        mgr = ck.CheckpointManager(os.path.join(directory, "async"),
                                   max_to_keep=2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.save(3, _state_of(model, st), asynchronous=True)
        block_s = time.perf_counter() - t0
        st, loss = step(st, x, y)           # trains on while it writes
        overlap_loss = float(loss)
        t0 = time.perf_counter()
        mgr.wait_until_finished()
        wait_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ck.save(os.path.join(directory, "sync"), 4, _state_of(model, st))
        sync_s = time.perf_counter() - t0

        model_b, _, step_b = _zero1_resnet(1, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tree = mgr.restore(3)
        st_b = _restore_into(model_b, tree)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        bad = _tree_mismatch(_state_of(model_b, st_b), saved)
        if bad:
            fail(f"checkpoint: the restored state differs from the state at "
                 f"the save call in leaves {bad[:8]} ({len(bad)} in all)")
        _load_state(model, saved)           # the run without the save
        st = _clone(saved["opt"])
        resumed, uninterrupted = [], []
        for _ in range(3):
            st, loss = step(st, x, y)
            uninterrupted.append(float(loss))
            st_b, loss = step_b(st_b, x, y)
            resumed.append(float(loss))
        if resumed != uninterrupted:
            fail(f"checkpoint: resumed losses {resumed} != uninterrupted "
                 f"{uninterrupted}")
        bad = _tree_mismatch(_state_of(model_b, st_b), _state_of(model, st))
        if bad:
            fail(f"checkpoint: after 3 steps the resumed state differs in "
                 f"leaves {bad[:8]} ({len(bad)} in all)")
        skipped = _skipped_copies(os.path.join(directory, "async"), 3)
        if skipped["latest_step"] != 3 or skipped["valid_steps"] != [3] or \
                (skipped["truncated"], skipped["nan_leaf"]) != ("corrupt",
                                                                "nonfinite"):
            fail(f"checkpoint: a bad copy was not skipped: {skipped}")
        print(json.dumps(dict(
            losses=losses, overlap_loss=overlap_loss,
            bytes=ck.state_nbytes(tree), leaves=len(tree["params"]),
            opt_rows={k: list(v.shape) for k, v in
                      tree["opt"]["inner"]["mu"].items()},
            sync_save_s=sync_s, async_save_blocks_s=block_s,
            async_wait_s=wait_s, restore_s=restore_s,
            restored_bit_equal=True, resumed_losses=resumed,
            uninterrupted_losses=uninterrupted, resumed_bit_equal=True,
            skipped=skipped, deterministic=True)), flush=True)
    finally:
        hvd.shutdown()


def checkpoint_phase(gpu=None) -> dict:
    """Run :func:`checkpoint_child` in its own process (on card ``gpu``
    alone, when given) and return its record."""
    import shutil

    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    env = child_env(gpu, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    try:
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--checkpoint", CKPT_DIR], capture_output=True,
                             text=True, timeout=600, env=env)
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    if out.returncode != 0:
        fail(f"checkpoint phase failed:\n{out.stderr[-3000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def checkpoint_world(directory: str, x, y) -> dict:
    """``--gpus N``: a ZeRO-1 + EF state of N ranks (2 steps of
    ResNet-50) saved, each rank into its own directory, of which only
    rank 0's is written (the rows gathered to ``[N, s]``), and restored
    on the same world: each rank's state must come back bit-equal to
    what it held, though the others' directories are empty."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import checkpoint as ck

    r, n = hvd.rank(), hvd.size()
    model, tx, step = _zero1_resnet(0, hvd.device())
    st = tx.init(model.jax_params())
    losses = []
    for _ in range(2):
        st, loss = step(st, x, y)
        losses.append(float(loss))
    held = _clone(st)
    mine = os.path.join(directory, f"rank{r}")
    os.makedirs(mine, exist_ok=True)
    ck.save(mine, 2, _state_of(model, st))
    tree = ck.restore(mine, 2)
    rows = {k: list(v.shape) for k, v in tree["opt"]["inner"]["mu"].items()}
    if any(v[0] != n for v in rows.values()):
        fail(f"checkpoint at {n} GPUs: the saved rows are {rows}")
    bad = _tree_mismatch(_restore_into(model, tree), held)
    if bad:
        fail(f"checkpoint at {n} GPUs, rank {r}: the restored state differs "
             f"in leaves {bad[:8]}")
    return dict(losses=losses, rows=rows, bit_equal=True,
                mine_empty=r > 0 and not os.listdir(mine))


def restore_world_of_one(directory: str) -> dict:
    """``--gpus N``, after the world of N: rank 0's checkpoint restored
    in a world of one through ``consolidate_opt_state(to_size=1)`` (the
    EF residuals of the N ranks summed into the one), then 2 steps with
    finite losses."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import checkpoint as ck

    hvd.init()
    try:
        dev = hvd.device()
        gen = torch.Generator(device=dev).manual_seed(5)
        x = torch.randn(64, 224, 224, 3, device=dev, generator=gen)
        y = torch.randint(0, 1000, (64,), device=dev, generator=gen)
        model, tx, step = _zero1_resnet(2, dev)
        tree = ck.restore(os.path.join(directory, "rank0"), 2)
        n_old = tree["opt"]["shard"]["size"]
        st = _restore_into(model, tree, to_size=1)
        if st["shard"] != {"rank": 0, "size": 1}:
            fail(f"restore at one GPU: state of {st['shard']}")
        losses = []
        for _ in range(2):
            st, loss = step(st, x, y)
            losses.append(float(loss))
        if not all(math.isfinite(v) for v in losses):
            fail(f"restore at one GPU: non-finite losses {losses}")
        return dict(from_ranks=n_old, losses=losses)
    finally:
        hvd.shutdown()


# --------------------------------------------------------------------------
# phases 11 and 12: Horovod's own PyTorch API (horovod_tpu_torch.torch)


def frontend_core_phase() -> dict:
    """One GPU, the native core attached (``init(native_core=True)``):
    one forward and backward of ResNet-50 at full width, batch 64, each
    of the 161 gradients enqueued by name with ``allreduce_async_`` from
    its post-accumulate-grad hook (so the core's stream waits on each
    gradient's ReadyEvent). Every result must equal, bit for bit, a sync
    ``allreduce`` of a copy of the gradient saved in the hook; the NCCL
    ``all_reduce`` calls must equal the plans the core ran (at least 2:
    the 102.2 MB of gradients exceed the 64 MB fusion threshold); named
    allgather, broadcast, alltoall and reducescatter must equal their
    sync forms; ``join()`` must return 0 and a duplicate name raise. Then
    5 steps of phase 12's Average run at this world of one, where the
    hook optimizer exchanges nothing: the steps' baseline."""
    import torch

    import horovod_tpu_torch.torch as thvd
    from horovod_tpu_torch import basics
    from horovod_tpu_torch.ops import collective as C
    from horovod_tpu_torch.training import softmax_xent

    thvd.init(native_core=True)
    try:
        core, dev = basics.core(), basics.device()
        model = build_model("resnet50", 0, dev)
        gen = torch.Generator(device=dev).manual_seed(1)
        side = MODELS["resnet50"][1]
        x = torch.randn(FRONTEND_BATCH, side, side, 3, device=dev,
                        generator=gen)
        y = torch.randint(0, 1000, (FRONTEND_BATCH,), device=dev,
                          generator=gen)
        named = list(model.named_parameters())
        saved, handles, last_hook = {}, {}, []

        def hook_for(name):
            def hook(p):
                saved[name] = p.grad.clone()
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                last_hook[:] = [ev]
                handles[name] = thvd.allreduce_async_(
                    p.grad, name=f"grad.{name}", op=thvd.Average)
            return hook

        hooks = [p.register_post_accumulate_grad_hook(hook_for(n))
                 for n, p in named]
        nccl, where = {}, ["backward"]
        responses0, t0 = core.responses, time.perf_counter()
        with counting_collectives(nccl, where):
            softmax_xent(model(x), y).backward()
            outs = {n: thvd.synchronize(h) for n, h in handles.items()}
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            torch.cuda.synchronize()
        span_s = time.perf_counter() - t0
        responses = core.responses - responses0
        for h in hooks:
            h.remove()
        calls = nccl.get("backward", {}).get("all_reduce", 0)
        if len(outs) != len(named) or len(named) != 161:
            fail(f"frontend core: {len(outs)} of {len(named)} gradients "
                 "came back")
        bad = [n for n, out in outs.items()
               if not same_bits(out, C.allreduce(saved[n], C.Average))]
        if bad:
            fail(f"frontend core: named results differ from the sync "
                 f"allreduce in {bad[:5]}")
        if calls != responses or responses < 2:
            fail(f"frontend core: {calls} NCCL all_reduce calls for "
                 f"{responses} plans (expected equal, at least 2)")
        t = saved[named[0][0]]
        pairs = {
            "allgather": (thvd.allgather_async(t, name="ag"),
                          thvd.allgather(t)),
            "broadcast": (thvd.broadcast_async(t, 0, name="bc"),
                          thvd.broadcast(t, 0)),
            "alltoall": (thvd.alltoall_async(t, name="a2a"),
                         thvd.alltoall(t)),
            "reducescatter": (thvd.reducescatter_async(t, name="rs"),
                              thvd.reducescatter(t)),
        }
        for op, (h, want) in pairs.items():
            if not same_bits(thvd.synchronize(h), want):
                fail(f"frontend core: named {op} differs from its sync form")
        h = thvd.allreduce_async(t, name="dup")
        try:
            thvd.allreduce_async(t, name="dup")
            fail("frontend core: a duplicate outstanding name was accepted")
        except ValueError:
            pass
        thvd.synchronize(h)
        joined = thvd.join()
        if joined != 0:
            fail(f"frontend core: join() returned {joined}")
        del saved, outs, handles
        # the no-exchange baseline of phase 12's steps: at a world of one
        # the hook optimizer registers no hooks
        alone = frontend_train("average", 5, x, y)
        return dict(leaves=len(named), plans=responses, all_reduce=calls,
                    world1_img_per_s=alone["img_per_s"],
                    world1_step_s=alone["step_s"],
                    cycle_ms=core.cycle_time_ms,
                    fusion_threshold=core.fusion_threshold,
                    span_s=span_s, cycles_spanned=span_s * 1e3 /
                    core.cycle_time_ms,
                    last_hook_to_done_ms=last_hook[0].elapsed_time(end),
                    named_ops_checked=["allreduce"] + list(pairs))
    finally:
        thvd.shutdown()


#: the frontend's modes across N GPUs: (compression, error feedback, op)
FRONTEND_MODES = ("average", "fp16_ef", "adasum")
#: the frontend phases' rows a GPU, and SyncBatchNorm's input a GPU
#: (ResNet-50's first BatchNorm at batch 64)
FRONTEND_BATCH = 64
SYNC_BN_SHAPE = (64, 64, 112, 112)
#: SyncBatchNorm against BatchNorm2d over the gathered batch: every
#: difference within this share of the reference's largest magnitude
SYNC_BN_RTOL = 1e-4
#: across N GPUs every NORM_EVERY-th parameter's hook also allreduces its
#: gradient's squared norm without a name: a collective on the default
#: process group during the backward, beside the core's on its own
NORM_EVERY = 20
#: the world with the core against the world without it, per parameter
#: tensor: the norm of the difference of their parameters after a mode's
#: first step within this share of the norm of the direct world's
#: update. From the same parameters and rows the two differ only by
#: rounding (fused against per-tensor sums, the Adasum dot products,
#: cuDNN's own order); a stale, missing or wrongly combined gradient is
#: off by the order of the update itself. After the last step the
#: distance is printed, not held: the bf16 activations carry each
#: rounding difference into the next steps' gradients
WORLDS_RTOL = 5e-2


def frontend_optimizer(thvd, mode: str, model):
    """``hvd.DistributedOptimizer`` over ``torch.optim.SGD(lr=0.01,
    momentum=0.9)``: Average uncompressed, Average with
    ``Compression.fp16`` and error feedback, or Adasum."""
    import torch

    kw = dict(named_parameters=model.named_parameters())
    if mode == "fp16_ef":
        kw.update(compression=thvd.Compression.fp16, error_feedback=True)
    elif mode == "adasum":
        kw.update(op=thvd.Adasum)
    return thvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9), **kw)


def frontend_expected(mode: str, n: int, leaves: int, plans,
                      norms: int = 0) -> tuple:
    """Exact NCCL calls and Adasum launches of the frontend's steps: per
    gradient (no core, ``plans`` None) one ``all_reduce``, or for Adasum
    log2(N) exchanges and ``adasum_pair_combine`` launches, and one
    ``all_reduce`` for each of the ``norms`` unnamed squared norms; with
    the core (``plans`` its ``{"allreduce": k, "adasum": k}`` plans) the
    same per fused plan, Adasum's combine ``adasum_segment_combine``, the
    unnamed norms riding the allreduce plans. At a world of one the
    Average optimizer registers no hooks and exchanges nothing, as the
    reference's."""
    levels = n.bit_length() - 1
    if plans is None:
        units, norm_calls = leaves, norms
    else:
        units = plans["adasum" if mode == "adasum" else "allreduce"]
        norm_calls = plans["allreduce"] if mode == "adasum" else 0
    if n == 1:          # no hooks at a world of one: nothing to exchange
        units = 0 if mode != "adasum" else units
    if mode != "adasum":
        return ({"all_reduce": units + norm_calls, "batch_isend_irecv": 0},
                {"adasum_pair_combine": 0, "adasum_segment_combine": 0})
    kernel = "adasum_pair_combine" if plans is None else \
        "adasum_segment_combine"
    return ({"all_reduce": norm_calls, "batch_isend_irecv": units * levels},
            {"adasum_pair_combine": 0, "adasum_segment_combine": 0,
             kernel: units * levels})


def frontend_train(mode: str, steps: int, x, y) -> dict:
    """``steps`` steps of ResNet-50 (full width, random weights from a
    seed) under the frontend's ``DistributedOptimizer`` in ``mode`` on
    this rank's batch; fails unless the loss is finite and falls, and the
    NCCL calls and Adasum launches are exactly what
    :func:`frontend_expected` says. ``params_sha`` hashes the
    parameters' bytes (every rank must agree). Across GPUs every
    :data:`NORM_EVERY`-th parameter's hook, run after the optimizer's,
    also allreduces its gradient's squared norm without a name (with the
    core attached it goes through the core under a generated name, so
    only the core's thread issues collectives): ``norms`` holds the last
    step's local and global values,
    and rank 0 returns its parameters after the first and the last step
    (``params``, keyed by step, with ``sizes``)."""
    import hashlib

    import torch

    import horovod_tpu_torch.torch as thvd
    from horovod_tpu_torch import basics
    from horovod_tpu_torch.ops import kernels as K
    from horovod_tpu_torch.training import softmax_xent

    core, n = basics.core(), thvd.size()
    label = f"frontend_{mode}{'_core' if core else ''}@{n}"
    model = build_model("resnet50", 0, basics.device())
    leaves = len(list(model.parameters()))
    opt = frontend_optimizer(thvd, mode, model)
    norms = []

    def norm_hook(p):
        local = p.grad.detach().float().pow(2).sum()
        norms.append((local, thvd.allreduce(local, op=thvd.Sum)))

    hooked = list(model.parameters())[::NORM_EVERY] if n > 1 else []
    for p in hooked:
        p.register_post_accumulate_grad_hook(norm_hook)
    thvd.broadcast_parameters(model.state_dict(), root_rank=0)
    torch.cuda.synchronize()
    nccl, where, calls, losses, times = {}, ["step"], [], [], []
    kept = {}                           # rank 0's parameters after step 1
    keep = n > 1 and thvd.rank() == 0
    from horovod_tpu_torch.core import REQUEST_ADASUM, REQUEST_ALLREDUCE

    def plan_counts():
        return {k: core.plan_counts.get(t, 0) for k, t in (
            ("allreduce", REQUEST_ALLREDUCE), ("adasum", REQUEST_ADASUM))}

    plans0 = plan_counts() if core else None
    K.reset_launches()                  # count the main path's run only
    with counting_collectives(nccl, where), logging_calls(calls):
        for _ in range(steps):
            calls.append([])
            del norms[:]
            t0 = time.perf_counter()
            opt.zero_grad()
            loss = softmax_xent(model(x), y)
            loss.backward()
            opt.step()
            losses.append(float(loss.detach()))
            times.append(time.perf_counter() - t0)
            if keep and not kept:
                kept[1] = torch.cat([p.detach().reshape(-1) for p in
                                     model.parameters()]).cpu().numpy()
    launches = dict(K.launches)
    plans = {k: v - plans0[k] for k, v in plan_counts().items()} \
        if core else None
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        fail(f"{label}: losses {losses} not finite and falling")
    want_calls, want_launches = frontend_expected(
        mode, n, leaves * steps, plans, norms=len(hooked) * steps)
    got_calls = {k: nccl.get("step", {}).get(k, 0) for k in want_calls}
    if got_calls != want_calls:
        fail(f"{label}: NCCL calls {got_calls} in {steps} steps, expected "
             f"{want_calls} ({plans} plans)")
    got_launches = {k: launches[k] for k in want_launches}
    if got_launches != want_launches:
        fail(f"{label}: launches {got_launches} in {steps} steps, expected "
             f"{want_launches}")
    for k in K.KERNELS:
        if sum(sig[0] == k for c in calls for sig in c) != launches[k]:
            fail(f"{label}: logged calls of {k} disagree with its launches")
    flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    flat = flat.cpu().numpy()
    sha = hashlib.sha256(flat.tobytes()).hexdigest()
    steady = times[1:]
    out = dict(mode=label, leaves=leaves, steps=steps, losses=losses,
               launches=launches, plans=plans and sum(plans.values()),
               plans_by_type=plans, nccl_calls=got_calls,
               step_s=times, img_per_s=x.shape[0] * len(steady) / sum(steady),
               params_sha=sha, step_calls=calls[-1],
               norms=[(float(a), float(b)) for a, b in norms])
    if keep:
        kept[steps] = flat
        out.update(params=kept,
                   sizes=[p.numel() for p in model.parameters()])
    return out


def sync_bn_check() -> dict:
    """``hvd.SyncBatchNorm(64)`` at ResNet-50's first BatchNorm shape,
    ``[64, 64, 112, 112]`` a rank, against ``torch.nn.BatchNorm2d`` over
    the gathered batch on every rank, loss ``sum(bn(x) * w)``: this
    rank's output and input-grad rows, the weight and bias grads summed
    over ranks, the running mean and variance. Returns each quantity's
    largest difference over the reference's largest magnitude, each
    within :data:`SYNC_BN_RTOL`."""
    import torch

    import horovod_tpu_torch.torch as thvd
    from horovod_tpu_torch import basics

    dev, n, r = basics.device(), thvd.size(), thvd.rank()
    b, c, h, w_ = SYNC_BN_SHAPE
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(b * n, c, h, w_, device=dev, generator=gen)
    w = torch.randn(b * n, c, h, w_, device=dev, generator=gen)
    rows = slice(b * r, b * (r + 1))

    def run(bn, xi, wi):
        xi = xi.clone().requires_grad_(True)
        bn.train()
        y = bn(xi)
        (y * wi).sum().backward()
        return [y.detach(), xi.grad, bn.weight.grad, bn.bias.grad,
                bn.running_mean, bn.running_var]

    got = run(thvd.SyncBatchNorm(c).to(dev), x[rows], w[rows])
    want = run(torch.nn.BatchNorm2d(c).to(dev), x, w)
    got[2] = thvd.allreduce(got[2], op=thvd.Sum)
    got[3] = thvd.allreduce(got[3], op=thvd.Sum)
    want[0], want[1] = want[0][rows], want[1][rows]
    names = ("out", "grad_input", "grad_weight", "grad_bias", "running_mean",
             "running_var")
    err = {k: max_abs(a, b) / float(b.abs().max())
           for k, a, b in zip(names, got, want)}
    bad = {k: v for k, v in err.items() if not v <= SYNC_BN_RTOL}
    if bad:
        fail(f"SyncBatchNorm at [64, 64, 112, 112] a rank: relative "
             f"differences {bad} over {SYNC_BN_RTOL}")
    return err


def _frontend_rank(modes) -> dict:
    """One rank of a frontend world: each mode 5 steps on this rank's 64
    rows of one global batch, then the SyncBatchNorm check. Rank 0 also
    returns the parameters the steps start from (``init``)."""
    import torch

    import horovod_tpu_torch as hvd

    gen = torch.Generator().manual_seed(0)
    n, side = hvd.size(), MODELS["resnet50"][1]
    x = torch.randn(FRONTEND_BATCH * n, side, side, 3, generator=gen)
    y = torch.randint(0, 1000, (FRONTEND_BATCH * n,), generator=gen)
    xs, ys = hvd.shard_batch(x).to(hvd.device()), hvd.shard_batch(y).to(
        hvd.device())
    del x
    init = None
    if hvd.rank() == 0:
        init = torch.cat([p.detach().reshape(-1) for p in build_model(
            "resnet50", 0, hvd.device()).parameters()]).cpu().numpy()
    runs = []
    for mode in modes:
        runs.append(frontend_train(mode, 5, xs, ys))
        torch.cuda.empty_cache()
    return dict(runs=runs, sync_bn=sync_bn_check(), init=init)


def _check_norms(label: str, res: list) -> None:
    """The unnamed squared norms of the last step: on every rank the same
    global values, each the sum of the ranks' local values (rtol 1e-5:
    NCCL sums in its own order)."""
    import numpy as np

    norms = [out["norms"] for out in res]
    globs = [[b for _, b in v] for v in norms]
    if not globs[0] or any(g != globs[0] for g in globs):
        fail(f"{label}: the unnamed norms differ across ranks: {norms}")
    for i, (_, glob) in enumerate(norms[0]):
        want = sum(v[i][0] for v in norms)
        if not (math.isfinite(glob) and glob > 0
                and np.isclose(glob, want, rtol=1e-5, atol=0)):
            fail(f"{label}: unnamed norm {i} is {glob}, the ranks' local "
                 f"values sum to {want}")


def _worlds_rel(run, direct, init, step: int) -> list:
    """For each parameter tensor, the norm of one world's parameters
    less another's after ``step`` steps, over the norm of the second
    world's update."""
    import numpy as np

    rel, at = [], 0
    for size in run["sizes"]:
        a, b, z = (v[at:at + size].astype(np.float64) for v in (
            run["params"][step], direct["params"][step], init))
        at += size
        den, num = np.linalg.norm(b - z), np.linalg.norm(a - b)
        rel.append(num / den if den > 0 else (0.0 if num == 0 else math.inf))
    return rel


def run_frontend_gpus(n: int) -> tuple:
    """Phase 12 across ``n`` GPUs: the frontend's modes without and with
    the native core (one world each), every rank's parameters identical
    after each run, the unnamed norms agreeing, the SyncBatchNorm check
    in both worlds, and the core world's parameters after each mode
    within :data:`WORLDS_RTOL` of the direct world's. Returns rank 0's
    runs and the SyncBatchNorm records of the two worlds."""
    import numpy as np

    from horovod_tpu_torch.testing import run_world

    runs, sync_bn, rank0 = [], {}, {}
    for core in (False, True):
        try:
            res = run_world(_frontend_rank, n, FRONTEND_MODES, device=None,
                            timeout=600, native_core=core)
        except RuntimeError as e:
            fail(f"frontend at {n} GPUs (core {core}): {e}")
        for r, out in enumerate(res):
            for o, o0 in zip(out["runs"], res[0]["runs"]):
                if o["params_sha"] != o0["params_sha"]:
                    fail(f"{o['mode']}: rank {r}'s parameters differ from "
                         "rank 0's")
        for i, run in enumerate(res[0]["runs"]):
            _check_norms(run["mode"], [out["runs"][i] for out in res])
        rank0[core] = res[0]
        sync_bn["core" if core else "direct"] = res[0]["sync_bn"]
    init = rank0[False]["init"]
    if not np.array_equal(init, rank0[True]["init"]):
        fail("frontend: the two worlds start from different parameters")
    for run, direct in zip(rank0[True]["runs"], rank0[False]["runs"]):
        run["vs_direct_world"] = {
            step: max(_worlds_rel(run, direct, init, step))
            for step in sorted(run["params"])}
        if not run["vs_direct_world"][1] <= WORLDS_RTOL:
            fail(f"{run['mode']}: parameters after one step "
                 f"{run['vs_direct_world'][1]} of the update away from the "
                 f"world without the core (bar {WORLDS_RTOL})")
    for core in (False, True):
        for run in rank0[core]["runs"]:
            del run["params"], run["sizes"]
            runs.append(run)
    return runs, sync_bn


def _world_rank(modes, ckpt_dir) -> dict:
    """One rank of the multi-GPU run: each mode in turn, 4 steps, each
    rank on its own rows of one global batch."""
    import torch

    import horovod_tpu_torch as hvd

    gen = torch.Generator().manual_seed(0)
    n = hvd.size()
    x = torch.randn(64 * n, 224, 224, 3, generator=gen)
    y = torch.randint(0, 1000, (64 * n,), generator=gen)
    xs, ys = hvd.shard_batch(x).to(hvd.device()), hvd.shard_batch(y).to(
        hvd.device())
    runs = [train(mode, 4, xs, ys) for mode in modes]
    runs += [train(mode, 4, xs, ys, bucket_bytes=bb)
             for mode, bb in OVERLAP_RUNS]
    runs += [train(mode, 4, xs, ys) for mode in HIER_MODES]
    return dict(runs=runs, checkpoint=checkpoint_world(ckpt_dir, xs, ys),
                zero3_moved=zero3_move_rank(ckpt_dir, "run"))


def zero3_move_rank(directory: str, phase: str) -> dict:
    """Bucketed ZeRO-3 (:data:`ZERO3_BUCKET`, the int8 gather) across
    world sizes, ResNet-50 on this rank's 64 rows of phase 5's global
    batch. ``run``: 3 steps, a checkpoint after the second into
    ``directory/zero3_a``; ``move``: that checkpoint restored at this
    world's size (``checkpoint.fsdp_params`` re-packs the parameter rows,
    ``consolidate_opt_state`` the state) and saved unstepped into
    ``zero3_b``; ``resume``: ``zero3_b`` restored and the third step
    taken. Returns the losses and the parameters' hashes (after step 2
    and at the end)."""
    import torch

    import horovod_tpu_torch as hvd
    import horovod_tpu_torch.checkpoint as ck

    n = hvd.size()
    os.environ["HOROVOD_FSDP_WIRE"] = "int8"
    model = build_model("resnet50", 0, hvd.device())
    tx = make_tx("zero3", 1e-3, ZERO3_BUCKET)
    a, b = (os.path.join(directory, f"zero3_{s}") for s in "ab")

    def sha(fp):
        full = hvd.fsdp_unpack_params(fp)
        return hashlib.sha256(b"".join(
            full[k].detach().reshape(-1).float().cpu().numpy().tobytes()
            for k in sorted(full))).hexdigest()

    if phase == "move":
        tree = ck.restore(a, 2)
        fp = ck.fsdp_params(tree["params"])
        st = ck.consolidate_opt_state(tree["opt"], tree["params"])
        ck.save(b, 2, {"params": fp, "opt": st})
        return dict(size=fp.meta.size, groups=len(fp.shards), sha2=sha(fp))
    world = 64 * (4 if phase == "resume" else n)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(world, 224, 224, 3, generator=gen)
    y = torch.randint(0, 1000, (world,), generator=gen)
    xs, ys = (hvd.shard_batch(v).to(hvd.device()) for v in (x, y))
    del x
    if phase == "resume":
        tree = ck.restore(b, 2)
        fp = ck.fsdp_params(tree["params"])
        st = ck.consolidate_opt_state(tree["opt"], tree["params"])
        step = hvd.make_train_step(model, tx, shard_params=True, params=fp)
        todo = 1
    else:
        step = hvd.make_train_step(model, tx, shard_params=True)
        st = tx.init(step.params)
        todo = 3
    losses, out = [], {}
    for i in range(todo):
        st, loss = step(st, xs, ys)
        losses.append(float(loss))
        if phase == "run" and i == 1:
            ck.save(a, 2, {"params": step.params, "opt": st})
            out["sha2"] = sha(step.params)
    os.environ.pop("HOROVOD_FSDP_WIRE", None)
    return dict(out, losses=losses, sha=sha(step.params),
                groups=len(step.params.shards), size=n)


def run_gpus(n: int, modes) -> tuple:
    """Phases 5 and 10 across ``n`` GPUs: rank 0's results of ``modes``,
    after checking that every rank reports the same losses and
    parameters, and the checkpoint record of every rank."""
    from horovod_tpu_torch.testing import run_world

    try:
        res = run_world(_world_rank, n, modes, CKPT_DIR, device=None,
                        timeout=900)
    except RuntimeError as e:
        fail(f"{n} GPUs: {e}")
    for r, out in enumerate(res):
        for o, o0 in zip(out["runs"], res[0]["runs"]):
            if o["losses"] != o0["losses"] or o["checksum"] != o0["checksum"] \
                    or o["params_sha"] != o0["params_sha"]:
                fail(f"{n} GPUs, {o['mode']}: rank {r} diverged from rank 0")
        if out["checkpoint"]["losses"] != res[0]["checkpoint"]["losses"]:
            fail(f"{n} GPUs, checkpoint run: rank {r} diverged from rank 0")
        if r > 0 and not out["checkpoint"]["mine_empty"]:
            fail(f"{n} GPUs, checkpoint: rank {r}'s directory was written")
    return (res[0]["runs"], [out["checkpoint"] for out in res],
            zero3_move(n, [out["zero3_moved"] for out in res]))


def zero3_move(n: int, ran: list) -> dict:
    """The bucketed ZeRO-3 checkpoint of the ``n`` ranks' ``run``
    (:func:`zero3_move_rank`) restored at 2 GPUs and saved, then restored
    at ``n`` and stepped once: every rank's losses and parameters the
    same, the move's unpacked parameters those after step 2, the resumed
    third step bit-equal to the run that never moved."""
    from horovod_tpu_torch.testing import run_world

    if any(o != ran[0] for o in ran):
        fail(f"zero3 checkpoint run: the ranks differ: {ran}")
    try:
        moved = run_world(zero3_move_rank, 2, CKPT_DIR, "move", device=None,
                          timeout=600)
        back = run_world(zero3_move_rank, n, CKPT_DIR, "resume", device=None,
                         timeout=600)
    except RuntimeError as e:
        fail(f"zero3 checkpoint across world sizes: {e}")
    if any(m != moved[0] for m in moved) or moved[0]["size"] != 2 \
            or moved[0]["sha2"] != ran[0]["sha2"]:
        fail(f"zero3 checkpoint restored at 2 GPUs: {moved} against the "
             f"parameters after step 2 {ran[0]['sha2']}")
    if any(b != back[0] for b in back) or back[0]["sha"] != ran[0]["sha"] \
            or back[0]["losses"] != ran[0]["losses"][2:]:
        fail(f"zero3 checkpoint back at {n} GPUs: {back[0]} differs from the "
             f"run that never moved {ran[0]}")
    return dict(buckets=ran[0]["groups"], losses=ran[0]["losses"],
                moved_to=moved[0]["size"], moved_groups=moved[0]["groups"],
                resumed_loss=back[0]["losses"], bit_equal=True)


def print_hier_zero3(by_mode: dict, smi: str) -> None:
    """The one-GPU lines of the hierarchical run (a 1 x 1 host mesh:
    bit-equal to the flat allreduce mode, since nothing reorders with one
    rank a group) and of bucketed ZeRO-3 (the exact gather bucketed
    bit-equal to unbucketed; the int8 one's img/s and peak memory beside
    unbucketed ZeRO-3's)."""
    hier, flat = by_mode["allreduce_hier"], by_mode["allreduce"]
    if hier["losses"] != flat["losses"] or \
            hier["params_sha"] != flat["params_sha"]:
        fail(f"allreduce_hier on a 1 x 1 host mesh differs from allreduce: "
             f"losses {hier['losses']} against {flat['losses']}")
    print(f"e2e allreduce_hier (1 x 1 host mesh): losses and parameters "
          f"bit-equal to allreduce; {hier['img_per_s']:.2f} img/s per GPU "
          f"(allreduce {flat['img_per_s']:.2f}); NCCL calls and bytes sent a "
          f"step by group {json.dumps(hier['nccl_by_group'])}; launches a "
          f"step {json.dumps({k: v / hier['steps'] for k, v in hier['launches'].items() if v})} "
          f"({smi})", flush=True)
    label = overlap_label("zero3_exact", ZERO3_BUCKET)
    exact, bucketed = by_mode["zero3_exact"], by_mode[label]
    if exact["losses"] != bucketed["losses"] or \
            exact["params_sha"] != bucketed["params_sha"]:
        fail(f"{label} differs from zero3_exact: losses "
             f"{bucketed['losses']} against {exact['losses']}")
    z3 = by_mode["zero3"]
    z3b = by_mode[overlap_label("zero3", ZERO3_BUCKET)]
    print(f"e2e {z3b['mode']} (int8 gather, {z3b['buckets']} buckets, each "
          f"gathered twice a step): {z3b['img_per_s']:.2f} img/s per GPU, "
          f"peak {z3b['peak_gib']:.2f} GiB; zero3 unbucketed "
          f"{z3['img_per_s']:.2f} img/s, peak {z3['peak_gib']:.2f} GiB; "
          f"exact gather (HOROVOD_FSDP_WIRE=none): {label} bit-equal to "
          f"zero3_exact over {exact['steps'] + 1} steps, "
          f"{bucketed['img_per_s']:.2f} against {exact['img_per_s']:.2f} "
          f"img/s, peak {bucketed['peak_gib']:.2f} against "
          f"{exact['peak_gib']:.2f} GiB; NCCL calls a step "
          f"{json.dumps(z3b['nccl_calls'].get('step', {}))} ({smi})",
          flush=True)


def print_overlap(by_mode: dict, suffix: str, smi: str) -> None:
    """The overlap runs' lines: img/s per GPU beside the mode without
    overlap in the same run, buckets started from the backward, and the
    last gradient hook to the last bucket's completion."""
    for mode, bb in OVERLAP_RUNS:
        run = by_mode[overlap_label(mode, bb) + suffix]
        base = by_mode[mode + suffix]
        ov = run["overlap"]
        print(f"e2e {run['mode']}: {run['img_per_s']:.2f} img/s per GPU "
              f"({mode}{suffix} without overlap, same run: "
              f"{base['img_per_s']:.2f}); {ov['buckets']} buckets, "
              f"{ov['started_in_backward']} started from the backward's hooks "
              f"({ov['started_with_leaves_pending']} of them while gradients "
              f"were still to come), last hook to last completion "
              f"{ov['last_hook_to_done_ms']:.3f} ms; NCCL calls a step in the "
              f"update {json.dumps(run['nccl_calls'].get('update', {}))}; "
              f"launches a step "
              f"{json.dumps({k: v / run['steps'] for k, v in run['launches'].items() if v})}"
              f"; hook route bit-equal to the exchange re-run after the "
              f"backward ({smi})", flush=True)


def _cost_text(cost: dict) -> str:
    m, h = cost["median_ms"], cost["median_host_ms"]
    return (f"the update alone, medians of {COST_TURNS} turns of "
            f"{COST_ITERS}: {m['plain']:.3f} ms unguarded, {m['guarded']:.3f} "
            f"guarded on the card's clock (+{cost['guard_ms']:.3f}), "
            f"{h['plain']:.3f} / {h['guarded']:.3f} ms to issue on the host "
            f"(+{cost['guard_host_ms']:.3f})")


def print_guarded(by_mode: dict, smi: str) -> None:
    """The guarded phase's lines: each guarded ResNet-50 run's img/s
    beside the same mode unguarded in this run (the guard's cost a step)
    and its update alone with and without the guard, the bf16 run, and
    the LM's tokens/s guarded and not and its update alone; fails unless
    the guarded LM update makes the unguarded one's NCCL calls plus the
    guard's one all-gather."""
    from horovod_tpu_torch.ops import collective as C

    bb = OVERLAP_RUNS[0][1]
    for label, base in (("zero1_guarded", "zero1"),
                        ("allreduce_guarded", "allreduce"),
                        (overlap_label("allreduce_guarded", bb),
                         overlap_label("allreduce", bb))):
        g, b = by_mode[label], by_mode[base]
        cost = 1e3 * 64 * (1 / g["img_per_s"] - 1 / b["img_per_s"])
        print(f"e2e {label}: {g['img_per_s']:.2f} img/s per GPU under the "
              f"guard with loss_scale=\"dynamic\", {base} unguarded in the "
              f"same run {b['img_per_s']:.2f} (the guard's cost {cost:.3f} ms "
              f"a step of {1e3 * 64 / b['img_per_s']:.3f}); NaN step "
              f"{GUARD_NAN} skipped bit for bit, scale "
              f"{g['verdicts'][GUARD_NAN - 1]['loss_scale']:g} -> "
              f"{g['verdicts'][GUARD_NAN]['loss_scale']:g}; NCCL calls a step "
              f"in the update {json.dumps(g['nccl_calls'].get('update', {}))} "
              f"(unguarded {json.dumps(b['nccl_calls'].get('update', {}))}); "
              f"good step bit-equal to unguarded, no host sync in the guard; "
              f"{_cost_text(g['update_cost'])} ({smi})", flush=True)
    bf = by_mode[BF16_MODE]
    print(f"e2e {BF16_MODE}: {bf['img_per_s']:.2f} img/s per GPU, losses "
          f"{bf['losses']}, {bf['launches_bf16']} bf16 fused_adam launches "
          f"over {bf['elements']} elements a step ({smi})", flush=True)
    lm, lg = by_mode["lm"], by_mode["lm_guarded"]
    want = dict(lm["nccl_update"])
    want[C._AG] = want.get(C._AG, 0) + 1
    if lg["nccl_update"] != want:
        fail(f"lm_guarded: the update made {lg['nccl_update']} NCCL calls a "
             f"step, expected the unguarded LM's plus one all-gather: {want}")
    cost = 1e3 * LM_BATCH * LM_SEQ * (1 / lg["tokens_per_s"]
                                      - 1 / lm["tokens_per_s"])
    print(f"e2e lm_guarded: {lg['tokens_per_s']:.1f} tokens/s per GPU under "
          f"the guard with loss_scale=\"dynamic\", lm unguarded in the same "
          f"run {lm['tokens_per_s']:.1f} (the guard's cost {cost:.3f} ms a "
          f"step of {1e3 * LM_BATCH * LM_SEQ / lm['tokens_per_s']:.3f}), "
          f"losses {lg['losses']}, verdict {json.dumps(lg['guard'])}, NCCL "
          f"calls a step in the update {json.dumps(lg['nccl_update'])} "
          f"(unguarded {json.dumps(lm['nccl_update'])}); "
          f"{_cost_text(lg['update_cost'])} ({smi})", flush=True)


def bf16_adam_row(f32_row: dict, run: dict) -> dict:
    """The kernels line's row of B5's bf16 instantiation: its replay of
    the bf16 run's step (the 161 bf16 leaves in one launch, held bit for
    bit against the plain version) and that run's launches."""
    m = f32_row["by_mode"][BF16_MODE]
    return dict(name="fused_adam_bf16", route="cuda",
                source=SOURCES["fused_adam"], replaces=TPU_KERNELS["fused_adam"],
                launches=run["launches_bf16"],
                launches_by_mode={BF16_MODE: run["launches_bf16"]},
                max_abs_err=m["max_abs_err"], ms=m["ms"], kernel_ms=m["ms"],
                device_ms=m["device_ms"], plain_ms=m["plain_ms"],
                bound_ms=m["bound_ms"], bound_by=m["bound_by"],
                library_ms=m["library_ms"], elements=run["elements"],
                bar="bit-equal to the plain version")


# --------------------------------------------------------------------------
# phase 18: tensor, sequence, pipeline and expert parallelism

#: lm_flagship with learned positions: the TP block and the PP split take
#: no RoPE
LM_LEARNED = dict(LM, pos_embedding="learned")
#: phase 18's training runs: steps, and adamw's learning rate
PAR_STEPS, PAR_LR = 4, 1e-4
#: the PP runs' micro-batches, each 1 x 2048 (the flagship's batch of 8)
PP_MICRO = 8
#: the MoE runs: width, expert hidden width, experts, tokens a rank,
#: capacity factor
MOE = dict(dim=1024, hidden=4096, experts=8, tokens=4096, factor=2.0)
#: the first SP/PP step against make_train_step's dense flash step from
#: the same parameters on the same global batch (both bf16 compute): the
#: loss within FIRST_LOSS_RTOL, and every leaf's gradient (what the
#: optimizer is given, after the step's averaging) within FIRST_GRAD_RTOL
#: of the dense step's in norm, ||g - g_dense|| / ||g_dense|| (other
#: matmul shapes and sum orders round bf16 activations the other way).
#: The parameters after a first Adam step cannot tell: it moves each by
#: lr * sign(g), so a wrong gradient moves them no further than a right one.
#: On an H100 the loss is within 1.3e-5 and every leaf within 0.0114 (the
#: ring's token embedding; Ulysses 0 at one GPU, 0.0023 at four; the PP
#: steps 0.0023); a ring whose last rotation goes the wrong way, or a
#: ppermute whose backward reuses the forward's permutation, puts leaves
#: near 1 (the CPU rehearsal of this phase at four ranks)
FIRST_LOSS_RTOL, FIRST_GRAD_RTOL = 1e-4, 3e-2
#: the TP block on the card (f32, TF32 off) against the dense block: each
#: output element within TP_C * 2^-24 * (K_proj * (|att| @ |W_proj|) +
#: K_down * (|gelu(h)| @ |W_down|)), K the two row-split contractions
#: (1024 and 4096 terms). A sum of K f32 products in any order is within
#: K * 2^-24 * sum |a b| of the exact one, so c = 2 is the worst case of
#: two orders; rounding errors of random sign sit far below it, and so do
#: those of a lower precision. TP_C is set between the sound runs' largest
#: reading and the control's, the same block with TF32 on (:func:`tp_run`
#: fails if the control meets the bar): on an H100, 0.00072 at one GPU
#: and 0.0026 at four against the control's 0.395. The elements over the
#: JAX test's elementwise bar (set at dim 32) are counted beside it
TP_C = 0.03
TP_JAX_RTOL, TP_JAX_ATOL = 2e-5, 2e-6
#: the TP block's gradients (mean over the axis) against the dense block's:
#: within TP_GRAD_TOL of each tensor's largest magnitude (the weight
#: gradients sum 16,384 rows)
TP_GRAD_TOL = 1e-4
#: the MoE (f32) against its local reference: rtol MOE_TOL, atol MOE_TOL
#: of the reference's largest magnitude (the JAX test's 1e-4 at unit
#: scale); the control, the same MoE with TF32 on, must not meet it (on an
#: H100: sound 1.5e-6 at most, the control 0.050 at least)
MOE_TOL = 1e-4
#: the ReLU kink check (one GPU, top1): a flipped ReLU is one whose
#: pre-activation has another sign in the port than in the reference; each
#: must lie within KINK_C times its f32 rounding bound, D * 2^-24 *
#: (|x| @ |w1|), of 0 (c = 2: the worst case of two sum orders)
KINK_C = 2.0
#: zigzag attention (bf16 in and out) against dense f32 attention on the
#: un-permuted sequence (:func:`_attn_ref`): out within one bf16 ULP (ULPs
#: below 2^-8's floored, flash_fwd's bar), q/k/v gradients within one bf16
#: ULP plus ATTN_GRAD_ATOL of the reference's largest magnitude (their f32
#: sums run over 2048 keys in other orders before the bf16 rounding)
ATTN_GRAD_ATOL = 2.0 ** -12


def _par_tokens(dev):
    """The flagship's global batch: tokens ``[8, 2048]`` from
    ``np.random.RandomState(0)`` and the targets rolled by one."""
    import numpy as np
    import torch

    tok = np.random.RandomState(0).randint(
        0, LM["vocab"], (LM_BATCH, LM_SEQ)).astype(np.int64)
    return (torch.from_numpy(tok).to(dev),
            torch.from_numpy(np.roll(tok, -1, axis=1)).to(dev))


def par_steps(label: str, fn, steps: int, check_first=None) -> dict:
    """``steps`` calls of ``fn()`` (a loss tensor, or None), each with its
    kernel-wrapper calls logged and its NCCL calls counted by group and
    name; launch counts set to 0 just before the first and read after the
    last. ``check_first(loss)`` runs after the first call, outside the
    counts (it launches no kernel and makes no collective)."""
    import torch

    from horovod_tpu_torch.ops import kernels as K

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    calls, losses, times, nccl = [], [], [], []
    for i in range(steps):
        calls.append([])
        counts, by_group = {}, {}
        with logging_calls(calls), counting_collectives(counts, ["step"],
                                                        by_group=by_group):
            t0 = time.perf_counter()
            loss = fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        nccl.append({g: rec["ops"] for g, rec in by_group.items()})
        losses.append(None if loss is None else float(loss))
        if i == 0 and check_first is not None:
            check_first(losses[0])
    launches = dict(K.launches)
    for k in K.KERNELS:
        logged = sum(sig[0] == k for c in calls for sig in c)
        if logged != launches[k]:
            fail(f"{label}: {launches[k]} launches of {k} but {logged} "
                 "logged calls")
    return dict(mode=label, steps=steps, losses=losses, step_s=times,
                launches=launches, nccl_by_step=nccl, step_calls=calls[-1],
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)


def par_expect(run: dict, flash: int, nccl: dict) -> None:
    """Fail unless ``run`` launched ``flash_fwd`` exactly ``flash`` times
    a step and made exactly the NCCL calls ``nccl`` (group -> call ->
    count) in every step, and no other kernel."""
    steps = run["steps"]
    want = {k: 0 for k in run["launches"]}
    want["flash_fwd"] = flash * steps
    if run["launches"] != want:
        fail(f"{run['mode']}: launches {run['launches']}, expected "
             f"flash_fwd {flash} a step and nothing else")
    for i, got in enumerate(run["nccl_by_step"]):
        if got != nccl:
            fail(f"{run['mode']}: NCCL calls by group in step {i + 1} "
                 f"{json.dumps(got)}, expected {json.dumps(nccl)}")
    losses = [v for v in run["losses"] if v is not None]
    if losses and not all(math.isfinite(v) for v in losses):
        fail(f"{run['mode']}: non-finite loss {losses}")


def _steady(times: list) -> float:
    """Seconds a step over the steps after the second (each sub-group's
    NCCL communicator is made at its first call)."""
    rest = times[2:] or times[-1:]
    return sum(rest) / len(rest)


def _params_sha(params: dict) -> str:
    return hashlib.sha256(b"".join(
        params[k].detach().reshape(-1).float().cpu().numpy().tobytes()
        for k in sorted(params))).hexdigest()


def keeping_grads(tx, kept: list):
    """``tx`` whose ``update`` also appends a copy of the gradients it is
    given to ``kept`` while ``kept`` is empty or ends in a dict (append
    None to stop): one dict a call."""
    def update(grads, state, params=None):
        if not kept or kept[-1] is not None:
            kept.append({k: g.detach().clone() for k, g in grads.items()})
        return tx.update(grads, state, params)

    return type(tx)(tx.init, update)


def dense_first_step(cfg: dict, x, y) -> tuple:
    """``make_train_step``'s dense flash step of the flagship (``cfg``),
    random weights from seed 0, ``adamw(PAR_LR)``, on the global batch:
    ``(loss, the gradients its update was given)``. Every rank of a world
    runs it on the same batch (its allreduces average equal gradients)."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import TransformerLM

    model = TransformerLM(**cfg, dtype=torch.bfloat16,
                          attention_fn=hvd.flash_attention, seed=0,
                          device=hvd.device())
    kept = []
    tx = keeping_grads(hvd.adamw(PAR_LR), kept)
    step = hvd.make_train_step(model, tx, loss_fn=hvd.lm_xent)
    _, loss = step(tx.init(model.jax_params()), x, y)
    del model, step
    torch.cuda.empty_cache()
    return float(loss), kept[0]


def first_step_check(label: str, loss: float, grads: dict, dense: tuple,
                     key_of=lambda k: k) -> dict:
    """The first step's loss and gradients against the dense step's
    (:data:`FIRST_LOSS_RTOL`, :data:`FIRST_GRAD_RTOL` a leaf in norm);
    fails past them. ``key_of`` maps a key of ``grads`` to the dense
    key; every dense leaf must be met once."""
    import torch

    d_loss, d_grads = dense
    if sorted(map(key_of, grads)) != sorted(d_grads):
        fail(f"{label}: first step's gradients cover "
             f"{sorted(map(key_of, grads))}, the dense step's "
             f"{sorted(d_grads)}")
    rel = abs(loss - d_loss) / abs(d_loss)
    by_leaf = {}
    for k, g in grads.items():
        ref = d_grads[key_of(k)]
        by_leaf[k] = float(torch.linalg.vector_norm((g - ref).float())
                           / torch.linalg.vector_norm(ref.float()))
    worst = max(by_leaf, key=by_leaf.get)
    rec = dict(loss=loss, dense_loss=d_loss, loss_rel=rel,
               grad_rel_max=by_leaf[worst], grad_rel_max_leaf=worst,
               grad_rel_median=sorted(by_leaf.values())[len(by_leaf) // 2],
               leaves=len(by_leaf))
    if rel > FIRST_LOSS_RTOL or by_leaf[worst] > FIRST_GRAD_RTOL:
        fail(f"{label}: first step against the dense step {json.dumps(rec)}")
    return rec


def sp_run(kind: str, axes: dict, x, y, dense: tuple) -> dict:
    """``lm_flagship`` through ``make_sp_train_step`` (``kind`` ring or
    ulysses) on the ``axes`` mesh, :data:`PAR_STEPS` steps of
    ``adamw(PAR_LR)`` on this rank's shard of the global batch; the first
    step against the dense step; exact flash_fwd launches and NCCL calls
    by group a step."""
    import functools

    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import TransformerLM
    from horovod_tpu_torch.parallel import (
        build_mesh, ring_attention, ulysses_attention,
    )
    from horovod_tpu_torch.training import make_sp_train_step

    mesh = build_mesh(axes)
    nd, ns = mesh.axis_size("data"), mesh.axis_size("seq")
    d, s = mesh.axis_index("data"), mesh.axis_index("seq")
    label = f"sp_{kind}@{hvd.size()}"
    bl, tl = LM_BATCH // nd, LM_SEQ // ns
    xs = x[d * bl:(d + 1) * bl, s * tl:(s + 1) * tl].contiguous()
    ys = y[d * bl:(d + 1) * bl, s * tl:(s + 1) * tl].contiguous()
    attn = functools.partial(
        ring_attention if kind == "ring" else ulysses_attention,
        axis_name="seq")
    model = TransformerLM(**LM, dtype=torch.bfloat16, attention_fn=attn,
                          seed=0, device=hvd.device())
    kept = []
    tx = keeping_grads(hvd.adamw(PAR_LR), kept)
    st = [tx.init(model.jax_params())]
    step = make_sp_train_step(model, tx)
    first = {}

    def check(loss):
        first.update(first_step_check(label, loss, kept[0], dense))
        kept[:] = [None]

    def one():
        st[0], loss = step(st[0], xs, ys)
        return loss

    run = par_steps(label, one, PAR_STEPS, check)
    depth = LM["depth"]
    want = {}
    if ns > 1:
        want["SEQ"] = ({"batch_isend_irecv": depth * (2 * ns - 1)}
                       if kind == "ring" else {"all_to_all_single": 8 * depth})
        want["SEQ"]["all_reduce"] = 1
    if nd > 1:
        want["DATA"] = {"all_reduce": 1}
    par_expect(run, 0 if kind == "ring" else depth, want)
    if not run["losses"][-1] < run["losses"][0]:
        fail(f"{label}: loss did not fall: {run['losses']}")
    run.update(first_step=first, params_sha=_params_sha(model.jax_params()),
               tokens_per_s_per_gpu=LM_BATCH * LM_SEQ / _steady(
                   run["step_s"]) / hvd.size(),
               nccl_want=want, axes=axes)
    del model, st, step
    torch.cuda.empty_cache()
    return run


def pp_run(v: int, x, y, dense: tuple) -> dict:
    """``lm_flagship_learned`` through ``make_transformer_pp_train_step``
    over a pipe axis of every rank, :data:`PP_MICRO` micro-batches of 1 x
    2048, ``v`` stages a rank (v > 1: the interleaved schedule);
    :data:`PAR_STEPS` steps of ``adamw(PAR_LR)``; the first step against
    the dense step (each rank its blocks); exact flash_fwd launches (every
    tick runs the rank's stages, bubble ticks on what it holds) and NCCL
    calls a step."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import TransformerLM
    from horovod_tpu_torch.parallel import build_mesh
    from horovod_tpu_torch.parallel.pipeline import interleaved_schedule
    from horovod_tpu_torch.training import (
        make_transformer_pp_train_step, split_transformer_for_pp,
    )

    S = hvd.size()
    r = build_mesh({"pipe": S}).axis_index("pipe")
    label = f"pp_{'interleaved' if v > 1 else 'gpipe'}@{S}"
    model = TransformerLM(**LM_LEARNED, dtype=torch.bfloat16,
                          attention_fn=hvd.flash_attention, seed=0,
                          device=hvd.device())
    pp = split_transformer_for_pp(
        model, {k: t.detach().clone() for k, t in model.jax_params().items()},
        S, interleaved_v=v)
    pp["stages"] = {k: t[r:r + 1].clone() for k, t in pp["stages"].items()}
    del model
    meta = TransformerLM(**LM_LEARNED, dtype=torch.bfloat16,
                         attention_fn=hvd.flash_attention, device="meta")
    kept = []
    tx = keeping_grads(hvd.adamw(PAR_LR), kept)
    st = [{p: tx.init(pp[p]) for p in pp}]
    step = make_transformer_pp_train_step(meta, tx, interleaved_v=v)
    tm = x.view(PP_MICRO, LM_BATCH // PP_MICRO, LM_SEQ)
    ym = y.view(PP_MICRO, LM_BATCH // PP_MICRO, LM_SEQ)
    per = LM["depth"] // (S * v)
    first = {}

    def check(loss):
        # the step's three updates: the stages', the embedding's, the head's
        parts = dict(zip(("stages", "embed", "head"), kept))
        grads, keys = {}, {}
        for p in ("embed", "head"):
            for k, t in parts[p].items():
                grads[f"{p}:{k}"], keys[f"{p}:{k}"] = t, k
        for k, t in parts["stages"].items():
            j, rest = k.split("/", 1)
            for w in range(v):
                name = f"stages:{k}#{w}"
                grads[name] = t[0] if v == 1 else t[0, w]
                block = (w * S + r) * per + int(j[1:])
                keys[name] = f"block{block}/{rest}"
        # this rank's blocks only: the dense step's other blocks are the
        # other ranks' to meet
        mine = {keys[k] for k in grads}
        first.update(first_step_check(
            label, loss, grads,
            (dense[0], {k: g for k, g in dense[1].items() if k in mine}),
            keys.__getitem__))
        kept[:] = [None]

    def one():
        _, st[0], loss = step(pp, st[0], tm, ym)
        return loss

    run = par_steps(label, one, PAR_STEPS, check)
    if v == 1:
        n_ticks = PP_MICRO + S - 1
        bubbles = S - 1
    else:
        ticks = interleaved_schedule(S, v, PP_MICRO)
        n_ticks = len(ticks)
        bubbles = sum(not row[r].active for row in ticks)
    want = ({"PIPE": {"batch_isend_irecv": 2 * (n_ticks - 1),
                      "all_reduce": 3}} if S > 1 else {})
    par_expect(run, n_ticks * per, want)
    if not run["losses"][-1] < run["losses"][0]:
        fail(f"{label}: loss did not fall: {run['losses']}")
    shared = {f"{p}/{k}": t for p in ("embed", "head")
              for k, t in pp[p].items()}
    run.update(first_step=first, params_sha=_params_sha(shared),
               ticks=n_ticks, bubble_ticks=bubbles, blocks_a_stage=per,
               tokens_per_s_per_gpu=LM_BATCH * LM_SEQ / _steady(
                   run["step_s"]) / S, nccl_want=want)
    del pp, st, step
    torch.cuda.empty_cache()
    return run


def _attn_ref(q, k, v, dout):
    """Dense causal attention in f32 on the un-permuted sequence, and the
    flash backward's q/k/v gradients for ``dout`` computed densely: delta
    from the output rounded to its bf16 (what the flash and ring
    backwards save, as the JAX package's do)."""
    import torch

    qf, kf, vf, df = (t.float() for t in (q, k, v, dout))
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", qf * scale, kf)
    t = q.shape[1]
    mask = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~mask, -1e30), dim=-1)
    del s
    out = torch.einsum("bhqk,bkhd->bqhd", p, vf)
    delta = torch.einsum("bqhd,bqhd->bhq", out.to(q.dtype).float(), df)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, df)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", df, vf) - delta[..., None])
    del p
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    return out, [dq, dk, dv]


def _within_bf16(got, ref, atol: float = 0.0) -> float:
    """The largest ``|got - ref|`` over one bf16 ULP of ``ref`` (ULPs below
    2^-8's floored) plus ``atol``; at most 1 to pass."""
    diff, ulp = _bf16_ulps(got.detach(), ref, FLASH_ULP_FLOOR)
    return float((diff / (ulp + atol)).max())


def zigzag_run(n: int) -> dict:
    """``zigzag_ring_attention`` forward and backward at ``[8, 2048, 16,
    64]`` bf16 (causal) over a seq axis of the ``n`` ranks, each on its
    zigzag chunk pair, against dense attention on the un-permuted
    sequence; 4 iterations, the first checked."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel import (
        build_mesh, zigzag_permutation, zigzag_ring_attention,
    )

    r = build_mesh({"seq": n}).axis_index("seq")
    label = f"zigzag_attn@{n}"
    dev = hvd.device()
    gen = torch.Generator(device=dev).manual_seed(18)
    shape = (LM_BATCH, LM_SEQ, LM["heads"], LM["dim"] // LM["heads"])
    q, k, v, dout = (torch.randn(shape, device=dev, generator=gen).to(
        torch.bfloat16) for _ in range(4))
    perm = torch.from_numpy(zigzag_permutation(LM_SEQ, n)).to(dev)
    tl = LM_SEQ // n
    mine = perm[r * tl:(r + 1) * tl]
    loc = [t[:, mine].contiguous().requires_grad_(True) for t in (q, k, v)]
    dl = dout[:, mine].contiguous()
    ref_out, ref_grads = _attn_ref(q, k, v, dout)
    ref_out, ref_grads = ref_out[:, mine], [g[:, mine] for g in ref_grads]
    errs = {}

    def one():
        out = zigzag_ring_attention(*loc)
        grads = torch.autograd.grad(out, loc, dl)
        if not errs:
            errs["out_ulps"] = _within_bf16(out, ref_out)
            for name, g, rg in zip("qkv", grads, ref_grads):
                errs[f"d{name}_ulps"] = _within_bf16(
                    g, rg, ATTN_GRAD_ATOL * float(rg.abs().max()))
        return None

    run = par_steps(label, one, PAR_STEPS)
    if max(errs.values()) > 1.0:
        fail(f"{label}: against dense attention {json.dumps(errs)}")
    want = {"SEQ": {"batch_isend_irecv": 2 * n - 1}} if n > 1 else {}
    par_expect(run, 0, want)
    del q, k, v, dout, loc, ref_out, ref_grads
    torch.cuda.empty_cache()
    run.update(errors=errs, fwd_bwd_s=_steady(run["step_s"]), nccl_want=want)
    return run


def with_tf32(fn):
    """``fn()`` with TF32 on for f32 matmuls (a bar's control: a lower
    precision than the f32 the bar is set for), then off again."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return fn()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def _tp_block(dev):
    """One ``lm_flagship_learned`` block in f32 with random weights (seed
    18; biases and LayerNorm affines non-trivial), as the JAX package's
    nested dict in flax's layouts (leaves requiring grad), and the port's
    dense ``TransformerBlock`` on the same leaves."""
    import torch

    from horovod_tpu_torch.models.layers import torch_params
    from horovod_tpu_torch.models.transformer import (
        TransformerBlock, default_attention,
    )

    block = TransformerBlock(LM["dim"], LM["heads"], LM["mlp_ratio"],
                             dtype=torch.float32,
                             attention_fn=default_attention, device=dev)
    gen = torch.Generator(device=dev).manual_seed(18)
    for m in block.modules():
        if m is not block and hasattr(m, "reset_parameters"):
            m.reset_parameters(gen)
    flat = {}
    for name, m in block.named_children():
        for leaf, t in m.jax_params().items():
            t = t.detach().clone()
            if t.dim() == 1:
                t += 0.1 * torch.randn(t.shape, device=dev, generator=gen)
            flat[f"{name}/{leaf}"] = t.requires_grad_(True)
    tree: dict = {}
    for k, t in flat.items():
        a, b = k.split("/")
        tree.setdefault(a, {})[b] = t
    return block, flat, tree, lambda x: torch.func.functional_call(
        block, torch_params(block, flat), (x,))


def tp_run(n: int) -> dict:
    """``tp_block_apply`` forward and backward at one ``lm_flagship_learned``
    block, x ``[8, 2048, 1024]`` f32, over a tp axis of the ``n`` ranks,
    4 iterations: each rank's output against the dense block within the
    contraction-scaled bound (:data:`TP_C`), the elements over the JAX
    test's elementwise bar counted; the gradients' mean over the axis
    against the dense block's; exact all-reduces on TP a step."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.transformer import tp_block_apply
    from horovod_tpu_torch.parallel import build_mesh, spmd

    build_mesh({"tp": n})
    label = f"tp_block@{n}"
    dev = hvd.device()
    torch.backends.cuda.matmul.allow_tf32 = False
    block, flat, tree, dense = _tp_block(dev)
    gen = torch.Generator(device=dev).manual_seed(19)
    x = torch.randn(LM_BATCH, LM_SEQ, LM["dim"], device=dev,
                    generator=gen).requires_grad_(True)
    dy = torch.randn(x.shape, device=dev, generator=gen)
    seen = {}
    hooks = [getattr(block, name).register_forward_hook(
        lambda m, args, out, name=name: seen.__setitem__(name, args[0]))
        for name in ("proj", "mlp_down")]
    ref = dense(x)
    for h in hooks:
        h.remove()
    keys = sorted(flat)
    ref_grads = torch.autograd.grad(ref, [x] + [flat[k] for k in keys], dy)
    ref = ref.detach()
    with torch.no_grad():
        bound = 2.0 ** -24 * (
            LM["dim"] * (seen["proj"].abs() @ flat["proj/kernel"].abs())
            + LM["mlp_ratio"] * LM["dim"] * (
                seen["mlp_down"].abs() @ flat["mlp_down/kernel"].abs()))
    del seen
    got = {}

    def one():
        out = tp_block_apply(tree, x, heads=LM["heads"], axis="tp")
        grads = torch.autograd.grad(out, [x] + [flat[k] for k in keys], dy)
        if not got:
            got["out"], got["grads"] = out.detach(), grads
        return None

    run = par_steps(label, one, PAR_STEPS)
    with torch.no_grad():
        diff = (got["out"] - ref).abs()
        norm = float((diff / bound).max())
        over_jax = int((diff > TP_JAX_ATOL + TP_JAX_RTOL * ref.abs()).sum())
        grads = [spmd.pmean(g, "tp") for g in got["grads"]]
        grad_err = {name: float((g - rg).abs().max() / rg.abs().max())
                    for name, g, rg in zip(["x"] + keys, grads, ref_grads)}
        ctl = with_tf32(lambda: tp_block_apply(tree, x, heads=LM["heads"],
                                               axis="tp")) - ref
        ctl_norm = float((ctl.abs() / bound).max())
        ctl_over_jax = int((ctl.abs() > TP_JAX_ATOL
                            + TP_JAX_RTOL * ref.abs()).sum())
        del ctl
    errs = dict(normalised_max=norm, bound_c=TP_C, over_jax_bar=over_jax,
                elements=diff.numel(), max_abs=float(diff.max()),
                grad_rel_max=max(grad_err.values()), grad_rel=grad_err,
                tf32_control_normalised_max=ctl_norm,
                tf32_control_over_jax_bar=ctl_over_jax)
    if norm > TP_C or max(grad_err.values()) > TP_GRAD_TOL:
        fail(f"{label}: against the dense block {json.dumps(errs)}")
    if ctl_norm <= TP_C:
        fail(f"{label}: the block with TF32 on meets the bar too "
             f"{json.dumps(errs)}")
    want = {"TP": {"all_reduce": 4}} if n > 1 else {}
    par_expect(run, 0, want)
    del got, grads, ref, ref_grads, bound, diff, x, dy, block, flat, tree
    torch.cuda.empty_cache()
    run.update(errors=errs, fwd_bwd_s=_steady(run["step_s"]),
               tokens_per_s_per_gpu=LM_BATCH * LM_SEQ / _steady(
                   run["step_s"]) / n, nccl_want=want)
    return run


def _moe_expert(p, tokens):
    """The MoE runs' expert: a GELU (tanh) MLP, as the LM's. Smooth: a
    ReLU's kink turns a last-bit difference of a pre-activation between
    two matmul orders into a whole term of a weight's gradient
    (:func:`moe_relu_run` shows it)."""
    import torch.nn.functional as F

    return F.gelu(tokens @ p[0], approximate="tanh") @ p[1]


def _moe_ref_expert(ex, p, tokens):
    return _moe_expert(p, tokens)


def _moe_reference(router, w1, w2, x, routing: str, capacity: int,
                   expert=_moe_ref_expert):
    """Each token through its chosen experts, gate-weighted (top2: the
    pair's gates renormalized), in token order: an expert keeps the first
    ``capacity`` of its first choices, then second choices while room is
    left (the GShard policy); the rest are dropped. ``expert(ex, (w1[ex],
    w2[ex]), tokens)`` is expert ``ex`` on its kept tokens. ``(y, aux,
    dropped)``."""
    import torch

    gates = torch.softmax(x @ router, dim=-1)
    e = router.shape[1]
    k = 1 if routing == "top1" else 2
    top = torch.topk(gates, k, dim=-1)
    g = top.values if k == 1 else top.values / torch.clamp_min(
        top.values.sum(-1, keepdim=True), 1e-9)
    y = torch.zeros_like(x)
    dropped = 0
    for ex in range(e):
        room = capacity
        for c in range(k):
            idx = torch.nonzero(top.indices[:, c] == ex).flatten()
            kept = idx[:max(room, 0)]
            dropped += idx.numel() - kept.numel()
            room -= kept.numel()
            if kept.numel():
                h = expert(ex, (w1[ex], w2[ex]), x[kept])
                y = y.index_add(0, kept, g[kept, c:c + 1] * h)
    first = torch.nn.functional.one_hot(top.indices[:, 0], e).float()
    aux = (first.mean(0) * gates.mean(0)).sum() * e
    return y, aux, dropped


def _moe_inputs(n: int) -> dict:
    """The MoE runs' inputs on this rank of an expert axis of ``n``: the
    router ``[D, E]``, experts ``w1 [E, D, H]``, ``w2 [E, H, D]`` (seed
    18), tokens ``x [T, D]`` and the output's cotangent ``dy`` (seed 100 +
    rank); ``leaves`` the port's copies requiring grad (the router, this
    rank's experts, the tokens); the capacity."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel import build_mesh
    from horovod_tpu_torch.parallel.moe import moe_capacity

    r = build_mesh({"expert": n}).axis_index("expert")
    dev = hvd.device()
    D, H, E, T = MOE["dim"], MOE["hidden"], MOE["experts"], MOE["tokens"]
    el = E // n
    gen = torch.Generator(device=dev).manual_seed(18)
    router = torch.randn(D, E, device=dev, generator=gen) * 0.02
    w1 = torch.randn(E, D, H, device=dev, generator=gen) * D ** -0.5
    w2 = torch.randn(E, H, D, device=dev, generator=gen) * H ** -0.5
    gen.manual_seed(100 + r)
    x = torch.randn(T, D, device=dev, generator=gen)
    dy = torch.randn(T, D, device=dev, generator=gen)
    mine = slice(r * el, (r + 1) * el)
    leaves = [t.clone().requires_grad_(True)
              for t in (router, w1[mine], w2[mine], x)]
    return dict(n=n, mine=mine, router=router, w1=w1, w2=w2, x=x, dy=dy,
                leaves=leaves, cap=moe_capacity(T, E, MOE["factor"]))


def _moe_port(m: dict, routing: str, expert_fn) -> tuple:
    """``expert_parallel_moe`` forward and backward (of ``sum(y * dy)``) on
    this rank: ``(y, aux, [router's, its experts', tokens' gradients])``."""
    import torch

    from horovod_tpu_torch.parallel import expert_parallel_moe

    rt, a, b, xs = m["leaves"]
    y, aux = expert_parallel_moe(rt, (a, b), xs, expert_fn,
                                 capacity_factor=MOE["factor"],
                                 routing=routing)
    grads = torch.autograd.grad((y * m["dy"]).sum(), [rt, a, b, xs])
    return y.detach(), aux.detach(), [g.detach() for g in grads]


def _moe_ref(m: dict, routing: str, expert=_moe_ref_expert) -> tuple:
    """The local reference (:func:`_moe_reference`, ``expert`` its
    expert) forward and backward on this rank's tokens: ``(y, aux,
    gradients of the router, every expert, the tokens, dropped)``, the
    experts' summed over the axis (every rank's tokens' share) and aux
    averaged over it."""
    import torch

    import horovod_tpu_torch as hvd

    leaves = [t.clone().requires_grad_(True)
              for t in (m["router"], m["w1"], m["w2"], m["x"])]
    y, aux, dropped = _moe_reference(*leaves, routing, m["cap"], expert)
    grads = [g.detach() for g in
             torch.autograd.grad((y * m["dy"]).sum(), leaves)]
    aux = aux.detach()
    if m["n"] > 1:
        for t in grads[1:3]:
            hvd.allreduce_(t, hvd.Sum, axis="expert")
        aux = hvd.allreduce(aux, hvd.Average, axis="expert")
    return y.detach(), aux, grads, dropped


def _moe_errs(m: dict, got: tuple, ref: tuple) -> dict:
    """Each output and gradient of ``got`` (:func:`_moe_port`) against
    ``ref`` (:func:`_moe_ref`): ``max(|g - r| - MOE_TOL |r|) / max |r|``
    (at most MOE_TOL to pass), aux relative."""
    y, aux, grads = got
    ry, raux, rg, _ = ref

    def err(g, r):
        return float(((g - r).abs() - MOE_TOL * r.abs()).max()
                     / r.abs().max())

    return dict(y=err(y, ry), router=err(grads[0], rg[0]),
                w1=err(grads[1], rg[1][m["mine"]]),
                w2=err(grads[2], rg[2][m["mine"]]), x=err(grads[3], rg[3]),
                aux_rel=float((aux - raux).abs() / raux))


def moe_run(n: int, routing: str) -> dict:
    """``expert_parallel_moe`` (``routing``) at D 1024, expert hidden 4096,
    8 experts over an expert axis of the ``n`` ranks, 4096 tokens a rank,
    capacity factor 2.0, forward and backward, 4 iterations: y, aux and
    the router's, experts' and tokens' gradients against the local
    reference (:func:`_moe_ref`), and its control, the same with TF32 on,
    failing the bar; exact all-to-alls and pmean a step."""
    import torch

    label = f"ep_moe_{routing}@{n}"
    torch.backends.cuda.matmul.allow_tf32 = False
    m = _moe_inputs(n)
    ref = _moe_ref(m, routing)
    got = []

    def one():
        out = _moe_port(m, routing, _moe_expert)
        if not got:
            got.append(out)
        return None

    run = par_steps(label, one, PAR_STEPS)
    with torch.no_grad():
        errs = _moe_errs(m, got[0], ref)
    ctl = _moe_errs(m, with_tf32(lambda: _moe_port(m, routing, _moe_expert)),
                    ref)
    errs["tf32_control_max"] = max(ctl.values())
    errs["tf32_control"] = ctl
    if max(v for k, v in errs.items() if not k.startswith("tf32")) > MOE_TOL:
        fail(f"{label}: against the local reference {json.dumps(errs)}")
    if errs["tf32_control_max"] <= MOE_TOL:
        fail(f"{label}: the MoE with TF32 on meets the bar too "
             f"{json.dumps(errs)}")
    want = ({"EXPERT": {"all_to_all_single": 4, "all_reduce": 1}}
            if n > 1 else {})
    par_expect(run, 0, want)
    dropped, cap = ref[3], m["cap"]
    del got, ref, m
    torch.cuda.empty_cache()
    run.update(errors=errs, dropped=dropped, capacity=cap,
               fwd_bwd_s=_steady(run["step_s"]),
               tokens_per_s_per_gpu=MOE["tokens"] / _steady(run["step_s"]),
               nccl_want=want)
    return run


def moe_relu_run() -> dict:
    """The MoE (one GPU, top1) with ReLU experts: why the smoke's experts
    are GELU. A pre-activation whose two matmul orders (the port's
    capacity buffer, the reference's kept rows) round to opposite signs
    flips the ReLU, and a flip moves a whole term of w1's and the tokens'
    gradients. Checks that every flip lies within :data:`KINK_C` times
    its rounding bound of 0, and that the reference given the port's
    ReLU mask meets :data:`MOE_TOL`; the plain ReLU reference's errors
    are reported beside it."""
    import torch

    label = "ep_moe_relu_top1@1"
    D = MOE["dim"]
    torch.backends.cuda.matmul.allow_tf32 = False
    m = _moe_inputs(1)
    port_pre, port_rows = [], []

    def relu_port(p, tokens):
        h = tokens @ p[0]
        port_pre.append(h.detach())
        port_rows.append(tokens.detach())
        return torch.relu(h) @ p[1]

    got = []
    run = par_steps(label, lambda: got.append(
        _moe_port(m, "top1", relu_port)), 1)
    ref_pre, ref_rows = {}, {}

    def relu_ref(ex, p, tokens):
        h = tokens @ p[0]
        ref_pre[ex], ref_rows[ex] = h.detach(), tokens.detach()
        return torch.relu(h) @ p[1]

    def port_mask_ref(ex, p, tokens):
        keep = port_pre[ex][:tokens.shape[0]] > 0
        return ((tokens @ p[0]) * keep) @ p[1]

    plain = _moe_ref(m, "top1", relu_ref)
    masked = _moe_ref(m, "top1", port_mask_ref)
    rec = dict(pre_activations=0, flips=0, flip_max_over_bound=0.0,
               diff_max_over_bound=0.0, rows_equal=True)
    with torch.no_grad():
        for ex, hr in ref_pre.items():
            k = hr.shape[0]
            rows = ref_rows[ex]
            rec["rows_equal"] &= bool(torch.equal(port_rows[ex][:k], rows))
            hp = port_pre[ex][:k]
            bound = D * 2.0 ** -24 * (rows.abs() @ m["w1"][ex].abs())
            flip = (hp > 0) != (hr > 0)
            rec["pre_activations"] += hr.numel()
            rec["flips"] += int(flip.sum())
            if flip.any():
                rec["flip_max_over_bound"] = max(
                    rec["flip_max_over_bound"],
                    float((hr.abs() / bound)[flip].max()))
            rec["diff_max_over_bound"] = max(
                rec["diff_max_over_bound"],
                float(((hp - hr).abs() / bound).max()))
        rec["plain_relu_errors"] = _moe_errs(m, got[0], plain)
        rec["port_mask_errors"] = _moe_errs(m, got[0], masked)
    if not rec["rows_equal"] or rec["flip_max_over_bound"] > KINK_C \
            or max(rec["port_mask_errors"].values()) > MOE_TOL:
        fail(f"{label}: the ReLU flips {json.dumps(rec)}")
    par_expect(run, 0, {})
    del got, plain, masked, m, port_pre, port_rows, ref_pre, ref_rows
    torch.cuda.empty_cache()
    run.update(errors=rec)
    return run


def parallel_phase(report=lambda run: None) -> list:
    """Phase 18 on every rank of the world (one GPU: a mesh of one): the
    SP runs, zigzag attention, the TP block, the PP runs and the MoE (one
    GPU: also with ReLU experts), ``report(run)`` after each. Returns this
    rank's run records."""
    import torch

    import horovod_tpu_torch as hvd

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 matmuls in f32
    n = hvd.size()
    x, y = _par_tokens(hvd.device())
    runs = []

    def done(run):
        runs.append(run)
        report(run)

    dense = dense_first_step(LM, x, y)
    done(sp_run("ring", {"data": 1, "seq": n}, x, y, dense))
    done(sp_run("ulysses", {"data": 2 if n > 1 else 1,
                            "seq": n // 2 if n > 1 else 1}, x, y, dense))
    del dense
    done(zigzag_run(n))
    done(tp_run(n))
    dense = dense_first_step(LM_LEARNED, x, y)
    done(pp_run(1, x, y, dense))
    if n > 1:
        done(pp_run(LM["depth"] // n, x, y, dense))
    del dense
    torch.cuda.empty_cache()
    for routing in ("top1", "top2"):
        done(moe_run(n, routing))
    if n == 1:
        done(moe_relu_run())
    return runs


def _parallel_rank() -> list:
    runs = parallel_phase()
    for run in runs:
        run["nccl_by_step"] = run["nccl_by_step"][-1:]
    return runs


def run_parallel_gpus(n: int) -> list:
    """Phase 18 across ``n`` GPUs: rank 0's runs, after checking that
    every rank reports the same losses and the same replicated
    parameters (SP: all; PP: the embedding and head)."""
    from horovod_tpu_torch.testing import run_world

    try:
        res = run_world(_parallel_rank, n, device=None, timeout=900)
    except RuntimeError as e:
        fail(f"{n} GPUs, phase 18: {e}")
    for r, out in enumerate(res):
        for o, o0 in zip(out, res[0]):
            if o["losses"] != o0["losses"] or \
                    o.get("params_sha") != o0.get("params_sha"):
                fail(f"{n} GPUs, {o['mode']}: rank {r} diverged from rank 0")
    return res[0]


def print_parallel(runs: list, smi: str) -> None:
    """Phase 18's lines: each run's numbers (tokens/s a GPU over the steps
    after the second, peak memory, the checks' errors, bubble ticks,
    dropped tokens, NCCL calls by group a step)."""
    keep = ("losses", "first_step", "tokens_per_s_per_gpu", "fwd_bwd_s",
            "peak_gib", "errors", "ticks", "bubble_ticks", "blocks_a_stage",
            "dropped", "capacity", "nccl_want", "axes", "step_s")
    for run in runs:
        rec = {k: run[k] for k in keep if k in run}
        rec["flash_fwd_a_step"] = run["launches"]["flash_fwd"] / run["steps"]
        print(f"parallel {run['mode']}: {json.dumps(rec)} ({smi}; TF32 off "
              "for f32 matmuls)", flush=True)


# --------------------------------------------------------------------------
# phase 19: resilience — preemption, rollback, retry, elastic resize

#: the preemption run: steps, and the step before which the chaos SIGTERM
#: lands
PREEMPT_STEPS = 8
PREEMPT_AT = 4
#: the rollback run: its steps, and the steps whose batch is NaN while
#: the replay epoch is 0 (HOROVOD_NUMERICS_MAX_BAD, 3, in a row)
ROLLBACK_STEPS = 8
ROLLBACK_NAN = (3, 4, 5)
#: the elastic run across the GPUs: 4 -> 3 -> 4
ELASTIC_SPEC = "rank_fail=1,rank_fail_at_step=3,rank_join_at_step=6"
ELASTIC_STEPS = 9
ELASTIC_FAIL, ELASTIC_JOIN = 3, 6
#: the run whose world falls below min_workers
TOO_SMALL_SPEC = "rank_fail=1,rank_fail_at_step=2"
TOO_SMALL_AT = 2
#: rows a GPU a step in phase 19
P19_BATCH = 64


def p19_batch(step: int, epoch: int = 0):
    """This rank's batch of ``step`` (replay epoch ``epoch``): 64 rows of
    224x224x3 and their labels, drawn on the device from a generator
    seeded by (epoch, step, rank), so every run, resumed or not, sees
    the same batches."""
    import torch

    import horovod_tpu_torch as hvd

    dev = hvd.device()
    gen = torch.Generator(device=dev).manual_seed(
        1_000_003 * epoch + 1009 * step + hvd.rank())
    x = torch.randn(P19_BATCH, 224, 224, 3, device=dev, generator=gen)
    y = torch.randint(0, 1000, (P19_BATCH,), device=dev, generator=gen)
    return x, y


def p19_state(model, opt_state) -> dict:
    return {"params": model.jax_params(),
            "batch_stats": model.jax_batch_stats(), "opt_state": opt_state}


def p19_load(model, state: dict) -> None:
    """A state's parameters and running stats into ``model``, unless they
    are its own (a resumed, rolled-back or resharded state holds new
    tensors)."""
    import torch

    with torch.no_grad():
        for part, views in (("params", model.jax_params()),
                            ("batch_stats", model.jax_batch_stats())):
            for k, v in views.items():
                if state[part][k].data_ptr() != v.data_ptr():
                    v.copy_(state[part][k])


def p19_builder(model, *, loss_scale=None, poison=None, log=None):
    """The elastic step builder: for each world a fresh ZeRO-1 + int8 +
    EF + fused Adam optimizer (:func:`make_tx`) and ``make_train_step``;
    the step loads the state into the model and trains on
    :func:`p19_batch` of its step and replay epoch (times NaN where
    ``poison(step, epoch)``). ``log`` gets ``(world, step, epoch,
    seconds, loss)`` a step, the step synchronised."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.resilience import numerics

    def builder(world):
        step = hvd.make_train_step(model, make_tx("zero1",
                                                  loss_scale=loss_scale),
                                   shard_optimizer=True)

        def step_fn(state, i):
            epoch = numerics.replay_epoch()
            x, y = p19_batch(i, epoch)
            if poison is not None and poison(i, epoch):
                x = x * float("nan")
            p19_load(model, state)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            opt, loss = step(state["opt_state"], x, y)
            loss = float(loss)
            if log is not None:
                log.append((hvd.size(), i, epoch,
                            time.perf_counter() - t0, loss))
            return p19_state(model, opt)

        return step_fn

    return builder


def _p19_setup() -> None:
    """Deterministic kernels (phase 10's settings): ``CUBLAS_WORKSPACE_
    CONFIG`` must come from the environment, set before CUDA starts."""
    import torch

    if not os.environ.get("CUBLAS_WORKSPACE_CONFIG"):
        fail("phase 19: CUBLAS_WORKSPACE_CONFIG must be set before CUDA "
             "starts")
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.benchmark = False


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def preempt_child(directory: str, role: str) -> None:
    """Phase 19's preemption on one GPU, in a child process (phase 10's
    determinism). ``preempt``: ``resilience.run`` of ResNet-50 ZeRO-1 for
    :data:`PREEMPT_STEPS` steps under ``HOROVOD_CHAOS=sigterm_at_step=``
    :data:`PREEMPT_AT`, a second SIGTERM sent during the drain; prints the
    preemption's record and leaves with ``Preempted``'s exit code.
    ``resume``: the same run from ``directory`` (it resumes at the
    emergency checkpoint), then an uninterrupted run of a fresh model and
    state; prints both final states' agreement and the resume's
    seconds."""
    import horovod_tpu_torch as hvd

    _p19_setup()
    hvd.init()
    try:
        _preempt_role(directory, role)
    finally:
        hvd.shutdown()


def _preempt_role(directory: str, role: str) -> None:
    import signal

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import checkpoint as ck
    from horovod_tpu_torch.observability import metrics
    from horovod_tpu_torch.resilience import loop

    dev = hvd.device()
    model = build_model("resnet50", 0, dev)
    state = p19_state(model, make_tx("zero1").init(model.jax_params()))
    fn = p19_builder(model)(1)
    times = {}
    if role == "preempt":
        drain, save = loop._drain, ck.save

        def noisy_drain(st, *a, **kw):     # the supervisor escalates
            t0 = time.perf_counter()
            os.kill(os.getpid(), signal.SIGTERM)
            time.sleep(0)
            drain(st, *a, **kw)
            times["drain_s"] = time.perf_counter() - t0

        def timed_save(*a, **kw):
            t0 = time.perf_counter()
            try:
                return save(*a, **kw)
            finally:
                times["emergency_checkpoint_s"] = time.perf_counter() - t0

        loop._drain, ck.save = noisy_drain, timed_save
        try:
            loop.run(fn, state, num_steps=PREEMPT_STEPS,
                     checkpoint_dir=directory)
        except loop.Preempted as e:
            print(json.dumps(dict(
                times, step=e.step, signum=e.signum,
                checkpoint=os.path.basename(e.checkpoint_path or ""),
                bytes=_dir_bytes(e.checkpoint_path),
                valid=ck.is_valid_checkpoint(e.checkpoint_path),
                latest_step=ck.latest_step(directory),
                preemptions=metrics.value("resilience_preemptions"),
                extra_signals=metrics.value(
                    "resilience_extra_preempt_signals"))), flush=True)
            raise
        fail("preemption: the run was not preempted")
    resume = loop.resume_state

    def timed_resume(d):
        t0 = time.perf_counter()
        try:
            return resume(d)
        finally:
            times["resume_s"] = time.perf_counter() - t0

    loop.resume_state = timed_resume
    resumed = loop.run(fn, state, num_steps=PREEMPT_STEPS,
                       checkpoint_dir=directory)
    loop.resume_state = resume
    model_b = build_model("resnet50", 0, dev)
    clean = loop.run(p19_builder(model_b)(1),
                     p19_state(model_b, make_tx("zero1").init(
                         model_b.jax_params())), num_steps=PREEMPT_STEPS)
    bad = _tree_mismatch(resumed, clean)
    print(json.dumps(dict(times, resumes=metrics.value("resilience_resumes"),
                          mismatched_leaves=len(bad),
                          leaves=len(_leaf_list(clean)))), flush=True)


def _leaf_list(tree) -> list:
    from horovod_tpu_torch import pytree

    return pytree.flatten(tree)[0]


def preemption_phase(gpu=None) -> dict:
    """Run :func:`preempt_child` as ``preempt``, which must leave with exit
    code 75 and a valid emergency checkpoint of step :data:`PREEMPT_AT`,
    the second SIGTERM only latched; then as ``resume``, whose final state
    must equal the uninterrupted run's bit for bit (on card ``gpu`` alone,
    when given)."""
    import shutil

    directory = os.path.join(CKPT_DIR, "preempt")
    shutil.rmtree(directory, ignore_errors=True)
    env = child_env(gpu, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    env.pop("HOROVOD_CHAOS", None)
    out = {}
    try:
        for role in ("preempt", "resume"):
            if role == "preempt":
                env["HOROVOD_CHAOS"] = f"sigterm_at_step={PREEMPT_AT}"
            else:
                env.pop("HOROVOD_CHAOS")
            r = subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--preempt", directory, role],
                               capture_output=True, text=True, timeout=600,
                               env=env)
            want = 75 if role == "preempt" else 0
            if r.returncode != want:
                fail(f"preemption ({role}): exit code {r.returncode}, "
                     f"expected {want}:\n{r.stderr[-3000:]}")
            out[role] = json.loads(r.stdout.strip().splitlines()[-1])
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    p, s = out["preempt"], out["resume"]
    if (p["step"], p["checkpoint"], p["latest_step"], p["valid"]) != (
            PREEMPT_AT, f"step_{PREEMPT_AT}", PREEMPT_AT, True):
        fail(f"preemption: emergency checkpoint {p}")
    if (p["preemptions"], p["extra_signals"]) != (1.0, 1.0):
        fail(f"preemption: the drain's second SIGTERM was not latched once "
             f"({p})")
    if s["resumes"] != 1.0 or s["mismatched_leaves"]:
        fail(f"preemption: the resumed run differs from the uninterrupted "
             f"one in {s['mismatched_leaves']} of {s['leaves']} leaves")
    return dict(exit_code=75, **{k: v for k, v in p.items()},
                resume_s=s["resume_s"], resumed_bit_equal=True,
                leaves=s["leaves"])


def rollback_phase() -> dict:
    """One GPU, ``elastic.run`` at a world of one with the guard
    (``loss_scale="dynamic"``): the batches of :data:`ROLLBACK_NAN` are
    NaN in replay epoch 0. Each of those steps must be BAD and leave the
    parameters and the inner optimizer state bit-identical; the third
    rolls back to committed step 3, the replay (epoch 1, fresh batches)
    finishes finite, ``numerics_rollbacks`` 1, health HEALTHY."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.observability import metrics
    from horovod_tpu_torch.resilience import elastic, health, numerics

    metrics.reset()
    health.reset()
    numerics.reset()
    model = build_model("resnet50", 0, hvd.device())
    tx0 = make_tx("zero1", loss_scale="dynamic")
    state = p19_state(model, tx0.init(model.jax_params()))
    log, frozen, rolled = [], [], []

    def poison(i, epoch):
        return epoch == 0 and i in ROLLBACK_NAN

    inner = p19_builder(model, loss_scale="dynamic", poison=poison, log=log)

    def builder(world):
        fn = inner(world)

        def step_fn(st, i):
            if not poison(i, numerics.replay_epoch()):
                return fn(st, i)
            p19_load(model, st)
            before = _clone({"params": model.jax_params(),
                             "inner": st["opt_state"].inner})
            out = fn(st, i)
            frozen.append((i, numerics.verdict(out["opt_state"])["last_bad"],
                           len(_tree_mismatch(before, {
                               "params": model.jax_params(),
                               "inner": out["opt_state"].inner}))))
            return out

        return step_fn

    rollback = elastic.ElasticRun._numerics_rollback

    def recorded(self, nr):
        rolled.append((nr.step, nr.streak, self._committed_step))
        return rollback(self, nr)

    elastic.ElasticRun._numerics_rollback = recorded
    try:
        final = elastic.run(builder, state, num_steps=ROLLBACK_STEPS,
                            snapshot_every=1)
    finally:
        elastic.ElasticRun._numerics_rollback = rollback
    torch.cuda.synchronize()
    if frozen != [(i, True, 0) for i in ROLLBACK_NAN]:
        fail(f"rollback: the NaN steps (step, BAD, leaves changed) {frozen}")
    last = ROLLBACK_NAN[-1]
    if rolled != [(last, len(ROLLBACK_NAN), ROLLBACK_NAN[0])]:
        fail(f"rollback: (step, streak, committed step) {rolled}")
    replay = [(i, e) for _, i, e, _, _ in log if e == 1]
    if replay != [(i, 1) for i in range(ROLLBACK_NAN[0], ROLLBACK_STEPS)]:
        fail(f"rollback: the replay ran {replay}")
    losses = [loss for _, _, e, _, loss in log if e == 1]
    if not all(math.isfinite(v) for v in losses) or not \
            numerics.tree_finite(final["params"]):
        fail(f"rollback: the replay is not finite ({losses})")
    v = numerics.verdict(final["opt_state"])
    if (metrics.value("numerics_rollbacks"), numerics.replay_epoch(),
            v["bad_streak"], health.health_state().name) != (
                1.0, 1, 0, "HEALTHY"):
        fail(f"rollback: rollbacks {metrics.value('numerics_rollbacks')}, "
             f"replay epoch {numerics.replay_epoch()}, verdict {v}, health "
             f"{health.health_state().name}")
    return dict(bad_steps=[i for i, _, _ in frozen], skipped_bit_equal=True,
                rolled_back=dict(at=rolled[0][0], to=rolled[0][2]),
                replayed=[i for i, _ in replay],
                rollback_steps=metrics.value("numerics_rollback_steps"),
                numerics_rollbacks=1, replay_losses=losses,
                loss_scale=v["loss_scale"], bad_count=v["bad_count"],
                health="HEALTHY")


def retry_phase() -> dict:
    """One eager ``allreduce`` under ``HOROVOD_CHAOS=collective_fail=1``:
    bit-equal to the clean call, ``resilience_retries`` 1."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.observability import metrics
    from horovod_tpu_torch.resilience import chaos

    metrics.reset()
    gen = torch.Generator(device=hvd.device()).manual_seed(19)
    x = torch.randn(1 << 22, device=hvd.device(), generator=gen)
    clean = hvd.allreduce(x, op=hvd.Average)
    chaos.configure("collective_fail=1")
    try:
        t0 = time.perf_counter()
        got = hvd.allreduce(x, op=hvd.Average)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        chaos.reset()
    retries = metrics.value("resilience_retries", scope="collective_dispatch")
    if not same_bits(got, clean) or retries != 1.0:
        fail(f"retry: bit-equal {same_bits(got, clean)}, retries {retries}")
    return dict(elements=x.numel(), retries=1, bit_equal=True,
                retried_call_s=dt)


def resilience_phase(preemption=preemption_phase) -> dict:
    """Phase 19 on one GPU: :func:`preemption_phase` (child processes;
    ``preemption`` gives its record), then in a world of one
    :func:`rollback_phase` and :func:`retry_phase`."""
    import torch

    import horovod_tpu_torch as hvd

    t0 = time.perf_counter()
    out = {"preemption": preemption()}
    hvd.init()
    try:
        out["rollback"] = rollback_phase()
        torch.cuda.empty_cache()
        out["retry"] = retry_phase()
    finally:
        hvd.shutdown()
    out["seconds"] = time.perf_counter() - t0
    return out


def _by_hand(base, ranks, tag: str) -> bool:
    """Re-form this rank's world by hand over base-world ``ranks`` under
    ``tag`` on the base store (the reference of the elastic run); a rank
    outside waits for ``tag``'s done key. True when this rank is in."""
    import datetime

    import torch.distributed as dist

    import horovod_tpu_torch as hvd

    me = _P19["rank"]
    if hvd.is_initialized():
        hvd.shutdown()
    if me not in ranks:
        base.wait([tag + "done"], datetime.timedelta(seconds=600))
        return False
    hvd.init(device=_P19["device"], rank=list(ranks).index(me),
             size=len(ranks), store=dist.PrefixStore(tag, base))
    return True


_P19: dict = {}


def _state_sha(model, state) -> str:
    import torch

    h = hashlib.sha256()
    for part in (model.jax_params(), model.jax_batch_stats()):
        for k in sorted(part):
            h.update(part[k].detach().reshape(-1).view(torch.uint8)
                     .cpu().numpy().tobytes())
    return h.hexdigest()


def _elastic_rank() -> dict:
    """One rank of phase 19 across the GPUs (deterministic kernels):
    ResNet-50 ZeRO-1 + int8 + EF + fused Adam under ``elastic.run`` and
    :data:`ELASTIC_SPEC`, 4 -> 3 -> 4, every kernel-wrapper call logged and
    the launches counted; then the same schedule driven by hand (a fresh
    world of 4 for steps 0-3, one of ranks 0-2 restored from the snapshot
    with ``consolidate_opt_state(to_size=3)`` for 3-6, 4 again for 6-9);
    then a run whose world falls below ``min_workers``."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import basics, checkpoint as ck
    from horovod_tpu_torch.observability import metrics
    from horovod_tpu_torch.ops import kernels as K
    from horovod_tpu_torch.resilience import chaos, elastic
    from horovod_tpu_torch.training import host_snapshot

    _p19_setup()
    base = basics._state.store
    _P19.update(rank=hvd.rank(), device=hvd.device())
    n = hvd.size()
    dev = hvd.device()
    metrics.reset()
    model = build_model("resnet50", 0, dev)
    state = p19_state(model, make_tx("zero1").init(model.jax_params()))
    log, calls, worlds = [], [], []
    costs: dict = {}
    inner = p19_builder(model, log=log)

    def builder(world):
        fn = inner(world)

        def step_fn(st, i):
            calls.append([])
            worlds.append(hvd.size())
            return fn(st, i)

        return step_fn

    from horovod_tpu_torch import training

    depth: dict = {}

    def timed(name, f, keyed=False):
        def call(*a):           # the outermost call of a recursive one
            depth[name] = depth.get(name, 0) + 1
            t0 = time.perf_counter()
            try:
                return f(*a)
            finally:
                dt = time.perf_counter() - t0
                depth[name] -= 1
                if not depth[name]:
                    costs.setdefault(name, []).append(
                        (a[1], dt) if keyed else dt)
        return call

    # the commit (its all-gather, its host copy), the boundary (keyed by
    # step), the resize (its re-formation, the snapshot's broadcast and
    # the reshard)
    targets = [(elastic.ElasticRun, "_commit", "commit"),
               (elastic.ElasticRun, "_poll_membership", "boundary"),
               (elastic.ElasticRun, "_resize", "resize"),
               (elastic.ElasticRun, "_form", "form"),
               (ck, "broadcast_host_tree", "broadcast"),
               (elastic, "_default_reshard", "reshard"),
               (ck, "_gather_sharded", "gather"),
               (training, "host_snapshot", "host_copy")]
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in targets]
    for (obj, attr, name), (_, _, f) in zip(targets, saved):
        setattr(obj, attr, timed(name, f, keyed=name == "boundary"))
    chaos.configure(ELASTIC_SPEC)
    K.reset_launches()                  # count the main path's run only
    try:
        with logging_calls(calls):
            final = elastic.run(builder, state, num_steps=ELASTIC_STEPS,
                                snapshot_every=1)
    finally:
        for obj, attr, f in saved:
            setattr(obj, attr, f)
        chaos.reset()
    launches = dict(K.launches)
    for k in K.KERNELS:
        logged = sum(sig[0] == k for c in calls for sig in c)
        if logged != launches[k]:
            fail(f"elastic: {launches[k]} launches of {k} but {logged} "
                 "logged calls")
    out = dict(rank=_P19["rank"], size=hvd.size(), log=log,
               launches=launches, costs=costs,
               sha=_state_sha(model, final),
               three=[c for c, w in zip(calls, worlds) if w == n - 1],
               metrics=dict(
                   generation=metrics.value("resilience_elastic_generation"),
                   shrink=metrics.value("resilience_elastic_membership_changes",
                                        kind="shrink"),
                   grow=metrics.value("resilience_elastic_membership_changes",
                                      kind="grow"),
                   rank_lost=metrics.value("resilience_rank_lost"),
                   resizes=(metrics.value("resilience_elastic_resize_seconds")
                            or {}).get("count")))
    del final, state
    torch.cuda.empty_cache()

    # the hand-driven reference
    def restore_into(snap, size):
        st = dict(snap)
        st["opt_state"] = ck.consolidate_opt_state(
            st["opt_state"], st["params"], to_size=size)
        p19_load(model, ck._tensors({"params": st["params"],
                                     "batch_stats": st["batch_stats"]}, dev))
        return p19_state(model, st["opt_state"])

    model = build_model("resnet50", 0, dev)
    _by_hand(base, range(n), "p19ref1/")
    fn = p19_builder(model)(n)
    st = p19_state(model, make_tx("zero1").init(model.jax_params()))
    for i in range(ELASTIC_FAIL):
        st = fn(st, i)
    snap = host_snapshot(ck._gather_sharded(st))
    if _by_hand(base, range(n - 1), "p19ref2/"):
        st = restore_into(snap, n - 1)
        fn = p19_builder(model)(n - 1)
        for i in range(ELASTIC_FAIL, ELASTIC_JOIN):
            st = fn(st, i)
        snap = host_snapshot(ck._gather_sharded(st))
        if hvd.rank() == 0:
            base.set("p19ref2/done", "1")
    _by_hand(base, range(n), "p19ref3/")
    snap = ck.broadcast_host_tree(snap if hvd.rank() == 0 else None)
    st = restore_into(snap, n)
    fn = p19_builder(model)(n)
    for i in range(ELASTIC_JOIN, ELASTIC_STEPS):
        st = fn(st, i)
    out["reference_sha"] = _state_sha(model, st)
    del st, snap
    torch.cuda.empty_cache()

    # below min_workers: the emergency checkpoint of the committed step
    _by_hand(base, range(n), "p19small/")
    directory = os.path.join(CKPT_DIR, "too_small")
    model = build_model("resnet50", 0, dev)
    state = p19_state(model, make_tx("zero1").init(model.jax_params()))
    chaos.configure(TOO_SMALL_SPEC)
    try:
        elastic.run(p19_builder(model), state, num_steps=TOO_SMALL_AT + 2,
                    min_workers=n, checkpoint_dir=directory)
        out["too_small"] = None
    except elastic.WorldTooSmall as e:
        out["too_small"] = dict(alive=e.alive, min_workers=e.min_workers,
                                step=e.step)
        if _P19["rank"] == 0:
            out["too_small"].update(
                latest_step=ck.latest_step(directory),
                valid=ck.is_valid_checkpoint(
                    os.path.join(directory, f"step_{TOO_SMALL_AT}")))
    finally:
        chaos.reset()
    return out


def _segment_img_s(log: list, world: int, first: int, last: int) -> float:
    """img/s per GPU over the steps ``[first, last)`` at ``world``, the
    first of them (new communicators, after the resize) left out."""
    times = [s for w, i, e, s, _ in log if w == world and first < i < last]
    return P19_BATCH * len(times) / sum(times)


def elastic_gpus(n: int) -> tuple:
    """Phase 19 across ``n`` GPUs (:func:`_elastic_rank` on each): every
    rank's elastic parameters bit-equal to the hand-driven reference and
    to every other rank's, rank 0's metrics (generation 3, one shrink,
    one grow, one rank lost, two resizes), ZeRO-1's kernels launched at
    the three-rank shapes exactly as :func:`expected_launches` says, and
    the world too small raising on every rank after rank 0 wrote a valid
    checkpoint of the committed step. Returns ``(record, rank 0's run
    for the kernels line, the three-rank step's calls)``."""
    import shutil

    from horovod_tpu_torch.ops import kernels as K
    from horovod_tpu_torch.testing import run_world

    env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    t0 = time.perf_counter()
    try:
        res = run_world(_elastic_rank, n, device=None, timeout=900)
    except RuntimeError as e:
        fail(f"elastic across {n} GPUs: {e}")
    finally:
        shutil.rmtree(os.path.join(CKPT_DIR, "too_small"),
                      ignore_errors=True)
        if env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = env
    seconds = time.perf_counter() - t0
    r0 = res[0]
    for out in res:
        if out["sha"] != r0["sha"] or out["sha"] != out["reference_sha"]:
            fail(f"elastic: rank {out['rank']}'s parameters and running "
                 f"stats differ from rank 0's or from the hand-driven "
                 f"reference ({out['sha'][:12]}, {r0['sha'][:12]}, "
                 f"{out['reference_sha'][:12]})")
        if out["size"] != n:
            fail(f"elastic: rank {out['rank']} ended in a world of "
                 f"{out['size']}")
        small = out["too_small"]
        if small is None or (small["alive"], small["min_workers"],
                             small["step"]) != (n - 1, n, TOO_SMALL_AT):
            fail(f"elastic: below min_workers, rank {out['rank']}: {small}")
    if (r0["too_small"]["latest_step"], r0["too_small"]["valid"]) != (
            TOO_SMALL_AT, True):
        fail(f"elastic: the emergency checkpoint below min_workers "
             f"{r0['too_small']}")
    m = r0["metrics"]
    if (m["generation"], m["shrink"], m["grow"], m["rank_lost"],
            m["resizes"]) != (3.0, 1.0, 1.0, 1.0, 2):
        fail(f"elastic: rank 0's metrics {m}")
    want = expected_launches("zero1", n - 1, 161)
    steps3 = r0["three"]
    if len(steps3) != ELASTIC_JOIN - ELASTIC_FAIL:
        fail(f"elastic: {len(steps3)} steps at {n - 1} ranks")
    for c in steps3:
        got = {k: sum(s[0] == k for s in c) for k in want}
        if got != want:
            fail(f"elastic: launches a step at {n - 1} ranks {got}, "
                 f"expected {want}")
    for k in NEED["zero1"]:
        if r0["launches"][k] < 1:
            fail(f"elastic: kernel {k} was not launched")
    log = r0["log"]
    worlds = [(n, 0, ELASTIC_FAIL), (n - 1, ELASTIC_FAIL, ELASTIC_JOIN),
              (n, ELASTIC_JOIN, ELASTIC_STEPS)]
    first = {f"{w}@{a}": next(s for ww, i, e, s, _ in log
                             if ww == w and i == a) for w, a, _ in worlds}
    c = r0["costs"]
    # a step's boundary on the rank that reached it last: its own cost
    # (the others' readings add their wait for that rank)
    by_step: dict = {}
    for out in res:
        for step, dt in out["costs"]["boundary"]:
            by_step.setdefault(step, []).append(dt)
    last_in = [min(v) for v in by_step.values()]

    def ms(xs):
        return 1e3 * sum(xs) / len(xs)

    record = dict(
        seconds=seconds, resize_s=c["resize"],
        resize_parts_s={k: c.get(k, []) for k in ("form", "broadcast",
                                                   "reshard")},
        first_step_s=first,
        img_per_s_per_gpu={f"{w}@{a}-{b}": _segment_img_s(log, w, a, b)
                           for w, a, b in worlds},
        commit_ms_per_step=ms(c["commit"][1:]),
        commit_parts_ms_per_step=dict(gather=ms(c["gather"][1:]),
                                      host_copy=ms(c["host_copy"][1:])),
        commit_ms_per_step_by_rank={
            f"rank{out['rank']}": ms(out["costs"]["commit"][1:])
            for out in res},
        boundary_ms_per_step=ms(last_in),
        boundary_ms_per_step_by_rank={
            f"rank{out['rank']}": ms([dt for _, dt in
                                      out["costs"]["boundary"]])
            for out in res},
        losses=[loss for _, _, _, _, loss in log],
        metrics=m, bit_equal_to_reference=True, ranks_agree=True,
        too_small=r0["too_small"],
        launches_at_three_a_step=want)
    run = dict(mode=f"elastic@{n}", launches=r0["launches"])
    return record, run, steps3[-1]

# --------------------------------------------------------------------------
# phase 20: observability and analysis on the main path

#: one GPU: steps of the plain and of the instrumented ZeRO-1 run, and the
#: last steps of the instrumented run that torch.profiler traces
OBS_STEPS = 8
OBS_TRACED = 2
#: the hand-written kernels of ZeRO-1's path, and the symbol each has in a
#: torch.profiler trace
OBS_KERNELS = {"quantize": "quantize_kernel",
               "dequant_accumulate": "deq_acc_kernel",
               "fused_adam": "adam_kernel"}
#: the trace category of a kernel launched on the card
OBS_TRACE_CAT = "kernel"
#: across the GPUs: the hang drill's steps, the step whose second eager
#: collective the highest rank holds before dispatching, how long it holds
#: (s), and the watchdog's timeout (s): above every gap between two
#: collectives of a healthy run (the commit's host copy, a resize)
HANG_STEPS = 6
HANG_AT = 3
HANG_HOLD = 16.0
HANG_TIMEOUT = 6.0
#: the corrupt-rank drill: its steps, the rank whose published gradient
#: fingerprint is made non-finite and from which step
CORRUPT_STEPS = 5
CORRUPT_RANK, CORRUPT_AT = 2, 2
#: seconds a metrics snapshot lives in the KV (a rank that stops
#: publishing is dead to the aggregator after it)
OBS_SNAP_TTL = 3.0


def _obs_env(directory: str) -> dict:
    """Every plane of phase 20 on: the host timeline, the flight sidecar,
    the schedule sanitizer, the gradient fingerprints."""
    return {"HOROVOD_TIMELINE": os.path.join(directory, "timeline.json"),
            "HOROVOD_FLIGHT_DIR": os.path.join(directory, "flight"),
            "HOROVOD_SANITIZE": "1",
            "HOROVOD_NUMERICS_FINGERPRINT": "1"}


def observe_child(directory: str, role: str) -> None:
    """Phase 20 on one GPU, in a child process (phase 10's determinism):
    phase 4's ResNet-50 ZeRO-1 + int8 + EF + fused Adam, batch 64,
    :data:`OBS_STEPS` steps on one batch. ``plain``: the step as built.
    ``instrumented``: through ``instrument_step`` with the parent's env
    (:func:`_obs_env`) on, a metrics publisher and a fleet aggregator
    over an HTTP KV store, and ``profiler.timeline`` around the last
    :data:`OBS_TRACED` steps; after ``shutdown`` (which merges the
    timeline and flushes the flight ring) the files are read back. Prints
    one JSON record."""
    import horovod_tpu_torch as hvd

    _p19_setup()
    hvd.init()
    try:
        out = _observe_role(directory, role)
    finally:
        hvd.shutdown()
    if role == "instrumented":
        out.update(_observe_files(directory))
    print(json.dumps(out), flush=True)


def _observe_role(directory: str, role: str) -> dict:
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import profiler
    from horovod_tpu_torch.observability import aggregate, exporters, metrics
    from horovod_tpu_torch.ops import kernels as K
    from horovod_tpu_torch.run.rendezvous import KVStoreClient, KVStoreServer
    from horovod_tpu_torch.training import instrument_step

    inst = role == "instrumented"
    dev = hvd.device()
    model = build_model("resnet50", 0, dev)
    tx = make_tx("zero1")
    opt = tx.init(model.jax_params())
    step = hvd.make_train_step(model, tx, shard_optimizer=True)
    x, y = p19_batch(0)
    server = pub = agg = None
    if inst:
        server = KVStoreServer()
        kv = KVStoreClient("127.0.0.1", server.start())
        pub = aggregate.MetricsPublisher(kv, rank=0, ttl=OBS_SNAP_TTL)
        agg = aggregate.FleetAggregator(kv, world=1)
        # ResNet-50 at 224x224: 4.1 GFLOP a forward image, x3 a step
        step = instrument_step(step, batch_arg=1,
                               flops_per_step=3 * 4.1e9 * x.shape[0])
    per_step, times, losses = [], [], []
    K.reset_launches()
    try:
        for i in range(OBS_STEPS):
            if inst and i == OBS_STEPS - OBS_TRACED:
                profiler.start_timeline(os.path.join(directory, "prof"))
            before = dict(K.launches)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            opt, loss = step(opt, x, y)
            losses.append(float(loss))
            times.append(time.perf_counter() - t0)
            per_step.append({k: K.launches[k] - before[k]
                             for k in OBS_KERNELS})
            if inst:
                pub.publish_once()
        if inst:
            profiler.stop_timeline()
            fleet = agg.collect()
    finally:
        if server is not None:
            server.close()
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        fail(f"phase 20 ({role}): losses {losses}")
    measured = times[1:OBS_STEPS - OBS_TRACED]
    out = dict(role=role, sha=_state_sha(model, None), losses=losses,
               launches_per_step=per_step,
               ms_per_step=1e3 * sum(measured) / len(measured),
               median_ms_per_step=1e3 * sorted(measured)[len(measured) // 2],
               step_ms=[1e3 * t for t in times])
    if inst:
        text = exporters.to_prometheus()
        out.update(fleet_ranks=fleet["ranks"], dead_ranks=fleet["dead_ranks"],
                   prometheus_lines=_parse_prometheus(text),
                   train_steps=metrics.value("train_steps"),
                   mfu=metrics.value("train_mfu"),
                   grad_sync_bytes=metrics.value("grad_sync_bytes_per_step",
                                                 mode="sharded"))
    return out


def _parse_prometheus(text: str) -> int:
    """The number of samples in a Prometheus text exposition; fails on a
    line that is neither a comment nor ``name{labels} value``."""
    import re

    sample = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{([a-zA-Z_][a-zA-Z0-9_]*'
                        r'="(\\.|[^"\\])*",?)*\})? [-+0-9.eEinfINFNa]+$')
    n = 0
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        if not sample.match(line):
            fail(f"phase 20: Prometheus line does not parse: {line!r}")
        n += 1
    if not n:
        fail("phase 20: empty Prometheus exposition")
    return n


def _observe_files(directory: str) -> dict:
    """The instrumented run's files: the merged timeline (Chrome-trace
    JSON, one ``step`` span a step), the flight sidecar with a torn line
    appended (as a kill mid-write leaves it) through ``flight.load_dir``
    and ``analyze_dir``, and the profiler trace's kernels by symbol."""
    from horovod_tpu_torch.observability import flight

    env = _obs_env(directory)
    with open(env["HOROVOD_TIMELINE"]) as f:
        events = json.load(f)
    spans = [e for e in events if e.get("tid") == "step" and e.get("ph") == "X"]
    sidecar = os.path.join(env["HOROVOD_FLIGHT_DIR"], "flight-rank0.jsonl")
    with open(sidecar, "a") as f:
        f.write('{"t": 1.0, "kind": "collec')
    rank_events, meta = flight.load_dir(env["HOROVOD_FLIGHT_DIR"])
    verdict = flight.analyze_dir(env["HOROVOD_FLIGHT_DIR"])
    evs = rank_events.get(0, [])
    with open(os.path.join(directory, "prof", "trace.json")) as f:
        prof = json.load(f)
    names = [e.get("name", "") for e in prof.get("traceEvents", [])
             if e.get("cat") == OBS_TRACE_CAT]
    return dict(
        timeline_events=len(events), step_spans=len(spans),
        flight_events=len(evs),
        flight_steps=sum(e.get("kind") == "step" for e in evs),
        flight_collectives=sum(e.get("kind") == "collective" for e in evs),
        flight_verdict=verdict.get("verdict"),
        profiler_kernels={k: sum(sym in n for n in names)
                          for k, sym in OBS_KERNELS.items()})


def observability_phase(gpu=None) -> dict:
    """Phase 20 on one GPU: :func:`observe_child` plain, then
    instrumented. The parameters and running stats after the last step
    must be bit-equal; B1, B3 and B5 must launch once a step in both; the
    timeline must hold one step span a step, the flight sidecar load with
    its torn tail and be analyzed, the Prometheus exposition parse, the
    aggregator see one live rank, and the profiler trace name each
    kernel's symbol. The children run on card ``gpu`` alone, when
    given."""
    import shutil

    directory = os.path.join(CKPT_DIR, "observe")
    shutil.rmtree(directory, ignore_errors=True)
    os.makedirs(directory)
    base = child_env(gpu, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    for k in list(_obs_env(directory)) + ["HOROVOD_CHAOS"]:
        base.pop(k, None)
    out = {}
    t0 = time.perf_counter()
    try:
        for role in ("plain", "instrumented"):
            env = dict(base, **(_obs_env(directory)
                                if role == "instrumented" else {}))
            r = subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--observe", directory, role],
                               capture_output=True, text=True, timeout=600,
                               env=env)
            if r.returncode != 0:
                fail(f"phase 20 ({role}): exit code {r.returncode}:\n"
                     f"{r.stderr[-3000:]}")
            out[role] = json.loads(r.stdout.strip().splitlines()[-1])
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    plain, inst = out["plain"], out["instrumented"]
    if plain["sha"] != inst["sha"] or plain["losses"] != inst["losses"]:
        fail(f"phase 20: the instrumented run is not bit-equal to the plain "
             f"one (losses {plain['losses']} vs {inst['losses']})")
    for run in (plain, inst):
        for i, c in enumerate(run["launches_per_step"]):
            if any(v != 1 for v in c.values()):
                fail(f"phase 20 ({run['role']}): step {i} launched {c}, "
                     "expected each of B1, B3, B5 once")
    if inst["step_spans"] != OBS_STEPS:
        fail(f"phase 20: {inst['step_spans']} step spans in the timeline, "
             f"expected {OBS_STEPS}")
    if inst["flight_steps"] != OBS_STEPS or not inst["flight_collectives"]:
        fail(f"phase 20: flight sidecar {inst['flight_steps']} step events, "
             f"{inst['flight_collectives']} collective events")
    if inst["flight_verdict"] not in ("progressing", "no_data"):
        fail(f"phase 20: a healthy run's flight verdict is "
             f"{inst['flight_verdict']}")
    if inst["fleet_ranks"] != [0] or inst["dead_ranks"]:
        fail(f"phase 20: the aggregator saw {inst['fleet_ranks']} live, "
             f"{inst['dead_ranks']} dead")
    if inst["train_steps"] != OBS_STEPS:
        fail(f"phase 20: train_steps {inst['train_steps']}")
    missing = [k for k, v in inst["profiler_kernels"].items() if v < 1]
    if missing:
        fail(f"phase 20: the torch.profiler trace names no kernel of "
             f"{missing} ({inst['profiler_kernels']})")
    return dict(seconds=time.perf_counter() - t0,
                plain_ms_per_step=plain["ms_per_step"],
                instrumented_ms_per_step=inst["ms_per_step"],
                plain_median_ms_per_step=plain["median_ms_per_step"],
                instrumented_median_ms_per_step=inst["median_ms_per_step"],
                plain_step_ms=plain["step_ms"],
                instrumented_step_ms=inst["step_ms"],
                bit_equal=True, launches_per_step=inst["launches_per_step"][0],
                launches={k: sum(c[k] for c in inst["launches_per_step"])
                          for k in OBS_KERNELS},
                **{k: inst[k] for k in (
                    "step_spans", "timeline_events", "flight_events",
                    "flight_verdict", "prometheus_lines", "profiler_kernels",
                    "mfu", "grad_sync_bytes")})


def _drill_rank(drill: str) -> dict:
    """One rank of a phase-20 drill across the GPUs: ResNet-50 ZeRO-1 +
    int8 + EF + fused Adam under ``elastic.run`` (committed once, at the
    start), each step through ``instrument_step`` and followed by one
    more eager collective (the slowest rank's step time, ``Max``), every
    plane on (the parent's env), a metrics publisher a rank and rank 0's
    fleet aggregator over the world's KV store. ``hang``: the highest
    rank holds :data:`HANG_HOLD` s before its second collective of step
    :data:`HANG_AT`; ``corrupt``: rank :data:`CORRUPT_RANK` publishes a
    non-finite fingerprint from step :data:`CORRUPT_AT`. Rank 0 stamps
    the onset (its own begin of the parked collective, or its own
    fingerprint publication of the corrupt step), the verdict
    (``health.record_hang`` / ``record_numeric_corruption``, where it
    also reads ``publish_gate_reason``) and the eviction
    (``mark_dead``)."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.analysis import sanitizer
    from horovod_tpu_torch.observability import aggregate, flight, metrics
    from horovod_tpu_torch.ops import kernels as K
    from horovod_tpu_torch.resilience import chaos, elastic, health, numerics
    from horovod_tpu_torch.run import rendezvous
    from horovod_tpu_torch.training import instrument_step

    _p19_setup()
    me, n = hvd.rank(), hvd.size()
    dev = hvd.device()
    metrics.reset()
    chaos.reset()
    if drill == "hang" and me == n - 1:
        chaos.configure(f"rank_hang_at_step={HANG_AT},"
                        f"rank_hang_hold={HANG_HOLD}")
    elif drill == "corrupt":
        chaos.configure(f"grad_corrupt_rank={CORRUPT_RANK}:{CORRUPT_AT}")
    kv = rendezvous.kv_client_from_env()
    pub = aggregate.MetricsPublisher(kv, rank=me, ttl=OBS_SNAP_TTL)
    agg = aggregate.FleetAggregator(kv, world=n) if me == 0 else None
    stamps, seen, calls, gates = {}, [], [], []
    steps = HANG_STEPS if drill == "hang" else CORRUPT_STEPS
    model = build_model("resnet50", 0, dev)
    state = p19_state(model, make_tx("zero1").init(model.jax_params()))

    def builder(world):
        fn = instrument_step(p19_builder(model)(world))

        def step_fn(st, i):
            calls.append(dict(K.launches))
            t0 = time.perf_counter()
            st = fn(st, i)
            dt = torch.full((1,), time.perf_counter() - t0, device=dev)
            hvd.allreduce(dt, op=hvd.Max).item()
            pub.publish_once()
            if agg is not None:
                fleet = agg.collect()
                seen.append((hvd.size(), len(fleet["ranks"])))
            return st

        return step_fn

    saved = []
    if me == 0:
        def stamp(obj, attr, name, also=None):
            f = getattr(obj, attr)
            saved.append((obj, attr, f))

            def call(*a, **kw):
                stamps.setdefault(name, time.monotonic())
                if also is not None:
                    also()
                return f(*a, **kw)
            setattr(obj, attr, call)

        stamp(health, "record_hang", "verdict")
        stamp(health, "record_numeric_corruption", "verdict",
              lambda: gates.append(numerics.publish_gate_reason(None, {})))
        stamp(elastic.ElasticCoordinator, "mark_dead", "evicted")
        publish = numerics.publish_fingerprint

        def stamped_publish(step, *a, **kw):
            if step == CORRUPT_AT:
                stamps.setdefault("onset", time.monotonic())
            return publish(step, *a, **kw)
        saved.append((numerics, "publish_fingerprint", publish))
        numerics.publish_fingerprint = stamped_publish
    K.reset_launches()
    t0 = time.perf_counter()
    try:
        final = elastic.run(builder, state, num_steps=steps,
                            snapshot_every=steps + 1)
    finally:
        for obj, attr, f in saved:
            setattr(obj, attr, f)
        chaos.reset()
    out = dict(rank=me, final=final is not None,
               size=hvd.size() if hvd.is_initialized() else 0,
               seconds=time.perf_counter() - t0,
               launches=dict(K.launches), steps_run=len(calls),
               diagnoses=[(e.get("verdict"), e.get("key"), e.get("hung_ranks"))
                          for e in flight.events() if e.get("kind") == "hang"
                          and e.get("ph") == "diagnosed"])
    if me == 0:
        flight.disarm_watchdog()    # the run is over: no more progress
        if drill == "hang":
            hang = flight.last_hang() or {}
            key = hang.get("key")
            parked = [e["t"] for e in flight.events()
                      if e.get("kind") == "collective" and e.get("ph") == "b"
                      and key and [e["step"], e["gen"], e["seq"]] == key]
            if parked:
                stamps["onset"] = parked[0]
            out["verdict"] = {k: hang.get(k) for k in (
                "verdict", "key", "op", "hung_ranks", "waiting")}
        else:
            c = numerics.last_corruption()
            out["verdict"] = c and {"rank": c["rank"], "step": c["step"],
                                    "finite": c["finite"]}
            out["gate"] = gates[0] if gates else None
        t_end = time.monotonic() + OBS_SNAP_TTL + 2.0
        while seen and seen[-1][1] != hvd.size() and time.monotonic() < t_end:
            time.sleep(0.25)
            seen.append((hvd.size(), len(agg.collect()["ranks"])))
        out.update(
            stamps=stamps, fleet_seen=seen,
            divergence=sanitizer.last_divergence(),
            sched_checked=metrics.value("sanitizer_steps_checked"),
            hang_fired=metrics.value("hang_watchdog_fired"))
    return out


def _drill_gpus(n: int, drill: str) -> tuple:
    """Run :func:`_drill_rank` across ``n`` GPUs with every plane on;
    returns ``(the ranks' records, seconds)``."""
    import shutil

    from horovod_tpu_torch.observability import flight
    from horovod_tpu_torch.testing import run_world

    directory = os.path.join(CKPT_DIR, f"drill_{drill}")
    shutil.rmtree(directory, ignore_errors=True)
    os.makedirs(directory)
    env = dict(_obs_env(directory), CUBLAS_WORKSPACE_CONFIG=":4096:8",
               HOROVOD_HANG_TIMEOUT=str(HANG_TIMEOUT), HOROVOD_HANG_EVICT="1")
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    t0 = time.perf_counter()
    try:
        res = run_world(_drill_rank, n, drill, device=None, timeout=600)
        if drill == "hang":     # the sidecars alone, after the run
            offline = flight.analyze_dir(env["HOROVOD_FLIGHT_DIR"])
            res[0]["offline"] = {k: offline.get(k) for k in (
                "verdict", "key", "hung_ranks")}
    except RuntimeError as e:
        fail(f"phase 20 {drill} drill across {n} GPUs: {e}")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(directory, ignore_errors=True)
    return res, time.perf_counter() - t0


def drills_gpus(n: int) -> dict:
    """Phase 20 across ``n`` GPUs: the hang drill (the watchdog fires,
    rank 0's diagnosis names rank ``n - 1`` missing at the parked
    ``(step, gen, seq)``, the rank is evicted and the run finishes at
    ``n - 1`` ranks, the schedule hashes of every checked step agree, the
    aggregator sees ``n`` live ranks, then ``n - 1``), then the corrupt
    drill (the cross-check names :data:`CORRUPT_RANK`, whose quarantine
    ``publish_gate_reason`` reports, and it is evicted). Each drill's
    onset -> verdict and verdict -> eviction seconds on rank 0's clock."""
    out = {}
    for drill in ("hang", "corrupt"):
        res, seconds = _drill_gpus(n, drill)
        r0 = res[0]
        victim = n - 1 if drill == "hang" else CORRUPT_RANK
        v = r0["verdict"] or {}
        # a diagnosis that names no rank (a slow first step: every rank
        # "progressing") acts on nothing
        acting = [d for d in r0["diagnoses"]
                  if d[0] not in ("progressing", "no_data")]
        if drill == "hang":
            if not r0["hang_fired"]:
                fail("phase 20 hang: the watchdog never fired")
            if (v.get("verdict"), v.get("hung_ranks")) != ("rank_missing",
                                                           [victim]) or \
                    len(acting) != 1:
                fail(f"phase 20 hang: rank 0's verdict {v}, diagnoses "
                     f"{r0['diagnoses']}")
            if list(v.get("key") or [])[::2] != [HANG_AT, 1]:
                fail(f"phase 20 hang: parked at {v.get('key')}, expected "
                     f"step {HANG_AT}, seq 1")
            if r0["offline"].get("hung_ranks") != [victim]:
                fail(f"phase 20 hang: offline analysis {r0['offline']}")
        else:
            if v.get("rank") != victim or r0.get("gate") != "quarantine" \
                    or acting:
                fail(f"phase 20 corrupt: verdict {v}, publish gate "
                     f"{r0.get('gate')}")
        if r0["divergence"] is not None or not r0["sched_checked"]:
            fail(f"phase 20 {drill}: schedule divergence "
                 f"{r0['divergence']}, {r0['sched_checked']} steps checked")
        for r in res:
            evicted = r["rank"] == victim
            if r["final"] == evicted or (not evicted and r["size"] != n - 1):
                fail(f"phase 20 {drill}: rank {r['rank']} ended "
                     f"final={r['final']} in a world of {r['size']}")
            if not evicted and any(r["launches"][k] < 1 for k in NEED["zero1"]):
                fail(f"phase 20 {drill}: rank {r['rank']} launches "
                     f"{r['launches']}")
        seen = [live for size, live in r0["fleet_seen"]]
        if n not in seen or seen[-1] != n - 1:
            fail(f"phase 20 {drill}: the aggregator saw {r0['fleet_seen']}")
        s = r0["stamps"]
        if not {"onset", "verdict", "evicted"} <= set(s):
            fail(f"phase 20 {drill}: stamps {s}")
        out[drill] = dict(
            seconds=seconds, verdict=v, gate=r0.get("gate"),
            onset_to_verdict_s=s["verdict"] - s["onset"],
            verdict_to_eviction_s=s["evicted"] - s["verdict"],
            live_ranks_seen=seen, steps_checked=r0["sched_checked"],
            diagnoses=r0["diagnoses"], offline=r0.get("offline"))
    return out


# ---------------------------------------------------------------------------
# phase 21: serving — the weight handoff, the paged engine, the prefix
# cache, speculative decoding, rollout and the fleet, tensor parallelism

#: the handoff's training: steps, publication cadence and payload chunks
SERVE_STEPS, SERVE_EVERY = 8, 4
SERVE_CHUNK_BYTES = 8 << 20
#: the engine at full width: pages for 8 full sequences plus page 0
SERVE_ENGINE = dict(max_batch=8, page_size=16, prefill_chunk=256,
                    max_seq_len=2048, num_pages=8 * 128 + 1)
#: (b)'s traffic: requests, new tokens, the prompt lengths' range
SERVE_REQUESTS, SERVE_NEW, SERVE_PROMPT = 16, 64, (128, 1536)
#: (c): the shared prefix and each request's own tail
SERVE_PREFIX, SERVE_TAIL = 1024, 64
#: (d): the draft's blocks and the tokens it proposes a pass
SERVE_DRAFT, SERVE_LOOKAHEAD = 2, 4
#: (e): the fleet pump at which replica 1 is killed
SERVE_KILL_PUMP = 3
#: (f): the teacher-forced stream (rows, tokens), the TP traffic
TP_STREAM = (4, 512)
TP_REQUESTS, TP_NEW = 8, 32
#: (b), (d): the bar on the paged engine's logits against ``generate``'s
#: path teacher-forced on the same streams (and on the speculative
#: engine's against the plain engine's), max |Δ| over the reference's
#: largest magnitude; it caps the |Δ| that the near-tie token bar may
#: use. On the card the sound engine reads 0.0098 (Δ 0.0547 at 5.56), a
#: control 0.116 or more; three controls must fail it: one perturbed
#: weight (:data:`TP_CONTROL`), decoding one position late, decoding
#: against the neighbouring row's cache
SERVE_LOGIT_RTOL = 0.03
#: (f): the bar on the TP engine's teacher-forced logits, max |Δ| over
#: the one-GPU engine's largest magnitude, and the control, one weight
#: leaf 12.5 % off (``ln_f``'s scale times 1.125), which must fail it
TP_LOGIT_RTOL = 0.05
TP_CONTROL = ("ln_f/scale", 1.125)
#: the weights the four-GPU world loads, inside the checkout (git-ignored)
SERVE_DIR = os.path.join(ROOT, "_smoke_serve")


def _serve_load(model, params: dict) -> None:
    """The state's parameters into ``model`` unless they are its own."""
    import torch

    with torch.no_grad():
        for k, v in model.jax_params().items():
            if params[k].data_ptr() != v.data_ptr():
                v.copy_(params[k])


def _tree_bits_equal(a: dict, b: dict) -> bool:
    """Two flat trees (numpy or tensors) hold the same bits."""
    import numpy as np
    import torch

    if set(a) != set(b):
        return False
    for k in a:
        x, y = a[k], b[k]
        x = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x
        y = y.detach().cpu().numpy() if isinstance(y, torch.Tensor) else y
        if x.shape != y.shape or not np.array_equal(
                np.ascontiguousarray(x).view(np.uint8),
                np.ascontiguousarray(y).view(np.uint8)):
            return False
    return True


def serve_handoff(server, addr, roll_hook):
    """(a): :data:`SERVE_STEPS` steps of the flagship LM under
    ``ElasticRun(publisher=WeightPublisher(KVStoreClient over HTTP to
    server), publish_every=SERVE_EVERY)``; after each publication a
    ``WeightSubscriber`` over HTTP rebuilds it on the card, and
    ``roll_hook()`` runs (the rollout's poll). Gates: generation 1 a
    keyframe, 2 a delta; B1 launched once per quantizable leaf of the
    delta and never for the keyframe; B6 12 a step; the card's
    reconstruction bit-equal to the publisher's ``decode`` of its own
    payload. Returns the record, the subscriber (holding generation 2 on
    the card) and the delta's logged B1 calls."""
    import numpy as np
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.compression import Int8Compressor
    from horovod_tpu_torch.models import TransformerLM
    from horovod_tpu_torch.models.convert import flatten_tree
    from horovod_tpu_torch.ops import kernels as K
    from horovod_tpu_torch.resilience import elastic
    from horovod_tpu_torch.run.rendezvous import KVStoreClient
    from horovod_tpu_torch.serving import (
        WeightPublisher, WeightSubscriber, protocol,
    )

    dev = hvd.device()
    torch.backends.cuda.matmul.allow_tf32 = False
    model = TransformerLM(**LM, dtype=torch.bfloat16,
                          attention_fn=hvd.flash_attention, seed=0, device=dev)
    tok = np.random.RandomState(21).randint(
        0, LM["vocab"], (LM_BATCH, LM_SEQ)).astype(np.int64)
    x = torch.from_numpy(tok).to(dev)
    y = torch.from_numpy(np.roll(tok, -1, axis=1)).to(dev)
    tx = hvd.DistributedOptimizer(hvd.adamw(1e-4))
    step = hvd.make_train_step(model, tx, loss_fn=hvd.lm_xent)
    pub = WeightPublisher(KVStoreClient(*addr[:2], secret=addr[2]),
                          keyframe_every=8, chunk_bytes=SERVE_CHUNK_BYTES,
                          register=False, device=dev)
    sub = WeightSubscriber(KVStoreClient(*addr[:2], secret=addr[2]),
                           device=dev)
    quantizable = sum(Int8Compressor.quantizes(tuple(p.shape), p.dtype)
                      for p in model.jax_params().values())
    pubs, delta_calls, losses = [], [], []
    real_publish = pub.publish

    def publish(state, step_no, **kw):
        before = dict(K.launches)
        calls: list = [[]]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with logging_calls(calls):
            gen = real_publish(state, step_no, **kw)
        publish_s = time.perf_counter() - t0
        launched = {k: K.launches[k] - before[k] for k in K.KERNELS}
        m = json.loads(server.get(protocol.manifest_key("serving", gen)))
        t0 = time.perf_counter()
        fresh = sub.poll()
        torch.cuda.synchronize()
        apply_s = time.perf_counter() - t0
        if fresh is None or sub.generation != gen:
            fail(f"phase 21 (a): the subscriber did not apply generation "
                 f"{gen} (serving {sub.generation})")
        if not _tree_bits_equal(flatten_tree(fresh),
                                flatten_tree(pub.reconstruction())):
            fail(f"phase 21 (a): generation {gen} rebuilt on the card is not "
                 "bit-equal to the publisher's decode of its payload")
        want_q = quantizable if m["kind"] == "delta" else 0
        if launched["quantize"] != want_q or len(calls[0]) != want_q:
            fail(f"phase 21 (a): generation {gen} ({m['kind']}) launched "
                 f"quantize {launched['quantize']} times ({len(calls[0])} "
                 f"logged), expected {want_q}")
        if m["kind"] == "delta":
            delta_calls.extend(calls[0])
        pubs.append(dict(generation=gen, kind=m["kind"], step=step_no,
                         publish_s=publish_s, wire_bytes=m["wire_bytes"],
                         payload_bytes=m["payload_bytes"],
                         chunks=m["chunks"], apply_s=apply_s,
                         quantize_launches=launched["quantize"],
                         bit_equal=True))
        roll_hook()
        return gen

    pub.publish = publish

    def builder(world):
        def step_fn(state, i):
            _serve_load(model, state["params"])
            opt, loss = step(state["opt_state"], x, y)
            losses.append(float(loss))
            return {"params": model.jax_params(), "opt_state": opt}
        return step_fn

    state = {"params": model.jax_params(),
             "opt_state": tx.init(model.jax_params())}
    K.reset_launches()
    t0 = time.perf_counter()
    elastic.run(builder, state, num_steps=SERVE_STEPS,
                snapshot_every=SERVE_EVERY, publisher=pub,
                publish_every=SERVE_EVERY)
    train_s = time.perf_counter() - t0
    launches = dict(K.launches)
    if [(p["generation"], p["kind"]) for p in pubs] != [(1, "key"),
                                                        (2, "delta")]:
        fail(f"phase 21 (a): publications {pubs}")
    if launches["flash_fwd"] != LM["depth"] * SERVE_STEPS:
        fail(f"phase 21 (a): {launches['flash_fwd']} flash_fwd launches in "
             f"{SERVE_STEPS} steps of a depth-{LM['depth']} model")
    if not all(math.isfinite(v) for v in losses) or losses[-1] >= losses[0]:
        fail(f"phase 21 (a): losses {losses}")
    del model, state, step, tx
    torch.cuda.empty_cache()
    rec = dict(steps=SERVE_STEPS, losses=losses, train_s=train_s,
               publications=pubs, quantizable_leaves=quantizable,
               flash_fwd_launches=launches["flash_fwd"],
               chunk_bytes=SERVE_CHUNK_BYTES)
    return rec, sub, delta_calls


#: the engine's pass kinds and the ``serving_engine_steps`` kind that
#: counts each pass (one forward of the target)
SERVE_PASS_KINDS = {"prefill": "prefill", "spec": "spec_verify",
                    "decode": "decode"}


def _serve_instrument(engine) -> dict:
    """Start reading a run of ``engine``: every logits row it consumes,
    by request (the token bars' input; its one private hook), each
    request's TTFT from the request trace's completions, and the engine's
    own pass seconds and counters as they stand. ``st["stop"]()`` ends
    the reading; :func:`_pass_stats` turns it into the run's numbers."""
    import numpy as np

    from horovod_tpu_torch.observability import metrics, reqtrace

    def counters():
        return dict(seconds=dict(engine.pass_seconds), prefill_tokens=(
            metrics.value("serving_prefill_tokens") or 0), passes={
            k: metrics.value("serving_engine_steps", kind=v) or 0
            for k, v in SERVE_PASS_KINDS.items()})

    st = dict(rows={}, ttft={}, start=counters())
    real_consume = engine._consume_logits

    def consume(s, row, generation=-1):
        st["rows"].setdefault(s.req.rid, []).append(
            np.asarray(row, np.float32))
        return real_consume(s, row, generation)

    def completed(req, summary):
        if summary["ttft"] is not None:
            st["ttft"][req.rid] = summary["ttft"]

    def stop():
        reqtrace.remove_completion_observer(completed)
        del engine._consume_logits
        st["end"] = counters()

    engine._consume_logits = consume
    reqtrace.add_completion_observer(completed)
    st["stop"] = stop
    return st


def _serve_traffic(engine, prompts, tag: str, *, width: int = 8,
                   wait_first: bool = False) -> list:
    """Submit ``prompts`` (``width`` at once, then one as each slot
    frees; with ``wait_first`` the first alone until it finishes) and
    run the engine idle. Returns the requests."""
    pending = list(enumerate(prompts))
    reqs = []
    if wait_first:
        i, p = pending.pop(0)
        reqs.append(engine.submit(p, SERVE_NEW, rid=f"{tag}-{i}"))
        engine.run_until_idle()
    for _ in range(100000):
        live = len(engine.scheduler.active()) + engine.scheduler.queue_depth()
        while pending and live < width:
            i, p = pending.pop(0)
            reqs.append(engine.submit(p, SERVE_NEW, rid=f"{tag}-{i}"))
            live += 1
        if not pending and engine.scheduler.idle():
            break
        engine.step()
    for r in reqs:
        if r.error is not None or len(r.generated) != SERVE_NEW:
            fail(f"phase 21: request {r.rid} failed ({r.error})")
    return reqs


def _forced_logits(meta, weights: dict, prompts, forced, fault=None):
    """Teacher-forced logits of ``generate``'s path (one batched prefill
    of the right-padded prompts, then one single-token step a position on
    the contiguous cache) along the streams ``forced`` ``[B, n]``:
    ``[B, n, vocab]`` f32 on the card, position j the logits from which
    token j was chosen. ``fault`` breaks the decode steps as a faulty
    cache would: ``"position"`` decodes each token one position late,
    ``"row"`` decodes each row against the next row's prefilled cache."""
    import torch

    dev = next(iter(weights.values())).device
    b, n = forced.shape
    lens = torch.tensor([len(p) for p in prompts], device=dev)
    t = int(lens.max())
    pad = torch.zeros(b, t, dtype=torch.int64, device=dev)
    for i, p in enumerate(prompts):
        pad[i, :len(p)] = torch.as_tensor(p, device=dev)
    f = torch.as_tensor(forced, device=dev, dtype=torch.int64)

    def fwd(*a):
        return torch.func.functional_call(meta, weights, a)

    out = []
    with torch.no_grad():
        cache = meta.decode_cache(b, t + n, device=dev)
        logits = fwd(pad, torch.arange(t, device=dev)[None].expand(b, t),
                     cache)
        out.append(logits[torch.arange(b, device=dev), lens - 1])
        if fault == "row":
            for kc, vc in cache:
                kc.copy_(kc.roll(1, 0))
                vc.copy_(vc.roll(1, 0))
        late = int(fault == "position")
        for j in range(n - 1):
            logits = fwd(f[:, j:j + 1], (lens + j + late)[:, None], cache)
            out.append(logits[:, -1])
    return torch.stack(out, dim=1)


def _near_tie_bar(label: str, ref_tokens, got_tokens, gap_of, delta: float):
    """The token bar: a row of ``got_tokens`` may leave ``ref_tokens``
    only at a position whose reference top-2 gap (``gap_of(row, j)``) is
    under ``2 * delta``, the most that logits each within ``delta`` (the
    largest |Δlogit| measured between the two paths) can move the
    difference of two of them; its comparison stops there. Fails on a
    divergence at a wider gap; returns the near-tie divergences
    ``[(row, j, gap)]``."""
    bound = 2 * delta
    ties = []
    for i, (r, g) in enumerate(zip(ref_tokens, got_tokens)):
        diff = [j for j in range(len(r)) if int(r[j]) != int(g[j])]
        if not diff:
            continue
        j = diff[0]
        gap = gap_of(i, j)
        if not gap < bound:
            fail(f"phase 21 {label}: row {i} diverges at token {j} where the "
                 f"reference's top-2 gap {gap:.6g} is not under twice the "
                 f"measured max |dlogit| {delta:.6g}")
        ties.append((i, j, gap))
    return ties


def _pass_stats(st: dict, reqs) -> dict:
    """A run's numbers from :func:`_serve_instrument`'s reading: passes
    and ms a pass by kind, prefill and decode tokens/s (a request's first
    token comes from its last prefill pass, the rest from decode and spec
    passes) and TTFT p50/p99 over ``reqs``."""
    import numpy as np

    a, b = st["start"], st["end"]
    out = {}
    secs = {k: b["seconds"].get(k, 0.0) - a["seconds"].get(k, 0.0)
            for k in SERVE_PASS_KINDS}
    for k in SERVE_PASS_KINDS:
        n = int(b["passes"][k] - a["passes"][k])
        if n:
            out[f"{k}_passes"] = n
            out[f"{k}_ms_per_pass"] = 1e3 * secs[k] / n
    if secs["prefill"]:
        out["prefill_tokens_per_s"] = (
            b["prefill_tokens"] - a["prefill_tokens"]) / secs["prefill"]
    dec_s = secs["decode"] + secs["spec"]
    if dec_s:
        out["decode_tokens_per_s"] = sum(
            len(r.generated) - 1 for r in reqs) / dec_s
    ttft = [st["ttft"][r.rid] for r in reqs if r.rid in st["ttft"]]
    if ttft:
        out["ttft_p50_s"] = float(np.percentile(ttft, 50))
        out["ttft_p99_s"] = float(np.percentile(ttft, 99))
    return out


def _serve_prompts(seed: int) -> list:
    import numpy as np

    rng = np.random.RandomState(seed)
    lens = rng.randint(SERVE_PROMPT[0], SERVE_PROMPT[1] + 1, SERVE_REQUESTS)
    return [rng.randint(0, LM["vocab"], n).astype(np.int32) for n in lens]


def _kernel_ms(fn, iters: int = 3) -> float:
    """The card's busy time a call of ``fn``: the sum of the durations of
    the kernels a ``torch.profiler`` trace of ``iters`` calls shows (the
    events of :data:`OBS_TRACE_CAT`), over ``iters``. Unlike
    :func:`cuda_device_ms` it holds for a call of a thousand launches,
    which fill the card's launch queue behind its sleep."""
    import tempfile

    import torch

    from horovod_tpu_torch import profiler

    fn()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        with profiler.timeline(d):
            for _ in range(iters):
                fn()
        with open(os.path.join(d, "trace.json")) as f:
            events = json.load(f).get("traceEvents", [])
    return sum(e.get("dur", 0.0) for e in events
               if e.get("cat") == OBS_TRACE_CAT) / 1e3 / iters


def _gather_share(engine) -> dict:
    """The page gather against the decode forward, both as the card's
    kernel time (:func:`_kernel_ms`) at a decode pass's shapes: both
    pools' gathers in every block through a full page table, and one
    forward of the engine's decode model on tensors already on the card
    (its writes to the trash page 0, so no live page changes)."""
    import torch

    from horovod_tpu_torch.ops.flash_attention import gather_pages

    dev, b = engine.device, engine.max_batch
    table = torch.randint(1, engine.num_pages, (b, engine.pages_per_seq),
                          device=dev)
    pools = engine._cache

    def gathers():
        for k, v in pools:
            gather_pages(k, table)
            gather_pages(v, table)

    tok = torch.zeros(b, 1, dtype=torch.int64, device=dev)
    pos = torch.full((b, 1), engine.max_seq_len - 1, dtype=torch.int64,
                     device=dev)
    trash = torch.zeros_like(table)
    params = engine.arm_params("stable")

    def forward():
        with torch.no_grad():
            torch.func.functional_call(engine._dec, params, (tok, pos), {
                "cache": pools, "page_table": trash})

    g, f = _kernel_ms(gathers), _kernel_ms(forward)
    return dict(gather_device_ms=g, decode_forward_device_ms=f,
                gather_share_of_decode_forward=g / f)


def serving_phase(smi: str) -> dict:
    """Phase 21 on one GPU, in a world of one: (a) the handoff, (b) the
    engine at full width against ``generate`` under the near-tie token
    bar, (c) the prefix cache against an uncached engine, (d) speculative
    decoding against (b), (e) a ``GenerationRollout`` canary of
    generation 2 over 1 and a two-replica ``FleetRouter`` under
    ``replica_kill``. Returns the record, the delta's B1 calls (replayed
    in the kernel phase) and (b)'s requests and tokens for (f)."""
    import numpy as np
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import TransformerLM
    from horovod_tpu_torch.models.convert import flatten_tree, torch_weights
    from horovod_tpu_torch.models.transformer import generate
    from horovod_tpu_torch.observability import metrics
    from horovod_tpu_torch.resilience import chaos, health
    from horovod_tpu_torch.run.rendezvous import (
        KVStoreClient, KVStoreServer, make_secret,
    )
    from horovod_tpu_torch.serving import (
        FleetRollout, FleetRouter, GenerationRollout, InferenceEngine,
        WeightSubscriber,
    )

    t_phase = time.perf_counter()
    metrics.reset()
    metrics.set_enabled(True)
    health.reset()
    dev = hvd.device()
    meta = TransformerLM(**LM, dtype=torch.bfloat16, device="meta")
    out = {}
    # the rollout's engine and subscriber follow the handoff from gen 1
    secret = make_secret()
    server = KVStoreServer(secret=secret)
    addr = ("127.0.0.1", server.start(), secret)
    roll_engine = InferenceEngine(meta, device=dev, **dict(
        SERVE_ENGINE, num_pages=4 * 128 + 1))
    events = []
    roll = GenerationRollout(
        roll_engine, WeightSubscriber(KVStoreClient(
            *addr[:2], secret=secret), device=dev),
        canary_fraction=0.5, min_canary_requests=2,
        on_event=lambda ev, g: events.append((ev, g)))
    handoff, sub, delta_calls = serve_handoff(server, addr, roll.poll)
    out["handoff"] = handoff
    print(f"phase 21 (a): {json.dumps(handoff)}", flush=True)
    if (roll.stable_generation, roll.canary_generation) != (1, 2):
        fail(f"phase 21 (e): rollout stable {roll.stable_generation}, "
             f"canary {roll.canary_generation}")
    gen2 = sub.weights()
    weights2 = torch_weights(meta, gen2, dev)

    # (b) the engine at full width against generate
    prompts = _serve_prompts(21)
    eng = InferenceEngine(meta, device=dev, **SERVE_ENGINE)
    eng.set_weights(gen2, generation=2)
    st = _serve_instrument(eng)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = _serve_traffic(eng, prompts, "b")
    serve_s = time.perf_counter() - t0
    st["stop"]()
    tokens_b = [np.asarray(r.generated) for r in reqs]
    pad = np.zeros((len(prompts), max(map(len, prompts))), np.int32)
    for i, p in enumerate(prompts):
        pad[i, :len(p)] = p
    lens = np.array([len(p) for p in prompts])
    t0 = time.perf_counter()
    ref = generate(meta, gen2, pad, max_new_tokens=SERVE_NEW,
                   prompt_lens=lens, device=dev).cpu().numpy()
    generate_s = time.perf_counter() - t0
    ref_tokens = [ref[i, lens[i]:lens[i] + SERVE_NEW]
                  for i in range(len(prompts))]
    streams = np.stack(tokens_b)
    forced = _forced_logits(meta, weights2, prompts, streams)
    eng_rows = torch.from_numpy(np.stack(
        [np.stack(st["rows"][r.rid]) for r in reqs])).to(dev)
    scale = float(forced.abs().max())
    bound = float((eng_rows - forced).abs().max())
    # the controls: the same reading against generate's path with one
    # perturbed weight, decoding one position late, or against the
    # neighbouring row's cache
    key, factor = TP_CONTROL
    flat2 = flatten_tree(gen2)
    controls = {}
    for name, w, fault in (
            ("weight", torch_weights(meta, dict(
                flat2, **{key: flat2[key] * factor}), dev), None),
            ("position", weights2, "position"), ("row", weights2, "row")):
        bad = _forced_logits(meta, w, prompts, streams, fault=fault)
        controls[name] = float((eng_rows - bad).abs().max()) / scale
        del bad
    if not bound / scale <= SERVE_LOGIT_RTOL:
        fail(f"phase 21 (b): the engine's teacher-forced logits differ from "
             f"generate's path by {bound:.6g}, {bound / scale:.3g} of the "
             f"largest magnitude {scale:.6g} (bar {SERVE_LOGIT_RTOL})")
    passed = {k: v for k, v in controls.items() if not v > SERVE_LOGIT_RTOL}
    if passed:
        fail(f"phase 21 (b): controls pass the bar {SERVE_LOGIT_RTOL}: "
             f"{passed}")
    top2 = torch.topk(forced, 2, dim=-1).values
    gaps = (top2[..., 0] - top2[..., 1]).cpu().numpy()
    ties = _near_tie_bar("(b)", ref_tokens, tokens_b,
                         lambda i, j: float(gaps[i, j]), bound)
    del eng_rows, forced, top2
    out["engine"] = dict(
        requests=len(reqs), new_tokens=SERVE_NEW,
        prompt_tokens=int(lens.sum()), serve_s=serve_s,
        generate_s=generate_s, max_abs_logit_delta=bound,
        max_abs_logit=scale, logit_rel=bound / scale,
        logit_bar=SERVE_LOGIT_RTOL, control_rel=controls,
        near_tie_divergences=len(ties), ties=ties,
        rows_identical=sum(np.array_equal(a, b)
                           for a, b in zip(ref_tokens, tokens_b)),
        **_pass_stats(st, reqs), **_gather_share(eng))
    print(f"phase 21 (b): {json.dumps(out['engine'])}", flush=True)

    # (c) the prefix cache against an uncached engine
    rng = np.random.RandomState(23)
    prefix = rng.randint(0, LM["vocab"], SERVE_PREFIX).astype(np.int32)
    cprompts = [np.concatenate([prefix, rng.randint(
        0, LM["vocab"], SERVE_TAIL).astype(np.int32)]) for _ in range(8)]
    runs = {}
    for cached in (True, False):
        e = eng if cached else InferenceEngine(
            meta, device=dev, prefix_cache=False, **SERVE_ENGINE)
        if not cached:
            e.set_weights(gen2, generation=2)
        metrics.reset()
        shared = [0]
        real_step = e.step

        def step(real_step=real_step, e=e):
            ran = real_step()
            shared[0] = max(shared[0], metrics.value(
                "serving_prefix_pages_shared") or 0)
            return ran

        e.step = step
        t0 = time.perf_counter()
        rq = _serve_traffic(e, cprompts, f"c{int(cached)}", wait_first=True)
        runs[cached] = dict(tokens=[list(r.generated) for r in rq],
                            seconds=time.perf_counter() - t0,
                            hits=metrics.value("serving_prefix_hits") or 0,
                            prefill_tokens=metrics.value(
                                "serving_prefill_tokens"),
                            pages_shared_max=shared[0])
        e.step = real_step
        if not cached:
            del e
            torch.cuda.empty_cache()
    if runs[True]["tokens"] != runs[False]["tokens"]:
        fail("phase 21 (c): prefix-cached tokens differ from the uncached "
             "engine's")
    if not runs[True]["pages_shared_max"] > 0 or not runs[True]["hits"]:
        fail(f"phase 21 (c): no page was aliased ({runs[True]})")
    out["prefix"] = dict(
        requests=8, prefix=SERVE_PREFIX, tail=SERVE_TAIL, identical=True,
        hits=runs[True]["hits"], pages_shared_max=runs[True][
            "pages_shared_max"],
        prefill_tokens_cached=runs[True]["prefill_tokens"],
        prefill_tokens_uncached=runs[False]["prefill_tokens"],
        seconds_cached=runs[True]["seconds"],
        seconds_uncached=runs[False]["seconds"])

    # (d) speculative decoding against (b)
    metrics.reset()
    spec = InferenceEngine(meta, device=dev, draft_depth=SERVE_DRAFT,
                           spec_lookahead=SERVE_LOOKAHEAD, **SERVE_ENGINE)
    spec.set_weights(gen2, generation=2)
    sst = _serve_instrument(spec)
    rq = _serve_traffic(spec, prompts, "d")
    sst["stop"]()
    tokens_d = [np.asarray(r.generated) for r in rq]
    exact = all(np.array_equal(a, b) for a, b in zip(tokens_b, tokens_d))
    # the verify pass's [b, K+1] forwards sum in other shapes than the
    # decode pass's [b, 1]: read the largest |Δlogit| over each row's
    # common stream (to its first divergence, included), hold it to the
    # bar, then the divergences to it
    dmax, dscale = 0.0, 0.0
    for r_b, r_d, tb, td in zip(reqs, rq, tokens_b, tokens_d):
        n = next((j for j in range(SERVE_NEW) if tb[j] != td[j]), SERVE_NEW)
        for j in range(min(n + 1, SERVE_NEW)):
            row = st["rows"][r_b.rid][j]
            dmax = max(dmax, float(np.abs(row - sst["rows"][r_d.rid][j])
                                   .max()))
            dscale = max(dscale, float(np.abs(row).max()))
    if not dmax / dscale <= SERVE_LOGIT_RTOL:
        fail(f"phase 21 (d): the speculative engine's logits differ from "
             f"the plain engine's by {dmax:.6g}, {dmax / dscale:.3g} of the "
             f"largest magnitude {dscale:.6g} (bar {SERVE_LOGIT_RTOL})")

    def gap_b(i, j):
        row = np.sort(st["rows"][reqs[i].rid][j])
        return float(row[-1] - row[-2])

    dties = _near_tie_bar("(d)", tokens_b, tokens_d, gap_b, dmax)
    proposed = metrics.value("spec_proposed") or 0
    out["spec"] = dict(draft_depth=SERVE_DRAFT, lookahead=SERVE_LOOKAHEAD,
                       identical_to_plain=exact, max_abs_logit_delta=dmax,
                       logit_rel=dmax / dscale,
                       near_tie_divergences=len(dties),
                       acceptance=(metrics.value("spec_accepted") or 0)
                       / max(1, proposed), proposed=proposed,
                       **_pass_stats(sst, rq))
    del spec
    torch.cuda.empty_cache()

    # (e) the rollout's verdict on generation 2, then the fleet
    # 16 rids: 4 of them hash into the canary's half of the traffic
    rreqs = [roll.submit(f"roll-{i}", p[:256], 16)
             for i, p in enumerate(_serve_prompts(25))]
    roll.drain()
    verdicts = [ev for ev in events if ev[0] in ("promoted", "rolled_back")]
    if not verdicts:
        fail(f"phase 21 (e): the rollout reached no verdict ({events})")
    out["rollout"] = dict(
        events=events, verdict=verdicts[-1][0],
        reason=health.MONITOR.reason() or "healthy canary",
        requests=len(rreqs),
        errors=sum(r.error is not None for r in rreqs))
    del roll, roll_engine
    torch.cuda.empty_cache()
    metrics.reset()
    router = FleetRouter(store=server, hedge_after=0.0)
    for i in range(2):
        router.add_replica(f"r{i}", InferenceEngine(
            meta, device=dev, **SERVE_ENGINE), WeightSubscriber(
            KVStoreClient(*addr[:2], secret=addr[2]), device=dev))
    frollout = FleetRollout(router, server, canary_fraction=1.0,
                            max_latency_ratio=None)
    t0 = time.perf_counter()
    router.pump()
    fleet_apply_s = time.perf_counter() - t0
    if frollout.stable_generation != 2:
        fail(f"phase 21 (e): the fleet serves generation "
             f"{frollout.stable_generation}")
    chaos.configure(f"replica_kill=1:{SERVE_KILL_PUMP}")
    try:
        t0 = time.perf_counter()
        freqs = [router.submit(f"f-{i}", p, SERVE_NEW)
                 for i, p in enumerate(prompts)]
        router.drain()
        fleet_s = time.perf_counter() - t0
    finally:
        chaos.reset()
    done = metrics.value("fleet_requests", arm="stable", outcome="ok")
    bad = [q.rid for q in freqs if q.error is not None or q.result is None]
    if bad or done != len(prompts) or not router.replica("r1").dead:
        fail(f"phase 21 (e): fleet requests {bad} failed, {done} completed "
             f"of {len(prompts)}, r1 dead {router.replica('r1').dead}")
    mism = [q.rid for q, t in zip(freqs, tokens_b)
            if not np.array_equal(np.asarray(q.generated), t)]
    if mism:
        fail(f"phase 21 (e): fleet tokens differ from (b)'s for {mism}")
    out["fleet"] = dict(
        replicas=2, requests=len(freqs), completed_once=int(done),
        failed_over=metrics.value("fleet_requests_failed_over") or 0,
        replicas_lost=metrics.value("resilience_replicas_lost") or 0,
        served_by={r: sum(q.replica == r for q in freqs)
                   for r in ("r0", "r1")},
        identical_to_b=True, seconds=fleet_s, subscribe_apply_s=fleet_apply_s)
    router.close()
    server.close()
    del router, eng, weights2
    gen2_flat = {k: v.detach().cpu() for k, v in flatten_tree(gen2).items()}
    del gen2, sub
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    return out, delta_calls, dict(prompts=prompts, tokens=tokens_b,
                                  gen2_flat=gen2_flat)


def _tp_stream(seed: int):
    import numpy as np

    b, t = TP_STREAM
    return np.random.RandomState(seed).randint(0, LM["vocab"], (b, t))


def _tp_forced(engine, params, stream):
    """Teacher-forced logits of the engine's forward over ``stream`` ``[b,
    t]`` in prefill chunks on a page table of fresh pages: ``[b, t,
    vocab]`` f32 on the card."""
    import numpy as np
    import torch

    b, t = stream.shape
    c, mb = engine.prefill_chunk, engine.max_batch
    table = np.zeros((mb, engine.pages_per_seq), np.int32)
    per = -(-t // engine.page_size)
    for i in range(b):
        table[i, :per] = 1 + i * per + np.arange(per)
    out = []
    for c0 in range(0, t, c):
        tok = np.zeros((mb, c), np.int32)
        pos = np.zeros((mb, c), np.int32)
        tok[:b] = stream[:, c0:c0 + c]
        pos[:b] = c0 + np.arange(c)
        out.append(engine._run(params, tok, pos, table, "tp_forced")[:b])
    return torch.cat(out, dim=1)


def serving_tp_rank(perturb: bool) -> dict:
    """One rank of (f): the TP engine over the mesh ``{"tp": n}`` on
    generation 2's weights (read from :data:`SERVE_DIR`). Teacher-forced
    logits of the fixed stream against the one-GPU engine's (max |Δ|
    over the reference's largest magnitude), with ``perturb`` the same
    after one perturbed weight (the control, on every rank: the TP
    forward is a collective); then greedy traffic, every
    decode pass's all-reduces and all-gathers counted, and the control
    plane's calls."""
    import numpy as np
    import torch
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import TransformerLM
    from horovod_tpu_torch.parallel import build_mesh
    from horovod_tpu_torch.serving import InferenceEngine
    from horovod_tpu_torch.testing import watching_calls

    dev = hvd.device()
    build_mesh({"tp": hvd.size()})
    flat = torch.load(os.path.join(SERVE_DIR, "gen2.pt"), map_location=dev)
    ref = torch.load(os.path.join(SERVE_DIR, "forced.pt"), map_location=dev)
    prompts = [p.numpy() for p in torch.load(
        os.path.join(SERVE_DIR, "traffic.pt"))]
    meta = TransformerLM(**LM, dtype=torch.bfloat16, device="meta")
    eng = InferenceEngine(meta, device=dev, tp_axis="tp", **dict(
        SERVE_ENGINE, num_pages=4 * 128 + 1))
    eng.set_weights(flat, generation=2)
    stream = _tp_stream(26)
    scale = float(ref.abs().max())
    got = _tp_forced(eng, eng.arm_params("stable"), stream)
    rel = float((got - ref).abs().max()) / scale
    rec = dict(rank=hvd.rank(), rel=rel)
    if perturb:
        bad = dict(flat)
        key, factor = TP_CONTROL
        bad[key] = flat[key] * factor
        ctl = InferenceEngine(meta, device=dev, tp_axis="tp", **dict(
            SERVE_ENGINE, num_pages=4 * 128 + 1))
        ctl.set_weights(bad, generation=2)
        cgot = _tp_forced(ctl, ctl.arm_params("stable"), stream)
        rec["control_rel"] = float((cgot - ref).abs().max()) / scale
        del ctl, cgot
    del got
    torch.cuda.empty_cache()
    calls = []
    decode = []
    real_decode = eng._decode_pass

    def counted(*a, **kw):
        n0 = len(calls)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ran = real_decode(*a, **kw)
        if ran:
            decode.append((len(calls) - n0, time.perf_counter() - t0,
                           len([s for s in eng.scheduler.active()
                                if not s.prefilling])))
        return ran

    eng._decode_pass = counted
    with watching_calls(dist, DIST_CALLS, lambda n, a, k: calls.append(n)):
        n0 = len(calls)
        reqs = [eng.submit(p, TP_NEW, rid=f"tp-{i}")
                for i, p in enumerate(prompts)]
        eng.scheduler.admit()
        control = len(calls) - n0
        eng.run_until_idle()
    ar = [c for c in calls if c == "all_reduce"]
    per_pass = sorted({n for n, _, _ in decode})
    rec.update(tokens=[list(map(int, r.generated)) for r in reqs],
               errors=[r.error for r in reqs if r.error is not None],
               decode_calls_per_pass=per_pass, control_calls=control,
               all_reduces=len(ar), decode_passes=len(decode),
               decode_s=sum(s for _, s, _ in decode),
               decode_tokens=sum(n for _, _, n in decode))
    return rec


def serving_tp_gpus(n: int, traffic: dict) -> dict:
    """(f): generation 2 and the one-GPU engine's teacher-forced logits of
    the fixed stream go to :data:`SERVE_DIR`, then a world of ``n`` runs
    :func:`serving_tp_rank`. Gates: every rank within
    :data:`TP_LOGIT_RTOL`, the control (one perturbed weight) outside
    it; every rank the same greedy tokens; each decode pass
    exactly 2 all-reduces a block plus the two all-gathers of the split
    embedding and vocabulary; the control plane no call."""
    import shutil

    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import TransformerLM
    from horovod_tpu_torch.serving import InferenceEngine
    from horovod_tpu_torch.testing import run_world

    shutil.rmtree(SERVE_DIR, ignore_errors=True)
    os.makedirs(SERVE_DIR)
    try:
        hvd.init()
        try:
            dev = hvd.device()
            meta = TransformerLM(**LM, dtype=torch.bfloat16, device="meta")
            eng = InferenceEngine(meta, device=dev, **dict(
                SERVE_ENGINE, num_pages=4 * 128 + 1))
            flat = {k: v.detach().cpu()
                    for k, v in traffic["gen2_flat"].items()}
            eng.set_weights(flat, generation=2)
            ref = _tp_forced(eng, eng.arm_params("stable"), _tp_stream(26))
            torch.save(flat, os.path.join(SERVE_DIR, "gen2.pt"))
            torch.save(ref.cpu(), os.path.join(SERVE_DIR, "forced.pt"))
            torch.save([torch.from_numpy(p[:512]) for p in traffic[
                "prompts"][:TP_REQUESTS]], os.path.join(SERVE_DIR,
                                                        "traffic.pt"))
            del eng, ref
            torch.cuda.empty_cache()
        finally:
            hvd.shutdown()
        t0 = time.perf_counter()
        try:
            res = run_world(_serving_tp_rank, n, device=None, timeout=600)
        except Exception as e:
            fail(f"{n} GPUs, phase 21 (f): {e}")
        seconds = time.perf_counter() - t0
    finally:
        shutil.rmtree(SERVE_DIR, ignore_errors=True)
    per_block = 2 * LM["depth"]
    for r in res:
        if r["rel"] > TP_LOGIT_RTOL:
            fail(f"phase 21 (f): rank {r['rank']}'s teacher-forced logits "
                 f"differ from the one-GPU engine's by {r['rel']:.3g} of the "
                 f"largest magnitude (bar {TP_LOGIT_RTOL})")
        if r["tokens"] != res[0]["tokens"] or r["errors"]:
            fail(f"phase 21 (f): rank {r['rank']} emitted other tokens "
                 f"({r['errors']})")
        if r["decode_calls_per_pass"] != [per_block + 2] or \
                r["all_reduces"] % per_block or r["control_calls"]:
            fail(f"phase 21 (f): rank {r['rank']}: calls a decode pass "
                 f"{r['decode_calls_per_pass']} (expected {per_block} "
                 f"all-reduces + 2 all-gathers), control plane "
                 f"{r['control_calls']}")
    ctl = res[0]["control_rel"]
    if not ctl > TP_LOGIT_RTOL:
        fail(f"phase 21 (f): the control (one perturbed weight) passes the "
             f"bar: {ctl:.3g} <= {TP_LOGIT_RTOL}")
    r0 = res[0]
    return dict(gpus=n, rel=[r["rel"] for r in res], bar=TP_LOGIT_RTOL,
                control_rel=ctl, tokens_identical_across_ranks=True,
                all_reduces_per_decode_pass=per_block,
                all_gathers_per_decode_pass=2,
                decode_passes=r0["decode_passes"],
                decode_tokens_per_s_per_gpu=r0["decode_tokens"] / max(
                    r0["decode_s"], 1e-9) / n,
                decode_ms_per_pass=1e3 * r0["decode_s"] / max(
                    1, r0["decode_passes"]),
                seconds=seconds)


def _serving_tp_rank() -> dict:
    return serving_tp_rank(perturb=True)


def print_serving(p21: dict, smi: str) -> None:
    """Phase 21's lines, each number beside the card's name and limit."""
    a, b, c, d = p21["handoff"], p21["engine"], p21["prefix"], p21["spec"]
    for pub in a["publications"]:
        print(f"phase 21 (a) publication {pub['generation']} "
              f"({pub['kind']}, step {pub['step']}): publish "
              f"{pub['publish_s']:.3f} s, {pub['wire_bytes']} wire bytes "
              f"({pub['payload_bytes']} payload, {pub['chunks']} chunks), "
              f"quantize launches {pub['quantize_launches']}; subscriber "
              f"apply on the card {pub['apply_s']:.3f} s, bit-equal ({smi})",
              flush=True)
    print(f"phase 21 (a) handoff: {a['steps']} steps in {a['train_s']:.2f} s "
          f"(elastic, world of one), flash_fwd {a['flash_fwd_launches']}, "
          f"{a['quantizable_leaves']} quantizable leaves, losses "
          f"{a['losses']} ({smi})", flush=True)
    print(f"phase 21 (b) engine (max_batch 8, page 16, chunk 256, 2048): "
          f"prefill {b['prefill_tokens_per_s']:.1f} tokens/s, decode "
          f"{b['decode_tokens_per_s']:.1f} tokens/s, TTFT p50 "
          f"{b['ttft_p50_s']:.4f} s p99 {b['ttft_p99_s']:.4f} s, ms a pass "
          f"prefill {b['prefill_ms_per_pass']:.3f} decode "
          f"{b['decode_ms_per_pass']:.3f} (host), page gather "
          f"{b['gather_device_ms']:.4f} ms of the decode forward's "
          f"{b['decode_forward_device_ms']:.4f} ms of kernel time "
          f"({100 * b['gather_share_of_decode_forward']:.1f} %); "
          f"teacher-forced logits against generate's path within "
          f"{b['logit_rel']:.4g} of the largest magnitude "
          f"{b['max_abs_logit']:.4g} (bar {b['logit_bar']}; controls "
          f"{json.dumps(b['control_rel'])}); tokens against generate: "
          f"{b['rows_identical']}/{b['requests']} rows identical, "
          f"{b['near_tie_divergences']} near-tie divergences (gap under 2 x "
          f"max |dlogit| {b['max_abs_logit_delta']:.4g}) ({smi})",
          flush=True)
    print(f"phase 21 (c) prefix cache ({c['requests']} requests, "
          f"{c['prefix']}-token prefix): tokens identical to the uncached "
          f"engine, {c['hits']} hits, up to {c['pages_shared_max']} pages "
          f"aliased, prefill tokens {c['prefill_tokens_cached']} vs "
          f"{c['prefill_tokens_uncached']}, seconds "
          f"{c['seconds_cached']:.3f} vs {c['seconds_uncached']:.3f} ({smi})",
          flush=True)
    print(f"phase 21 (d) speculative (draft {d['draft_depth']} blocks, "
          f"lookahead {d['lookahead']}): acceptance {d['acceptance']:.4f}, "
          f"decode {d['decode_tokens_per_s']:.1f} tokens/s, identical to "
          f"plain decode {d['identical_to_plain']}, logits within "
          f"{d['logit_rel']:.4g} of the plain engine's largest magnitude "
          f"(max |dlogit| {d['max_abs_logit_delta']:.4g}), "
          f"{d['near_tie_divergences']} near-tie divergences ({smi})",
          flush=True)
    print(f"phase 21 (e) rollout verdict on generation 2: "
          f"{p21['rollout']['verdict']} ({p21['rollout']['reason']}); fleet "
          f"{json.dumps(p21['fleet'])} ({smi})", flush=True)
    rest = {k: v for k, v in p21.items() if k != "handoff"}
    print(f"phase 21: {p21['seconds']:.1f} s; {json.dumps(rest)}", flush=True)


# --------------------------------------------------------------------------
# phase 22: the launcher and the input plane


#: phase 22's run (ResNet-50 on the launcher's GPU): the dataset (images,
#: side, classes, rows a shard), rows a GPU a step, epochs, learning rate
#: (warmed up over the first epoch, then halved each epoch), the stream's
#: seed
P22 = dict(images=2048, side=224, classes=1000, shard=128, batch=64,
           epochs=2, lr=1e-3, seed=7)
#: one GPU: the step a SIGTERM holds in epoch 0, the step the primary KV
#: store is killed at, the corrupt shard; across N GPUs, the kill's step
P22_PREEMPT_AT, P22_KILL_AT, P22_CORRUPT = 10, 12, 3
P22_KILL_AT_WORLD = 3
P22_DIR = os.path.join(ROOT, "_smoke_launcher")
#: seconds a launched job may take
P22_TIMEOUT = 600
#: when main() started (the elapsed lines)
T0 = time.perf_counter()


def _p22_tool() -> str:
    return os.path.join(ROOT, "tools", "launcher_phase.py")


def _p22_env(cache_all: bool = True, gpu=None, **extra) -> dict:
    """The jobs' environment: deterministic cuBLAS (the workers turn on
    deterministic algorithms), the schedule sanitizer (its step keys are
    what the failover drill reads on the promoted store), a 1 s primary
    lease, the repository importable. ``cache_all``: a shard cache that
    holds the whole dataset, for the drills, whose readings are bits (the
    default of 8 shards thrashes: every batch of a shuffled epoch touches
    all 16); the timed run keeps the store's default, as a deployment
    whose dataset outgrows memory would. ``gpu``: the jobs see that card
    alone."""
    env = child_env(gpu, CUBLAS_WORKSPACE_CONFIG=":4096:8",
                    HOROVOD_SANITIZE="1", HOROVOD_KV_REPLICA_LEASE="1.0",
                    PYTHONPATH=os.pathsep.join(
                        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    env.pop("HOROVOD_CHAOS", None)
    env.pop("HOROVOD_DATA_CACHE_SHARDS", None)
    if cache_all:
        env["HOROVOD_DATA_CACHE_SHARDS"] = str(
            -(-P22["images"] // P22["shard"]))
    env.update(extra)
    return env


def p22_cfg(tag: str, n: int, **kw) -> str:
    """A worker config for the run ``tag`` on ``n`` GPUs (its own output
    directory, checkpoint directory and signal directory); returns its
    path."""
    import shutil

    out = os.path.join(P22_DIR, tag)
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    cfg = dict(store=os.path.join(P22_DIR, "store"), model="resnet50",
               model_seed=0, classes=P22["classes"], batch=P22["batch"] * n,
               seed=P22["seed"], epochs=P22["epochs"], lr=P22["lr"],
               warmup_epochs=1, checkpoint_dir=os.path.join(out, "ckpt"),
               deterministic=True, out=out, signal_dir=out)
    cfg.update(kw)
    path = os.path.join(out, "cfg.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def _p22_records(cfg_path: str, n: int) -> list:
    with open(cfg_path) as f:
        out = json.load(f)["out"]
    recs = []
    for r in range(n):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            recs.append(json.load(f))
    return recs


def _p22_job(argv: list, cfg_path: str, env: dict, during=None) -> dict:
    """Run one job (its output in the run's directory); ``during(proc,
    out)`` runs while it does. ``{"rc", "seconds", "t_launch"}``."""
    with open(cfg_path) as f:
        out = json.load(f)["out"]
    t_launch = time.time()
    with open(os.path.join(out, "job.log"), "w") as log:
        proc = subprocess.Popen(argv, stdout=log, stderr=subprocess.STDOUT,
                                env=env, cwd=ROOT)
        try:
            if during is not None:
                during(proc, out)
            rc = proc.wait(timeout=P22_TIMEOUT)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    res = dict(rc=rc, seconds=time.time() - t_launch, t_launch=t_launch)
    if rc not in (0, 75):
        with open(os.path.join(out, "job.log")) as f:
            res["log"] = f.read()[-4000:]
    return res


def hvdrun_argv(n: int, cfg_path: str) -> list:
    """``python -m horovod_tpu_torch.run -np n --kv-standbys 1`` of the
    worker, as a user launches it."""
    return [sys.executable, "-m", "horovod_tpu_torch.run", "-np", str(n),
            "--kv-standbys", "1", sys.executable, _p22_tool(), "--worker",
            cfg_path]


def hvdrun(n: int, cfg_path: str, env: dict, during=None) -> dict:
    return _p22_job(hvdrun_argv(n, cfg_path), cfg_path, env, during)


def _p22_side_by_side(*jobs) -> list:
    """Jobs (``(argv, cfg_path, env, during)`` or a callable) run side by
    side on the same GPUs: the drills and the references, whose readings
    are their bits, not their times; results in order."""
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as ex:
        futs = [ex.submit(j) if callable(j) else ex.submit(_p22_job, *j)
                for j in jobs]
        return [f.result() for f in futs]


def _p22_wait_file(path: str, proc, timeout: float = 300.0) -> dict:
    t0 = time.monotonic()
    while not os.path.exists(path):
        if proc.poll() is not None:
            fail(f"phase 22: the job ended (rc {proc.returncode}) before "
                 f"{os.path.basename(path)}")
        if time.monotonic() - t0 > timeout:
            fail(f"phase 22: {os.path.basename(path)} never came")
        time.sleep(0.02)
    with open(path) as f:
        return json.load(f)


def _primary_of(launcher_pid: int) -> int:
    """The launcher's primary KV store process (its child running
    ``horovod_tpu_torch.run.replication --role primary``)."""
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                argv = f.read().split(b"\0")
            with open(f"/proc/{pid}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
        except (OSError, ValueError, IndexError):
            continue
        if ppid == launcher_pid and \
                b"horovod_tpu_torch.run.replication" in argv and \
                b"primary" in argv:
            return int(pid)
    fail("phase 22: no primary KV store process under the launcher")


def p22_expected_lr(i: int, spe: int, n: int) -> float:
    """The learning rate at step ``i``: in the first epoch Goyal et al.'s
    warmup, as ``LearningRateWarmupCallback`` computes it, then
    ``lr * 0.5 ** epoch`` at the fractional epoch, as the worker's
    ``LearningRateScheduleCallback`` does."""
    e, k = divmod(i, spe)
    epoch = e + float(k) / spe
    if e == 0:
        return P22["lr"] * ((min(epoch, 1) * (n - 1) / 1 + 1) / n)
    return P22["lr"] * 0.5 ** epoch


def _p22_check_run(label: str, recs: list, n: int, first: int = 0,
                   want_sha=None) -> dict:
    """(b) and (c) of one run's records: every rank's ids at each step are
    the sample index's prediction, each epoch visits every id once, the
    first batch equals the store's rows, each step's learning rate and
    its logged ``fused_adam`` call's are the schedule's, B1, B3 and B5 each
    launched once a step; every rank's parameters identical (and equal to
    ``want_sha`` when given)."""
    from horovod_tpu_torch.data import GlobalSampleIndex

    index = GlobalSampleIndex(P22["images"], P22["batch"] * n,
                              seed=P22["seed"])
    spe = index.steps_per_epoch
    want_launch = {k: v for k, v in expected_launches(
        "zero1", n, 161).items() if v}
    seen: dict = {}
    for r, rec in enumerate(recs):
        if rec["rank"] != r or rec["size"] != n:
            fail(f"phase 22 {label}: rank {r}'s record is rank "
                 f"{rec['rank']} of {rec['size']}")
        if first == 0 and rec.get("first_batch_equal") is False:
            fail(f"phase 22 {label}: rank {r}'s first batch on the card is "
                 "not the store's rows")
        steps = [s["i"] for s in rec["steps"]]
        if steps != list(range(first, spe * P22["epochs"])):
            fail(f"phase 22 {label}: rank {r} ran steps {steps}")
        for s in rec["steps"]:
            e, st = divmod(s["i"], spe)
            if s["key"] != [e, st] or s["ids"] != index.rank_indices(
                    e, st, r, n).tolist():
                fail(f"phase 22 {label}: rank {r} step {s['i']} consumed "
                     f"{s['key']} {s['ids'][:4]}... not the index's")
            for v in s["ids"]:
                seen.setdefault(e, []).append(v)
            lr = p22_expected_lr(s["i"], spe, n)
            if s["lr"] != lr:
                fail(f"phase 22 {label}: step {s['i']} lr {s['lr']} is not "
                     f"the schedule's {lr}")
            if s["launches"] != want_launch:
                fail(f"phase 22 {label}: rank {r} step {s['i']} launched "
                     f"{s['launches']}, expected {want_launch}")
        for step, sigs in zip(rec["steps"], rec["calls"]):
            for sig in sigs:
                if sig[0] == "fused_adam" and dict(map(tuple, sig[4]))[
                        "lr"] != step["lr"]:
                    fail(f"phase 22 {label}: step {step['i']}'s fused_adam "
                         f"call has lr {dict(map(tuple, sig[4]))['lr']}, "
                         f"the schedule's is {step['lr']}")
    if first == 0:
        for e, ids in seen.items():
            if sorted(ids) != list(range(P22["images"])):
                fail(f"phase 22 {label}: epoch {e} did not visit every id "
                     "exactly once")
    shas = {rec["params_sha"] for rec in recs}
    if len(shas) != 1:
        fail(f"phase 22 {label}: the ranks' final parameters differ")
    sha = shas.pop()
    if want_sha is not None and sha != want_sha:
        fail(f"phase 22 {label}: final parameters differ from the run "
             "without the launcher")
    return dict(sha=sha, steps=spe * P22["epochs"], steps_per_epoch=spe)


def _tuples(x):
    return tuple(map(_tuples, x)) if isinstance(x, list) else x


def p22_replay_calls(rec: dict) -> list:
    """The logged kernel calls to replay of one rank's run: those of the
    first step of each epoch and of its last step, each with its own
    ``lr`` (the warmup's first rate, the schedule's first and last; a
    step whose rate an earlier one had is left out)."""
    spe = len(rec["steps"]) // P22["epochs"]
    keep, rates = [], set()
    for j in [*range(0, len(rec["steps"]), spe), len(rec["steps"]) - 1]:
        if rec["steps"][j]["lr"] not in rates:
            keep.append(j)
            rates.add(rec["steps"][j]["lr"])
    return [_tuples(sig) for j in keep for sig in rec["calls"][j]]


def _p22_stats(label: str, res: dict, recs: list, n: int) -> dict:
    """The run's readings: launch to first step; img/s a GPU fed by the
    loader, over the second epoch's wall time (its waits for a batch,
    steps, callbacks and the first epoch's checkpoint included), and over
    its steps alone (each synchronised); the step loop's wait for a
    batch; peak memory."""
    rec = recs[0]
    spe = len(rec["steps"]) // P22["epochs"]
    steps = rec["steps"]
    loop_s = steps[-1]["t_end"] - steps[spe - 1]["t_end"]
    second = [s["step_s"] for s in steps[spe:]]
    waits = sorted(s["wait_s"] for s in rec["steps"])
    marks = {}
    if rec.get("t_start") is not None:
        t = res["t_launch"]
        for name, key in (("launcher_and_start", "t_start"),
                          ("init", "t_init"), ("model", "t_model"),
                          ("build", "t_built"), ("to_first_step",
                                                 "t_first")):
            marks[name] = max(r[key] for r in recs) - t
            t = max(r[key] for r in recs)
    return dict(
        label=label, rc=res["rc"], job_s=res["seconds"],
        launch_to_first_step_s=min(r["t_first"] for r in recs)
        - res["t_launch"], startup_s=marks,
        img_per_s_per_gpu=P22["batch"] * len(second) / loop_s,
        step_img_per_s_per_gpu=P22["batch"] * len(second) / sum(second),
        wait_p50_ms=1e3 * waits[len(waits) // 2],
        wait_max_ms=1e3 * waits[-1],
        copy_ms=rec.get("copy_ms"), copy_bytes=rec.get("copy_bytes"),
        peak_gib=max(r.get("peak_gib", 0.0) for r in recs),
        launches={k: sum(s["launches"].get(k, 0) for s in rec["steps"])
                  for k in ("quantize", "dequant_accumulate", "fused_adam")},
        epoch_logs=rec["epoch_logs"])


def _p22_kill_primary(kill_at: int, times: dict):
    """The failover drill's driver: when rank 0 holds step ``kill_at``,
    SIGKILL the launcher's primary KV store, let the rank go on, and time
    the standby's promotion."""
    import signal

    from horovod_tpu_torch.run import replication
    from horovod_tpu_torch.run.rendezvous import parse_endpoints

    def during(proc, out):
        note = _p22_wait_file(os.path.join(out, "kill_at"), proc)
        if note["step"] != kill_at:
            fail(f"phase 22 (e): rank 0 announced step {note['step']}")
        eps = parse_endpoints(note["kv_addrs"])
        primary = _primary_of(proc.pid)
        os.kill(primary, signal.SIGKILL)
        t_kill = time.monotonic()
        with open(os.path.join(out, "killed"), "w") as f:
            f.write("1")
        while True:
            st = replication.status_of(*eps[1], secret=note["secret"])
            if st is not None and st.get("role") == "primary":
                times["kill_to_promotion_s"] = time.monotonic() - t_kill
                break
            if time.monotonic() - t_kill > 60 or proc.poll() is not None:
                fail("phase 22 (e): the standby was not promoted within 60 s")
            time.sleep(0.01)

    return during


def _p22_check_failover(label: str, recs: list) -> dict:
    out = {}
    for rec in recs:
        kv = rec["kv"]
        if not kv["failovers"] or kv["failovers"] < 1:
            fail(f"phase 22 {label}: rank {rec['rank']}'s KV client counted "
                 f"no failover ({kv})")
        if kv.get("later_keys") is not None and \
                kv["later_keys_on_standby"] != kv["later_keys"]:
            fail(f"phase 22 {label}: rank {rec['rank']}'s step keys after "
                 f"the kill: {kv['later_keys_on_standby']} of "
                 f"{kv['later_keys']} on the promoted store")
        out[rec["rank"]] = kv
    return out


def launcher_phase(smi: str, gpu=None) -> tuple:
    """Phase 22 on one GPU: ``(record, the logged kernel calls to
    replay)``. Writes the dataset, runs the worker without the launcher
    (the reference), then through it: (a) the run, (b) its stream, (c)
    its learning rate, (d) a SIGTERM to the launcher and the resume, (e)
    the primary KV store killed, (f) a corrupt shard. ``gpu``: every job
    sees that card alone."""
    import shutil
    import signal

    import numpy as np

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import launcher_phase as LP

    t0 = time.perf_counter()
    shutil.rmtree(P22_DIR, ignore_errors=True)
    rec = {}
    try:
        t = time.perf_counter()
        manifest = LP.make_dataset(os.path.join(P22_DIR, "store"),
                                   P22["images"], P22["side"],
                                   P22["classes"], P22["shard"])
        rec["dataset"] = dict(
            images=manifest["n"], shards=len(manifest["shards"]),
            bytes=_dir_bytes(os.path.join(P22_DIR, "store")),
            write_s=time.perf_counter() - t)
        env = _p22_env(gpu=gpu)
        # the reference (no launcher), (f), (d)'s preempted run and (e)
        # side by side; then (a) alone (its times are readings), then (d)'s
        # resume
        ref_cfg = p22_cfg("reference", 1)
        # (no first-batch check in (f): its own gather would count again)
        f_cfg = p22_cfg("corrupt", 1, row_sums=True, checkpoint_dir=None,
                        check_first=False)
        d_cfg = p22_cfg("preempt", 1, preempt_at=P22_PREEMPT_AT)
        e_cfg = p22_cfg("failover", 1, kill_at=P22_KILL_AT)

        def sigterm(proc, out):
            _p22_wait_file(os.path.join(out, "at_preempt"), proc)
            proc.send_signal(signal.SIGTERM)

        times: dict = {}
        ref, f, d, e = _p22_side_by_side(
            ([sys.executable, _p22_tool(), "--worker", ref_cfg], ref_cfg,
             env, None),
            (hvdrun_argv(1, f_cfg), f_cfg, _p22_env(
                gpu=gpu, HOROVOD_CHAOS=f"shard_corrupt={P22_CORRUPT}:0"),
             None),
            (hvdrun_argv(1, d_cfg), d_cfg, env, sigterm),
            (hvdrun_argv(1, e_cfg), e_cfg, env,
             _p22_kill_primary(P22_KILL_AT, times)))
        if ref["rc"] != 0:
            fail(f"phase 22: the worker without the launcher: rc "
                 f"{ref['rc']}\n{ref.get('log', '')}")
        if f["rc"] != 0:
            fail(f"phase 22 (f): exit {f['rc']}\n{f.get('log', '')}")
        if d["rc"] != 75:
            fail(f"phase 22 (d): the preempted job exited {d['rc']}, not "
                 f"75\n{d.get('log', '')}")
        if e["rc"] != 0:
            fail(f"phase 22 (e): exit {e['rc']}\n{e.get('log', '')}")
        ref_sha = _p22_records(ref_cfg, 1)[0]["params_sha"]
        rec["f"] = _p22_check_corrupt(_p22_records(f_cfg, 1)[0])
        rec["f"]["job_s"] = f["seconds"]
        e_recs = _p22_records(e_cfg, 1)
        _p22_check_run("(e)", e_recs, 1, want_sha=ref_sha)
        rec["e"] = dict(times, kv=_p22_check_failover("(e)", e_recs),
                        bit_equal=True, job_s=e["seconds"])
        # (a)-(c), at the store's default shard cache
        a_cfg = p22_cfg("run", 1, log_calls=True, copy_ms=True)
        a = hvdrun(1, a_cfg, _p22_env(cache_all=False, gpu=gpu))
        if a["rc"] != 0:
            fail(f"phase 22 (a): hvdrun exit {a['rc']}\n{a.get('log', '')}")
        a_recs = _p22_records(a_cfg, 1)
        rec["a"] = _p22_check_run("(a)", a_recs, 1, want_sha=ref_sha)
        rec["a"].update(_p22_stats("(a)", a, a_recs, 1))
        calls = p22_replay_calls(a_recs[0])
        with open(d_cfg) as fh:
            cfg = json.load(fh)
        cfg.pop("preempt_at")
        with open(d_cfg, "w") as fh:
            json.dump(cfg, fh)
        d2 = hvdrun(1, d_cfg, env)
        if d2["rc"] != 0:
            fail(f"phase 22 (d): the resumed job exited {d2['rc']}\n"
                 f"{d2.get('log', '')}")
        d_recs = _p22_records(d_cfg, 1)
        first = d_recs[0]["steps"][0]["i"]
        if first != P22_PREEMPT_AT + 1:
            fail(f"phase 22 (d): resumed at step {first}, expected "
                 f"{P22_PREEMPT_AT + 1}")
        _p22_check_run("(d)", d_recs, 1, first=first, want_sha=ref_sha)
        a_ids = {st["i"]: st["ids"] for st in a_recs[0]["steps"]}
        if any(st["ids"] != a_ids[st["i"]] for st in d_recs[0]["steps"]):
            fail("phase 22 (d): the resumed run's ids differ from (a)'s")
        rec["d"] = dict(preempted_rc=d["rc"], preempted_s=d["seconds"],
                        resumed_at=first, resumed_s=d2["seconds"],
                        bit_equal=True)
    finally:
        shutil.rmtree(P22_DIR, ignore_errors=True)
    rec["seconds"] = time.perf_counter() - t0
    return rec, calls


def _p22_check_corrupt(rec: dict) -> dict:
    """(f): the shard quarantined, every sample of it substituted by the
    store's rule (``healthy_rows[id % n_healthy]``: the delivered row's
    pixel sum and label are the substitute's), the count in
    ``data_samples_substituted``, health SUSPECT naming the shard."""
    import numpy as np

    rng = np.random.default_rng(0)
    n, side = P22["images"], P22["side"]
    x = rng.integers(0, 256, (n, side, side, 3), dtype=np.uint8)
    y = rng.integers(0, P22["classes"], (n,), dtype=np.int64)
    sums = x.reshape(n, -1).sum(axis=1, dtype=np.int64)
    del x
    lo, hi = P22_CORRUPT * P22["shard"], (P22_CORRUPT + 1) * P22["shard"]
    healthy = np.concatenate([np.arange(lo), np.arange(hi, n)])
    if rec["quarantined"] != [P22_CORRUPT]:
        fail(f"phase 22 (f): quarantined {rec['quarantined']}")
    substituted = 0
    for s in rec["steps"]:
        for j, i in enumerate(s["ids"]):
            src = i
            if lo <= i < hi:
                src = int(healthy[i % healthy.size])
                substituted += 1
            if s["row_sums"][j] != sums[src] or s["labels"][j] != y[src]:
                fail(f"phase 22 (f): step {s['i']} row {j} (id {i}) is not "
                     f"row {src}")
    # the producer runs ahead of the step loop by up to prefetch + 1
    # batches (gathered, so counted, but never consumed): the counter is
    # the consumed samples' substitutions plus those of the first k
    # batches of the next epoch, for one k in 0..3
    from horovod_tpu_torch.data import GlobalSampleIndex

    index = GlobalSampleIndex(n, P22["batch"], seed=P22["seed"])
    ahead = [substituted]
    for k in range(3):
        ids = index.rank_indices(P22["epochs"], k, 0, 1)
        ahead.append(ahead[-1] + int(((ids >= lo) & (ids < hi)).sum()))
    if rec["substituted"] not in ahead:
        fail(f"phase 22 (f): data_samples_substituted "
             f"{rec['substituted']}, the rule predicts {substituted} "
             f"consumed (with the prefetch's run-ahead: one of {ahead})")
    shard = f"shard-{P22_CORRUPT:05d}.npz"
    suspect = [s for s in rec["steps"] if s["health"] == "SUSPECT"
               and shard in s.get("health_reason", "")]
    if not suspect:
        fail(f"phase 22 (f): health never SUSPECT naming {shard}: "
             f"{[s['health'] for s in rec['steps']]}")
    return dict(quarantined=rec["quarantined"], substituted=substituted,
                counter=rec["substituted"], suspect_from_step=suspect[0]["i"],
                reason=suspect[0]["health_reason"], exit_code=0)


def launcher_gpus(n: int, smi: str) -> tuple:
    """Phase 22 across ``n`` GPUs: the worker in ``testing.run_world``
    (the reference), ``hvdrun -np n`` ((a)-(c): every rank on its own GPU,
    every rank's parameters identical and equal to the reference's), and
    (e) at ``n`` ranks, the three side by side (their readings are their
    bits; the one-GPU part times the launched run): ``(record, rank 0's
    logged calls to replay)``."""
    import shutil

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import launcher_phase as LP
    from horovod_tpu_torch.testing import run_world

    t0 = time.perf_counter()
    shutil.rmtree(P22_DIR, ignore_errors=True)
    rec = {}
    try:
        LP.make_dataset(os.path.join(P22_DIR, "store"), P22["images"],
                        P22["side"], P22["classes"], P22["shard"])
        env = _p22_env()
        ref_cfg = p22_cfg("reference", n)
        with open(ref_cfg) as f:
            cfg = json.load(f)
        e_cfg = p22_cfg("failover", n, kill_at=P22_KILL_AT_WORLD)
        a_cfg = p22_cfg("run", n, log_calls=True)
        times: dict = {}

        def reference():
            try:
                return run_world(LP.worker, n, cfg, device=None,
                                 timeout=P22_TIMEOUT, env={k: env[k] for k in (
                                     "CUBLAS_WORKSPACE_CONFIG",
                                     "HOROVOD_SANITIZE", "PYTHONPATH",
                                     "HOROVOD_DATA_CACHE_SHARDS")})
            except RuntimeError as err:
                fail(f"phase 22 at {n} GPUs, run_world: {err}")

        ref, e, a = _p22_side_by_side(
            reference, (hvdrun_argv(n, e_cfg), e_cfg, env,
                        _p22_kill_primary(P22_KILL_AT_WORLD, times)),
            (hvdrun_argv(n, a_cfg), a_cfg, env, None))
        ref_sha = _p22_check_run(f"run_world@{n}", ref, n)["sha"]
        if e["rc"] != 0:
            fail(f"phase 22 (e) at {n}: exit {e['rc']}\n{e.get('log', '')}")
        e_recs = _p22_records(e_cfg, n)
        _p22_check_run(f"(e)@{n}", e_recs, n, want_sha=ref_sha)
        rec["e"] = dict(times, kv=_p22_check_failover(f"(e)@{n}", e_recs),
                        bit_equal=True, job_s=e["seconds"])
        if a["rc"] != 0:
            fail(f"phase 22 (a) at {n}: exit {a['rc']}\n{a.get('log', '')}")
        a_recs = _p22_records(a_cfg, n)
        devices = {r["device"] for r in a_recs}
        if len(devices) != n:
            fail(f"phase 22 (a) at {n}: the ranks ran on {sorted(devices)}")
        rec["a"] = _p22_check_run(f"(a)@{n}", a_recs, n, want_sha=ref_sha)
        rec["a"].update(_p22_stats(f"(a)@{n}", a, a_recs, n))
        rec["a"]["devices"] = sorted(devices)
        calls = p22_replay_calls(a_recs[0])
    finally:
        shutil.rmtree(P22_DIR, ignore_errors=True)
    rec["seconds"] = time.perf_counter() - t0
    return rec, calls


def launcher_kernel_rows(label: str, calls: list) -> dict:
    """The kernel phase's replay of phase 22's logged calls under
    ``label`` (in a world of one); ``{kernel: its by_mode row}``."""
    import horovod_tpu_torch as hvd

    hvd.init()
    try:
        rows = kernel_phase({label: calls},
                            {k: (label,) for k in TPU_KERNELS})
    finally:
        hvd.shutdown()
    return {k: r["by_mode"][label] for k, r in rows.items()
            if label in r["by_mode"]}


def print_launcher(p22: dict, smi: str, z1_img_s=None, note="") -> None:
    a = p22["a"]
    print(f"phase 22 (one GPU, hvdrun -np 1 --kv-standbys 1, ResNet-50 "
          f"ZeRO-1 + int8 + EF + inject_hyperparams(fused_adam), "
          f"{P22['images']} images of {P22['side']}x{P22['side']}x3 in "
          f"{p22['dataset']['shards']} shards, batch {P22['batch']}, "
          f"{P22['epochs']} epochs): launch to first step "
          f"{a['launch_to_first_step_s']:.3f} s (by part "
          f"{json.dumps(a['startup_s'])}); loader-fed "
          f"{a['img_per_s_per_gpu']:.2f} img/s a GPU over the second "
          f"epoch's wall time, the store's default shard cache (its steps "
          f"alone {a['step_img_per_s_per_gpu']:.2f}; phase 4's synthetic "
          f"ZeRO-1: {'not run' if z1_img_s is None else f'{z1_img_s:.2f}'})"
          f"; wait for a batch p50 {a['wait_p50_ms']:.3f} ms, max "
          f"{a['wait_max_ms']:.3f} ms; copy to the card "
          f"{a['copy_ms'] or 0:.3f} ms a batch ({a['copy_bytes']} bytes); peak "
          f"{a['peak_gib']:.2f} GiB; (d) resumed at step "
          f"{p22['d']['resumed_at']} bit-equal; (e) kill to promotion "
          f"{p22['e']['kill_to_promotion_s']:.3f} s, bit-equal; (f) "
          f"{p22['f']['substituted']} samples substituted from shard "
          f"{P22_CORRUPT}; phase {p22['seconds']:.1f} s{note} ({smi})",
          flush=True)
    print(f"phase 22: {json.dumps(p22)}", flush=True)


def print_launcher_world(rec: dict, n: int, smi: str) -> None:
    a = rec["a"]
    print(f"phase 22 at {n} GPUs (hvdrun -np {n}, ranks on "
          f"{a['devices']}): every rank's parameters identical and equal "
          f"to testing.run_world's (the launched run, run_world and (e) "
          f"side by side on the same GPUs: no rate is a reading); peak "
          f"{a['peak_gib']:.2f} GiB; (e) kill to promotion "
          f"{rec['e']['kill_to_promotion_s']:.3f} s, bit-equal; "
          f"{rec['seconds']:.1f} s ({smi})", flush=True)
    print(f"phase 22 at {n} GPUs: {json.dumps(rec)}", flush=True)


# --------------------------------------------------------------------------
# phase 23: the TensorFlow, Keras, MXNet and Spark frontends, the estimator

P23_DIR = os.path.join(ROOT, "_smoke_frontends")
#: (c)'s bar: the largest difference between the card's fitted weights and
#: the CPU's (plain PyTorch, the same seed and shards), over the CPU
#: weights' largest magnitude; the control (the CPU fit on another
#: shuffle seed) must lie outside it
P23_WEIGHT_RTOL = 1e-4
P23_TIMEOUT = 600


def _p23_tool():
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import frontends_phase as FP

    return FP


def _p23_estimator(n: int) -> dict:
    """(c): ``TorchEstimator`` fits tools/frontends_phase.py's MLP on its
    DataFrame at ``num_proc=n`` (``n`` > 1: through ``run.run``, one
    process a GPU, the worker wrapped to report every rank's parameters'
    digest) and transforms rows; its weights and epoch losses against
    the same fit on the CPU (plain PyTorch), TF32 off."""
    import copy
    import shutil

    import numpy as np
    import torch

    from horovod_tpu_torch.data import LocalStore
    from horovod_tpu_torch.estimator import TorchEstimator

    FP = _p23_tool()
    est = FP.EST
    df = FP.est_frame()
    init = FP.est_model()
    model = copy.deepcopy(init)

    class EveryRank(TorchEstimator):
        def _make_train_fn(self, run_id):
            import functools

            return functools.partial(FP.every_rank,
                                     super()._make_train_fn(run_id))

        def _make_model(self, result, run_id):
            self.rank_shas = result["rank_shas"]
            self.devices = result["devices"]
            return super()._make_model(result, run_id)

    directory = os.path.join(P23_DIR, f"est{n}")
    shutil.rmtree(directory, ignore_errors=True)
    env = dict(os.environ, NVIDIA_TF32_OVERRIDE="0", PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.path.join(ROOT, "tools"),
                    os.environ.get("PYTHONPATH")) if p))
    fit = (TorchEstimator if n == 1 else EveryRank)(
        model=model, optimizer=torch.optim.SGD(model.parameters(),
                                               lr=est["lr"]),
        loss=torch.nn.functional.mse_loss,
        feature_cols=[f"f{i}" for i in range(est["features"])],
        label_cols=["label"], batch_size=est["batch"], epochs=est["epochs"],
        num_proc=n, store=LocalStore(directory), seed=est["seed"], env=env)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    try:
        fitted = fit.fit(df)
        fit_s = time.perf_counter() - t0
        pred = fitted.transform(df.head(256))["label_pred"].to_numpy()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
        shutil.rmtree(directory, ignore_errors=True)
    got = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    ref, ctrl = copy.deepcopy(init), copy.deepcopy(init)
    ref_hist = FP.plain_fit(ref, df, n, est["seed"])
    FP.plain_fit(ctrl, df, n, est["seed"] + 1)

    def rel(m):
        w = m.state_dict()
        top = max(float(v.abs().max()) for v in w.values())
        return max(float((got[k] - v).abs().max()) for k, v in w.items()) / top

    err, ctrl_err = rel(ref), rel(ctrl)
    label = f"phase 23 (c) num_proc={n}"
    if not err <= P23_WEIGHT_RTOL < ctrl_err:
        fail(f"{label}: the card's weights lie {err:.3g} from the CPU fit's "
             f"(bar {P23_WEIGHT_RTOL}; the control {ctrl_err:.3g})")
    if not np.allclose(fitted.history_, ref_hist, rtol=1e-4) or \
            not np.isfinite(pred).all():
        fail(f"{label}: losses {fitted.history_} vs the CPU's {ref_hist}")
    out = dict(num_proc=n, fit_s=fit_s, losses=fitted.history_,
               cpu_losses=ref_hist, weight_rel_err=err,
               control_rel_err=ctrl_err, bar=P23_WEIGHT_RTOL,
               rows=est["rows"], epochs=est["epochs"])
    if n > 1:
        if len(set(fit.rank_shas)) != 1:
            fail(f"{label}: the ranks' parameters differ ({fit.rank_shas})")
        if sorted(fit.devices) != [f"cuda:{r}" for r in range(n)]:
            fail(f"{label}: the ranks ran on {fit.devices}")
        out.update(ranks_identical=True, devices=fit.devices)
    return out


def frontends_phase(smi: str) -> dict:
    """Phase 23 on one GPU: the package probe; (a) the MXNet bridge in a
    world of one, every collective handed a tensor on ``cuda:0``, every
    result its input's kind and numpy's; (c) with pandas and pyarrow,
    ``TorchEstimator`` at ``num_proc=1``."""
    import horovod_tpu_torch as hvd

    FP = _p23_tool()
    t0 = time.perf_counter()
    rec = {"probe": FP.run_probe()}
    print(f"phase 23 probe: {json.dumps(rec['probe'])} ({smi})", flush=True)
    hvd.init()
    try:
        a = FP.mxnet_ops(0, 1)
    finally:
        hvd.shutdown()
    bad = FP.check_mxnet(a, 1, "cuda:0")
    if bad:
        fail(f"phase 23 (a): {bad}")
    rec["a"] = dict(collectives=len(a["devices"]),
                    devices=sorted({d for _, d in a["devices"]}),
                    kinds=a["kinds"], exact=True)
    if rec["probe"]["pandas"] and rec["probe"]["pyarrow"]:
        rec["c"] = _p23_estimator(1)
    else:
        rec["c"] = "not run: pandas and pyarrow do not both import here"
    rec["seconds"] = time.perf_counter() - t0
    return rec


def frontends_gpus(n: int, probe: dict, smi: str) -> dict:
    """Phase 23 across ``n`` GPUs: (b) a Spark barrier job of ``n``
    processes without Spark (``testing.run_barrier_job``), each forming
    the world from ``spark._run_barrier_slot``'s environment on
    ``cuda:<local_rank>``; the MXNet bridge exact on every rank; with
    TensorFlow and Keras, the TF frontend's Adasum of an f32 delta and of
    the same through its bf16 wire identical on every rank, each
    launching B8 (``adasum_pair_combine``: one tensor a call, whatever
    its type; B9 is the grouped route); (c) with pandas and pyarrow,
    ``TorchEstimator(num_proc=n)`` through ``run.run``."""
    import numpy as np

    from horovod_tpu_torch.testing import run_barrier_job

    FP = _p23_tool()
    with_tf = bool(probe["tensorflow"] and probe["keras"]
                   and probe.get("keras_backend") == "tensorflow")
    t0 = time.perf_counter()
    try:
        res = run_barrier_job(FP.slot_fn, n, with_tf, timeout=P23_TIMEOUT)
    except RuntimeError as e:
        fail(f"phase 23 (b) at {n} GPUs: {e}")
    b_s = time.perf_counter() - t0
    for r, got in enumerate(res):
        dev = f"cuda:{got['local_rank']}"
        if (got["rank"], got["size"], got["device"]) != (r, n, dev):
            fail(f"phase 23 (b): task {r} is rank {got['rank']} of "
                 f"{got['size']} on {got['device']}")
        bad = FP.check_mxnet(got["mxnet"], n, dev)
        if bad:
            fail(f"phase 23 (b) rank {r}: {bad}")
    devices = sorted(got["device"] for got in res)
    if len(set(devices)) != n:
        fail(f"phase 23 (b): the ranks ran on {devices}")
    rec = {"b": dict(ranks=n, devices=devices, exact=True, job_s=b_s)}
    launches = {}
    if with_tf:
        for wire in ("f32", "bf16"):
            kernel = "adasum_pair_combine"
            vals = [got["tf"][wire]["value"] for got in res]
            if not all(np.array_equal(v, vals[0]) for v in vals) or \
                    not np.isfinite(vals[0]).all():
                fail(f"phase 23 (b): the TF Adasum ({wire}) differs between "
                     "ranks or is not finite")
            counts = [got["tf"][wire]["launches"] for got in res]
            if any(c != counts[0] for c in counts) or \
                    not counts[0].get(kernel):
                fail(f"phase 23 (b): the TF Adasum ({wire}) launched "
                     f"{counts}, not {kernel}")
            for k, v in counts[0].items():
                launches[k] = launches.get(k, 0) + v
        rec["b"]["tf_adasum"] = dict(identical=True, launches=launches)
    else:
        rec["b"]["tf_adasum"] = "not run: TensorFlow with Keras on its " \
                                "TensorFlow backend does not import here"
    rec["launches"] = launches
    if probe["pandas"] and probe["pyarrow"]:
        rec["c"] = _p23_estimator(n)
    else:
        rec["c"] = "not run: pandas and pyarrow do not both import here"
    rec["seconds"] = time.perf_counter() - t0
    return rec


def print_frontends(rec: dict, smi: str) -> None:
    a, c = rec["a"], rec["c"]
    est = c if isinstance(c, str) else (
        f"TorchEstimator num_proc=1 fit {c['fit_s']:.2f} s, weights within "
        f"{c['weight_rel_err']:.3g} of the CPU fit's largest magnitude (bar "
        f"{c['bar']}; the control {c['control_rel_err']:.3g}), losses "
        f"{c['losses']} (CPU {c['cpu_losses']})")
    print(f"phase 23 (one GPU, the frontends): (a) the MXNet bridge, "
          f"{a['collectives']} collectives handed tensors on "
          f"{a['devices']}, results {a['kinds']} equal to numpy; (c) {est}; "
          f"phase {rec['seconds']:.1f} s ({smi})", flush=True)
    print(f"phase 23: {json.dumps(rec)}", flush=True)


def print_frontends_world(rec: dict, n: int, smi: str,
                          beside: bool = False) -> None:
    b, c = rec["b"], rec["c"]
    est = c if isinstance(c, str) else (
        f"TorchEstimator num_proc={n} through run.run on {c['devices']}: "
        f"every rank's parameters identical, within "
        f"{c['weight_rel_err']:.3g} of the CPU's {n}-shard fit (bar "
        f"{c['bar']}; the control {c['control_rel_err']:.3g}), fit "
        f"{c['fit_s']:.2f} s")
    print(f"phase 23 at {n} GPUs: (b) a barrier job of {n} processes on "
          f"{b['devices']}, the MXNet bridge exact on every rank, TF "
          f"Adasum {json.dumps(b['tf_adasum'])}, job {b['job_s']:.1f} s; "
          f"(c) {est}; phase {rec['seconds']:.1f} s"
          + (" (side by side with phase 22's jobs: no time is a reading)"
             if beside else "") + f" ({smi})", flush=True)
    print(f"phase 23 at {n} GPUs: {json.dumps(rec)}", flush=True)


def one_gpu_children(gpu: int) -> dict:
    """With ``--gpus N``: phase 10's checkpoint child, phase 19's
    preemption children and phase 20's children, one after another on
    card ``gpu`` alone, side by side with the phases this process drives
    on ``cuda:0`` (their checks are bits; their times are no readings)."""
    return {"ckpt": checkpoint_phase(gpu), "preemption": preemption_phase(gpu),
            "p20": observability_phase(gpu)}


def _summary(run: dict) -> str:
    return json.dumps({k: v for k, v in run.items() if k != "step_calls"})


def main() -> None:
    if len(sys.argv) > 1 and sys.argv[1] == "--cpu-reference":
        sys.path.insert(0, ROOT)
        cpu_reference()
        return
    if len(sys.argv) > 2 and sys.argv[1] == "--checkpoint":
        sys.path.insert(0, ROOT)
        checkpoint_child(sys.argv[2])
        return
    if len(sys.argv) > 3 and sys.argv[1] == "--preempt":
        sys.path.insert(0, ROOT)
        preempt_child(sys.argv[2], sys.argv[3])
        return
    if len(sys.argv) > 3 and sys.argv[1] == "--observe":
        sys.path.insert(0, ROOT)
        observe_child(sys.argv[2], sys.argv[3])
        return
    gpus = 1
    if len(sys.argv) > 2 and sys.argv[1] == "--gpus":
        gpus = int(sys.argv[2])
    global T0
    T0 = time.perf_counter()

    import torch

    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a GPU")
    if torch.cuda.device_count() < gpus:
        fail(f"--gpus {gpus}: only {torch.cuda.device_count()} GPUs")
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        fail(f"nvidia-smi: {e}")
    print(smi, flush=True)

    sys.path.insert(0, ROOT)
    try:
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch.models import ResNet50
        from horovod_tpu_torch.ops import _build, kernels as K
    except ImportError as e:
        fail(f"horovod_tpu_torch is not importable next to chip_smoke.py: {e}")

    try:
        release = subprocess.run([_build.nvcc(), "--version"],
                                 capture_output=True, text=True, timeout=60,
                                 check=True).stdout.strip().splitlines()[-2]
    except (OSError, RuntimeError, subprocess.SubprocessError, IndexError) as e:
        fail(f"nvcc: {e}")
    print(f"nvcc: {release}", flush=True)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        core_build = ex.submit(lambda: (_build.core_library(),
                                        time.perf_counter() - t0))
        report = _build.build_all()
        try:
            _, core_s = core_build.result()
        except (OSError, RuntimeError) as e:
            fail(f"native core build: {e}")
    print(f"build: {time.perf_counter() - t0:.2f} s "
          + ", ".join(f"{n} {r['seconds']:.2f} s" for n, r in report.items())
          + f", native core (g++) {core_s:.2f} s", flush=True)
    usage = {n: ptxas_usage(r["log"]) for n, r in report.items()}
    print(f"ptxas: {json.dumps(usage)}", flush=True)

    # with --gpus N the one-GPU phases that run in child processes go side
    # by side on the spare cards: 10, 19's preemption and 20 on cuda:1,
    # 22 on cuda:2 (cuda:1 at N = 2)
    children = launched = None
    side_note = ""
    if gpus > 1:
        pool = concurrent.futures.ThreadPoolExecutor(2)
        children = pool.submit(one_gpu_children, 1)
        launched = pool.submit(launcher_phase, smi, min(2, gpus - 1))
        pool.shutdown(wait=False)
        side_note = (" (side by side with the one-GPU phases on cuda:0, on "
                     "a card of its own: its times are no readings)")
    cpu = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--cpu-reference"], capture_output=True, text=True,
                         timeout=300)
    if cpu.returncode != 0:
        fail(f"CPU reference run failed:\n{cpu.stderr[-2000:]}")
    ref = json.loads(cpu.stdout.strip().splitlines()[-1])
    hvd.init()
    try:
        got = small_run(hvd.device())
        # f32 on both sides with TF32 off: the convolutions sum in another
        # order, and the int8 wire may turn that into one quantum of
        # difference in a few gradient elements
        if not all(abs(a - b) <= 2e-3 * abs(b) + 1e-4 for a, b in zip(got, ref)):
            fail(f"small input: GPU losses {got} vs CPU {ref}")
        print(f"small input: GPU losses {got}, CPU losses {ref}", flush=True)
        torch.backends.cudnn.allow_tf32 = True

        gen = torch.Generator(device=hvd.device()).manual_seed(0)
        x = torch.randn(64, 224, 224, 3, device=hvd.device(), generator=gen)
        y = torch.randint(0, 1000, (64,), device=hvd.device(), generator=gen)
        runs = [train("zero1", 10, x, y), train("allreduce", 5, x, y),
                train("zero3", 10, x, y), train("adasum", 5, x, y)]
        runs += [train(mode, 5, x, y, bucket_bytes=bb)
                 for mode, bb in OVERLAP_RUNS]
        # hierarchical sync on a 1 x 1 host mesh, and bucketed ZeRO-3
        runs += [train("allreduce_hier", 5, x, y),
                 train("zero3", 5, x, y, bucket_bytes=ZERO3_BUCKET),
                 train("zero3_exact", 4, x, y),
                 train("zero3_exact", 4, x, y, bucket_bytes=ZERO3_BUCKET)]
        runs.append(train_multisteps(4, x, y))
        for name, mode, lr in ZOO_RUNS:     # the other scaling models
            side = MODELS[name][1]
            xm = x if side == 224 else torch.randn(
                64, side, side, 3, device=hvd.device(), generator=gen)
            runs.append(train(mode, 5, xm, y, model_name=name, lr=lr))
            del xm
            torch.cuda.empty_cache()
        by_mode = {run["mode"]: run for run in runs}
        for mode, bb in (("zero1", None), ("allreduce", None),
                         ("allreduce", OVERLAP_RUNS[0][1])):
            base = by_mode[overlap_label(mode, bb) if bb else mode]
            runs.append(train_guarded(mode, x, y, bucket_bytes=bb, base=base))
            torch.cuda.empty_cache()
        runs.append(train_bf16_guarded(x, y))
        torch.cuda.empty_cache()
        x = torch.randn(128, 224, 224, 3, device=hvd.device(), generator=gen)
        y = torch.randint(0, 1000, (128,), device=hvd.device(), generator=gen)
        replay = adasum_replay(x, y)
        del x, y
        torch.cuda.empty_cache()
        runs.append(train_lm(LM_STEPS))
        torch.cuda.empty_cache()
        runs.append(train_lm(LM_STEPS, loss_scale="dynamic"))
        torch.cuda.empty_cache()
        runs.append(train_lm(4, powersgd_rank=PSGD_RANK))
        torch.cuda.empty_cache()
        # phase 18 on a mesh of one
        par_runs = parallel_phase(lambda run: print_parallel([run], smi))
        torch.cuda.empty_cache()
    finally:
        hvd.shutdown()
    for run in runs:
        print(f"e2e {run['mode']}: {_summary(run)}", flush=True)
    runs += par_runs
    by_mode = {run["mode"]: run for run in runs}
    for name, mode, _ in ZOO_RUNS:
        run = by_mode[f"{name}_{mode}"]
        print(f"e2e {run['mode']}: {run['img_per_s']:.2f} img/s per GPU, "
              f"peak {run['peak_gib']:.2f} GiB, {run['leaves']} leaves, "
              f"{run['params']} parameters, launches a step "
              f"{json.dumps({k: v / run['steps'] for k, v in run['launches'].items() if v})} "
              f"({smi})", flush=True)
    torch.cuda.empty_cache()
    print(f"elapsed after phases 4-9, 16-18: {time.perf_counter() - T0:.1f}"
          " s", flush=True)
    ckpt = children.result()["ckpt"] if children else checkpoint_phase()
    print(f"checkpoint (one GPU, ResNet-50 ZeRO-1 + int8 + EF): "
          f"{json.dumps(ckpt)}{side_note} ({smi})", flush=True)
    torch.cuda.empty_cache()
    front = frontend_core_phase()
    print(f"frontend named ops through the native core (one GPU, ResNet-50 "
          f"batch 64, 161 gradients from post-accumulate-grad hooks): "
          f"{json.dumps(front)} ({smi})", flush=True)
    torch.cuda.empty_cache()
    print(f"elapsed after phases 10-12: {time.perf_counter() - T0:.1f} s",
          flush=True)
    p19 = resilience_phase(
        (lambda: children.result()["preemption"]) if children
        else preemption_phase)
    print(f"resilience (phase 19, one GPU, ResNet-50 ZeRO-1 + int8 + EF + "
          f"fused Adam, batch {P19_BATCH}): preemption "
          f"{json.dumps(p19['preemption'])}{side_note}; rollback "
          f"{json.dumps(p19['rollback'])}; retry {json.dumps(p19['retry'])}; "
          f"phase {p19['seconds']:.1f} s ({smi})", flush=True)
    torch.cuda.empty_cache()
    p20 = children.result()["p20"] if children else observability_phase()
    print(f"observability (phase 20, one GPU, ResNet-50 ZeRO-1 + int8 + EF + "
          f"fused Adam, batch {P19_BATCH}, {OBS_STEPS} steps, every plane "
          f"on against none): instrumented {p20['instrumented_ms_per_step']:.3f}"
          f" ms a step (median {p20['instrumented_median_ms_per_step']:.3f}),"
          f" plain {p20['plain_ms_per_step']:.3f} (median "
          f"{p20['plain_median_ms_per_step']:.3f}); {json.dumps(p20)}"
          f"{side_note} ({smi})", flush=True)
    torch.cuda.empty_cache()
    hvd.init()
    try:
        p21, serve_delta_calls, serve_traffic = serving_phase(smi)
    finally:
        hvd.shutdown()
    print_serving(p21, smi)
    print(f"elapsed after phase 21: {time.perf_counter() - T0:.1f} s",
          flush=True)
    torch.cuda.empty_cache()
    p23 = frontends_phase(smi)
    print_frontends(p23, smi)
    print(f"elapsed after phase 23: {time.perf_counter() - T0:.1f} s",
          flush=True)
    p22, p22_calls = launched.result() if launched else launcher_phase(smi)
    print_launcher(p22, smi, by_mode["zero1"]["img_per_s"], side_note)
    print(f"elapsed after phase 22: {time.perf_counter() - T0:.1f} s",
          flush=True)
    ar = by_mode["allreduce"]
    print(f"e2e allreduce: NCCL calls a step in the optimizer update "
          f"{json.dumps(ar['nccl_calls']['update'])}, "
          f"{sum(ar['nccl_calls']['update'].values()):g} in all (expected "
          f"{ar['nccl_update_want']}); in the rest of the step (running "
          f"stats, loss) {json.dumps(ar['nccl_calls'].get('step', {}))}",
          flush=True)
    z1, z3 = by_mode["zero1"], by_mode["zero3"]
    print(f"e2e zero3 (int8 gather): {z3['img_per_s']:.2f} img/s per GPU, "
          f"peak {z3['peak_gib']:.2f} GiB; zero1: {z1['img_per_s']:.2f} img/s, "
          f"peak {z1['peak_gib']:.2f} GiB ({smi})", flush=True)
    print_hier_zero3(by_mode, smi)
    print(f"e2e adasum: {by_mode['adasum']['img_per_s']:.2f} img/s per GPU; "
          "at a world of one the butterfly has no level, so no Adasum kernel "
          "runs: the level-1 replay and --gpus N launch them", flush=True)
    print(f"adasum level-1 replay: {_summary(replay)}", flush=True)
    if gpus == 1:
        print("adasum_pair_combine and adasum_segment_combine: no run on one "
              "GPU launches them; their launches, shapes and per-step numbers "
              "below are the level-1 replay's (grouped, and per leaf in bf16)",
              flush=True)
    lm = by_mode["lm"]
    print(f"e2e lm: {lm['tokens_per_s']:.1f} tokens/s per GPU over steps "
          f"2-{lm['steps']} ({smi}; TF32 off for matmuls)", flush=True)
    print_overlap(by_mode, "", smi)
    ms = by_mode["multisteps"]
    print(f"e2e multisteps (backward_passes_per_step=2, allreduce mode int8 "
          f"+ EF): per step {json.dumps(ms['per_step'])}, losses "
          f"{ms['losses']}; under the guard, host syncs in the guard's code "
          f"by update {json.dumps(ms['guard_host_syncs'])} (the verdict's "
          f"one read for the host counters) ({smi})", flush=True)
    print_guarded(by_mode, smi)
    lp = by_mode["lm_powersgd"]
    print(f"e2e lm_powersgd (rank {PSGD_RANK}, EF, adamw): "
          f"{lp['tokens_per_s']:.1f} tokens/s per GPU (plain adamw "
          f"{lm['tokens_per_s']:.1f}), losses {lp['losses']}, "
          f"{json.dumps(lp['powersgd'])} ({smi})", flush=True)
    step_calls = {run["mode"]: run["step_calls"] for run in runs}
    step_calls.update(replay["step_calls"])
    # phase 21: the handoff's training (B6) and its delta's B1 calls
    step_calls["serve_delta"] = serve_delta_calls
    for mode, k, n in (("serve_handoff", "flash_fwd",
                        p21["handoff"]["flash_fwd_launches"]),
                       ("serve_delta", "quantize", len(serve_delta_calls))):
        runs.append(dict(mode=mode, launches={
            name: n if name == k else 0 for name in K.KERNELS}))
    # phase 22: the launched worker's B1/B3/B5 calls, each step's own lr
    step_calls["hvdrun@1"] = p22_calls
    runs.append(dict(mode="hvdrun@1", launches={
        name: p22["a"]["launches"].get(name, 0) for name in K.KERNELS}))
    if gpus > 1:
        torch.cuda.empty_cache()
        try:
            world_runs, world_ckpt, z3_moved = run_gpus(gpus, WORLD_MODES)
            print(f"elapsed after the {gpus}-GPU world runs: "
                  f"{time.perf_counter() - T0:.1f} s", flush=True)
            one = restore_world_of_one(CKPT_DIR)
        finally:
            import shutil

            shutil.rmtree(CKPT_DIR, ignore_errors=True)
        print(f"checkpoint at {gpus} GPUs: {json.dumps(world_ckpt)}; restored "
              f"in a world of one: {json.dumps(one)}", flush=True)
        print(f"zero3 checkpoint (bucketed {ZERO3_BUCKET >> 20} MiB, int8 "
              f"gather) of {gpus} GPUs restored at 2 and back at {gpus}: "
              f"{json.dumps(z3_moved)} ({smi})", flush=True)
        for run in world_runs:
            run["mode"] = f"{run['mode']}@{gpus}"
            print(f"e2e {gpus} GPUs {run['mode']}: {_summary(run)}", flush=True)
            print(f"e2e {run['mode']}: {run['img_per_s']:.2f} img/s per GPU, "
                  f"peak {run['peak_gib']:.2f} GiB ({smi})", flush=True)
            step_calls[run["mode"]] = run["step_calls"]
            runs.append(run)
        print_overlap({r["mode"]: r for r in world_runs}, f"@{gpus}", smi)
        for mode in HIER_MODES:
            run = next(r for r in world_runs if r["mode"] == f"{mode}@{gpus}")
            flat = next(r for r in world_runs if r["mode"] == (
                mode.replace("_hier", "") + f"@{gpus}"))
            print(f"e2e {run['mode']} ({gpus // HIER_LOCAL} x {HIER_LOCAL} "
                  f"host mesh, axis=('cross', 'local')): "
                  f"{run['img_per_s']:.2f} img/s per GPU ({flat['mode']}, "
                  f"same run: {flat['img_per_s']:.2f}); losses "
                  f"{run['losses']}; NCCL calls and bytes sent a step by "
                  f"group {json.dumps(run['nccl_by_group'])}; launches a step "
                  f"{json.dumps({k: v / run['steps'] for k, v in run['launches'].items() if v})} "
                  f"({smi})", flush=True)
        psgd = next(r for r in world_runs if r["mode"] == f"powersgd@{gpus}")
        meta = ResNet50(device="meta").jax_params()
        print(f"e2e powersgd@{gpus} (ResNet-50, rank {PSGD_RANK}, EF, fused "
              f"Adam): {psgd['img_per_s']:.2f} img/s per GPU, losses "
              f"{psgd['losses']}, factorized {psgd['factorized']}, "
              f"{json.dumps(wire_bytes(meta, hvd.Compression.powersgd(PSGD_RANK)))}"
              f", NCCL calls a step in the update "
              f"{json.dumps(psgd['nccl_calls']['update'])} ({smi})",
              flush=True)
        torch.cuda.empty_cache()
        pass_s = []
        for _ in range(FRONTEND_PASSES):    # the frontend world that hung
            t0 = time.perf_counter()
            front_runs, sync_bn = run_frontend_gpus(gpus)
            pass_s.append(time.perf_counter() - t0)
        print(f"frontend at {gpus} GPUs (phase 12): {len(pass_s)} passes, "
              f"each the world without the core and the one with it, "
              f"seconds {json.dumps(pass_s)}; no pass hung", flush=True)
        functional = next(r for r in runs if r["mode"] == f"allreduce@{gpus}")
        for run in front_runs:
            print(f"e2e {run['mode']}: {_summary(run)}", flush=True)
            print(f"e2e {run['mode']}: {run['img_per_s']:.2f} img/s per GPU "
                  f"(SGD momentum, hook DistributedOptimizer; the functional "
                  f"DistributedOptimizer's allreduce mode, int8 + EF + fused "
                  f"Adam, in the same run: {functional['img_per_s']:.2f}); "
                  f"plans a step {run['plans'] and run['plans'] / run['steps']}"
                  f", NCCL calls a step "
                  f"{json.dumps({k: v / run['steps'] for k, v in run['nccl_calls'].items()})} "
                  f"({smi})", flush=True)
            if any(run["launches"][k] for k in ("adasum_pair_combine",
                                                "adasum_segment_combine")):
                step_calls[run["mode"]] = run["step_calls"]
            runs.append(run)
        torch.cuda.empty_cache()
        print(f"elapsed after phase 12 at {gpus} GPUs: "
              f"{time.perf_counter() - T0:.1f} s", flush=True)
        par_world = run_parallel_gpus(gpus)
        print_parallel(par_world, smi)
        for run in par_world:
            step_calls[run["mode"]] = run["step_calls"]
        runs += par_world
        torch.cuda.empty_cache()
        print(f"elapsed after phase 18 at {gpus} GPUs: "
              f"{time.perf_counter() - T0:.1f} s", flush=True)
        elastic_rec, elastic_run, elastic_calls = elastic_gpus(gpus)
        step_calls[f"elastic@{gpus - 1}"] = elastic_calls
        runs.append(elastic_run)
        z1 = {r["mode"]: r["img_per_s"] for r in runs
              if r["mode"] in ("zero1", f"zero1@{gpus}")}
        print(f"elastic {gpus} -> {gpus - 1} -> {gpus} (phase 19, ResNet-50 "
              f"ZeRO-1 + int8 + EF + fused Adam, {ELASTIC_SPEC}): "
              f"{json.dumps(elastic_rec)}; phase 4's ZeRO-1 img/s per GPU "
              f"{json.dumps(z1)} ({smi})", flush=True)
        torch.cuda.empty_cache()
        print(f"elapsed after phase 19 at {gpus} GPUs: "
              f"{time.perf_counter() - T0:.1f} s", flush=True)
        p20_world = drills_gpus(gpus)
        torch.cuda.empty_cache()
        print(f"elapsed after phase 20 at {gpus} GPUs: "
              f"{time.perf_counter() - T0:.1f} s", flush=True)
        p21_tp = serving_tp_gpus(gpus, serve_traffic)
        print(f"phase 21 (f) TP engine over a tp axis of {gpus} (flagship LM, "
              f"generation 2, bf16): teacher-forced logits within "
              f"{max(p21_tp['rel']):.4g} of the one-GPU engine's largest "
              f"magnitude (bar {TP_LOGIT_RTOL}; the control, one perturbed "
              f"weight, {p21_tp['control_rel']:.4g}); decode "
              f"{p21_tp['decode_tokens_per_s_per_gpu']:.1f} tokens/s a GPU; "
              f"{json.dumps(p21_tp)} ({smi})", flush=True)
        torch.cuda.empty_cache()
        # phase 22's jobs and phase 23's side by side on the N cards
        with concurrent.futures.ThreadPoolExecutor(1) as ex:
            p23_f = ex.submit(frontends_gpus, gpus, p23["probe"], smi)
            p22_world, p22_wcalls = launcher_gpus(gpus, smi)
            p23_world = p23_f.result()
        print_launcher_world(p22_world, gpus, smi)
        print_frontends_world(p23_world, gpus, smi, beside=True)
        step_calls[f"hvdrun@{gpus}"] = p22_wcalls
        runs.append(dict(mode=f"hvdrun@{gpus}", launches={
            name: p22_world["a"]["launches"].get(name, 0)
            for name in K.KERNELS}))
        if p23_world["launches"]:
            runs.append(dict(mode=f"frontends@{gpus}", launches={
                name: p23_world["launches"].get(name, 0)
                for name in K.KERNELS}))
        print(f"elapsed after phases 22-23 at {gpus} GPUs: "
              f"{time.perf_counter() - T0:.1f} s", flush=True)
        for drill, rec in p20_world.items():
            print(f"phase 20 {drill} drill at {gpus} GPUs (elastic ResNet-50 "
                  f"ZeRO-1, every plane on): onset -> verdict "
                  f"{rec['onset_to_verdict_s']:.3f} s, verdict -> eviction "
                  f"{rec['verdict_to_eviction_s']:.3f} s; {json.dumps(rec)} "
                  f"({smi})", flush=True)
        print(f"SyncBatchNorm at [64, 64, 112, 112] per GPU against "
              f"BatchNorm2d over the gathered batch, largest difference over "
              f"the reference's largest magnitude (bar {SYNC_BN_RTOL}), in "
              f"the world without the core and the world with it: "
              f"{json.dumps(sync_bn)} ({smi})", flush=True)

    meta = list(ResNet50(device="meta").jax_params().values())
    step_calls[PER_LEAF] = per_leaf_calls(meta, 1)
    L = sum(v.numel() for v in meta)
    flat_buffer_checks(L)
    epilogue = adam_epilogue_check(L)
    print(f"fused_adam requant epilogue agrees bit for bit: "
          f"{json.dumps(epilogue)}", flush=True)
    rows = kernel_phase(step_calls, main_modes(gpus))
    for name, r in rows.items():
        print(f"kernel {name}: {json.dumps(r)}", flush=True)
    extra = flash_extra_checks()
    print(f"flash_fwd extra shapes agree: {extra}", flush=True)
    print(f"adasum extra checks agree: {adasum_extra_checks()}", flush=True)
    flash_sigs = [s for s in lm["step_calls"] if s[0] == "flash_fwd"]
    flash = rows["flash_fwd"]
    # the same calls' bound at the f32 rate outside the tensor cores, the
    # arithmetic the kernel uses
    flash["bound_f32_ms"] = 1e3 * sum(
        max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)
        for nbytes, ops, _ in map(call_bound, flash_sigs))
    flash["plain_bwd_ms"] = flash_bwd_ms(flash_sigs)
    print(f"lm step split (s): {json.dumps(lm['split_s'])}, sum "
          f"{lm['split_step_s']:.4f}; per step: "
          f"flash_fwd {flash['ms']:.3f} ms, its plain backward "
          f"{flash['plain_bwd_ms']:.3f} ms ({len(flash_sigs)} calls)", flush=True)

    kernels = []
    for name in K.KERNELS:
        r = rows[name]
        by_mode = {run["mode"]: run["launches"][name] for run in runs}
        if not any(by_mode.values()):   # the Adasum combines on one GPU
            by_mode[replay["mode"]] = replay["launches"][name]
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=TPU_KERNELS[name], launches=sum(by_mode.values()),
            launches_by_mode=by_mode,
            max_abs_err=r["max_abs_err"], ms=r["ms"], kernel_ms=r["ms"],
            device_ms=r["device_ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"]))
        if "two_pass_bound_ms" in r:
            kernels[-1]["two_pass_bound_ms"] = r["two_pass_bound_ms"]
        for mode in YARDSTICKS:           # the calls before they were fused
            if mode in r["by_mode"]:
                kernels[-1]["per_leaf_yardstick"] = r["by_mode"][mode]
    next(k for k in kernels if k["name"] == "flash_fwd").update(
        bound_f32_ms=flash["bound_f32_ms"],
        library="F.scaled_dot_product_attention (no lse)",
        tensor_core_route="mma.sync (m16n8k16 bf16, P split hi/lo; "
                          "cp.async double buffer; bf16 inputs)",
        ptxas=usage["flash_attention"])
    next(k for k in kernels
         if k["name"] == "dequant_accumulate_requantize").update(
        ptxas=usage["int8_wire"])
    next(k for k in kernels if k["name"] == "quantize").update(
        serve_delta=rows["quantize"]["by_mode"]["serve_delta"])
    next(k for k in kernels if k["name"] == "fused_adam").update(
        launch_cap=K.ADAM_MAX_LEAVES, requant_epilogue=epilogue,
        ptxas=usage["fused_adam"])
    for k in kernels:                     # phase 20's instrumented run
        if k["name"] in p20["launches"]:
            k["launches_by_mode"]["observe"] = p20["launches"][k["name"]]
            k["launches"] += p20["launches"][k["name"]]
    kernels.append(bf16_adam_row(rows["fused_adam"], next(
        run for run in runs if run["mode"] == BF16_MODE)))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
