#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (mxnet_tpu_torch) on one CUDA card.

Run from the repository root on a machine with an H100 and the CUDA
toolkit:

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package. Phases, in order; any
failure exits non-zero, nothing is caught and carried on:

  1. device: require CUDA; print the card's name and power limit; TF32 off
     for matmuls and cuDNN (a float32 reference must be float32).
  2. build: compile every kernel under mxnet_tpu_torch/csrc with nvcc.
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the main paths' shapes and edge cases, with times beside the card's
     bound and the one-call PyTorch equivalent: the attention forward and
     the two attention backward kernels in both variants (the tensor-core
     kernels for bf16: ragged S 200 and 37, causal, D 32, 64 and 128,
     dropout, fused-QKV views, contiguous and misaligned tensors; the FP32
     kernels for f32), each timed alone and SDPA the same way (summed kernel
     events of the profiler, inputs rotated over copies that exceed the L2)
     and back to back from the host (CUDA events around 20 calls), the
     optimizer ladder (one launch per bucket: buckets of one at BERT-base's
     shapes, a mixed bucket, a bucket split over several launches) and its
     global-norm pre-pass (against the plain sum, and bit for bit over two
     runs), and the BatchNorm-training forward and backward at
     every BatchNorm shape of ResNet-50 at batch 256 (bf16, NHWC; timed
     alone L2-cold and L2-warm, host-issued, and beside a copy of the same
     bytes) and at edge cases (C = 3 and 8, NCHW, a misaligned view), each
     launched twice for a bitwise repeat, its regime (16-byte vector or
     scalar channels last; planes or resident channels not last) the one
     launch_geometry predicts.
 3b. attention probes: the bf16 dropout mask of all three kernels bit for
     bit against ``_dropout_keep`` at S = D = 64 and 128 (q = k = 0,
     v = dO = I for out and dv; q = 0, k = I, v and dO one-hot for dq),
     and two runs of the forward and backward bitwise equal.
  4. model parity: a 2-layer BERT at full width in float32, once on CUDA
     (through the FP32 attention kernels, counted) and once on the CPU
     (their plain versions): the logits, then the loss and every gradient
     of one training step.
 4b. the exact GELU (``ops/nn.py:gelu_exact``, 0.5 * x * erfc(-x /
     sqrt 2)) on the card against the CPU at x = -8 ... 8: f32 within 2e-6
     relative, its gradient within 1e-5 relative (plus 1e-7 of the largest
     where it crosses zero), bf16 within 2^-7.
  5. serving, a main path: BERT-base (bf16, seq 384) with its SQuAD head
     served through InferenceEngine (rungs 1/2/4/8), whose warmup captures
     one CUDA graph per rung (``call_cached_graph``): a replay against the
     eager forward of the same batch at each rung, then 32 requests from
     two client threads through the captured rungs in each engine mode
     (pipelined, max_inflight 2; sync), launch counts zeroed just before
     and read just after each: every attention launch the tensor-core
     kernel's, 12 a batch (counted from the replays), no capture and no
     new signature after warmup, every result (read after all requests
     finished) within 1e-2 of an eager forward of its rows. The same
     traffic through the eager forward (an adapter in this file), and one
     batch of 8 measured graph against eager in turns
     (tools/profile_serving: host ms, device-busy, idle share, host calls).
 5b. serving behind the front door, a main path: two BERT-base replicas
     (seeds 0 and 1) on the card behind ``serving.FrontDoor``; the first
     serves two client threads while the second warms up and captures its
     rungs, then both serve; the routing split and each replica's stats;
     counts from 0 just before: 12 tensor-core attention launches a batch
     plus the second replica's warm-up forwards, none lost or added by the
     capture beside the replays; every result within 1e-2 of an eager
     forward on the replica that served it.
  6. training, a main path: BERT-base (bf16 weights, f32 masters, seq 384,
     batch 8, dropout 0.1) takes 5 fine-tune steps through
     ``autograd.record()`` -> ``autograd.backward`` -> ``Trainer.step``,
     with no setting beyond the defaults; after 2 warm-up steps the launch
     counts are zeroed just before the 5 counted steps and read just after
     (K4, K5a, K5b: 12 tensor-core launches a step each, no FP32 one; K3
     and its norm once per bucket a step, every trainable tensor through
     K3). The optimizer over BERT-base's whole parameter list as
     update_fused issues it: one launch per bucket, the first port's one
     launch per parameter and the plain ladder, alone and host-issued,
     beside torch.optim.AdamW(fused=True). Then, without dropout, 3 steps
     through the kernels against 3 steps through their plain versions from
     the same weights.
  7. ResNet parity: a narrow ResNet (NHWC, space-to-depth stem) in float32,
     one training step on CUDA (BatchNorm through its kernels) and on the
     CPU: logits, loss, every gradient and the running stats.
  8. training, a main path: ResNet-50 v1 (NHWC, space-to-depth stem, bf16
     weights with f32 masters, batch 256 of 224x224 images, SGD momentum
     0.9, lr 0.1, wd 1e-4) through ``autograd.record()`` ->
     ``autograd.backward`` -> ``Trainer.step``; 2 warm-up steps, then the
     launch counts are zeroed just before 5 counted steps and read just
     after; the optimizer over ResNet-50's parameter list as in 6, beside
     torch.optim.SGD(fused=True). Then 3 float32 steps at batch 32 through
     the kernels against 3 through their plain versions, each from the
     same state.
  9. runtime-compiled kernels (mx.rtc, K7), a main path: three CUDA C++
     sources kept in this file (RTC_*: axpy in f32, a bf16 row sum into f32
     with dynamic shared memory and a fixed shuffle tree, a strided __half
     scale with int and long long scalars), compiled through
     ``rtc.CudaModule`` while phase 2 builds, launched on ``mx.np`` arrays
     of the card with the counts zeroed just before and read just after;
     then each against its plain PyTorch version, timed beside its bound
     and one library call; a refused launch (a 2048-thread block) and
     dynamic shared memory above 48 KB without opting in must raise.
 10. LeNet parity: LeNet in f32 takes one imperative step on ``mx.np``
     arrays on CUDA and on the CPU from the same weights: logits, loss,
     every gradient and the parameters after the step.
 11. LeNet-MNIST imperative, a main path (BASELINE config #1 as
     bench.py:288-306 builds it): lenet(classes=10), batch 256 of 1x28x28
     from ``mx.np.random``, ``SoftmaxCrossEntropyLoss``, ``Trainer("sgd",
     lr 0.05)``, ``autograd.record()`` -> ``L.backward()`` ->
     ``trainer.step(256)``; 2 warm-up steps, then the counts are zeroed just
     before 5 counted steps and read just after; the optimizer over LeNet's
     parameters as in 6.
 13-15. TrainStep, main paths: ResNet-50 (as 8), LeNet (as 11) and
     BERT-base (as 6, without the global-norm clip, which TrainStep runs
     phased) through ``gluon.TrainStep``, which captures each step as one
     CUDA graph: two builds of each from one seed, one through the graph
     and one phased (``MXTPU_WHOLE_STEP=0``); 2 warm-up steps (the eager
     warm-up, then the capture and its first replay), then the counts are
     zeroed just before 5 counted steps of each and read just after (the
     graph's from its replays' deltas): one capture, the phased path's
     launches (K1 = K2 = 53, K3 = its buckets, K4 = K5a = K5b = 12 a
     step). BERT: each replay moves every layer's dropout-seed generator as
     a phased step moves its twin's, and the 5 replays draw 5 different
     seeds. Then 3 steps of both from one state
     with an LR that changes every step, held to each other (phase 6's
     and 10's loss tolerances, phase 8's parameter measure), and both
     profiled in turns (phased, graph, graph, phased: host ms, device-busy
     ms, idle share, host calls a step beside the kernels the device ran,
     peak memory). Phase 3's K3 sweeps also hold the ladder's device-scalar
     entry bit for bit against its by-value entry over each path's list
     and time it, and 3b probes the mask with a seed drawn on the card.
 16. checkpoint and resume, a main path: BERT-base fine-tuning as 6
     (dropout 0: the Dropout generators' state is not part of
     ``save_states``; the checkpoint manager of phase 26 carries it) takes
     4 phased steps with the global-norm clip (A);
     a build from A's seed takes 2 and saves (``save_parameters``,
     ``save_states``); a build from another seed loads both and takes 2
     on A's batch, the counts zeroed just before and read just after:
     after the load every weight, f32 master and AdamW moment equals A's
     after step 2, after the steps A's after step 4, losses too, bit for
     bit; K3 and its norm once per bucket a step, K4, K5a, K5b 12 times a
     step. Then a captured ``gluon.TrainStep`` (no clip) loads both in
     place and replays with no rebuild and no capture, held to a phased
     build loaded from the same files; then an engine's captured rungs
     answer from ``load_parameters`` with no capture, and a retyping load
     (``cast_dtype=True, dtype_source='saved'``) captures each rung again.
     File sizes and save and load seconds beside the card.
 17. LAMB under AMP, a main path: BERT-base as 6 but initialized with
     ``mx.initializer.Xavier()`` and trained by LAMB (lr 1e-3, wd 0.01,
     the global-norm clip at 1.0, f32 masters) through MXNet's AMP loop
     (``amp.init``, ``convert_hybrid_block``, ``init_trainer``, the
     backward inside ``scale_loss``, ``unscale``, ``has_overflow``,
     ``trainer.step`` without an overflow, ``update_scale``); 2 warm-up
     steps, then the counts are zeroed just before 5 counted steps and
     read just after: K4, K5a, K5b 12 tensor-core launches a step, the
     global-norm kernel once per bucket a step, no ladder launch (every
     member decided ``unsupported_rule``, as the JAX package's ladder
     decides), scale 1 and no overflow, losses finite, and the batch's
     loss in predict mode lower after the steps than before them. Step
     ms, host ms and samples/s beside phase 6's AdamW step; the
     optimizer's share of the step's stream time (CUDA events around
     ``trainer.step``) and its update alone beside its byte bound. Then,
     without dropout, 3 steps through the kernels against 3 through their
     plain versions from the same weights, as in 6.
 18. the 14 optimizer rules: one fused update of each (SGLD's per
     parameter, its normal draws given) over a 2-layer BERT at full width,
     in f32, bf16 and bf16 with f32 masters, with wd, a rescale and a
     per-element clip, on the card and on the CPU from one state; every
     leaf within 4 f32 ulps (one bf16 ulp for a bf16 leaf) of its largest
     value plus 1e-3 of its largest change.
 19. ring flash attention (K6), a main path: first each hop kernel
     (ops/ring_hop.py: ring_flash_fwd, ring_flash_bwd) against its plain
     version at the local shard (12 x 8192 x 64), at D 128, at a ragged
     shard of 1000 rows (D 64 and 128), causal and not (forward from a
     running state, a middle and a last hop: out or acc within 2^-7 of
     the largest, lse within 1e-5; backward increments within 2^-7), and
     HGMMA in each library's SASS (cuobjdump). Then BERT-base's attention
     width (12 heads of 64, bf16) over a 32768-token sequence sharded on a
     mesh ``{"sp": 4}`` of four positions on ``cuda:0``, through
     ``parallel.ring_flash_attention_sharded`` and ``out.backward(dout)``,
     non-causal and causal, the counts zeroed just before each and read
     just after, under ``torch.cuda.set_sync_debug_mode("error")`` (no
     synchronising call): the hop kernels 16 times each way (n^2), causal
     10 (n(n+1)/2), K4 and K5 never, the "hop" route both ways; out within
     2^-7 of its largest of the plain ring's (f32 online softmax) on the
     same q, k, v, and of one K4 launch over the whole sequence; dq, dk,
     dv within 2^-7 + 4 x 2^-8 of their largest (the K4/K5 route's
     tolerance, kept) of the ring backward with the plain hop backward in
     place of the kernel, and of one K5 pair over the whole sequence.
     Forward and backward p50 of 5 after 2 warm-ups (CUDA events), the
     hop kernels alone in the ring's order, K4/K5 per hop alone (the
     earlier route), one K4 and one K5 pair over the whole sequence,
     SDPA's forward and backward, the plain ring's forward, the bound; one
     hop at the shard beside its plain version and SDPA; the forward hop
     from an empty state at 8 x 12 x 384 x 64 beside K4. Then at 4096
     tokens the f32 ring (K4/K5's FP32 kernels) against the same call on
     the CPU (1e-5 of the largest, out and gradients) and the bf16 ring
     against the plain ring (2^-7); at 8192 Ulysses against the plain
     ring (2^-7).
 20. the vision zoo, a main path: K1 and K2 against their plain versions
     at each of MobileNetV2-1.0's 53 BatchNorm shapes at batch 256 (bf16
     NCHW, the resident or planes regime as launch_geometry chooses, each
     site's regime, CUDA launches a call (counted in a CUDA graph that
     captured one call: exactly the regime's own kernels) and design
     bytes printed, non-zero cotangents, a second launch bit for bit), each timed alone L2-cold beside the plain
     versions and cuDNN on the same tensor and summed over the 53 sites
     beside the byte bound;
     then ``vision.mobilenet_v2_1_0(classes=1000)`` (NCHW, bf16 weights
     with f32 masters, batch 256 of 224x224, SGD momentum 0.9, lr 0.1, wd
     1e-4, softmax cross entropy on f32 logits) trained as 13-15 train
     ResNet-50, phased and through TrainStep's graph (K1 = K2 = 53, K3 = 2
     a step, one capture, graph and phased steps from one state held to
     each other), then two more phased steps whose logits update
     ``metric.Accuracy`` and ``metric.TopKAccuracy(5)``; then densenet121,
     inception_v3 (299x299), vgg16_bn, mobilenet1_0, squeezenet1_1 and
     alexnet at full width take a step each at batch 32 (bf16 with
     masters), the counts zeroed just before: K1 = K2 = the net's
     BatchNorm blocks, K3 once a bucket, the loss finite, peak memory.
 21. the input pipeline, a main path: ``tools/train_mnist.py`` (LeNet,
     the synthetic MNIST's 1024 samples, 2 epochs at batch 64, in the
     caller: K3 once a step) and ``tools/train_cifar_resnet.py --bf16``
     (``resnet18_v1(classes=10)`` at full width, ``nag``, one epoch of the
     synthetic CIFAR-10 at batch 64) fed by ``gluon.data.DataLoader`` in
     each mode from the same ``np.random.seed`` and initial weights: (a)
     in the caller, (b) 4 fork workers forked after CUDA is initialised,
     (c) a thread pool, (d) ``device_prefetch=2`` with ``pin_memory``,
     (e) (d) through TrainStep's graph at batch 64 and 256. (a)-(d) give
     the same batches in the same order (sha1 of each) and losses within
     1e-4 (cuDNN deterministic); every run K1 = K2 = 20 a step and K3 once
     a bucket a step on the card, ``data_prefetch_total`` = its batches
     with prefetch (0 without), no worker process left after it, and with
     prefetch its host-to-device copies on a stream that runs no compute
     (the profiler's, else the loader's stream ids); each prints its
     samples/s, step ms (CUDA events), ms waiting in ``next(loader)`` and
     the device's idle share in a profiled epoch. Then K1 and K2 at
     ResNet-18's 20 CIFAR BatchNorm sites at batch 64 (bf16 NCHW), as
     phase 20 times MobileNetV2's.
 22. the operator corpus, main paths (``mx.nd``/``mx.npx`` filled from
     the op registry): (a) ResNet-50 v1 written in the legacy ops
     (``nd.Convolution``, ``nd.BatchNorm(fix_gamma=False)``,
     ``nd.Activation``, ``nd.Pooling``, ``nd.Flatten``,
     ``nd.FullyConnected``, ``nd.SoftmaxOutput``) at full width, NCHW f32,
     batch 64 of 224x224, from the weights of the Gluon ``resnet50_v1``
     after ``initialize``: three steps under ``autograd.record()`` ->
     ``backward()`` -> ``nd.sgd_mom_update(w, g, mom, lr 0.1, momentum
     0.9, wd 1e-4, out=w)``, the counts zeroed just before and read just
     after (K1 = K2 = 53 a step), every result on ``cuda:0``; the first
     step's loss and gradients held to the Gluon net's forward and summed
     ``SoftmaxCrossEntropyLoss`` backward, the weights after the first
     update to a ``Trainer('sgd')`` step (tolerance from the Gluon step's
     own run-to-run noise); step p50 ms and samples/s. (b)
     ``npx.flash_attention`` and ``nd.flash_attention`` at 8 x 12 x 384 x
     64 bf16, causal and not, dropout 0.1 with a seed, forward and
     backward: K4, K5a, K5b once each a call; out and the gradients bit for
     bit the direct call's, within the kernels' tolerances of the plain
     versions. (c) every case of ``mxnet_tpu_torch/ops/_sweep_cases.py``
     on ``cuda:0``: results on the card, deterministic cases against the
     CPU, samplers reproducible under one seed; the number swept and
     failed (0).
 23. sparse arrays and the row-sparse training path, a main path (no
     kernel: the JAX package's sparse compute is XLA, so the port's is
     plain PyTorch): (a) ``tools/matrix_factorization.py`` at MovieLens-20M's
     table sizes (138 493 users x 27 278 items, rank 64, f32: tables of
     35.5 and 7.0 MB; two ``Embedding(sparse_grad=True)`` tables, Adam
     with ``lazy_update``, L2Loss, lr 0.01), 20 steps of 4096 sampled
     pairs whose ratings come from the two factors and hashed noise: step
     ms (CUDA events), rows touched a step per table; the first 3 steps
     also on a CPU twin from the same weights (weights and Adam states
     within 1e-5 of each tensor's largest value); rows no step touched bit
     for bit their initial values, their states zero; the rmse over the
     example's fixed pairs before and after (it must fall); the update
     alone (p50 of 5: CUDA events, the host's ms to return, the profiler's
     device ms and kernels) lazy against ``lazy_update=False`` from one
     state, with K3's launches counted from 0 (none lazy, some dense; the
     LAMB and hybridized steps' too); a LAMB step moves every row the batch did not touch
     (dense), and so does an Adam step through the hybridized model (no
     rows recorded). (b) ``sparse.dot`` of a CSR batch of 8192 rows over
     2^20 columns, 32 nonzeros a row, with a 2^20 x 64 f32 weight
     (csr·dense), and its transpose with an 8192 x 64 operand
     (csr^T·dense): forward and the dense operand's gradient within 1e-5
     of the largest value of the same calls on the CPU; ms (p50 of 5)
     beside the byte bound (the dense operand's rows read once: the
     distinct columns' for csr·dense, all 8192 for the transpose) and
     ``torch.sparse.mm`` on the same CSR as an
     indication. (c) every case of ``_sweep_cases.REST_CASES`` (the rest
     of ``mx.np``, ``mx.nd.sparse``, the new NDArray methods) on the card
     against the CPU, as 22c: the number swept and failed (0).
 24. data-parallel training across processes, a main path (BASELINE
     config #3), each part launched through ``mxnet_tpu_torch/tools/
     launch.py``, a rank's failure the phase's: (a) two ranks of
     ``tools/distributed_train.py --model resnet50_v1`` on the one card
     over gloo (NCCL refuses two ranks on a card): ResNet-50 v1 as phase 8
     builds it, 128 images a rank (global 256), 3 steps through
     ``Trainer(kvstore='tpu_dist')``, the counts zeroed in each rank just
     before its steps and read just after (K1 = K2 = 53 a step, K3 = 2
     a step, one a bucket); K1 and K2 against their plain versions at
     the 53 sites at a rank's batch of 128 (bf16 NHWC, phase 3's checks
     by ``bn_case``); every trainable parameter and optimizer state bit
     for bit equal across the ranks, and the parameters within phase 8's
     measure (plus one bf16 ulp for a bf16 weight) of this process taking
     the same two half-batches (``grad_req='add'`` over two backward
     passes, then ``trainer.step(256)``); step ms, the pushpull's ms and
     bytes a step (``collective_*``), the gradient list's bucketed sum
     alone after a barrier (ms), the backend. (b) NCCL at world size
     1: the store's bucketed reduce over (a)'s gradient list gives its
     input back bit for bit; ms a call. (c) the example at its defaults
     (two ranks, the MLP, 5 steps): ranks bit for bit equal, rank 0's
     loss over its batches lower after training; its compressed mode
     (2-bit, threshold 0.5, two rounds): each pulled sum equals the sum
     of the ranks' dequantized values. (d) 2-bit and 1-bit compression
     of a 2^24-element f32 gradient on the card: packed bytes and
     residuals bit for bit the CPU's over two rounds.
 25. INT8 inference, a main path (BASELINE config #5): (a) Q1 and Q2
     (``kernels/int8.py``: ``csrc/int8_quant.cu``; Q2's wgmma variant
     ``csrc/int8_conv_wgmma.cu`` with its split-K epilogue launch, and its
     gather variant ``csrc/int8_conv.cu``, as ``plan_conv`` picks them)
     against their plain versions on the card at each of ResNet-50 v1's
     54 quantized sites (53 convolutions and the Dense as a 1x1
     convolution) at batch 1, 8 and 32 (the served rungs), and at a site
     each of dilation 2, groups 2 and depthwise, the operands stored as
     the layers store them (channels-last codes and weight where the
     wgmma variant runs): Q1's codes, layout and ranges, Q2's int32 sums
     (against the float64 convolution's) and its f32 epilogue bit for
     bit; at batch 32 each site's plan (variant, tile, split) and each
     kernel timed alone and host-issued beside its plain version and its
     bound (bytes at 3.35 TB/s, int8 operations at 1979 TOPS), with the
     earlier designs timed in the same run (Q1's flat NCHW pass, Q2's
     gather variant forced at every site), cuDNN's f32 and bf16
     convolutions, ``torch._int_mm`` at the Dense and
     ``torch.quantize_per_tensor`` as indications. (b)
     ``tools/int8_inference.py``: ``resnet50_v1(classes=1000)`` f32 NCHW
     from seed 0, calibrated by ``quantize_net(calib_mode="entropy")``
     over 4 batches of 8 (host seconds printed), served through
     InferenceEngine with captured rungs 1, 8 and 32, 24 requests of 1-8
     images with the counts zeroed just before and read just after: Q1 54
     launches a batch, Q2 53 on the wgmma variant and 1 (the stem) on the
     gather one, a split-K epilogue launch for each site the plan splits
     at the rung served, all from the replays; every rung dispatched (the
     dispatches by rung printed); no capture after warmup; each result
     within 1e-4 of an eager forward of its rows; at each rung's batch,
     every quantized layer's Q1 codes, Q2 sums and output bit for bit
     their plain versions on its own input on the card; 8 images' logits
     against the same quantized net on the CPU with the card's ranges
     (1e-2 of the largest, the same top-1; the int8 codes that differ
     counted); int8 against fp32 top-1 agreement over 8 batches of 32 (no
     gate: random weights); the int8 and fp32 forwards at batch 32, each
     a captured rung, and one replay of each under the profiler, its
     device time split by kernel group (Q1, each Q2 variant, BatchNorm,
     pooling, adds, ReLU, copies, the rest by name). (c)
     ``tools/quantize_int8.py`` on the card, its own gate: int8 accuracy
     at least fp32's less 0.05.
 26. the checkpoint manager (``mx.checkpoint``), a main path: BERT-base
     QA fine-tuning as 15 (bf16, f32 masters, AdamW, batch 8, seq 384, no
     clip, through TrainStep's graph) at dropout 0.1, CKPT_STEPS steps.
     A, this process: the uninterrupted run, its losses and the sha256 of
     every weight, master and moment. B, a worker (``chip_smoke.py
     --ckpt-worker``, started with P while A runs): an async
     ``CheckpointManager.save`` at CKPT_AT, committed, two more steps, a
     second async save that ``_WRITE_BEGIN_HOOK`` holds open on the IO
     thread, a step while it is held; SIGKILLed there. C, a fresh
     worker: the latest committed step must be CKPT_AT and the killed
     write's tmp dir reaped; it restores and takes the remaining steps,
     the counts zeroed just before and read just after (K3 once per
     bucket, K4, K5a, K5b 12 times a step); its losses and digests equal
     A's bit for bit, dropout masks included (the checkpoint carries the
     noise generators). Then this process restores CKPT_AT into A's live,
     captured TrainStep: its replays equal A's steps bit for bit, with the
     same launches and no new capture. P, a worker under
     ``install_preemption_handler`` with MXTPU_CKPT_PREEMPT_EXIT_CODE set,
     its signals blocked but for an instant between two steps: SIGTERM
     must exit with that code and leave a committed ``preempt``
     checkpoint at the step it had completed, which ``python -m
     mxnet_tpu_torch.tools.ckpt verify`` passes. Printed beside the card:
     bytes a checkpoint, the snapshot's device-to-host copy and crc32 ms,
     the async save's return and its write + commit ms, restore ms (here
     and in C), step ms with no save in flight and with one in flight.
 27. sharding plans over positions of the card, a main path: BERT-base QA
     fine-tuning as 26 (dropout 0.1, TrainStep's graph), SHARD_STEPS steps
     (a) with no plan, under ``dp=4`` over four positions of the card (the
     per-shard form) and under ``from_layout("dp=2,fsdp=2,tp=2")`` over
     eight (the logical step, every parameter and its ZeRO state a block a
     position): the last bit for bit with the first (losses, weights,
     masters, moments), dp=4 within the AdamW step bound; one capture a
     run; K3, K4, K5a, K5b counted, K3 under the hybrid plan as the placed
     tables predict. (b) the hybrid run's optimizer-state bytes a
     position. (c) its checkpoint: PlanMismatch into a world-4 plan, then
     ``resharded_restore`` and ``verify_parity``, an unplaced restore, an
     offline reshard for dp=4 restored as an exact match, the CLI's
     ``verify --mesh`` and ``reshard``, a resumed run equal to the
     uninterrupted one. (d) ``elastic.reenter`` of the live run to
     ``dp=2,fsdp=2`` with the linear LR rule, bit for bit with the
     unplaced run at half its LR, one new capture. Printed beside the
     card: step host and device-busy ms, the gradient hand-out's and the
     gathers' device ms, restore ms across plans, reenter's ms.
 28. a ``timing`` line (profiler windows taken, windows that came back
     without device events, and times taken with CUDA events instead
     where the profiler recorded none), a ``{"kernels": [...]}`` line
     (with each kernel's launches on the TrainStep paths, on the resumed
     steps, on the LAMB steps, in the ring, on the vision zoo's steps and
     in the data phase's runs and in phase 24's ranks and on phase 26's
     resumed steps and under phase 27's plans, a row for each hop
     kernel and one for K6's ring; K3 with each training path's sweep and
     K1, K2 with MobileNetV2's and ResNet-18's CIFAR sites and phase 24's
     launches and errors in ``per_path``), the card
     line, and as the last line
     ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --bn-sites ROOT [SETS]`` runs no phase but this: K1
and K2 of the ``mxnet_tpu_torch`` package under ROOT (this checkout, or
another one such as a parent commit's, unpacked with ``git archive``) timed
exactly as phase 3 times them at ResNet-50's 9 BatchNorm shapes (NHWC),
MobileNetV2-1.0's 19 (phase 20's, NCHW) and ResNet-18's 5 CIFAR shapes
(phase 21's), or the comma-separated SETS of ``resnet50``,
``mobilenet_v2``, ``resnet18_cifar``, so that two trees compare on one
card in one call. It prints a ``bn_site`` line for each NCHW shape, one
``bn_sites`` line with the sums over each set's sites, and no ``ok``
line.

``python3 chip_smoke.py --int8-plans [BATCHES]`` runs no phase but this:
at ResNet-50 v1's quantized sites that Q2's wgmma variant takes, at each
of the comma-separated BATCHES (default 1,8,32), the variant timed alone
(summed kernel events, inputs rotated over copies exceeding the L2) at
every tile (BM 64 and 128 output pixels by 64 channels) and split of K that
``INT8_SWEEP_SPLITS`` and the plan's own allow, one ``int8_plan_site``
line a site (the plan's choice, the fastest, the bound) and an
``int8_plans`` line with the sums over the sites by their counts; no
``ok`` line.
"""
import concurrent.futures
import contextlib
import ctypes
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time
from functools import partial
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
L2_BYTES = 50 * 2 ** 20            # H100 SXM L2
PEAK_FLOPS = {"bfloat16": 989e12,  # dense tensor cores
              "float32": 67e12}    # float32 outside the tensor cores


_FA = "mxnet_tpu_torch.ops.flash_attention"
_FA_FWD = "mxnet_tpu_torch/csrc/flash_attention_fwd.cu"
_FA_BWD = "mxnet_tpu_torch/csrc/flash_attention_bwd.cu"
#: every kernel of the port: its launch counter's name, its source, the TPU
#: kernel it replaces, and where its wrapper and its plain version live. The
#: attention kernels come in two variants each, counted apart: ``_mma`` on
#: the tensor cores for bfloat16 (the main paths'), ``_fp32`` for float32
KERNELS = [
    dict(name="flash_attention_fwd_mma", route="cuda", source=_FA_FWD,
         replaces="mxnet_tpu/ops/pallas_attention.py:85",
         wrapper=f"{_FA}:flash_attention_fwd",
         plain=f"{_FA}:flash_attention_reference"),
    dict(name="flash_attention_fwd_fp32", route="cuda", source=_FA_FWD,
         replaces="mxnet_tpu/ops/pallas_attention.py:85",
         wrapper=f"{_FA}:flash_attention_fwd",
         plain=f"{_FA}:flash_attention_reference"),
    dict(name="flash_attention_bwd_dq_mma", route="cuda", source=_FA_BWD,
         replaces="mxnet_tpu/ops/pallas_attention.py:259",
         wrapper=f"{_FA}:flash_attention_bwd",
         plain=f"{_FA}:flash_attention_bwd_reference"),
    dict(name="flash_attention_bwd_dq_fp32", route="cuda", source=_FA_BWD,
         replaces="mxnet_tpu/ops/pallas_attention.py:259",
         wrapper=f"{_FA}:flash_attention_bwd",
         plain=f"{_FA}:flash_attention_bwd_reference"),
    dict(name="flash_attention_bwd_dkv_mma", route="cuda", source=_FA_BWD,
         replaces="mxnet_tpu/ops/pallas_attention.py:305",
         wrapper=f"{_FA}:flash_attention_bwd",
         plain=f"{_FA}:flash_attention_bwd_reference"),
    dict(name="flash_attention_bwd_dkv_fp32", route="cuda", source=_FA_BWD,
         replaces="mxnet_tpu/ops/pallas_attention.py:305",
         wrapper=f"{_FA}:flash_attention_bwd",
         plain=f"{_FA}:flash_attention_bwd_reference"),
    dict(name="opt_ladder", route="cuda",
         source="mxnet_tpu_torch/csrc/opt_ladder.cu",
         replaces="mxnet_tpu/kernels/opt.py:95",
         wrapper="mxnet_tpu_torch.kernels.opt:bucket_step",
         plain="mxnet_tpu_torch.kernels.opt:bucket_step_reference"),
    # the global-norm pre-pass of the ladder: XLA in the JAX package (one
    # jit per bucket), no pallas_call; written by hand here over K3's table
    dict(name="opt_sqnorm", route="cuda",
         source="mxnet_tpu_torch/csrc/opt_ladder.cu",
         replaces="mxnet_tpu/optimizer/optimizer.py:341",
         wrapper="mxnet_tpu_torch.kernels.opt:bucket_sqnorm",
         plain="mxnet_tpu_torch.kernels.opt:bucket_sqnorm_reference"),
    dict(name="bn_train_fwd", route="cuda",
         source="mxnet_tpu_torch/csrc/bn_train.cu",
         replaces="mxnet_tpu/kernels/norm.py:112",
         wrapper="mxnet_tpu_torch.kernels.norm:bn_train_fwd",
         plain="mxnet_tpu_torch.kernels.norm:bn_train_fwd_reference"),
    dict(name="bn_train_bwd", route="cuda",
         source="mxnet_tpu_torch/csrc/bn_train.cu",
         replaces="mxnet_tpu/kernels/norm.py:202",
         wrapper="mxnet_tpu_torch.kernels.norm:bn_train_bwd",
         plain="mxnet_tpu_torch.kernels.norm:bn_train_bwd_reference"),
    # K6's hop kernels: the ring's bf16 path at head dims 64 and 128
    dict(name="ring_flash_fwd", route="cuda",
         source="mxnet_tpu_torch/csrc/ring_flash_fwd.cu",
         replaces="mxnet_tpu/parallel/ring_attention.py:119",
         wrapper="mxnet_tpu_torch.ops.ring_hop:ring_hop_fwd",
         plain="mxnet_tpu_torch.ops.ring_hop:ring_hop_fwd_reference"),
    dict(name="ring_flash_bwd", route="cuda",
         source="mxnet_tpu_torch/csrc/ring_flash_bwd.cu",
         replaces="mxnet_tpu/parallel/ring_attention.py:210",
         wrapper="mxnet_tpu_torch.ops.ring_hop:ring_hop_bwd",
         plain="mxnet_tpu_torch.ops.ring_hop:ring_hop_bwd_reference"),
    # INT8 inference (config #5): XLA in the JAX package (its _q and its
    # int8 conv_general_dilated / dot_general), no pallas_call; written by
    # hand here
    dict(name="int8_quantize", route="cuda",
         source="mxnet_tpu_torch/csrc/int8_quant.cu",
         replaces="mxnet_tpu/contrib/quantization.py:40",
         wrapper="mxnet_tpu_torch.kernels.int8:quantize",
         plain="mxnet_tpu_torch.kernels.int8:quantize_reference"),
    # Q2's variants (kernels/int8.py:plan_conv): wgmma at every site whose
    # C/groups is a multiple of 16, with its split-K epilogue launch where
    # the plan splits K; gather at the rest
    dict(name="int8_conv_wgmma", route="cuda",
         source="mxnet_tpu_torch/csrc/int8_conv_wgmma.cu",
         replaces="mxnet_tpu/contrib/quantization.py:311",
         wrapper="mxnet_tpu_torch.kernels.int8:conv",
         plain="mxnet_tpu_torch.kernels.int8:conv_reference"),
    dict(name="int8_conv_splitk", route="cuda",
         source="mxnet_tpu_torch/csrc/int8_conv_wgmma.cu",
         replaces="mxnet_tpu/contrib/quantization.py:311",
         wrapper="mxnet_tpu_torch.kernels.int8:conv",
         plain="mxnet_tpu_torch.kernels.int8:conv_reference"),
    dict(name="int8_conv_gather", route="cuda",
         source="mxnet_tpu_torch/csrc/int8_conv.cu",
         replaces="mxnet_tpu/contrib/quantization.py:311",
         wrapper="mxnet_tpu_torch.kernels.int8:conv",
         plain="mxnet_tpu_torch.kernels.int8:conv_reference"),
    # K7: user CUDA C++ (the RTC_* sources below) through mx.rtc
    dict(name="rtc", route="cuda", source="mxnet_tpu_torch/rtc.py",
         replaces="mxnet_tpu/rtc.py:65",
         wrapper="mxnet_tpu_torch.rtc:CudaKernel.launch",
         plain="mxnet_tpu_torch.rtc:PallasKernel.launch"),
]

# -- the runtime-compiled kernels of phase 9 (user code of mx.rtc) ----------
RTC_AXPY = r"""
// y += alpha * x (MXNet's CudaModule example), one element a thread
extern "C" __global__ void axpy(const float *x, float *y, float alpha, int n) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) y[i] += alpha * x[i];
}
"""

RTC_ROW_SUM = r"""
#include <cuda_bf16.h>
// out[r] = sum of row r of x (bf16 in, f32 out): one block a row, eight
// values a thread through one 16-byte load where the row allows it, a
// shuffle tree in each warp, the warps' sums in dynamic shared memory, a
// last shuffle tree in warp 0. The order of the sums is fixed: the same
// bits on every run.
extern "C" __global__ void row_sum_bf16(const __nv_bfloat16 *x, float *out,
                                        int cols) {
    extern __shared__ float warp_sums[];
    const __nv_bfloat16 *row = x + (long long)blockIdx.x * cols;
    float s = 0.f;
    if ((cols & 7) == 0 && (reinterpret_cast<unsigned long long>(x) & 15) == 0) {
        for (int c = threadIdx.x * 8; c < cols; c += blockDim.x * 8) {
            uint4 v = *reinterpret_cast<const uint4 *>(row + c);
            const __nv_bfloat16 *h = reinterpret_cast<const __nv_bfloat16 *>(&v);
            for (int k = 0; k < 8; ++k) s += __bfloat162float(h[k]);
        }
    } else {
        for (int c = threadIdx.x; c < cols; c += blockDim.x)
            s += __bfloat162float(row[c]);
    }
    for (int off = 16; off > 0; off >>= 1)
        s += __shfl_down_sync(0xffffffffu, s, off);
    int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (lane == 0) warp_sums[warp] = s;
    __syncthreads();
    if (warp == 0) {
        s = lane < (int)(blockDim.x >> 5) ? warp_sums[lane] : 0.f;
        for (int off = 16; off > 0; off >>= 1)
            s += __shfl_down_sync(0xffffffffu, s, off);
        if (lane == 0) out[blockIdx.x] = s;
    }
}

// y = each tile of x reversed, through a tile of dynamic shared memory
// (64 KB at 16384 floats: above the 48 KB a launch may take unasked)
extern "C" __global__ void tile_reverse(const float *x, float *y, int tile) {
    extern __shared__ float buf[];
    const float *src = x + (long long)blockIdx.x * tile;
    float *dst = y + (long long)blockIdx.x * tile;
    for (int i = threadIdx.x; i < tile; i += blockDim.x) buf[i] = src[i];
    __syncthreads();
    for (int i = threadIdx.x; i < tile; i += blockDim.x)
        dst[i] = buf[tile - 1 - i];
}
"""

RTC_STRIDED = r"""
#include <cuda_fp16.h>
// y[i] = scale * x[offset + i * stride] in __half: an int and a long long
// scalar (the offset may pass 2^31 elements)
extern "C" __global__ void strided_scale_half(const __half *x, __half *y,
                                              float scale, int n, int stride,
                                              long long offset) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n)
        y[i] = __float2half(scale * __half2float(x[offset + (long long)i * stride]));
}
"""

#: (kernel, source, exports, signature)
RTC_KERNELS = [
    ("axpy", RTC_AXPY, ("axpy",), "const float *x, float *y, float alpha, int n"),
    ("row_sum_bf16", RTC_ROW_SUM, ("row_sum_bf16", "tile_reverse"),
     "const __nv_bfloat16 *x, float *out, int cols"),
    ("strided_scale_half", RTC_STRIDED, ("strided_scale_half",),
     "const __half *x, __half *y, float scale, int n, int stride, "
     "long long offset"),
]


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(ok, msg):
    if not ok:
        fail(msg)


def say(*a):
    print(*a, flush=True)


def cuda_ms(torch, fn, iters=20):
    """Mean device time of ``fn`` in ms over ``iters`` back-to-back calls
    (CUDA events, after a warm-up; inputs stay in the 50 MB L2)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def same_layout_copy(torch, t):
    """A copy of ``t`` with its sizes, strides and storage offset (so its
    alignment too), in storage of its own."""
    extent = sum((n - 1) * st for n, st in zip(t.shape, t.stride())) + 1
    buf = torch.empty(t.storage_offset() + extent, dtype=t.dtype,
                      device=t.device)
    c = buf.as_strided(t.shape, t.stride(), t.storage_offset())
    c.copy_(t)
    return c


def cold_copies(torch, tensors):
    """Copies of ``tensors`` (None entries kept), each one's layout kept
    (:func:`same_layout_copy`): enough sets that the input bytes over all of
    them exceed twice the L2, so that calls made on the sets in turn read
    their inputs from HBM, as the bounds assume."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors
                 if t is not None)
    n = min(64, max(2, -(-2 * L2_BYTES // nbytes) + 1))
    return [tuple(None if t is None else same_layout_copy(torch, t)
                  for t in tensors) for _ in range(n)]


#: profiler windows taken, windows that came back without device events,
#: and device_ms calls timed with CUDA events instead (printed before the
#: kernels line)
TIMING = {"profiler_windows": 0, "empty_windows": 0, "event_timed_calls": 0}


def device_ms(torch, fns, iters=20):
    """Mean device time of one call in ms: the summed durations of every
    kernel that ``iters`` calls launch, from ``torch.profiler``'s CUDA
    events, after a warm-up. ``fns`` compute one function each on its own
    set of :func:`cold_copies` and are called in turn, so that a call finds
    its inputs in HBM, not in the L2. Host time between launches is not in
    it, so the host cannot bound a short kernel's number; a library call's
    autograd kernels are in it. Where the profiler records no device
    activity (it returns a window without its device events now and then,
    and on some machines every time), the calls are timed with CUDA events
    behind a spin kernel instead (profile_training.queued_ms: the card's
    gaps between kernels are then in the time) and TIMING counts it."""
    from torch.profiler import ProfilerActivity, profile

    fns = list(fns)
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    # an empty window is taken again, twice at most; once the profiler has
    # come back empty three times running, once only
    for attempt in range(1 if TIMING["event_timed_calls"] else 3):
        TIMING["profiler_windows"] += 1
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fns[i % len(fns)]()
            torch.cuda.synchronize()
        us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
        if us > 0:
            return us / 1e3 / iters
        TIMING["empty_windows"] += 1
        say(f"device_ms: the profiler recorded no device activity "
            f"(window {attempt + 1})")
    from mxnet_tpu_torch.tools.profile_training import queued_ms

    TIMING["event_timed_calls"] += 1
    return sum(queued_ms(fns, iters)) / iters


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


# -- phase 3 ---------------------------------------------------------------

def attention_bound(b, h, s, d, dtype_name, causal):
    """Least time (ms) and what bounds it: q, k, v read once and out, lse
    written once at the memory rate, or 4*D operations per live (q, k)
    pair (2*D each for QK^T and PV) at the card's peak for the dtype."""
    esize = 2 if dtype_name == "bfloat16" else 4
    nbytes = 4 * b * h * s * d * esize + 4 * b * h * s
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 4 * b * h * pairs * d
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def attention_bwd_bound(b, h, s, d, dtype_name, causal):
    """``{"dq": (ms, bound_by), "dkv": (ms, bound_by), "pair": ...}``, the
    least time of each backward kernel and of the function the two compute
    together. dq reads q, k, v, dO, out and lse and writes dq and delta;
    dk/dv reads q, k, v, dO, lse and delta and writes dk and dv: six
    (B, H, S, D) tensors and two f32 rows each. The pair's function (dq, dk
    and dv from q, k, v, out, lse and dO) reads five tensors and lse and
    writes three. Operations per live (q, k) pair: 6*D for dq (three
    products), 8*D for dk/dv (four) and 10*D for the function (QK^T, dO V^T,
    dS K, dS^T Q, P^T dO), plus 2*D per row for delta where it is
    computed."""
    esize = 2 if dtype_name == "bfloat16" else 4
    n = b * h * s * d
    rows = b * h * s
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    out = {}
    for key, nbytes, flops in (
            ("dq", 6 * n * esize + 2 * 4 * rows, 6 * pairs * d + 2 * n),
            ("dkv", 6 * n * esize + 2 * 4 * rows, 8 * pairs * d),
            ("pair", 8 * n * esize + 4 * rows, 10 * pairs * d + 2 * n)):
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = flops / PEAK_FLOPS[dtype_name]
        out[key] = (1e3 * max(t_bytes, t_ops),
                    "bytes" if t_bytes >= t_ops else "operations")
    return out


def attention_cases(torch):
    # (label, B, H, S, D, dtype, causal, dropout_p, layout); the first two
    # are the main paths' calls (serving; training, with dropout). layout:
    # "fused", q, k, v strided views of one (B, S, 3, H, D) tensor as BERT
    # calls it; "contiguous", three (B, H, S, D) tensors; "offset", three
    # (B, H, S, D) views that start 2 bytes past 16 (the tensor-core
    # kernels' narrow staging, as for D 36)
    bf, f32 = torch.bfloat16, torch.float32
    return [
        ("serve_bf16", 8, 12, 384, 64, bf, False, 0.0, "fused"),
        ("train_bf16_dropout", 8, 12, 384, 64, bf, False, 0.1, "fused"),
        ("serve_f32", 8, 12, 384, 64, f32, False, 0.0, "fused"),
        ("ragged_s200", 8, 12, 200, 64, f32, False, 0.0, "fused"),
        ("causal", 8, 12, 384, 64, f32, True, 0.0, "fused"),
        ("dropout_0.1_seed7", 8, 12, 384, 64, f32, False, 0.1, "fused"),
        ("d32", 8, 12, 384, 32, f32, False, 0.0, "fused"),
        ("d128", 8, 12, 384, 128, f32, False, 0.0, "fused"),
        ("d128_bf16_causal", 8, 12, 384, 128, bf, True, 0.0, "fused"),
        ("ragged_s200_bf16", 8, 12, 200, 64, bf, False, 0.0, "fused"),
        ("ragged_s37_bf16", 8, 12, 37, 64, bf, False, 0.0, "fused"),
        ("causal_bf16", 8, 12, 384, 64, bf, True, 0.0, "fused"),
        ("d32_bf16", 8, 12, 384, 32, bf, False, 0.0, "fused"),
        ("contiguous_bf16", 8, 12, 384, 64, bf, False, 0.0, "contiguous"),
        ("ragged_causal_dropout_bf16", 2, 12, 200, 64, bf, True, 0.1,
         "fused"),
        ("d36_bf16_unaligned", 2, 12, 200, 36, bf, False, 0.1, "fused"),
        ("offset_bf16_unaligned", 2, 12, 384, 64, bf, True, 0.0, "offset"),
    ]


def attention_inputs(torch, gen, b, h, s, d, dt, layout):
    """q, k, v of one case on the card, in the case's layout."""
    dev = torch.device("cuda", 0)
    if layout == "fused":
        qkv = torch.randn(b, s, 3, h, d, device=dev, generator=gen).to(dt)
        return tuple(qkv[:, :, i].transpose(1, 2) for i in range(3))
    if layout == "contiguous":
        return tuple(torch.randn(b, h, s, d, device=dev, generator=gen)
                     .to(dt) for _ in range(3))
    n = b * h * s * d
    flat = torch.randn(3 * n + 1, device=dev, generator=gen).to(dt)
    return tuple(flat[1 + i * n:1 + (i + 1) * n].view(b, h, s, d)
                 for i in range(3))


def phase_kernels(torch, fa):
    """The forward kernel (each variant by its dtype) against its plain
    version at :func:`attention_cases`. Times: ``ms`` the kernel alone
    (:func:`device_ms`), ``ms_host_issued`` back to back from the host
    (:func:`cuda_ms`, this script's older method); SDPA the same two ways."""
    import torch.nn.functional as F

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1234)
    rows = []
    for label, b, h, s, d, dt, causal, p, layout in attention_cases(torch):
        q, k, v = attention_inputs(torch, gen, b, h, s, d, dt, layout)
        # the seed on the card, as training passes it (an int seed would
        # add a copy to the card to every call)
        seed = torch.tensor([7], dtype=torch.int32, device=dev) if p \
            else None
        variant, aligned = fa.tensor_route(q, k, v)
        counter = fa.VARIANT_LAUNCHES[fa.KERNEL][variant]
        before = counter.value
        out, lse = fa.flash_attention_fwd(q, k, v, causal=causal,
                                          dropout_p=p, dropout_seed=seed)
        check(counter.value == before + 1,
              f"{label}: the {variant} variant did not launch")
        ref, ref_lse = fa.flash_attention_reference(
            q, k, v, causal=causal, dropout_p=p, dropout_seed=seed)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        # bf16: P and out round to bf16 at other points than in the plain
        # version (8 mantissa bits, |v| < 6); f32: summation order only
        tol, lse_tol = (3e-2, 1e-3) if dt == torch.bfloat16 else (1e-4, 1e-4)
        check(bool(torch.isfinite(out.float()).all()),
              f"{label}: non-finite output")
        check(err <= tol and lse_err <= lse_tol,
              f"{label}: kernel disagrees with its plain version: out "
              f"{err:.3g} (tol {tol}), lse {lse_err:.3g} (tol {lse_tol})")

        def kernel(q=q, k=k, v=v):
            return fa.flash_attention_fwd(q, k, v, causal=causal, dropout_p=p,
                                          dropout_seed=seed)

        copies = cold_copies(torch, (q, k, v))
        ms = device_ms(torch, [partial(kernel, *c) for c in copies])
        ms_host = cuda_ms(torch, kernel)
        plain_ms = cuda_ms(torch, lambda: fa.flash_attention_reference(
            q, k, v, causal=causal, dropout_p=p, dropout_seed=seed))
        library_ms = library_ms_host = None
        if not p:  # SDPA's dropout mask is another function
            def sdpa(q=q, k=k, v=v):
                return F.scaled_dot_product_attention(q, k, v,
                                                      is_causal=causal)

            library_ms = device_ms(torch, [partial(sdpa, *c)
                                           for c in copies])
            library_ms_host = cuda_ms(torch, sdpa)
        del copies
        dname = str(dt).replace("torch.", "")
        bound_ms, bound_by = attention_bound(b, h, s, d, dname, causal)
        row = dict(case=label, shape=[b, h, s, d], dtype=dname,
                   causal=causal, dropout_p=p, layout=layout,
                   variant=variant, aligned=aligned, max_abs_err=err,
                   lse_max_abs_err=lse_err, tol=tol, ms=ms,
                   ms_host_issued=ms_host, plain_ms=plain_ms,
                   library_ms=library_ms,
                   library_ms_host_issued=library_ms_host,
                   bound_ms=bound_ms, bound_by=bound_by)
        say("kernel_case " + json.dumps(row))
        rows.append(row)
    return rows


def phase_kernels_bwd(torch, fa):
    """The two backward kernels against the plain backward, at the shapes
    of :func:`attention_cases` (``train_bf16_dropout`` is the training
    path's call); times as in :func:`phase_kernels`."""
    import math

    import torch.nn.functional as F

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(4321)
    rows = []
    for label, b, h, s, d, dt, causal, p, layout in attention_cases(torch):
        q, k, v = attention_inputs(torch, gen, b, h, s, d, dt, layout)
        # dO as autograd hands it: a transposed view of a (B, S, H*D) tensor
        do = torch.randn(b, s, h, d, device=dev,
                         generator=gen).to(dt).transpose(1, 2)
        seed = torch.tensor([7], dtype=torch.int32, device=dev) if p \
            else None
        scale = 1.0 / math.sqrt(d)
        out, lse = fa.flash_attention_fwd(q, k, v, causal=causal,
                                          dropout_p=p, dropout_seed=seed)
        variant, aligned = fa.tensor_route(q, k, v, out, do)
        counters = [fa.VARIANT_LAUNCHES[n][variant]
                    for n in (fa.KERNEL_BWD_DQ, fa.KERNEL_BWD_DKV)]
        before = [c.value for c in counters]
        got = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=causal,
                                     dropout_p=p, dropout_seed=seed)
        check([c.value - n for c, n in zip(counters, before)] == [1, 1],
              f"bwd {label}: the {variant} variants did not launch")
        want = fa.flash_attention_bwd_reference(
            q, k, v, out, lse, do, causal=causal, dropout_p=p,
            dropout_seed=seed)
        torch.cuda.synchronize()
        errs = [(a.float() - w.float()).abs().max().item()
                for a, w in zip(got, want)]
        big = max(w.float().abs().max().item() for w in want)
        # f32: the same operations summed in another order. bf16: dS, P_d
        # and the outputs round to bf16 (8 mantissa bits): two ulps of the
        # largest gradient
        tol = (2.0 ** -7 * big if dt == torch.bfloat16
               else 1e-4 * max(1.0, big))
        check(all(bool(torch.isfinite(a.float()).all()) for a in got),
              f"bwd {label}: non-finite gradient")
        check(max(errs) <= tol,
              f"bwd {label}: kernels disagree with the plain backward: "
              f"dq {errs[0]:.3g} dk {errs[1]:.3g} dv {errs[2]:.3g} "
              f"(tol {tol:.3g})")
        _, delta = fa.launch_bwd_dq(q, k, v, out, lse, do, causal, scale, p,
                                    seed)

        def dq_kernel(q=q, k=k, v=v, out=out, lse=lse, do=do):
            return fa.launch_bwd_dq(q, k, v, out, lse, do, causal, scale, p,
                                    seed)

        def dkv_kernel(q=q, k=k, v=v, lse=lse, do=do, delta=delta):
            return fa.launch_bwd_dkv(q, k, v, lse, delta, do, causal, scale,
                                     p, seed)

        copies = cold_copies(torch, (q, k, v, out, lse, do, delta))
        dq_ms = device_ms(torch, [partial(dq_kernel, *c[:6])
                                  for c in copies])
        dkv_ms = device_ms(torch, [partial(dkv_kernel, *c[:3], *c[4:])
                                   for c in copies])
        dq_host, dkv_host = cuda_ms(torch, dq_kernel), cuda_ms(torch,
                                                               dkv_kernel)
        plain_ms = cuda_ms(torch, lambda: fa.flash_attention_bwd_reference(
            q, k, v, out, lse, do, causal=causal, dropout_p=p,
            dropout_seed=seed), iters=5)
        library_ms = library_host = None
        if not p:  # SDPA's dropout mask is another function
            def sdpa_bwd_of(q, k, v, do):
                ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
                o = F.scaled_dot_product_attention(ql, kl, vl,
                                                   is_causal=causal)
                return lambda: torch.autograd.grad(o, (ql, kl, vl), do,
                                                   retain_graph=True)

            library_ms = device_ms(torch, [sdpa_bwd_of(*c[:3], c[5])
                                           for c in copies])
            library_host = cuda_ms(torch, sdpa_bwd_of(q, k, v, do))
        del copies
        dname = str(dt).replace("torch.", "")
        bound = attention_bwd_bound(b, h, s, d, dname, causal)
        row = dict(case=label, shape=[b, h, s, d], dtype=dname,
                   causal=causal, dropout_p=p, layout=layout,
                   variant=variant, aligned=aligned, dq_max_abs_err=errs[0],
                   dkv_max_abs_err=max(errs[1:]), tol=tol, dq_ms=dq_ms,
                   dkv_ms=dkv_ms, dq_ms_host_issued=dq_host,
                   dkv_ms_host_issued=dkv_host,
                   plain_ms_dq_dk_dv_together=plain_ms,
                   library_ms_sdpa_backward_dq_dk_dv_together=library_ms,
                   library_ms_host_issued=library_host,
                   dq_bound_ms=bound["dq"][0], dq_bound_by=bound["dq"][1],
                   dkv_bound_ms=bound["dkv"][0],
                   dkv_bound_by=bound["dkv"][1],
                   pair_bound_ms=bound["pair"][0],
                   pair_bound_by=bound["pair"][1])
        say("kernel_case_bwd " + json.dumps(row))
        rows.append(row)
    return rows


def mask_probe(torch, fa, b, h, s, p, seed):
    """Where each kernel applies the dropout mask, at S = D = ``s``, against
    ``_dropout_keep``: ``(mismatches of out, dv, dq, kept share)``. With
    q = k = 0 every score is 0 and P = 1/S, so with v = I out[i, j] > 0
    exactly where the hash keeps (i, j), and with dO = I dv[j, i] > 0 there
    too. With q = 0, k = I and v, dO one-hot in column 0, dP[i, j] =
    keep / (1 - p) and delta[i] = kept share of row i / (1 - p), so
    dq[i, j] = dS[i, j] > 0 exactly where the hash keeps (i, j); a row the
    hash keeps whole has dS = 0 up to rounding and is left out of dq's
    count."""
    dev = torch.device("cuda", 0)
    bf = torch.bfloat16
    zero = torch.zeros(b, h, s, s, device=dev, dtype=bf)
    eye = torch.eye(s, device=dev, dtype=bf).expand(b, h, s, s)
    onehot = torch.zeros(b, h, s, s, device=dev, dtype=bf)
    onehot[..., 0] = 1
    kw = dict(dropout_p=p, dropout_seed=seed)
    out, lse = fa.flash_attention_fwd(zero, zero, eye, **kw)
    _, _, dv = fa.flash_attention_bwd(zero, zero, eye, out, lse, eye, **kw)
    o1, lse1 = fa.flash_attention_fwd(zero, eye, onehot, **kw)
    dq, _, _ = fa.flash_attention_bwd(zero, eye, onehot, o1, lse1, onehot,
                                      **kw)
    keep = fa._dropout_keep(
        fa._seed_value(seed),
        torch.arange(b * h, device=dev).reshape(b, h, 1, 1),
        torch.arange(s, device=dev).reshape(1, 1, s, 1),
        torch.arange(s, device=dev).reshape(1, 1, 1, s), p)
    torch.cuda.synchronize()
    partial_rows = ~keep.all(dim=-1, keepdim=True)
    bad = (int(((out.float() > 0) != keep).sum().item()),
           int(((dv.float().transpose(2, 3) > 0) != keep).sum().item()),
           int((((dq.float() > 0) != keep) & partial_rows).sum().item()))
    return bad + (keep.float().mean().item(),)


def phase_attention_probes(torch, fa):
    """3b. Two checks of the tensor-core kernels that a tolerance cannot
    make. The dropout mask of all three kernels, bit for bit
    (:func:`mask_probe`), at S = D = 64 (the main paths' head dim and tile
    configuration) and 128, so that a fragment-layout slip in the mask
    cannot hide under 3e-2. Determinism: two runs of K5 (and of K4) on the
    training call give bitwise-equal results."""
    dev = torch.device("cuda", 0)
    b, h, p = 2, 3, 0.1
    probes = {}
    # an int seed (copied to the card by the wrappers) and a seed tensor
    # drawn on the card, as an attention layer draws it in training: the
    # kernels read either from device memory
    drawn = fa.next_dropout_seed(torch.Generator(device=dev).manual_seed(5))
    for s, seed in ((64, 7), (128, 7), (64, drawn)):
        out_bad, dv_bad, dq_bad, kept = mask_probe(torch, fa, b, h, s, p,
                                                   seed)
        label = seed if isinstance(seed, int) else \
            f"tensor {int(seed.item())}"
        say(f"mask probe ({b}, {h}, {s}, {s}) bf16 p {p} seed {label}: "
            f"kept {kept:.4f}; mismatches out {out_bad}, dv {dv_bad}, "
            f"dq {dq_bad}")
        check(out_bad == dv_bad == dq_bad == 0,
              f"the kernels' dropout mask differs from _dropout_keep at "
              f"S = D = {s}: out {out_bad}, dv {dv_bad}, dq {dq_bad} of "
              f"{b * h * s * s} pairs")
        check(0.85 < kept < 0.95, f"kept share {kept} for p = {p}")
        key = f"s{s}" if isinstance(seed, int) else f"s{s}_device_seed"
        probes[key] = dict(mask_out_mismatches=out_bad,
                               mask_dv_mismatches=dv_bad,
                               mask_dq_mismatches=dq_bad, kept_share=kept)

    gen = torch.Generator(device=dev).manual_seed(99)
    q, k, v = attention_inputs(torch, gen, 8, 12, 384, 64, torch.bfloat16,
                               "fused")
    do = torch.randn(8, 384, 12, 64, device=dev,
                     generator=gen).to(torch.bfloat16).transpose(1, 2)
    runs = []
    for _ in range(2):
        o, l = fa.flash_attention_fwd(q, k, v, dropout_p=p, dropout_seed=7)
        runs.append((o, l) + fa.flash_attention_bwd(
            q, k, v, o, l, do, dropout_p=p, dropout_seed=7))
    torch.cuda.synchronize()
    same = [bool(torch.equal(x, y)) for x, y in zip(*runs)]
    say(f"determinism (8, 12, 384, 64) bf16 dropout: out, lse, dq, dk, dv "
        f"bitwise equal over two runs: {same}")
    check(all(same), f"two runs differ: out, lse, dq, dk, dv {same}")
    return dict(mask=probes, deterministic=all(same))


def _ladder_operands(torch, dev, gen, shape, mp, n_state, misalign=False):
    """(w, state, g) of one parameter as the Trainer holds them; with
    ``misalign`` every tensor starts 4 bytes past a 16-byte boundary."""
    dt = torch.bfloat16 if mp else torch.float32

    def buf(scale, dtype=torch.float32):
        off = 4 // torch.empty((), dtype=dtype).element_size() \
            if misalign else 0
        n = math.prod(shape)
        x = torch.randn(n + off, device=dev, generator=gen) * scale
        return x.to(dtype)[off:].view(shape)

    master = buf(0.05)
    g = buf(0.01, dt)
    inner = [buf(1.0).abs() * 1e-4 for _ in range(n_state)]
    inner = None if not inner else (inner[0] if n_state == 1
                                    else tuple(inner))
    w = buf(1.0, dt)
    w.copy_(master.to(dt))
    return w, ((master, inner) if mp else inner), g


def _clone_state(x):
    if x is None:
        return None
    if isinstance(x, tuple):
        return tuple(_clone_state(y) for y in x)
    return x.clone()


F32_EPS = 2.0 ** -23


def check_ladder(label, kopt, kernel_side, plain_side, before):
    """Hold two (w, state) pairs against each other after the same updates
    from ``before``; returns ``(largest error, largest error / tolerance)``
    over the leaves.

    The kernel does the plain ladder's f32 operations in the same order
    without contraction, so an f32 leaf may differ by a few ulps of its
    values (4 allowed) and, in Adam, by the difference between the host's
    powf and numpy's in ``1 - beta^t`` (2e-5 of the step). The tolerance of
    a leaf is therefore 4 ulps of its largest value plus 1e-3 of its
    largest CHANGE over these updates: a kernel that left a leaf unwritten,
    or scaled its step wrongly by a percent, fails. The bf16 weight is the
    master rounded: the kernel's must equal its own master rounded, and
    lie within one bf16 ulp of the plain side's."""
    worst = worst_ratio = 0.0
    kl, pl, bl = (kopt._leaves(x) for x in (kernel_side, plain_side, before))
    check(len(kl) == len(pl) == len(bl), f"opt {label}: leaf count")
    for j, (a, w, w0) in enumerate(zip(kl, pl, bl)):
        err = (a.float() - w.float()).abs().max().item()
        big = w.float().abs().max().item()
        if a.dtype.itemsize == 2:
            master = kopt._leaves(kernel_side)[1]
            check(bool((a == master.to(a.dtype)).all()),
                  f"opt {label}: the bf16 weight is not the rounded master")
            tol = 2.0 ** -7 * max(big, 1e-3)
        else:
            moved = (w.float() - w0.float()).abs().max().item()
            check(moved > 0, f"opt {label}: leaf {j} did not change; the "
                             f"case checks nothing")
            tol = 4 * F32_EPS * big + 1e-3 * moved
        check(err <= tol,
              f"opt {label}: kernel disagrees with the plain ladder on leaf "
              f"{j} ({a.dtype}): {err:.3g} (tol {tol:.3g})")
        worst, worst_ratio = max(worst, err), max(worst_ratio, err / tol)
    return worst, worst_ratio


def _kernel_deltas(kopt, fn):
    """``fn()``'s ladder launches, tensors updated and norm launches."""
    counters = (kopt.LAUNCHES, kopt.TENSORS, kopt.SQNORM_LAUNCHES)
    before = [c.value for c in counters]
    fn()
    return tuple(c.value - b for c, b in zip(counters, before))


def _bucket_bytes(dispatch, kopt, items, mp):
    return sum(dispatch.optimizer_region_bytes(
        w.numel(), w.element_size(), len(kopt._leaves(st[1] if mp else st)),
        mp)[1] for w, st, *_ in items)


def phase_kernels_opt(torch, kopt, topt, dispatch):
    """The optimizer ladder kernel against its plain version over two
    updates: buckets of one (``param_step``) at BERT-base's parameter
    shapes, a mixed bucket, and a bucket of more tensors than one launch's
    table holds; then the global-norm kernels against ``_fused_sqnorm`` and
    against a second run of their own. Times beside the bytes each must
    move."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(99)
    adam = dict(beta1=0.9, beta2=0.999, eps=1e-8, rescale_grad=1.0 / 8)
    sgd = dict(momentum=0.9, rescale_grad=1.0 / 8)
    # (label, rule, shape, mp, n_state, clip, global-norm scale or None)
    cases = [
        ("adamw_mp_bf16_ffn", "AdamW", (3072, 768), True, 2, None, 0.5),
        ("adamw_mp_bf16_embed", "AdamW", (30522, 768), True, 2, None, 0.5),
        ("adamw_mp_bf16_bias768", "AdamW", (768,), True, 2, None, 0.5),
        ("adamw_mp_bf16_tail30522", "AdamW", (30522,), True, 2, None, 0.5),
        ("adamw_f32_embed", "AdamW", (30522, 768), False, 2, None, None),
        ("adam_f32_clip", "Adam", (3072, 768), False, 2, 0.001, None),
        ("sgd_momentum_f32", "SGD", (3072, 768), False, 1, None, None),
        ("sgd_stateless_mp_gn", "SGD", (3072, 768), True, 0, None, 0.5),
    ]
    rows = []
    for label, rule, shape, mp, n_state, clip, gscale in cases:
        cls = getattr(topt, rule)
        hyper = adam if n_state == 2 else sgd
        w, st, g = _ladder_operands(torch, dev, gen, shape, mp, n_state)
        pw, pst = w.clone(), _clone_state(st)
        w0, st0 = w.clone(), _clone_state(st)
        gn, scale = gscale is not None, gscale or 1.0
        for t in (1, 2):
            args = (1e-3, 0.01, t, scale, hyper)
            delta = _kernel_deltas(kopt, lambda: kopt.param_step(
                cls, clip, gn, mp, w, st, g, *args))
            check(delta == (1, 1, 0),
                  f"opt {label}: the wrapper did not launch the kernel once "
                  f"for one tensor ({delta})")
            topt.Optimizer._fused_param_step(cls, clip, gn, mp, pw, pst, g,
                                             *args)
        torch.cuda.synchronize()
        err, err_over_tol = check_ladder(label, kopt, (w, st), (pw, pst),
                                         (w0, st0))
        args = (1e-3, 0.01, 3, scale, hyper)
        ms = cuda_ms(torch, lambda: kopt.param_step(
            cls, clip, gn, mp, w, st, g, *args))
        plain_ms = cuda_ms(torch, lambda: topt.Optimizer._fused_param_step(
            cls, clip, gn, mp, pw, pst, g, *args))
        library_ms = library = None
        if label == "adamw_f32_embed":
            # another function (no bf16 copy, torch's own bias correction
            # and epsilon placement), timed as an indication only
            library = "torch.optim.AdamW(fused=True).step"
            lw = torch.nn.Parameter(w.clone())
            lw.grad = g.clone()
            lopt = torch.optim.AdamW([lw], lr=1e-3, weight_decay=0.01,
                                     fused=True)
            library_ms = cuda_ms(torch, lopt.step)
        n = w.numel()
        _, kernel_bytes = dispatch.optimizer_region_bytes(
            n, w.element_size(), n_state, mp)
        row = dict(case=label, rule=rule, shape=list(shape), mp=mp,
                   n_state=n_state, clip=clip, global_norm_scale=gscale,
                   max_abs_err=err, max_err_over_tol=err_over_tol, ms=ms,
                   plain_ms=plain_ms, bound_ms=1e3 * kernel_bytes / HBM_BYTES_PER_S,
                   bound_by="bytes", bytes_per_element=kernel_bytes / n,
                   library_ms=library_ms, library=library)
        say("kernel_case_opt " + json.dumps(row))
        rows.append(row)

    # a mixed bucket: BERT's sizes, 3 elements, an odd size and a view 4
    # bytes off alignment, with per-tensor lr, wd and t that differ, under
    # a global-norm scale and a clip; then a bucket of tiny tensors that
    # outgrows one table. Two updates each, every tensor checked
    buckets = [
        ("bucket_mixed_adamw_mp", "AdamW", adam, True, 2, 0.02, 0.5,
         [(768,), (3,), (30522,), (3072, 768), (4099,), (1000,)]),
        ("bucket_split_sgd_f32", "SGD", sgd, False, 1, None, None,
         [(1 + k % 7,) for k in range(1100)]),
    ]
    norm_grads = []
    for label, rule, hyper, mp, n_state, clip, gscale, shapes in buckets:
        cls = getattr(topt, rule)
        gn, scale = gscale is not None, gscale or 1.0
        items = [_ladder_operands(torch, dev, gen, shape, mp, n_state,
                                  misalign=shape == (1000,))
                 + (1e-3 * (1 + k % 5), 0.01 * (k % 3), 1 + 2 * (k % 4))
                 for k, shape in enumerate(shapes)]
        plain = [(w.clone(), _clone_state(st), g, lr, wd, t)
                 for w, st, g, lr, wd, t in items]
        start = [(w.clone(), _clone_state(st)) for w, st, *_ in items]
        want = (-(-len(items) // kopt.TABLE_CAPACITY), len(items), 0)
        for step in (0, 1):
            now = [it[:5] + (it[5] + step,) for it in items]
            delta = _kernel_deltas(kopt, lambda: kopt.bucket_step(
                cls, clip, gn, mp, now, scale, hyper))
            check(delta == want, f"opt {label}: launches, tensors, norms "
                                 f"{delta}, want {want}")
            kopt.bucket_step_reference(
                cls, clip, gn, mp, [it[:5] + (it[5] + step,)
                                    for it in plain], scale, hyper)
        torch.cuda.synchronize()
        errs = [check_ladder(f"{label} member {k}", kopt, a[:2], b[:2], c)
                for k, (a, b, c) in enumerate(zip(items, plain, start))]
        nbytes = _bucket_bytes(dispatch, kopt, items, mp)
        ms = cuda_ms(torch, lambda: kopt.bucket_step(
            cls, clip, gn, mp, items, scale, hyper))
        plain_ms = cuda_ms(torch, lambda: kopt.bucket_step_reference(
            cls, clip, gn, mp, plain, scale, hyper), iters=3)
        row = dict(case=label, rule=rule, tensors=len(items),
                   launches_per_update=want[0],
                   misaligned=[list(s) for s in shapes if s == (1000,)],
                   max_abs_err=max(e[0] for e in errs),
                   max_err_over_tol=max(e[1] for e in errs), ms=ms,
                   plain_ms=plain_ms,
                   bound_ms=1e3 * nbytes / HBM_BYTES_PER_S, bound_by="bytes")
        say("kernel_case_opt " + json.dumps(row))
        rows.append(row)
        norm_grads.append((label, [it[2] for it in items]))

    # the global-norm kernels: against the plain sum (rtol 1e-5: another
    # summation order) and bit for bit against a second run
    for label, gs in norm_grads:
        out = torch.zeros(3, device=dev)
        delta = _kernel_deltas(kopt, lambda: kopt.bucket_sqnorm(
            gs, 0.125, out=out[1]))
        check(delta == (0, 0, 1), f"norm {label}: launches {delta}")
        again = kopt.bucket_sqnorm(gs, 0.125)
        want = topt.Optimizer._fused_sqnorm(gs, 0.125)
        rel = ((out[1] - want).abs() / want).item()
        same = bool(torch.equal(out[1], again))
        row = dict(case=f"sqnorm_{label}", tensors=len(gs),
                   dtype=str(gs[0].dtype).removeprefix("torch."),
                   value=out[1].item(), plain=want.item(), rel_err=rel,
                   tol=1e-5, bitwise_repeat=same)
        say("kernel_case_opt " + json.dumps(row))
        check(rel <= 1e-5 and out[0].item() == 0 and out[2].item() == 0,
              f"norm {label}: {out.tolist()} against {want.item()}")
        check(same, f"norm {label}: two runs differ")
        rows.append(row)
    return rows


def opt_plan(kopt, trainer):
    """What ``update_fused`` makes of the trainer's trainable parameters:
    its buckets (by dtype and multi-precision), the ladder launches of an
    update, and the tensors."""
    opt, sizes = trainer.optimizer, {}
    for i, p in enumerate(trainer._params):
        if p.grad_req == "null":
            continue
        w, st = p._tensor(), trainer._states[i]
        key = (str(w.dtype), opt._is_mp_state(w, st))
        sizes[key] = sizes.get(key, 0) + 1
    return dict(buckets=len(sizes),
                launches=sum(-(-n // kopt.TABLE_CAPACITY)
                             for n in sizes.values()),
                tensors=sum(sizes.values()))


def phase_opt_sweep(torch, kopt, topt, dispatch, trainer, path):
    """The optimizer over every trainable parameter of a trained model, as
    ``update_fused`` issues it: bucketed by (dtype, multi-precision), each
    parameter with the optimizer's own lr, wd and next update count. On
    copies of the Trainer's weights and states, three designs: one launch
    per bucket (``bucket_step``), the first port's one launch per
    parameter (``param_step`` for each) and the plain ladder; held against
    each other after one update, then timed alone (summed kernel events
    of the profiler) and host-issued (CUDA events around back-to-back host
    calls). Alone, each design runs in turn on copies of its tensors that
    together exceed twice the L2, so that it reads them from HBM as the
    bound assumes (:func:`cold_copies`); host-issued, on one set. Under
    ``clip_global_norm`` the norm kernels over the same buckets, the same
    ways. As an indication only (another function: no bf16 copy, torch's
    own bias correction and epsilon placement), torch's fused AdamW or SGD
    over f32 copies of the same masters."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(5)
    opt = trainer.optimizer
    cls, clip = type(opt), opt.clip_gradient
    hyper = dict(opt._hyper(), rescale_grad=1.0 / 8)
    gn = opt.clip_global_norm is not None
    scale = 0.5 if gn else 1.0
    sides = {"bucket": {}, "per_parameter": {}, "plain": {},
             "device_scalars": {}, "before": {}}
    for i, p in enumerate(trainer._params):
        if p.grad_req == "null":
            continue
        w, st = p._tensor().detach(), trainer._states[i]
        mp = opt._is_mp_state(w, st)
        g = (torch.randn(w.shape, device=dev, generator=gen) * 0.01
             ).to(w.dtype)
        scal = (opt._get_lr(i), opt._get_wd(i),
                opt._index_update_count.get(i, 0) + 1)
        for side in sides.values():
            side.setdefault((str(w.dtype), mp), []).append(
                (w.clone(), _clone_state(st), g) + scal)
    before = sides.pop("before")
    nbytes = sum(_bucket_bytes(dispatch, kopt, items, mp)
                 for (_, mp), items in before.items())
    gbytes = sum(it[2].numel() * it[2].element_size()
                 for items in before.values() for it in items)

    def bucket(side):
        for (_, mp), items in side.items():
            kopt.bucket_step(cls, clip, gn, mp, items, scale, hyper)

    def per_parameter(side):
        for (_, mp), items in side.items():
            for it in items:
                kopt.param_step(cls, clip, gn, mp, *it, scale, hyper)

    def plain(side):
        for (_, mp), items in side.items():
            kopt.bucket_step_reference(cls, clip, gn, mp, items, scale,
                                       hyper)

    # K3's entry for captured graphs: the same bucket, each tensor's
    # scalars and the rescale read from rows on the card (no global-norm
    # scale: TrainStep runs none, so it is held to the by-value entry
    # without one below, and timed here on the same bytes)
    rows = {key: torch.from_numpy(kopt.ladder_scalars(
        cls, hyper, hyper["rescale_grad"], [tuple(it[3:6]) for it in items]
    )).to(dev) for key, items in before.items()}

    def device_scalars(side):
        for (key, items) in side.items():
            kopt.bucket_step_dev(cls, clip, key[1],
                                 [it[:3] for it in items], rows[key], hyper)

    designs = {"bucket": bucket, "per_parameter": per_parameter,
               "plain": plain, "device_scalars": device_scalars}
    n = sum(len(items) for items in before.values())
    deltas = {k: _kernel_deltas(kopt, lambda k=k: fn(sides[k]))
              for k, fn in designs.items()}
    torch.cuda.synchronize()
    check(deltas == {"bucket": (len(before), n, 0),
                     "per_parameter": (n, n, 0), "plain": (0, 0, 0),
                     "device_scalars": (len(before), n, 0)},
          f"{path} sweep: launches, tensors, norms {deltas} for {n} "
          f"tensors in {len(before)} buckets")
    # the device-scalar entry against the by-value entry, bit for bit
    by_value = {key: [(w.clone(), _clone_state(st), g) + tuple(rest)
                      for w, st, g, *rest in items]
                for key, items in before.items()}
    on_card = {key: [(w.clone(), _clone_state(st), g) + tuple(rest)
                     for w, st, g, *rest in items]
               for key, items in before.items()}
    for (_, mp), items in by_value.items():
        kopt.bucket_step(cls, clip, False, mp, items, 1.0, hyper)
    device_scalars(on_card)
    torch.cuda.synchronize()
    dev_diff = max((a.float() - b.float()).abs().max().item()
                   for key in before
                   for x, y in zip(by_value[key], on_card[key])
                   for a, b in zip(kopt._leaves(x[:2]), kopt._leaves(y[:2])))
    say(f"{path} sweep: K3 device-scalar entry vs by-value entry over "
        f"{n} tensors: largest difference {dev_diff}")
    check(dev_diff == 0, f"{path} sweep: the device-scalar entry differs "
                         f"from the by-value entry by {dev_diff}")
    del by_value, on_card
    errs = []
    for key, items in before.items():
        for j, b in enumerate(items):
            for design in ("bucket", "per_parameter"):
                errs.append(check_ladder(
                    f"{path} sweep {design} {key} parameter {j}", kopt,
                    sides[design][key][j][:2], sides["plain"][key][j][:2],
                    b[:2]))
    del before
    row = dict(path=path, rule=cls.__name__, parameters=n,
               buckets=len(sides["bucket"]), bytes=nbytes,
               device_scalars_max_diff=dev_diff,
               bound_ms=1e3 * nbytes / HBM_BYTES_PER_S, bound_by="bytes",
               max_abs_err=max(e[0] for e in errs),
               max_err_over_tol=max(e[1] for e in errs))
    n_sets = min(64, max(2, -(-2 * L2_BYTES // nbytes) + 1))
    for k, fn in designs.items():
        sets = [sides[k]] + [
            {key: [(w.clone(), _clone_state(st), g.clone()) + tuple(rest)
                   for w, st, g, *rest in items]
             for key, items in sides[k].items()} for _ in range(n_sets - 1)]
        row[f"{k}_ms"] = device_ms(torch, [partial(fn, x) for x in sets],
                                   iters=max(5, n_sets))
        row[f"{k}_ms_host_issued"] = cuda_ms(torch, partial(fn, sides[k]),
                                             iters=5)
        del sets
    row["copies_alone"] = n_sets
    # the card's copy rate by the same method: y.copy_(x) moving as many
    # bytes as the update (half read, half written), over as many copies
    half = max(1, nbytes // 8)
    pairs = [(torch.empty(half, device=dev), torch.empty(half, device=dev))
             for _ in range(n_sets)]
    row["copy_ms"] = device_ms(
        torch, [partial(y.copy_, x) for x, y in pairs], iters=max(5, n_sets))
    del pairs
    # an indication only: torch's fused rule over f32 copies of the masters
    lparams = []
    for (_, mp), items in sides["plain"].items():
        for w, st, g, *_ in items:
            lp = torch.nn.Parameter((st[0] if mp else w).float().clone())
            lp.grad = g.float()
            lparams.append(lp)
    if cls.__name__ == "AdamW":
        lopt = torch.optim.AdamW(lparams, lr=1e-4, weight_decay=0.01,
                                 fused=True)
    else:
        lopt = torch.optim.SGD(lparams, lr=0.1, momentum=0.9,
                               weight_decay=1e-4, fused=True)
    row["library"] = f"torch.optim.{type(lopt).__name__}(fused=True).step"
    row["library_ms"] = device_ms(torch, [lopt.step], iters=5)
    row["library_ms_host_issued"] = cuda_ms(torch, lopt.step, iters=5)
    del lparams, lopt
    row["norm"] = None
    if gn:
        gss = [[it[2] for it in items] for items in sides["bucket"].values()]
        sums = torch.zeros(len(gss), device=dev)
        psums = torch.zeros(len(gss), device=dev)
        rescale = hyper["rescale_grad"]

        def norm(out=sums):
            for k, gs in enumerate(gss):
                kopt.bucket_sqnorm(gs, rescale, out=out[k])

        def norm_plain():
            for k, gs in enumerate(gss):
                kopt.bucket_sqnorm_reference(gs, rescale, out=psums[k])

        check(_kernel_deltas(kopt, norm) == (0, 0, len(gss)),
              f"{path} norm: not one launch per bucket")
        norm_plain()
        again = torch.zeros_like(sums)
        norm(again)
        rel = ((sums - psums).abs() / psums).max().item()
        check(rel <= 1e-5 and torch.equal(sums, again),
              f"{path} norm: {sums.tolist()} {again.tolist()} against "
              f"{psums.tolist()}")
        total_norm = getattr(torch.nn.utils, "get_total_norm", None)
        grads = [g for gs in gss for g in gs]
        row["norm"] = dict(
            buckets=len(gss), rel_err=rel, tol=1e-5, bitwise_repeat=True,
            max_abs_err=(sums - psums).abs().max().item(),
            ms=device_ms(torch, [norm], iters=5),
            ms_host_issued=cuda_ms(torch, norm, iters=5),
            plain_ms=device_ms(torch, [norm_plain], iters=5),
            plain_ms_host_issued=cuda_ms(torch, norm_plain, iters=5),
            bound_ms=1e3 * gbytes / HBM_BYTES_PER_S, bound_by="bytes",
            bytes=gbytes,
            indication="torch.nn.utils.get_total_norm (another function: "
                       "the norm of the unscaled gradients)",
            indication_ms=None if total_norm is None else device_ms(
                torch, [lambda: total_norm(grads)], iters=5))
    say("opt_sweep " + json.dumps(row))
    return row


def resnet50_bn_sites(batch):
    """``[(NHWC shape, sites)]``: the 53 BatchNorm sites of ResNet-50 v1 at
    224x224, by shape. The stem's at 112x112; in each stage two of the
    three per bottleneck have C/4 channels, the third and the downsample's
    C (the first block strides in its first 1x1 convolution)."""
    sites, hw = [((batch, 112, 112, 64), 1)], 56
    for i, (blocks, c) in enumerate(zip((3, 4, 6, 3), (256, 512, 1024, 2048))):
        hw = hw // 2 if i else hw
        sites += [((batch, hw, hw, c // 4), 2 * blocks),
                  ((batch, hw, hw, c), blocks + 1)]
    return sites


def bn_bounds(shape, itemsize):
    """Least ms of the forward and the backward by bytes, each input read
    once and each output written once: x in, out out; x and dy in, dx out.
    Per-channel vectors are ignored. (The operations, some 10 per element
    on the f32 pipes, take a twentieth of that.)"""
    n = 1
    for d in shape:
        n *= d
    return (1e3 * 2 * n * itemsize / HBM_BYTES_PER_S,
            1e3 * 3 * n * itemsize / HBM_BYTES_PER_S)


def ptxas_report(log, fragment):
    """``{kernel: [registers, spill stores, spill loads]}`` of the kernels
    whose mangled name holds ``fragment``, from an ``-Xptxas -v`` log."""
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and fragment in name and "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split()
                    if w.isdigit()]
            out.setdefault(name, [None, nums[1], nums[2]])
        elif name and fragment in name and "registers" in line:
            words = line.split()
            out.setdefault(name, [None, 0, 0])[0] = int(
                words[words.index("registers,") - 1])
    return out


def bn_operands(torch, gen, dev, shape, axis, dt, cts, misalign):
    """x, dy (views ``misalign`` elements into their storage), gamma, beta,
    shift and the cotangents of mean and var (zeros unless ``cts``)."""
    c, n = shape[axis], math.prod(shape)

    def tensor(scale, offset):
        t = torch.randn(n + misalign, device=dev, generator=gen)
        return (t * scale + offset).to(dt)[misalign:].view(shape)

    x, dy = tensor(2, 1), tensor(1, 0)
    g = torch.rand(c, device=dev, generator=gen) + 0.5
    b = torch.randn(c, device=dev, generator=gen)
    sh = torch.randn(c, device=dev, generator=gen) * 0.1 + 1
    dm, dv = ((torch.randn(c, device=dev, generator=gen),
               torch.randn(c, device=dev, generator=gen)) if cts
              else (torch.zeros(c, device=dev),) * 2)
    return x, dy, g, b, sh, dm, dv


def phase_kernels_bn(torch, knorm, dispatch, build):
    """K1 and K2 against their plain versions on the card:
    every BatchNorm shape of ResNet-50 at batch 256 (bf16, NHWC, the
    training path's calls) with times beside the bound, the plain versions
    and cuDNN's ``F.batch_norm`` (training, on the channels_last view; its
    backward through autograd): another function (zero shift, unbiased
    running variance, no running stats here), the same work. Then NCHW f32,
    the stem's NHWC shape in f32 at batch 32 (the comparison of whole
    steps runs there), ragged rows with C = 3 and with C = 8, a view whose
    base is not on 16 bytes, ``MXTPU_BN_COMPUTE=bf16`` and non-zero
    cotangents of the batch statistics. Every case: the path
    ``launch_geometry`` chooses (16-byte vector or scalar) is the one the
    case is there for, and a second launch of each kernel on the
    same inputs repeats the bits. Times per site: kernel alone with the
    inputs rotated over copies that exceed the L2 (L2-cold, the method of
    the attention rows) and on the same inputs (L2-warm), host-issued back
    to back (``cuda_ms``), and ``y.copy_(x)`` of the same tensor, the
    rate this card reaches for that many bytes; beside the read-once bound,
    the time of the bytes the kernels' own design moves (x read twice in
    each direction: ``dispatch.norm_region_bytes``' kernel side)."""
    import torch.nn.functional as F

    ptx = ptxas_report((build.BUILD_DIR / "bn_train.log").read_text(),
                       "bn_")
    say("bn ptxas (registers, spill stores, spill loads): "
        + json.dumps({k.split("bn_train_cu")[-1]: v for k, v in ptx.items()
                      if "_vec_" in k}))
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(77)
    bf16 = torch.bfloat16
    cases = [(f"resnet50_{s[1]}x{s[2]}x{s[3]}", s, -1, bf16, "f32", False, 0,
              k) for s, k in resnet50_bn_sites(256)]
    cases += [("nchw_f32", (32, 64, 56, 56), 1, torch.float32, "f32", True,
               0, 0),
              ("stem_nhwc_f32_b32", (32, 112, 112, 64), -1, torch.float32,
               "f32", True, 0, 0),
              ("ragged_c3_f32", (7, 13, 17, 3), -1, torch.float32, "f32",
               False, 0, 0),
              ("ragged_c8_bf16", (3, 7, 11, 8), -1, bf16, "f32", True, 0, 0),
              ("misaligned_bf16", (4, 9, 9, 64), -1, bf16, "f32", True, 1, 0),
              ("compute_bf16", (256, 14, 14, 1024), -1, bf16, "bf16", True, 0,
               0),
              ("cotangents_bf16", (256, 28, 28, 512), -1, bf16, "f32", True,
               0, 0),
              # channels not last: a 49-element plane, planes, a view off
              # 16 bytes, bf16 elementwise math
              ("nchw_7x7_bf16", (64, 160, 7, 7), 1, bf16, "f32", True, 0, 0),
              ("nchw_planes_bf16", (24, 8, 224, 224), 1, bf16, "f32", True,
               0, 0),
              ("nchw_misaligned_bf16", (4, 40, 9, 11), 1, bf16, "f32", True,
               1, 0),
              ("nchw_compute_bf16", (64, 96, 14, 14), 1, bf16, "bf16", True,
               0, 0)]
    rows = []
    for label, shape, axis, dt, compute, cts, misalign, sites in cases:
        row, ops = bn_case(torch, knorm, gen, dev, label, shape, axis,
                           dt, compute, cts, misalign)
        row["sites"] = sites
        if sites:
            row.update(bn_site_times(torch, F, knorm, dispatch, *ops,
                                     axis % len(shape)))
        say("kernel_case_bn " + json.dumps(row))
        rows.append(row)
        del ops
        torch.cuda.empty_cache()
    timed = [r for r in rows if r["sites"]]
    check(sum(r["sites"] for r in timed) == 53, "ResNet-50 has 53 BN sites")
    total = {key: sum(r[key] * r["sites"] for r in timed) for key in (
        "fwd_ms", "bwd_ms", "fwd_ms_l2_warm", "bwd_ms_l2_warm",
        "fwd_ms_host_issued", "bwd_ms_host_issued", "copy_ms",
        "plain_fwd_ms", "plain_bwd_ms", "library_fwd_ms", "library_bwd_ms",
        "library_fwd_ms_host_issued", "library_bwd_ms_host_issued",
        "fwd_bound_ms", "bwd_bound_ms", "fwd_design_ms", "bwd_design_ms")}
    largest = sorted(timed, key=lambda r: -math.prod(r["shape"]))[:3]
    summary = dict(
        resnet50_batch256_53_sites=total,
        largest_sites=[{k: r[k] for k in (
            "case", "sites", "fwd_ms", "bwd_ms", "fwd_ms_host_issued",
            "bwd_ms_host_issued", "copy_ms", "fwd_bound_ms", "bwd_bound_ms",
            "plain_fwd_ms", "plain_bwd_ms", "library_fwd_ms",
            "library_bwd_ms")} for r in largest],
        fwd_max_abs_err=max(r["out_max_abs_err"] for r in timed),
        bwd_max_abs_err=max(r["dx_max_abs_err"] for r in timed),
        ptxas={k.split("bn_train_cu")[-1]: v for k, v in ptx.items()},
        card=card_line())
    say("bn_kernels " + json.dumps(summary))
    return summary


#: the kernels of csrc/bn_train.cu each regime launches, by direction
BN_REGIME_KERNELS = {
    "last": lambda d: {f"bn_{d}_partials_kernel", f"bn_{d}_combine_kernel",
                       f"bn_{d}_apply_kernel"},
    "vector": lambda d: {f"bn_{d}_partials_vec_kernel",
                         f"bn_{d}_combine_kernel", f"bn_{d}_apply_vec_kernel"},
    "planes": lambda d: {f"bn_{d}_planes_partials_kernel",
                         f"bn_{d}_planes_apply_kernel"},
    "resident": lambda d: {f"bn_{d}_resident_kernel"}}


def bn_geometries(knorm, x, dy, axis):
    """K1's and K2's :class:`launch_geometry` at x's shape on its card, as
    the wrappers take it."""
    dev = x.device
    aligned = x.data_ptr() % 16 == 0 and dy.data_ptr() % 16 == 0
    return [knorm.launch_geometry(
        x.shape, axis, x.element_size(), knorm.sm_count(dev), aligned,
        backward, knorm.smem_per_block(dev)) for backward in (False, True)]


def bn_resident(knorm, x, dy, axis):
    """Whether K1 and K2 run resident at x's shape."""
    return tuple(g.regime == "resident"
                 for g in bn_geometries(knorm, x, dy, axis))


class _KernelNodeParams(ctypes.Structure):
    """CUDA_KERNEL_NODE_PARAMS_v2 of cuda.h (CUDA 12): the function, grid
    and block dimensions, shared bytes, arguments, kernel, context."""
    _fields_ = [("func", ctypes.c_void_p), ("dims", ctypes.c_uint * 7),
                ("params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


def graph_kernels(torch, fn):
    """The CUDA kernels one call of ``fn`` launches, counted in a CUDA graph
    that captured the call: each kernel node's function, by libcuda's
    name for it (a ``bn_*`` kernel's shortened to the template's), in the
    graph's node order. Copies and memsets are nodes of other types and
    are not in it. The call runs once first, as a capture needs."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")
    vp, size = ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)
    for fname, args in (("cuGraphGetNodes", [vp, vp, size]),
                        ("cuGraphNodeGetType", [vp, ctypes.POINTER(
                            ctypes.c_int)]),
                        ("cuGraphKernelNodeGetParams_v2", [
                            vp, ctypes.POINTER(_KernelNodeParams)]),
                        ("cuFuncGetName", [ctypes.POINTER(ctypes.c_char_p),
                                           vp]),
                        ("cuKernelGetName", [ctypes.POINTER(ctypes.c_char_p),
                                             vp])):
        getattr(cu, fname).argtypes = args
        getattr(cu, fname).restype = ctypes.c_int

    def drv(err, what):
        check(err == 0, f"graph_kernels: {what} returned CUresult {err}")

    raw, n = vp(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    drv(cu.cuGraphGetNodes(raw, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (vp * n.value)()
    drv(cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    names = []
    for node in nodes[:n.value]:
        kind = ctypes.c_int(-1)
        drv(cu.cuGraphNodeGetType(node, ctypes.byref(kind)),
            "cuGraphNodeGetType")
        if kind.value != 0:                     # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        params, name = _KernelNodeParams(), ctypes.c_char_p()
        drv(cu.cuGraphKernelNodeGetParams_v2(node, ctypes.byref(params)),
            "cuGraphKernelNodeGetParams_v2")
        if params.func:
            drv(cu.cuFuncGetName(ctypes.byref(name), params.func),
                "cuFuncGetName")
        else:
            drv(cu.cuKernelGetName(ctypes.byref(name), params.kern),
                "cuKernelGetName")
        full = (name.value or b"").decode()
        m = re.search(r"(bn_(?:fwd|bwd)_\w*?kernel)", full)
        names.append(m.group(1) if m else full)
    graph.reset()
    return names


def bn_case(torch, knorm, gen, dev, label, shape, axis, dt, compute, cts,
            misalign):
    """K1 and K2 against their plain versions on one case (the checks of
    :func:`phase_kernels_bn`): ``(row, (x, dy, g, b, sh, want_f,
    bwd_args))``, the operands for :func:`bn_site_times`."""
    os.environ["MXTPU_BN_COMPUTE"] = compute
    try:
        axis = axis % len(shape)
        x, dy, g, b, sh, dm, dv = bn_operands(torch, gen, dev, shape,
                                              axis, dt, cts, misalign)
        got_f = knorm.bn_train_fwd(x, g, b, sh, 1e-5, axis)
        want_f = knorm.bn_train_fwd_reference(x, g, b, sh, 1e-5, axis)
        bwd_args = (x, g, sh, want_f[1], want_f[3], dy, dm, dv, axis)
        got_b = knorm.bn_train_bwd(*bwd_args)
        want_b = knorm.bn_train_bwd_reference(*bwd_args)
        again = (knorm.bn_train_fwd(x, g, b, sh, 1e-5, axis)
                 + knorm.bn_train_bwd(*bwd_args))
        torch.cuda.synchronize()
        check(all(torch.equal(a, w) for a, w in zip(got_f + got_b, again)),
              f"bn {label}: a second launch on the same inputs gave "
              "other bits")
        geoms = bn_geometries(knorm, x, dy, axis)
        vector = geoms[0].regime == "vector"
        # channels innermost among the dims of size > 1 (an NCHW site at
        # 1x1 too), 16-byte rows, aligned bases
        check(vector == (math.prod(shape[axis + 1:]) == 1 and misalign == 0
                         and shape[axis] * x.element_size() % 16 == 0),
              f"bn {label}: launch_geometry chose the "
              f"{'vector' if vector else 'scalar'} path")
        # channels not last: a plane regime, never a channels-last one
        nchw = math.prod(shape[axis + 1:]) > 1
        check(all((g.regime in ("planes", "resident")) == nchw
                  for g in geoms),
              f"bn {label}: regimes {[g.regime for g in geoms]}")
        seen = [graph_kernels(torch, fn) for fn in (
            lambda: knorm.bn_train_fwd(x, g, b, sh, 1e-5, axis),
            lambda: knorm.bn_train_bwd(*bwd_args))]
        # the kernels one call launched, counted in its captured graph:
        # each of the regime's own once, and no other of bn_train.cu
        launched = [[n for n in got if n.startswith("bn_")] for got in seen]
        for side, mine, geo in zip(("fwd", "bwd"), launched, geoms):
            check(sorted(mine) == sorted(BN_REGIME_KERNELS[geo.regime](side))
                  and len(mine) == knorm.cuda_launches(geo),
                  f"bn {label}: kernels launched {seen} for regimes "
                  f"{[g.regime for g in geoms]}")
        errs = {}
        for key, a, w in (("out", got_f[0], want_f[0]),
                          ("dx", got_b[0], want_b[0])):
            errs[key] = (a.float() - w.float()).abs().max().item()
            errs[key + "_scale"] = w.float().abs().max().item()
        stat_err = max((a - w).abs().max().item() / max(
            w.abs().max().item(), 1e-30) for a, w in zip(
                got_f[1:] + got_b[1:], want_f[1:] + want_b[1:]))
        check(all(bool(torch.isfinite(t.float()).all())
                  for t in (got_f[0], got_b[0])),
              f"bn {label}: non-finite output")
        # statistics and dgamma/dbeta: f32 sums in another order. out
        # and dx: rounded once to x's dtype (bf16: 2^-8 of the value);
        # with bf16 elementwise math a coefficient may round to the
        # neighbouring bf16 value too: 2^-6 of the largest value
        tol = (2.0 ** -6 if compute == "bf16" else 2.0 ** -7
               if dt == torch.bfloat16 else 1e-5)
        check(stat_err <= 1e-4,
              f"bn {label}: statistics or dgamma/dbeta disagree with "
              f"the plain version: {stat_err:.3g} relative")
        for key in ("out", "dx"):
            check(errs[key] <= tol * max(1.0, errs[key + "_scale"]),
                  f"bn {label}: {key} disagrees with the plain version: "
                  f"{errs[key]:.3g} (scale {errs[key + '_scale']:.3g})")
        row = dict(case=label, shape=list(shape), axis=axis,
                   dtype=str(dt).replace("torch.", ""), compute=compute,
                   nonzero_cotangents=cts, misaligned=bool(misalign),
                   vector_path=vector,
                   regime={"fwd": geoms[0].regime, "bwd": geoms[1].regime},
                   chunks={"fwd": geoms[0].chunks, "bwd": geoms[1].chunks},
                   cuda_launches={"fwd": len(launched[0]),
                                  "bwd": len(launched[1])},
                   kernels_launched={"fwd": seen[0], "bwd": seen[1]},
                   bitwise_repeat=True,
                   out_max_abs_err=errs["out"], dx_max_abs_err=errs["dx"],
                   stats_max_rel_err=stat_err)
        return row, (x, dy, g, b, sh, want_f, bwd_args)
    finally:
        os.environ.pop("MXTPU_BN_COMPUTE", None)


def bn_site_times(torch, F, knorm, dispatch, x, dy, g, b, sh, want_f,
                  bwd_args, axis):
    """The times of one BatchNorm site (ms; the docstring of
    :func:`phase_kernels_bn`): channels last (ResNet-50's, cuDNN on the
    channels_last view) or, with ``axis`` 1, NCHW as it is."""
    shape, esize = tuple(x.shape), x.element_size()
    fwd_bound, bwd_bound = bn_bounds(shape, esize)
    n = math.prod(shape)
    resident = bn_resident(knorm, x, dy, axis)
    cold_f = cold_copies(torch, [x])
    cold_b = cold_copies(torch, [x, dy])
    fwd = partial(knorm.bn_train_fwd, gamma=g, beta=b, shift=sh, eps=1e-5,
                  axis=axis)
    _, _, mean, inv = want_f

    def bwd(xc, dyc):
        return knorm.bn_train_bwd(xc, g, sh, mean, inv, dyc, *bwd_args[6:])

    def nchw(t):
        return t if axis == 1 else t.movedim(-1, 1)

    xl = nchw(x.detach()).requires_grad_()
    gl, bl = (t.detach().requires_grad_() for t in (g, b))
    yl = F.batch_norm(xl, None, None, gl, bl, training=True, eps=1e-5)
    dyl = nchw(dy)
    lib_cold = [(nchw(c[0]).requires_grad_(),) for c in cold_f]
    lib_graphs = [(F.batch_norm(c[0], None, None, gl, bl, training=True,
                                eps=1e-5), c[0]) for c in lib_cold]
    y = torch.empty_like(x)
    times = dict(
        fwd_ms=device_ms(torch, [partial(fwd, c[0]) for c in cold_f]),
        bwd_ms=device_ms(torch, [partial(bwd, *c) for c in cold_b]),
        plain_fwd_ms=cuda_ms(torch, lambda: knorm.bn_train_fwd_reference(
            x, g, b, sh, 1e-5, axis), iters=5),
        plain_bwd_ms=cuda_ms(torch, lambda: knorm.bn_train_bwd_reference(
            *bwd_args), iters=5),
        library_fwd_ms=device_ms(torch, [partial(
            F.batch_norm, c[0], None, None, gl, bl, training=True, eps=1e-5)
            for c in lib_cold]),
        library_bwd_ms=device_ms(torch, [partial(
            torch.autograd.grad, yc, (xc, gl, bl), dyl, retain_graph=True)
            for yc, xc in lib_graphs]),
        fwd_bound_ms=fwd_bound, bwd_bound_ms=bwd_bound, bound_by="bytes",
        # the design's own bytes: x twice and out once; x, dy twice, dx
        # once; resident, each once
        fwd_design_ms=1e3 * (2 if resident[0] else 3) * n * esize
        / HBM_BYTES_PER_S,
        bwd_design_ms=1e3 * (3 if resident[1] else 5) * n * esize
        / HBM_BYTES_PER_S,
        fwd_ms_l2_warm=device_ms(torch, [partial(fwd, x)]),
        bwd_ms_l2_warm=device_ms(torch, [partial(bwd, x, dy)]),
        fwd_ms_host_issued=cuda_ms(torch, partial(fwd, x)),
        bwd_ms_host_issued=cuda_ms(torch, partial(bwd, x, dy)),
        copy_ms=device_ms(torch, [partial(y.copy_, c[0]) for c in cold_f]),
        library_fwd_ms_host_issued=cuda_ms(torch, lambda: F.batch_norm(
            xl, None, None, gl, bl, training=True, eps=1e-5)),
        library_bwd_ms_host_issued=cuda_ms(
            torch, lambda: torch.autograd.grad(yl, (xl, gl, bl), dyl,
                                               retain_graph=True)))
    design = dispatch.norm_region_bytes(shape, esize, 4, resident)
    check(abs(times["fwd_design_ms"] + times["bwd_design_ms"]
              - 1e3 * design[1] / HBM_BYTES_PER_S) < 1e-9,
          "bn design bytes")
    return times


# -- phase 4 ---------------------------------------------------------------

def phase_model_parity(torch, mt, bert, fa):
    cfg = dict(vocab_size=30522, max_length=512, num_layers=2, units=768,
               hidden_size=3072, num_heads=12)
    ids = torch.randint(0, cfg["vocab_size"], (2, 384),
                        generator=torch.Generator().manual_seed(5),
                        dtype=torch.int32)
    seg = torch.zeros_like(ids)
    outs = {}
    for where in (mt.gpu(0), mt.cpu()):
        net = bert.BERTForQA(bert.get_bert_model("bert_12_768_12", **cfg))
        net.initialize(device=where,
                       generator=torch.Generator().manual_seed(0))
        net.hybridize()
        fp32 = fa.VARIANT_LAUNCHES[fa.KERNEL]
        before = (fa.LAUNCHES.value, fp32["fp32"].value, fp32["mma"].value)
        start, end = net.call_cached_graph(ids.to(where), seg.to(where))
        if where.type == "cuda":
            torch.cuda.synchronize()
            after = (fa.LAUNCHES.value, fp32["fp32"].value, fp32["mma"].value)
            n = cfg["num_layers"]
            check([x - y for x, y in zip(after, before)] == [n, n, 0],
                  "the CUDA forward did not launch the FP32 kernel once per "
                  f"layer: launches, fp32, mma {after} from {before}")
        outs[where.type] = torch.stack([start, end]).float().cpu()
        del net
    err = (outs["cuda"] - outs["cpu"]).abs().max().item()
    scale = outs["cpu"].abs().max().item()
    say(f"model_parity bert 2x768 f32 b2 s384: max_abs_err {err:.3g} "
        f"(max |logit| {scale:.3g}, tol 1e-3)")
    check(bool(torch.isfinite(outs["cuda"]).all()), "non-finite logits")
    check(err <= 1e-3, f"CUDA and CPU BERT disagree: {err:.3g}")
    return err


def phase_gelu(torch):
    """Phase 4b: the exact GELU (ops/nn.py:gelu_exact, 0.5 * x * erfc(-x *
    sqrt_half)) on the card against the CPU on x = -8 ... 8 (and
    cotangents for the f32 gradient): f32 within 2e-6 relative (erfc is
    within 4 ulps on CUDA, 1-2 on the CPU, plus one rounding of the
    product), the f32 gradient within 1e-5 relative, bf16 within 2^-7 (one
    bf16 ulp where the two erfc straddle a rounding boundary, and the
    product's)."""
    from mxnet_tpu_torch.ops import nn as tnn

    x = torch.linspace(-8.0, 8.0, 4097)
    ct = torch.cos(7.0 * x)
    errs = {}
    for dt, rtol in ((torch.float32, 2e-6), (torch.bfloat16, 2 ** -7)):
        sides = []
        for dev in ("cuda", "cpu"):
            xd = x.to(dev, dt).detach().clone().requires_grad_(
                dt == torch.float32)
            y = tnn.gelu_exact(xd)
            if dt == torch.float32:
                y.backward(ct.to(dev))
            sides.append((y.detach().float().cpu(),
                          None if xd.grad is None else xd.grad.cpu()))
        (y, g), (y_cpu, g_cpu) = sides
        err = ((y - y_cpu).abs() / y_cpu.abs().clamp_min(1e-38)).max().item()
        check(err <= rtol, f"gelu {dt}: card vs CPU {err:.3g} relative "
              f"(tol {rtol:.3g})")
        errs[str(dt)] = err
        if g is not None:
            # 1e-5 relative, plus 1e-7 of the largest where the gradient
            # crosses zero (x near -0.75, where its two terms cancel)
            excess = ((g - g_cpu).abs() - 1e-5 * g_cpu.abs()).max().item()
            atol = 1e-7 * g_cpu.abs().max().item()
            check(excess <= atol, f"gelu f32 gradient: card vs CPU beyond "
                  f"1e-5 relative by {excess:.3g} (tol {atol:.3g})")
            errs["grad_float32_excess"] = excess
    say(f"gelu: card vs CPU at x in [-8, 8], worst relative {json.dumps(errs)}")
    return errs


# -- phase 5 ---------------------------------------------------------------

SERVE_SEQ = 384
SERVE_RUNGS = [1, 2, 4, 8]


class EagerServed:
    """The served net without its CUDA graphs: ``call_cached_graph`` runs
    the block's own forward eagerly (what the engine dispatched before the
    rungs were captured), so the same traffic can be served both ways."""

    def __init__(self, net):
        self.net = net
        self.device = net.device

    def call_cached_graph(self, *args):
        import torch

        from mxnet_tpu_torch import autograd

        with autograd.pause(), torch.inference_mode():
            return self.net(*args)

    def jit_trace_count(self, training=False):
        return self.net.jit_trace_count(training)

    def capture_count(self):
        return 0


def serve_plans(torch, seed, clients=2, per_client=16, rows=(1, 5)):
    """Request plans of two client threads: token ids of 1-4 rows each."""
    rs = torch.Generator().manual_seed(seed)
    return [[torch.randint(0, 30522, (int(torch.randint(*rows, (1,),
                                                         generator=rs)),
                                      SERVE_SEQ), generator=rs,
                           dtype=torch.int32)
             for _ in range(per_client)] for _ in range(clients)]


def drive_clients(torch, submit, plans):
    """Each plan from a thread of its own (submit all, then wait for all);
    returns the results, each request's latency from its submit to its
    result in ms, and the wall seconds."""
    results = [[None] * len(p) for p in plans]
    lat = [[None] * len(p) for p in plans]

    def client(k):
        handles = [(time.perf_counter(), submit(ids, torch.zeros_like(ids)))
                   for ids in plans[k]]
        for i, (t0, hd) in enumerate(handles):
            results[k][i] = hd.result(timeout=300)
            lat[k][i] = 1e3 * (time.perf_counter() - t0)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(k,))
               for k in range(len(plans))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    check(not any(t.is_alive() for t in threads), "clients did not finish")
    return results, [x for row in lat for x in row], wall


def quantile(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


def check_held_results(torch, mt, nets_of, plans, results):
    """Every result, read after every request of the run has finished (a
    result that aliased a replay's output would have changed by now):
    finite, of its rows, and within 1e-2 of its largest logit of an eager
    forward of its own rows (bf16 GEMMs of another batch size may sum in
    another order: a pad or neighbour row leaking in would differ by
    O(|logit|)). ``nets_of(k, i)`` is the net that served request i of
    plan k. Returns the largest difference."""
    worst = 0.0
    for k, plan in enumerate(plans):
        for i, (ids, res) in enumerate(zip(plan, results[k])):
            start, end = res
            check(start.shape == (ids.shape[0], SERVE_SEQ), "result shape")
            got = torch.stack([start, end]).float()
            check(bool(torch.isfinite(got).all()), "non-finite result")
            net = nets_of(k, i)
            dev = net.device
            with mt.autograd.pause(), torch.inference_mode():
                ref = torch.stack(net(ids.to(dev), torch.zeros_like(
                    ids).to(dev))).float()
            err = (got - ref).abs().max().item()
            check(err <= 1e-2 * max(1.0, ref.abs().max().item()),
                  f"a served result differs from its direct forward: {err}")
            worst = max(worst, err)
    return worst


def serve_run(torch, mt, eng, net, build, fa, plans, label):
    """One phase-5 run: the counts zeroed just before the clients and read
    just after; gated on the outcomes, no new signature or capture, and
    12 tensor-core attention launches a batch."""
    captures = net.capture_count()
    build.reset_counters()                       # main path: counts from 0
    eng.start()
    results, lat, wall = drive_clients(torch, eng.submit, plans)
    eng.stop()
    launches = fa.LAUNCHES.value                 # read just after
    variants = {v: c.value for v, c in fa.VARIANT_LAUNCHES[fa.KERNEL].items()}
    st = eng.stats()
    n_req = sum(len(p) for p in plans)
    check(st["requests"] == {"ok": n_req}, f"{label}: outcomes {st}")
    check(st["recompiles_since_warmup"] == 0,
          f"{label}: a served shape was new or a rung was captured again")
    check(net.capture_count() == captures, f"{label}: captured online")
    check(launches == 12 * st["dispatches"] and launches > 0,
          f"{label}: kernel launches {launches} != 12 x {st['dispatches']} "
          "batches")
    check(variants == {"mma": launches, "fp32": 0},
          f"{label}: attention variants {variants}: all {launches} must be "
          "the tensor-core kernel's")
    return results, dict(
        requests=n_req, rows=sum(p.shape[0] for pl in plans for p in pl),
        batches=st["dispatches"], avg_batch_rows=st["avg_batch_rows"],
        max_inflight_seen=st["max_inflight_seen"],
        req_per_s=n_req / wall, wall_s=wall,
        p50_ms=quantile(lat, 0.5), p99_ms=quantile(lat, 0.99),
        stats_p50_ms_bucket_bound=st["p50_ms"],
        stats_p99_ms_bucket_bound=st["p99_ms"],
        kernel_launches=launches, variant_launches=variants)


def phase_serving(torch, mt, serving, build, fa):
    """BERT-base QA served through the engine's captured rungs (the main
    path), both modes, then the same traffic through the eager forward, a
    replay against an eager forward at each rung, and one batch of 8
    measured both ways in turns."""
    from mxnet_tpu_torch.tools import profile_serving

    dev = mt.gpu(0)
    reserved = torch.cuda.memory_reserved(dev)
    net, eng, info = profile_serving.serving_net(dev, 8)
    check(info["graphs"] == dict.fromkeys(SERVE_RUNGS, 1),
          f"warmup did not capture one graph per rung: {info}")
    check(net.capture_count() == len(SERVE_RUNGS) and
          eng.recompiles_since_warmup() == 0, "warmup did not seal")
    pools = {g["shapes"][0][0]: g["pool_bytes"] / 2 ** 30
             for g in net.captured_graphs()}
    say(f"serving warmup: {json.dumps(info)}; graph pools GiB "
        f"{json.dumps(pools)}; reserved after warmup "
        f"{(torch.cuda.memory_reserved(dev) - reserved) / 2 ** 30:.3f} GiB")

    # a replay against the eager forward of the same batch, each rung
    rung_check = {}
    gen = torch.Generator().manual_seed(11)
    for b in SERVE_RUNGS:
        ids = torch.randint(0, 30522, (b, SERVE_SEQ), generator=gen,
                            dtype=torch.int32).to(dev)
        seg = torch.zeros_like(ids)
        got = net.call_cached_graph(ids, seg)
        with mt.autograd.pause(), torch.inference_mode():
            want = net(ids, seg)
        diff = max((g.float() - w.float()).abs().max().item()
                   for g, w in zip(got, want))
        scale = max(w.float().abs().max().item() for w in want)
        rung_check[b] = dict(bitwise=all(torch.equal(g, w) for g, w in
                                         zip(got, want)),
                             max_abs_diff=diff, max_abs_logit=scale)
        check(diff <= 1e-2 * max(1.0, scale),
              f"rung {b}: replay and eager forward differ by {diff}")
    check(net.capture_count() == len(SERVE_RUNGS), "captured after warmup")
    say(f"serving replay vs eager per rung: {json.dumps(rung_check)}")

    runs = {}
    for mode, seed in (("pipelined", 7), ("sync", 8)):
        plans = serve_plans(torch, seed)
        if mode == "sync":
            eng = serving.InferenceEngine(net, name="bert_qa_sync",
                                          max_batch_size=8, timeout_ms=0,
                                          mode="sync")
            again = eng.warmup(torch.zeros((1, SERVE_SEQ),
                                           dtype=torch.int32),
                               torch.zeros((1, SERVE_SEQ),
                                           dtype=torch.int32))
            check(again["graphs"] == dict.fromkeys(SERVE_RUNGS, 0),
                  f"a second engine captured again: {again}")
        results, runs[f"graph_{mode}"] = serve_run(
            torch, mt, eng, net, build, fa, plans, f"serving {mode}")
        runs[f"graph_{mode}"]["max_abs_err_vs_direct"] = check_held_results(
            torch, mt, lambda k, i: net, plans, results)
    # the same pipelined traffic, the forward eager
    plans = serve_plans(torch, 7)
    eager = EagerServed(net)
    eng = serving.InferenceEngine(eager, name="bert_qa_eager",
                                  max_batch_size=8, timeout_ms=0)
    eng.warmup(torch.zeros((1, SERVE_SEQ), dtype=torch.int32),
               torch.zeros((1, SERVE_SEQ), dtype=torch.int32))
    results, runs["eager_pipelined"] = serve_run(
        torch, mt, eng, net, build, fa, plans, "serving eager")
    runs["eager_pipelined"]["max_abs_err_vs_direct"] = check_held_results(
        torch, mt, lambda k, i: net, plans, results)

    # one batch of 8, graph against eager in turns
    ids = torch.randint(0, 30522, (8, SERVE_SEQ), generator=gen,
                        dtype=torch.int32).to(dev)
    profile, same = profile_serving.graph_against_eager(
        net, ids, torch.zeros_like(ids), 10)
    check(net.capture_count() == len(SERVE_RUNGS), "captured while "
                                                   "profiled")
    summary = dict(warmup=info, graph_pools_gib=pools, rungs=rung_check,
                   runs=runs, profile_batch8=profile,
                   profile_replay_equals_eager_bitwise=same,
                   variant_launches=runs["graph_pipelined"][
                       "variant_launches"], card=card_line())
    say(f"serving: {json.dumps(summary)}")
    del net, eng, eager
    gc_collect(torch)
    return summary


# -- phase 5b --------------------------------------------------------------

def phase_frontdoor(torch, mt, serving, build, fa):
    """Two BERT-base replicas (seeds 0 and 1) behind one FrontDoor on the
    card: the first serves two client threads while the second warms up
    (captures its rungs), then both serve. Counts from 0 just before the
    clients: every attention launch is the tensor-core kernel's, 12 a
    served batch plus the second replica's warm-up forwards (three a rung:
    the eager first call, the eager run on the capture stream before the
    capture, and the replay that answers the capturing call), none lost
    to or added by the capture running beside the first replica's
    replays."""
    from mxnet_tpu_torch.tools import profile_serving

    dev = mt.gpu(0)
    net0, eng0, _ = profile_serving.serving_net(dev, 8, name="bert_qa/0")
    net1 = profile_serving.bert_qa(dev, seed=1)
    eng1 = serving.InferenceEngine(net1, name="bert_qa/1", max_batch_size=8,
                                   timeout_ms=0)
    fd = serving.FrontDoor(
        [eng0, eng1], name="bert_qa",
        health_check=lambda e: e.started and e.admission_state() == "ok")
    nets = {"bert_qa/0": net0, "bert_qa/1": net1}
    build.reset_counters()                       # main path: counts from 0
    eng0.start()
    stop = threading.Event()
    done = [[], []]

    def client(k):                   # closed loop until stopped, 8 at least
        gen = torch.Generator().manual_seed(40 + k)
        while not stop.is_set() or len(done[k]) < 8:
            ids = torch.randint(0, 30522, (int(torch.randint(
                1, 5, (1,), generator=gen)), SERVE_SEQ), generator=gen,
                dtype=torch.int32)
            req = fd.submit(ids, torch.zeros_like(ids))
            req.result(timeout=300)
            done[k].append((ids, req))

    threads = [threading.Thread(target=client, args=(k,)) for k in (0, 1)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    before = fd.stats()["replicas"]["bert_qa/0"]["routed"]
    info1 = eng1.warmup(torch.zeros((1, SERVE_SEQ), dtype=torch.int32),
                        torch.zeros((1, SERVE_SEQ), dtype=torch.int32))
    served_during = fd.stats()["replicas"]["bert_qa/0"]["routed"] - before
    eng1.start()
    while fd.stats()["replicas"]["bert_qa/1"]["routed"] < 8 and \
            time.perf_counter() - t0 < 300:
        time.sleep(0.01)
    stop.set()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    check(not any(t.is_alive() for t in threads), "clients did not finish")
    fd.stop()
    launches = fa.LAUNCHES.value                 # read just after
    variants = {v: c.value for v, c in fa.VARIANT_LAUNCHES[fa.KERNEL].items()}
    st = {e.name: e.stats() for e in (eng0, eng1)}
    routing = fd.stats()
    check(info1["graphs"] == dict.fromkeys(SERVE_RUNGS, 1),
          f"the second replica's warmup: {info1}")
    check(served_during > 0, "the first replica served nothing while the "
                             "second warmed up")
    n_req = sum(len(d) for d in done)
    check(sum(s["requests"].get("ok", 0) for s in st.values()) == n_req
          and all(set(s["requests"]) == {"ok"} for s in st.values()),
          f"front door outcomes {st}")
    check(all(s["recompiles_since_warmup"] == 0 for s in st.values()),
          "a replica met a new shape or captured online")
    batches = sum(s["dispatches"] for s in st.values())
    warm_runs = 3 * len(SERVE_RUNGS)
    check(launches == 12 * (batches + warm_runs),
          f"attention launches {launches} != 12 x ({batches} batches + "
          f"{warm_runs} warm-up forwards)")
    check(variants == {"mma": launches, "fp32": 0},
          f"front door attention variants {variants}")
    plans = [[ids for ids, _ in d] for d in done]
    results = [[req.result() for _, req in d] for d in done]
    worst = check_held_results(torch, mt,
                               lambda k, i: nets[done[k][i][1].model],
                               plans, results)
    summary = dict(
        requests=n_req, wall_s=wall, req_per_s=n_req / wall,
        routed_while_second_warmed=served_during,
        routing={n: r["routed"] for n, r in routing["replicas"].items()},
        batches=batches, kernel_launches=launches,
        variant_launches=variants, max_abs_err_vs_direct=worst,
        second_warmup=info1, stats=st, card=card_line())
    say(f"frontdoor: {json.dumps(summary)}")
    del net0, net1, eng0, eng1, fd
    gc_collect(torch)
    return summary


# -- training parity ---------------------------------------------------------

def phase_train_parity(torch, mt, finetune, fa):
    """One training step of a 2-layer BERT at full width in float32 without
    dropout: the loss and every gradient, once on CUDA (attention forward
    and backward through the kernels) and once on the CPU (plain)."""
    res = {}
    for where in (mt.gpu(0), mt.cpu()):
        net, trainer, step = finetune.build_bert_finetune(
            batch=2, seq=384, dropout=0.0, dtype="float32", device=where,
            seed=3, num_layers=2)
        counters = [fa.VARIANT_LAUNCHES[n][v]
                    for n in (fa.KERNEL, fa.KERNEL_BWD_DQ, fa.KERNEL_BWD_DKV)
                    for v in ("fp32", "mma")]
        before = [c.value for c in counters]
        loss = step().cpu()
        if where.type == "cuda":
            torch.cuda.synchronize()
            got = [c.value - b for c, b in zip(counters, before)]
            check(got == [2, 0, 2, 0, 2, 0],
                  "the CUDA step did not launch each FP32 attention kernel "
                  f"once per layer (fp32, mma of K4, K5a, K5b: {got})")
        grads = {k: p.grad().float().cpu()
                 for k, p in net.collect_params().items()
                 if p.grad_req != "null"}
        res[where.type] = (loss, grads)
        del net, trainer, step
    (closs, cgrads), (ploss, pgrads) = res["cuda"], res["cpu"]
    loss_err = (closs - ploss).abs().max().item()
    worst, worst_name, big = 0.0, "", 0.0
    for k, g in pgrads.items():
        check(bool(torch.isfinite(cgrads[k]).all()), f"non-finite grad {k}")
        err = (cgrads[k] - g).abs().max().item()
        big = max(big, g.abs().max().item())
        if err > worst:
            worst, worst_name = err, k
    qkv = "bert.encoder.layers.0.attention.qkv.weight"
    qkv_big = cgrads[qkv].abs().max().item()
    # f32 on both sides; GEMMs and reductions sum in another order through
    # two layers: 1e-3 of the largest gradient
    tol = 1e-3 * max(big, 1e-3)
    say(f"train_parity bert 2x768 f32 b2 s384: loss max_abs_err "
        f"{loss_err:.3g} (tol 1e-3), grads max_abs_err {worst:.3g} at "
        f"{worst_name} (largest |grad| {big:.3g}, tol {tol:.3g}), "
        f"|grad {qkv}| max {qkv_big:.3g}")
    check(loss_err <= 1e-3, f"CUDA and CPU losses disagree: {loss_err:.3g}")
    check(worst <= tol, f"CUDA and CPU gradients disagree: {worst:.3g} at "
                        f"{worst_name}")
    check(qkv_big > 0, "no gradient reached q, k, v through attention")
    return worst


# -- training, a main path ----------------------------------------------------

#: the optimizer wrappers and the plain versions a plain run puts in their
#: places (the port has no switch that sends CUDA tensors to them)
LADDER_SWAP = (("bucket_step", "bucket_step_reference"),
               ("bucket_sqnorm", "bucket_sqnorm_reference"),
               ("param_step", None))


@contextlib.contextmanager
def ladder_swap(kopt, on):
    """With ``on``, the optimizer's bucket entry points (and param_step)
    are their plain versions until the block ends."""
    from mxnet_tpu_torch.optimizer.optimizer import Optimizer

    saved = {name: getattr(kopt, name) for name, _ in LADDER_SWAP}
    if on:
        for name, plain in LADDER_SWAP:
            setattr(kopt, name, getattr(kopt, plain) if plain
                    else Optimizer._fused_param_step)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(kopt, name, fn)


TRAIN_LR = 1e-4
TRAIN_WARMUP = 2   # steps before the counted ones: allocator, cuBLAS plans
TRAIN_STEPS = 5


def _run_steps(torch, step, n):
    """Mean loss and synchronised host seconds of each of n steps (the
    loss a tensor or an NDArray)."""
    losses, secs = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step()
        loss = getattr(loss, "_data", loss)
        losses.append(loss.float().mean().item())     # synchronises
        secs.append(time.perf_counter() - t0)
    return losses, secs


def phase_training(torch, mt, finetune, build, fa, kopt, topt, dispatch):
    batch, seq = 8, 384
    net, trainer, step = finetune.build_bert_finetune(
        batch=batch, seq=seq, dropout=0.1, dtype="bfloat16",
        learning_rate=TRAIN_LR, device=mt.gpu(0), seed=0)
    n_train = len(net.trainable_param_names())

    warm_losses, _ = _run_steps(torch, step, TRAIN_WARMUP)
    build.reset_counters()                       # main path: counts from 0
    kopt.TENSORS.reset()
    dispatch.reset_counts()
    losses, secs = _run_steps(torch, step, TRAIN_STEPS)
    launches = {c.name: c.value for c in build.COUNTERS.values()}  # after
    tensors = kopt.TENSORS.value
    outcomes = {f"{k}:{o}": n for (k, o), n in dispatch.COUNTS.items()}
    plan = opt_plan(kopt, trainer)

    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        check(launches[name] == launches[f"{name}_mma"] == 12 * TRAIN_STEPS
              and launches[f"{name}_fp32"] == 0,
              f"{name}: {launches[name]} launches, {launches[name + '_mma']}"
              f" tensor-core, {launches[name + '_fp32']} FP32; want 12 x "
              f"{TRAIN_STEPS} tensor-core")
    check(launches["opt_ladder"] == TRAIN_STEPS * plan["launches"]
          and launches["opt_sqnorm"] == TRAIN_STEPS * plan["buckets"]
          and tensors == TRAIN_STEPS * n_train == TRAIN_STEPS
          * plan["tensors"],
          f"opt_ladder: {launches['opt_ladder']} launches, opt_sqnorm "
          f"{launches['opt_sqnorm']}, {tensors} tensors updated; want "
          f"{TRAIN_STEPS} x {plan} ({n_train} trainable parameters)")
    check(outcomes == {"opt_adamw:kernel": TRAIN_STEPS * n_train},
          f"dispatch outcomes {outcomes}")
    check(all(l == l and abs(l) != float("inf")
              for l in warm_losses + losses),
          f"non-finite loss {warm_losses + losses}")
    check(losses[-1] < losses[0] and losses[-1] < warm_losses[0],
          f"the loss did not fall over the {TRAIN_STEPS} counted steps at "
          f"lr {TRAIN_LR}: warm-up {warm_losses}, counted {losses}")
    qkv = net.collect_params()["bert.encoder.layers.0.attention.qkv.weight"]
    check(qkv.grad().float().abs().max().item() > 0,
          "no gradient reached layer 0's qkv.weight")
    for name, p in net.collect_params().items():
        check(bool(torch.isfinite(p._tensor().float()).all()),
              f"non-finite parameter {name}")
    steady = sorted(secs)[len(secs) // 2]
    summary = dict(model="BERTForQA(bert_12_768_12)", dtype="bfloat16+f32 "
                   "masters", batch=batch, seq=seq, dropout=0.1,
                   optimizer="adamw", lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                   warmup_losses=warm_losses, steps=TRAIN_STEPS,
                   trainable_parameters=n_train, losses=losses,
                   step_ms=[1e3 * x for x in secs], step_ms_p50=1e3 * steady,
                   samples_per_s=batch / steady, launches=launches,
                   opt_tensors_updated=tensors, opt_plan=plan,
                   dispatch=outcomes,
                   peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
                   card=card_line())
    say(f"training: {json.dumps(summary)}")
    sweep = phase_opt_sweep(torch, kopt, topt, dispatch, trainer, "bert")
    del net, trainer, step, qkv
    torch.cuda.empty_cache()

    # kernels against their plain versions, from the same weights, without
    # dropout. The port has no switch that sends CUDA tensors to the plain
    # ladder, so for the plain run this script puts the plain versions in
    # the optimizer wrappers' places (LADDER_SWAP); MXTPU_FLASH_ATTENTION=0
    # takes the masked-softmax attention and torch's own backward.
    runs = {}
    for label in ("kernels", "plain"):
        if label == "plain":
            os.environ["MXTPU_FLASH_ATTENTION"] = "0"
        build.reset_counters()
        try:
            with ladder_swap(kopt, label == "plain"):
                net, trainer, step = finetune.build_bert_finetune(
                    batch=batch, seq=seq, dropout=0.0, dtype="bfloat16",
                    learning_rate=TRAIN_LR, device=mt.gpu(0), seed=0)
                runs[label], _ = _run_steps(torch, step, 3)
        finally:
            os.environ.pop("MXTPU_FLASH_ATTENTION", None)
        used = {k: build.COUNTERS[k].value for k in (
            "flash_attention_fwd", "flash_attention_bwd_dq",
            "flash_attention_bwd_dkv", "opt_ladder", "opt_sqnorm")}
        check(all(n > 0 for n in used.values()) if label == "kernels"
              else not any(used.values()),
              f"{label} run: kernel launches {used}")
        del net, trainer, step
        torch.cuda.empty_cache()
    diffs = [abs(a - b) for a, b in zip(runs["kernels"], runs["plain"])]
    # bf16 activations: the two attention paths round P at other points
    # (8 mantissa bits), and after a step AdamW has moved every weight by
    # about lr in a direction that such rounding can flip for the smallest
    # gradients; 0.03 is 0.25% of a loss near 12
    say(f"training kernels vs plain (dropout 0, 3 steps): kernels "
        f"{runs['kernels']} plain {runs['plain']} max diff {max(diffs):.3g} "
        f"(tol 0.03)")
    check(max(diffs) <= 0.03,
          f"kernel and plain training disagree: {diffs}")
    summary["kernels_vs_plain_max_loss_diff"] = max(diffs)
    summary["opt_sweep"] = sweep
    return summary


# -- ResNet ------------------------------------------------------------------

def _narrow_resnet(vision):
    return vision.ResNetV1(vision.BottleneckV1, [1, 1, 1, 1],
                           [16, 64, 128, 256, 512], classes=100,
                           layout="NHWC", stem_s2d=True)


def phase_resnet_parity(torch, mt, train_resnet, vision, knorm):
    """One f32 training step of a narrow ResNet (NHWC, s2d stem, 17
    BatchNorm sites), once on CUDA (BatchNorm through K1/K2, cuDNN
    convolutions in full f32) and once on the CPU (the plain versions):
    logits, loss, every gradient and every running stat."""
    res = {}
    for where in (mt.gpu(0), mt.cpu()):
        net, trainer, step = train_resnet.build_resnet_train(
            batch=8, dtype="float32", device=where, seed=3, image=64,
            classes=100, model=_narrow_resnet(vision))
        before = (knorm.LAUNCHES_FWD.value, knorm.LAUNCHES_BWD.value)
        loss = step().cpu()
        if where.type == "cuda":
            torch.cuda.synchronize()
            after = (knorm.LAUNCHES_FWD.value, knorm.LAUNCHES_BWD.value)
            check([a - b for a, b in zip(after, before)] == [17, 17],
                  "the CUDA step did not launch K1 and K2 once per "
                  "BatchNorm site")
        ps = net.collect_params()
        grads = {k: p.grad().float().cpu() for k, p in ps.items()
                 if p.grad_req != "null"}
        stats = {k: p._tensor().float().cpu() for k, p in ps.items()
                 if p.grad_req == "null"}
        res[where.type] = (loss, grads, stats)
        del net, trainer, step
    (closs, cgrads, cstats), (ploss, pgrads, pstats) = res["cuda"], res["cpu"]
    loss_err = (closs - ploss).abs().max().item()
    big = max(g.abs().max().item() for g in pgrads.values())
    worst, worst_name = max(((cgrads[k] - g).abs().max().item(), k)
                            for k, g in pgrads.items())
    stat_err = max(((cstats[k] - v).abs().max().item()
                    / max(v.abs().max().item(), 1e-6))
                   for k, v in pstats.items())
    # f32 on both sides; convolutions and BatchNorm sum in other orders
    # through 17 sites: gradients to 1e-3 of the largest, the loss and the
    # running stats to 1e-4
    tol = 1e-3 * big
    say(f"resnet_parity narrow NHWC f32 b8 64x64: loss max_abs_err "
        f"{loss_err:.3g} (tol 1e-4), grads max_abs_err {worst:.3g} at "
        f"{worst_name} (largest |grad| {big:.3g}, tol {tol:.3g}), running "
        f"stats max rel err {stat_err:.3g} (tol 1e-4)")
    check(all(bool(torch.isfinite(g).all()) for g in cgrads.values()),
          "non-finite CUDA gradient")
    check(loss_err <= 1e-4, f"CUDA and CPU losses disagree: {loss_err:.3g}")
    check(worst <= tol, f"CUDA and CPU gradients disagree: {worst:.3g} at "
                        f"{worst_name}")
    check(stat_err <= 1e-4, f"CUDA and CPU running stats disagree: "
                            f"{stat_err:.3g}")
    return worst


RESNET_BATCH = 256
RESNET_LR = 0.1


def phase_resnet_training(torch, mt, train_resnet, build, knorm, kopt, topt,
                          dispatch):
    net, trainer, step = train_resnet.build_resnet_train(
        batch=RESNET_BATCH, device=mt.gpu(0), seed=0,
        learning_rate=RESNET_LR)
    n_train = len(net.trainable_param_names())
    n_bn = sum(isinstance(m, mt.gluon.nn.BatchNorm) for m in net.modules())
    check((n_train, n_bn) == (161, 53),
          f"ResNet-50 has {n_train} trainable tensors and {n_bn} BN sites")
    torch.cuda.reset_peak_memory_stats()
    warm_losses, warm_secs = _run_steps(torch, step, TRAIN_WARMUP)
    build.reset_counters()                       # main path: counts from 0
    kopt.TENSORS.reset()
    dispatch.reset_counts()
    losses, secs = _run_steps(torch, step, TRAIN_STEPS)
    launches = {c.name: c.value for c in build.COUNTERS.values()}  # after
    tensors = kopt.TENSORS.value
    outcomes = {f"{k}:{o}": n for (k, o), n in dispatch.COUNTS.items()}
    plan = opt_plan(kopt, trainer)

    for name in ("bn_train_fwd", "bn_train_bwd"):
        check(launches[name] == n_bn * TRAIN_STEPS,
              f"{name}: {launches[name]} launches != {n_bn} x {TRAIN_STEPS}")
    check(launches["opt_ladder"] == plan["launches"] * TRAIN_STEPS
          and launches["opt_sqnorm"] == 0
          and tensors == n_train * TRAIN_STEPS == plan["tensors"]
          * TRAIN_STEPS,
          f"opt_ladder: {launches['opt_ladder']} launches, opt_sqnorm "
          f"{launches['opt_sqnorm']}, {tensors} tensors updated; want "
          f"{TRAIN_STEPS} x {plan}, no norm")
    check(outcomes == {"bn_fwd:kernel": n_bn * TRAIN_STEPS,
                       "bn_bwd:kernel": n_bn * TRAIN_STEPS,
                       "opt_sgd:kernel": n_train * TRAIN_STEPS},
          f"dispatch outcomes {outcomes}")
    check(all(math.isfinite(x) for x in warm_losses + losses),
          f"non-finite loss {warm_losses + losses}")
    # at lr 0.1 and momentum 0.9 the loss of one fixed batch oscillates
    # from step to step (8.79 7.35 | 6.75 6.83 7.07 7.13 6.72 in the first
    # run): the last step is held below the run's first
    check(losses[-1] < warm_losses[0],
          f"the loss did not fall over the {TRAIN_WARMUP + TRAIN_STEPS} "
          f"steps at lr 0.1: warm-up {warm_losses}, counted {losses}")
    ps = net.collect_params()
    stem = ps["features.0.weight"]
    check(stem.grad().float().abs().max().item() > 0,
          "no gradient reached the stem")
    for name, p in ps.items():
        check(bool(torch.isfinite(p._tensor().float()).all()),
              f"non-finite parameter {name}")
    rm = ps["features.1.running_var"]._tensor()
    check(not torch.equal(rm, torch.ones_like(rm)),
          "the stem's running variance was never updated")
    steady = sorted(secs)[len(secs) // 2]
    summary = dict(model="resnet50_v1(layout=NHWC, stem_s2d=True)",
                   dtype="bfloat16+f32 masters", batch=RESNET_BATCH,
                   image=224, optimizer="sgd momentum 0.9 wd 1e-4", lr=0.1,
                   warmup_steps=TRAIN_WARMUP, warmup_losses=warm_losses,
                   warmup_step_ms=[1e3 * x for x in warm_secs],
                   steps=TRAIN_STEPS, trainable_parameters=n_train,
                   bn_sites=n_bn, losses=losses,
                   step_ms=[1e3 * x for x in secs], step_ms_p50=1e3 * steady,
                   images_per_s=RESNET_BATCH / steady, launches=launches,
                   opt_tensors_updated=tensors, opt_plan=plan,
                   dispatch=outcomes,
                   peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
                   card=card_line())
    say(f"resnet_training: {json.dumps(summary)}")
    summary["opt_sweep"] = phase_opt_sweep(torch, kopt, topt, dispatch,
                                           trainer, "resnet50")
    del net, trainer, step, ps, stem, rm
    torch.cuda.empty_cache()

    summary["kernels_vs_plain"] = kernels_vs_plain(
        torch, build, knorm, kopt, lambda: train_resnet.build_resnet_train(
            batch=32, dtype="float32", device=mt.gpu(0), seed=0,
            learning_rate=RESNET_LR), "resnet50", 32, RESNET_LR)
    return summary


def kernels_vs_plain(torch, build, knorm, kopt, make, path, batch, lr):
    """K1, K2 and K3 against their plain versions over three whole f32
    training steps of ``path``: ``make()`` gives ``(net, trainer, step)``
    from seed 0, built three times (kernels, kernels again, plain). After
    every step the other two nets take the kernel net's weights, running
    stats and momenta again, so each step starts from one state. Whole
    runs cannot be compared: on ResNet-50 at lr 0.01 a first-step loss
    that agrees to 1.2e-5 grew into 0.018 and 0.063 apart over two more
    steps (one-ulp differences amplified, measured), and in bf16 the first
    step already differs by 0.022 of 9.1. The port has no switch that
    sends CUDA tensors to the plain versions, so this script puts them in
    the wrappers' places for the plain steps. The second kernel net
    measures how far two runs of the same code drift in one step
    (cuDNN's algorithms need not repeat their bits). Returns the plain
    side's errors per step."""
    saved = (knorm.bn_train_fwd, knorm.bn_train_bwd)
    plain = (knorm.bn_train_fwd_reference, knorm.bn_train_bwd_reference)
    sides = {label: make() for label in ("kernels", "kernels_again", "plain")}
    stats = {other: {"loss": [], "grad": [], "param": []}
             for other in ("kernels_again", "plain")}
    for _ in range(3):
        losses = {}
        for label, (net, trainer, step) in sides.items():
            build.reset_counters()
            if label == "plain":
                knorm.bn_train_fwd, knorm.bn_train_bwd = plain
            try:
                with ladder_swap(kopt, label == "plain"):
                    losses[label] = step().mean().item()
            finally:
                knorm.bn_train_fwd, knorm.bn_train_bwd = saved
            mine = {k: build.COUNTERS[k].value for k in (
                "bn_train_fwd", "bn_train_bwd", "opt_ladder")}
            check(not any(mine.values()) if label == "plain"
                  else all(mine.values()),
                  f"{path} {label} step: kernel launches {mine}")
        knet, ktr, _ = sides["kernels"]
        kps = knet.collect_params()
        trainable = [k for k, p in kps.items() if p.grad_req != "null"]
        big = max(kps[k].grad().abs().max().item() for k in trainable)
        # a parameter's error over 1e-5 of its largest value plus 0.1 of
        # the step the net's largest gradient takes (lr * big / batch)
        floor = 0.1 * lr * big / batch
        for other, st in stats.items():
            onet, otr, _ = sides[other]
            ops = onet.collect_params()
            st["loss"].append(abs(losses["kernels"] - losses[other])
                              / abs(losses["kernels"]))
            st["grad"].append(sorted(
                ((kps[k].grad() - ops[k].grad()).abs().max().item() / big,
                 k) for k in trainable)[-3:])
            st["param"].append(sorted(
                ((kps[k]._tensor() - p._tensor()).abs().max().item()
                 / (1e-5 * kps[k]._tensor().abs().max().item() + floor), k)
                for k, p in ops.items())[-3:])
            with torch.no_grad():
                for k, p in ops.items():
                    p._tensor().copy_(kps[k]._tensor())
                for ks, os_ in zip(ktr._states, otr._states):
                    for a, b in zip(kopt._leaves(ks), kopt._leaves(os_)):
                        b.copy_(a)
    del sides, knet, ktr, kps, onet, otr, ops
    gc_collect(torch)
    for other, st in stats.items():
        say(f"{path} training kernels vs {other} (f32, batch {batch}, lr "
            f"{lr}, 3 steps, re-synchronised after each): loss rel "
            f"diffs {st['loss']}; the 3 largest gradient errors over the "
            f"largest gradient, per step {st['grad']}; the 3 largest "
            f"parameter errors over tolerance, per step {st['param']}")
    st = stats["plain"]
    # f32, one step from the same state. K1/K2 sum in another order than the
    # plain versions, so the forward differs by about 1e-7 and the loss by
    # 1.4e-6 (ResNet-50, measured). That flips the ReLUs of the few
    # activations within 1e-7 of zero, and each flip moves a whole gradient
    # element: the early layers' gradients then differ by up to 0.025 of
    # the net's largest gradient (measured at the stem and stage 1), where
    # two runs of the kernels, whose forwards agree bit for bit, differ by
    # 2.6e-5. Gradients are held to 0.1 of the largest, the parameters
    # after the update to 0.1 of the largest step, the loss to 1e-4
    check(max(st["loss"]) <= 1e-4
          and max(e for step in st["grad"] for e, _ in step) <= 0.1
          and max(e for step in st["param"] for e, _ in step) <= 1.0,
          f"kernel and plain {path} training steps disagree")
    return st


# -- mx.rtc (K7) ----------------------------------------------------------------

RTC_AXPY_N = 1 << 26                    # f32 elements
RTC_ROWS, RTC_COLS = 65536, 1024        # bf16
RTC_HALF_N, RTC_STRIDE = 1 << 24, 2
RTC_OFFSET = (1 << 31) + 4097           # elements: past a 32-bit int
RTC_SMEM_TILE = 16384                   # floats: 64 KB of shared memory


def build_rtc_modules(rtc):
    """Each RTC_* source compiled through ``rtc.CudaModule``, one nvcc each,
    all started together: ``{kernel: (CudaModule, build seconds)}``."""
    with concurrent.futures.ThreadPoolExecutor(len(RTC_KERNELS)) as pool:
        futs = {name: pool.submit(rtc.CudaModule, src, exports=exports)
                for name, src, exports, _ in RTC_KERNELS}
        return {name: (f.result(), f.result().build_seconds)
                for name, f in futs.items()}


def phase_rtc(torch, mt, rtc, build, modules):
    """K7's main path, then each kernel against its plain version. The
    kernels are user code compiled at run time; the path is a user's:
    ``mx.np`` arrays of the card handed to ``CudaKernel.launch``."""
    dev = torch.device("cuda", 0)
    k = {name: modules[name][0].get_kernel(name, sig)
         for name, _, _, sig in RTC_KERNELS}
    mt.seed(21)
    alpha, scale = 2.5, 0.75
    x = mt.np.random.normal(size=(RTC_AXPY_N,), device=dev)
    y = mt.np.random.uniform(size=(RTC_AXPY_N,), device=dev)
    y0 = y.copy()
    xb = mt.np.random.normal(size=(RTC_ROWS, RTC_COLS), dtype="bfloat16",
                             device=dev)
    rows = mt.np.zeros((RTC_ROWS,), device=dev)
    xh = mt.np.random.normal(size=(RTC_OFFSET + RTC_HALF_N * RTC_STRIDE,),
                             dtype="float16", device=dev)
    yh = mt.np.zeros((RTC_HALF_N,), dtype="float16", device=dev)
    n_warps = 128 // 32
    launches = {
        "axpy": lambda: k["axpy"].launch(
            [x, y, alpha, RTC_AXPY_N], dev, (RTC_AXPY_N // 256,), (256,)),
        "row_sum_bf16": lambda: k["row_sum_bf16"].launch(
            [xb, rows, RTC_COLS], dev, (RTC_ROWS,), (128,),
            shared_mem=4 * n_warps),
        "strided_scale_half": lambda: k["strided_scale_half"].launch(
            [xh, yh, scale, RTC_HALF_N, RTC_STRIDE, RTC_OFFSET], dev,
            ((RTC_HALF_N + 255) // 256,), (256,)),
    }
    torch.cuda.synchronize()
    build.reset_counters()                       # main path: counts from 0
    v0 = y._version
    for name in launches:
        launches[name]()
    torch.cuda.synchronize()
    counts = {c.name: c.value for c in build.COUNTERS.values()}  # after
    check(counts["rtc"] == len(launches) and sum(counts.values())
          == len(launches), f"rtc main path: launch counts {counts}")
    check(y._version == v0 + 1, "axpy's output was not marked as written")

    strided = xh._data[RTC_OFFSET::RTC_STRIDE][:RTC_HALF_N]
    plain = {
        "axpy": lambda: y0._data + alpha * x._data,
        "row_sum_bf16": lambda: xb._data.float().sum(1),
        "strided_scale_half": lambda: (strided.float() * scale).half(),
    }
    library = {
        "axpy": ("y.add_(x, alpha=a)",
                 lambda: y0._data.add_(x._data, alpha=alpha)),
        "row_sum_bf16": ("x.sum(1, dtype=torch.float32)",
                         lambda: xb._data.sum(1, dtype=torch.float32)),
        "strided_scale_half": ("torch.mul(x[offset::stride][:n], s, out=y)",
                               lambda: torch.mul(strided, scale,
                                                 out=yh._data)),
    }
    got = {"axpy": y._data, "row_sum_bf16": rows._data,
           "strided_scale_half": yh._data}
    wants = {name: fn() for name, fn in plain.items()}
    torch.cuda.synchronize()
    row_abs = xb._data.float().abs().sum(1).max().item()
    # axpy: nvcc contracts y + a*x into one FMA, the plain version rounds
    # twice: 2 ulps of the largest value. Row sums: f32 sums of 1024 bf16
    # values in two fixed orders: 1e-5 of the largest row's sum of |x|.
    # The half scale: one f32 product rounded once to half on both sides.
    tols = {"axpy": 2 * F32_EPS * max(1.0, wants["axpy"].abs().max().item()),
            "row_sum_bf16": 1e-5 * row_abs, "strided_scale_half": 0.0}
    nbytes = {"axpy": 3 * 4 * RTC_AXPY_N,
              "row_sum_bf16": 2 * RTC_ROWS * RTC_COLS + 4 * RTC_ROWS,
              "strided_scale_half": 2 * 2 * RTC_HALF_N}
    flops = {"axpy": 2 * RTC_AXPY_N, "row_sum_bf16": RTC_ROWS * RTC_COLS,
             "strided_scale_half": RTC_HALF_N}
    cases = []
    for name in launches:
        err = (got[name].float() - wants[name].float()).abs().max().item()
        check(bool(torch.isfinite(got[name].float()).all()),
              f"rtc {name}: non-finite output")
        check(err <= tols[name], f"rtc {name}: kernel disagrees with its "
                                 f"plain version: {err:.3g} (tol {tols[name]:.3g})")
        t_bytes = nbytes[name] / HBM_BYTES_PER_S
        t_ops = flops[name] / PEAK_FLOPS["float32"]
        lib_name, lib_fn = library[name]
        row = dict(kernel=name, build_s=modules[name][1], max_abs_err=err,
                   tol=tols[name], main_path_launches=1,
                   ms=cuda_ms(torch, launches[name]),
                   plain_ms=cuda_ms(torch, plain[name]),
                   library_ms=cuda_ms(torch, lib_fn), library=lib_name,
                   bound_ms=1e3 * max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   bytes=nbytes[name])
        say("rtc_case " + json.dumps(row))
        cases.append(row)
    del x, y, y0, xb, rows, xh, yh, strided, wants, got
    torch.cuda.empty_cache()

    # refused launches raise with cuGetErrorString's words; nothing falls
    # back
    small_x = mt.np.ones((4096,), device=dev)
    small_y = mt.np.zeros((4096,), device=dev)
    refused = []
    try:
        k["axpy"].launch([small_x, small_y, 1.0, 4096], dev, (2,), (2048,))
    except mt.MXNetError as e:
        refused.append(str(e))
    check(len(refused) == 1 and "CUDA_ERROR" in refused[0],
          f"a 2048-thread block was not refused: {refused}")
    rev = modules["row_sum_bf16"][0].get_kernel(
        "tile_reverse", "const float *x, float *y, int tile")
    tx = mt.np.random.uniform(size=(8 * RTC_SMEM_TILE,), device=dev)
    ty = mt.np.zeros((8 * RTC_SMEM_TILE,), device=dev)
    smem = 4 * RTC_SMEM_TILE
    try:
        rev.launch([tx, ty, RTC_SMEM_TILE], dev, (8,), (1024,),
                   shared_mem=smem)
    except mt.MXNetError as e:
        refused.append(str(e))
    check(len(refused) == 2, "64 KB of dynamic shared memory was not "
                             "refused without opting in")
    rev.set_max_dynamic_shared_memory(smem)
    rev.launch([tx, ty, RTC_SMEM_TILE], dev, (8,), (1024,), shared_mem=smem)
    torch.cuda.synchronize()
    check(torch.equal(ty._data, tx._data.view(8, -1).flip(1).reshape(-1)),
          "tile_reverse with 64 KB of dynamic shared memory is wrong")
    # the plain version does not run CUDA arrays, nor CudaModule CPU ones
    pallas = rtc.PallasModule(lambda x_ref, o_ref: None).get_kernel(
        "<lambda>")
    for what, call in (
            ("PallasModule on CUDA arrays", lambda: pallas.launch(
                [small_x], out_shape=(4096,))),
            ("CudaModule on CPU arrays", lambda: k["axpy"].launch(
                [small_x.as_in_ctx(mt.cpu()), small_y.as_in_ctx(mt.cpu()),
                 1.0, 4096], dev, (16,), (256,)))):
        try:
            call()
        except (mt.MXNetError, ValueError):
            continue
        fail(f"{what} did not raise")
    summary = dict(cases=cases, main_path_launches=counts["rtc"],
                   refused=refused, card=card_line())
    say("rtc: " + json.dumps(summary))
    return summary


# -- LeNet -------------------------------------------------------------------------

LENET_BATCH = 256


def phase_lenet_parity(torch, mt, vision, kopt):
    """One f32 imperative step of LeNet (SGD momentum) on ``mx.np`` arrays,
    once on CUDA (the update through K3, cuDNN convolutions in full f32) and
    once on the CPU, from the same weights and batch."""
    gen = torch.Generator().manual_seed(3)
    xv = torch.rand((64, 1, 28, 28), generator=gen)
    yv = torch.randint(0, 10, (64,), generator=gen, dtype=torch.int32)
    res = []
    for where in (mt.gpu(0), mt.cpu()):
        net = vision.lenet(classes=10)
        net.initialize(device=where, generator=torch.Generator().manual_seed(3))
        trainer = mt.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": 0.05, "momentum": 0.9})
        lossfn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
        x, y = mt.np.array(xv, device=where), mt.np.array(yv, device=where)
        before = (kopt.LAUNCHES.value, kopt.TENSORS.value)
        with mt.autograd.record():
            out = net(x)
            loss = lossfn(out, y)
        loss.backward()
        trainer.step(64)
        if where.type == "cuda":
            torch.cuda.synchronize()
            plan = opt_plan(kopt, trainer)
            got = (kopt.LAUNCHES.value - before[0],
                   kopt.TENSORS.value - before[1])
            check(got == (plan["launches"], 10),
                  f"the CUDA step launched the ladder {got[0]} times for "
                  f"{got[1]} tensors; want once per bucket for 10: {plan}")
        ps = net.collect_params()
        res.append((out.asnumpy(), loss.asnumpy(),
                    {k: p.grad().float().cpu() for k, p in ps.items()},
                    {k: p._tensor().detach().float().cpu()
                     for k, p in ps.items()}))
    (co, cl, cg, cp), (po, pl, pg, pp) = res

    def rel(a, b):
        a, b = torch.as_tensor(a), torch.as_tensor(b)
        return ((a - b).abs().max() / b.abs().max().clamp_min(1e-12)).item()

    errs = dict(logits=rel(co, po), loss=rel(cl, pl),
                grads=max(rel(cg[k], g) for k, g in pg.items()),
                params=max(rel(cp[k], v) for k, v in pp.items()))
    # f32 on both sides (TF32 off): convolutions, GEMMs and reductions sum
    # in other orders. Logits, loss and the parameters after the step to
    # 1e-4 of their largest value; each gradient to 1e-3 of its largest
    say(f"lenet_parity f32 b64 sgd momentum, CUDA vs CPU, max error over "
        f"the largest value: {json.dumps(errs)}")
    check(errs["logits"] <= 1e-4 and errs["loss"] <= 1e-4
          and errs["params"] <= 1e-4 and errs["grads"] <= 1e-3,
          f"CUDA and CPU LeNet steps disagree: {errs}")
    check(all(bool(torch.isfinite(g).all()) for g in cg.values()),
          "non-finite CUDA gradient")
    return errs


def phase_lenet_training(torch, mt, train_lenet, build, dispatch, kopt,
                         topt):
    net, trainer, step, (x, y) = train_lenet.build_lenet_train(
        batch=LENET_BATCH, device=mt.gpu(0), seed=0)

    def run(n):
        """The mean loss and synchronised host seconds of each of n steps
        (the loss an NDArray, as user code gets it)."""
        losses, secs = [], []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = step()
            losses.append(float(loss.mean()))    # synchronises
            secs.append(time.perf_counter() - t0)
        return losses, secs, loss

    warm, warm_secs, _ = run(TRAIN_WARMUP)
    build.reset_counters()                       # main path: counts from 0
    kopt.TENSORS.reset()
    dispatch.reset_counts()
    losses, secs, loss = run(TRAIN_STEPS)
    launches = {c.name: c.value for c in build.COUNTERS.values()}  # after
    tensors = kopt.TENSORS.value
    outcomes = {f"{k}:{o}": n for (k, o), n in dispatch.COUNTS.items()}
    ps = net.collect_params()
    n_train = len(net.trainable_param_names())
    plan = opt_plan(kopt, trainer)
    check(n_train == 10, f"LeNet has {n_train} trainable tensors, not 10")
    check(launches["opt_ladder"] == plan["launches"] * TRAIN_STEPS
          and sum(launches.values()) == launches["opt_ladder"]
          and tensors == n_train * TRAIN_STEPS,
          f"launches {launches}, {tensors} tensors updated; want only "
          f"opt_ladder, {TRAIN_STEPS} x {plan}")
    check(outcomes == {"opt_sgd:kernel": n_train * TRAIN_STEPS},
          f"dispatch outcomes {outcomes}")
    check(all(math.isfinite(v) for v in warm + losses),
          f"non-finite loss {warm + losses}")
    check(losses[-1] < warm[0], f"the loss did not fall over the "
                                f"{TRAIN_WARMUP + TRAIN_STEPS} steps: "
                                f"warm-up {warm}, counted {losses}")
    on_cpu = [name for name, t in
              [("x", x._data), ("y", y._data), ("loss", loss._data)]
              + [(k, p._tensor()) for k, p in ps.items()]
              + [(k + ".grad", p.grad()) for k, p in ps.items()]
              if not t.is_cuda]
    check(on_cpu == [], f"tensors of the loop on the CPU: {on_cpu}")
    steady = sorted(secs)[len(secs) // 2]
    summary = dict(model="lenet(classes=10)", dtype="float32",
                   batch=LENET_BATCH, optimizer="sgd", lr=0.05,
                   warmup_steps=TRAIN_WARMUP, warmup_losses=warm,
                   warmup_step_ms=[1e3 * v for v in warm_secs],
                   steps=TRAIN_STEPS, losses=losses,
                   step_ms=[1e3 * v for v in secs], step_ms_p50=1e3 * steady,
                   images_per_s=LENET_BATCH / steady, launches=launches,
                   launches_per_step={k: v / TRAIN_STEPS
                                      for k, v in launches.items()},
                   opt_tensors_updated=tensors, opt_plan=plan,
                   dispatch=outcomes, card=card_line())
    say(f"lenet_training: {json.dumps(summary)}")
    summary["opt_sweep"] = phase_opt_sweep(torch, kopt, topt, dispatch,
                                           trainer, "lenet")
    return summary


# -- TrainStep: one CUDA graph a step (phases 13-15) --------------------------

TS_COMPARE = 3     # graph and phased steps from one state, LR moving


@contextlib.contextmanager
def phased_steps():
    """TrainStep runs phased inside (``MXTPU_WHOLE_STEP=0``)."""
    os.environ["MXTPU_WHOLE_STEP"] = "0"
    try:
        yield
    finally:
        os.environ.pop("MXTPU_WHOLE_STEP", None)


def _ts_build(mt, mods, path, dev):
    """(net, trainer, step) of ``path`` through gluon.TrainStep, from seed
    0: ``step()`` takes one step on the path's fixed batch, ``step.func``
    is the TrainStep."""
    finetune, train_resnet, train_lenet = mods
    if path == "bert":
        return finetune.build_bert_finetune(
            batch=8, seq=384, dropout=0.1, dtype="bfloat16",
            learning_rate=TRAIN_LR, device=dev, seed=0,
            clip_global_norm=None, train_step=True)
    if path == "resnet50":
        return train_resnet.build_resnet_train(
            batch=RESNET_BATCH, device=dev, seed=0, learning_rate=RESNET_LR,
            train_step=True)
    if path == "mobilenet_v2":
        from mxnet_tpu_torch.gluon.model_zoo import vision

        return train_resnet.build_resnet_train(
            batch=MNV2_BATCH, layout="NCHW", stem_s2d=False, device=dev,
            seed=0, learning_rate=RESNET_LR, train_step=True,
            model=vision.mobilenet_v2_1_0(classes=1000))
    net, trainer, step, _ = train_lenet.build_lenet_train(
        batch=LENET_BATCH, device=dev, seed=0, train_step=True)
    return net, trainer, step


def _ts_copy_state(torch, kopt, src, dst):
    """``dst`` (net, trainer) takes ``src``'s weights, running stats,
    optimizer states and counts and noise generators (the Dropout layers'
    and the attention layers' dropout-seed generators), in place: the next
    steps of both start from one state."""
    (snet, str_), (dnet, dtr) = src, dst
    with torch.no_grad():
        dps = dnet.collect_params()
        for k, p in snet.collect_params().items():
            dps[k]._tensor().copy_(p._tensor())
        for a, b in zip(str_._states, dtr._states):
            for x, y in zip(kopt._leaves(a), kopt._leaves(b)):
                y.copy_(x)
    for ga, gb in zip(snet._noise_generators(), dnet._noise_generators()):
        gb.set_state(ga.get_state())
    so, do = str_.optimizer, dtr.optimizer
    do._index_update_count = dict(so._index_update_count)
    do.num_update = so.num_update


def _ts_counted(torch, build, dispatch, kopt, step, n):
    """n steps with the counts zeroed just before and read just after:
    (mean losses, host seconds, launches, tensors, dispatch outcomes)."""
    build.reset_counters()
    kopt.TENSORS.reset()
    dispatch.reset_counts()
    losses, secs = _run_steps(torch, step, n)
    launches = {c.name: c.value for c in build.COUNTERS.values() if c.value}
    outcomes = {f"{k}:{o}": v for (k, o), v in dispatch.COUNTS.items()}
    return losses, secs, launches, kopt.TENSORS.value, outcomes


def phase_train_step(torch, mt, build, dispatch, kopt, fa, mods, path,
                     after=None):
    """13-15. ``path`` (resnet50, lenet, bert without the global-norm
    clip) through ``gluon.TrainStep``: two builds from one seed, one
    through the graph, one phased (MXTPU_WHOLE_STEP=0). 2 warm-up steps
    (the graph's eager warm-up and its capture), then 5 counted steps of
    each with the counts zeroed just before and read just after (the
    graph's from the replays' deltas; equal to the phased path's), then
    TS_COMPARE steps of both from one state with an LR that changes every
    step, then both profiled in turns (phased, graph, graph, phased):
    host ms, device-busy ms, idle share, host calls beside the kernels the
    device ran, peak memory. ``after(net, trainer, step)`` (phase 20) runs
    on the graph's side last and adds its dict to the summary."""
    from mxnet_tpu_torch.tools.profile_training import measure

    gc_collect(torch)
    dev = mt.gpu(0)
    torch.cuda.reset_peak_memory_stats()
    graph_side = _ts_build(mt, mods, path, dev)
    phased_side = _ts_build(mt, mods, path, dev)
    gnet, gtr, gstep = graph_side
    pnet, ptr, pstep = phased_side
    ts = gstep.func
    n_train = len(gnet.trainable_param_names())
    warm = _run_steps(torch, gstep, TRAIN_WARMUP)[0]
    with phased_steps():
        pwarm = _run_steps(torch, pstep, TRAIN_WARMUP)[0]
    check(ts.last_path == "whole_step" and ts.jit_trace_count() == 1,
          f"{path}: TrainStep ran {ts.last_path} with "
          f"{ts.jit_trace_count()} captures: {ts.ineligible_reason()}")
    check(pstep.func.last_path == "phased", f"{path}: phased side ran "
                                           f"{pstep.func.last_path}")
    # the attention layers' dropout generators, and a twin of layer 0's
    # that draws the seeds the replays will draw
    gens = [m.dropout_generator for m in gnet.modules()
            if getattr(m, "dropout_generator", None) is not None]
    twin = None
    if gens:
        twin = torch.Generator(device=gens[0].device)
        twin.set_state(gens[0].get_state())
    offsets_before = [g_.get_offset() for g_ in gens]
    g = _ts_counted(torch, build, dispatch, kopt, gstep, TRAIN_STEPS)
    moved = [g_.get_offset() - b for g_, b in zip(gens, offsets_before)]
    pgens = [m.dropout_generator for m in pnet.modules()
             if getattr(m, "dropout_generator", None) is not None]
    poffsets = [g_.get_offset() for g_ in pgens]
    with phased_steps():
        p = _ts_counted(torch, build, dispatch, kopt, pstep, TRAIN_STEPS)
    pmoved = [g_.get_offset() - b for g_, b in zip(pgens, poffsets)]
    check(ts.last_path == "whole_step" and ts.jit_trace_count() == 1,
          f"{path}: TrainStep captured again: {ts.jit_trace_count()}")
    plan = opt_plan(kopt, gtr)
    want = {"opt_ladder": plan["launches"] * TRAIN_STEPS}
    if path in ("resnet50", "mobilenet_v2"):
        want.update(bn_train_fwd=53 * TRAIN_STEPS,
                    bn_train_bwd=53 * TRAIN_STEPS)
    if path == "bert":
        for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                     "flash_attention_bwd_dkv"):
            want[name] = want[f"{name}_mma"] = 12 * TRAIN_STEPS
    check(g[2] == want and g[3] == n_train * TRAIN_STEPS,
          f"{path} graph: launches {g[2]}, {g[3]} tensors updated; want "
          f"{want} and {n_train} x {TRAIN_STEPS}")
    check(g[2] == p[2] and g[3] == p[3] and g[4] == p[4],
          f"{path}: graph launches {g[2]} {g[3]} {g[4]} != phased "
          f"{p[2]} {p[3]} {p[4]}")
    losses = warm + g[0]
    check(all(math.isfinite(v) for v in losses + pwarm + p[0]),
          f"{path}: non-finite loss, graph {losses}, phased {p[0]}")
    check(losses[-1] < losses[0], f"{path}: the graph's loss did not fall "
                                  f"over {len(losses)} steps: {losses}")
    seeds = []
    if path == "bert":
        # the replays moved every layer's dropout generator as far as the
        # phased steps moved its twin's; the seeds the 5 replays drew in
        # layer 0 (drawn again from a copy of its state) all differ
        check(len(gens) == 12 and all(moved) and moved == pmoved,
              f"bert: dropout generators moved {moved} in the replays, "
              f"{pmoved} in the phased steps")
        seeds = [int(fa.next_dropout_seed(twin).item())
                 for _ in range(TRAIN_STEPS)]
        check(len(set(seeds)) == TRAIN_STEPS, f"bert: seeds {seeds}")

    # graph and phased steps from one state, the LR moving every step
    base_lr = gtr.learning_rate
    compare = []
    for k in range(TS_COMPARE):
        lr = base_lr * (1.0 + 0.25 * (k + 1))
        for tr in (gtr, ptr):
            tr.set_learning_rate(lr)
        _ts_copy_state(torch, kopt, (gnet, gtr), (pnet, ptr))
        gl = gstep()
        with phased_steps():
            pl = pstep()
        torch.cuda.synchronize()
        gl = gl._data if hasattr(gl, "_data") else gl
        pl = pl._data if hasattr(pl, "_data") else pl
        loss_diff = (gl.float() - pl.float()).abs().max().item()
        loss_rel = loss_diff / max(pl.float().abs().max().item(), 1e-12)
        gps, pps = gnet.collect_params(), pnet.collect_params()
        big = max(pps[n].grad().float().abs().max().item()
                  for n in pnet.trainable_param_names())
        # each parameter against 1e-5 of its largest value plus 0.1 of the
        # step the largest gradient takes (phase 8's measure): the f32
        # masters where there are any, else the weights
        batch = {"bert": 8, "resnet50": RESNET_BATCH, "lenet": LENET_BATCH,
                 "mobilenet_v2": MNV2_BATCH}[path]
        floor = 0.1 * lr * max(1.0, big / batch)
        errs = []
        for i, prm in enumerate(gtr._params):
            a, b = prm._tensor(), ptr._params[i]._tensor()
            sa, sb = gtr._states[i], ptr._states[i]
            if sa is not None and gtr.optimizer._is_mp_state(a, sa):
                a, b = sa[0], sb[0]
            err = (a.float() - b.float()).abs().max().item()
            errs.append((err / (1e-5 * b.float().abs().max().item()
                                + floor), gtr._param_names[i]))
        bitwise = torch.equal(gl, pl) and all(
            torch.equal(gps[n]._tensor(), pps[n]._tensor()) for n in gps)
        compare.append(dict(lr=lr, loss_diff=loss_diff, loss_rel=loss_rel,
                            worst_params=sorted(errs)[-3:], bitwise=bitwise))
    worst = max(e for c in compare for e, _ in c["worst_params"])
    # the losses as phases 6 (bf16: 0.03) and 10 (f32: 1e-4 of the loss)
    # hold a kernel run against another
    loss_ok = all(c["loss_diff"] <= 0.03 if path != "lenet"
                  else c["loss_rel"] <= 1e-4 for c in compare)
    say(f"{path} train_step graph vs phased from one state, LR moving: "
        f"{json.dumps(compare)}")
    check(loss_ok and worst <= 1.0,
          f"{path}: graph and phased steps from one state disagree")
    check(ts.jit_trace_count() == 1, f"{path}: the LR schedule made "
                                     f"{ts.jit_trace_count()} captures")

    runs = []
    for label, side in (("phased", pstep), ("graph", gstep),
                        ("graph", gstep), ("phased", pstep)):
        ctx = phased_steps() if label == "phased" else \
            contextlib.nullcontext()
        torch.cuda.reset_peak_memory_stats()  # both nets' memory, and this
        with ctx:                             # run's own on top of it
            run, _ = measure(side, TRAIN_STEPS)
        runs.append(dict(path=label, **{k: run[k] for k in (
            "host_ms_per_step_p50", "host_ms_per_step",
            "issue_ms_per_step_p50", "device_time_from",
            "device_busy_ms_per_step", "device_idle_share",
            "kernel_launches_per_step", "host_calls_per_step",
            "peak_memory_gib", "peak_reserved_gib")}))
    check(ts.jit_trace_count() == 1, f"{path}: captured again while "
                                     f"profiled")
    summary = dict(
        path=path, trainable_parameters=n_train, captures=ts.jit_trace_count(),
        warmup_losses=warm, losses=g[0], phased_losses=p[0],
        step_ms=[1e3 * v for v in g[1]], phased_step_ms=[1e3 * v for v in
                                                         p[1]],
        launches=g[2], phased_launches=p[2], tensors_updated=g[3],
        dispatch=g[4], opt_plan=plan, dropout_seeds_layer0=seeds,
        compare=compare, profile=runs,
        peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        peak_reserved_gib=torch.cuda.max_memory_reserved() / 2 ** 30,
        card=card_line())
    if after is not None:
        summary.update(after(gnet, gtr, gstep))
    say(f"train_step {path}: {json.dumps(summary)}")
    del graph_side, phased_side, gnet, gtr, gstep, pnet, ptr, pstep, ts
    gc_collect(torch)
    return summary


# -- checkpoint and resume (phase 16) ----------------------------------------

RESUME_STEPS = 2   # steps before the save, and again after the load


def _resume_build(finetune, dev, seed, clip, **model_kwargs):
    """Phase 6's fine-tune (bf16 weights, f32 masters, AdamW, batch 8, seq
    384) from ``seed`` through TrainStep's partial, dropout 0: the Dropout
    generators' state is not part of ``save_states`` (nor of the JAX
    package's); the checkpoint manager carries it (phase 26 resumes the
    same fine-tune at dropout 0.1 bit for bit). With the global-norm
    clip TrainStep runs phased, the fine-tune default; without it, one CUDA
    graph a step on the card."""
    return finetune.build_bert_finetune(
        batch=8, seq=384, dropout=0.0, dtype="bfloat16",
        learning_rate=TRAIN_LR, device=dev, seed=seed,
        clip_global_norm=clip, train_step=True, **model_kwargs)


def _snapshot(kopt, net, trainer):
    """Copies of every weight and every optimizer-state leaf (the f32
    masters and AdamW's m and v), in place on the device."""
    return ([p._tensor().detach().clone()
             for p in net.collect_params().values()],
            [x.detach().clone() for s in trainer._states
             for x in kopt._leaves(s)])


def _snap_diff(torch, a, b):
    """``(bitwise, largest abs difference)`` of two snapshots."""
    pairs = list(zip(a[0] + a[1], b[0] + b[1]))
    check(len(a[0]) == len(b[0]) and len(a[1]) == len(b[1]) and all(
        x.shape == y.shape and x.dtype == y.dtype for x, y in pairs),
        "snapshots of another structure")
    return (all(torch.equal(x, y) for x, y in pairs),
            max((x.float() - y.float()).abs().max().item() for x, y in pairs))


def _resume_steps(torch, step, args, n):
    """n steps of a TrainStep on the batch ``args``; their mean losses."""
    return _run_steps(torch, lambda: step(*args), n)[0]


def _counted(torch, build, step, args, n):
    """n steps with the counts zeroed just before and read just after:
    (losses, launches)."""
    build.reset_counters()
    losses = _resume_steps(torch, step, args, n)
    return losses, {c.name: c.value for c in build.COUNTERS.values()
                    if c.value}


def _want_launches(kopt, trainer, n, clipped, layers):
    """The launches of n BERT steps: K3 once per bucket (its norm too where
    the step clips), K4, K5a and K5b once per layer a step, all
    tensor-core."""
    plan = opt_plan(kopt, trainer)
    want = {"opt_ladder": plan["launches"] * n}
    if clipped:
        want["opt_sqnorm"] = plan["buckets"] * n
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        want[name] = want[f"{name}_mma"] = layers * n
    return want


def _served_net(torch, mt, dev, dtype, model_kwargs):
    """BERT-base QA from seed 9, hybridized: the fine-tune's net (bf16
    through amp, LayerNorms f32) where ``dtype`` is None, else the model
    built in ``dtype`` (phase 5's, LayerNorms bf16 too)."""
    from mxnet_tpu_torch.gluon.model_zoo import bert

    net = bert.BERTForQA(bert.bert_12_768_12(
        vocab_size=30522, max_length=512, dropout=0.0,
        dtype=dtype or "float32", **model_kwargs))
    net.initialize(device=dev, generator=torch.Generator().manual_seed(9))
    if dtype is None:
        mt.amp.convert_hybrid_block(net, "bfloat16")
    net.hybridize()
    return net


def _served_against_eager(torch, mt, net, dev, rungs, seed):
    """A batch through each rung's ``call_cached_graph`` against the eager
    forward of the same weights (phase 5's bound); the largest difference."""
    gen = torch.Generator().manual_seed(seed)
    worst = 0.0
    for b in rungs:
        ids = torch.randint(0, 30522, (b, SERVE_SEQ), generator=gen,
                            dtype=torch.int32).to(dev)
        seg = torch.zeros_like(ids)
        got = net.call_cached_graph(ids, seg)
        with mt.autograd.pause(), torch.inference_mode():
            want = net(ids, seg)
        diff = max((g.float() - w.float()).abs().max().item()
                   for g, w in zip(got, want))
        scale = max(w.float().abs().max().item() for w in want)
        check(all(bool(torch.isfinite(g.float()).all()) for g in got)
              and diff <= 1e-2 * max(1.0, scale),
              f"resume serving: rung {b} and the eager forward of the "
              f"loaded weights differ by {diff}")
        worst = max(worst, diff)
    return worst


def phase_resume(torch, mt, finetune, serving, build, kopt, dev,
                 **model_kwargs):
    """16. Checkpoint and resume on BERT-base (``model_kwargs`` cut it:
    tests/test_torch_cuda_resume.py; the counts are gated on the card
    only).

    A: 4 phased steps with the fine-tune's global-norm clip. B: a build
    from A's seed takes 2 steps and saves (``save_parameters``,
    ``save_states``); a build from another seed loads both and takes 2
    steps on A's batch: after the load every weight, master and moment
    equals A's after step 2, after its steps A's after step 4 and A's
    losses, bit for bit (K3, K4 and K5 repeat bitwise); the counts over
    the resumed steps. Then through TrainStep without the clip: a captured
    step, ``load_states`` and ``load_parameters`` in place, 2 replays with
    no rebuild and no capture, held to a phased build loaded from the same
    files. Then served: the rungs of an engine's captured net answer from
    ``load_parameters`` with no capture; a retype by
    ``cast_dtype=True, dtype_source='saved'`` captures each rung again."""
    import tempfile

    gc_collect(torch)
    t_phase = time.perf_counter()
    on_card = dev.type == "cuda"
    layers = model_kwargs.get("num_layers", 12)
    out = dict(card=card_line() if on_card else None)

    # A: the uninterrupted run
    net_a, tr_a, step_a = _resume_build(finetune, dev, 0, 1.0,
                                        **model_kwargs)
    batch = step_a.args
    ts_a = step_a.func
    losses_a = _resume_steps(torch, ts_a, batch, RESUME_STEPS)
    check(ts_a.last_path == "phased" and "clip_global_norm" in str(
        ts_a.ineligible_reason()), f"A ran {ts_a.last_path}")
    after2 = _snapshot(kopt, net_a, tr_a)
    losses_a += _resume_steps(torch, ts_a, batch, RESUME_STEPS)
    after4 = _snapshot(kopt, net_a, tr_a)
    del net_a, tr_a, step_a, ts_a

    root = Path(__file__).resolve().parent / "build" / "scratch"
    root.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="resume_", dir=root) as tmp:
        params = os.path.join(tmp, "bert.params")
        states = os.path.join(tmp, "bert.states")
        # B: two steps, then the checkpoint
        net_b, tr_b, step_b = _resume_build(finetune, dev, 0, 1.0,
                                            **model_kwargs)
        losses_b = _resume_steps(torch, step_b.func, batch, RESUME_STEPS)
        check(losses_b == losses_a[:RESUME_STEPS]
              and _snap_diff(torch, _snapshot(kopt, net_b, tr_b),
                             after2)[0],
              f"two builds from one seed differ after {RESUME_STEPS} "
              f"steps: losses {losses_b} and {losses_a}")
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        net_b.save_parameters(params)
        mt.waitall()   # the write runs on an IO thread: time it whole
        t1 = time.perf_counter()
        tr_b.save_states(states)
        t2 = time.perf_counter()
        out.update(params_bytes=os.path.getsize(params),
                   states_bytes=os.path.getsize(states),
                   save_parameters_s=t1 - t0, save_states_s=t2 - t1)
        del net_b, tr_b, step_b

        # B resumed: another seed, so the load overwrites everything
        net_r, tr_r, step_r = _resume_build(finetune, dev, 7, 1.0,
                                            **model_kwargs)
        _resume_steps(torch, step_r.func, step_r.args, 1)
        check(not _snap_diff(torch, _snapshot(kopt, net_r, tr_r),
                             after2)[0], "the other seed's build equals A")
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        net_r.load_parameters(params)
        t1 = time.perf_counter()
        tr_r.load_states(states)
        if on_card:
            torch.cuda.synchronize()
        t2 = time.perf_counter()
        out.update(load_parameters_s=t1 - t0, load_states_s=t2 - t1)
        same, diff = _snap_diff(torch, _snapshot(kopt, net_r, tr_r), after2)
        check(same, f"after the load the weights, masters and moments "
                    f"differ from A's after step {RESUME_STEPS}: {diff}")
        check(tr_r.optimizer.num_update == RESUME_STEPS,
              f"num_update {tr_r.optimizer.num_update} after the load")
        losses_r, launches = _counted(torch, build, step_r.func, batch,
                                      RESUME_STEPS)
        same, diff = _snap_diff(torch, _snapshot(kopt, net_r, tr_r), after4)
        out.update(losses_a=losses_a, losses_resumed=losses_r,
                   resumed_equals_uninterrupted=same,
                   resumed_max_abs_diff=diff, launches=launches)
        check(same and losses_r == losses_a[RESUME_STEPS:],
              f"the resumed run differs from the uninterrupted one: losses "
              f"{losses_r} and {losses_a}, largest difference {diff}")
        if on_card:
            want = _want_launches(kopt, tr_r, RESUME_STEPS, True, layers)
            check(launches == want, f"resumed steps launched {launches}; "
                                    f"want {want}")
        del net_r, tr_r, step_r

        # through TrainStep's graph, no clip: loads in place, no rebuild
        net_g, tr_g, step_g = _resume_build(finetune, dev, 3, None,
                                            **model_kwargs)
        ts_g = step_g.func
        _resume_steps(torch, ts_g, batch, 2)   # warm-up, capture + replay
        captures = ts_g.jit_trace_count()
        tr_g.load_states(states)
        net_g.load_parameters(params)
        same, diff = _snap_diff(torch, _snapshot(kopt, net_g, tr_g), after2)
        check(same, f"TrainStep's net after the loads: {diff}")
        losses_g, launches_g = _counted(torch, build, ts_g, batch,
                                        RESUME_STEPS)
        check(ts_g.last_path == "whole_step" or not on_card,
              f"TrainStep ran {ts_g.last_path}: {ts_g.ineligible_reason()}")
        check(ts_g.jit_trace_count() == captures == 1,
              f"TrainStep captured again after the loads: "
              f"{ts_g.jit_trace_count()} (was {captures})")
        if on_card:
            want = _want_launches(kopt, tr_g, RESUME_STEPS, False, layers)
            check(launches_g == want, f"TrainStep replays launched "
                                      f"{launches_g}; want {want}")
        net_p, tr_p, step_p = _resume_build(finetune, dev, 4, None,
                                            **model_kwargs)
        net_p.load_parameters(params)
        tr_p.load_states(states)
        with phased_steps():
            losses_p = _resume_steps(torch, step_p.func, batch, RESUME_STEPS)
        check(step_p.func.last_path == "phased", "the twin did not run "
                                                 "phased")
        same_g, diff_g = _snap_diff(torch, _snapshot(kopt, net_g, tr_g),
                                    _snapshot(kopt, net_p, tr_p))
        # graph against phased: phase 15's loss bound (bf16, 0.03); the
        # weights, masters and moments within 1e-3 of the largest
        scale = max(t.float().abs().max().item()
                    for t in _snapshot(kopt, net_p, tr_p)[1])
        loss_diff = max(abs(a - b) for a, b in zip(losses_g, losses_p))
        out.update(train_step=dict(
            captures=ts_g.jit_trace_count(), losses_graph=losses_g,
            losses_phased=losses_p, bitwise=same_g, max_abs_diff=diff_g,
            launches=launches_g))
        check(loss_diff <= 0.03 and diff_g <= 1e-3 * max(1.0, scale),
              f"TrainStep after the loads and the phased twin differ: "
              f"losses {losses_g} {losses_p}, states {diff_g}")
        del net_g, tr_g, step_g, ts_g, net_p, tr_p, step_p
        if on_card:
            gc_collect(torch)

        # served from the checkpoint: the fine-tune's net, captured rungs
        rungs = SERVE_RUNGS
        net_s = _served_net(torch, mt, dev, None, model_kwargs)
        eng = serving.InferenceEngine(net_s, name="bert_qa_resumed",
                                      max_batch_size=rungs[-1], timeout_ms=0)
        example = torch.zeros((1, SERVE_SEQ), dtype=torch.int32)
        info = eng.warmup(example, example)
        captured = net_s.capture_count()
        net_s.load_parameters(params)
        check(_snap_diff(torch, ([p._tensor() for p in net_s.collect_params()
                                  .values()], []), (after2[0], []))[0],
              "the served net's weights differ from the checkpoint's")
        err_in_place = _served_against_eager(torch, mt, net_s, dev, rungs,
                                             21)
        in_place = dict(captures_after_load=net_s.capture_count() - captured,
                        recompiles_since_warmup=eng.recompiles_since_warmup(),
                        max_abs_diff=err_in_place, warmup=info)
        check(in_place["captures_after_load"] == 0
              and in_place["recompiles_since_warmup"] == 0,
              f"an in-place load made the rungs capture again: {in_place}")
        del net_s, eng

        # a net whose LayerNorms are bf16 takes the file's f32 ones by
        # retyping: their storage moves and each rung captures again
        net_c = _served_net(torch, mt, dev, "bfloat16", model_kwargs)
        eng = serving.InferenceEngine(net_c, name="bert_qa_retyped",
                                      max_batch_size=2, timeout_ms=0)
        eng.warmup(example, example)
        captured = net_c.capture_count()
        try:
            net_c.load_parameters(params)
            check(False, "a load across dtypes without cast_dtype passed")
        except AssertionError:
            pass
        net_c.load_parameters(params, cast_dtype=True, dtype_source="saved")
        err_saved = _served_against_eager(torch, mt, net_c, dev, [1, 2], 22)
        saved = dict(captures_after_load=net_c.capture_count() - captured,
                     recompiles_since_warmup=eng.recompiles_since_warmup(),
                     max_abs_diff=err_saved)
        check(saved["captures_after_load"] == (2 if on_card else 0),
              f"a retyping load did not capture each rung again: {saved}")
        out.update(serving_in_place=in_place, serving_retyped=saved)
        del net_c, eng
    out["phase_s"] = time.perf_counter() - t_phase
    say(f"resume: {json.dumps(out)}")
    say(f"resume checkpoint: parameters {out['params_bytes']} bytes, states "
        f"{out['states_bytes']} bytes; save {out['save_parameters_s']:.3f} + "
        f"{out['save_states_s']:.3f} s, load {out['load_parameters_s']:.3f} "
        f"+ {out['load_states_s']:.3f} s; phase {out['phase_s']:.1f} s; "
        f"card {out['card']}")
    if on_card:
        gc_collect(torch)
    return out


def gc_collect(torch):
    import gc

    gc.collect()
    torch.cuda.empty_cache()


# -- LAMB under AMP, a main path (phase 17) ----------------------------------

LAMB_LR = 1e-3


def _lamb_build(finetune, mt, dev, dropout, **model_kwargs):
    """BERT-base (or ``model_kwargs``' cut) for LAMB under MXNet's AMP loop:
    Xavier-initialized, bf16 with f32 masters, lr 1e-3, wd 0.01, the
    global-norm clip at 1.0 (finetune's defaults beside those)."""
    return finetune.build_bert_finetune(
        batch=8, seq=384, dropout=dropout, dtype="bfloat16",
        learning_rate=LAMB_LR, device=dev, seed=0, optimizer="lamb",
        init=mt.initializer.Xavier(), amp_loop=True, **model_kwargs)


def _timed_optimizer(torch, trainer):
    """Wrap ``trainer.step`` so that each call records a pair of CUDA
    events on the current stream; returns the list of pairs."""
    pairs, inner = [], trainer.step

    def step(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = inner(*args, **kwargs)
        end.record()
        pairs.append((start, end))
        return out

    trainer.step = step
    return pairs


def _lamb_alone_ms(torch, topt, trainer):
    """The LAMB update of every trainable parameter alone, as update_fused
    issues it, on copies of the trainer's weights, states and gradients
    (two sets, each past the L2): summed kernel time of the profiler
    (:func:`device_ms`), host-issued (CUDA events), and the bytes of its
    byte bound (each master, m and v read and written, each gradient read
    and each low-precision weight written once)."""
    opt = trainer.optimizer
    kw = dict(learning_rate=opt.lr, wd=opt.wd, rescale_grad=1.0 / 8,
              clip_global_norm=opt.clip_global_norm, multi_precision=True,
              beta1=opt.beta1, beta2=opt.beta2, epsilon=opt.epsilon)
    members = [(i, p) for i, p in enumerate(trainer._params)
               if p.grad_req != "null"]
    nbytes = 0
    for i, p in members:
        w = p._tensor()
        st = trainer._states[i]
        mp = opt._is_mp_state(w, st)
        master = st[0] if mp else w
        # master, m, v read and written; the gradient read; the bf16 weight
        # written
        nbytes += 3 * 2 * master.numel() * 4 + w.numel() * w.element_size()
        nbytes += w.numel() * w.element_size() if mp else 0
    sets = []
    for _ in range(2):
        sets.append(([i for i, _ in members],
                     [p._tensor().detach().clone() for _, p in members],
                     [p.grad().clone() for _, p in members],
                     [_clone_state(trainer._states[i]) for i, _ in members]))
    opts = [topt.LAMB(**kw) for _ in sets]

    def update(k):
        idx, ws, gs, sts = sets[k]
        opts[k].update_multi_precision(idx, ws, gs, sts)

    ms = device_ms(torch, [partial(update, 0), partial(update, 1)], iters=4)
    host = cuda_ms(torch, partial(update, 0), iters=3)
    del sets
    return dict(ms=ms, ms_host_issued=host, bytes=nbytes,
                bound_ms=1e3 * nbytes / HBM_BYTES_PER_S, bound_by="bytes")


def _batch_loss(mt, net, batch):
    """The mean loss of the fixed batch in predict mode (no dropout, not
    recorded): what the training steps move, without their dropout
    noise."""
    tokens, segments, starts, ends = batch
    lf = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    s, e = net(tokens, segments)
    return (lf(s.float(), starts) + lf(e.float(), ends)).mean().item()


def phase_lamb_amp(torch, mt, finetune, build, kopt, topt, dispatch, dev,
                   adamw=None, warmup=TRAIN_WARMUP, steps=TRAIN_STEPS,
                   **model_kwargs):
    """Phase 17 (module docstring). ``adamw``: phase 6's summary, printed
    beside. ``model_kwargs`` cut the model (the card tests)."""
    net, trainer, step = _lamb_build(finetune, mt, dev, 0.1, **model_kwargs)
    layers = len(net.bert.encoder.layers)
    n_train = len(net.trainable_param_names())
    eval_before = _batch_loss(mt, net, step.batch)
    warm, _ = _run_steps(torch, step, warmup)
    build.reset_counters()                       # main path: counts from 0
    kopt.TENSORS.reset()
    dispatch.reset_counts()
    pairs = _timed_optimizer(torch, trainer)
    losses, secs, host, step_ev = [], [], [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        loss = step()
        end.record()
        host.append(time.perf_counter() - t0)
        losses.append(loss.float().mean().item())     # synchronises
        secs.append(time.perf_counter() - t0)
        step_ev.append((start, end))
    launches = {c.name: c.value for c in build.COUNTERS.values()}  # after
    outcomes = {f"{k}:{o}": n for (k, o), n in dispatch.COUNTS.items()}
    plan = opt_plan(kopt, trainer)
    eval_after = _batch_loss(mt, net, step.batch)
    torch.cuda.synchronize()
    opt_ms = [a.elapsed_time(b) for a, b in pairs]
    step_stream_ms = [a.elapsed_time(b) for a, b in step_ev]
    scaler = trainer._amp_loss_scaler

    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        check(launches[name] == launches[f"{name}_mma"] == layers * steps
              and launches[f"{name}_fp32"] == 0,
              f"LAMB: {name} {launches[name]} launches, "
              f"{launches[name + '_mma']} tensor-core; want {layers} x "
              f"{steps}")
    check(launches["opt_sqnorm"] == plan["buckets"] * steps
          and launches["opt_ladder"] == 0 and kopt.TENSORS.value == 0,
          f"LAMB: opt_sqnorm {launches['opt_sqnorm']}, opt_ladder "
          f"{launches['opt_ladder']}; want {plan['buckets']} x {steps} norm "
          f"launches and no ladder launch")
    check(outcomes == {"opt_lamb:unsupported_rule": steps * n_train},
          f"LAMB dispatch outcomes {outcomes}")
    check(scaler.loss_scale == 1.0 and not any(step.overflows),
          f"LAMB: loss scale {scaler.loss_scale}, overflows "
          f"{step.overflows}")
    check(all(math.isfinite(x) for x in warm + losses
                  + [eval_before, eval_after]),
          f"LAMB: non-finite loss {warm + losses}, batch loss "
          f"{eval_before} -> {eval_after}")
    # the training losses carry each step's dropout noise (about 0.5 at
    # this loss near 2 ln 384): the fall is read on the batch's loss
    # without dropout, before the warm-up steps and after the counted ones
    check(eval_after < eval_before,
          f"LAMB: the loss did not fall: the batch's loss in predict mode "
          f"{eval_before} before the steps, {eval_after} after (training "
          f"losses: warm-up {warm}, counted {losses})")
    for name, p in net.collect_params().items():
        check(bool(torch.isfinite(p._tensor().float()).all()),
              f"LAMB: non-finite parameter {name}")
    p50 = sorted(secs)[len(secs) // 2]
    summary = dict(
        model=f"BERTForQA(bert_12_768_12{', ' if model_kwargs else ''}"
              f"{', '.join(f'{k}={v}' for k, v in model_kwargs.items())})",
        init="Xavier()", dtype="bfloat16+f32 masters", batch=8, seq=384,
        dropout=0.1, optimizer="lamb", lr=LAMB_LR, wd=0.01,
        clip_global_norm=1.0, amp="init, convert_hybrid_block, "
        "init_trainer, scale_loss, unscale, has_overflow, update_scale",
        warmup_steps=warmup, warmup_losses=warm, steps=steps, losses=losses,
        batch_loss_predict_mode=[eval_before, eval_after],
        loss_scale=scaler.loss_scale, overflows=step.overflows,
        trainable_parameters=n_train, step_ms=[1e3 * s for s in secs],
        step_ms_p50=1e3 * p50,
        host_ms=[1e3 * h for h in host],
        host_ms_p50=1e3 * sorted(host)[len(host) // 2],
        samples_per_s=8 / p50, step_stream_ms=step_stream_ms,
        optimizer_stream_ms=opt_ms,
        optimizer_share_of_step=sum(opt_ms) / sum(step_stream_ms),
        launches={k: v for k, v in launches.items() if v},
        dispatch=outcomes, opt_plan=plan,
        peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        card=card_line())
    if adamw is not None:
        summary["adamw_phase6_step_ms_p50"] = adamw["step_ms_p50"]
        summary["adamw_phase6_samples_per_s"] = adamw["samples_per_s"]
    summary["optimizer_alone"] = _lamb_alone_ms(torch, topt, trainer)
    say(f"lamb_amp: {json.dumps(summary)}")
    del net, trainer, step, pairs
    gc_collect(torch)

    # kernels against their plain versions from one state, without dropout,
    # as phase 6 holds them
    runs = {}
    for label in ("kernels", "plain"):
        if label == "plain":
            os.environ["MXTPU_FLASH_ATTENTION"] = "0"
        build.reset_counters()
        try:
            with ladder_swap(kopt, label == "plain"):
                net, trainer, step = _lamb_build(finetune, mt, dev, 0.0,
                                                 **model_kwargs)
                runs[label], _ = _run_steps(torch, step, 3)
        finally:
            os.environ.pop("MXTPU_FLASH_ATTENTION", None)
        used = {k: build.COUNTERS[k].value for k in (
            "flash_attention_fwd", "flash_attention_bwd_dq",
            "flash_attention_bwd_dkv", "opt_sqnorm")}
        check(all(n > 0 for n in used.values()) if label == "kernels"
              else not any(used.values()),
              f"LAMB {label} run: kernel launches {used}")
        del net, trainer, step
        gc_collect(torch)
    diffs = [abs(a - b) for a, b in zip(runs["kernels"], runs["plain"])]
    say(f"LAMB kernels vs plain (dropout 0, 3 steps): kernels "
        f"{runs['kernels']} plain {runs['plain']} max diff {max(diffs):.3g} "
        f"(tol 0.03)")
    check(max(diffs) <= 0.03, f"LAMB kernel and plain training disagree: "
                              f"{diffs}")
    summary["kernels_vs_plain_max_loss_diff"] = max(diffs)
    return summary


# -- the 14 rules on the card against the CPU (phase 18) ---------------------

SWEEP_RULES = ("sgld", "dcasgd", "nadam", "adabelief", "adamax", "ftml",
               "rmsprop", "adagrad", "adadelta", "ftrl", "lamb", "lans",
               "lars", "groupadagrad")


def _rule_sides(torch, topt, rule, case, dev, weights, grads, noise):
    """One fused update of ``rule`` over ``weights`` on ``dev`` in
    ``case`` (f32, bf16, bf16 + f32 masters), with wd, a rescale and a
    per-element clip: ``(before, after)``, each a list of ``(w, state)``
    on the CPU. SGLD's normal draws are ``noise``, given."""
    dt = torch.float32 if case == "f32" else torch.bfloat16
    kw = dict(wd=0.0 if rule == "groupadagrad" else 1e-3,
              rescale_grad=1.0 / 8, clip_gradient=0.5,
              multi_precision=case == "bf16_mp")
    opt = topt.create(rule, **kw)
    ws = [w.to(device=dev, dtype=dt, copy=True) for w in weights]
    gs = [g.to(device=dev, dtype=dt, copy=True) for g in grads]
    sts = [opt.create_state_multi_precision(i, w) for i, w in enumerate(ws)]
    before = [(_cpu_state(torch, w), _cpu_state(torch, s))
              for w, s in zip(ws, sts)]
    given = {id(w): n for w, n in zip(ws, noise)}
    saved = topt._sgld_normal
    topt._sgld_normal = lambda w: given[id(w)].to(w.device)
    if case == "bf16_mp":   # SGLD's update runs on the masters
        given.update({id(s[0]): n for s, n in zip(sts, noise)})
    try:
        opt.update_multi_precision(list(range(len(ws))), ws, gs, sts)
    finally:
        topt._sgld_normal = saved
    return before, [(_cpu_state(torch, w), _cpu_state(torch, s))
                    for w, s in zip(ws, sts)]


def _cpu_state(torch, s):
    if s is None:
        return None
    if isinstance(s, tuple):
        return tuple(_cpu_state(torch, x) for x in s)
    return s.detach().to("cpu", copy=True)


def phase_rule_sweep(torch, mt, kopt, topt, dev, **model_kwargs):
    """Phase 18 (module docstring): every leaf of the card's update within
    4 f32 ulps of its largest value (one bf16 ulp for a bf16 leaf) plus
    1e-3 of its largest change of the CPU's."""
    from mxnet_tpu_torch.gluon.model_zoo import bert

    cfg = dict(dict(num_layers=2), **model_kwargs)
    net = bert.BERTForQA(bert.bert_12_768_12(vocab_size=30522,
                                             max_length=512, **cfg))
    net.initialize(device=mt.cpu(),
                   generator=torch.Generator().manual_seed(3))
    weights = [p._tensor().detach() for _, p in sorted(
        net.collect_params().items()) if p.grad_req != "null"]
    gen = torch.Generator().manual_seed(4)
    grads = [torch.randn(w.shape, generator=gen) for w in weights]
    noise = [torch.randn(w.shape, generator=gen) for w in weights]
    n_elems = sum(w.numel() for w in weights)
    rows, worst = [], 0.0
    for rule in SWEEP_RULES:
        keep = [k for k, w in enumerate(weights)
                if rule != "groupadagrad" or w.dim() >= 2]
        ws, gs, ns = ([x[k] for k in keep] for x in (weights, grads, noise))
        for case in ("f32", "bf16", "bf16_mp"):
            t0 = time.perf_counter()
            before, cpu = _rule_sides(torch, topt, rule, case, "cpu", ws, gs,
                                      ns)
            t1 = time.perf_counter()
            _, card = _rule_sides(torch, topt, rule, case, dev, ws, gs, ns)
            t2 = time.perf_counter()
            label = f"rule sweep {rule} {case}"
            ratio = 0.0
            # a bf16 weight without a master may not move by an update
            # smaller than half its ulp; the update as a whole must
            check(any(bool((w[0] != b[0]).any())
                       for w, b in zip(cpu, before)),
                  f"{label}: no weight changed")
            for k, (a, w, b) in enumerate(zip(card, cpu, before)):
                al, wl, bl = (kopt._leaves(x) for x in (a, w, b))
                check(len(al) == len(wl) == len(bl), f"{label}: leaf count")
                for x, y, y0 in zip(al, wl, bl):
                    err = (x.float() - y.float()).abs().max().item()
                    big = y.float().abs().max().item()
                    moved = (y.float() - y0.float()).abs().max().item()
                    ulp = F32_EPS if y.dtype == torch.float32 else 2.0 ** -7
                    n_ulp = 4 if y.dtype == torch.float32 else 1
                    tol = n_ulp * ulp * big + 1e-3 * moved
                    check(err <= tol, f"{label}: weight {k}, a "
                          f"{y.dtype} leaf: card vs CPU {err:.3g} (tol "
                          f"{tol:.3g})")
                    if tol > 0:
                        ratio = max(ratio, err / tol)
            worst = max(worst, ratio)
            rows.append(dict(rule=rule, case=case, tensors=len(ws),
                             max_err_over_tol=ratio,
                             cpu_s=t1 - t0, card_s=t2 - t1))
    out = dict(model=f"BERTForQA(bert_12_768_12, {cfg})",
               parameters=n_elems, tensors=len(weights), cases=rows,
               max_err_over_tol=worst,
               tolerance="per leaf: 4 f32 ulps (1 bf16 ulp for a bf16 leaf)"
                         " of its largest value + 1e-3 of its largest "
                         "change on the CPU; SGLD with the noise given")
    say(f"rule_sweep: {json.dumps(out)}")
    del net, weights, grads, noise
    gc_collect(torch)
    return out


# -- ring flash attention over a mesh (phase 19) ------------------------------

RING_POSITIONS = 4
RING_HEADS = 12           # BERT-base's attention width: 12 heads of 64
RING_SEQ = 32768          # the whole sequence, 8192 rows a position
RING_SMALL = 4096         # the f32 and plain-ring comparisons
RING_ULYSSES = 8192       # the plain score matrix of RING_SEQ does not fit
RING_WARMUP, RING_TIMED = 2, 5
RING_RAGGED = 1000        # a local shard that is no multiple of a tile
RING_SERVE = (8, 12, 384, 64)   # the forward hop beside K4 at serving shape


def _p50_ms(torch, fn, before=None):
    """p50 over RING_TIMED host-issued runs of ``fn(before())`` after
    RING_WARMUP, each between two CUDA events (``before`` untimed)."""
    times = []
    for i in range(RING_WARMUP + RING_TIMED):
        arg = before() if before is not None else None
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(arg)
        end.record()
        end.synchronize()
        if i >= RING_WARMUP:
            times.append(start.elapsed_time(end))
    return sorted(times)[RING_TIMED // 2]


def _rel_err(got, want):
    """``(max |got - want|, max |want|)`` in float32."""
    return ((got.float() - want.float()).abs().max().item(),
            want.float().abs().max().item())


def _ring_operands(torch, gen, dev, s, heads, dt, d=64, b=1):
    return tuple(torch.randn(b, heads, s, d, device=dev, generator=gen)
                 .to(dt) for _ in range(4))


def ring_hop_bound(b, h, s, d, causal, backward):
    """Least time (ms) of one hop and what bounds it: 4*D operations per
    live (q, k) pair forward, 2.5 times that backward, at the bf16 peak;
    bytes: the bf16 operands read once (q, k, v; and dout backward), the
    f32 state read and written (acc and lse forward; lse and delta read,
    dq, dk, dv read and written backward)."""
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 4 * b * h * pairs * d * (2.5 if backward else 1.0)
    n = b * h * s * d
    nbytes = (4 * n * 2 + 2 * b * h * s * 4 + 3 * 2 * n * 4 if backward
              else 3 * n * 2 + 2 * n * 4 + 2 * b * h * s * 4)
    t_ops, t_bytes = flops / PEAK_FLOPS["bfloat16"], nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def ring_hop_case(torch, rh, gen, dev, b, h, s, d, causal):
    """Each hop kernel against its plain version on the same inputs: the
    forward from a running state (a middle hop into acc, and a last hop
    into bf16 out), out or acc within 2^-7 of its largest (P rounds to
    bf16 against another running maximum) and lse within 1e-5 of its
    largest; the backward's increments of dq, dk, dv within 2^-7 of their
    largest (P and dS round to bf16 in both, sums in other orders)."""
    q, k, v, do = _ring_operands(torch, gen, dev, s, h, torch.bfloat16, d, b)
    scale = d ** -0.5
    acc0 = 0.5 * torch.randn(b, h, s, d, device=dev, generator=gen)
    lse0 = torch.randn(b, h, s, device=dev, generator=gen) + 3.0
    errs = {}
    for last in (False, True):
        got = []
        for fn in (rh.ring_hop_fwd, rh.ring_hop_fwd_reference):
            acc, lse = acc0.clone(), lse0.clone()
            out = torch.empty_like(q) if last else None
            r, lse = fn(q, k, v, acc, lse, causal, scale, last, out)
            got.append((r, lse))
        (r, lse), (r_want, lse_want) = got
        e, big = _rel_err(r, r_want)
        check(e <= 2 ** -7 * big, f"ring_flash_fwd {b}x{h}x{s}x{d} causal "
              f"{causal} last {last}: {e:.3g} (tol 2^-7 of {big:.3g})")
        el, bigl = _rel_err(lse, lse_want)
        check(el <= 1e-5 * max(bigl, 1.0), f"ring_flash_fwd lse {el:.3g} "
              f"(tol 1e-5 of {bigl:.3g})")
        errs[f"fwd_{'last' if last else 'middle'}"] = e
        errs[f"fwd_{'last' if last else 'middle'}_over_largest"] = e / big
        errs["lse"] = max(errs.get("lse", 0.0), el)
    out, lse = rh.ring_hop_fwd_reference(
        q, k, v, None, torch.empty(b, h, s, device=dev), causal, scale, True,
        torch.empty_like(q), True)
    delta = rh.ring_delta(out, do)
    base = [torch.randn(b, h, s, d, device=dev, generator=gen)
            for _ in range(3)]
    sums = []
    for fn in (rh.ring_hop_bwd, rh.ring_hop_bwd_reference):
        gs = [t.clone() for t in base]
        fn(q, k, v, do, lse, delta, *gs, causal, scale)
        sums.append([g - z for g, z in zip(gs, base)])
    for name, got, want in zip(("dq", "dk", "dv"), *sums):
        e, big = _rel_err(got, want)
        check(e <= 2 ** -7 * big, f"ring_flash_bwd {b}x{h}x{s}x{d} causal "
              f"{causal}: {name} {e:.3g} (tol 2^-7 of {big:.3g})")
        errs[f"bwd_{name}"] = e
        errs[f"bwd_{name}_over_largest"] = e / big
    return dict(shape=[b, h, s, d], causal=causal, **errs)


def _sass_hgmma(build):
    """HGMMA instructions in each hop library's SASS, by cuobjdump where
    the toolkit has it (None where it does not)."""
    tool = Path(build.nvcc_path()).with_name("cuobjdump")
    found = {}
    for name in ("ring_flash_fwd", "ring_flash_bwd"):
        if not tool.is_file():
            found[name] = None
            continue
        sass = subprocess.run([str(tool), "-sass",
                               str(build.library_path(name))],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout
        found[name] = sass.count("HGMMA")
        check(found[name] > 0, f"{name}: no HGMMA in its SASS")
    return found


def phase_ring(torch, build, fa, card, seq=RING_SEQ, heads=RING_HEADS,
               small=RING_SMALL, ulysses_seq=RING_ULYSSES,
               ragged=RING_RAGGED, serve=RING_SERVE):
    """Phase 19 (module docstring): ``{"full": {...}, "causal": {...},
    "hop_cases": [...], "serve_hop": {...}, "f32_vs_cpu": ...,
    "bf16_vs_plain": ..., "ulysses_vs_plain_ring": ...}``."""
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops import ring_hop as rh
    from mxnet_tpu_torch.parallel import mesh as pmesh
    from mxnet_tpu_torch.parallel import ring_attention as ring
    from mxnet_tpu_torch.parallel import ulysses

    n = RING_POSITIONS
    shard = seq // n
    dev = torch.device("cuda", 0)
    t_phase = time.perf_counter()
    out = {"hgmma_in_sass": _sass_hgmma(build)}
    # each hop kernel against its plain version: the ring's shard, D 128,
    # a ragged shard, causal and not
    gen = torch.Generator(device=dev).manual_seed(18)
    out["hop_cases"] = [
        ring_hop_case(torch, rh, gen, dev, 1, h, s, d, causal)
        for h, s, d in ((heads, shard, 64), (heads, min(shard, 2048), 128),
                        (heads, ragged, 64), (4, ragged, 128))
        for causal in (False, True)]
    gc_collect(torch)
    mesh = pmesh.make_mesh({"sp": n}, [dev] * n)
    gen = torch.Generator(device=dev).manual_seed(19)
    q, k, v, dout = _ring_operands(torch, gen, dev, seq, heads,
                                   torch.bfloat16)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]

    def ring_fwd(_=None, causal=False):
        for t in leaves:
            t.grad = None
        return ring.ring_flash_attention_sharded(*leaves, mesh,
                                                 causal=causal)

    for causal in (False, True):
        label = "causal" if causal else "full"
        want = n * (n + 1) // 2 if causal else n * n
        # the main path: counts from 0 just before, read just after; no
        # call inside may synchronise the host
        torch.cuda.synchronize()
        build.reset_counters()
        ring.ROUTES.clear()
        torch.cuda.set_sync_debug_mode("error")
        try:
            o = ring_fwd(causal=causal)
            o.backward(dout)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        launches = {c.name: c.value for c in build.COUNTERS.values()
                    if c.value}
        routes = dict(ring.ROUTES)
        grads = [t.grad for t in leaves]
        for kname in ("ring_flash_fwd", "ring_flash_bwd"):
            check(launches.get(kname) == want,
                  f"ring {label}: {kname} launched {launches.get(kname)} "
                  f"times, want {want}")
        check(not any(name.startswith("flash_attention") for name in
                      launches),
              f"ring {label}: K4/K5 launched inside the ring: {launches}")
        check(launches.get("ring_flash_attention") == 1
              and launches.get("ring_flash_attention_bwd") == 1
              and routes == {"hop": 2},
              f"ring {label}: ring counts {launches}, routes {routes}")
        # against the plain ring (f32 online softmax) on the same inputs
        with torch.no_grad():
            plain = ring.ring_attention_sharded(q, k, v, mesh, causal=causal)
        err, big = _rel_err(o, plain)
        check(err <= 2 ** -7 * big, f"ring {label}: out vs the plain ring "
              f"{err:.3g} (tol 2^-7 of {big:.3g})")
        del plain
        # the ring backward with the plain hop backward on each hop (at
        # the local shard's shape, the same in-place sums) in place of the
        # hop kernel, on the ring forward's saved out and lse
        shards = [pmesh.split(t, mesh, "sp", 2) for t in (q, k, v, dout)]
        qs, ks, vs, ds = shards
        scale = 64 ** -0.5
        with torch.no_grad():
            outs, lses = ring._ring_flash_fwd_impl(qs, ks, vs, causal, scale)
            plain_grads = [pmesh.assemble(g, 2) for g in ring._ring_flash_bwd(
                qs, ks, vs, outs, lses, ds, causal, scale,
                hop_bwd=rh.ring_hop_bwd_reference)]
        gc_collect(torch)
        # the tolerance of the K4/K5 route, kept: 2^-7 of the largest for
        # the kernels, and n x 2^-8 for the bf16 rounding of each hop's
        # gradients that route made before the f32 sum (the hop kernels add
        # in f32 and round once)
        grad_tol = 2 ** -7 + n * 2 ** -8
        grad_err = {}
        for name, g, r in zip(("dq", "dk", "dv"), grads, plain_grads):
            e, b = _rel_err(g, r)
            check(e <= grad_tol * b, f"ring {label}: {name} vs the ring on "
                  f"plain hops {e:.3g} (tol {grad_tol:.4g} of {b:.3g})")
            grad_err[name] = e / b
        del plain_grads
        # a second witness: one K4/K5 launch over the whole sequence
        ref, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        ref_grads = fa.flash_attention_bwd(q, k, v, ref, lse, dout,
                                           causal=causal)
        e, b = _rel_err(o, ref)
        check(e <= 2 ** -7 * b, f"ring {label}: out vs one K4 launch "
              f"{e:.3g} (tol 2^-7 of {b:.3g})")
        one_err = {"out": e / b}
        for name, g, r in zip(("dq", "dk", "dv"), grads, ref_grads):
            e, b = _rel_err(g, r)
            check(e <= grad_tol * b, f"ring {label}: {name} vs one K5 pair "
                  f"{e:.3g} (tol {grad_tol:.4g} of {b:.3g})")
            one_err[name] = e / b
        # times: p50 of RING_TIMED after RING_WARMUP, CUDA events
        fwd_ms = _p50_ms(torch, partial(ring_fwd, causal=causal))
        bwd_ms = _p50_ms(torch, lambda o: o.backward(dout),
                         partial(ring_fwd, causal=causal))
        # the hop kernels alone in the ring's order on the ring's operands
        # (the rest of the ring's time is allocation, delta and moves)
        hops = _hops_flat(ring, n, causal)
        last = {my: i for i, my, _, _ in hops}
        accs = [torch.empty(t.shape, dtype=torch.float32, device=dev)
                for t in qs]
        lse_s = [torch.empty(t.shape[:3], dtype=torch.float32, device=dev)
                 for t in qs]
        hop_outs = [torch.empty_like(t) for t in qs]
        hop_fwd_ms = _p50_ms(torch, lambda _: [
            rh.ring_hop_fwd(qs[my], ks[src], vs[src], accs[my], lse_s[my],
                            c, scale, i == last[my], hop_outs[my], i == 0)
            for i, my, src, c in hops])
        deltas = [rh.ring_delta(o_, d_) for o_, d_ in zip(outs, ds)]
        sums = [[torch.zeros(t.shape, device=dev) for t in qs]
                for _ in range(3)]
        hop_bwd_ms = _p50_ms(torch, lambda _: [
            rh.ring_hop_bwd(qs[my], ks[src], vs[src], ds[my], lses[my],
                            deltas[my], sums[0][my], sums[1][src],
                            sums[2][src], c, scale)
            for _, my, src, c in hops])
        # K4/K5 per hop alone as the earlier route ran them (the yardstick)
        k4_ms = _p50_ms(torch, lambda _: [
            fa.flash_attention_fwd(qs[my], ks[src], vs[src], causal=c)
            for _, my, src, c in hops])
        k5_ms = _p50_ms(torch, lambda _: [
            fa.flash_attention_bwd(qs[my], ks[src], vs[src], outs[my],
                                   lses[my], ds[my], causal=c)
            for _, my, src, c in hops])
        one_k4_ms = _p50_ms(torch, lambda _: fa.flash_attention_fwd(
            q, k, v, causal=causal))
        one_k5_ms = _p50_ms(torch, lambda _: fa.flash_attention_bwd(
            q, k, v, ref, lse, dout, causal=causal))

        def sdpa(_=None):
            for t in leaves:
                t.grad = None
            return F.scaled_dot_product_attention(*leaves, is_causal=causal)

        sdpa_ms = _p50_ms(torch, sdpa)
        sdpa_bwd_ms = _p50_ms(torch, lambda o: o.backward(dout), sdpa)
        with torch.no_grad():
            plain_ms = _p50_ms(torch, lambda _: ring.ring_attention_sharded(
                q, k, v, mesh, causal=causal))
        bound_ms, bound_by = attention_bound(1, heads, seq, 64, "bfloat16",
                                             causal)
        bwd_bound_ms, bwd_bound_by = attention_bwd_bound(
            1, heads, seq, 64, "bfloat16", causal)["pair"]
        out[label] = dict(
            shape=[1, heads, seq, 64], positions=n, launches=launches,
            routes=routes, max_abs_err=err, out_tol=2 ** -7 * big,
            grad_err_over_largest=grad_err, grad_tol_of_largest=grad_tol,
            one_launch_err_over_largest=one_err,
            ms=fwd_ms, bwd_ms=bwd_ms, hop_fwd_ms=hop_fwd_ms,
            hop_bwd_ms=hop_bwd_ms, k4_ms=k4_ms, k5_ms=k5_ms,
            rest_share_fwd=1 - hop_fwd_ms / fwd_ms,
            rest_share_bwd=1 - hop_bwd_ms / bwd_ms,
            one_k4_ms=one_k4_ms, one_k5_ms=one_k5_ms,
            library_ms=sdpa_ms, library_bwd_ms=sdpa_bwd_ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            bwd_bound_ms=bwd_bound_ms, bwd_bound_by=bwd_bound_by)
        r = out[label]
        say(f"ring {label}: forward {r['ms']:.3f} ms (hop kernels alone "
            f"{r['hop_fwd_ms']:.3f}, rest {r['rest_share_fwd']:.3f}; K4 per "
            f"hop {r['k4_ms']:.3f}), backward {r['bwd_ms']:.3f} ms (hop "
            f"kernels alone {r['hop_bwd_ms']:.3f}, rest "
            f"{r['rest_share_bwd']:.3f}; K5 per hop {r['k5_ms']:.3f}); one "
            f"K4 {r['one_k4_ms']:.3f}, one K5 pair {r['one_k5_ms']:.3f}; "
            f"SDPA {r['library_ms']:.3f} + {r['library_bwd_ms']:.3f}; plain "
            f"ring {r['plain_ms']:.3f}; bound {r['bound_ms']:.3f} + "
            f"{r['bwd_bound_ms']:.3f} ({r['bound_by']}); out err {err:.3g} "
            f"and gradients {json.dumps(grad_err)} of their largest against "
            f"the plain ring, {json.dumps(one_err)} against one launch; "
            f"card: {card}")
        del (o, grads, ref, lse, ref_grads, shards, qs, ks, vs, ds, outs,
             lses, accs, lse_s, hop_outs, deltas, sums)
        gc_collect(torch)
    del q, k, v, dout, leaves
    # one hop at the shard's shape, each kernel alone beside its plain
    # version, SDPA on the same q, k, v (the hop's attention without its
    # merge) and the bound: the kernels line's rows
    out["hop"] = ring_hop_times(torch, rh, F, dev, 1, heads, shard, 64)
    # the forward hop from an empty state at serving shape, beside K4
    b, h, s, d = serve
    gen = torch.Generator(device=dev).manual_seed(22)
    q, k, v, _ = _ring_operands(torch, gen, dev, s, h, torch.bfloat16, d, b)
    lse = torch.empty(b, h, s, device=dev)
    o = torch.empty_like(q)
    out["serve_hop"] = dict(
        shape=list(serve), hop_ms=_p50_ms(torch, lambda _: rh.ring_hop_fwd(
            q, k, v, None, lse, False, d ** -0.5, True, o, True)),
        k4_ms=_p50_ms(torch, lambda _: fa.flash_attention_fwd(q, k, v)))
    del q, k, v, o, lse
    gc_collect(torch)
    # f32 on the FP32 kernels against the same call on the CPU port
    gen = torch.Generator(device=dev).manual_seed(20)
    q, k, v, dout = _ring_operands(torch, gen, dev, small, heads,
                                   torch.float32)
    cpu_mesh = pmesh.make_mesh({"sp": n}, [torch.device("cpu")] * n)
    sides = {}
    for side, m in (("card", mesh), ("cpu", cpu_mesh)):
        ts = [t.detach().to(m.positions("sp")[0]).requires_grad_()
              for t in (q, k, v)]
        o = ring.ring_flash_attention_sharded(*ts, m, causal=True)
        o.backward(dout.to(o.device))
        sides[side] = [o] + [t.grad for t in ts]
    f32_err = {}
    for name, a, b in zip(("out", "dq", "dk", "dv"), sides["card"],
                          sides["cpu"]):
        e, big = _rel_err(a.cpu(), b)
        check(e <= 1e-5 * big, f"ring f32 {name}: card vs CPU {e:.3g} (tol "
              f"1e-5 of {big:.3g})")
        f32_err[name] = e / big
    # bf16 flash ring against the plain ring on the card
    qb, kb, vb = (t.bfloat16() for t in (q, k, v))
    with torch.no_grad():
        flash = ring.ring_flash_attention_sharded(qb, kb, vb, mesh,
                                                  causal=True)
        plain = ring.ring_attention_sharded(qb, kb, vb, mesh, causal=True)
    e, big = _rel_err(flash, plain)
    check(e <= 2 ** -7 * big, f"ring bf16 vs the plain ring {e:.3g} (tol "
          f"2^-7 of {big:.3g})")
    out["f32_vs_cpu"] = dict(shape=[1, heads, small, 64], causal=True,
                             err_over_largest=f32_err, tol=1e-5)
    out["bf16_vs_plain"] = dict(shape=[1, heads, small, 64], causal=True,
                                max_abs_err=e, tol=2 ** -7 * big)
    del q, k, v, dout, sides, qb, kb, vb
    gc_collect(torch)
    # Ulysses against the plain ring
    gen = torch.Generator(device=dev).manual_seed(21)
    q, k, v, _ = _ring_operands(torch, gen, dev, ulysses_seq, heads,
                                torch.bfloat16)
    with torch.no_grad():
        u = ulysses.ulysses_attention_sharded(q, k, v, mesh, causal=True)
        r = ring.ring_attention_sharded(q, k, v, mesh, causal=True)
    e, big = _rel_err(u, r)
    check(e <= 2 ** -7 * big, f"Ulysses vs the plain ring {e:.3g} (tol "
          f"2^-7 of {big:.3g})")
    out["ulysses_vs_plain_ring"] = dict(shape=[1, heads, ulysses_seq, 64],
                                        causal=True, max_abs_err=e,
                                        tol=2 ** -7 * big)
    del q, k, v, u, r
    gc_collect(torch)
    out["seconds"] = time.perf_counter() - t_phase
    say(f"ring: {json.dumps(out)}")
    return out


def _hops_flat(ring, n, causal):
    """The ring's live hops in order: ``(round, position, block owner,
    causal)``."""
    return [(i, my, src, c) for i, live in enumerate(ring._hops(n, causal))
            for my, src, c in live]


def ring_hop_times(torch, rh, F, dev, b, h, s, d):
    """One non-causal middle hop at (b, h, s, d) bf16, each kernel alone
    (p50 of host-issued runs, CUDA events) beside its plain version, SDPA's
    forward (backward) over the same q, k, v and the hop's bound."""
    gen = torch.Generator(device=dev).manual_seed(23)
    q, k, v, do = _ring_operands(torch, gen, dev, s, h, torch.bfloat16, d, b)
    scale = d ** -0.5
    acc = torch.zeros(b, h, s, d, device=dev)
    lse = torch.zeros(b, h, s, device=dev)
    delta = torch.zeros(b, h, s, device=dev)
    gs = [torch.zeros(b, h, s, d, device=dev) for _ in range(3)]
    times = {}
    for side, fwd, bwd in (("ms", rh.ring_hop_fwd, rh.ring_hop_bwd),
                           ("plain_ms", rh.ring_hop_fwd_reference,
                            rh.ring_hop_bwd_reference)):
        times[f"fwd_{side}"] = _p50_ms(torch, lambda _: fwd(
            q, k, v, acc, lse, False, scale, False))
        times[f"bwd_{side}"] = _p50_ms(torch, lambda _: bwd(
            q, k, v, do, lse, delta, *gs, False, scale))
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    times["fwd_library_ms"] = _p50_ms(
        torch, lambda _: F.scaled_dot_product_attention(*leaves))
    times["bwd_library_ms"] = _p50_ms(
        torch, lambda o: o.backward(do),
        lambda: F.scaled_dot_product_attention(*leaves))
    for way, backward in (("fwd", False), ("bwd", True)):
        times[f"{way}_bound_ms"], times[f"{way}_bound_by"] = ring_hop_bound(
            b, h, s, d, False, backward)
    del q, k, v, do, acc, lse, delta, gs, leaves
    gc_collect(torch)
    return dict(shape=[b, h, s, d], causal=False, **times)


# -- the vision zoo (phase 20) ------------------------------------------------

MNV2_BATCH = 256
ZOO_BATCH = 32
#: the zoo's other families trained a step each: name, input size, and the
#: BatchNorm blocks the net holds (the JAX package's nets hold as many: the
#: CPU tests hold every collect_params() name equal)
ZOO_FAMILIES = (("densenet121", 224, 121), ("inception_v3", 299, 94),
                ("vgg16_bn", 224, 13), ("mobilenet1_0", 224, 27),
                ("squeezenet1_1", 224, 0), ("alexnet", 224, 0))


def mobilenet_v2_bn_sites(torch, vision, dev, batch):
    """``[(NCHW shape, sites)]``: the input shape of each of
    MobileNetV2-1.0's 53 BatchNorm blocks at 224x224 (:func:`bn_sites_of`,
    held to the study tool's list)."""
    from mxnet_tpu_torch.tools import bn_regime_study

    return bn_sites_of(torch, vision.mobilenet_v2_1_0(classes=1000), dev,
                       batch, 224,
                       bn_regime_study.mobilenet_v2_bn_sites(batch),
                       "MobileNetV2")


def resnet18_cifar_bn_sites(torch, vision, dev, batch):
    """``[(NCHW shape, sites)]`` of ResNet-18's 20 BatchNorm blocks on
    CIFAR's 32x32 (:func:`bn_sites_of`, held to the study tool's list)."""
    from mxnet_tpu_torch.tools import bn_regime_study

    return bn_sites_of(torch, vision.resnet18_v1(classes=10), dev, batch, 32,
                       [((batch,) + s[1:], k)
                        for s, k in bn_regime_study.RESNET18_CIFAR_SITES],
                       "ResNet-18")


def bn_sites_of(torch, net, dev, batch, image, want, label):
    """``[(NCHW shape, sites)]``: the input shape of each BatchNorm block of
    ``net`` at ``image`` x ``image``, read by forward pre-hooks from a
    predict-mode forward of one image on the card, at ``batch``; in the
    order of their first site. They must be ``want``'s (the lists the
    study tool and the CPU tests hold by hand), in any order."""
    from mxnet_tpu_torch.gluon.nn import BatchNorm

    net.initialize(device=dev)
    shapes = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: shapes.append((batch,) + tuple(args[0].shape[1:])))
        for m in net.modules() if isinstance(m, BatchNorm)]
    with torch.no_grad():
        net(torch.zeros(1, 3, image, image, device=dev))
    for h in hooks:
        h.remove()
    counts = {}
    for shape in shapes:
        counts[shape] = counts.get(shape, 0) + 1
    check(counts == dict(want), f"{label}'s BN sites {counts} are not the "
                                f"study tool's {dict(want)}")
    return list(counts.items())


def phase_kernels_bn_nchw(torch, knorm, dispatch, sites,
                          model="mobilenet_v2", batch=MNV2_BATCH):
    """K1 and K2 against their plain versions at every BatchNorm shape of
    ``model`` (MobileNetV2-1.0 at batch 256; ResNet-18 on CIFAR, phase 21),
    bf16 NCHW (the plane regimes: resident where a channel fits a cluster's
    shared memory, else planes; a 1x1 site's channels are innermost, so it
    takes the vector path), with non-zero cotangents of the statistics and
    a second launch bit for bit (phase 3's checks); each site's row names
    K1's and K2's regime, chunks (resident: the cluster's CTAs), CUDA
    launches a call (counted in a captured graph of one call, the kernels
    by name) and design bytes;
    each shape timed as phase 3 times ResNet-50's sites
    (:func:`bn_site_times`), cuDNN's ``F.batch_norm`` on the same NCHW
    tensor, summed over the sites."""
    import torch.nn.functional as F

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(78)
    rows = []
    for shape, n in sites:
        label = "{}_{}x{}x{}".format(model, *shape[1:])
        row, ops = bn_case(torch, knorm, gen, dev, label, shape, 1,
                           torch.bfloat16, "f32", True, 0)
        row["sites"] = n
        row.update(bn_site_times(torch, F, knorm, dispatch, *ops, 1))
        row["design_bytes"] = {
            side: row[f"{side}_design_ms"] * HBM_BYTES_PER_S / 1e3
            for side in ("fwd", "bwd")}
        say("kernel_case_bn_nchw " + json.dumps(row))
        rows.append(row)
        del ops
        torch.cuda.empty_cache()
    elements = sum(math.prod(r["shape"]) * r["sites"] for r in rows)
    total = {key: sum(r[key] * r["sites"] for r in rows) for key in (
        "fwd_ms", "bwd_ms", "fwd_ms_l2_warm", "bwd_ms_l2_warm",
        "fwd_ms_host_issued", "bwd_ms_host_issued", "copy_ms",
        "plain_fwd_ms", "plain_bwd_ms", "library_fwd_ms", "library_bwd_ms",
        "library_fwd_ms_host_issued", "library_bwd_ms_host_issued",
        "fwd_bound_ms", "bwd_bound_ms", "fwd_design_ms", "bwd_design_ms")}
    n_sites = sum(r["sites"] for r in rows)
    summary = {
        f"{model}_batch{batch}_{n_sites}_sites": total}
    summary.update(
        elements_per_image=elements / batch,
        input_gb=2 * elements / 1e9,
        fwd_max_abs_err=max(r["out_max_abs_err"] for r in rows),
        bwd_max_abs_err=max(r["dx_max_abs_err"] for r in rows),
        stats_max_rel_err=max(r["stats_max_rel_err"] for r in rows),
        distinct_shapes=len(rows),
        # from the kernels each site's captured call launched (bn_case holds
        # them equal to its regime's own)
        sites_by_regime={side: {reg: sum(r["sites"] for r in rows
                                          if r["regime"][side] == reg)
                                for reg in ("vector", "planes", "resident")}
                         for side in ("fwd", "bwd")},
        cuda_launches_per_step={side: sum(
            r["sites"] * r["cuda_launches"][side] for r in rows)
            for side in ("fwd", "bwd")},
        card=card_line())
    say("bn_kernels_nchw " + json.dumps(summary))
    return summary


def _zoo_metrics(mt, net, trainer, step, n=2):
    """After the timed window: ``n`` more phased steps on the step's batch,
    each step's logits into ``metric.Accuracy`` and
    ``metric.TopKAccuracy(5)``."""
    x, y = step.args
    acc, top5 = mt.gluon.metric.Accuracy(), mt.gluon.metric.TopKAccuracy(5)
    lf = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    for _ in range(n):
        with mt.autograd.record():
            out = net(x)
            loss = lf(out.float(), y)
        mt.autograd.backward(loss)
        trainer.step(x.shape[0])
        acc.update(y, out.detach())
        top5.update(y, out.detach())
    return dict(metrics_after_steps=n, accuracy=acc.get()[1],
                top5_accuracy=top5.get()[1])


#: the families start as their Gluon training recipes start them, from
#: Xavier(magnitude 2) weights and at lr 0.01: the default Uniform(0.07)
#: gives AlexNet's and VGG's 4096-wide dense layers logits in the hundreds,
#: and one step of SGD momentum from there diverges
ZOO_LR = 0.01


def phase_zoo_families(torch, mt, train_resnet, vision, build, kopt):
    """Each other family at full width from Xavier(magnitude 2) weights,
    one warm-up step (the deferred shapes, cuDNN's choices) and one
    counted step through the phased path (bf16 weights, f32 masters,
    batch 32, SGD momentum 0.9 at lr 0.01): the counts zeroed just before
    and read just after: K1 = K2 = the net's BatchNorm blocks (counted by
    walking it), K3 once a bucket; both losses finite; step ms and the
    family's own peak memory (above what earlier phases still hold)."""
    rows = []
    for name, image, n_bn in ZOO_FAMILIES:
        gc_collect(torch)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        net, trainer, step = train_resnet.build_resnet_train(
            batch=ZOO_BATCH, layout="NCHW", stem_s2d=False, device=mt.gpu(0),
            seed=0, image=image, learning_rate=ZOO_LR,
            init=mt.initializer.Xavier(magnitude=2),
            model=vision.get_model(name, classes=1000))
        walked = sum(isinstance(m, mt.gluon.nn.BatchNorm)
                     for m in net.modules())
        check(walked == n_bn, f"{name}: {walked} BatchNorm blocks, want "
                              f"{n_bn}")
        first = step().float().mean().item()
        build.reset_counters()
        losses, secs = _run_steps(torch, step, 1)
        launches = {c.name: c.value for c in build.COUNTERS.values()
                    if c.value}
        plan = opt_plan(kopt, trainer)
        want = {"opt_ladder": plan["launches"]}
        if n_bn:
            want.update(bn_train_fwd=n_bn, bn_train_bwd=n_bn)
        check(launches == want, f"{name}: launches {launches}, want {want}")
        check(all(math.isfinite(v) for v in [first] + losses),
              f"{name}: non-finite loss {first}, {losses}")
        row = dict(model=name, image=image, batch=ZOO_BATCH, lr=ZOO_LR,
                   bn_blocks=walked, first_loss=first, loss=losses[0],
                   step_ms=1e3 * secs[0],
                   launches=launches, opt_plan=plan,
                   peak_gib=(torch.cuda.max_memory_allocated() - base)
                   / 2 ** 30, held_before_gib=base / 2 ** 30,
                   peak_reserved_gib=torch.cuda.max_memory_reserved()
                   / 2 ** 30)
        say("zoo_family " + json.dumps(row))
        rows.append(row)
        del net, trainer, step
    return rows


#: the batch of MobileNetV2's f32 steps against the plain versions (three
#: nets at once)
MNV2_PLAIN_BATCH = 64


def phase_vision_zoo(torch, mt, build, dispatch, kopt, knorm, topt, fa,
                     mods):
    """20. The vision zoo: K1/K2 at MobileNetV2's 53 NCHW bf16 sites,
    MobileNetV2-1.0 trained at batch 256 phased and through TrainStep's
    graph (phase 13's method, with its metrics, then K3 over its trainer's
    parameters against the plain ladder, phase 10's sweep), whole f32
    steps of it with K1, K2 and K3 against their plain versions from one
    state (phase 10's method), and each other family a step."""
    from mxnet_tpu_torch.gluon.model_zoo import vision

    t0 = time.perf_counter()
    sites = mobilenet_v2_bn_sites(torch, vision, mt.gpu(0), MNV2_BATCH)
    bn = phase_kernels_bn_nchw(torch, knorm, dispatch, sites)
    seconds = {"bn_sites": time.perf_counter() - t0}

    def after(net, trainer, step):
        return dict(_zoo_metrics(mt, net, trainer, step),
                    opt_sweep=phase_opt_sweep(torch, kopt, topt, dispatch,
                                              trainer, "mobilenet_v2"))

    run = phase_train_step(torch, mt, build, dispatch, kopt, fa, mods,
                           "mobilenet_v2", after=after)
    check(run["opt_plan"]["launches"] == 2,
          f"MobileNetV2: {run['opt_plan']['launches']} K3 buckets, want 2")
    seconds["train_step"] = time.perf_counter() - t0 - sum(seconds.values())
    run["kernels_vs_plain"] = kernels_vs_plain(
        torch, build, knorm, kopt, lambda: mods[1].build_resnet_train(
            batch=MNV2_PLAIN_BATCH, dtype="float32", layout="NCHW",
            stem_s2d=False, device=mt.gpu(0), seed=0,
            learning_rate=RESNET_LR,
            model=vision.mobilenet_v2_1_0(classes=1000)),
        "mobilenet_v2", MNV2_PLAIN_BATCH, RESNET_LR)
    seconds["vs_plain"] = time.perf_counter() - t0 - sum(seconds.values())
    families = phase_zoo_families(torch, mt, mods[1], vision, build, kopt)
    seconds["families"] = time.perf_counter() - t0 - sum(seconds.values())
    prof = {p["path"]: p for p in run["profile"]}
    summary = dict(
        model="mobilenet_v2_1_0 (NCHW)", batch=MNV2_BATCH,
        dtype="bfloat16+f32 masters",
        step_ms_p50={k: v["host_ms_per_step_p50"] for k, v in prof.items()},
        samples_per_s={k: MNV2_BATCH / v["host_ms_per_step_p50"] * 1e3
                       for k, v in prof.items()},
        issue_ms_p50={k: v["issue_ms_per_step_p50"] for k, v in prof.items()},
        idle_share={k: v["device_idle_share"] for k, v in prof.items()},
        peak_gib=run["peak_memory_gib"],
        peak_reserved_gib=run["peak_reserved_gib"],
        launches=run["launches"], accuracy=run["accuracy"],
        top5_accuracy=run["top5_accuracy"], families=families,
        phase_s=time.perf_counter() - t0, seconds=seconds, card=card_line())
    say("vision_zoo " + json.dumps(summary))
    return dict(summary, bn=bn, train_step=run)


# -- phase 21 --------------------------------------------------------------

DATA_BATCH = 64        # the examples' batch
DATA_BIG_BATCH = 256   # (e) at the batch of the other training phases
RESNET18_BN = 20       # BatchNorm layers of resnet18_v1


def _data_profile(torch, run, want_side=False):
    """One epoch of ``run()`` under ``torch.profiler``: the device's idle
    share of the window (1 - the union of kernel and copy intervals over
    the window's wall time) and where the host-to-device copies ran. A
    window without device events, or with ``want_side`` without a copy on
    a stream that runs no kernel, is taken again, twice at most (late in
    the whole smoke the profiler drops events, §7 of PERF.md); then the
    last window's numbers stand, or None without device events."""
    from torch.profiler import ProfilerActivity, profile

    from mxnet_tpu_torch.tools.profile_training import _busy_us

    cuda = torch.autograd.DeviceType.CUDA
    for _ in range(3):
        TIMING["profiler_windows"] += 1
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stats = run()
            torch.cuda.synchronize()
            window_us = (time.perf_counter() - t0) * 1e6
        dev = [e for e in prof.events() if e.device_type == cuda]
        if not dev:
            TIMING["empty_windows"] += 1
            say("data: the profiler recorded no device activity")
            continue
        h2d = [e for e in dev if "HtoD" in e.name]
        compute = {e.device_resource_id for e in dev
                   if not e.name.startswith(("Memcpy", "Memset"))}
        busy = _busy_us([(e.time_range.start, e.time_range.end)
                         for e in dev])
        out = dict(idle_share=1.0 - busy / window_us,
                   window_ms=window_us / 1e3, steps=stats["steps"],
                   h2d_copies=len(h2d),
                   h2d_off_compute_stream=sum(
                       e.device_resource_id not in compute for e in h2d),
                   compute_streams=sorted(compute),
                   h2d_streams=sorted({e.device_resource_id for e in h2d}))
        if out["h2d_off_compute_stream"] or not want_side:
            return out
        say(f"data: the profiler saw {len(h2d)} host-to-device copies, "
            "none off the compute streams")
    if not dev:
        return dict(idle_share=None, h2d_copies=None,
                    h2d_off_compute_stream=None, steps=stats["steps"])
    return out


def data_run(torch, mt, build, dispatch, kopt, tools, label, make, prep,
             epochs, train_step=False, want_prefetch=False):
    """Build a training run with ``make()`` (net, trainer, loader, loss,
    metric), train ``epochs`` epochs with the launch counters from 0 and
    then one profiled epoch, close the loader, and check the launches (K1
    and K2 once a BatchNorm layer a step, K3 once a bucket a step, every
    dispatch decision the kernel's), ``data_prefetch_total`` and that no
    worker process is left."""
    import multiprocessing as mp

    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.telemetry import instruments as inst

    train_mnist = tools[0]
    dev = mt.gpu(0)
    net, trainer, loader, lossfn, metric = make()
    bn_layers = sum(isinstance(m, mt.gluon.nn.BatchNorm)
                    for m in net.modules())
    try:
        telemetry.reset()
        build.reset_counters()
        dispatch.reset_counts()
        stats = train_mnist.run_epochs(
            net, trainer, loader, lossfn, metric, epochs, prep, dev,
            train_step=train_step, keep_batches=True, log=say)
        torch.cuda.synchronize()
        launches = {c.name: c.value for c in build.COUNTERS.values()}
        outcomes = {f"{k}:{o}": n for (k, o), n in dispatch.COUNTS.items()}
        prefetched = inst.data_prefetch_total.value
        plan = opt_plan(kopt, trainer)
        prof = _data_profile(torch, lambda: train_mnist.run_epochs(
            net, trainer, loader, lossfn, metric, 1, prep, dev,
            train_step=train_step, seed=epochs, log=lambda *_: None),
            want_prefetch)
        start = (loader._mp_pool._ctx.get_start_method()
                 if loader._mp_pool is not None else None)
    finally:
        loader.close()
    alive = [p.pid for p in mp.active_children()]
    for pid in stats["pids"]:
        try:
            os.kill(pid, 0)
            alive.append(pid)
        except ProcessLookupError:
            pass
    check(not alive, f"data {label}: worker processes left alive: {alive}")
    n = stats["steps"]
    check(n > 0 and all(math.isfinite(v) for v in stats["losses"]),
          f"data {label}: {n} steps, losses {stats['losses'][:4]}")
    want = dict(opt_ladder=plan["launches"] * n)
    if bn_layers:
        want.update(bn_train_fwd=bn_layers * n, bn_train_bwd=bn_layers * n)
    got = {k: launches.get(k, 0) for k in want}
    check(got == want, f"data {label}: launches {got}, want {want} "
                       f"({bn_layers} BatchNorm layers, {plan['launches']} "
                       f"K3 buckets, {n} steps)")
    check(outcomes and all(k.endswith(":kernel") for k in outcomes),
          f"data {label}: dispatch outcomes {outcomes}")
    check(prefetched == (n if want_prefetch else 0),
          f"data {label}: data_prefetch_total {prefetched} for {n} batches")
    if want_prefetch:
        # the loader's own record: each batch's copies went on a stream
        # other than the one that consumed it
        pairs = loader.prefetch_streams
        check(pairs and all(a != b for a, b in pairs),
              f"data {label}: prefetch copy and consumer streams {pairs}")
        # and the profiler's, where its windows caught them (it drops
        # events late in the whole smoke: then the count is printed and
        # the loader's record stands alone)
        if not prof["h2d_off_compute_stream"]:
            say(f"data {label}: the profiler caught no batch copy: "
                f"{prof}")
    row = dict(
        run=label, steps=n, batch=loader._batch_sampler._batch_size,
        samples_per_s=stats["samples_per_s"],
        samples_per_s_with_first=stats["samples_per_s_with_first"],
        step_ms_p50=train_mnist.p50(stats["step_ms"]),
        host_ms_p50=train_mnist.p50(stats["host_ms"]),
        wait_ms_p50=train_mnist.p50(stats["wait_ms"]),
        wait_ms_mean=sum(stats["wait_ms"]) / n,
        wait_ms_first=stats["wait_ms"][0],
        first_loss=stats["losses"][0], last_loss=stats["losses"][-1],
        metric=stats["metric"], launches=got, outcomes=outcomes,
        data_prefetch_total=prefetched, mp_start=start,
        worker_pids=len(stats["pids"]),
        prefetch_streams=sorted(loader.prefetch_streams),
        profile=prof, card=card_line())
    say("data_run " + json.dumps(row))
    return row, stats


def phase_data(torch, mt, build, dispatch, kopt, knorm):
    """21. The input pipeline: tools/train_mnist.py (LeNet, 2 epochs of the
    synthetic MNIST at batch 64, in the caller) and
    tools/train_cifar_resnet.py --bf16 (ResNet-18 at full width, one epoch
    of the synthetic CIFAR-10 at batch 64) in each loader mode from the
    same np.random.seed and the same initial weights: (a) in the caller,
    (b) 4 fork workers (forked after CUDA is initialised), (c) a thread
    pool, (d) device_prefetch=2 with pin_memory, (e) (d) through
    TrainStep's graph at batch 64 and 256. (a)-(d) must deliver the same
    batches in the same order and agree on the losses; each run its
    launches, ``data_prefetch_total``, no worker left and, with
    prefetch, its copies off the compute stream (:func:`data_run`). Then
    K1 and K2 at ResNet-18's 20 CIFAR sites at batch 64 against their
    plain versions, bound and cuDNN (:func:`phase_kernels_bn_nchw`).
    cuDNN runs deterministic here, so the modes' losses can be held
    close."""
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.tools import train_cifar_resnet, train_mnist

    t0 = time.perf_counter()
    tools = (train_mnist, train_cifar_resnet)
    dev = mt.gpu(0)
    cudnn = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    runs = {}
    try:
        runs["mnist"], _ = data_run(
            torch, mt, build, dispatch, kopt, tools, "mnist_lenet",
            lambda: train_mnist.build_mnist_train(device=dev),
            train_mnist.mnist_prep, 2)
        check(runs["mnist"]["steps"] == 32, "MNIST: 2 epochs of 16 steps")
        modes = {
            "a_caller": dict(num_workers=0),
            "b_fork_workers": dict(num_workers=4),
            "c_thread_pool": dict(num_workers=4, thread_pool=True),
            "d_device_prefetch": dict(device_prefetch=2, pin_memory=True),
        }
        prep = train_cifar_resnet.cifar_prep("bfloat16")
        stats = {}
        for mode, kw in modes.items():
            runs[mode], stats[mode] = data_run(
                torch, mt, build, dispatch, kopt, tools, mode,
                lambda kw=kw: train_cifar_resnet.build_cifar_train(
                    DATA_BATCH, bf16=True, device=dev,
                    loader_kw=dict(kw, timeout=60)),
                prep, 1, want_prefetch="device_prefetch" in kw)
        check(runs["b_fork_workers"]["mp_start"] == "fork",
              f"(b) started its workers by "
              f"{runs['b_fork_workers']['mp_start']}: "
              f"{[t.name for t in threading.enumerate()]}")
        base = stats["a_caller"]
        for mode in modes:
            check(stats[mode]["batch_digests"] == base["batch_digests"],
                  f"data {mode}: its batches differ from (a)'s or come in "
                  "another order")
            err = max(abs(a - b) / max(abs(b), 1e-6) for a, b in zip(
                stats[mode]["losses"], base["losses"]))
            runs[mode]["loss_max_rel_err_vs_a"] = err
            check(len(stats[mode]["losses"]) == len(base["losses"])
                  and err <= 1e-4,
                  f"data {mode}: losses {err:.3g} relative from (a)'s "
                  "(tol 1e-4, phase 8's)")
        for batch, epochs in ((DATA_BATCH, 1), (DATA_BIG_BATCH, 2)):
            label = f"e_train_step_batch{batch}"
            runs[label], _ = data_run(
                torch, mt, build, dispatch, kopt, tools, label,
                lambda batch=batch: train_cifar_resnet.build_cifar_train(
                    batch, bf16=True, device=dev,
                    loader_kw=dict(device_prefetch=2, pin_memory=True,
                                   timeout=60)),
                prep, epochs, train_step=True, want_prefetch=True)
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = cudnn
    seconds = {"runs": time.perf_counter() - t0}
    sites = resnet18_cifar_bn_sites(torch, vision, dev, DATA_BATCH)
    bn = phase_kernels_bn_nchw(torch, knorm, dispatch, sites,
                               "resnet18_cifar", DATA_BATCH)
    seconds["bn_sites"] = time.perf_counter() - t0 - seconds["runs"]
    summary = dict(
        runs={k: {key: v[key] for key in (
            "samples_per_s", "step_ms_p50", "wait_ms_p50", "wait_ms_mean",
            "steps", "batch")} | {"idle_share": v["profile"]["idle_share"]}
            for k, v in runs.items()},
        bn_sites=bn[f"resnet18_cifar_batch{DATA_BATCH}_{RESNET18_BN}_sites"],
        phase_s=time.perf_counter() - t0, seconds=seconds, card=card_line())
    say("data " + json.dumps(summary))
    return dict(summary, runs=runs, bn=bn)


# -- the operator corpus on the card (phase 22) ------------------------------

REG_BATCH = 64                     # 22a: ResNet-50 v1 in the legacy ops
REG_STEPS = 3


def legacy_resnet50(nd, net, W, x, y):
    """ResNet-50 v1 written in the legacy op vocabulary (``nd.Convolution``,
    ``nd.BatchNorm(fix_gamma=False)``, ``nd.Activation``, ``nd.Pooling``,
    ``nd.Flatten``, ``nd.FullyConnected``, ``nd.SoftmaxOutput``) over the
    NDArrays ``W[parameter]``, the architecture and hyperparameters read
    off the Gluon ``resnet50_v1`` ``net``: the 7x7/2 stem, BatchNorm,
    ReLU, the 3x3/2 max pool, 16 bottlenecks, the global average pool and
    the dense head. Returns the class probabilities."""
    def conv(c, h):
        return nd.Convolution(h, W[c.weight], kernel=c._kernel,
                              stride=c._strides, pad=c._padding,
                              num_filter=c._channels, no_bias=True)

    def bn(b, h):
        return nd.BatchNorm(h, W[b.gamma], W[b.beta], W[b.running_mean],
                            W[b.running_var], eps=1e-5, momentum=0.9,
                            fix_gamma=False)

    def relu(h):
        return nd.Activation(h, act_type="relu")

    f = net.features
    h = relu(bn(f[1], conv(f[0], x)))
    h = nd.Pooling(h, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                   pool_type="max")
    for stage in list(f)[4:8]:
        for blk in stage:
            b = blk.body
            r = relu(bn(b[1], conv(b[0], h)))
            r = relu(bn(b[4], conv(b[3], r)))
            r = bn(b[7], conv(b[6], r))
            short = h if blk.downsample is None else bn(
                blk.downsample[1], conv(blk.downsample[0], h))
            h = relu(r + short)
    h = nd.Flatten(nd.Pooling(h, kernel=(1, 1), global_pool=True,
                              pool_type="avg"))
    return nd.SoftmaxOutput(nd.FullyConnected(
        h, W[net.output.weight], W[net.output.bias], num_hidden=1000), y)


def _max_rel(pairs):
    """The largest ``max |a - b| / max |b|`` over ``(a, b)`` tensor pairs."""
    return max(((a.float() - b.float()).abs().max()
                / b.float().abs().max().clamp_min(1e-30)).item()
               for a, b in pairs)


def phase_registry_resnet(torch, mt, build, vision):
    """22a: ResNet-50 v1 in the legacy vocabulary at full width (NCHW, f32,
    batch 64 of 224x224, 1000 classes) from the weights of the Gluon
    ``resnet50_v1`` after ``initialize``, three steps under
    ``autograd.record()`` -> ``backward()`` -> ``nd.sgd_mom_update(w, g,
    mom, lr=0.1, momentum=0.9, wd=1e-4, out=w)`` for every weight, the
    counts zeroed just before and read just after (K1 = K2 = 53 a step).

    Held against the Gluon net on the same weights and batch: the first
    step's loss and gradients against its forward and the summed backward
    of ``SoftmaxCrossEntropyLoss``, the weights after the first update
    against one ``Trainer('sgd', momentum 0.9, wd 1e-4, rescale_grad 1)``
    step. Tolerance: cuDNN chooses its algorithms per call, and the weight
    gradients of some sum in an order that changes between calls, so the
    same Gluon step run twice from one state may differ; each gradient
    may differ by 8 times that (the noise floor measured here, per tensor
    relative to its largest value) plus 1e-3 of its largest value: the
    heads round apart (softmax minus one-hot in SoftmaxOutput, log-softmax's
    backward in the loss) and 53 BatchNorms carry that last-bit difference
    to 7.6e-5 of the largest gradient (measured on an H100). A weight may
    differ by lr times its gradient's tolerance, a moving statistic by
    1e-4 of the largest, the loss by 1e-5 relative."""
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    mt.random.seed(0)
    net = vision.resnet50_v1(classes=1000)
    net.initialize(device=dev)
    params = list(net.collect_params().values())
    gen = torch.Generator(device=dev).manual_seed(22)
    x = torch.randn(REG_BATCH, 3, 224, 224, device=dev, generator=gen)
    y = torch.randint(0, 1000, (REG_BATCH,), device=dev, generator=gen)
    net(x[:1])        # predict mode: the deferred shapes, no statistics
    W = {p: mt.np.array(p.data()._data.detach()) for p in params}
    trained = [p for p in params if p.grad_req != "null"]
    check(len(trained) == 161, f"{len(trained)} trained weights")
    moms = {p: mt.np.zeros(p.shape) for p in trained}
    for p in trained:
        W[p].attach_grad()
    data, label = mt.np.array(x), mt.np.array(y.float())

    # the Gluon reference, twice from the same state for cuDNN's noise
    # floor (the running statistics put back between: they are K1's
    # shift), then one update
    lossf = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    running = [p for p in params if p.grad_req == "null"]
    start = [p.data()._data.clone() for p in running]
    ref = []
    for _ in range(2):
        for p, t in zip(running, start):
            p.set_data(t)
        with mt.autograd.record():
            loss = lossf(net(x), y)
        mt.autograd.backward(loss)        # ones: the per-sample losses summed
        ref.append((loss.detach().mean().item(),
                    [p.grad().clone() for p in trained]))
    trainer = mt.gluon.Trainer(net.collect_params(), "sgd", dict(
        learning_rate=0.1, momentum=0.9, wd=1e-4, rescale_grad=1.0))
    trainer.step(1)
    noise = [_max_rel([(a, b)]) for a, b in zip(ref[0][1], ref[1][1])]

    build.reset_counters()
    times, first = [], None
    for step in range(REG_STEPS):
        torch.cuda.synchronize()
        start = time.perf_counter()
        with mt.autograd.record():
            prob = legacy_resnet50(mt.nd, net, W, data, label)
        prob.backward()
        if step == 0:
            grads = [W[p].grad._data.clone() for p in trained]
        for p in trained:
            mt.nd.sgd_mom_update(W[p], W[p].grad, moms[p], lr=0.1,
                                 momentum=0.9, wd=1e-4, out=W[p])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
        if step == 0:
            p_y = prob._data.gather(1, y[:, None]).squeeze(1)
            first = dict(loss=(-p_y.log().mean()).item(), grads=grads,
                         weights=[W[p]._data.clone() for p in trained],
                         running=[W[p]._data.clone() for p in running])
    counts = {c.name: c.value for c in build.COUNTERS.values()}
    arrays = [prob, *W.values(), *moms.values()]
    check(all(a._data.device == dev for a in arrays)
          and all(W[p].grad._data.device == dev for p in trained),
          "22a: a result off cuda:0")
    check(all(bool(torch.isfinite(a._data).all()) for a in arrays),
          "22a: non-finite values")
    for name in ("bn_train_fwd", "bn_train_bwd"):
        check(counts.get(name, 0) == 53 * REG_STEPS,
              f"22a: {name} launched {counts.get(name, 0)} times in "
              f"{REG_STEPS} steps, not {53 * REG_STEPS}")
    grad_err = [_max_rel([(g, r)]) for g, r in zip(first["grads"],
                                                    ref[0][1])]
    # each tensor within 8x its own run-to-run noise (cuDNN's per-call
    # algorithms) plus 1e-4 of its largest value
    grad_tol = [8 * n + 1e-4 for n in noise]
    grad_ok = [e <= t for e, t in zip(grad_err, grad_tol)]
    check(all(grad_ok), "22a: gradients against the Gluon step: worst "
                        f"{max(grad_err):.3g} (noise {max(noise):.3g})")
    loss_err = abs(first["loss"] - ref[0][0]) / abs(ref[0][0])
    check(loss_err <= 1e-5, f"22a: loss {first['loss']} against Gluon's "
                            f"{ref[0][0]}")
    w_err = [((w - p.data()._data).abs().max()
              / p.data()._data.abs().max()).item()
             for w, p in zip(first["weights"], trained)]
    # an update moves a weight by lr * (its gradient's difference) at most
    w_tol = [0.1 * t * r.abs().max().item()
             / p.data()._data.abs().max().item() + 1e-6
             for t, r, p in zip(grad_tol, ref[0][1], trained)]
    check(all(e <= t for e, t in zip(w_err, w_tol)),
          f"22a: weights after the update against the Trainer's: worst "
          f"{max(w_err):.3g}")
    run_err = _max_rel([(a, p.data()._data)
                        for a, p in zip(first["running"], running)])
    check(run_err <= 1e-4, f"22a: moving statistics against the Gluon "
                           f"step's: {run_err:.3g} of the largest")
    p50 = sorted(times)[len(times) // 2]
    out = dict(batch=REG_BATCH, steps=REG_STEPS, step_ms=times,
               step_ms_p50=p50, samples_per_s=REG_BATCH / p50 * 1e3,
               loss=first["loss"], gluon_loss=ref[0][0],
               grad_max_rel_err=max(grad_err),
               gluon_noise_max_rel=max(noise),
               weight_max_rel_err=max(w_err),
               running_stats_max_rel_err=run_err,
               launches={k: v for k, v in counts.items() if v},
               seconds=time.perf_counter() - t0, card=card_line())
    say("registry_resnet50 " + json.dumps(out))
    del W, moms, net, trainer
    gc_collect(torch)
    return out


REG_ATTN = (8, 12, 384, 64)       # 22b: BERT-base's attention


def phase_registry_attention(torch, mt, build, fa):
    """22b: ``npx.flash_attention`` and ``nd.flash_attention`` at BERT-base's
    shape in bf16, non-causal and causal, dropout 0.1 with a seed, forward
    and backward on NDArrays inside ``record()``: one launch of K4, K5a
    and K5b a call (the counts zeroed just before each call and read just
    after); out and dq, dk, dv bit for bit those of
    ``ops/flash_attention.flash_attention`` called directly with the same
    seed, and within the kernels' tolerances of the plain versions (out
    3e-2, the gradients 2^-7 of their largest: bf16 rounds P, dS and the
    outputs at other points)."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(2222)
    q, k, v, dout = (torch.randn(*REG_ATTN, device=dev, generator=gen)
                     .to(torch.bfloat16) for _ in range(4))
    kernels = ("flash_attention_fwd_mma", "flash_attention_bwd_dq_mma",
               "flash_attention_bwd_dkv_mma")
    rows, totals = [], dict.fromkeys(kernels, 0)
    for causal in (False, True):
        kw = dict(causal=causal, dropout_p=0.1, dropout_seed=7)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        want = fa.flash_attention(*leaves, **kw)
        want_g = torch.autograd.grad(want, leaves, dout)
        ref, lse = fa.flash_attention_reference(q, k, v, causal=causal,
                                                dropout_p=0.1,
                                                dropout_seed=7)
        ref_g = fa.flash_attention_bwd_reference(q, k, v, ref, lse, dout,
                                                 causal=causal,
                                                 dropout_p=0.1,
                                                 dropout_seed=7)
        big = max(g.float().abs().max().item() for g in ref_g)
        for ns in ("npx", "nd"):
            xs = [mt.np.array(t) for t in (q, k, v)]
            for a in xs:
                a.attach_grad()
            build.reset_counters()
            with mt.autograd.record():
                out = getattr(mt, ns).flash_attention(*xs, **kw)
            out.backward(mt.np.array(dout))
            torch.cuda.synchronize()
            counts = {c.name: c.value for c in build.COUNTERS.values()}
            label = f"{ns} causal={causal}"
            check([counts.get(n, 0) for n in kernels] == [1, 1, 1],
                  f"22b {label}: launches {counts}")
            for n in kernels:
                totals[n] += counts[n]
            check(out._data.device == dev and all(
                a.grad._data.device == dev for a in xs), f"22b {label}: "
                                                          "off cuda:0")
            check(torch.equal(out._data, want.detach()) and all(
                torch.equal(a.grad._data, g) for a, g in zip(xs, want_g)),
                f"22b {label}: not bit for bit the direct call's")
            err = (out._data.float() - ref.float()).abs().max().item()
            gerr = max((a.grad._data.float() - g.float()).abs().max().item()
                       for a, g in zip(xs, ref_g))
            check(err <= 3e-2 and gerr <= 2.0 ** -7 * big,
                  f"22b {label}: against the plain versions out {err:.3g}, "
                  f"grads {gerr:.3g} (tol {2.0 ** -7 * big:.3g})")
            rows.append(dict(call=label, out_max_abs_err=err,
                             grad_max_abs_err=gerr, launches=counts))
    out = dict(shape=list(REG_ATTN), dtype="bfloat16", dropout_p=0.1,
               calls=rows, launches=totals)
    say("registry_attention " + json.dumps(out))
    return out


def _host(out):
    """The tensors of a result, on the host (a sparse array's dense
    value)."""
    if isinstance(out, (list, tuple)):
        return [leaf for o in out for leaf in _host(o)]
    if hasattr(out, "todense"):
        out = out.todense()
    return [] if out is None else [out._data.detach().cpu()]


def phase_registry_sweep(torch, mt):
    """22c: every case of ``ops/_sweep_cases.py`` (each op this slice adds
    to the registry, ``mx.np.linalg``, ``mx.np.random``, ``mx.random``,
    ``mx.nd.random``) once on ``cuda:0`` NDArrays, by
    :func:`sweep_on_card`."""
    from mxnet_tpu_torch.ops import _sweep_cases as sc

    return sweep_on_card(torch, mt, sc.CASES, "22c", "registry_sweep")


def sweep_on_card(torch, mt, cases, label, line):
    """Each case of ``cases`` (``ops/_sweep_cases.py``) once on ``cuda:0``
    NDArrays: every result on ``cuda:0`` (a sparse array's stored
    arrays); a deterministic case against the same call on CPU NDArrays
    (1e-4 relative to the largest value plus 1e-5: cuBLAS, cuDNN and
    cuSOLVER sum in other orders than the CPU's libraries; a factor's
    vectors compared by absolute value, their sign being free; complex
    values sorted where the order is the solver's); a sampler's shape and
    dtype against the CPU's, two draws after one ``mx.random.seed``
    equal. Prints ``line`` with the counts; fails on any failed case."""
    from mxnet_tpu_torch.ops import _sweep_cases as sc

    dev = torch.device("cuda", 0)
    data = sc.inputs(0)
    t0 = time.perf_counter()
    failed = []

    def run(case, on_cpu):
        scope = mt.cpu() if on_cpu else contextlib.nullcontext()
        with scope:
            args, kw = sc.materialize(
                case, data, lambda a: mt.np.array(a, dtype=a.dtype))
            out = sc.function_of(mt, case.key)(*args, **kw)
            return args[0] if case.kind == "sample_inplace" else out

    def arrays(out):
        if isinstance(out, (list, tuple)):
            return [a for o in out for a in arrays(o)]
        if isinstance(out, mt.nd.BaseSparseNDArray):
            return [out.data, out.indices]
        return [out] if isinstance(out, mt.NDArray) else []

    def ordered(t):
        import numpy as np

        return torch.from_numpy(np.sort_complex(t.numpy()))

    for case in cases:
        try:
            mt.random.seed(11)
            got = run(case, False)
            if any(a._data.device != dev for a in arrays(got)):
                failed.append((case.key, "off cuda:0"))
                continue
            if case.kind == "det":
                want = run(case, True)
                pairs = list(zip(_host(got), _host(want)))
                if len(_host(got)) != len(_host(want)):
                    failed.append((case.key, "outputs"))
                for a, b in pairs:
                    if case.check == "abs":
                        a, b = a.abs(), b.abs()
                    elif case.check == "sorted":
                        a, b = ordered(a), ordered(b)
                    if a.dtype != b.dtype or a.shape != b.shape:
                        failed.append((case.key, "dtype/shape"))
                    elif a.is_floating_point() or a.is_complex():
                        tol = 1e-4 * b.abs().max().item() + 1e-5
                        if (a - b).abs().max().item() > tol:
                            failed.append((case.key, "value"))
                    elif not torch.equal(a, b):
                        failed.append((case.key, "value"))
            else:
                mt.random.seed(11)
                again = _host(run(case, False))
                cpu = _host(run(case, True))
                for a, b, c in zip(_host(got), again, cpu):
                    if not torch.equal(a, b):
                        failed.append((case.key, "seeded draws differ"))
                    if (a.shape, a.dtype) != (c.shape, c.dtype):
                        failed.append((case.key, "shape/dtype vs the CPU"))
        except Exception as e:  # noqa: BLE001 - every case is reported
            failed.append((case.key, f"{type(e).__name__}: {e}"[:200]))
    torch.cuda.synchronize()
    out = dict(swept=len(cases),
               deterministic=sum(c.kind == "det" for c in cases),
               failed=len(failed), failures=failed[:20],
               seconds=time.perf_counter() - t0)
    say(f"{line} " + json.dumps(out))
    check(not failed, f"{label}: {len(failed)} of {len(cases)} cases "
                      f"failed: {failed[:10]}")
    return out


def phase_registry(torch, mt, build, fa, vision):
    """Phase 22, the operator corpus on the card: 22a, 22b, 22c."""
    t0 = time.perf_counter()
    resnet = phase_registry_resnet(torch, mt, build, vision)
    attention = phase_registry_attention(torch, mt, build, fa)
    sweep = phase_registry_sweep(torch, mt)
    seconds = time.perf_counter() - t0
    say(f"registry: ResNet-50 in the legacy ops {resnet['step_ms_p50']:.2f}"
        f" ms a step (p50 of {REG_STEPS}), {resnet['samples_per_s']:.1f} "
        f"samples/s at batch {REG_BATCH} f32; {sweep['swept']} names swept, "
        f"{sweep['failed']} failed; phase {seconds:.1f} s; card: "
        f"{card_line()}")
    return dict(resnet=resnet, attention=attention, sweep=sweep,
                seconds=seconds)


# -- sparse arrays and the row-sparse training path (phase 23) ---------------

#: 23a: the matrix-factorization example at MovieLens-20M's table sizes
#: (138 493 users x 27 278 items, the counts of GroupLens's ml-20m README)
MF_USERS, MF_ITEMS, MF_RANK = 138493, 27278, 64
MF_BATCH, MF_STEPS, MF_LR = 4096, 20, 0.01
MF_PARITY_STEPS, MF_OPT_REPEATS = 3, 5
#: 23b: a CSR batch of 8192 rows over 2^20 columns, 32 nonzeros a row,
#: against a 2^20 x 64 f32 weight
DOT_ROWS, DOT_COLS, DOT_NNZ, DOT_D = 8192, 1 << 20, 32, 64


def _flat_states(trainer):
    """Every optimizer state tensor of ``trainer``, in parameter order."""
    out = []

    def walk(s):
        if s is None:
            return
        if isinstance(s, (list, tuple)):
            for x in s:
                walk(x)
        else:
            out.append(s)

    for s in trainer._states:
        walk(s)
    return out


def _within(torch, got, want, tol):
    """Each pair's ``max |got - want|`` as a share of ``max |want|``
    (the largest such share), checked against ``tol``."""
    worst = 0.0
    for a, b in zip(got, want):
        a, b = a.detach().float().cpu(), b.detach().float().cpu()
        scale = b.abs().max().item() or 1.0
        worst = max(worst, (a - b).abs().max().item() / scale)
    return worst, worst <= tol


def _p50(values):
    return sorted(values)[len(values) // 2] if values else None


def _step_ms(torch, fn):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def phase_sparse_mf(torch, mt, users=MF_USERS, items=MF_ITEMS, rank=MF_RANK,
                    batch=MF_BATCH, steps=MF_STEPS, lr=MF_LR):
    """23a: the port's tools/matrix_factorization.py at MovieLens-20M's
    table sizes: two ``Embedding(sparse_grad=True)`` tables (rank 64, f32),
    Adam with ``lazy_update`` through the Trainer, L2Loss, batches of 4096
    sampled pairs whose ratings come from the factors and hashed noise.
    ``steps`` steps on the card; the first ``MF_PARITY_STEPS`` also on a
    CPU twin from the same weights (weights and Adam states within 1e-5 of
    each tensor's largest value); rows no step touched bit for bit their
    initial values, their states zero; the rmse over the example's fixed
    pairs before and after (it must fall). Then the update alone, lazy
    against ``lazy_update=False`` from one state (CUDA-event ms, the host's
    ms to return, the profiler's device ms and kernels, K3 launches counted
    from 0: none lazy, some dense); LAMB's update (layer-wise
    norms: dense) and a hybridized forward's (no rows recorded: dense)
    each move rows the batch did not touch."""
    import numpy as np

    from mxnet_tpu_torch.tools import matrix_factorization as mf

    dev, cpu = torch.device("cuda", 0), torch.device("cpu")
    t0 = time.perf_counter()
    rs = np.random.RandomState(0)
    ratings = mf.Ratings(users, items, rank, rs, dev)
    net, tr, lossfn = mf.build_mf(users, items, rank, lr, dev)
    pairs = mf.eval_pairs(users, items)
    rmse_before = mf.rmse(net, ratings, pairs)
    tables = {"user": net.user.weight, "item": net.item.weight}
    initial = {k: p._tensor().detach().clone() for k, p in tables.items()}
    touched = {k: torch.zeros(p.shape[0], dtype=torch.bool, device=dev)
               for k, p in tables.items()}
    cnet, ctr, clf = mf.build_mf(users, items, rank, lr, cpu)
    for name, p in cnet.collect_params().items():
        p.set_data(net.collect_params()[name]._tensor().detach().cpu())
    step_ms, rows = [], {"user": [], "item": []}
    parity = None
    for step in range(steps):
        uid, iid, y = mf.draw_batch(ratings, rs, batch)
        for k, ids in (("user", uid), ("item", iid)):
            touched[k][ids.long()] = True
            rows[k].append(int(torch.unique(ids).numel()))
        step_ms.append(_step_ms(torch, lambda: mf.train_step(
            net, tr, lossfn, uid, iid, y)))
        if step < MF_PARITY_STEPS:
            with mt.cpu():
                mf.train_step(cnet, ctr, clf, uid.cpu(), iid.cpu(), y.cpu())
        if step == MF_PARITY_STEPS - 1:
            got = [p._tensor() for p in net.collect_params().values()] \
                + _flat_states(tr)
            want = [p._tensor() for p in cnet.collect_params().values()] \
                + _flat_states(ctr)
            worst, ok = _within(torch, got, want, 1e-5)
            parity = worst
            check(len(got) == len(want) == 6 and ok,
                  f"23a: {MF_PARITY_STEPS} steps on the card differ from "
                  f"the CPU by {worst:.3g} of the largest (tol 1e-5)")
    torch.cuda.synchronize()
    rmse_after = mf.rmse(net, ratings, pairs)
    check(rmse_after < rmse_before,
          f"23a: rmse did not fall ({rmse_before} -> {rmse_after})")
    untouched = {}
    for k, p in tables.items():
        keep = ~touched[k]
        untouched[k] = int(keep.sum())
        check(torch.equal(p._tensor().detach()[keep], initial[k][keep]),
              f"23a: a row of {k} no step touched moved")
        i = tr._param_names.index(f"{k}.weight")
        for s in tr._states[i]:
            check(not bool(s[keep].any()),
                  f"23a: a state row of {k} no step touched is not zero")
    # the update alone, lazy and dense, from one state
    uid, iid, y = mf.draw_batch(ratings, rs, batch)
    with mt.autograd.record():
        loss = lossfn(net(uid, iid), y)
    mt.autograd.backward(loss)
    params = list(net.collect_params().values())
    saved = ([p._tensor().detach().clone() for p in params],
             [s.clone() for s in _flat_states(tr)],
             [list(p._sparse_row_hints) for p in params],
             dict(tr._grad_versions), dict(tr._optimizer._index_update_count),
             tr._optimizer.num_update)

    def restore():
        with torch.no_grad():
            for p, w in zip(params, saved[0]):
                p._tensor().copy_(w)
            for s, v in zip(_flat_states(tr), saved[1]):
                s.copy_(v)
        for p, h in zip(params, saved[2]):
            p._sparse_row_hints = list(h)
        tr._grad_versions = dict(saved[3])
        tr._optimizer._index_update_count = dict(saved[4])
        tr._optimizer.num_update = saved[5]

    from torch.profiler import ProfilerActivity, profile

    from mxnet_tpu_torch.kernels import build, opt as kopt

    def update(host):
        h0 = time.perf_counter()
        tr.step(batch)
        host.append((time.perf_counter() - h0) * 1e3)

    # each mode: CUDA-event ms with the host's ms to return from the step,
    # K3 launches counted from 0 just before; then the same update again
    # under the profiler for its kernels' device ms and their number
    upd = {m: {k: [] for k in ("ms", "host_ms", "device_ms", "kernels",
                               "k3_launches")} for m in ("lazy", "dense")}
    for _ in range(MF_OPT_REPEATS):
        for mode, u in upd.items():
            tr._optimizer.lazy_update = mode == "lazy"
            restore()
            torch.cuda.synchronize()
            build.reset_counters()
            u["ms"].append(_step_ms(torch, lambda: update(u["host_ms"])))
            u["k3_launches"].append(kopt.LAUNCHES.value)
            restore()
            torch.cuda.synchronize()
            TIMING["profiler_windows"] += 1
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                tr.step(batch)
                torch.cuda.synchronize()
            ev = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
            if not ev:
                TIMING["empty_windows"] += 1
                continue
            u["device_ms"].append(
                sum(e.time_range.elapsed_us() for e in ev) / 1e3)
            u["kernels"].append(len(ev))
    tr._optimizer.lazy_update = True
    check(set(upd["lazy"]["k3_launches"]) == {0}
          and min(upd["dense"]["k3_launches"]) > 0,
          f"23a: K3 launches a step, lazy {upd['lazy']['k3_launches']} "
          f"(want 0), dense {upd['dense']['k3_launches']} (want > 0)")
    restore()
    for p in params:
        p._sparse_row_hints = []
    # LAMB densifies: a row no batch touched moves (its weight decay)
    before = {k: p._tensor().detach().clone() for k, p in tables.items()}
    lamb = mt.gluon.Trainer(net.collect_params(), "lamb",
                            {"learning_rate": lr, "wd": 0.01})
    uid, iid, y = mf.draw_batch(ratings, rs, batch)
    build.reset_counters()
    mf.train_step(net, lamb, lossfn, uid, iid, y)
    k3 = {"lamb": kopt.LAUNCHES.value}
    lamb_moved = {}
    for k, p in tables.items():
        idle = torch.ones(p.shape[0], dtype=torch.bool, device=dev)
        idle[(uid if k == "user" else iid).long()] = False
        moved = (p._tensor().detach()[idle] != before[k][idle]).any(1)
        lamb_moved[k] = float(moved.float().mean())
        check(bool(moved.all()),
              f"23a: LAMB left {int((~moved).sum())} idle rows of {k}")
    # a hybridized forward records no rows: Adam's update is dense, so
    # rows with momentum that this batch does not touch move
    net.hybridize()
    before = {k: p._tensor().detach().clone() for k, p in tables.items()}
    uid, iid, y = mf.draw_batch(ratings, rs, batch)
    build.reset_counters()
    mf.train_step(net, tr, lossfn, uid, iid, y)
    k3["hybridized"] = kopt.LAUNCHES.value
    hybrid_moved = {}
    for k, p in tables.items():
        idle = touched[k].clone()
        idle[(uid if k == "user" else iid).long()] = False
        moved = (p._tensor().detach()[idle] != before[k][idle]).any(1)
        hybrid_moved[k] = float(moved.float().mean())
        check(bool(moved.all()),
              f"23a: the hybridized step left {int((~moved).sum())} rows "
              f"of {k} with momentum unchanged")
    net.hybridize(False)
    torch.cuda.synchronize()
    out = dict(
        users=users, items=items, rank=rank, batch=batch, steps=steps,
        lr=lr, step_ms=step_ms, step_ms_p50=sorted(step_ms)[len(step_ms) // 2],
        rows_touched=rows, untouched_rows=untouched,
        rmse_before=rmse_before, rmse_after=rmse_after,
        parity_max_share=parity,
        optimizer=upd,
        optimizer_p50={m: {k: _p50(v) for k, v in u.items()}
                       for m, u in upd.items()},
        lamb_idle_rows_moved=lamb_moved,
        hybridized_idle_rows_moved=hybrid_moved, k3_launches=k3,
        table_mb={k: p._tensor().numel() * 4 / 1e6
                  for k, p in tables.items()},
        seconds=time.perf_counter() - t0)
    say("sparse_mf " + json.dumps(out))
    return out


def phase_sparse_dot(torch, mt, rows=DOT_ROWS, cols=DOT_COLS, nnz=DOT_NNZ,
                     d=DOT_D):
    """23b: ``sparse.dot`` of a CSR batch (``rows`` x ``cols``, ``nnz`` a
    row) with a ``cols`` x ``d`` f32 weight (csr·dense) and of its
    transpose with a ``rows`` x ``d`` operand (csrᵀ·dense), forward and the
    dense operand's gradient, against the same calls on the CPU (within
    1e-5 of the largest value); each forward's ms (p50 of 5, CUDA events)
    beside its byte bound (the dense operand's rows that it reads, each
    once, the stored indices and values, the output) and
    ``torch.sparse.mm`` on the same CSR as an indication."""
    from mxnet_tpu_torch.ndarray import sparse as sp

    dev, cpu = torch.device("cuda", 0), torch.device("cpu")
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(23)
    col = torch.randint(0, cols, (rows, nnz), device=dev, generator=g)
    col = col.sort(dim=1).values.reshape(-1)
    vals = torch.randn(rows * nnz, device=dev, generator=g)
    ptr = torch.arange(0, rows * nnz + 1, nnz, device=dev)
    w = torch.randn(cols, d, device=dev, generator=g)
    x = torch.randn(rows, d, device=dev, generator=g)
    cot = {"csr_dense": torch.randn(rows, d, device=dev, generator=g),
           "csrT_dense": torch.randn(cols, d, device=dev, generator=g)}
    forms = {"csr_dense": (w, {}), "csrT_dense": (x, {"transpose_a": True})}
    nnz_all = rows * nnz
    distinct = int(torch.unique(col).numel())
    out = {}
    for name, (rhs, kw) in forms.items():
        csr = sp.CSRNDArray(vals, col, ptr, (rows, cols))
        res = {}
        for where in (dev, cpu):
            c = csr if where == dev else sp.CSRNDArray(
                vals.cpu(), col.cpu(), ptr.cpu(), (rows, cols))
            r = mt.NDArray(rhs.to(where).clone())
            r.attach_grad()
            with mt.autograd.record():
                y = sp.dot(c, r, **kw)
            y.backward(mt.NDArray(cot[name].to(where)))
            res[where.type] = (y._data.detach(), r.grad._data)
        worst, ok = _within(torch, res["cuda"], res["cpu"], 1e-5)
        check(ok, f"23b: {name} on the card differs from the CPU by "
                  f"{worst:.3g} of the largest (tol 1e-5)")
        r = mt.NDArray(rhs)
        times = [_step_ms(torch, lambda: sp.dot(csr, r, **kw))
                 for _ in range(6)][1:]
        # the dense operand read once: the distinct rows that csr·dense
        # gathers, all of csrᵀ·dense's; column indices, values and row
        # pointers as stored; the output written once
        read_rows = rows if kw else distinct
        out_rows = cols if kw else rows
        nbytes = (read_rows * d * 4
                  + nnz_all * (col.element_size() + vals.element_size())
                  + (rows + 1) * ptr.element_size() + out_rows * d * 4)
        lib = None
        try:
            tcsr = torch.sparse_csr_tensor(ptr, col, vals, (rows, cols))
            a = tcsr.t() if kw else tcsr
            torch.sparse.mm(a, rhs)
            lib = sorted(_step_ms(torch, lambda: torch.sparse.mm(a, rhs))
                         for _ in range(6))[3]
        except Exception as e:  # noqa: BLE001 - an indication only
            say(f"23b: torch.sparse.mm refused {name}: {e}"[:200])
        out[name] = dict(ms=sorted(times)[2], ms_all=times,
                         bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                         bound_bytes=nbytes, torch_sparse_mm_ms=lib,
                         max_share_vs_cpu=worst)
    torch.cuda.synchronize()
    out.update(rows=rows, cols=cols, nnz_per_row=nnz, d=d,
               distinct_columns=distinct,
               weight_mb=cols * d * 4 / 1e6,
               seconds=time.perf_counter() - t0)
    say("sparse_dot " + json.dumps(out))
    return out


def phase_sparse(torch, mt):
    """Phase 23, sparse arrays and the row-sparse training path on the
    card: 23a, 23b, 23c (the sweep of the slice's new names)."""
    t0 = time.perf_counter()
    from mxnet_tpu_torch.ops import _sweep_cases as sc

    mf_run = phase_sparse_mf(torch, mt)
    dot = phase_sparse_dot(torch, mt)
    sweep = sweep_on_card(torch, mt, sc.REST_CASES, "23c", "sparse_sweep")
    seconds = time.perf_counter() - t0
    lazy, dense = (mf_run["optimizer_p50"][m] for m in ("lazy", "dense"))
    say(f"sparse: matrix factorization at {MF_USERS} x {MF_ITEMS} rank "
        f"{MF_RANK}: {mf_run['step_ms_p50']:.2f} ms a step (p50 of "
        f"{MF_STEPS}), update lazy {lazy['ms']:.3f} ms ({lazy['device_ms']}"
        f" on the device) against dense {dense['ms']:.3f} "
        f"({dense['device_ms']}), rmse "
        f"{mf_run['rmse_before']:.5f} -> {mf_run['rmse_after']:.5f}; dot "
        f"{dot['csr_dense']['ms']:.3f} ms (bound "
        f"{dot['csr_dense']['bound_ms']:.4f}), transposed "
        f"{dot['csrT_dense']['ms']:.3f} ms (bound "
        f"{dot['csrT_dense']['bound_ms']:.4f}); {sweep['swept']} names "
        f"swept, {sweep['failed']} failed; phase {seconds:.1f} s; card: "
        f"{card_line()}")
    return dict(mf=mf_run, dot=dot, sweep=sweep, seconds=seconds)


# -- data-parallel training across processes (phase 24) ----------------------

DIST_BATCH = 128            # a rank's share of config #3's global 256
DIST_STEPS = 3
DIST_COMPRESS_N = 1 << 24   # f32 elements of 24d's gradient
# K3 launches a rank a step: one a bucket, bf16 weights with f32 masters
# and f32 BatchNorm parameters, each well under a launch's 384 tensors
DIST_LADDER_BUCKETS = 2
_RANK_VARS = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
              "MASTER_ADDR", "MASTER_PORT")


def dist_launch(n, args, out, timeout=240):
    """``tools/distributed_train.py`` with ``args`` as ``n`` ranks through
    the port's launcher, each writing into ``out``; a rank's failure fails
    the phase. Returns the seconds the launch took and its output; each
    rank's ``wall`` times in its record become seconds from the launch."""
    here = Path(__file__).resolve().parent
    out.mkdir(parents=True, exist_ok=True)
    env = {k: v for k, v in os.environ.items() if k not in _RANK_VARS}
    env["PYTHONPATH"] = str(here) + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "mxnet_tpu_torch.tools.launch", "-n",
           str(n), "--timeout", str(timeout), sys.executable, "-m",
           "mxnet_tpu_torch.tools.distributed_train", "--out", str(out),
           *args]
    t0, wall = time.perf_counter(), time.time()
    proc = subprocess.run(cmd, cwd=here, env=env, capture_output=True,
                          text=True, timeout=timeout + 60)
    check(proc.returncode == 0,
          f"{n} ranks of distributed_train {args}: exit "
          f"{proc.returncode}\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    for r in range(n):
        path = out / f"rank{r}.json"
        rec = json.loads(path.read_text())
        rec["seconds_from_launch"] = {k: v - wall
                                      for k, v in rec["wall"].items()}
        path.write_text(json.dumps(rec))
    return time.perf_counter() - t0, proc.stdout


def _dist_results(torch, out, n, files="params"):
    recs = [json.loads((out / f"rank{r}.json").read_text())
            for r in range(n)]
    states = [torch.load(out / f"{files}_rank{r}.pt") for r in range(n)]
    return recs, states


def _bitwise_across(torch, states, label):
    """Fail unless every rank ended with the same tensors, bit for bit."""
    for r, st in enumerate(states[1:], 1):
        check(st.keys() == states[0].keys()
              and all(torch.equal(st[k], states[0][k]) for k in st),
              f"{label}: rank {r} differs from rank 0 in "
              f"{[k for k in st if not torch.equal(st[k], states[0][k])]}")


def dist_reference(torch, mt, batch, steps, narrow):
    """One process taking the ranks' two half-batches a step:
    ``grad_req='add'`` over two backward passes, then ``trainer.step(2 x
    batch)``. Each rank keeps BatchNorm's running statistics of its own
    (nothing reduces them, as in the JAX package), and BatchNorm's
    training forward shifts its sums by them, so each half's forward here
    runs with the statistics its rank would hold. Returns the trained
    state (``distributed_train.trained_state``), the largest gradient of
    the last step and its gradients (the trainable list, on the card)."""
    from mxnet_tpu_torch.tools import distributed_train as dtr
    from mxnet_tpu_torch.tools import train_resnet

    kw = dtr.resnet_kwargs(narrow)
    dev = mt.gpu(0)
    net, trainer, _ = train_resnet.build_resnet_train(batch=batch,
                                                      device=dev, **kw)
    halves = [train_resnet.synthetic_batch(
        batch, "NHWC", kw.get("image", 224), kw.get("classes", 1000), 1 + r,
        dev) for r in range(2)]
    with mt.autograd.pause(), torch.no_grad():
        net(halves[0][0])   # the deferred shapes; predict mode moves nothing
    params = net.collect_params().values()
    trainable = [p for p in params if p.grad_req != "null"]
    running = [p._tensor() for p in params if p.grad_req == "null"]
    held = [[t.detach().clone() for t in running] for _ in range(2)]
    for p in trainable:
        p.grad_req = "add"
    loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    for _ in range(steps):
        trainer.zero_grad()
        for (x, y), mine in zip(halves, held):
            with torch.no_grad():
                for t, h in zip(running, mine):
                    t.copy_(h)
            with mt.autograd.record():
                loss = loss_fn(net(x).float(), y)
            mt.autograd.backward(loss)
            with torch.no_grad():
                for t, h in zip(running, mine):
                    h.copy_(t)
        trainer.step(2 * batch)
    grads = [p.grad() for p in trainable]
    big = max(g.abs().max().item() for g in grads)
    return dtr.trained_state(net, trainer), big, grads


def dist_bn_sites(torch, batch):
    """K1 and K2 against their plain versions on the card at the 53
    BatchNorm sites of ResNet-50 at a rank's ``batch`` (bf16 NHWC, the
    shapes 24a's ranks run; phase 3 checks them at batch 256), each site
    by :func:`bn_case` (its tolerances, its bit-for-bit repeat, the
    kernels a captured call launched); the largest errors."""
    from mxnet_tpu_torch.kernels import norm as knorm

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(79)
    rows = []
    for shape, sites in resnet50_bn_sites(batch):
        label = "resnet50_b{}_{}x{}x{}".format(*shape)
        row, ops = bn_case(torch, knorm, gen, dev, label, shape, -1,
                           torch.bfloat16, "f32", False, 0)
        row["sites"] = sites
        rows.append(row)
        del ops
        torch.cuda.empty_cache()
    check(sum(r["sites"] for r in rows) == 53, "ResNet-50 has 53 BN sites")
    return dict(
        batch=batch, sites=53, distinct_shapes=len(rows),
        fwd_max_abs_err=max(r["out_max_abs_err"] for r in rows),
        bwd_max_abs_err=max(r["dx_max_abs_err"] for r in rows),
        stats_max_rel_err=max(r["stats_max_rel_err"] for r in rows),
        regimes=sorted({r["regime"]["fwd"] for r in rows}
                       | {r["regime"]["bwd"] for r in rows}))


def phase_dist_resnet(torch, mt, out, narrow=False, batch=DIST_BATCH,
                      steps=DIST_STEPS):
    """24a: config #3, two ranks over gloo on the one card (module note).
    Returns the ranks' figures, the gates' measures and the reference's
    gradients (for 24b)."""
    gc_collect(torch)
    seconds, _ = dist_launch(
        2, ["--model", "resnet50_v1", "--batch", str(batch), "--steps",
            str(steps)] + (["--narrow"] if narrow else []), out)
    recs, states = _dist_results(torch, out, 2)
    check(all(rec["backend"] == "gloo" for rec in recs),
          f"24a backends {[rec['backend'] for rec in recs]}, want gloo "
          f"(two ranks, one card)")
    for rec in recs:
        want = rec["bn_layers"] * steps
        got = rec["launches"]
        check(got["bn_train_fwd"] == got["bn_train_bwd"] == want
              and got["opt_ladder"] == DIST_LADDER_BUCKETS * steps,
              f"24a rank {rec['rank']}: launches {got}, want K1 = K2 = "
              f"{want} and K3 = {DIST_LADDER_BUCKETS * steps}")
        check(all(math.isfinite(v) for v in rec["losses"]),
              f"24a rank {rec['rank']}: losses {rec['losses']}")
    _bitwise_across(torch, states, "24a")
    bn = dist_bn_sites(torch, batch)
    ref, big, grads = dist_reference(torch, mt, batch, steps, narrow)
    # phase 8's measure: a parameter's error over 1e-5 of its largest
    # value plus 0.1 of the step the largest gradient takes; a bf16 weight
    # may round its master the other way, one bf16 ulp (2^-7 of it)
    floor = 0.1 * RESNET_LR * big / (2 * batch)
    worst = {}
    for k, want in ref.items():
        a, b = states[0][k].float(), want.float()
        tol = 1e-5 * b.abs().max().item() + floor
        if want.dtype == torch.bfloat16:
            tol = tol + b.abs() * 2.0 ** -7
        worst[k] = ((a - b).abs() / tol).max().item()
    params = {k: v for k, v in worst.items() if not k.startswith("state")}
    check(max(params.values()) <= 1.0,
          f"24a: parameters against one process over two half-batches, "
          f"the 3 worst over tolerance "
          f"{sorted((v, k) for k, v in params.items())[-3:]}")
    per_rank = []
    for rec in recs:
        pp = rec["collectives"].get("pushpull", {})
        per_rank.append(dict(
            rank=rec["rank"], step_ms=rec["step_ms"],
            step_ms_p50=sorted(rec["step_ms"])[len(rec["step_ms"]) // 2],
            pushpull_ms_per_step=1e3 * pp.get("seconds", 0.0) / steps,
            pushpull_bytes_per_step=pp.get("bytes", 0.0) / steps,
            pushpull_calls=pp.get("calls", 0),
            allreduce_alone_ms=rec["allreduce_ms"],
            allreduce_alone_ms_p50=sorted(rec["allreduce_ms"])[1],
            launches=rec["launches"],
            losses=rec["losses"],
            seconds_from_launch=rec["seconds_from_launch"]))
    return dict(
        ranks=per_rank, backend=recs[0]["backend"], seconds=seconds,
        global_batch=2 * batch, steps=steps, bn_layers=recs[0]["bn_layers"],
        bn=bn,
        params_worst_over_tol=max(params.values()),
        states_worst_over_tol=max(v for k, v in worst.items()
                                  if k.startswith("state")),
        tensors_bitwise_across_ranks=len(states[0])), grads


def phase_dist_nccl(torch, mt, tensors):
    """24b: NCCL at world size 1: the store's bucketed reduce over
    ``tensors`` (the ranks' gradient list) gives back its input bit for
    bit; ms a call."""
    import torch.distributed as dist

    from mxnet_tpu_torch.kvstore import tpu_dist

    backend = tpu_dist.choose_backend(1, torch.cuda.device_count())
    check("nccl" in backend, f"24b: one rank on a card took {backend}")
    # port 0: the store binds a free port itself
    store = dist.TCPStore("127.0.0.1", 0, 1, is_master=True)
    dist.init_process_group(backend, store=store, world_size=1, rank=0)
    try:
        kv = mt.kvstore.create("tpu_dist")
        got = kv.allreduce_flat(tensors)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, tensors)),
              "24b: NCCL's sum over one rank is not its input")
        ms = _p50_ms(torch, lambda _: kv.allreduce_flat(tensors))
        nbytes = sum(t.numel() * t.element_size() for t in tensors)
        return dict(backend=kv.backend, ms=ms, bytes=nbytes,
                    tensors=len(tensors),
                    dtypes=sorted({str(t.dtype) for t in tensors}))
    finally:
        dist.destroy_process_group()


def _dequantized_sum(torch, ranks):
    """Each round's sum over ``ranks`` of what the compressed example
    pushes, quantized and dequantized on the CPU."""
    import numpy as onp

    from mxnet_tpu_torch.kvstore.gradient_compression import \
        GradientCompression

    want = [torch.zeros(6, 5), torch.zeros(6, 5)]
    for r in range(ranks):
        rs = onp.random.RandomState(100 + r)
        gc = GradientCompression(type="2bit", threshold=0.5)
        for i in range(2):
            g = torch.from_numpy(rs.uniform(-1.2, 1.2, (6, 5)).astype("f"))
            want[i] += gc.compress_pipeline("w:0", g)
    return want


def phase_dist_example(torch, out):
    """24c: the example at its defaults and its compressed mode, each two
    ranks over gloo on the card, the two jobs at once."""
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        jobs = [pool.submit(dist_launch, 2, args, out / name)
                for args, name in (([], "example"),
                                   (["--compress"], "compress"))]
        (seconds, _), (c_seconds, _) = [job.result() for job in jobs]
    recs, states = _dist_results(torch, out / "example", 2)
    _bitwise_across(torch, states, "24c")
    seen = recs[0]["seen_loss"]
    check(seen["after"] < seen["before"],
          f"24c: rank 0's loss over its batches did not fall: {seen}")
    pulled = [torch.load(out / "compress" / f"kv_rank{r}.pt")
              for r in range(2)]
    want = _dequantized_sum(torch, 2)
    for r, got in enumerate(pulled):
        for i, key in enumerate(("round1", "round2")):
            check(torch.equal(got[key], want[i]),
                  f"24c: rank {r}'s {key} is not the sum of the ranks' "
                  f"dequantized values")
    return dict(seconds=seconds, compressed_seconds=c_seconds,
                backend=recs[0]["backend"], losses=recs[0]["losses"],
                seen_loss=seen,
                seconds_from_launch=[rec["seconds_from_launch"]
                                     for rec in recs])


def phase_dist_compression(torch, n=DIST_COMPRESS_N):
    """24d: 2-bit and 1-bit compression of an ``n``-element f32 gradient on
    the card against the CPU, two rounds (the residual fed back): packed
    bytes and residuals bit for bit; the card's ms a compress_pipeline."""
    from mxnet_tpu_torch.kvstore.gradient_compression import \
        GradientCompression

    gen = torch.Generator().manual_seed(24)
    grads = [torch.randn(n, generator=gen) * 0.6 for _ in range(2)]
    out = {}
    for kind in ("2bit", "1bit"):
        cpu = GradientCompression(type=kind, threshold=0.5)
        card = GradientCompression(type=kind, threshold=0.5)
        for g in grads:
            packed = cpu.compress("g", g)
            packed_card = card.compress("g", g.cuda())
            check(torch.equal(packed, packed_card.cpu())
                  and torch.equal(cpu._residuals["g"],
                                  card._residuals["g"].cpu()),
                  f"24d: {kind} on the card differs from the CPU")
        g = grads[0].cuda()
        out[kind] = dict(
            packed_bytes=packed.numel(),
            ms=_p50_ms(torch, lambda _: card.compress_pipeline("t", g)))
    return out


def phase_distributed(torch, mt, narrow=False, batch=DIST_BATCH,
                      steps=DIST_STEPS):
    """Phase 24 (module note): 24a, 24b, 24c, 24d."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dist_") as tmp:
        tmp = Path(tmp)
        resnet, grads = phase_dist_resnet(torch, mt, tmp / "resnet",
                                          narrow, batch, steps)
        nccl = phase_dist_nccl(torch, mt, grads)
        del grads
        gc_collect(torch)
        example = phase_dist_example(torch, tmp)
    compression = phase_dist_compression(torch)
    seconds = time.perf_counter() - t0
    ranks = resnet["ranks"]
    say(f"distributed: config #3, {len(ranks)} ranks over "
        f"{resnet['backend']} on one card, global batch "
        f"{resnet['global_batch']}: step p50 "
        f"{[round(r['step_ms_p50'], 2) for r in ranks]} ms, pushpull "
        f"{[round(r['pushpull_ms_per_step'], 2) for r in ranks]} ms and "
        f"{ranks[0]['pushpull_bytes_per_step'] / 1e6:.1f} MB a step (the "
        f"bucketed sum alone after a barrier "
        f"{[round(r['allreduce_alone_ms_p50'], 2) for r in ranks]} ms), "
        f"K1/K2/K3 "
        f"{[tuple(r['launches'].values()) for r in ranks]} a rank; "
        f"K1/K2 at the 53 sites at batch {resnet['bn']['batch']}: max err "
        f"{resnet['bn']['fwd_max_abs_err']:.3g}/"
        f"{resnet['bn']['bwd_max_abs_err']:.3g}; parameters {resnet['params_worst_over_tol']:.3g} of phase 8's "
        f"tolerance from one process; NCCL at world size 1 "
        f"{nccl['ms']:.3f} ms over {nccl['bytes'] / 1e6:.1f} MB; example "
        f"{example['seen_loss']}; compression 2-bit "
        f"{compression['2bit']['ms']:.3f} ms, 1-bit "
        f"{compression['1bit']['ms']:.3f} ms over 2^24 f32; phase "
        f"{seconds:.1f} s; card: {card_line()}")
    out = dict(resnet=resnet, nccl=nccl, example=example,
               compression=compression, seconds=seconds)
    say("distributed " + json.dumps(out))
    return out


# -- INT8 inference, BASELINE config #5 (phase 25) ----------------------------

#: int8 operations a second at the card's dense tensor-core peak (H100 SXM)
PEAK_INT8_OPS = 1979e12
INT8_BATCH = 32            # the rung whose forward the kernel rows time
INT8_RUNGS = (1, 8, 32)    # the served rungs: 25a's and 25b's checks at each
INT8_REQUESTS = 24         # 25b's requests of 1-8 images
INT8_TWIN_IMAGES = 8       # 25b's images held against the CPU twin
#: 25b: card logits against the CPU twin's, relative to the largest. The
#: f32 layers between the int8 ones (BatchNorm, the pools) round in other
#: places on the card and the CPU, which moves some int8 codes by one at a
#: rounding boundary, and 53 random-weight layers carry that on (the codes
#: that differ are counted and printed); each layer itself is held bit for
#: bit on the card at every rung (int8_layer_check)
INT8_TWIN_TOL = 1e-2


def int8_sites(torch, mt, vision, dev, batches):
    """``{batch: [(site, count)]}`` of ResNet-50 v1 (NCHW) at each of
    ``batches``: each Conv2D's and the Dense's (as a 1x1 convolution of a
    1x1 plane) input shape, weight shape, stride, padding, dilation,
    groups, bias and relu, read by hooks from a forward at batch 1, with
    how many layers share it."""
    from mxnet_tpu_torch.contrib import quantization as qz

    net = vision.resnet50_v1(classes=1000)
    net.initialize(device=dev, generator=torch.Generator().manual_seed(0))
    seen = []

    def hook(block, inputs, out):  # noqa: ARG001
        x = inputs[0]
        w = block.weight._tensor()
        bias = block.bias is not None
        relu = block._activation == "relu"
        if isinstance(block, mt.gluon.nn.Dense):
            seen.append(((1, w.shape[1], 1, 1), tuple(w.shape) + (1, 1),
                         (1, 1), (0, 0), (1, 1), 1, bias, relu))
        else:
            seen.append(((1,) + tuple(x.shape[1:]), tuple(w.shape),
                         block._strides, block._padding, block._dilation,
                         block._groups, bias, relu))

    handles = [child.register_forward_hook(hook)
               for _, _, _, child in qz._targets(net, set())]
    with torch.no_grad():
        net(torch.zeros((1, 3, 224, 224), device=dev))
    for h in handles:
        h.remove()
    check(len(seen) == 54, f"ResNet-50 has 54 quantized sites, saw "
                           f"{len(seen)}")
    counts = {}
    for site in seen:
        counts[site] = counts.get(site, 0) + 1
    return {b: [(((b,) + site[0][1:],) + site[1:], n)
                for site, n in counts.items()] for b in batches}


def int8_bounds(site):
    """Least ms of Q1 and Q2 at one site, and what bounds Q2: Q1 reads x
    (f32) and writes its codes; Q2 reads the codes, the int8 weight and
    its per-channel f32 scales (and bias), writes f32 out, and does 2 * K
    int8 operations an output (K = C/groups * kh * kw) at the dense
    tensor-core peak."""
    xs, ws, stride, pad, dil, groups, bias, _ = site
    n = math.prod(xs)
    q1 = 1e3 * 5 * n / HBM_BYTES_PER_S
    from mxnet_tpu_torch.kernels import int8 as kint8

    out = kint8.conv_out_shape(xs, ws, stride, pad, dil)
    k = math.prod(ws[1:])
    nbytes = n + math.prod(ws) + 4 * math.prod(out) + 4 * ws[0] * (
        2 if bias else 1)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2 * math.prod(out) * k / PEAK_INT8_OPS
    return q1, 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                           else "operations")


def int8_device_parts(torch, fns, tag, iters=20):
    """``(all, tagged)``: as :func:`device_ms`, the mean device ms of one
    call, and of it the ms of the kernels whose name holds ``tag`` (None
    where the profiler recorded no device activity: then ``all`` is
    :func:`device_ms`'s CUDA-event time)."""
    from torch.profiler import ProfilerActivity, profile

    fns = list(fns)
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    for _ in range(1 if TIMING["event_timed_calls"] else 3):
        TIMING["profiler_windows"] += 1
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fns[i % len(fns)]()
            torch.cuda.synchronize()
        ev = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
        if ev:
            us = sum(e.time_range.elapsed_us() for e in ev)
            mine = sum(e.time_range.elapsed_us() for e in ev
                       if tag in e.name)
            return us / 1e3 / iters, mine / 1e3 / iters
        TIMING["empty_windows"] += 1
    return device_ms(torch, fns, iters), None


def int8_site_operands(torch, kint8, site, gen, dev):
    """One site's random f32 input and int8 weight (stored as the layer
    stores it: channels-last where the wgmma variant takes the site), its
    per-channel scales and bias."""
    xs, ws, _, _, _, _, has_bias, _ = site
    x = torch.rand(xs, device=dev, generator=gen) * 5 - 2
    wq = torch.randint(-127, 128, ws, device=dev, generator=gen,
                       dtype=torch.int32).to(torch.int8)
    if kint8.wgmma_site(ws):
        wq = wq.contiguous(memory_format=torch.channels_last)
    wscale = torch.rand(ws[0], device=dev, generator=gen) * 200 + 50
    bias = (torch.rand(ws[0], device=dev, generator=gen) - 0.5
            if has_bias else None)
    return x, wq, wscale, bias


def phase_int8_kernels(torch, mt, vision, batch=INT8_BATCH):
    """25a: Q1 and Q2 against their plain versions on the card at each of
    ResNet-50's 54 quantized sites at every served rung's batch (1, 8, 32;
    and at a site each of dilation 2, groups 2 and depthwise), each in the
    variant, tile and split that ``kernels/int8.py:plan_conv`` picks, its
    operands stored as the quantized layers store them (Q1's codes and
    the weight channels-last where the wgmma variant runs): Q1's codes and
    (-amax, amax, scale) bit for bit, Q2's int32 sums bit for bit those of
    the float64 convolution of the codes (cuDNN off: im2col and a GEMM,
    exact on integers), its f32 epilogue bit for bit the plain version's.
    Times at ``batch`` per site, summed over the sites by their counts:
    each kernel alone (summed kernel events, inputs rotated over copies
    exceeding the L2; the wgmma variant's split-K epilogue launch apart)
    and host-issued (CUDA events around back-to-back calls), the plain
    versions, the bound; beside them the earlier designs in the same run:
    Q1's flat pass writing NCHW codes, and Q2's gather variant forced at
    every site on NCHW codes and OIHW weights; as indications, cuDNN's f32
    and bf16 convolutions of the same shapes (other functions),
    ``torch._int_mm`` at the Dense's shape and ``torch.quantize_per_tensor``
    (x / scale, another rounding and range) beside Q1."""
    import torch.nn.functional as F
    from mxnet_tpu_torch.kernels import int8 as kint8

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(25)
    by_batch = int8_sites(torch, mt, vision, dev, INT8_RUNGS)
    sites = by_batch[batch]
    extra = [(((2, 16, 28, 28), (32, 16, 3, 3), (1, 1), (2, 2), (2, 2), 1,
               True, True), 0),
             (((2, 16, 28, 28), (32, 8, 3, 3), (2, 2), (1, 1), (1, 1), 2,
               True, False), 0),
             (((2, 32, 28, 28), (32, 1, 3, 3), (1, 1), (1, 1), (1, 1), 32,
               False, True), 0)]
    lohi = torch.tensor([-2.0, 2.0], device=dev)
    gather = kint8.ConvPlan("gather", 64, 1)
    keys = ("q1_ms", "q1_ms_host_issued", "q1_plain_ms", "q1_bound_ms",
            "q1_library_ms", "q1_flat_ms", "q2_ms", "q2_ms_host_issued",
            "q2_plain_ms", "q2_bound_ms", "q2_gather_ms", "cudnn_f32_ms",
            "cudnn_bf16_ms")
    total = dict.fromkeys(keys, 0.0)
    # the kernels line's Q2 rows: each variant's sites, and the split-K
    # epilogue launches of the split ones
    by_variant = {v: dict.fromkeys(("ms", "ms_host_issued", "plain_ms",
                                    "bound_ms", "gather_ms", "sites",
                                    "layers"), 0)
                  for v in ("wgmma", "gather", "splitk")}
    worst = dict(q1_codes=0, q1_info=0.0, q1_layout_wrong=0, q2_acc=0,
                 q2_f32=0.0, q2_f32_ulps=0)
    checked = {}
    per_site, bound_by = [], {"bytes": 0.0, "operations": 0.0}
    t0 = time.perf_counter()
    cases = [(b, site, count) for b in INT8_RUNGS
             for site, count in by_batch[b]] + [(None, site, 0)
                                                for site, _ in extra]
    for at, site, count in cases:
        xs, ws, stride, pad, dil, groups, _, relu = site
        x, wq, wscale, bias = int8_site_operands(torch, kint8, site, gen,
                                                 dev)
        plan = kint8.plan_conv(xs, ws, stride, pad, dil, groups)
        cl = plan.variant == "wgmma"
        key = f"{plan.variant}/{plan.bm}x64/split{plan.split}"
        checked[key] = checked.get(key, 0) + 1
        codes, info = kint8.quantize(x, lohi, clip=True, channels_last=cl)
        want_codes, want_info = kint8.quantize_reference(x, lohi, True)
        worst["q1_codes"] = max(worst["q1_codes"], int(
            (codes.int() - want_codes.int()).abs().max()))
        worst["q1_info"] = max(worst["q1_info"],
                               float((info - want_info).abs().max()))
        worst["q1_layout_wrong"] += int(not codes.is_contiguous(
            memory_format=torch.channels_last if cl
            else torch.contiguous_format))
        args = (stride, pad, dil, groups)
        acc = kint8.conv(codes, wq, *args)
        with torch.backends.cudnn.flags(enabled=False):
            want_acc = kint8.conv_reference(codes, wq, *args)
        worst["q2_acc"] = max(worst["q2_acc"], int(
            (acc.long() - want_acc.long()).abs().max()))
        xscale = info[2:3]
        y = kint8.conv(codes, wq, *args, xscale, wscale, bias, relu)
        want_y = kint8._epilogue(want_acc, xscale, wscale, bias, relu)
        worst["q2_f32"] = max(worst["q2_f32"],
                              float((y - want_y).abs().max()))
        ulps = (y.view(torch.int32).long()
                - want_y.view(torch.int32).long()).abs()
        worst["q2_f32_ulps"] = max(worst["q2_f32_ulps"], int(
            torch.where(y == want_y, 0, ulps).max()))
        del acc, want_acc, want_y, want_codes
        if at != batch or not count:    # checked, not timed
            continue
        q1_bound, q2_bound, by = int8_bounds(site)
        bound_by[by] += q2_bound * count
        # the earlier designs' operands: NCHW codes, OIHW weight
        codes_nchw, wq_oihw = codes.contiguous(), wq.contiguous()
        cold_x = cold_copies(torch, [x])
        cold_c = cold_copies(torch, [codes])
        cold_n = cold_copies(torch, [codes_nchw])
        wf = wq.float()
        xf16 = x.bfloat16()
        cold_bf = cold_copies(torch, [xf16])
        scale = 1.0 / info[2].item()
        try:
            q1_lib = device_ms(torch, [partial(
                torch.quantize_per_tensor, c[0], scale, 0, torch.qint8)
                for c in cold_x])
        except RuntimeError:
            q1_lib = None
        q2_all, q2_splitk = int8_device_parts(torch, [partial(
            kint8.conv, c[0], wq, *args, xscale, wscale, bias, relu)
            for c in cold_c], "splitk_epilogue_kernel")
        times = dict(
            plan=plan._asdict(),
            q1_ms=device_ms(torch, [partial(kint8.quantize, c[0], lohi, True,
                                            cl) for c in cold_x]),
            q1_ms_host_issued=cuda_ms(torch, partial(kint8.quantize, x, lohi,
                                                     True, cl)),
            q1_plain_ms=cuda_ms(torch, partial(kint8.quantize_reference, x,
                                               lohi, True), iters=5),
            q1_bound_ms=q1_bound, q1_library_ms=q1_lib,
            q1_flat_ms=device_ms(torch, [partial(kint8.quantize, c[0], lohi,
                                                 True) for c in cold_x]),
            q2_ms=q2_all,
            q2_splitk_ms=q2_splitk if plan.split > 1 else 0.0,
            q2_ms_host_issued=cuda_ms(torch, partial(
                kint8.conv, codes, wq, *args, xscale, wscale, bias, relu)),
            q2_plain_ms=cuda_ms(torch, partial(
                kint8.conv_reference, codes, wq, *args, xscale, wscale, bias,
                relu), iters=3),
            q2_bound_ms=q2_bound,
            q2_gather_ms=device_ms(torch, [partial(
                kint8.conv, c[0], wq_oihw, *args, xscale, wscale, bias, relu,
                plan=gather) for c in cold_n]),
            cudnn_f32_ms=device_ms(torch, [partial(
                F.conv2d, c[0], wf, None, stride, pad, dil, groups)
                for c in cold_x]),
            cudnn_bf16_ms=device_ms(torch, [partial(
                F.conv2d, c[0], wf.bfloat16(), None, stride, pad, dil,
                groups) for c in cold_bf]))
        if ws[2:] == (1, 1) and xs[2:] == (1, 1):   # the Dense
            a = codes.reshape(xs[0], xs[1])
            b = wq.reshape(ws[0], ws[1]).t().contiguous()
            cold_a = cold_copies(torch, [a])
            # _int_mm refuses 16 rows or fewer
            times["int_mm_ms"] = device_ms(torch, [partial(
                torch._int_mm, c[0], b) for c in cold_a]) \
                if xs[0] > 16 else None
            times["int_mm_ms_host_issued"] = cuda_ms(torch, partial(
                torch._int_mm, a, b)) if xs[0] > 16 else None
            dense = dict(site=[list(v) if isinstance(v, tuple) else v
                               for v in site], **times)
        for k in keys:
            if times[k] is None or total[k] is None:
                total[k] = None
            else:
                total[k] += times[k] * count
        row = by_variant[plan.variant]
        split = times["q2_splitk_ms"]
        row["ms"] = None if split is None or row["ms"] is None else (
            row["ms"] + (times["q2_ms"] - split) * count)
        row["ms_host_issued"] += times["q2_ms_host_issued"] * count
        row["plain_ms"] += times["q2_plain_ms"] * count
        row["bound_ms"] += q2_bound * count
        row["gather_ms"] += times["q2_gather_ms"] * count
        row["sites"] += 1
        row["layers"] += count
        if plan.split > 1:
            sk = by_variant["splitk"]
            sk["ms"] = None if split is None or sk["ms"] is None else (
                sk["ms"] + split * count)
            # its plain version: the splits' int32 sums added, then the
            # epilogue
            parts = torch.randint(-2 ** 20, 2 ** 20, (plan.split,) + tuple(
                y.shape), device=dev, generator=gen, dtype=torch.int32)
            sk["plain_ms"] += count * cuda_ms(torch, lambda: kint8._epilogue(
                parts.sum(0, dtype=torch.int32), xscale, wscale, bias, relu),
                iters=5)
            del parts
            sk["bound_ms"] += splitk_bound(kint8, site, plan) * count
            sk["sites"] += 1
            sk["layers"] += count
        per_site.append(dict(site=[list(v) if isinstance(v, tuple) else v
                                   for v in site], count=count, **times))
        del cold_x, cold_c, cold_n, cold_bf
        gc_collect(torch)
    torch.cuda.synchronize()
    check(worst["q1_codes"] == 0 and worst["q1_info"] == 0.0
          and worst["q1_layout_wrong"] == 0,
          f"int8 quantize differs from its plain version: {worst}")
    check(worst["q2_acc"] == 0, f"int8 conv sums differ: {worst}")
    check(worst["q2_f32_ulps"] == 0,
          f"int8 conv f32 epilogue differs from its plain version: {worst}")
    check(by_variant["wgmma"]["layers"] == 53
          and by_variant["gather"]["layers"] == 1,
          f"int8 plan at batch {batch}: 53 wgmma layers and the stem on "
          f"the gather variant, got {by_variant}")
    out = dict(batch=batch, sites=len(sites),
               layers=sum(c for _, c in sites), extra_sites=len(extra),
               checked_at={b: sum(c for _, c in by_batch[b])
                           for b in INT8_RUNGS},
               checked_plans=checked, worst=worst, total=total,
               by_variant=by_variant,
               q2_bound_ms_by=bound_by,
               q2_bound_by=max(bound_by, key=bound_by.get),
               dense=dense, per_site=per_site,
               seconds=time.perf_counter() - t0)
    say("int8_kernels " + json.dumps(out))
    return out


def splitk_bound(kint8, site, plan):
    """Least ms of the split-K epilogue launch at one site: it reads the
    splits' int32 sums and the per-channel scales (and bias) and writes
    the output (f32), bytes at the memory rate."""
    xs, ws, stride, pad, dil, _, bias, _ = site
    out = math.prod(kint8.conv_out_shape(xs, ws, stride, pad, dil))
    nbytes = 4 * out * (plan.split + 1) + 4 * ws[0] * (2 if bias else 1)
    return 1e3 * nbytes / HBM_BYTES_PER_S


def int8_split_launches(torch, mt, vision, dev, by_rung):
    """The split-K epilogue launches a served ResNet-50 makes: the sites
    that :func:`kernels.int8.plan_conv` splits at each rung's batch, times
    that rung's dispatches (``by_rung``)."""
    from mxnet_tpu_torch.kernels import int8 as kint8

    sites = int8_sites(torch, mt, vision, dev, tuple(by_rung))
    return sum(n * sum(count for site, count in sites[rung]
                       if kint8.plan_conv(*site[:6]).split > 1)
               for rung, n in by_rung.items())


def int8_inputs(torch, layers, run, out=False):
    """Each quantized layer's input during ``run()``, on the host (and
    ``run()``'s result, with ``out``)."""
    seen = {}

    def hook(name):
        def fn(block, inputs, output):  # noqa: ARG001
            seen[name] = inputs[0].detach().cpu()
        return fn

    handles = [layer.register_forward_hook(hook(name))
               for name, layer in layers]
    result = run()
    for h in handles:
        h.remove()
    return (seen, result.cpu()) if out else seen


def int8_code_flips(torch, layers, card_in, cpu_in):
    """Of every quantized layer's input codes (each net's input quantized
    with the layer's range by Q1's plain version): how many differ between
    the card and the CPU, the largest difference, the first layer where
    any does and its share there."""
    from mxnet_tpu_torch.kernels import int8 as kint8

    differ = total = largest = 0
    first = None
    for name, layer in layers:
        lohi = layer._lohi.cpu()
        a = kint8.quantize_reference(card_in[name], lohi, True)[0].int()
        b = kint8.quantize_reference(cpu_in[name], lohi, True)[0].int()
        d = (a - b).abs()
        n = int((d > 0).sum())
        differ += n
        total += d.numel()
        largest = max(largest, int(d.max()))
        if n and first is None:
            first = dict(layer=name, share=n / d.numel(),
                         largest=int(d.max()))
    return dict(differ=differ, codes=total, share=differ / total,
                largest=largest, first_layer=first)


def int8_layer_check(torch, layers, run):
    """Every quantized layer in ``run()`` (an eager forward on the card at
    a rung's batch), on its own input there: Q1's codes and (-amax, amax,
    scale) against its plain version, Q2's int32 sums of those codes
    against the float64 convolution (cuDNN off), and the layer's output
    against the plain epilogue of those sums. Returns the worst of each
    (all 0 when bit for bit) and how many layers were held."""
    from mxnet_tpu_torch.contrib import quantization as qz
    from mxnet_tpu_torch.kernels import int8 as kint8

    worst = dict(layers=0, q1_codes=0, q1_info=0.0, q2_acc=0, out_ulps=0)

    def hook(block, inputs, y):
        x, wq, lohi = inputs[0], block._wq, block._lohi
        args = (1, 0, 1, 1)
        if isinstance(block, qz.QuantizedDense):   # a 1x1 convolution
            x = x.reshape(x.shape[0], -1, 1, 1)
            wq = wq.view(*wq.shape, 1, 1)
            y = y.reshape(y.shape[0], -1, 1, 1)
        else:
            args = (block._strides, block._padding, block._dilation,
                    block._groups)
        codes, info = kint8.quantize(x, lohi, clip=True)
        want_codes, want_info = kint8.quantize_reference(x, lohi, True)
        acc = kint8.conv(codes, wq, *args)
        with torch.backends.cudnn.flags(enabled=False):
            want_acc = kint8.conv_reference(want_codes, wq, *args)
        want_y = kint8._epilogue(want_acc, want_info[2:3], block._wscale,
                                 block._bias, block._activation == "relu")
        worst["layers"] += 1
        worst["q1_codes"] = max(worst["q1_codes"], int(
            (codes.int() - want_codes.int()).abs().max()))
        worst["q1_info"] = max(worst["q1_info"],
                               float((info - want_info).abs().max()))
        worst["q2_acc"] = max(worst["q2_acc"], int(
            (acc.long() - want_acc.long()).abs().max()))
        ulps = (y.view(torch.int32).long()
                - want_y.view(torch.int32).long()).abs()
        worst["out_ulps"] = max(worst["out_ulps"], int(
            torch.where(y == want_y, 0, ulps).max()))

    handles = [layer.register_forward_hook(hook) for _, layer in layers]
    try:
        run()
    finally:
        for h in handles:
            h.remove()
    return worst


#: the kernel groups of a replay's profile: Q1 and Q2's kernels by name
#: (csrc/int8_quant.cu, csrc/int8_conv_wgmma.cu, csrc/int8_conv.cu), the
#: f32 layers' PyTorch kernels by the layer that launched them
INT8_KERNEL_NAMES = (
    ("q1", r"quantize(_nhwc)?_kernel"),
    ("q2_wgmma", r"conv_wgmma_kernel"),
    ("q2_splitk", r"splitk_epilogue_kernel"),
    ("q2_gather", r"(^|::|\s)conv_kernel\b"),
)
INT8_LAYER_GROUPS = {
    "BatchNorm": "batchnorm", "MaxPool2D": "pooling",
    "GlobalAvgPool2D": "pooling", "Activation": "relu",
    "QuantizedConv2D": "int8_other", "QuantizedDense": "int8_other",
    "Conv2D": "conv_f32", "Dense": "dense_f32", "Flatten": "other"}
#: a kernel launched outside every layer: the residual add, the ReLU after
#: it, the input's copy into the captured graph
INT8_LOOSE_NAMES = (("add", r"(?i)add"), ("relu", r"(?i)relu|clamp|threshold"),
                    ("copy", r"(?i)copy|memcpy"))


def int8_name_group(name, table):
    """The first group of ``table`` whose pattern the kernel's name holds."""
    for group, pattern in table:
        if re.search(pattern, name):
            return group
    return None


def int8_window_kernels(torch, prof):
    """The device kernels (and copies) of a profiler window in order, the
    marker's and those before it dropped (:func:`int8_window_marker`), and
    no synchronisation the profiler records on the device, nor the device
    span of a named range (:func:`int8_kernel_sequence`'s layers)."""
    ev = sorted((e for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and not re.search(r"(?i)sync", e.name)
                 and not e.name.startswith("int8group:")),
                key=lambda e: e.time_range.start)
    marks = [i for i, e in enumerate(ev) if "arange" in e.name]
    return ev[marks[-1] + 1:] if marks else ev


def int8_window_marker(torch, dev):
    """A kernel that opens a profiler window: the profiler has been seen to
    lose the first kernels launched after it starts (the stem's Q1 and Q2,
    on the H100), so a window opens with this marker and drops it after."""
    torch.arange(2, device=dev)
    torch.cuda.synchronize()


def int8_kernel_sequence(torch, net, x):
    """Every device kernel of one eager forward of ``net`` on ``x``, in
    order, as ``(name, group, us)``: Q1's and Q2's by name, the rest by the
    layer that launched it (each layer bracketed by synchronisations and a
    named profiler range, so that its kernels fall inside its range), else
    by name (:data:`INT8_LOOSE_NAMES`)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    open_ranges = []

    def pre(block, inputs):  # noqa: ARG001
        torch.cuda.synchronize()
        rf = record_function("int8group:" + INT8_LAYER_GROUPS[
            type(block).__name__])
        rf.__enter__()
        open_ranges.append(rf)

    def post(block, inputs, out):  # noqa: ARG001
        torch.cuda.synchronize()
        open_ranges.pop().__exit__(None, None, None)

    handles = []
    for m in net.modules():
        if type(m).__name__ in INT8_LAYER_GROUPS:
            handles += [m.register_forward_pre_hook(pre),
                        m.register_forward_hook(post)]
    try:
        net(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            int8_window_marker(torch, x.device)
            net(x)
            torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    spans = [(e.time_range.start, e.time_range.end, e.name.split(":", 1)[1])
             for e in prof.events() if e.name.startswith("int8group:")]
    seq = []
    for e in int8_window_kernels(torch, prof):
        group = int8_name_group(e.name, INT8_KERNEL_NAMES)
        if group is None:
            inside = [g for a, b, g in spans
                      if a <= e.time_range.start <= b]
            group = inside[-1] if inside else (
                int8_name_group(e.name, INT8_LOOSE_NAMES) or "other")
        seq.append((e.name, group, e.time_range.elapsed_us()))
    return seq


def int8_groups(seq):
    """``{group: {"kernels": n, "ms": x}}`` of a kernel sequence."""
    out = {}
    for _, group, us in seq:
        g = out.setdefault(group, dict(kernels=0, ms=0.0))
        g["kernels"] += 1
        g["ms"] += us / 1e3
    return out


def int8_align(eager, ev):
    """The groups of a replay's kernels ``ev`` by position: a graph replays
    the kernels of the forward it captured in the order they were launched,
    so the replay's names are aligned in order with those of an eager
    forward (``eager``, :func:`int8_kernel_sequence`; difflib's matching
    blocks, each name equal to its partner's) and each aligned kernel takes
    its partner's group. A kernel left over goes by name. Returns
    ``(seq, aligned, loose, eager_only)``: the replay as ``(name, group,
    us)``, the count aligned, the leftover replay kernels' groups and the
    unaligned eager kernels' groups as counts."""
    import difflib

    sm = difflib.SequenceMatcher(None, [n for n, _, _ in eager],
                                 [e.name for e in ev], autojunk=False)
    at = {}
    for a, b, size in sm.get_matching_blocks():
        for i in range(size):
            at[b + i] = a + i
    seq, loose = [], {}
    for j, e in enumerate(ev):
        if j in at:
            group = eager[at[j]][1]
        else:
            group = (int8_name_group(e.name, INT8_KERNEL_NAMES)
                     or int8_name_group(e.name, INT8_LOOSE_NAMES)
                     or "other")
            loose[group] = loose.get(group, 0) + 1
        seq.append((e.name, group, e.time_range.elapsed_us()))
    eager_only = {}
    for i in sorted(set(range(len(eager))) - set(at.values())):
        eager_only[eager[i][1]] = eager_only.get(eager[i][1], 0) + 1
    return seq, len(at), loose, eager_only


def int8_replay_profile(torch, net, batch=INT8_BATCH):
    """One replay of ``net``'s captured rung of ``batch`` under the
    profiler: the device ms of its kernels in all, split by kernel group
    (Q1, each Q2 variant, BatchNorm, pooling, ReLU, the residual adds, the
    input copy, the f32 convolutions of an fp32 net) by each kernel's
    position against an eager forward (:func:`int8_align`); the split is
    ``split_complete`` where every replayed kernel but the input's and the
    output's copies was aligned and the window is complete. The window
    opens with :func:`int8_window_marker`; Q1's and Q2's ms, counts and
    shares, and whether the window holds a Q1 and a Q2 kernel of every
    quantized layer (late in the smoke the profiler drops events now and
    then, PERF.md section 7: up to three windows are taken for one that
    does); None where the profiler recorded no device activity. The eager
    forward's own split (``eager_groups``, each kernel in the layer range
    that launched it) beside it."""
    from torch.profiler import ProfilerActivity, profile

    from mxnet_tpu_torch.tools import int8_inference as ii

    layers = len(ii.int8_layers(net))
    x = torch.rand((batch,) + ii.IMAGE, device=net.device)
    with torch.inference_mode():
        eager = int8_kernel_sequence(torch, net, x)
    net.call_cached_graph(x)
    torch.cuda.synchronize()
    out = None
    for window in range(3):
        TIMING["profiler_windows"] += 1
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            int8_window_marker(torch, x.device)
            net.call_cached_graph(x)
            torch.cuda.synchronize()
        ev = int8_window_kernels(torch, prof)
        if not ev:
            TIMING["empty_windows"] += 1
            continue
        seq, aligned, loose, eager_only = int8_align(eager, ev)
        groups = int8_groups(seq)
        out = dict(window=window + 1, kernels=len(ev), device_ms=sum(
            e.time_range.elapsed_us() for e in ev) / 1e3, groups=groups,
            aligned=aligned, loose=loose, eager_kernels=len(eager),
            eager_only=eager_only, eager_groups=int8_groups(eager),
            other_kernels=sorted({n[:160] for n, g, _ in seq
                                  if g == "other"}))
        q2 = ("q2_wgmma", "q2_gather")
        for key, names in (("q1", ("q1",)), ("q2", q2 + ("q2_splitk",))):
            out[key + "_kernels"] = sum(groups.get(n, {}).get("kernels", 0)
                                        for n in names)
            out[key + "_ms"] = sum(groups.get(n, {}).get("ms", 0.0)
                                   for n in names)
            out[key + "_share"] = out[key + "_ms"] / out["device_ms"]
        q2_launches = sum(groups.get(n, {}).get("kernels", 0) for n in q2)
        out["complete"] = out["q1_kernels"] == q2_launches == layers
        out["split_complete"] = out["complete"] and set(loose) <= {"copy"}
        if out["complete"]:
            break
    return out


def phase_int8_serving(torch, mt):
    """25b: config #5 served (``tools/int8_inference.py``): ResNet-50 v1 f32
    NCHW from seed 0, entropy-calibrated over 4 batches of 8 and quantized
    (53 QuantizedConv2D, 1 QuantizedDense), served through InferenceEngine
    with captured rungs 1, 8 and 32: the counts zeroed just before the
    requests and read just after, Q1 and Q2 each 54 times a batch (from the
    rungs' replays), every rung dispatched at least once, no capture and no
    new signature after warmup, every result finite and within 1e-4 of its
    largest logit of an eager forward of its own rows on the card; at each
    rung's batch, every quantized layer's Q1, Q2 and output bit for bit
    their plain versions on its own input on the card
    (:func:`int8_layer_check`); 8 images' logits against the same
    quantized net on the CPU (the kernels' plain versions) with the card's
    calibrated ranges, within INT8_TWIN_TOL of the largest, the same
    top-1, the int8 codes that differ counted; int8 against
    fp32 top-1 agreement over 8 batches of 32 (random weights: printed, no
    gate); the forwards at batch 32, int8 and fp32, each a captured
    rung, and one replay of each under the profiler (Q1's and Q2's share
    of the int8 forward's device time)."""
    from mxnet_tpu_torch.kernels import int8 as kint8
    from mxnet_tpu_torch.tools import int8_inference as ii

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    fp32, net, info = ii.build_int8_resnet50(dev, 0, 4, 8, "entropy")
    check(info["swapped"] == {"QuantizedConv2D": 53, "QuantizedDense": 1},
          f"config #5: swapped {info['swapped']}")
    say(f"int8 calibration: {json.dumps(info)}")
    results, served = ii.serve(net, INT8_REQUESTS)
    check(served["warmup"]["graphs"] == dict.fromkeys(ii.RUNGS, 1),
          f"int8 warmup: one graph a rung, got {served['warmup']}")
    check(served["outcomes"] == {"ok": INT8_REQUESTS},
          f"int8 serving outcomes {served['outcomes']}")
    check(served["captures_after_warmup"] == 0
          and served["recompiles_since_warmup"] == 0,
          f"int8 serving captured or traced online: {served}")
    from mxnet_tpu_torch.gluon.model_zoo import vision

    # Q1 and Q2 54 times a batch; of Q2, the stem on the gather variant
    # and the 53 others on wgmma; a split-K epilogue launch for each site
    # the plan splits at the rung that served the batch
    nb = served["batches"]
    want = {kint8.KERNEL_QUANT: 54 * nb, kint8.KERNEL_CONV_WGMMA: 53 * nb,
            kint8.KERNEL_CONV_GATHER: nb,
            kint8.KERNEL_CONV_SPLITK: int8_split_launches(
                torch, mt, vision, dev, served["by_rung"])}
    check(served["launches"] == want and nb > 0,
          f"int8 launches {served['launches']} != {want} over {nb} "
          f"batches")
    check(sum(served["by_rung"].values()) == served["batches"]
          and all(served["by_rung"].get(r, 0) > 0 for r in ii.RUNGS),
          f"int8 serving: every rung serves, got {served['by_rung']}")
    worst = 0.0
    with mt.autograd.pause(), torch.inference_mode():
        for x, res in results:
            check(tuple(res.shape) == (len(x), 1000)
                  and bool(torch.isfinite(res).all()),
                  "an int8 result's shape or values")
            ref = net(torch.from_numpy(x).to(dev))
            err = (res - ref).abs().max().item()
            check(err <= 1e-4 * max(1.0, ref.abs().max().item()),
                  f"an int8 result differs from its direct forward: {err}")
            worst = max(worst, err)
        gen = torch.Generator().manual_seed(26)
        layers, gen_rungs = {}, torch.Generator().manual_seed(27)
        for b in ii.RUNGS:
            xb = torch.rand((b,) + ii.IMAGE, generator=gen_rungs).to(dev)
            layers[b] = int8_layer_check(torch, ii.int8_layers(net),
                                         partial(net, xb))
        check(all(w["layers"] == 54 and w["q1_codes"] == w["q2_acc"]
                  == w["out_ulps"] == 0 and w["q1_info"] == 0.0
                  for w in layers.values()),
              f"int8 layers at the rungs differ from their plain versions: "
              f"{layers}")
        x8 = torch.rand((INT8_TWIN_IMAGES,) + ii.IMAGE, generator=gen)
        got = net.call_cached_graph(x8.to(dev)).cpu()
        twin = ii.cpu_twin(net, fp32)
        card_in = int8_inputs(torch, ii.int8_layers(net),
                              lambda: net(x8.to(dev)))
        cpu_in, ref = int8_inputs(torch, ii.int8_layers(twin),
                                  lambda: twin(x8), out=True)
    flips = int8_code_flips(torch, ii.int8_layers(twin), card_in, cpu_in)
    scale = ref.abs().max().item()
    twin_err = (got - ref).abs().max().item()
    top1 = bool((got.argmax(-1) == ref.argmax(-1)).all())
    check(twin_err <= INT8_TWIN_TOL * scale and top1,
          f"int8 logits on the card differ from the CPU twin's by "
          f"{twin_err} (largest {scale}; top-1 equal {top1}; codes {flips})")
    del twin
    agree = ii.agreement(fp32, net)
    times = dict(int8_forward_ms_batch32=ii.forward_ms(net),
                 fp32_forward_ms_batch32=ii.forward_ms(fp32),
                 int8_forward_ms_batch32_again=ii.forward_ms(net),
                 fp32_forward_ms_batch32_again=ii.forward_ms(fp32))
    profiles = dict(int8=int8_replay_profile(torch, net),
                    fp32=int8_replay_profile(torch, fp32))
    out = dict(calibration=info, serving=served,
               results_max_abs_err_vs_direct=worst, layers_at_rungs=layers,
               replay_profile=profiles,
               twin=dict(images=INT8_TWIN_IMAGES, max_abs_err=twin_err,
                         max_abs_logit=scale, tol=INT8_TWIN_TOL * scale,
                         code_flips=flips,
                         top1_equal=top1),
               agreement_top1=agree, seconds=time.perf_counter() - t0,
               **times)
    del fp32, net
    gc_collect(torch)
    return out


def phase_int8(torch, mt, build, vision):
    """Phase 25 (module note): 25a, 25b, 25c."""
    from mxnet_tpu_torch.kernels import int8 as kint8
    from mxnet_tpu_torch.tools import quantize_int8

    t0 = time.perf_counter()
    kernels = phase_int8_kernels(torch, mt, vision)
    serving = phase_int8_serving(torch, mt)
    # 25c: the example on the card, its own gate
    build.reset_counters()
    try:
        example = quantize_int8.main([])
    except SystemExit as e:
        fail(f"tools/quantize_int8.py: {e}")
    example = dict(fp32_acc=example["fp32_acc"], int8_acc=example["int8_acc"],
                   launches={c.name: c.value for c in (
                       kint8.LAUNCHES_QUANT, kint8.LAUNCHES_CONV_WGMMA,
                       kint8.LAUNCHES_CONV_GATHER,
                       kint8.LAUNCHES_CONV_SPLITK)})
    check(example["launches"][kint8.KERNEL_QUANT]
          and kint8.conv_launches(),
          f"the int8 example launched no int8 kernel: {example}")
    seconds = time.perf_counter() - t0
    tot = kernels["total"]
    prof = serving["replay_profile"]["int8"] or {}
    groups = prof.get("groups", {})
    say(f"int8: config #5, ResNet-50 v1 NCHW served in int8 "
        f"(calibration {serving['calibration']['calib_host_s']:.1f} host s, "
        f"{serving['serving']['batches']} batches, by rung "
        f"{serving['serving']['by_rung']}, launches "
        f"{serving['serving']['launches']}); a rung-32 "
        f"replay's device ms {prof.get('device_ms')}, Q1 "
        f"{prof.get('q1_ms')}, Q2 {prof.get('q2_ms')} (every kernel in "
        f"the window: {prof.get('complete')}; by group "
        f"{ {g: round(v['ms'], 4) for g, v in groups.items()} }"
        f", {prof.get('aligned')} of {prof.get('kernels')} aligned with an "
        f"eager forward's {prof.get('eager_kernels')}, split complete "
        f"{prof.get('split_complete')}); forward at "
        f"batch {INT8_BATCH}: int8 {serving['int8_forward_ms_batch32']:.3f} "
        f"ms, fp32 {serving['fp32_forward_ms_batch32']:.3f} ms; the 54 "
        f"sites: Q1 {tot['q1_ms']:.3f} ms alone (bound "
        f"{tot['q1_bound_ms']:.3f}; the flat NCHW pass "
        f"{tot['q1_flat_ms']:.3f}), Q2 {tot['q2_ms']:.3f} ms alone (bound "
        f"{tot['q2_bound_ms']:.3f}; the gather variant at every site "
        f"{tot['q2_gather_ms']:.3f}; cuDNN f32 {tot['cudnn_f32_ms']:.3f}, "
        f"bf16 {tot['cudnn_bf16_ms']:.3f}); _int_mm at the Dense "
        f"{kernels['dense']['int_mm_ms']:.4f} ms against Q2's "
        f"{kernels['dense']['q2_ms']:.4f}; twin "
        f"{serving['twin']['max_abs_err']:.3g} of "
        f"{serving['twin']['max_abs_logit']:.3g}; agreement "
        f"{serving['agreement_top1']:.4f}; example fp32 "
        f"{example['fp32_acc']:.3f} int8 {example['int8_acc']:.3f}; phase "
        f"{seconds:.1f} s; card: {card_line()}")
    out = dict(kernels={k: v for k, v in kernels.items() if k != "per_site"},
               serving=serving, example=example, seconds=seconds)
    say("int8 " + json.dumps(out))
    return out


# -- the checkpoint manager on BERT-base fine-tuning (phase 26) --------------

CKPT_STEPS = 6   # the uninterrupted run's steps
CKPT_AT = 3      # the step committed before the kill
CKPT_PREEMPT_CODE = 75   # the preempted worker's MXTPU_CKPT_PREEMPT_EXIT_CODE
CKPT_SIGNALS = ("SIGTERM", "SIGUSR1")   # MXTPU_CKPT_PREEMPT_SIGNALS' default


def _ckpt_build(finetune, dev, model_kwargs):
    """BERT-base QA fine-tuning as the smoke's other BERT paths: bf16 with
    f32 masters, AdamW, batch 8, seq 384, dropout 0.1 (the fine-tune
    default), no global-norm clip, so each step is one CUDA graph on the
    card; the weights and the batch from seed 0."""
    return finetune.build_bert_finetune(
        batch=8, seq=384, dropout=0.1, dtype="bfloat16",
        learning_rate=TRAIN_LR, device=dev, seed=0, clip_global_norm=None,
        train_step=True, **model_kwargs)


def _state_digests(torch, kopt, net, trainer):
    """sha256 of every weight and every optimizer-state leaf (f32 masters,
    AdamW's m and v), over their bytes on the host."""
    import hashlib

    tensors = [p._tensor() for p in net.collect_params().values()]
    tensors += [x for s in trainer._states for x in kopt._leaves(s)]
    out = []
    for t in tensors:
        t = t.detach().contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        out.append(hashlib.sha256(t.cpu().numpy()).hexdigest())
    return out


def _block_signals():
    """Block the preemption signals in this thread and every thread it
    starts later. Call before anything starts a thread: a signal that
    another thread left unblocked would be delivered there, and its Python
    handler would run on the main thread at any bytecode, mid-step."""
    import signal

    signal.pthread_sigmask(signal.SIG_BLOCK,
                           [getattr(signal, s) for s in CKPT_SIGNALS])


def _steps_between_signals(torch, step, n, done):
    """n TrainStep calls with the preemption signals blocked
    (:func:`_block_signals`) except for an instant between two steps, when a
    pending signal's handler runs (``signal.pthread_sigmask`` runs it before
    it returns): a preemption saves between steps. ``done[0]`` counts the
    steps completed."""
    import signal

    sigs = [getattr(signal, s) for s in CKPT_SIGNALS]
    for _ in range(n):
        _resume_steps(torch, step.func, step.args, 1)
        done[0] += 1
        signal.pthread_sigmask(signal.SIG_UNBLOCK, sigs)
        signal.pthread_sigmask(signal.SIG_BLOCK, sigs)


def ckpt_worker(mode, workdir, model_kwargs):
    """``--ckpt-worker MODE DIR KWARGS``: a process of phase 26 (its
    docstring), on ``cuda:0``, building the attention and ladder kernels
    (already built by the parent: loaded from build/kernels). It writes
    DIR/<mode>.json; the checkpoints go to DIR/../ck (kill, resume) or
    DIR/ck (preempt)."""
    if mode == "preempt":
        _block_signals()   # before torch starts its threads
    import torch

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.checkpoint import manager as mgr_mod
    from mxnet_tpu_torch.kernels import build, opt as kopt
    from mxnet_tpu_torch.tools import finetune

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build(["flash_attention_fwd", "flash_attention_bwd", "opt_ladder"])
    workdir = Path(workdir)
    kwargs = json.loads(model_kwargs)
    net, trainer, step = _ckpt_build(finetune, mt.gpu(0), kwargs)
    ts = step.func
    report = {}

    def write(**kw):
        report.update(kw)
        (workdir / f"{mode}.json").write_text(json.dumps(report))

    if mode == "kill":
        mgr = mt.checkpoint.CheckpointManager(workdir.parent / "ck",
                                              trainer)
        losses = _resume_steps(torch, ts, step.args, CKPT_AT)
        mgr.save(step=CKPT_AT)
        mgr.flush()                   # committed: the resume target
        losses += _resume_steps(torch, ts, step.args, 2)
        held = []

        def hold(path):               # on the IO thread
            held.append(path)
            time.sleep(600)           # the parent SIGKILLs us first

        mgr_mod._WRITE_BEGIN_HOOK = hold
        t0 = time.perf_counter()
        mgr.save(step=CKPT_AT + 2)
        save_s = time.perf_counter() - t0
        while not held:
            time.sleep(0.01)
        # a step while the write is held open on the IO thread
        losses += _resume_steps(torch, ts, step.args, 1)
        write(losses=losses, held=held[0], save_returned_s=save_s,
              last_path=ts.last_path, captures=ts.jit_trace_count())
        time.sleep(600)               # killed here
        return 1
    if mode == "resume":
        mgr = mt.checkpoint.CheckpointManager(workdir.parent / "ck",
                                              trainer)
        ck = workdir.parent / "ck"
        tmp_left = sorted(n for n in os.listdir(ck) if n.startswith(".tmp-"))
        latest = mgr.latest_step()
        t0 = time.perf_counter()
        result = mgr.restore()
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        build.reset_counters()
        losses = _resume_steps(torch, ts, step.args, CKPT_STEPS - result.step)
        launches = {c.name: c.value for c in build.COUNTERS.values()
                    if c.value}
        want = _want_launches(kopt, trainer, CKPT_STEPS - result.step, False,
                              kwargs.get("num_layers", 12))
        write(step=result.step, latest=latest, tmp_left=tmp_left,
              losses=losses, launches=launches, want_launches=want,
              restore_s=restore_s, last_path=ts.last_path,
              captures=ts.jit_trace_count(),
              digests=_state_digests(torch, kopt, net, trainer))
        return 0
    if mode == "preempt":
        mgr = mt.checkpoint.CheckpointManager(workdir / "ck", trainer)
        done = [0]
        mt.checkpoint.install_preemption_handler(
            mgr, user_state_fn=lambda: {"next_step": done[0] + 1})
        _steps_between_signals(torch, step, 2, done)
        write(ready=True)
        _steps_between_signals(torch, step, 10000, done)  # SIGTERM first
        return 3
    fail(f"--ckpt-worker: unknown mode {mode!r}")


def _ckpt_start(mode, workdir, model_kwargs, env=None):
    """Start ``chip_smoke.py --ckpt-worker`` in its own directory, its
    output there too."""
    workdir.mkdir(parents=True)
    log = open(workdir / "log.txt", "wb")  # noqa: SIM115 - closed by _ckpt_end
    proc = subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--ckpt-worker",
         mode, str(workdir), json.dumps(model_kwargs)],
        stdout=log, stderr=subprocess.STDOUT,
        env=dict(os.environ, **(env or {})))
    proc.log, proc.workdir, proc.mode = log, workdir, mode
    return proc


def _ckpt_report(proc):
    path = proc.workdir / f"{proc.mode}.json"
    return json.loads(path.read_text()) if path.exists() else {}


def _ckpt_tail(proc):
    return (proc.workdir / "log.txt").read_text(errors="replace")[-3000:]


def _ckpt_wait_report(proc, key, timeout=600):
    """Wait until the worker's report holds ``key``; fail if it exits
    first."""
    deadline = time.time() + timeout
    while key not in _ckpt_report(proc):
        if proc.poll() is not None:
            fail(f"checkpoint worker {proc.mode} exited {proc.returncode} "
                 f"early: {_ckpt_tail(proc)}")
        check(time.time() < deadline,
              f"checkpoint worker {proc.mode} never wrote {key}")
        time.sleep(0.05)
    return _ckpt_report(proc)


def _ckpt_end(proc, timeout=600):
    """The worker's exit code (killed first if it is still running after
    ``timeout``); its log is closed."""
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=60)
    proc.log.close()
    return proc.returncode


def _median_ms(seconds):
    return statistics.median(seconds) * 1e3


def phase_checkpoint(torch, mt, finetune, build, kopt, dev, **model_kwargs):
    """26. The checkpoint manager on BERT-base fine-tuning at dropout 0.1
    through TrainStep's graph (``model_kwargs`` cut it:
    tests/test_torch_cuda_checkpoint.py).

    A (this process): CKPT_STEPS steps from seed 0, their losses and the
    digests of every weight, master and moment after them. B (a worker):
    the same steps with an async save at CKPT_AT, committed, two more
    steps, a second async save that ``_WRITE_BEGIN_HOOK`` holds open, a
    step while it is held; then SIGKILL. C (a fresh worker): the latest
    committed step must be CKPT_AT and the killed write's tmp dir reaped;
    it restores, takes the remaining steps with the counts zeroed just
    before and read just after (K3 once per bucket, K4, K5a, K5b once per
    layer, a step), and its losses and digests must equal A's bit for bit,
    dropout masks included. Then this process restores CKPT_AT into A's
    live, captured TrainStep: the replays equal A's steps bit for bit with
    no new capture. P (a worker, started with B): SIGTERM between steps
    under ``install_preemption_handler`` must exit with
    MXTPU_CKPT_PREEMPT_EXIT_CODE and leave a committed ``preempt``
    checkpoint that ``python -m mxnet_tpu_torch.tools.ckpt verify`` passes.
    Numbers on A's net: bytes a checkpoint, the snapshot's device-to-host
    copy and its crc32 ms, the async save's return, write + commit and
    restore ms, and step ms with no save in flight and with one in
    flight."""
    import signal
    import tempfile
    import threading as _threading

    from mxnet_tpu_torch.checkpoint import manager as ckmgr
    from mxnet_tpu_torch.checkpoint import snapshot as cksnap

    gc_collect(torch)
    t_phase = time.perf_counter()
    layers = model_kwargs.get("num_layers", 12)
    out = dict(card=card_line(), steps=CKPT_STEPS, committed_at=CKPT_AT)
    root = Path(__file__).resolve().parent / "build" / "scratch"
    root.mkdir(parents=True, exist_ok=True)
    procs = []
    with tempfile.TemporaryDirectory(prefix="ckpt_", dir=root) as tmp:
        tmp = Path(tmp)
        try:
            # B and P first: a process takes seconds to reach the card
            b = _ckpt_start("kill", tmp / "b" / "w", model_kwargs)
            p = _ckpt_start("preempt", tmp / "p", model_kwargs, env={
                "MXTPU_CKPT_PREEMPT_EXIT_CODE": str(CKPT_PREEMPT_CODE)})
            procs += [b, p]

            # A: the uninterrupted run
            net, trainer, step = _ckpt_build(finetune, dev, model_kwargs)
            ts = step.func
            losses_a = _resume_steps(torch, ts, step.args, CKPT_STEPS)
            check(ts.last_path == "whole_step" and ts.jit_trace_count() == 1,
                  f"A ran {ts.last_path} with {ts.jit_trace_count()} "
                  f"captures: {ts.ineligible_reason()}")
            digests_a = _state_digests(torch, kopt, net, trainer)
            out["losses_a"] = losses_a

            # B: killed in the middle of its second write
            rep_b = _ckpt_wait_report(b, "held")
            b.kill()
            check(_ckpt_end(b) == -signal.SIGKILL,
                  f"B exited {b.returncode}: {_ckpt_tail(b)}")
            ck = tmp / "b" / "ck"
            check(rep_b["losses"] == losses_a[:CKPT_AT + 3],
                  f"B's steps differ from A's: {rep_b['losses']} "
                  f"{losses_a}")
            check(sorted(os.listdir(ck)) == [
                f".tmp-step-{CKPT_AT + 2:08d}", f"step-{CKPT_AT:08d}"],
                f"B left {sorted(os.listdir(ck))}")
            out["b"] = dict(save_returned_s=rep_b["save_returned_s"],
                            ck=sorted(os.listdir(ck)))

            # C: resumes in a fresh process
            c = _ckpt_start("resume", tmp / "b" / "c", model_kwargs)
            procs.append(c)

            # P: SIGTERM between steps
            _ckpt_wait_report(p, "ready")
            p.send_signal(signal.SIGTERM)
            code = _ckpt_end(p)
            check(code == CKPT_PREEMPT_CODE,
                  f"the preempted worker exited {code}, not "
                  f"{CKPT_PREEMPT_CODE}: {_ckpt_tail(p)}")
            verify = subprocess.run(
                [sys.executable, "-m", "mxnet_tpu_torch.tools.ckpt",
                 "verify", str(tmp / "p" / "ck"), "--json"],
                capture_output=True, text=True, timeout=600,
                cwd=Path(__file__).resolve().parent)
            check(verify.returncode == 0,
                  f"tools/ckpt.py verify: {verify.returncode} "
                  f"{verify.stdout[-2000:]} {verify.stderr[-2000:]}")
            report = json.loads(verify.stdout)
            manifest = json.loads((tmp / "p" / "ck" /
                                   f"step-{report['step']:08d}" /
                                   "MANIFEST.json").read_text())
            nxt = manifest["meta"]["user_state"]["next_step"]
            check(manifest["reason"] == "preempt" and
                  manifest["meta"]["optimizer"]["num_update"] == nxt - 1
                  == manifest["step"] >= 2,
                  f"the preempt checkpoint: {manifest['reason']} at step "
                  f"{manifest['step']}, {manifest['meta']['user_state']}, "
                  f"{manifest['meta']['optimizer']['num_update']}")
            out["preempt"] = dict(exit_code=code, verify=report,
                                  next_step=nxt)

            code = _ckpt_end(c)
            rep_c = _ckpt_report(c)
            check(code == 0 and rep_c, f"C exited {code}: {_ckpt_tail(c)}")
            out["c"] = {k: v for k, v in rep_c.items() if k != "digests"}
            check(rep_c["latest"] == rep_c["step"] == CKPT_AT
                  and rep_c["tmp_left"] == [],
                  f"C restored {rep_c['step']} (latest {rep_c['latest']}, "
                  f"tmp left {rep_c['tmp_left']})")
            same = rep_c["digests"] == digests_a
            out["resumed_equals_uninterrupted"] = same
            check(same and rep_c["losses"] == losses_a[CKPT_AT:],
                  f"C differs from A: losses {rep_c['losses']} and "
                  f"{losses_a[CKPT_AT:]}, "
                  f"{sum(x != y for x, y in zip(rep_c['digests'], digests_a))}"
                  f" of {len(digests_a)} tensors")
            check(rep_c["last_path"] == "whole_step" and
                  rep_c["captures"] == 1, f"C ran {rep_c['last_path']}")
            if dev.type == "cuda":
                check(rep_c["launches"] == rep_c["want_launches"],
                      f"C's steps launched {rep_c['launches']}; want "
                      f"{rep_c['want_launches']}")

            # restore into A's live graph: no capture, the same replays
            mgr = mt.checkpoint.CheckpointManager(ck, trainer)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mgr.restore()
            torch.cuda.synchronize()
            restore_ms = (time.perf_counter() - t0) * 1e3
            build.reset_counters()
            losses_r = _resume_steps(torch, ts, step.args,
                                     CKPT_STEPS - CKPT_AT)
            launches_r = {x.name: x.value for x in build.COUNTERS.values()
                          if x.value}
            same_r = _state_digests(torch, kopt, net, trainer) == digests_a
            check(same_r and losses_r == losses_a[CKPT_AT:],
                  f"replays after a restore into the live graph differ: "
                  f"{losses_r} {losses_a[CKPT_AT:]}")
            check(ts.jit_trace_count() == 1 and ts.last_path == "whole_step",
                  f"the restore made TrainStep capture again: "
                  f"{ts.jit_trace_count()}, {ts.last_path}")
            want = _want_launches(kopt, trainer, CKPT_STEPS - CKPT_AT,
                                  False, layers)
            check(launches_r == want or dev.type != "cuda",
                  f"the replays launched {launches_r}; want {want}")
            out["live"] = dict(losses=losses_r, bitwise=same_r,
                               captures=ts.jit_trace_count(),
                               launches=launches_r, restore_ms=restore_ms)

            # numbers: the snapshot's copy and crc32, the save, a step
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            arrays, _ = cksnap.capture(trainer)
            copy_ms = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            for a in arrays.values():
                ckmgr._crc(a)
            crc_ms = (time.perf_counter() - t0) * 1e3
            nbytes = sum(ckmgr._bits(a)[0].nbytes for a in arrays.values())
            del arrays
            idle = _run_steps(torch, lambda: ts(*step.args), 5)[1]
            tmgr = mt.checkpoint.CheckpointManager(tmp / "t", trainer,
                                                   keep_last=1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tmgr.save(step=CKPT_STEPS + 5)
            t1 = time.perf_counter()
            done = []
            flusher = _threading.Thread(
                target=lambda: (tmgr.flush(), done.append(
                    time.perf_counter())))
            flusher.start()
            busy = []
            while not done and len(busy) < 200:
                busy += _run_steps(torch, lambda: ts(*step.args), 1)[1]
            flusher.join()
            check(bool(done), "the timed save did not land")
            check(tmgr.steps() == [CKPT_STEPS + 5], f"{tmgr.steps()}")
            out["numbers"] = dict(
                bytes=nbytes, capture_copy_ms=copy_ms, capture_crc32_ms=crc_ms,
                save_returned_ms=(t1 - t0) * 1e3,
                write_commit_ms=(done[0] - t1) * 1e3, restore_ms=restore_ms,
                c_restore_ms=rep_c["restore_s"] * 1e3,
                step_ms_idle=_median_ms(idle),
                step_ms_save_in_flight=_median_ms(busy),
                steps_in_flight=len(busy))
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                _ckpt_end(proc)
    del net, trainer, step, ts
    out["phase_s"] = time.perf_counter() - t_phase
    n = out["numbers"]
    say(f"checkpoint: {json.dumps(out)}")
    say(f"checkpoint numbers: {n['bytes']} bytes a checkpoint; capture "
        f"{n['capture_copy_ms']:.1f} ms device-to-host + "
        f"{n['capture_crc32_ms']:.1f} ms crc32; save returned in "
        f"{n['save_returned_ms']:.1f} ms, write + commit "
        f"{n['write_commit_ms']:.1f} ms after; restore "
        f"{n['restore_ms']:.1f} ms (fresh process {n['c_restore_ms']:.1f}); "
        f"step {n['step_ms_idle']:.2f} ms idle, "
        f"{n['step_ms_save_in_flight']:.2f} ms with a save in flight "
        f"({n['steps_in_flight']} steps); phase {out['phase_s']:.1f} s; "
        f"card {out['card']}")
    gc_collect(torch)
    return out


# -- sharding plans over mesh positions (phase 27) ----------------------------

SHARD_STEPS = 5      # 27a: steps under each plan, counted from 0
SHARD_MORE = 2       # 27c: steps after the save, resumed and uninterrupted
SHARD_REENTER = 7    # 27d: steps after the re-entry (warm-up, capture, five
                     # replays)
SHARD_TIMED = 3      # steps timed at the end of each run
SHARD_HYBRID = "dp=2,fsdp=2,tp=2"
SHARD_REENTRY = "dp=2,fsdp=2"
SHARD_GRAD_STEPS = 4  # 27a's gradient gate: steps at dropout 0 and lr 0,
                      # a fresh batch each (warm-up, capture, two replays)
SHARD_GRAD_LIMIT = 2.0 ** -4  # the gate: each tensor's first moment
                              # within this relative L2 gap of (i)'s
# the span head's bias: each sample's loss is a softmax over positions,
# which a shift of all its logits leaves as it is, so its gradient is zero
# in exact arithmetic and what any two runs hold there is rounding noise
# (its gap is printed, not gated)
SHARD_GRAD_EXEMPT = "span_classifier.bias"


def adam_step_bound(lr, steps, beta1=0.9, beta2=0.999):
    """How far two AdamW runs from the same weights can drift apart in
    ``steps`` steps of learning rate ``lr``, whatever their gradients: each
    step moves a weight by ``lr * (|m_hat| / (sqrt(v_hat) + eps) + wd |w|)``,
    and by Cauchy-Schwarz ``|m_hat| / sqrt(v_hat)`` is at most ``B_t = (1 -
    beta1) sqrt(1 - beta2^t) sqrt(S_t) / ((1 - beta1^t) sqrt(1 - beta2))``
    with ``S_t = sum_{j<t} (beta1^2 / beta2)^j`` (1 at t = 1, 1.0108 at t =
    5); the decay term contracts the difference. So the weights differ by
    at most ``2 lr sum_t B_t``."""
    total = 0.0
    for t in range(1, steps + 1):
        s = sum((beta1 * beta1 / beta2) ** j for j in range(t))
        total += ((1 - beta1) * math.sqrt(1 - beta2 ** t) * math.sqrt(s)
                  / ((1 - beta1 ** t) * math.sqrt(1 - beta2)))
    return 2.0 * lr * total


def _shard_build(finetune, dev, plan, model_kwargs, dropout=0.1,
                 lr=TRAIN_LR):
    """Phase 26's fine-tune (bf16 weights, f32 masters, AdamW at ``lr``,
    batch 8, seq 384, ``dropout``, no clip, TrainStep's graph), the
    weights, batch and noise generators from seed 0, under ``plan`` (a
    ShardingPlan, a
    function of the net that returns one, or None)."""
    return finetune.build_bert_finetune(
        batch=8, seq=384, dropout=dropout, dtype="bfloat16",
        learning_rate=lr, device=dev, seed=0, clip_global_norm=None,
        train_step=True, sharding_plan=plan, **model_kwargs)


def _shard_state(torch, net, trainer):
    """Clones of every weight and every optimizer-state leaf, by kind:
    weights, masters (multi-precision parameters' f32 copies), moments;
    logical values, gathered from the positions' blocks."""
    from mxnet_tpu_torch.gluon import _sharded

    out = {"weights": [p._tensor().detach().clone()
                       for p in net.collect_params().values()],
           "masters": [], "moments": []}
    for p, st in zip(trainer._params, trainer._states):
        full = _sharded.full_state(st)
        if full is None:
            continue
        mp = trainer.optimizer._is_mp_state(p._tensor(), full)
        leaves = _sharded._leaves(full)
        if mp:
            out["masters"].append(leaves[0].detach().clone())
            leaves = leaves[1:]
        out["moments"] += [x.detach().clone() for x in leaves]
    return out


def _shard_equal(torch, a, b):
    """{kind: bit for bit} of two :func:`_shard_state` snapshots."""
    return {k: len(a[k]) == len(b[k]) and all(
        x.dtype == y.dtype and torch.equal(x, y)
        for x, y in zip(a[k], b[k])) for k in a}


def _shard_steps(torch, build, step, n, count=False):
    """n TrainStep calls on the fixed batch: their per-sample losses (host
    lists), their synchronised host seconds and, with ``count``, the launch
    counts zeroed just before and read just after."""
    if count:
        build.reset_counters()
    losses, secs = [], []
    for _ in range(n):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step()
        losses.append(loss.float().cpu().tolist())
        secs.append(time.perf_counter() - t0)
    launches = {c.name: c.value for c in build.COUNTERS.values()
                if c.value} if count else None
    return losses, secs, launches


def _placed_launches(kopt, upd):
    """K3 launches of one placed update: each bucket's members (every
    position's blocks) by state count, a table of TABLE_CAPACITY a launch
    (kernels/opt.py:_launch_bucket_dev)."""
    total = 0
    for (_, mp), members in upd.buckets:
        by_state = {}
        for _j, w, st, _g in members:
            if w.numel():
                n = len(kopt._parts(mp, w, st)[1])
                by_state[n] = by_state.get(n, 0) + 1
        total += sum(-(-n // kopt.TABLE_CAPACITY) for n in by_state.values())
    return total


def _state_bytes(trainer):
    """Optimizer-state bytes at each position (mesh order), their sum, the
    unplaced total (each leaf's logical bytes) and what the plan's layouts
    make of it (each leaf's bytes times positions over its distinct
    blocks)."""
    from mxnet_tpu_torch.gluon import _sharded
    from mxnet_tpu_torch.parallel.mesh import Placed

    per, unplaced, expected = None, 0, 0
    for st in trainer._states:
        for leaf in _sharded._leaves(st):
            if not isinstance(leaf, Placed):
                fail("27b: an optimizer-state leaf is not placed")
            nb = leaf.nbytes()
            per = nb if per is None else [a + b for a, b in zip(per, nb)]
            logical = math.prod(leaf.shape) * leaf.shards[0].element_size()
            unplaced += logical
            expected += logical * len(nb) // leaf.layout.distinct()
    return dict(per_position=per, total=sum(per), unplaced=unplaced,
                expected_total=expected, largest=max(per))


def _within_adam_bound(torch, a, b, tol):
    """The largest excess of snapshot ``a``'s masters and weights over
    ``b``'s beyond ``tol`` plus one bf16 ulp of the larger magnitude
    (2^-7 of it: a bf16 weight is its master rounded to nearest, half an
    ulp each side; f32 ones take it as slack for the two runs' f32
    rounding): <= 0 holds."""
    worst = -math.inf
    for x, y in zip(a["weights"] + a["masters"], b["weights"] + b["masters"]):
        if not x.numel():
            continue
        x, y = x.float(), y.float()
        mag = torch.maximum(x.abs(), y.abs())
        worst = max(worst, ((x - y).abs() - tol - mag * 2.0 ** -7)
                    .max().item())
    return worst


def _grad_batches(torch, finetune, dev, n, seed=2):
    """``n`` batches of the fine-tune's shapes (8 rows of 384 tokens,
    segment 0, span starts and ends) from ``seed``: a fresh batch a step,
    so a step that summed an earlier step's gradients would show."""
    gen = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(n):
        tok = torch.randint(0, finetune.VOCAB, (8, 384), generator=gen,
                            dtype=torch.int32)
        starts = torch.randint(0, 384, (8,), generator=gen)
        ends = torch.randint(0, 384, (8,), generator=gen)
        out.append([t.to(dev) for t in (tok, torch.zeros_like(tok),
                                         starts, ends)])
    return out


def _first_moments(trainer):
    """The logical first moments of the trainer's AdamW states by name, in
    trainer order: ``m_t = beta1 m_{t-1} + (1 - beta1) g_t`` over the
    summed, rescaled gradients ``g_t``."""
    from mxnet_tpu_torch.gluon import _sharded

    out = {}
    for name, p, st in zip(trainer._param_names, trainer._params,
                           trainer._states):
        full = _sharded.full_state(st)
        if full is None:
            continue
        leaves = _sharded._leaves(full)
        if trainer.optimizer._is_mp_state(p._tensor(), full):
            leaves = leaves[1:]
        out[name] = leaves[0].detach().clone()
    return out


def _moment_gap(a, b):
    """Each tensor's ``||a - b|| / ||b||`` of two :func:`_first_moments`
    (sums in f64; tensors zero in both, which no loss reaches, left out):
    ``{"worst": the largest, "name": its tensor, "over": how many exceed
    SHARD_GRAD_LIMIT, "tensors": how many were held, "exempt":
    SHARD_GRAD_EXEMPT's gap}``."""
    gaps, exempt = {}, None
    for name, y in b.items():
        num = float((a[name].double() - y.double()).norm())
        den = float(y.double().norm())
        gap = num / den if den else (math.inf if num else None)
        if name.endswith(SHARD_GRAD_EXEMPT):
            exempt = gap
        elif gap is not None:
            gaps[name] = gap
    name = max(gaps, key=gaps.get)
    return dict(worst=gaps[name], name=name, tensors=len(gaps),
                over=sum(g > SHARD_GRAD_LIMIT for g in gaps.values()),
                exempt=exempt)


@contextlib.contextmanager
def _dropped_last_shard(torch):
    """The control of 27a's gradient gate: inside it the shard_map form's
    gradient sum (``psum_tree_flat_traced``, warm-up and capture alike)
    leaves out the last data position's gradients, as a sum that dropped
    a shard would."""
    from mxnet_tpu_torch.gluon import train_step as ts_mod

    real = ts_mod.psum_tree_flat_traced

    def dropped(trees, axis=None, bucket_mb=None):
        zeros = [torch.zeros_like(g) for g in trees[-1]]
        return real(list(trees[:-1]) + [zeros], axis, bucket_mb)

    ts_mod.psum_tree_flat_traced = dropped
    try:
        yield
    finally:
        ts_mod.psum_tree_flat_traced = real


def _grad_run(torch, finetune, build, dev, plan, model_kwargs, batches,
              label, ref=None, control=False):
    """27a's gradient gate for one plan: ``len(batches)`` TrainStep calls
    at dropout 0 and learning rate 0 from the fine-tune's weights, a fresh
    batch each. The weights stay where they start, so every step's
    gradients are taken at the same weights in every run, and the first
    moments sum them. Returns the record: ``moments`` after each step
    (with no ``ref``), else ``gaps`` to ``ref``'s after the same step."""
    net, trainer, step = _shard_build(finetune, dev, plan, model_kwargs,
                                      dropout=0.0, lr=0.0)
    ts = step.func
    per_step = []
    with _dropped_last_shard(torch) if control else contextlib.nullcontext():
        for k, b in enumerate(batches):
            ts(*b)
            m = _first_moments(trainer)
            per_step.append(m if ref is None else _moment_gap(m, ref[k]))
    check(ts.last_path == "whole_step" and ts.jit_trace_count() == 1,
          f"27a gradients {label}: ran {ts.last_path} with "
          f"{ts.jit_trace_count()} captures: {ts.ineligible_reason()}")
    return {"form": ts._form,
            ("moments" if ref is None else "gaps"): per_step}


def _zero_blocks_match(torch, trainer, logical):
    """Each position's block of every placed state leaf of ``trainer``
    against the slice of ``logical`` (another trainer whose states hold
    the same leaves unsharded) that its layout assigns it, bit for bit;
    ``(blocks compared, blocks equal, leaves sharded over fsdp)``."""
    from mxnet_tpu_torch.gluon import _sharded

    n = same = split = 0
    for st, ref in zip(trainer._states, logical._states):
        ref_leaves = _sharded._leaves(_sharded.full_state(ref))
        for leaf, full in zip(_sharded._leaves(st), ref_leaves):
            split += leaf.layout.distinct() > 1
            for blk, shard in zip(leaf.layout.blocks, leaf.shards):
                n += 1
                same += torch.equal(
                    shard, full[tuple(slice(a, b) for a, b in blk)])
    return n, same, split


def phase_sharding(torch, mt, finetune, build, kopt, dev, **model_kwargs):
    """27. Sharding plans over mesh positions of ``dev`` (every position a
    position of the one card), on BERT-base QA fine-tuning at dropout 0.1
    through TrainStep's graph (``model_kwargs`` cut it:
    tests/test_torch_cuda_sharding.py).

    27a: SHARD_STEPS steps each from the same weights, batch and noise
    generators (i) with no plan, (ii) under ``ShardingPlan("dp=4",
    devices=[dev] * 4)`` (the shard_map form: each position's forward and
    backward over its two rows, the gradients summed in position order),
    (iii) under ``ShardingPlan.from_layout("dp=2,fsdp=2,tp=2", net=net,
    devices=[dev] * 8)`` with ZeRO (the logical step, the update over
    every position's blocks). (iii) equals (i) bit for bit: losses, bf16
    weights, f32 masters, both moments. (ii) draws its dropout masks per
    shard, so it is held to (i) by :func:`adam_step_bound` (masters and
    f32 weights within it, bf16 weights within it plus one bf16 ulp), and
    its replicas' blocks equal each other. One capture a run; K3, K4, K5a
    and K5b counted over the steps, K3 under (iii) as the placed tables
    predict (:func:`_placed_launches`). The gradient gate: at dropout 0
    and learning rate 0 (the weights stay put, so every step's gradients
    are taken at the same weights), SHARD_GRAD_STEPS fresh batches, dp=4
    and the layout-less dp=2,fsdp=2 keep every tensor's first moment within
    SHARD_GRAD_LIMIT of (i)'s (relative L2), and a control whose sum drops
    the last shard's gradients exceeds it at every step. The layout-less
    ``ShardingPlan("dp=2,fsdp=2", devices=[dev] * 4)`` (replicated weights,
    ZeRO state, the placed update) equals ``ShardingPlan("dp=2")`` over
    SHARD_STEPS steps at dropout 0.1 bit for bit, each ZeRO block the
    slice of dp=2's state, its launches counted.
    27b: (iii)'s optimizer-state bytes a position, their sum (the unplaced
    total times what the plan replicates, exactly) and the largest (at most
    1/fsdp of the unplaced total).
    27c: (iii) saved by CheckpointManager; a fresh trainer under
    ``from_layout("dp=2,fsdp=2")`` (world 4) raises PlanMismatch, then
    takes it through ``elastic.resharded_restore`` and ``verify_parity``
    holds bit for bit; so does a fresh trainer with no plan; the checkpoint
    rewritten offline for dp=4 (``reshard_checkpoint``) restores into a
    dp=4 trainer as an exact plan match; ``python -m
    mxnet_tpu_torch.tools.ckpt verify --mesh dp=4`` and ``reshard`` exit
    0; SHARD_MORE steps resumed under (iii)'s plan equal SHARD_MORE more
    steps of (iii), which never stopped, bit for bit.
    27d: ``elastic.reenter`` moves the live (iii) run and its TrainStep to
    ``from_layout("dp=2,fsdp=2")`` with the linear LR rule: world 8 -> 4,
    lr factor 0.5, generation + 1, one new capture and none in the five
    replays after it, and its SHARD_REENTER steps equal (i)'s with its LR
    halved at the same step, bit for bit.
    Printed beside the card: step host ms and device-busy ms under each
    plan, the device ms of (iii)'s gradient hand-out and of its gathers
    and shard copies a step, restore ms across plans, reenter's ms."""
    import tempfile

    from mxnet_tpu_torch import elastic
    from mxnet_tpu_torch.checkpoint import manager as ckmgr
    from mxnet_tpu_torch.gluon import _sharded
    from mxnet_tpu_torch.sharding import ShardingPlan

    cuda = dev.type == "cuda"
    if cuda:
        gc_collect(torch)
    t_phase = time.perf_counter()
    layers = model_kwargs.get("num_layers", 12)
    out = dict(card=card_line() if cuda else None, steps=SHARD_STEPS,
               hybrid=SHARD_HYBRID, reentry=SHARD_REENTRY)
    plans = {
        "unplaced": None,
        "dp4": lambda net: ShardingPlan("dp=4", devices=[dev] * 4),
        "hybrid": lambda net: ShardingPlan.from_layout(
            SHARD_HYBRID, net=net, devices=[dev] * 8),
    }
    runs = {}
    for label, plan in plans.items():
        net, trainer, step = _shard_build(finetune, dev, plan, model_kwargs)
        losses, secs, launches = _shard_steps(torch, build, step,
                                              SHARD_STEPS, count=True)
        ts = step.func
        check(ts.last_path == "whole_step" and ts.jit_trace_count() == 1,
              f"27a {label}: ran {ts.last_path} with "
              f"{ts.jit_trace_count()} captures: {ts.ineligible_reason()}")
        runs[label] = dict(net=net, trainer=trainer, step=step,
                           losses=losses, launches=launches,
                           state=_shard_state(torch, net, trainer),
                           form=ts._form)
        if label == "dp4":
            # (ii) against (i), then (ii) is timed and let go
            ref, dp4 = runs["unplaced"], runs["dp4"]
            tol = adam_step_bound(TRAIN_LR, SHARD_STEPS) * 1.001
            worst = _within_adam_bound(torch, dp4["state"], ref["state"],
                                       tol)
            replicas = all(
                all(torch.equal(s, p.placement.shards[0])
                    for s in p.placement.shards)
                for p in trainer._params)
            check(worst <= 0.0 and replicas,
                  f"27a dp4: weights past the Adam bound {tol:.6g} by "
                  f"{worst:.3g}, replicas equal: {replicas}")
            dp4["bound"] = dict(tol=tol, worst_excess=worst,
                                replicas_bitwise=replicas,
                                largest_loss_diff=max(
                                    abs(a - b) for x, y in zip(
                                        dp4["losses"], ref["losses"])
                                    for a, b in zip(x, y)))
            dp4["timed"] = _shard_times(torch, step) if cuda else None
            for k in ("net", "trainer", "step", "state"):
                dp4.pop(k)
            del net, trainer, step, ts
            if cuda:
                gc_collect(torch)
    ref, hyb = runs["unplaced"], runs["hybrid"]
    same = _shard_equal(torch, hyb["state"], ref["state"])
    check(hyb["losses"] == ref["losses"] and all(same.values()),
          f"27a hybrid differs from the unplaced run: losses "
          f"{hyb['losses'] == ref['losses']}, {same}")
    hts = hyb["step"].func
    upd = hts._placed
    want_k3 = _placed_launches(kopt, upd) * SHARD_STEPS
    for label, run in runs.items():
        got = run["launches"]
        want_attn = layers * SHARD_STEPS * (4 if label == "dp4" else 1)
        for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                     "flash_attention_bwd_dkv"):
            check(not cuda or got.get(name, 0) == want_attn,
                  f"27a {label}: {name} launched {got.get(name)}, want "
                  f"{want_attn}")
        check(not cuda or got.get("opt_ladder", 0) > 0,
              f"27a {label}: no K3 launch")
    check(not cuda or hyb["launches"].get("opt_ladder") == want_k3,
          f"27a hybrid: K3 launched {hyb['launches'].get('opt_ladder')}, "
          f"the tables predict {want_k3}")
    out["a"] = {label: dict(form=run["form"], launches=run["launches"],
                            losses_mean=[sum(x) / len(x)
                                         for x in run["losses"]],
                            **({k: run[k] for k in ("bound", "timed")}
                               if label == "dp4" else {}))
                for label, run in runs.items()}
    out["a"]["hybrid_bitwise"] = same
    out["a"]["k3_predicted"] = want_k3
    out["a"]["placed_copies_per_step"] = upd.copies() + sum(
        len(ul.blocks) for ul in upd._ulayouts)
    if cuda:
        out["a"]["hybrid_scatter_ms"] = device_ms(torch, [upd.scatter])
        out["a"]["hybrid_gather_ms"] = device_ms(torch, [upd.finish])
        # (i) and (iii) take the same timed steps, so they stay in step
        out["timed"] = {"unplaced": _shard_times(torch, ref["step"]),
                        "dp4": out["a"]["dp4"]["timed"],
                        "hybrid": _shard_times(torch, hyb["step"])}

    # 27a, the gradient gate: at dropout 0 and learning rate 0 a per-shard
    # form computes (i)'s gradients at (i)'s weights but for the order of
    # its sums, so after each step (a fresh batch each) every tensor's
    # first moment stays within SHARD_GRAD_LIMIT of (i)'s; a control whose
    # sum leaves out the last shard must not
    batches = _grad_batches(torch, finetune, dev, SHARD_GRAD_STEPS)
    ref_m = _grad_run(torch, finetune, build, dev, None, model_kwargs,
                      batches, "unplaced").pop("moments")
    grad = {}
    for label, plan, control in (
            ("dp4", plans["dp4"], False),
            ("dp4_dropped_shard", plans["dp4"], True),
            ("dp2_fsdp2", ShardingPlan(SHARD_REENTRY, devices=[dev] * 4),
             False)):
        grad[label] = _grad_run(torch, finetune, build, dev, plan,
                                model_kwargs, batches, label, ref=ref_m,
                                control=control)
        if cuda:
            gc_collect(torch)
    del ref_m
    worst = {label: max(g["worst"] for g in rec["gaps"])
             for label, rec in grad.items()}
    ctrl = grad["dp4_dropped_shard"]["gaps"]
    control_least = min(g["worst"] for g in ctrl)
    say(f"sharding gradient gate: largest first-moment gap to (i) "
        f"{json.dumps(worst)}; the control's least {control_least:.6g}, "
        f"tensors past the limit a step "
        f"{[(g['over'], g['tensors']) for g in ctrl]}; limit "
        f"{SHARD_GRAD_LIMIT:.6g}; {SHARD_GRAD_EXEMPT} "
        f"{[[g['exempt'] for g in rec['gaps']] for rec in grad.values()]};"
        f" card {out['card']}")
    for label in ("dp4", "dp2_fsdp2"):
        rec = grad[label]
        check(rec["form"] == "mesh" and worst[label] <= SHARD_GRAD_LIMIT,
              f"27a gradients {label}: form {rec['form']}, first moments "
              f"{rec['gaps']} from (i)'s, past {SHARD_GRAD_LIMIT}")
    check(control_least > SHARD_GRAD_LIMIT,
          f"27a gradients: the control that drops a shard came within "
          f"{control_least:.6g} of (i), inside the limit {SHARD_GRAD_LIMIT}")
    out["a"]["gradient_gate"] = dict(
        limit=SHARD_GRAD_LIMIT, steps=SHARD_GRAD_STEPS, worst=worst,
        control_least=control_least, **grad)

    # the layout-less dp=2,fsdp=2 plan (replicated weights, ZeRO state, the
    # placed update) trains as dp=2 does, bit for bit, each of its ZeRO
    # blocks the slice of dp=2's state
    pair = {}
    for label, n in (("dp=2", 2), (SHARD_REENTRY, 4)):
        net0, tr0, step0 = _shard_build(
            finetune, dev, ShardingPlan(label, devices=[dev] * n),
            model_kwargs)
        losses, _, launches = _shard_steps(torch, build, step0, SHARD_STEPS,
                                           count=True)
        pair[label] = dict(net=net0, trainer=tr0, step=step0.func,
                           losses=losses, launches=launches)
        del net0, tr0, step0
    lo, z = pair["dp=2"], pair[SHARD_REENTRY]
    zts = z["step"]
    same_z = _shard_equal(torch, _shard_state(torch, z["net"], z["trainer"]),
                          _shard_state(torch, lo["net"], lo["trainer"]))
    blocks = dict(zip(("compared", "equal", "leaves_sharded"),
                      _zero_blocks_match(torch, z["trainer"], lo["trainer"])))
    check(zts._form == "mesh" and zts._placed is not None
          and zts.jit_trace_count() == 1 and z["losses"] == lo["losses"]
          and all(same_z.values()) and blocks["compared"] == blocks["equal"]
          and blocks["leaves_sharded"] > 0,
          f"27a dp2_fsdp2: form {zts._form}, placed update "
          f"{zts._placed is not None}, captures {zts.jit_trace_count()}, "
          f"losses equal {z['losses'] == lo['losses']}, against dp=2 "
          f"{same_z}, ZeRO blocks {blocks}")
    want_attn = layers * SHARD_STEPS * 2    # two data positions
    got = z["launches"]
    check(not cuda or (all(got.get(name, 0) == want_attn
                           for name in ("flash_attention_fwd",
                                        "flash_attention_bwd_dq",
                                        "flash_attention_bwd_dkv"))
                       and got.get("opt_ladder", 0) > 0),
          f"27a dp2_fsdp2: launches {got}, want attention {want_attn} "
          f"each and K3")
    out["a"]["dp2_fsdp2"] = dict(form=zts._form, launches=got,
                                 bitwise_dp2=same_z, zero_blocks=blocks)
    del pair, lo, z, zts
    if cuda:
        gc_collect(torch)

    # 27b: ZeRO bytes
    b = _state_bytes(hyb["trainer"])
    unplaced_bytes = sum(
        x.numel() * x.element_size()
        for k in ("masters", "moments") for x in ref["state"][k])
    fsdp = 2
    check(b["unplaced"] == unplaced_bytes and b["total"] ==
          b["expected_total"] and b["largest"] <= b["unplaced"] / fsdp,
          f"27b: {b}, unplaced run's state {unplaced_bytes} bytes")
    out["b"] = b

    # 27c: checkpoints across plans
    root = Path(__file__).resolve().parent / "build" / "scratch"
    root.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="shard_", dir=root) as tmp:
        tmp = Path(tmp)
        ck = tmp / "ck"
        saved = hyb["trainer"].optimizer.num_update
        mgr = mt.checkpoint.CheckpointManager(ck, hyb["trainer"])
        mgr.save(step=saved)
        mgr.flush()
        arrays = ckmgr._read_checkpoint(
            str(ck / ckmgr._STEP_FMT.format(saved)))[0]
        c = {}

        def fresh(plan):
            return _shard_build(finetune, dev, plan, model_kwargs)

        net4, tr4, _ = fresh(lambda net: ShardingPlan.from_layout(
            SHARD_REENTRY, net=net, devices=[dev] * 4))
        try:
            mt.checkpoint.CheckpointManager(ck, tr4).restore()
            fail("27c: a restore across world sizes did not raise")
        except mt.checkpoint.PlanMismatch as e:
            c["plan_mismatch"] = str(e)[:160]
        t0 = time.perf_counter()
        res, compat = elastic.resharded_restore(
            mt.checkpoint.CheckpointManager(ck, tr4))
        c["reshard_restore_ms"] = (time.perf_counter() - t0) * 1e3
        c["compared_resharded"] = elastic.verify_parity(tr4, arrays)
        c["resharded_verdict"] = compat["verdict"]
        del net4, tr4
        net1, tr1, _ = fresh(None)
        t0 = time.perf_counter()
        mt.checkpoint.CheckpointManager(ck, tr1).restore()
        c["unplaced_restore_ms"] = (time.perf_counter() - t0) * 1e3
        c["compared_unplaced"] = elastic.verify_parity(tr1, arrays)
        del net1, tr1
        report = elastic.reshard_checkpoint(ck, tmp / "dp4", "dp=4")
        net4, tr4, _ = fresh(lambda net: ShardingPlan(
            "dp=4", devices=[dev] * 4))
        res = mt.checkpoint.CheckpointManager(tmp / "dp4", tr4).restore()
        c["offline_verdict"] = elastic.plan_compatibility(
            (res.manifest.get("meta") or {}).get("sharding_plan"),
            tr4.sharding_plan)["verdict"]
        c["compared_offline"] = elastic.verify_parity(tr4, arrays)
        c["offline_report"] = {k: report[k] for k in ("arrays", "nbytes")}
        del net4, tr4
        check(c["resharded_verdict"] == "reshard"
              and c["offline_verdict"] == "exact",
              f"27c: verdicts {c}")
        cli = {}
        for argv in (["verify", str(ck), "--mesh", "dp=4", "--json"],
                     ["reshard", str(ck), "--dest", str(tmp / "cli"),
                      "--mesh", "dp=4", "--json"]):
            proc = subprocess.run(
                [sys.executable, "-m", "mxnet_tpu_torch.tools.ckpt", *argv],
                capture_output=True, text=True, timeout=600,
                cwd=Path(__file__).resolve().parent)
            check(proc.returncode == 0,
                  f"27c: ckpt {argv[0]} exited {proc.returncode}: "
                  f"{proc.stdout[-1500:]} {proc.stderr[-1500:]}")
            cli[argv[0]] = json.loads(proc.stdout).get(
                "plan", {}).get("verdict", "written")
        c["cli"] = cli
        # the uninterrupted (iii) run and a resumed one, SHARD_MORE steps
        netr, trr, stepr = fresh(plans["hybrid"])
        t0 = time.perf_counter()
        mt.checkpoint.CheckpointManager(ck, trr).restore()
        c["exact_restore_ms"] = (time.perf_counter() - t0) * 1e3
        resumed, _, _ = _shard_steps(torch, build, stepr, SHARD_MORE)
        more, _, _ = _shard_steps(torch, build, hyb["step"], SHARD_MORE)
        same_r = _shard_equal(torch, _shard_state(torch, netr, trr),
                              _shard_state(torch, hyb["net"],
                                           hyb["trainer"]))
        check(resumed == more and all(same_r.values()),
              f"27c: the resumed steps differ from the uninterrupted ones: "
              f"{resumed == more}, {same_r}")
        c["resumed_bitwise"] = same_r
        del netr, trr, stepr
    if cuda:
        gc_collect(torch)
    out["c"] = c

    # 27d: elastic re-entry of the live (iii) run
    ref_more, _, _ = _shard_steps(torch, build, ref["step"], SHARD_MORE)
    check(ref_more == more, "27d: (i) and (iii) parted before re-entry")
    captures = hts.jit_trace_count()
    info = elastic.reenter(
        hyb["trainer"], ShardingPlan.from_layout(
            SHARD_REENTRY, net=hyb["net"], devices=[dev] * 4),
        train_step=hts, lr_rescale="linear")
    check(info["old_world"] == 8 and info["new_world"] == 4
          and info["lr_factor"] == 0.5,
          f"27d: reenter reported {info}")
    ref["trainer"].set_learning_rate(ref["trainer"].learning_rate * 0.5)
    first, _, _ = _shard_steps(torch, build, hyb["step"], 2)
    after_capture = hts.jit_trace_count()
    rest, _, d_launches = _shard_steps(torch, build, hyb["step"],
                                       SHARD_REENTER - 2, count=True)
    want, _, _ = _shard_steps(torch, build, ref["step"], SHARD_REENTER)
    same_d = _shard_equal(torch, _shard_state(torch, hyb["net"],
                                              hyb["trainer"]),
                          _shard_state(torch, ref["net"], ref["trainer"]))
    check(after_capture == captures + 1 and hts.jit_trace_count() ==
          after_capture and first + rest == want and all(same_d.values()),
          f"27d: captures {captures} -> {after_capture} -> "
          f"{hts.jit_trace_count()}, losses equal {first + rest == want}, "
          f"{same_d}")
    out["d"] = dict(info=info, captures=[captures, after_capture,
                                         hts.jit_trace_count()],
                    launches=d_launches, bitwise=same_d,
                    form=hts._form)
    if cuda:
        out["timed"]["reentered"] = _shard_times(torch, hyb["step"])
    del runs, ref, hyb, upd, hts
    if cuda:
        gc_collect(torch)
    out["phase_s"] = time.perf_counter() - t_phase
    say(f"sharding: {json.dumps(out)}")
    if cuda:
        t = out["timed"]
        say(f"sharding numbers: step host/device-busy ms unplaced "
            f"{t['unplaced']['host_ms']:.2f}/{t['unplaced']['device_ms']:.2f}"
            f", dp4 {t['dp4']['host_ms']:.2f}/{t['dp4']['device_ms']:.2f}, "
            f"dp2_fsdp2_tp2 {t['hybrid']['host_ms']:.2f}/"
            f"{t['hybrid']['device_ms']:.2f}, "
            f"dp2_fsdp2 after re-entry {t['reentered']['host_ms']:.2f}/"
            f"{t['reentered']['device_ms']:.2f}; (iii)'s gradient hand-out "
            f"{out['a']['hybrid_scatter_ms']:.3f} ms and gathers "
            f"{out['a']['hybrid_gather_ms']:.3f} ms a step; restore across "
            f"plans {c['reshard_restore_ms']:.1f} ms (no plan "
            f"{c['unplaced_restore_ms']:.1f}, same plan "
            f"{c['exact_restore_ms']:.1f}); reenter {info['ms']:.1f} ms; "
            f"phase {out['phase_s']:.1f} s; card {out['card']}")
    return out


def _shard_times(torch, step):
    """Host ms (synchronised, median) and device-busy ms (the kernels a
    step launches, summed by the profiler) of SHARD_TIMED steps."""
    _, secs, _ = _shard_steps(torch, None, step, SHARD_TIMED)
    return dict(host_ms=_median_ms(secs),
                device_ms=device_ms(torch, [step], iters=SHARD_TIMED))


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a "
             "CUDA card")
    here = Path(__file__).resolve().parent
    check((here / "mxnet_tpu_torch" / "csrc").is_dir(),
          f"no mxnet_tpu_torch package beside {__file__}")
    sys.path.insert(0, str(here))

    # 1. device
    card = card_line()
    say(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    # 2. build: one nvcc per source, all at once; the rtc sources of phase
    # 9 compile through mx.rtc meanwhile
    from mxnet_tpu_torch import rtc
    from mxnet_tpu_torch.kernels import build

    names = sorted(p.stem for p in build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        rtc_build = pool.submit(build_rtc_modules, rtc)
        built = build.build(names)
        rtc_modules = rtc_build.result()
    say(f"build: {names} and {len(rtc_modules)} rtc sources in "
        f"{time.perf_counter() - t0:.1f}s (per source {json.dumps(built)}; "
        f"rtc {json.dumps({n: m[1] for n, m in rtc_modules.items()})})")

    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.gluon.model_zoo import bert, vision
    from mxnet_tpu_torch.kernels import dispatch, norm as knorm, opt as kopt
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.optimizer import optimizer as topt
    from mxnet_tpu_torch.tools import finetune, train_lenet, train_resnet

    check(sorted({Path(k["source"]).stem for k in KERNELS
                  if "/csrc/" in k["source"]}) == names,
          "the kernel table does not name every source under csrc")

    # 3-8
    cases = phase_kernels(torch, fa)
    bwd_cases = phase_kernels_bwd(torch, fa)
    probes = phase_attention_probes(torch, fa)
    phase_kernels_opt(torch, kopt, topt, dispatch)
    bn = phase_kernels_bn(torch, knorm, dispatch, build)
    build.reset_counters()  # the FP32 attention kernels' launches in 4
    phase_model_parity(torch, mt, bert, fa)
    phase_gelu(torch)
    phase_train_parity(torch, mt, finetune, fa)
    f32_launches = {c.name: c.value for c in build.COUNTERS.values()}
    phase_resnet_parity(torch, mt, train_resnet, vision, knorm)
    serve = phase_serving(torch, mt, serving, build, fa)
    frontdoor = phase_frontdoor(torch, mt, serving, build, fa)
    train = phase_training(torch, mt, finetune, build, fa, kopt, topt,
                           dispatch)
    resnet = phase_resnet_training(torch, mt, train_resnet, build, knorm,
                                   kopt, topt, dispatch)
    rtc_run = phase_rtc(torch, mt, rtc, build, rtc_modules)
    phase_lenet_parity(torch, mt, vision, kopt)
    lenet_run = phase_lenet_training(torch, mt, train_lenet, build, dispatch,
                                     kopt, topt)
    # 13-15. the three training paths through TrainStep's CUDA graph
    mods = (finetune, train_resnet, train_lenet)
    ts_runs = {path: phase_train_step(torch, mt, build, dispatch, kopt, fa,
                                      mods, path)
               for path in ("resnet50", "lenet", "bert")}
    # 16. checkpoint and resume
    resume = phase_resume(torch, mt, finetune, serving, build, kopt,
                          mt.gpu(0))
    # 17. LAMB under AMP; 18. the 14 rules, the card against the CPU
    lamb = phase_lamb_amp(torch, mt, finetune, build, kopt, topt, dispatch,
                          mt.gpu(0), adamw=train)
    rule_sweep = phase_rule_sweep(torch, mt, kopt, topt, mt.gpu(0))
    # 19. ring flash attention over a four-position mesh on the card
    ring_run = phase_ring(torch, build, fa, card)
    # 20. the vision zoo: MobileNetV2-1.0 and the other families
    zoo = phase_vision_zoo(torch, mt, build, dispatch, kopt, knorm, topt,
                           fa, mods)
    # 21. the input pipeline: the MNIST and CIFAR examples fed by the
    # DataLoader in each worker mode
    data = phase_data(torch, mt, build, dispatch, kopt, knorm)
    # 22. the operator corpus: ResNet-50 in the legacy ops, the registered
    # flash_attention, the sweep of every new name
    registry = phase_registry(torch, mt, build, fa, vision)
    # 23. sparse arrays and the row-sparse training path: the
    # matrix-factorization example at MovieLens-20M's table sizes, sparse
    # dot at a realistic size, the sweep of the slice's new names
    phase_sparse(torch, mt)
    # 24. data-parallel training across processes: config #3 by two ranks,
    # NCCL at world size 1, the example, compression card against CPU
    dist = phase_distributed(torch, mt)
    # 25. INT8 inference, config #5: Q1 and Q2 at ResNet-50's sites, the
    # calibrated ResNet-50 served in int8, the int8 example
    int8_run = phase_int8(torch, mt, build, vision)
    # 26. the checkpoint manager: BERT-base fine-tuning at dropout 0.1
    # through TrainStep's graph, killed in the middle of a write, resumed
    # in a fresh process, restored into a live graph, preempted by SIGTERM
    ckpt = phase_checkpoint(torch, mt, finetune, build, kopt, mt.gpu(0))
    # 27. sharding plans over positions of the card: BERT-base fine-tuning
    # unplaced, dp=4 and dp=2,fsdp=2,tp=2, ZeRO's bytes, checkpoints across
    # plans, elastic re-entry
    shard = phase_sharding(torch, mt, finetune, build, kopt, mt.gpu(0))

    # 28. the kernels line, card, ok. Each row's case is the main paths'
    # call: attention at (8, 12, 384, 64) bf16 (its f32 variants at the
    # same shape in f32, with their launches from the f32 parity of phase
    # 4: no main path runs them), the ladder and its norm as the sweep over
    # BERT-base's parameters (one launch per bucket; per_path: each training
    # path's sweep and launches), BatchNorm summed over ResNet-50's 53 sites at
    # batch 256 (bf16, NHWC). Attention's ms and library_ms are the kernel
    # alone and SDPA by the same method (summed kernel events of the
    # profiler); ms_host_issued are back-to-back CUDA-event times, the
    # method of this script's earlier rows.
    # The two backward kernels run as a pair and their plain version and the
    # library call compute dq, dk and dv in one: both rows carry the PAIR's
    # ms, plain_ms, library_ms and bound_ms (like beside like; the bound is
    # the function's own, each input read and each output written once),
    # and each kernel's own time and bound as own_ms and own_bound_ms. The pair is
    # timed with dropout 0.1, as training runs it; the library (SDPA's
    # backward through autograd, whose dropout mask is another function) at
    # the same shape without dropout.
    # Launches: from the path that runs the kernel most (the ladder and its
    # norm: BERT's, with each path's beside). rtc (K7): the three user kernels
    # of phase 9 at their main-path shapes, each timed alone; the row
    # carries their sums and max_abs_err the largest of the three (each
    # against its own tolerance), and "cases" each kernel's own numbers.
    # phase 24's ranks: their ResNet-50 steps, counted in each rank
    dist_ranks = {f"rank{r['rank']}": r["launches"]
                  for r in dist["resnet"]["ranks"]}
    by_label = {r["case"]: r for r in cases}
    bwd_by_label = {r["case"]: r for r in bwd_cases}
    measured = {}
    for variant, fwd_case, bwd_case, bwd_lib_case in (
            ("mma", "serve_bf16", "train_bf16_dropout", "serve_bf16"),
            ("fp32", "serve_f32", "dropout_0.1_seed7", "serve_f32")):
        fwd, bwd = by_label[fwd_case], bwd_by_label[bwd_case]
        bwd_nodrop = bwd_by_label[bwd_lib_case]
        check(bwd["shape"] == bwd_nodrop["shape"] == fwd["shape"]
              and bwd["dtype"] == bwd_nodrop["dtype"] == fwd["dtype"]
              and fwd["variant"] == bwd["variant"] == variant,
              "attention rows' shapes and variants")
        if variant == "mma":
            fwd_launches = max(serve["variant_launches"]["mma"],
                               train["launches"]["flash_attention_fwd_mma"])
            bwd_launches = {n: train["launches"][f"{n}_mma"] for n in (
                "flash_attention_bwd_dq", "flash_attention_bwd_dkv")}
            seen = "main paths: serving (phase 5), training (phase 6)"
        else:
            fwd_launches = f32_launches["flash_attention_fwd_fp32"]
            bwd_launches = {n: f32_launches[f"{n}_fp32"] for n in (
                "flash_attention_bwd_dq", "flash_attention_bwd_dkv")}
            seen = "f32 parity phase 4 (no main path runs float32)"
        pair = dict(
            ms=bwd["dq_ms"] + bwd["dkv_ms"],
            ms_host_issued=bwd["dq_ms_host_issued"]
            + bwd["dkv_ms_host_issued"],
            plain_ms=bwd["plain_ms_dq_dk_dv_together"],
            library_ms=bwd_nodrop[
                "library_ms_sdpa_backward_dq_dk_dv_together"],
            library_ms_host_issued=bwd_nodrop["library_ms_host_issued"],
            bound_ms=bwd["pair_bound_ms"], bound_by=bwd["pair_bound_by"],
            times_cover="dq and dk/dv kernels together; own_ms is this "
                        "kernel's", library_case="same shape, dropout 0",
            launches_from=seen)
        measured[f"flash_attention_fwd_{variant}"] = dict(
            launches=fwd_launches, launches_from=seen,
            max_abs_err=fwd["max_abs_err"], ms=fwd["ms"],
            ms_host_issued=fwd["ms_host_issued"], plain_ms=fwd["plain_ms"],
            bound_ms=fwd["bound_ms"], bound_by=fwd["bound_by"],
            library_ms=fwd["library_ms"],
            library_ms_host_issued=fwd["library_ms_host_issued"])
        for name, key in (("flash_attention_bwd_dq", "dq"),
                          ("flash_attention_bwd_dkv", "dkv")):
            measured[f"{name}_{variant}"] = dict(
                launches=bwd_launches[name],
                max_abs_err=bwd[f"{key}_max_abs_err"], own_ms=bwd[f"{key}_ms"],
                own_ms_host_issued=bwd[f"{key}_ms_host_issued"],
                own_bound_ms=bwd[f"{key}_bound_ms"],
                own_bound_by=bwd[f"{key}_bound_by"], **pair)
    measured["flash_attention_fwd_mma"]["probes"] = probes
    zoo_ts = zoo["train_step"]
    paths = {"bert": train, "resnet50": resnet, "lenet": lenet_run,
             # phased and graph steps launch alike (phase 20 holds them)
             "mobilenet_v2": dict(
                 zoo_ts, launches={"opt_sqnorm": 0, **zoo_ts["launches"]},
                 opt_tensors_updated=zoo_ts["tensors_updated"])}
    per_path = {}
    for path, run in paths.items():
        sw = run["opt_sweep"]
        per_path[path] = dict(
            launches=run["launches"]["opt_ladder"],
            tensors_updated=run["opt_tensors_updated"],
            norm_launches=run["launches"]["opt_sqnorm"],
            buckets=sw["buckets"], parameters=sw["parameters"],
            max_abs_err=sw["max_abs_err"], ms=sw["bucket_ms"],
            ms_host_issued=sw["bucket_ms_host_issued"],
            per_parameter_ms=sw["per_parameter_ms"],
            per_parameter_ms_host_issued=sw[
                "per_parameter_ms_host_issued"],
            plain_ms=sw["plain_ms"],
            plain_ms_host_issued=sw["plain_ms_host_issued"],
            bound_ms=sw["bound_ms"], copy_ms=sw["copy_ms"],
            library=sw["library"], library_ms=sw["library_ms"],
            library_ms_host_issued=sw["library_ms_host_issued"])
    sweep, norm = train["opt_sweep"], train["opt_sweep"]["norm"]
    measured.update({
        "opt_ladder": dict(
            launches=train["launches"]["opt_ladder"],
            launches_from="BERT training, phase 6 (per_path: each path's)",
            max_abs_err=max(p["max_abs_err"] for p in per_path.values()),
            ms=sweep["bucket_ms"], ms_host_issued=sweep[
                "bucket_ms_host_issued"],
            per_parameter_ms=sweep["per_parameter_ms"],
            per_parameter_ms_host_issued=sweep[
                "per_parameter_ms_host_issued"],
            plain_ms=sweep["plain_ms"], bound_ms=sweep["bound_ms"],
            bound_by=sweep["bound_by"], copy_ms=sweep["copy_ms"],
            library_ms=None,
            times_cover="one update of BERT-base's parameters as "
                        "update_fused issues it (per_path: each path's); "
                        "ms alone (profiler kernel sums), host-issued "
                        "beside; copy_ms: y.copy_(x) of the same bytes "
                        "the same way; per_parameter: one launch a "
                        "parameter; "
                        "library_ms in per_path: torch's fused rule, "
                        "another function, an indication only",
            per_path=dict(per_path, distributed_resnet50=dict(
                launches={rank: n["opt_ladder"]
                          for rank, n in dist_ranks.items()},
                launches_from=f"phase 24a: {dist['resnet']['steps']} "
                              f"steps a rank",
                buckets=DIST_LADDER_BUCKETS,
                max_abs_err=per_path["resnet50"]["max_abs_err"],
                max_abs_err_from="phase 8's sweep over the same ResNet-50 "
                                 "parameter list (the batch changes no "
                                 "parameter's shape)"))),
        "opt_sqnorm": dict(
            launches=train["launches"]["opt_sqnorm"],
            launches_from="BERT training, phase 6 (ResNet-50 and LeNet "
                          "clip no global norm)",
            max_abs_err=norm["max_abs_err"], ms=norm["ms"],
            ms_host_issued=norm["ms_host_issued"], plain_ms=norm["plain_ms"],
            plain_ms_host_issued=norm["plain_ms_host_issued"],
            bound_ms=norm["bound_ms"], bound_by=norm["bound_by"],
            library_ms=None, indication=norm["indication"],
            indication_ms=norm["indication_ms"],
            times_cover="the bucket sums of BERT-base's gradients, one "
                        "norm launch a bucket; ms alone (profiler kernel "
                        "sums), host-issued beside"),
    })
    rc = rtc_run["cases"]
    measured["rtc"] = dict(
        launches=rtc_run["main_path_launches"],
        max_abs_err=max(c["max_abs_err"] for c in rc),
        ms=sum(c["ms"] for c in rc), plain_ms=sum(c["plain_ms"] for c in rc),
        bound_ms=sum(c["bound_ms"] for c in rc), bound_by="bytes",
        library_ms=sum(c["library_ms"] for c in rc),
        times_cover="axpy 2^26 f32 + row sum (65536, 1024) bf16 + strided "
                    "half scale 2^24, summed; see cases",
        cases=[{key: c[key] for key in ("kernel", "build_s", "ms", "plain_ms",
                                        "bound_ms", "bound_by", "library_ms",
                                        "library", "max_abs_err", "tol")}
               for c in rc])
    check(all(c["bound_by"] == "bytes" for c in rc), "an rtc kernel bound "
                                                     "by operations")
    total = bn["resnet50_batch256_53_sites"]
    for name, side, err in (("bn_train_fwd", "fwd", bn["fwd_max_abs_err"]),
                            ("bn_train_bwd", "bwd", bn["bwd_max_abs_err"])):
        measured[name] = dict(
            launches=resnet["launches"][name], max_abs_err=err,
            ms=total[f"{side}_ms"],
            ms_l2_warm=total[f"{side}_ms_l2_warm"],
            ms_host_issued=total[f"{side}_ms_host_issued"],
            copy_ms=total["copy_ms"],
            plain_ms=total[f"plain_{side}_ms"],
            bound_ms=total[f"{side}_bound_ms"], bound_by="bytes",
            library_ms=total[f"library_{side}_ms"],
            library_ms_host_issued=total[f"library_{side}_ms_host_issued"],
            times_cover="the 53 BatchNorm sites of ResNet-50 at batch 256, "
                        "bf16 NHWC; ms and library_ms alone with inputs "
                        "rotated over copies exceeding the L2; copy_ms: "
                        "y.copy_(x) of each site's x the same way; library: "
                        "F.batch_norm (cuDNN), another function; per_path: "
                        "MobileNetV2-1.0's 53 sites, bf16 NCHW (phase 20), "
                        "ResNet-18's 20 CIFAR sites at batch 64, bf16 NCHW "
                        "(phase 21)",
            per_path={"distributed_resnet50": dict(
                launches={rank: n[name] for rank, n in dist_ranks.items()},
                launches_from=f"phase 24a: {dist['resnet']['steps']} steps "
                              f"a rank",
                max_abs_err=dist["resnet"]["bn"][f"{side}_max_abs_err"],
                stats_max_rel_err=dist["resnet"]["bn"]["stats_max_rel_err"],
                max_abs_err_from=f"the 53 sites at a rank's batch of "
                                 f"{dist['resnet']['bn']['batch']}, bf16 "
                                 f"NHWC, against the plain versions (phase "
                                 f"24a)"), "resnet18_cifar": dict(
                launches=data["runs"]["a_caller"]["launches"][name],
                sites_by_regime=data["bn"]["sites_by_regime"][side],
                cuda_launches_per_step=data["bn"][
                    "cuda_launches_per_step"][side],
                max_abs_err=data["bn"][f"{side}_max_abs_err"],
                copy_ms=data["bn"]["resnet18_cifar_batch64_20_sites"][
                    "copy_ms"],
                **{key.replace(f"{side}_", "").replace(f"_{side}", ""): v
                   for key, v in data["bn"][
                       "resnet18_cifar_batch64_20_sites"].items()
                   if side in key}), "mobilenet_v2": dict(
                launches=zoo["train_step"]["phased_launches"][name],
                graph_launches=zoo["train_step"]["launches"][name],
                sites_by_regime=zoo["bn"]["sites_by_regime"][side],
                cuda_launches_per_step=zoo["bn"]["cuda_launches_per_step"][
                    side],
                max_abs_err=zoo["bn"][f"{side}_max_abs_err"],
                copy_ms=zoo["bn"]["mobilenet_v2_batch256_53_sites"][
                    "copy_ms"],
                **{key.replace(f"{side}_", "").replace(f"_{side}", ""): v
                   for key, v in zoo["bn"][
                       "mobilenet_v2_batch256_53_sites"].items()
                   if side in key})})
    # Q1 and Q2: the 54 sites of ResNet-50's int8 forward at batch 32
    # (phase 25a, each site timed and summed by its count; each Q2 row over
    # the sites its variant takes, the split-K epilogue's over the split
    # ones); launches from the served requests' rung replays (25b)
    k8, s8 = int8_run["kernels"], int8_run["serving"]
    tot, rows = k8["total"], k8["by_variant"]
    cover = (f"ResNet-50 v1 (NCHW) at batch {k8['batch']}, each site timed "
             f"and summed by its count: ms alone (summed kernel events, "
             f"inputs rotated over copies exceeding the L2), host-issued "
             f"beside; no PyTorch call computes this function (indications "
             f"beside)")
    common = dict(
        launches_from=f"phase 25b: {s8['serving']['batches']} served "
                      f"batches of the int8 ResNet-50, from the rungs' "
                      f"replays",
        library_ms=None, checks=k8["worst"])
    measured["int8_quantize"] = dict(
        common, launches=s8["serving"]["launches"]["int8_quantize"],
        max_abs_err=k8["worst"]["q1_codes"], ms=tot["q1_ms"],
        ms_host_issued=tot["q1_ms_host_issued"], plain_ms=tot["q1_plain_ms"],
        bound_ms=tot["q1_bound_ms"], bound_by="bytes",
        flat_nchw_ms=tot["q1_flat_ms"],
        indication_quantize_per_tensor_ms=tot["q1_library_ms"],
        times_cover="the 54 quantized sites of " + cover,
        example_launches=int8_run["example"]["launches"]["int8_quantize"])
    for name, variant in (("int8_conv_wgmma", "wgmma"),
                          ("int8_conv_gather", "gather"),
                          ("int8_conv_splitk", "splitk")):
        row = rows[variant]
        measured[name] = dict(
            common, launches=s8["serving"]["launches"][name],
            max_abs_err=k8["worst"]["q2_f32"], ms=row["ms"],
            ms_host_issued=row["ms_host_issued"] or None,
            plain_ms=row["plain_ms"] or None, bound_ms=row["bound_ms"],
            bound_by="bytes" if variant == "splitk" else k8["q2_bound_by"],
            sites=row["sites"], layers=row["layers"],
            times_cover=f"the {row['layers']} of the 54 quantized layers "
                        f"that the plan gives this "
                        + ("variant" if variant != "splitk"
                           else "kernel (the sums of the split sites)")
                        + " in " + cover,
            example_launches=int8_run["example"]["launches"][name])
    measured["int8_conv_wgmma"].update(
        all_q2_ms=tot["q2_ms"], all_q2_bound_ms=tot["q2_bound_ms"],
        all_q2_gather_ms=tot["q2_gather_ms"],
        gather_at_these_sites_ms=rows["wgmma"]["gather_ms"],
        bound_ms_by=k8["q2_bound_ms_by"],
        indication_cudnn_f32_ms=tot["cudnn_f32_ms"],
        indication_cudnn_bf16_ms=tot["cudnn_bf16_ms"],
        dense_batch32=k8["dense"], plans=k8["checked_plans"],
        int8_forward_ms_batch32=s8["int8_forward_ms_batch32"],
        fp32_forward_ms_batch32=s8["fp32_forward_ms_batch32"])
    hop = ring_run["hop"]
    for name, way in (("ring_flash_fwd", "fwd"), ("ring_flash_bwd", "bwd")):
        measured[name] = dict(
            launches=sum(ring_run[label]["launches"][name]
                         for label in ("full", "causal")),
            launches_from="phase 19: the ring's forward and backward, "
                          "non-causal (16 hops) and causal (10)",
            max_abs_err=max(c[key] for c in ring_run["hop_cases"]
                            for key in c if key.startswith(way)
                            and not key.endswith("largest")),
            ms=hop[f"{way}_ms"], plain_ms=hop[f"{way}_plain_ms"],
            bound_ms=hop[f"{way}_bound_ms"], bound_by=hop[f"{way}_bound_by"],
            library_ms=hop[f"{way}_library_ms"],
            ring_alone_ms={label: ring_run[label][f"hop_{way}_ms"]
                           for label in ("full", "causal")},
            hgmma_in_sass=ring_run["hgmma_in_sass"][name],
            times_cover="one non-causal middle hop at the ring's shard "
                        "(1 x 12 x 8192 x 64 bf16), p50 of 5 host-issued "
                        "(CUDA events); library: SDPA over the same q, k, "
                        "v (the hop's attention without its merge or its "
                        "sums); ring_alone_ms: the ring's hops in order; "
                        "max_abs_err: the largest against the plain "
                        "version over hop_cases",
            cases=ring_run["hop_cases"])
    measured["ring_flash_fwd"]["serve_hop"] = ring_run["serve_hop"]
    kernels = []
    for k in KERNELS:
        m = measured[k["name"]]
        check(m["launches"] > 0, f"{k['name']} was never launched on a "
                                 "main path")
        # the launches of the same kernel on the three TrainStep paths
        # (phases 13-15, 5 replays each, counted from the replays' deltas)
        m["train_step_launches"] = {
            path: run["launches"].get(k["name"], 0)
            for path, run in ts_runs.items()}
        # and over the 2 resumed BERT steps of phase 16, phased with the
        # clip and through TrainStep's replays without it
        m["resume_launches"] = {
            "phased": resume["launches"].get(k["name"], 0),
            "train_step": resume["train_step"]["launches"].get(k["name"],
                                                                0)}
        # and over the 5 counted LAMB steps under AMP of phase 17
        m["lamb_amp_launches"] = lamb["launches"].get(k["name"], 0)
        # and in the ring's forward and backward of phase 19, each way
        m["ring_launches"] = {
            label: ring_run[label]["launches"].get(k["name"], 0)
            for label in ("full", "causal")}
        # and in phase 20's 5 MobileNetV2 steps each way and the one step
        # of each other family
        m["vision_zoo_launches"] = dict(
            mobilenet_v2_phased=zoo["train_step"]["phased_launches"].get(
                k["name"], 0),
            mobilenet_v2_graph=zoo["train_step"]["launches"].get(k["name"],
                                                                 0),
            **{f["model"]: f["launches"].get(k["name"], 0)
               for f in zoo["families"]})
        # and in phase 21's runs of the MNIST and CIFAR tools, each fed by
        # the DataLoader in one mode
        m["data_launches"] = {label: run["launches"].get(k["name"], 0)
                              for label, run in data["runs"].items()}
        # and in phase 22: the 3 legacy ResNet-50 steps, the 4 registered
        # flash_attention calls
        m["registry_launches"] = {
            "resnet50_legacy_ops": registry["resnet"]["launches"].get(
                k["name"], 0),
            "flash_attention_op": registry["attention"]["launches"].get(
                k["name"], 0)}
        # and in phase 24's ranks (their ResNet-50 steps)
        m["distributed_launches"] = {
            rank: n.get(k["name"], 0) for rank, n in dist_ranks.items()}
        # and over phase 26's resumed steps: in the fresh process, and
        # through the live graph after its restore
        m["checkpoint_launches"] = {
            "resumed_process": ckpt["c"]["launches"].get(k["name"], 0),
            "live_restore": ckpt["live"]["launches"].get(k["name"], 0)}
        # and over phase 27's steps under each plan (5 each, the
        # layout-less dp=2,fsdp=2 plan's too) and the 5 replays after the
        # re-entry
        m["sharding_launches"] = dict(
            {label: run["launches"].get(k["name"], 0)
             for label, run in shard["a"].items()
             if isinstance(run, dict) and "launches" in run},
            reentered=shard["d"]["launches"].get(k["name"], 0))
        kernels.append(dict(name=k["name"], route=k["route"],
                            source=k["source"], replaces=k["replaces"], **m))
    # K6, the ring: its Python schedule (ring_attention.py) over the hop
    # kernels (their own rows above). Its row is the non-causal forward at
    # 1 x 12 x 32768 x 64 bf16 over four positions (launches: ring forwards
    # on phase 19's main path); the backward and the causal ring beside it,
    # each with its plain, library and bound
    full = ring_run["full"]
    kernels.append(dict(
        name="ring_flash_attention", route="cuda",
        source="mxnet_tpu_torch/parallel/ring_attention.py",
        replaces="mxnet_tpu/parallel/ring_attention.py:119",
        launches=sum(ring_run[label]["launches"]["ring_flash_attention"]
                     for label in ("full", "causal")),
        bwd_launches=sum(
            ring_run[label]["launches"]["ring_flash_attention_bwd"]
            for label in ("full", "causal")),
        max_abs_err=full["max_abs_err"], ms=full["ms"],
        plain_ms=full["plain_ms"], bound_ms=full["bound_ms"],
        bound_by=full["bound_by"], library_ms=full["library_ms"],
        times_cover="ms: the ring's forward, p50 of 5 host-issued (CUDA "
                    "events); max_abs_err: out against the plain f32 ring "
                    "on the same inputs; plain: the plain f32 ring "
                    "(ring_attention); library: SDPA's forward over the "
                    "whole sequence; see full and causal for the "
                    "backward, the hop kernels alone, K4/K5 per hop and "
                    "one K4/K5 launch",
        full=full, causal=ring_run["causal"],
        checks={key: ring_run[key] for key in (
            "f32_vs_cpu", "bf16_vs_plain", "ulysses_vs_plain_ring")}))
    say(f"lamb_amp summary: step {lamb['step_ms_p50']:.2f} ms (AdamW, "
        f"phase 6: {train['step_ms_p50']:.2f}), host "
        f"{lamb['host_ms_p50']:.2f} ms, {lamb['samples_per_s']:.1f} "
        f"samples/s, optimizer {lamb['optimizer_share_of_step']:.3f} of the "
        f"step's stream time, alone {lamb['optimizer_alone']['ms']:.3f} ms "
        f"against a bound of {lamb['optimizer_alone']['bound_ms']:.3f}; rule "
        f"sweep worst {rule_sweep['max_err_over_tol']:.3g} of its "
        f"tolerance")
    say(f"timing: {json.dumps(TIMING)}")
    say(json.dumps({"kernels": kernels}))
    say(f"card: {card}")
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


#: the site sets ``--bn-sites`` times: (batch, channel axis, non-zero
#: cotangents), the shapes from :func:`bn_site_sets`
BN_SITE_SETS = {"resnet50": (256, 3, False),
                "mobilenet_v2": (MNV2_BATCH, 1, True),
                "resnet18_cifar": (DATA_BATCH, 1, True)}


def bn_site_sets(torch, vision, dev, name):
    """``[(shape, sites)]`` of one of :data:`BN_SITE_SETS`."""
    if name == "resnet50":
        return resnet50_bn_sites(256)
    if name == "mobilenet_v2":
        return mobilenet_v2_bn_sites(torch, vision, dev, MNV2_BATCH)
    return resnet18_cifar_bn_sites(torch, vision, dev, DATA_BATCH)


def bn_sites(root, names=tuple(BN_SITE_SETS)):
    """``--bn-sites ROOT [SETS]`` (the module docstring)."""
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    root = Path(root).resolve()
    check((root / "mxnet_tpu_torch" / "csrc" / "bn_train.cu").is_file(),
          f"no mxnet_tpu_torch package under {root}")
    sys.path.insert(0, str(root))
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.kernels import build, dispatch, norm as knorm

    check(Path(knorm.__file__).resolve().is_relative_to(root),
          f"imported {knorm.__file__}, not the package under {root}")
    build.build(["bn_train"])
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(77)
    result = dict(root=str(root), card=card_line())
    for name in names:
        batch, axis, cts = BN_SITE_SETS[name]
        sites = bn_site_sets(torch, vision, dev, name)
        total = {}
        for shape, k in sites:
            x, dy, g, b, sh, dm, dv = bn_operands(torch, gen, dev, shape,
                                                  axis, torch.bfloat16, cts,
                                                  0)
            want_f = knorm.bn_train_fwd_reference(x, g, b, sh, 1e-5, axis)
            bwd_args = (x, g, sh, want_f[1], want_f[3], dy, dm, dv, axis)
            times = bn_site_times(torch, F, knorm, dispatch, x, dy, g, b, sh,
                                  want_f, bwd_args, axis)
            for key, v in times.items():
                if isinstance(v, float):
                    total[key] = total.get(key, 0.0) + v * k
            if axis == 1:
                regime = [geo.regime for geo in bn_geometries(knorm, x, dy,
                                                                axis)]
                say("bn_site " + json.dumps(dict(
                    root=str(root), shape=list(shape), sites=k,
                    regime=regime, **{key: times[key] for key in (
                        "fwd_ms", "bwd_ms", "fwd_ms_l2_warm",
                        "bwd_ms_l2_warm", "fwd_ms_host_issued",
                        "bwd_ms_host_issued", "library_fwd_ms",
                        "library_bwd_ms", "fwd_bound_ms",
                        "bwd_bound_ms")})))
            del x, dy, want_f, bwd_args
            torch.cuda.empty_cache()
        result[f"{name}_batch{batch}_{sum(k for _, k in sites)}_sites"] = total
    say("bn_sites " + json.dumps(result))


#: the splits of K that ``--int8-plans`` tries beside 1
INT8_SWEEP_SPLITS = (2, 3, 4, 6, 8, 12, 16)


def int8_plans(batches=INT8_RUNGS):
    """``--int8-plans [BATCHES]`` (the module docstring)."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.kernels import build, int8 as kint8

    build.build(["int8_conv_wgmma", "int8_quant"])
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(25)
    lohi = torch.tensor([-2.0, 2.0], device=dev)
    result = dict(card=card_line())
    for batch, sites in int8_sites(torch, mt, vision, dev, batches).items():
        total = dict(plan_ms=0.0, best_ms=0.0, bound_ms=0.0)
        for site, count in sites:
            xs, ws, stride, pad, dil, groups, _, relu = site
            plan = kint8.plan_conv(*site[:6])
            if plan.variant != "wgmma":
                continue
            x, wq, wscale, bias = int8_site_operands(torch, kint8, site,
                                                     gen, dev)
            codes, info = kint8.quantize(x, lohi, True, channels_last=True)
            cold = cold_copies(torch, [codes])
            steps = -(-ws[1] * ws[2] * ws[3] // 128)
            times = {}
            for bm in (64, 128):
                for split in sorted({1, plan.split, *INT8_SWEEP_SPLITS}):
                    per = -(-steps // split)
                    if split > steps or (split - 1) * per >= steps:
                        continue
                    cand = kint8.ConvPlan("wgmma", bm, split)
                    times[f"{bm}x64/{split}"] = device_ms(torch, [
                        partial(kint8.conv, c[0], wq, stride, pad, dil,
                                groups, info[2:3], wscale, bias, relu,
                                plan=cand) for c in cold], iters=10)
            best = min(times, key=times.get)
            mine = f"{plan.bm}x64/{plan.split}"
            bound = int8_bounds(site)[1]
            total["plan_ms"] += times[mine] * count
            total["best_ms"] += times[best] * count
            total["bound_ms"] += bound * count
            say("int8_plan_site " + json.dumps(dict(
                batch=batch, site=[list(v) if isinstance(v, tuple) else v
                                   for v in site], count=count, plan=mine,
                plan_ms=times[mine], best=best, best_ms=times[best],
                bound_ms=bound, times=times)))
            del cold
            gc_collect(torch)
        result[f"batch{batch}"] = total
    say("int8_plans " + json.dumps(result))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--bn-sites"] and len(sys.argv) in (3, 4):
        bn_sites(sys.argv[2], *([sys.argv[3].split(",")]
                                if len(sys.argv) == 4 else []))
    elif sys.argv[1:2] == ["--ckpt-worker"] and len(sys.argv) == 5:
        sys.exit(ckpt_worker(*sys.argv[2:5]))
    elif sys.argv[1:2] == ["--int8-plans"] and len(sys.argv) in (2, 3):
        int8_plans(*([tuple(int(b) for b in sys.argv[2].split(","))]
                     if len(sys.argv) == 3 else []))
    else:
        main()
