#!/usr/bin/env python3
"""Smoke run of the PyTorch port (kubeflow_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``kubeflow_tpu_torch/csrc``,
holds each one against its plain PyTorch version on the card, then drives
the port's main paths on the flagship LM (d_model 1024, 12 layers, 8
heads of 128, 4 KV heads, d_ff 4096, vocab 32000, max_seq_len 1024; random
weights from a seed): it serves over HTTP through ``ServingServer`` and
``BatchedGenerator``, serves over HTTP through ``ContinuousBatchedGenerator``
(8 slots, 256-token prefill chunks, the prefix cache), trains through
``Trainer`` at batch 8 x 1024 with bf16 params and f32 masters, resumes a
Trainer from a checkpoint, and serves that checkpoint through
``build_server`` with a speculative draft in both engines; then it serves
and trains the MoE family at the flagship's width (``FLAGSHIP_MOE``: 8
experts, top-2) and finetunes the flagship with LoRA, serving the
adapters through ``build_server --lora-config``; and drives the
multi-device entry points (sharded train step, ``Trainer(mesh=...)``,
tp-sharded decode) on a NCCL world of one rank, and starts an h100-1
notebook's container: its world through ``runtime/bootstrap.py`` from
the env the port's pod spec renders; then it rolls a notebook whose node
dies onto a new world and resumes its training, and binds a notebook to
a warm pool slice and migrates its training off a preempted node onto a
warm spare, and admits two gangs under a tenant quota through the fleet
scheduler: one trains on the card, the other serves on it once the
first has gone; holds a notebook locked until the extension has
provisioned it; admits one through the port's own webhooks; and
creates, watches and resumes one over the port's own apiserver, its
culler probing the card's server through the apiserver's service
proxy; and reconciles one with the manager on the port's own HTTP
client, admitted by AdmissionReview, across an apiserver restart; and
runs the control plane as the port's own binaries, a leader-elected
pair of core managers and an extension manager, each a process, driven
by the port's CLI, the leader handing over on SIGTERM. The kernels'
launch counters, zeroed before each path and read after it, show that
each path ran its kernels.
Then it times each kernel beside its bound, its plain version and one
PyTorch library call computing the same function.

After the build it prints ptxas's registers and spills of every kernel
(a tensor-core kernel that spills fails the run), and the HGMMA (wgmma)
and UTMALDG (TMA load) instructions in the SASS of the bf16 tensor-core
kernels: forward, dK/dV and dQ, each at d_head 32/64/128. The bf16
kernels are held to their plain versions by an elementwise bound and by
the relative error of each 64-row tile (``check_tiles``).

Phases (any failure exits non-zero before the result line):
  1. flash-attention forward, kernel vs plain (bf16 at the train, prefill
     and served shapes and the small draft's served d_head 64, ragged
     lengths, d_head 32/64/128, a strided and a misaligned view; f32);
  2. flash-decode, kernel vs plain (bf16 and int8 cache at the
     flagship's D 128 and the small draft's D 64, pos from 0 to past the
     end), and two launches bit-identical;
  3. the serving path at full flagship width, counted launches, a
     streamed request refused (400, the JAX server's body) since the
     bucketed engine does not stream, and an f32 check of kernel-path
     tokens against the plain-attention path;
  4. where the time goes: one generate() under torch.profiler, device
     busy time by kernel class against host wall time;
  8. the continuous engine over HTTP on phase 3's params: 16 staggered
     streamed requests (tokens/s, time to first token), the prefix
     cache's exact counter deltas and a bit-identical resubmission, the
     inter-token gaps of a stream beside a 900-token admission at
     256-token and 1024-token chunks, a client that hangs up (one
     cancellation), steps_per_sync=4 giving the same ids, an EOS engine
     and an int8-KV engine; flash_decode launches = ticks x 12 and no
     flash_attention; an f32 engine teacher-forced through the plain
     forward; ticks that never synchronise with the card
     (``set_sync_debug_mode("error")``); 20 ticks under torch.profiler;
  6. flash-attention backward (dK/dV and dQ kernels) vs plain (the train
     shape in bf16 and f32, ragged length, f32), two dQ launches
     bit-identical, and the autograd Function through the kernels vs its
     plain backward;
  7. the train path at full flagship width: counted launches, throughput
     (median of 3 timed runs), share of the bf16 peak, peak memory, the
     host's CPU time, allocator calls and garbage collections in each run
     and each kernel wrapper's host cost a call, a falling loss, remat
     launch counts, an f32 loss/grad check against plain attention, a
     profiled step, whole-logits vs chunked CE at b8, b32 and b64;
  7b. a checkpoint round trip at full width: Trainer A (checkpoints every
     4 steps, keeping 1) trains 4 steps, Trainer B resumes from its step 4
     on the same directory, both run steps 5 and 6 on the same batches
     and agree bit for bit; bytes on disk, save (host snapshot and
     background write) and restore seconds; the small draft (d_model 512,
     6 layers, 8 heads of 64, d_ff 2048; seed 1) saved for phase 9;
  9. speculative serving of 7b's checkpoint (``build_server``
     --checkpoint, --draft-config/--draft-checkpoint, --spec-k 4,
     --spec-inexact): the restored ids equal the in-memory params'; the
     flagship as its own draft in f32 (every proposal accepted, ids equal
     generate's) and bf16 (how often flash-decode and the einsum verify
     window agree: the exactness gate's measurement); the small draft
     over HTTP in both engines (tokens/s, acceptance, time to first token,
     streams equal to their ids); launches = spec_ticks x 5 x 6
     (continuous) and spec_batches x 18 prefill + blocks x 5 x 6 decode
     (bucketed); spec_exact_only=True falls back (bucketed) or refuses
     (continuous); 10 ticks under set_sync_debug_mode("error") and 10
     under torch.profiler;
  10. the MoE at the flagship's width (f32 params from a seed, 5.2 GB,
     and a bf16 serving copy): in f32 at capacity factor 4 (no drops)
     prefill and a decode step through the kernels vs plain (every
     pick's expert and slot identical, logits within 2e-5) and an f32
     continuous engine over HTTP teacher-forced through the plain
     forward; at the default factor 1.25 in bf16 both engines over HTTP
     (tokens/s, time to first token), an identical request twice
     (bit-identical ids), a tick's sync-debug check and profile (idle
     share, kernels a tick), an int8-weight engine and an MoE target
     with the small draft, launches exact per engine; the Trainer at b8
     x s1024 (median of 3 runs of 3 steps, TFLOP/s on active params,
     peak memory), a falling loss and 12 of each attention kernel a step
     under remat="mlp", a step-3 checkpoint resumed bit-equal;
  11. LoRA (rank 8 on wq/wk/wv/wo) over 7b's restored params: 6 adapter
     steps (ms/step, checkpoint bytes, 12 of each attention kernel a
     step, the base bit-identical, a falling loss, ``merged_params()`` =
     ``merge_lora``), then ``build_server`` with --checkpoint,
     --lora-config and --lora-checkpoint serving 4 greedy requests whose
     ids equal an engine's on the merge made in memory;
  12. multi-device at a world of one rank (NCCL on the card): each
     differentiated collective of parallel/comm.py the identity forward
     and backward; ``make_sharded_train_step`` on ``MeshConfig()`` at b8
     x s1024 with bf16 params, 10 steps a run, attention "auto" and
     "ulysses", in turns with ``make_train_step`` on phase 7's seed and
     batches (one-device, auto, ulysses, auto, one-device; losses
     bit-equal or within 1e-6 relative; ms/step, tokens/s and peak
     memory of each run beside phase 7's; 12 of each attention kernel a
     step);
     a ``Trainer(mesh=...)`` checkpoint of step 4 resumed bit-equal over
     steps 5-6; ``shard_decode_params`` + greedy ``generate`` (8 x 128 ->
     64) equal to unsharded (flash-decode launches counted);
     ``speculative_generate`` of the f32 flagship as its own draft on the
     sharded params accepting every proposal; ``dryrun_multidevice(1,
     "cuda")``;
  15. the port's control plane provisions the card, after phases 12-14's
     world has ended: ``build_manager(simulate_kubelet=True)`` under
     ``start()`` reconciles an h100-1 Notebook; the simulator's ready
     hook turns worker 0 Ready only once ``initialize_slice`` +
     ``verify_slice`` (NCCL, device_count 1) have run on the pod's own
     env (pod index from its label, a free coordinator port), so
     SliceReady and ``status.readyReplicas == 1`` are the card's; the
     StatefulSet requests ``nvidia.com/gpu: 1`` under the H100
     selectors; an h100-16 Notebook renders 2 replicas, a headless
     Service and 2 hostnames; in the hook's world an h100-16
     expectation raises TimeoutError, ``Trainer(mesh=...)`` on
     ``build_mesh(MeshConfig.auto(1))`` runs 3 steps at b8 x s1024 with
     bf16 params, bit-equal to a one-device Trainer (12 of each
     attention kernel a step), greedy ``generate`` 8 x 128 -> 16 on
     ``shard_decode_params`` of the trained params equals the unsharded
     ``generate``; the idle culler (``CullingReconciler`` on the
     manager, checks enqueued with an advanced clock, probes through a
     local ``kubectl proxy`` whose Jupyter is a day idle): the h100-1
     notebook serves the trained params (``ServingServer`` over a
     continuous engine on the card, its port on the serving-port
     annotation and the Service), 8 requests arm the observed counter, 8
     more keep it up past the cull time, and with no traffic it and the
     h100-16 notebook are culled at one check: replicas [1, 0] and
     [2, 0], no pods, SliceReady False, flash_decode launches = ticks x
     12; then 100 Notebooks (60 h100-1, 30 h100-8, 10 h100-16) on a
     fresh manager with 4 workers, reading through the cache, all reach
     SliceReady within 60 s (CR→SliceReady p50/p95 in host ms); writes,
     reconciles, cache lookups and scans, ms/step, peak memory and the
     phase's seconds;
  16. slice repair on the card: ``build_manager`` with its slice repair
     reconciler under ``start()``; an h100-1 Notebook SliceReady in
     world A (the ready hook's NCCL world for its pod); in it a
     ``Trainer(mesh=...)`` with a ``checkpoint_dir`` runs 4 steps at b8 x
     s1024 with bf16 params and saves step 4 durably, greedy
     ``generate`` 8 x 128 -> 16 gives the ids; the worker's node is
     killed: the StatefulSet is rolled whole (replicas 1, 0, 1), the
     hook ends world A and forms and verifies world B for the new pod
     (kill -> Degraded -> 0 replicas -> SliceReady in host ms), the
     Degraded, RepairStarted and Repaired events, one repair duration
     sample; in world B a fresh Trainer restores step 4 (``generate``
     ids equal) and runs steps 5-6: 6 losses bit-equal to an
     uninterrupted 6-step Trainer, 12 of each attention kernel a step;
     then, on a second stack with one repairer on an advanced clock, a
     wedged h100-8 notebook (its pods' ``verify_slice`` refused on one
     card) is quarantined after 2 timed-out repairs, starts no repair
     while quarantined, and reaches SliceReady once its image is fixed
     and the quarantine cleared; the phase's seconds and peak memory;
  17. the warm SlicePool reconciler on the card, after phase 16's worlds
     have ended (``_pool_sequence``): ``build_manager`` (its SlicePool
     reconciler on, its repairer off) under ``start()`` beside one
     ``SliceRepairReconciler`` whose migrator is a
     ``CheckpointMigrationDriver`` over the live Trainer; the ready hook
     checks a pool slice's pod in one spawned child process, each check
     its own NCCL world of one rank on a free port, ended before it
     returns (``_WarmChecker``), and forms the cold notebook's world in
     this process; an h100-1 notebook with no pool (cold CR →
     SliceReady, host ms) is deleted; the pool ``h100-1-pool``
     (warmReplicas 1) warms w0; notebook A binds w0 in the first pool
     reconcile (warm CR → SliceReady beside the cold one, reconciles
     between, w0's pod uid unchanged and its replicas never 0, the
     SliceBound event, one bind-latency sample); A's world from w0's
     pod env, the pool's capacity raised to 2 (w1 checked in the child
     while A's world lives), ``Trainer(mesh=...)`` 4 steps at b8 x
     s1024 with bf16 params and ``generate`` 8 x 128 -> 16 on
     ``shard_decode_params``; a preemption notice on w0's node: the
     repairer checkpoints step 4, the pool re-binds A to w1 under the
     same identity and drains w0, world B forms from w1's pod env and
     the driver restores step 4 (preempt → Checkpointing → Binding →
     Resuming → SliceReady in host ms, checkpoint s and bytes, restore
     s); steps 5-6: 6 losses bit-equal to an uninterrupted Trainer,
     ``generate`` ids equal, 12 of each attention kernel a step; A
     stopped: w1 released scrubbed (pods recreated, no tenant label or
     annotation, no idle clock), re-warmed on the card and bound by a
     notebook of another namespace; ``slicepool_size`` by state; the
     phase's seconds and peak memory;
  18. the fleet scheduler on the card (``_sched_sequence``):
     ``build_manager`` with the scheduler on and
     ``sched_default_capacity=1`` (the one card is the fleet; no pool)
     under ``start()``, its poll out of reach so every admission is
     driven by a watch event; a TPUQuota caps tenant team-ds at 0
     slices: notebook ds (h100-1, a gang of 1, tier interactive) stays
     Pending and quota-denied with no StatefulSet, and the core's gate
     run again past ``sched_admission_grace_s`` raises no
     SchedulerAdmissionTimeout; notebook train (team-train, h100-1, a
     gang of 1, tier training) goes Pending → Reserving → Admitted, then
     its StatefulSet and worker 0 Ready once the ready hook's NCCL world
     from its pod env passes ``verify_slice``; ``Trainer(mesh=...)`` 4
     steps at b8 x s1024 with bf16 params, bit-equal to a one-device
     Trainer (12 of each attention kernel a step); team-ds's quota
     raised to 1: ds moves to no-capacity with no StatefulSet, train is
     not preempted (not elastic), ``scheduler_quota_used`` 1 for
     team-train and 0 for team-ds; train's world ended and the notebook
     deleted: the first scheduler pass of ds after the deletion's
     fan-out reserves it, then it is admitted, rolled and its own world
     formed; greedy ``generate`` 8 x 128 -> 16 on ``shard_decode_params``
     of train's final params equals the one-device ``generate``; CR →
     Admitted → SliceReady (host ms) for each, the gang wait per tenant,
     admissions by outcome, the scheduler's reconciles and writes; then
     phase 15's 100-notebook fleet twice in turns, without and with the
     scheduler (reconciles, writes, cache lookups and full scans);
  19. the extension reconciler on the card (``_ext_sequence``):
     ``build_manager(components="all", webhooks=False)`` under
     ``start()``; an h100-1 notebook created with the reconciliation
     lock and auth on stays at
     0 replicas with no pod until its finalizers, auth objects,
     NetworkPolicies, route, ReferenceGrant, trust bundle and runtime
     images exist, then is unlocked, rolled and trains 2 steps in its
     world bit-equal to phase 18's; auth off replaces its route without
     rolling the pod; ``generate`` ids equal; deleted, nothing is left;
     then phase 15's fleet on ``"core"`` and ``"all"``, in turns;
  20. the admission webhooks on the card (``_admission_sequence``): the
     port's AdmissionReview server on 127.0.0.1 (a CREATE review's
     JSONPatch equal to the in-process mutation, host ms per review; an
     h100-3 request denied 403; a body that is not JSON 400); then
     ``build_manager(components="all")`` (the webhooks in process) under
     ``start()``: an h100-1 notebook created with a JAX image and no
     lock is stored locked with the CUDA image and the kube-rbac-proxy
     sidecar, unlocked by the extension and rolled to SliceReady (CR →
     unlock → SliceReady in host ms); in its world 2 steps bit-equal to
     phase 19's and ``generate`` ids equal; the trust bundle's mount
     parked by a label touch on the running slice (pod spec, pod and
     world untouched) and a third step bit-equal to one device; a resize
     and the MLflow annotation's removal denied while it runs; stopped,
     the parked mount applied; deleted, nothing is left;
  21. the tracing tier on the card (``_trace_sequence``): a local OTLP
     collector on 127.0.0.1, the port's ``OtlpHttpExporter`` behind a
     ``FlightRecorder`` in a recording ``SDKProvider``, a JSON log
     handler with the ``CorrelationFilter`` and a ``HealthServer`` with
     the manager's registry and the recorder; on ``build_manager(
     components="all")`` an h100-1 notebook with a JAX
     image is locked and swapped by the webhook (its root span with the
     image-swapped event), stamped once with the trace-context
     annotation, unlocked and rolled to SliceReady in its world (CR →
     SliceReady host ms); the debug endpoint serves the stamped trace,
     every reconcile root a Notebook event caused after the stamp is in
     it, each with a ``workqueue.wait`` child, and its breakdown sums
     (queue + wire + reconcile = wall, wire 0); the collector holds
     every span the recorder holds; a queue-duration exemplar carries
     the stamped trace id; the JSON log lines of its reconciles carry
     its key and a trace id; 2 steps bit-equal to phase 20's and to one
     device's, ``generate`` ids equal; deleted, nothing is left; then
     phase 15's fleet twice in turns, untraced and recorded (seconds,
     CPU seconds, spans, traces held, notebooks traced);
  22. the wire's server half on the card (``_wire_sequence``): the
     port's ``ApiServerProxy`` (APF on) over its sharded store beside
     ``build_manager(components="all")``; over HTTP a
     LIST's anchor rv, a JSON and a binary watch from it, an h100-1
     notebook POSTed with a JAX image (201, locked, the CUDA image) and
     rolled to SliceReady in its world (host ms); both streams the same
     (type, rv) sequence up to SliceReady, each binary frame its JSON
     twin's object (bytes per event each); the JSON stream closed, a
     label patched, and a resume from the last rv read replaying exactly
     the frames missed; 410 with a Status body past an 8-frame ring and
     from an rv never issued; 2 steps bit-equal to phase 21's and to one
     device's, ``generate`` ids equal; the culler's probes through the
     apiserver's service proxy (a Jupyter stand-in, the card's
     ``ServingServer``): served traffic keeps it up past the cull time,
     then it is culled, every probe answered 200 through the apiserver;
     deleted over HTTP, nothing is left; then phase 15's fleet twice,
     on 8 shards and on 1 (SliceReady s, CPU s, the write-lock
     histogram), the sharded run over HTTP: a paged LIST equal to the
     unpaginated one, an rv=0 LIST from the serve cache, a malformed
     continue 422, and a JSON and a binary Pod watcher's fan-out bytes
     per frame;
  23. the manager over the wire on the card (``_http_sequence``): the
     port's ``ApiServerProxy`` over its sharded store with the
     simulator's own manager beside it, the port's ``AdmissionServer``
     registered by webhook configurations created through the port's
     ``HttpApiClient``, and ``build_manager(HttpApiClient(url),
     components="all")`` recording into a ``FlightRecorder``: an h100-1
     notebook created through the client is answered locked with the
     CUDA image after one mutating and one validating AdmissionReview,
     unlocked, rolled and read SliceReady through the manager's cache
     (host ms); 2 steps bit-equal to phase 22's and to one device's,
     ``generate`` ids equal; the controllers' requests by method, the
     stitched trace's ``rest.*`` spans and a ``wire`` leg above 0, the
     audit lines carrying its trace id; the apiserver stopped, a second
     notebook created during the outage, a new apiserver on the same
     port: every watch resumes from its last rv without a LIST and the
     second notebook turns SliceReady; both deleted, nothing is left;
     then phase 15's fleet with the manager on the client, JSON and
     binary (SliceReady s, CPU s, requests per notebook by method under
     60, connections opened, echoes dropped);
  24. the control plane as the port's binaries on the card
     (``_binary_sequence``): the apiserver's side in this process, three
     controller processes against it, two core managers (``python -m
     kubeflow_tpu_torch.main --leader-elect --components core
     --trace-debug``) and one extension manager serving the admission
     webhooks (``--components extension --webhook-port``), with 6 s
     leases; one ``python -m kubeflow_tpu_torch.cli apply -f`` registers
     the webhooks and creates an h100-1 notebook with a JAX image, stored
     locked with the CUDA image, unlocked by the extension and rolled by
     the leader to SliceReady (host ms; the standby reconciles nothing),
     which ``cli get -o json`` reads; 2 steps bit-equal to phase 23's and
     to one device's, ``generate`` ids equal; ``cli trace`` renders the
     stamped trace from the leader's debug endpoint; SIGTERM to the
     leader: exit 0, the standby holds the Lease (host ms, under half
     the lease); ``cli stop`` through the new leader; an apiserver outage
     opens its breaker (readyz 503 on ``apiserver``,
     ``apiserver_breaker_state`` 2), the restart closes it and resyncs;
     ``cli delete`` leaves nothing; every process exits 0 on SIGTERM and
     releases its Lease;
  5. times of each kernel, its plain version and a library call (last, so
     the paths above run on a card not yet warmed by timing loops), with
     the achieved TFLOP/s, the share of the bound, the forward, dK/dV and
     dQ against SDPA at the train shape, flash-decode against SDPA at
     the served pos and against its byte bound at a full cache, and the
     forward and flash-decode at the small draft's d_head 64 (held to
     their plain versions too).

The first lines name the card and its power limit; the line before the
last is the ``kernels`` JSON record; the last line is
``{"ok": true, "device": {...}}``. Exits non-zero without a result when
CUDA is unavailable or the package is not beside this file. Imports
neither JAX nor the JAX package.
"""

from __future__ import annotations

import functools
import gc
import json
import math
import os
import random
import re
import shutil
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, published
PEAK_FLOPS = {"bfloat16": 989e12,  # dense tensor-core bf16, published
              "float32": 67e12}    # f32 outside the tensor cores
BF16_TOL = 2e-2    # |kernel - plain|: ~4 bf16 ulps at |o| ~ 1; the two
                   # round p to bf16 against different running maxima
F32_TOL = 2e-5     # the JAX package's own kernel pin (tests/test_ops.py)
# the card's name and power limit (nvidia-smi), printed beside phase 14's
# numbers
CARD: list = []
LSE_TOL = 1e-4     # f32 row log-sum-exp, summation order only
# the JAX server's reply to a streamed request on the bucketed engine
STREAM_REFUSAL = ("engine BatchedGenerator does not support streaming; use "
                  "the continuous engine")
# bf16 grads, elementwise |kernel - plain| <= RTOL * |plain| + ATOL.
# RTOL: the two round f32 sums to bf16, at most one bf16 ulp (2^-7 of the
# value) apart, plus the f32 noise of the sums. ATOL: the dK/dV kernel
# rounds P and dS to bf16 (relative error <= 2^-9 each, as the reference
# does on its TPU) before its two accumulating products; the plain version
# keeps them in f32. An element of dV = sum_q P dO then moves by
# sum_q e_q P dO, |e_q| <= 2^-9, random in sign: about 2^-9 / sqrt(3) *
# sqrt(sum_q (P dO)^2). That root is largest for the first keys of a causal
# row (few queries, P up to 1, sum_q P^2 ~ 1.6 with |dO| ~ 1), where it
# gives a spread of ~1.5e-3, and it lands in full on an element whose sum
# cancels to near 0. 1e-2 is ~6.5 of those spreads, for the 8.4M elements
# of a grad at b8 s1024 h8 d128 (worst measured: 5.8e-3, NVIDIA H100).
BWD_BF16_RTOL = 1e-2
BWD_BF16_ATOL = 1e-2
# ||kernel - plain|| / ||plain|| over each tile of 64 rows (queries for the
# forward and dQ, keys for dK and dV) of one (batch, head): at most 1e-2,
# ~9x the 2^-9 / sqrt(3) a tile takes from bf16 rounding alone, so a tile
# that a kernel gets wrong shows even where the elementwise bound, scaled
# by the large values of the early causal rows, would let it pass. A tile
# whose plain values have an rms under TILE_RMS_FLOOR (rounding noise: dK
# at s = 1, where dS is 0 up to rounding) is measured against that floor.
TILE_ROWS = 64
TILE_REL_TOL = 1e-2
TILE_RMS_FLOOR = 1e-3
MODEL_GRAD_REL = 5e-4  # f32 model grads through flash vs plain attention,
                       # / max|grad| (the JAX package's pin, test_ops.py)
# f32 MoE logits, kernel path vs plain path on the same inputs at a
# non-binding capacity (the same routing): the port's forward pin
MOE_LOGITS_TOL = 2e-5


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def require(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def check_tiles(got, want, rows: int = TILE_ROWS,
                limit: float = TILE_REL_TOL) -> tuple[bool, float]:
    """(worst <= limit, worst): the largest ||got - want|| / ||want|| over
    the tiles of ``rows`` positions along dim 1 of (b, s, h, d) tensors,
    taken per (batch, head, tile), ||want|| floored at an rms of
    TILE_RMS_FLOOR. Uses tensor methods only, so this module imports
    nothing but the stdlib."""
    sq_err = (got.float() - want.float()).square()
    sq_ref = want.float().square()
    worst = 0.0
    for t0 in range(0, want.shape[1], rows):
        num = sq_err[:, t0:t0 + rows].sum(dim=(1, 3)).sqrt()
        den = sq_ref[:, t0:t0 + rows].sum(dim=(1, 3)).sqrt()
        n = sq_ref[:, t0:t0 + rows].shape[1] * want.shape[3]
        floor = TILE_RMS_FLOOR * math.sqrt(n)
        worst = max(worst, (num / den.clamp_min(floor)).max().item())
    return worst <= limit, worst


# ------------------------------------------------------------------ timing
class Timer:
    """Per-launch CUDA-event timing with the L2 cache flushed before every
    launch (a cold cache, as a decode step finds each layer's KV). A
    busy-wait kernel goes first, so the host has queued every launch
    before the card reaches them: the events time the card, not the
    host's launch overhead (tens of microseconds a call, the size of the
    kernels themselves)."""

    SLEEP_CYCLES = 200_000_000   # ~0.1 s at the H100's clock

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def ms(self, fn, iters: int = 20, warmup: int = 3) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(self.SLEEP_CYCLES)
        pairs = []
        for _ in range(iters):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in pairs) / iters


def sass_counts(lib) -> dict[str, tuple[int, int]]:
    """{kernel: (HGMMA, UTMALDG)}: the wgmma and TMA-load instructions in
    the SASS of each tensor-core kernel of a built library (cuobjdump)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    out = {}
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        name = part.split(None, 1)[0]
        if "wgmma" in name:
            out[name] = (part.count("HGMMA"), part.count("UTMALDG"))
    return out


def ptxas_report(log: str) -> dict[str, tuple[int, int, int]]:
    """{kernel: (registers, spill-store bytes, spill-load bytes)} from
    nvcc's ``-Xptxas -v`` output: each "Compiling entry function" line
    opens a kernel, its spill and register lines follow."""
    out: dict[str, list[int]] = {}
    name = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            out[name] = [0, 0, 0]
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name][1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name][0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


def bound(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# --------------------------------------------------------------- phase 1
def _as_layout(torch, x, layout: str):
    """``x`` (b, s, h, d) as a caller may hand it: as it is ("contig"), a
    strided view of one of q/k/v in a fused (b, s, 3, h, d) tensor
    ("fused"), or a view whose base is one element past an aligned one
    ("offset": the bf16 wrapper copies it for TMA)."""
    if layout == "fused":
        b, s, h, d = x.shape
        fused = torch.zeros((b, s, 3, h, d), dtype=x.dtype, device=x.device)
        fused[:, :, 1] = x
        return fused[:, :, 1]
    if layout == "offset":
        view = torch.empty(x.numel() + 1, dtype=x.dtype,
                           device=x.device)[1:].view(x.shape)
        view.copy_(x)
        return view
    return x


def phase_flash_attention(torch):
    from kubeflow_tpu_torch.ops.attention import (flash_attention_cuda,
                                                  flash_attention_plain)
    g = torch.Generator(device="cuda").manual_seed(1)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [  # (b, s, h, d, dtype, causal, layout)
        (8, 1024, 8, 128, bf16, True, "contig"),    # the train shape
        (8, 512, 8, 128, bf16, True, "contig"),     # flagship prefill
        (8, 128, 8, 128, bf16, True, "contig"),     # the served prompts
        (8, 128, 8, 64, bf16, True, "contig"),      # the draft prefill
        (2, 77, 8, 128, bf16, True, "contig"),      # ragged edge
        (2, 77, 8, 128, bf16, False, "contig"),
        (2, 65, 4, 64, bf16, True, "fused"),
        (2, 63, 4, 32, bf16, False, "offset"),
        (2, 128, 4, 64, f32, True, "contig"),
        (2, 100, 4, 32, f32, False, "contig"),
        (1, 200, 2, 128, f32, True, "contig"),
    ]
    flagship_err = 0.0
    for b, s, h, d, dt, causal, layout in cases:
        q, k, v = (_as_layout(torch, torch.randn(
            (b, s, h, d), generator=g, device="cuda", dtype=dt), layout)
            for _ in range(3))
        out, lse = flash_attention_cuda(q, k, v, causal, return_lse=True)
        torch.cuda.synchronize()
        ref, ref_lse = flash_attention_plain(q, k, v, causal,
                                             return_lse=True)
        err = (out.float() - ref.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        tiles_ok, tile_err = check_tiles(out, ref)
        tol = BF16_TOL if dt == bf16 else F32_TOL
        print(f"phase1 flash_attention b={b} s={s} h={h} d={d} "
              f"{str(dt)[6:]} causal={causal} {layout}: max|kernel-plain|="
              f"{err:.3e} (tol {tol:g}) lse err={lse_err:.3e} (tol "
              f"{LSE_TOL:g}) worst tile {tile_err:.3e} (tol "
              f"{TILE_REL_TOL:g})", flush=True)
        require(err <= tol and lse_err <= LSE_TOL and tiles_ok and
                bool(torch.isfinite(out).all()),
                f"flash_attention disagrees with its plain version at "
                f"{(b, s, h, d, dt, causal, layout)}")
        if b == 8 and dt == bf16:
            flagship_err = max(flagship_err, err)
    return flagship_err


# --------------------------------------------------------------- phase 2
def decode_inputs(torch, B=8, S=1024, G=4, rep=2, D=128,
                  dtype=None, seed=2):
    dtype = dtype or torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, G, rep, D), generator=g, device="cuda", dtype=dtype)
    k = torch.randn((B, S, G, D), generator=g, device="cuda", dtype=dtype)
    v = torch.randn((B, S, G, D), generator=g, device="cuda", dtype=dtype)
    return q, k, v


def phase_flash_decode(torch):
    from kubeflow_tpu_torch.models.decode import _quantize_kv
    from kubeflow_tpu_torch.ops.decode_attention import (
        flash_decode_attention_cuda, flash_decode_attention_plain)
    S = 1024
    positions = {"zero": [0] * 8, "mid-block": [300] * 8,
                 "last": [S - 1] * 8,
                 "mixed": [0, 1, 127, 128, 500, 777, S - 2, S - 1],
                 "past-end": [S + 5] * 8}
    errs = {"flash_decode": 0.0, "flash_decode_int8": 0.0}
    # the flagship's (D 128) and the small draft's (D 64) served shapes
    for dt, D in ((torch.bfloat16, 128), (torch.float32, 128),
                  (torch.bfloat16, 64)):
        q, k, v = decode_inputs(torch, D=D, dtype=dt)
        qk, ks = _quantize_kv(k)
        qv, vs = _quantize_kv(v)
        tol = BF16_TOL if dt == torch.bfloat16 else F32_TOL
        for label, pos in positions.items():
            pos = torch.tensor(pos, dtype=torch.int32, device="cuda")
            for name, kw, kk, vv in (
                    ("flash_decode", {}, k, v),
                    ("flash_decode_int8", {"k_scale": ks, "v_scale": vs},
                     qk, qv)):
                out = flash_decode_attention_cuda(q, kk, vv, pos, **kw)
                again = flash_decode_attention_cuda(q, kk, vv, pos, **kw)
                torch.cuda.synchronize()
                ref = flash_decode_attention_plain(q, kk, vv, pos, **kw)
                err = (out.float() - ref.float()).abs().max().item()
                same = torch.equal(out, again)
                print(f"phase2 {name} {str(dt)[6:]} D={D} pos={label}: "
                      f"max|kernel-plain|={err:.3e} (tol {tol:g}), two "
                      f"launches bit-identical: {same}", flush=True)
                require(err <= tol and same and
                        bool(torch.isfinite(out).all()),
                        f"{name} disagrees with its plain version or with "
                        f"itself ({dt}, D {D}, pos {label})")
                if dt == torch.bfloat16:
                    errs[name] = max(errs[name], err)
    for rep in (1, 4, 8):  # the GQA widths other configs use, small f32
        q, k, v = decode_inputs(torch, B=2, S=256, G=2, rep=rep, D=64,
                                dtype=torch.float32, seed=3)
        pos = torch.tensor([50, 255], dtype=torch.int32, device="cuda")
        err = (flash_decode_attention_cuda(q, k, v, pos) -
               flash_decode_attention_plain(q, k, v, pos)).abs().max().item()
        print(f"phase2 flash_decode f32 rep={rep} d=64: "
              f"max|kernel-plain|={err:.3e} (tol {F32_TOL:g})", flush=True)
        require(err <= F32_TOL, f"flash_decode rep={rep} disagrees")
    return errs


# --------------------------------------------------------------- phase 3
def _post(url: str, payload: dict, timeout: float = 300.0) -> dict:
    req = urllib.request.Request(
        url + "/v1/generate", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        require(resp.status == 200, f"/v1/generate answered {resp.status}")
        return json.loads(resp.read())


def _refused(url: str, payload: dict) -> tuple[int, dict]:
    """(status, JSON body) of a /v1/generate the server refuses."""
    try:
        _post(url, payload)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())
    fail(f"the server accepted {payload}")


def _concurrent(url: str, payloads: list[dict]) -> tuple[list[dict], float]:
    results: list = [None] * len(payloads)
    errors: list = []

    def worker(i):
        try:
            results[i] = _post(url, payloads[i])
        except Exception as e:  # noqa: BLE001 — re-raised below as a failure
            errors.append(f"request {i}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(payloads))]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.monotonic() - t0
    require(not errors and all(r is not None for r in results),
            f"concurrent requests failed: {errors}")
    return results, wall


def _check_ids(out: dict, n: int, vocab: int, what: str) -> list[int]:
    ids = out["ids"]
    require(isinstance(ids, list) and len(ids) == n and
            all(isinstance(t, int) and 0 <= t < vocab for t in ids),
            f"{what}: bad ids {ids!r}")
    require(out["usage"]["completion_tokens"] == n,
            f"{what}: usage {out['usage']}")
    return ids


def phase_serving(torch, flagship):
    from kubeflow_tpu_torch import ops
    from kubeflow_tpu_torch.models.decode import generate
    from kubeflow_tpu_torch.models.transformer import init_params
    from kubeflow_tpu_torch.runtime.server import ServingServer
    from kubeflow_tpu_torch.runtime.serving import BatchedGenerator

    c = flagship
    L, V = c.n_layers, c.vocab_size
    params = init_params(torch.Generator(device="cuda").manual_seed(0), c,
                         device="cuda")
    gen = BatchedGenerator(params, c, max_batch=8, max_wait_s=0.5,
                           device="cuda")
    server = ServingServer(gen, c, port=0).start()
    rng = torch.Generator().manual_seed(7)

    def prompt(n):
        return torch.randint(0, V, (n,), generator=rng).tolist()

    expected = {"flash_attention": 0, "flash_decode": 0,
                "flash_decode_int8": 0}

    def account(batches, max_new):
        expected["flash_attention"] += batches * L
        expected["flash_decode"] += batches * (max_new - 1) * L

    stats = {}
    try:
        ops.reset_launch_counts()
        # warm-up: the first batch initialises cuBLAS and the allocator
        n0 = gen.batches_total
        _check_ids(_post(server.url, {"prompt": prompt(8),
                                      "max_new_tokens": 2}), 2, V, "warmup")
        account(gen.batches_total - n0, 2)

        # 8 concurrent greedy requests: 128-token prompts, 64 new tokens
        n0 = gen.batches_total
        group_a = [{"prompt": prompt(128), "max_new_tokens": 64}
                   for _ in range(8)]
        outs, wall = _concurrent(server.url, group_a)
        for i, out in enumerate(outs):
            _check_ids(out, 64, V, f"greedy request {i}")
        batches_a = gen.batches_total - n0
        account(batches_a, 64)
        stats["serve_8x128p_64n_wall_s"] = wall
        stats["serve_8x128p_64n_batches"] = batches_a
        stats["serve_8x128p_64n_tokens_per_s"] = 8 * 64 / wall
        print(f"phase3 8 concurrent greedy requests (prompt 128, 64 new): "
              f"{batches_a} batch(es), {wall:.3f} s, "
              f"{8 * 64 / wall:.1f} generated tokens/s", flush=True)

        # 2 requests at a ragged 77-token prompt, one greedy, one sampled
        n0 = gen.batches_total
        outs, _ = _concurrent(server.url, [
            {"prompt": prompt(77), "max_new_tokens": 16},
            {"prompt": prompt(77), "max_new_tokens": 16,
             "temperature": 0.8, "top_k": 50, "top_p": 0.9}])
        for i, out in enumerate(outs):
            _check_ids(out, 16, V, f"77-token request {i}")
        account(gen.batches_total - n0, 16)

        # the bucketed engine does not stream: a streamed request gets the
        # JAX server's 400 and never reaches the engine; then the same
        # prompt twice, plain: a repeated greedy prompt at the same batch
        # shape gives the same ids
        p = prompt(128)
        n0 = gen.batches_total
        refusal = _refused(server.url, {"prompt": p, "max_new_tokens": 32,
                                        "stream": True})
        print(f"phase3 a streamed request to the bucketed engine: "
              f"{refusal}", flush=True)
        require(refusal == (400, {"error": STREAM_REFUSAL}) and
                gen.batches_total == n0,
                f"bucketed stream answered {refusal}")
        first = _check_ids(_post(server.url, {"prompt": p,
                                              "max_new_tokens": 32}),
                           32, V, "plain request")
        again = _check_ids(_post(server.url, {"prompt": p,
                                              "max_new_tokens": 32}),
                           32, V, "repeated request")
        require(again == first,
                "a repeated greedy prompt gave different ids")
        account(gen.batches_total - n0, 32)

        for path in ("/healthz", "/v1/models", "/metrics"):
            with urllib.request.urlopen(server.url + path, timeout=30) as r:
                require(r.status == 200, f"{path} answered {r.status}")

        # the int8 KV cache drives the int8 decode kernel
        kv_prompt = torch.randint(0, V, (2, 64), generator=rng).cuda()
        toks = generate(gen.params, kv_prompt, c, 8, kv_quant=True)
        torch.cuda.synchronize()
        require(toks.shape == (2, 8) and bool(((toks >= 0) &
                                                (toks < V)).all()),
                "generate(kv_quant=True) returned bad tokens")
        expected["flash_attention"] += L
        expected["flash_decode_int8"] += 7 * L
        counts = ops.launch_counts()
    finally:
        server.stop()
    print(f"phase3 launches {counts} expected {expected}", flush=True)
    for name, want in expected.items():
        require(counts[name] == want and want > 0,
                f"{name}: {counts[name]} launches on the main path, "
                f"expected {want}")
    return params, counts, stats


def phase_reference_tokens(torch, flagship, params):
    """f32, full width: greedy tokens through the kernels equal those
    through the plain attention paths (launches here are not counted)."""
    from kubeflow_tpu_torch.models.decode import generate, prefill
    c32 = flagship.replace(dtype="float32")
    plain = c32.replace(attention="xla", decode_attention="xla")
    prompt = torch.randint(0, c32.vocab_size, (2, 40),
                           generator=torch.Generator().manual_seed(9)).cuda()
    l_k, _ = prefill(params, prompt, c32)
    l_p, _ = prefill(params, prompt, plain)
    t_k = generate(params, prompt, c32, 12)
    t_p = generate(params, prompt, plain, 12)
    err = (l_k - l_p).abs().max().item()
    same = bool((t_k == t_p).all())
    print(f"phase3 f32 reference: prefill logits max|kernel-plain|="
          f"{err:.3e} (tol 1e-3), greedy tokens identical: {same}",
          flush=True)
    require(err <= 1e-3 and same,
            "the kernel path disagrees with the plain attention path")


# --------------------------------------------------------------- phase 4
def _kernel_class(name: str) -> str:
    low = name.lower()
    if "flash_fwd_kernel" in low:
        return "flash_attention (ours)"
    if "flash_bwd_dkv_kernel" in low:
        return "flash_attention_bwd_dkv (ours)"
    if "flash_bwd_dq_kernel" in low:
        return "flash_attention_bwd_dq (ours)"
    if "flash_decode_kernel" in low:
        return "flash_decode (ours)"
    if any(t in low for t in ("gemm", "xmma", "cutlass", "nvjet", "cublas",
                              "matmul")):
        return "matmul (cuBLAS)"
    if any(t in low for t in ("sort", "scan", "topk", "argmax", "reduce")):
        return "sort/reduce"
    return "elementwise/other"


def _device_ms(evt) -> float:
    us = getattr(evt, "self_device_time_total", None)
    if us is None:
        us = getattr(evt, "self_cuda_time_total", 0.0)
    return us / 1e3


# the runtime and driver calls that launch a kernel
_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx")


def _enqueues(key: str) -> bool:
    """Whether a CUDA API call of that name puts work on the
    device: a launch (of a kernel or a graph), a copy or a set."""
    return key.startswith("cu") and any(
        t in key for t in ("Launch", "Memcpy", "Memset"))


def _profile(torch, fn) -> dict:
    """Run ``fn`` once under torch.profiler: host wall, device busy time
    by kernel class, kernel count, idle share."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    by_class: dict[str, float] = {}
    by_key: dict[str, int] = {}
    launches = 0
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        cls = _kernel_class(evt.key)
        by_class[cls] = by_class.get(cls, 0.0) + _device_ms(evt)
        by_key[evt.key] = by_key.get(evt.key, 0) + evt.count
        launches += evt.count
    busy = sum(by_class.values())
    top = sorted(((evt.key[:90], _device_ms(evt), evt.count)
                  for evt in prof.key_averages()
                  if getattr(evt, "device_type", None)
                  == torch.autograd.DeviceType.CUDA),
                 key=lambda kv: -kv[1])[:12]
    # the kernels the host launched (the device's events can drop a few)
    host_launches = sum(evt.count for evt in prof.key_averages()
                        if evt.key in _LAUNCH_CALLS)
    # every call that put work on the device (launches, copies, sets):
    # exact, where the device's record loses events over a run
    host_enqueues = sum(evt.count for evt in prof.key_averages()
                        if getattr(evt, "device_type", None)
                        != torch.autograd.DeviceType.CUDA
                        and _enqueues(evt.key))
    # the host's side: ops and runtime calls by self CPU time (the
    # profiler's own cost included)
    host = sorted(((evt.key[:90], evt.self_cpu_time_total / 1e3, evt.count)
                   for evt in prof.key_averages()
                   if getattr(evt, "device_type", None)
                   != torch.autograd.DeviceType.CUDA),
                  key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall_ms, "device_busy_ms": busy if busy else None,
            "device_idle_share": (1 - busy / wall_ms) if busy else None,
            "device_kernels": launches, "host_launches": host_launches,
            "host_enqueues": host_enqueues,
            "device_counts": by_key,
            "busy_ms_by_class": by_class,
            "top_kernels_ms_count": top, "top_host_ms_count": host}


def _print_profile(phase: str, out: dict) -> None:
    busy = out["device_busy_ms"]
    if not busy:
        print(f"{phase} device time not measured: the profiler saw no CUDA "
              f"kernels", flush=True)
        return
    wall = out["wall_ms"]
    print(f"{phase} {out['shape']}: wall {wall:.2f} ms, device busy "
          f"{busy:.2f} ms (idle {100 * (1 - busy / wall):.1f}%), "
          f"{out['device_kernels']} kernels", flush=True)
    for cls, ms in sorted(out["busy_ms_by_class"].items(),
                          key=lambda kv: -kv[1]):
        print(f"{phase}   {cls}: {ms:.3f} ms ({100 * ms / busy:.1f}% of "
              f"busy)", flush=True)
    for name, ms, count in out["top_kernels_ms_count"]:
        print(f"{phase}     {ms:8.3f} ms {count:5d}x {name}", flush=True)
    for name, ms, count in out["top_host_ms_count"]:
        print(f"{phase}   host {ms:8.3f} ms {count:5d}x {name}", flush=True)


def phase_where_time_goes(torch, flagship, params):
    """One generate() at the served shape under torch.profiler: device
    busy time by kernel class against host wall time. Launches here are
    not counted."""
    from kubeflow_tpu_torch.models.decode import generate
    from kubeflow_tpu_torch.runtime.serving import cast_matmul_weights
    p = cast_matmul_weights(params, flagship.compute_dtype)
    prompt = torch.randint(0, flagship.vocab_size, (8, 128),
                           generator=torch.Generator().manual_seed(11)
                           ).cuda()
    generate(p, prompt, flagship, 4)              # warm
    out = {"shape": "generate B=8 prompt=128 new=16 bf16",
           **_profile(torch, lambda: generate(p, prompt, flagship, 16))}
    _print_profile("phase4", out)
    return out


# --------------------------------------------------------------- phase 8
def _stream_timed(url: str, payload: dict, close_after: int | None = None,
                  on_token=None) -> tuple[float, list]:
    """POST a streamed /v1/generate; (monotonic time of the post, [(time,
    event), ...] as each SSE event arrives). ``on_token(n)`` runs after
    the n-th token event; with ``close_after`` the client hangs up after
    that many token events."""
    import http.client
    host, port = url.rsplit("/", 1)[-1].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=300)
    t0 = time.monotonic()
    conn.request("POST", "/v1/generate",
                 body=json.dumps({**payload, "stream": True}),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    events, n_tok = [], 0
    try:
        require(resp.status == 200 and resp.getheader("Content-Type")
                == "text/event-stream", f"stream answered {resp.status}")
        while True:  # bounded: the server ends the stream (done or error)
            line = resp.fp.readline()
            if not line:
                break
            if not line.startswith(b"data: "):
                continue
            event = json.loads(line[len(b"data: "):])
            events.append((time.monotonic(), event))
            if "token" in event:
                n_tok += 1
                if on_token is not None:
                    on_token(n_tok)
            if event.get("done") or "error" in event or \
                    (close_after is not None and n_tok >= close_after):
                break
    finally:
        resp.close()
        conn.close()
    return t0, events


def _streamed_ids(events: list, n: int, vocab: int, what: str) -> list[int]:
    """The done event's ids, held to the streamed token events."""
    done = events[-1][1] if events else {}
    require(done.get("done") is True, f"{what}: stream did not finish: "
                                      f"{done}")
    streamed = [e["token"] for _, e in events[:-1]]
    require(streamed == done["ids"],
            f"{what}: streamed tokens differ from the done event's ids")
    return _check_ids(done, n, vocab, what)


def _staggered(url: str, prompts: list, max_new: int, vocab: int,
               temperatures: list | None = None) -> dict:
    """One streamed request a prompt (greedy, or at ``temperatures[i]``),
    posted 25 ms apart from threads: ids, wall (first post to last done
    event), time to first token."""
    results: list = [None] * len(prompts)
    errors: list = []
    temps = temperatures or [0.0] * len(prompts)

    def worker(i):
        try:
            results[i] = _stream_timed(url, {"prompt": prompts[i],
                                             "max_new_tokens": max_new,
                                             "temperature": temps[i]})
        except Exception as e:  # noqa: BLE001 — re-raised below as a failure
            errors.append(f"request {i}: {type(e).__name__}: {e}")

    threads = []
    t0 = time.monotonic()
    for i in range(len(prompts)):
        threads.append(threading.Thread(target=worker, args=(i,)))
        threads[-1].start()
        time.sleep(0.025)
    for t in threads:
        t.join(timeout=600)
    require(not errors and all(r is not None for r in results),
            f"staggered requests failed: {errors}")
    ids = [_streamed_ids(ev, max_new, vocab, f"staggered request {i}")
           for i, (_, ev) in enumerate(results)]
    wall = max(ev[-1][0] for _, ev in results) - t0
    ttft = sorted(ev[0][0] - t_post for t_post, ev in results)
    return {"ids": ids, "wall_s": wall,
            "tokens_per_s": len(prompts) * max_new / wall,
            "ttft_median_s": ttft[len(ttft) // 2], "ttft_max_s": ttft[-1]}


class _ServedEngine:
    """A continuous engine on the card behind ServingServer; the launch
    counters are zeroed when it starts, so ``launches`` reads this
    engine's traffic alone."""

    def __init__(self, torch, params, config, phase="phase8", **kw):
        from kubeflow_tpu_torch import ops
        from kubeflow_tpu_torch.runtime.server import ServingServer
        from kubeflow_tpu_torch.runtime.serving import \
            ContinuousBatchedGenerator
        self.ops, self.phase = ops, phase
        self.gen = ContinuousBatchedGenerator(params, config, n_slots=8,
                                              device="cuda", **kw)
        self.server = ServingServer(self.gen, config, port=0).start()
        self.url = self.server.url
        self.layers = config.n_layers
        ops.reset_launch_counts()

    def launches(self, name: str, what: str) -> int:
        """Every tick launches ``name`` once a layer and nothing else
        does: chunked prefill is decode_window's einsum."""
        counts = self.ops.launch_counts()
        want = {k: 0 for k in counts}
        want[name] = self.gen.steps_total * self.layers
        print(f"{self.phase} {what}: {self.gen.steps_total} ticks, launches "
              f"{counts}, expected {name} = ticks x {self.layers} = "
              f"{want[name]} and no other", flush=True)
        require(counts == want and want[name] > 0,
                f"{what}: launches {counts}, expected {want}")
        return want[name]

    def close(self):
        self.server.stop()


def _gaps(events: list) -> list[float]:
    times = [t for t, e in events if "token" in e]
    return sorted(b - a for a, b in zip(times, times[1:]))


def _stall(torch, served, vocab: int, rng) -> dict:
    """A streamed request (128-token prompt, 48 new) is running when a
    900-token prompt is admitted: its inter-token gaps."""
    long_prompt = torch.randint(0, vocab, (900,), generator=rng).tolist()
    box: dict = {}

    def admit_long():
        try:
            box["out"] = _post(served.url, {"prompt": long_prompt,
                                            "max_new_tokens": 16})
        except Exception as e:  # noqa: BLE001 — re-raised below
            box["error"] = f"{type(e).__name__}: {e}"

    thread = threading.Thread(target=admit_long)

    def post_long_at_8th_token(n):
        if n == 8:
            box["chunks0"] = served.gen.prefill_chunks_total
            thread.start()
    _, events = _stream_timed(
        served.url, {"prompt": torch.randint(0, vocab, (128,),
                                             generator=rng).tolist(),
                     "max_new_tokens": 48}, on_token=post_long_at_8th_token)
    thread.join(timeout=300)
    require("out" in box, f"the 900-token request failed: {box}")
    _check_ids(box["out"], 16, vocab, "900-token request")
    _streamed_ids(events, 48, vocab, "stalled stream")
    gaps = _gaps(events)
    return {"gap_median_ms": 1e3 * gaps[len(gaps) // 2],
            "gap_max_ms": 1e3 * gaps[-1],
            "chunks": served.gen.prefill_chunks_total - box["chunks0"]}


def _check_sync_free(torch, gen, what: str, phase="phase8") -> None:
    """A few of the engine's ticks (no readback) on the idle engine under
    torch.cuda.set_sync_debug_mode("error"): an op in the tick that
    waits for the card raises."""
    import traceback
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        gen._tick(2, False)
        gen._tick(2, True)
    except RuntimeError:
        torch.cuda.set_sync_debug_mode(0)
        fail(f"{what}: a tick synchronises with the card:\n"
             f"{traceback.format_exc()[-3000:]}")
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print(f"{phase} {what}: 4 ticks (greedy and sampling) ran under "
          f"set_sync_debug_mode('error') without a synchronising op",
          flush=True)


def _tick_host_ms(torch, gen, n: int = 20) -> dict:
    """Host ms a step on the idle engine, from this thread with no other
    thread busy, each timed run ending in a synchronise: the engine's
    tick (``_tick(1)``, no readback), ``decode_step`` alone with the
    engine's per-row pos, and with one scalar pos (``generate``'s path).
    Launches here are not counted."""
    from kubeflow_tpu_torch.models.decode import decode_step
    st = gen._state
    token = torch.zeros(gen.n_slots, dtype=torch.int32, device="cuda")
    runs = {"tick": lambda: gen._tick(1, False),
            "decode_step_per_row_pos": lambda: decode_step(
                gen.params, st["cache"], token, st["pos"], gen.config),
            "decode_step_scalar_pos": lambda: decode_step(
                gen.params, st["cache"], token, 100, gen.config)}
    out = {}
    for name, fn in runs.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        out[name] = (time.monotonic() - t0) / n * 1e3
    print(f"phase8 host ms a step on the idle engine, from the main thread "
          f"({n} steps each): " + ", ".join(f"{k} {v:.2f}"
                                           for k, v in out.items()),
          flush=True)
    return out


def phase_continuous(torch, flagship, params):
    """The continuous engine serving the flagship over HTTP (8 slots,
    prefill_chunk 256, prefix_cache_chunks 64): staggered arrivals, the
    prefix cache, streaming beside a chunked 900-token admission (and the
    same with monolithic prefill), a client that hangs up, multi-step
    sync, EOS and int8 KV engines, launch counts, an f32 teacher-forced
    check, the no-sync tick, and a profiled window of 20 ticks."""
    c = flagship
    V = c.vocab_size
    rng = torch.Generator().manual_seed(13)

    def prompt(n):
        return torch.randint(0, V, (n,), generator=rng).tolist()

    stats: dict = {}
    launches = {"flash_decode": 0, "flash_decode_int8": 0}
    staggered_prompts = [prompt(128) for _ in range(16)]

    e1 = _ServedEngine(torch, params, c)
    gen = e1.gen
    try:
        _check_ids(_post(e1.url, {"prompt": prompt(128),
                                  "max_new_tokens": 8}), 8, V, "warm-up")
        # staggered: 16 greedy requests, one every 25 ms
        run = _staggered(e1.url, staggered_prompts, 64, V)
        require(gen.admitted_while_running >= 1,
                "no request joined a running batch")
        stats["staggered"] = {k: v for k, v in run.items() if k != "ids"}
        print(f"phase8 staggered 16 x (prompt 128, 64 new), 25 ms apart: "
              f"wall {run['wall_s']:.3f} s, {run['tokens_per_s']:.1f} "
              f"generated tokens/s, {gen.steps_total} ticks so far, time "
              f"to first token median {1e3 * run['ttft_median_s']:.1f} ms "
              f"max {1e3 * run['ttft_max_s']:.1f} ms, admitted while "
              f"running {gen.admitted_while_running}", flush=True)

        # prefix cache: a 512-token preamble; 576 tokens are 3 chunks of
        # 256 of which the first 2 are cacheable
        preamble = prompt(512)
        first = preamble + prompt(64)
        hits0, chunks0 = gen.prefix_cache_hits_total, \
            gen.prefill_chunks_total
        ids_first = _check_ids(_post(e1.url, {"prompt": first,
                                              "max_new_tokens": 32}),
                               32, V, "prefix request 0")
        outs, _ = _concurrent(e1.url, [
            {"prompt": preamble + prompt(64), "max_new_tokens": 32}
            for _ in range(4)])
        for i, out in enumerate(outs):
            _check_ids(out, 32, V, f"prefix request {i + 1}")
        hits = gen.prefix_cache_hits_total - hits0
        chunks = gen.prefill_chunks_total - chunks0
        again = _check_ids(_post(e1.url, {"prompt": first,
                                           "max_new_tokens": 32}),
                           32, V, "prefix request 0 again")
        print(f"phase8 prefix cache, 5 requests with one 512-token "
              f"preamble: hits +{hits} (expected +8), chunks +{chunks} "
              f"(expected +7); the first request again gives the same ids: "
              f"{again == ids_first}", flush=True)
        require(hits == 8 and chunks == 7,
                f"prefix cache: hits +{hits}, chunks +{chunks}")
        require(again == ids_first,
                "a prefix-cache hit changed a greedy request's ids")

        # streaming beside a chunked 900-token admission
        stall = _stall(torch, e1, V, rng)
        stats["stall_chunk_256"] = stall
        print(f"phase8 stream of 48 beside a 900-token admission "
              f"(prefill_chunk 256, {stall['chunks']} chunks): inter-token "
              f"gap median {stall['gap_median_ms']:.2f} ms, max "
              f"{stall['gap_max_ms']:.2f} ms", flush=True)

        # a client that hangs up after 5 events
        cancelled0 = gen.cancelled_total
        _, events = _stream_timed(e1.url, {"prompt": prompt(128),
                                           "max_new_tokens": 200},
                                  close_after=5)
        require(sum("token" in e for _, e in events) == 5,
                "the cancelled stream did not deliver 5 tokens")
        deadline = time.monotonic() + 60
        while gen.cancelled_total == cancelled0 and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        require(gen.cancelled_total == cancelled0 + 1,
                f"cancelled_total {gen.cancelled_total}, expected "
                f"{cancelled0 + 1}")
        _check_ids(_post(e1.url, {"prompt": prompt(64),
                                  "max_new_tokens": 8}), 8, V,
                   "request after the cancellation")
        print(f"phase8 a client closing after 5 of 200 tokens: "
              f"cancelled_total +1, the next request completed",
              flush=True)

        # 8 rows submitted 25 ms apart straight to the engine (no HTTP),
        # timed from the tick all 8 are armed until they finish: once
        # unprofiled, once under torch.profiler
        def armed_window(fn):
            admitted0 = gen.admitted_total
            futures = []
            for p in staggered_prompts[:8]:
                futures.append(gen.submit(p, 64))
                time.sleep(0.025)
            deadline = time.monotonic() + 60
            while gen.admitted_total < admitted0 + 8 and \
                    time.monotonic() < deadline:
                time.sleep(0.001)
            s0, t0 = gen.steps_total, time.monotonic()
            out = fn(lambda: [f.result(timeout=300) for f in futures])
            ticks = gen.steps_total - s0
            require(ticks > 0, "no tick ran with 8 rows armed")
            return out, ticks, (time.monotonic() - t0) / ticks * 1e3

        _, ticks, tick_ms = armed_window(lambda wait: wait())
        prof, prof_ticks, _ = armed_window(lambda wait: {
            "shape": "continuous engine, 8 rows armed until done",
            **_profile(torch, wait)})
        _print_profile("phase8", prof)
        busy = prof["device_busy_ms"]
        stats["tick_ms_unprofiled"] = tick_ms
        stats["profile"] = prof
        if busy:
            busy_tick = busy / prof_ticks
            device = (f"device busy {busy_tick:.3f} ms a tick, idle "
                      f"{100 * (1 - busy / prof['wall_ms']):.1f}% of the "
                      f"profiled window and "
                      f"{100 * (1 - busy_tick / tick_ms):.1f}% of the "
                      f"unprofiled tick")
        else:
            device = "device time not measured"
        print(f"phase8 tick with 8 rows armed: {tick_ms:.2f} ms unprofiled "
              f"({ticks} ticks), {prof['wall_ms'] / prof_ticks:.2f} ms "
              f"profiled ({prof_ticks} ticks); {device}", flush=True)
        launches["flash_decode"] += e1.launches("flash_decode",
                                                "engine 1 (256-token chunks)")
        stats["steps_total"] = gen.steps_total
        _check_sync_free(torch, gen, "bf16 engine")
        stats["host_ms_a_step_alone"] = _tick_host_ms(torch, gen)
    finally:
        e1.close()

    mono = _ServedEngine(torch, params, c, prefill_chunk=1024)
    try:
        _check_ids(_post(mono.url, {"prompt": prompt(128),
                                    "max_new_tokens": 8}), 8, V, "warm-up")
        stall = _stall(torch, mono, V, rng)
        stats["stall_chunk_1024"] = stall
        print(f"phase8 stream of 48 beside a 900-token admission "
              f"(prefill_chunk 1024, {stall['chunks']} chunk): inter-token "
              f"gap median {stall['gap_median_ms']:.2f} ms, max "
              f"{stall['gap_max_ms']:.2f} ms", flush=True)
        launches["flash_decode"] += mono.launches(
            "flash_decode", "monolithic-prefill engine")
    finally:
        mono.close()

    e4 = _ServedEngine(torch, params, c, steps_per_sync=4)
    try:
        run4 = _staggered(e4.url, staggered_prompts, 64, V)
        same = [a == b for a, b in zip(run4["ids"], run["ids"])]
        stats["staggered_steps_per_sync_4"] = {
            k: v for k, v in run4.items() if k != "ids"}
        print(f"phase8 steps_per_sync=4, the staggered traffic again: "
              f"{run4['tokens_per_s']:.1f} generated tokens/s (against "
              f"{run['tokens_per_s']:.1f} at 1), wall {run4['wall_s']:.3f} "
              f"s, time to first token median "
              f"{1e3 * run4['ttft_median_s']:.1f} ms; ids equal prompt by "
              f"prompt: {sum(same)} of {len(same)}", flush=True)
        require(all(same), "steps_per_sync=4 changed greedy ids")
        launches["flash_decode"] += e4.launches("flash_decode",
                                                "steps_per_sync=4 engine")
    finally:
        e4.close()

    # EOS at the 5th greedy token of a prompt whose first 4 lack it
    k = next((i for i, ids in enumerate(run["ids"])
              if ids[4] not in ids[:4]), None)
    require(k is not None, "no staggered prompt has a fresh 5th token")
    want = run["ids"][k][:5] + [0] * 59
    eos = _ServedEngine(torch, params, c, eos_id=run["ids"][k][4])
    try:
        out = _post(eos.url, {"prompt": staggered_prompts[k],
                              "max_new_tokens": 64})
        print(f"phase8 eos_id = the 5th greedy token: the first 5 ids, then "
              f"pad_id: {out['ids'] == want}", flush=True)
        require(out["ids"] == want and
                out["usage"]["completion_tokens"] == 5,
                f"EOS engine gave {out['ids'][:8]}..., expected "
                f"{want[:8]}...")
        launches["flash_decode"] += eos.launches("flash_decode",
                                                 "eos engine")
    finally:
        eos.close()

    kv = _ServedEngine(torch, params, c, kv_quant=True)
    try:
        outs, wall = _concurrent(kv.url, [
            {"prompt": p, "max_new_tokens": 32}
            for p in staggered_prompts[:8]])
        for i, out in enumerate(outs):
            _check_ids(out, 32, V, f"int8-KV request {i}")
        print(f"phase8 kv_quant=True, 8 concurrent (prompt 128, 32 new): "
              f"{wall:.3f} s, {8 * 32 / wall:.1f} generated tokens/s",
              flush=True)
        launches["flash_decode_int8"] += kv.launches(
            "flash_decode_int8", "int8-KV engine")
        _check_sync_free(torch, kv.gen, "int8-KV engine")
    finally:
        kv.close()

    stats["f32_margin"] = _f32_anchor(torch, c, params,
                                      staggered_prompts[:4])
    stats["launches"] = launches
    return launches, stats


def _f32_anchor(torch, flagship, params, prompts) -> float:
    """An f32 engine at full width (TF32 off): 4 staggered requests of 16
    greedy tokens, each teacher-forced through the f32 forward with plain
    attention. Every greedy token's logit is within 1e-3 of its
    position's maximum (a near-tie cannot fail this; a wrong token
    does). Launches here are not counted."""
    from kubeflow_tpu_torch.models.transformer import forward
    from kubeflow_tpu_torch.runtime.serving import ContinuousBatchedGenerator
    c32 = flagship.replace(dtype="float32")
    with ContinuousBatchedGenerator(params, c32, n_slots=8,
                                    device="cuda") as gen:
        futures = []
        for p in prompts:
            futures.append(gen.submit(p, 16))
            time.sleep(0.025)
        results = [f.result(timeout=300).tolist() for f in futures]
    plain = c32.replace(attention="xla")
    worst = _teacher_forced_gap(
        torch, lambda tokens: forward(params, tokens, plain), prompts,
        results)
    print(f"phase8 f32 engine, 4 staggered requests of 16: the largest gap "
          f"between a greedy token's teacher-forced logit and its "
          f"position's maximum is {worst:.3e} (tol 1e-3)", flush=True)
    require(worst <= 1e-3, "the f32 engine chose a token the f32 forward "
                           "does not rank first")
    return worst


def _teacher_forced_gap(torch, logits_fn, prompts, results) -> float:
    """The largest gap between a generated token's logit and its
    position's maximum when each prompt + ids runs through ``logits_fn``
    (tokens (1, n) → logits (1, n, vocab)): 0 when every token is the
    forward's argmax."""
    worst = 0.0
    with torch.no_grad():
        for p, ids in zip(prompts, results):
            tokens = torch.tensor([p + ids], device="cuda")
            logits = logits_fn(tokens)[0, len(p) - 1:-1]
            ids_t = torch.tensor(ids, device="cuda")
            chosen = logits.gather(1, ids_t[:, None])[:, 0]
            worst = max(worst, (logits.max(dim=1).values - chosen)
                        .max().item())
    return worst


# --------------------------------------------------------------- phase 6
def _random_qkvdo(torch, b, s, h, d, dt, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn((b, s, h, d), generator=g, device="cuda", dtype=dt)
            for _ in range(4)]


def _bwd_err(torch, got, want, dt) -> tuple[float, float, float]:
    """(max |kernel - plain| over the grads, the largest share of its
    tolerance any element takes, the worst tile's relative error): the
    kernels agree when the share is <= 1 and the tile error <=
    TILE_REL_TOL. f32 is held to F32_TOL, bf16 elementwise to
    BWD_BF16_RTOL * |plain| + BWD_BF16_ATOL."""
    err = share = tile = 0.0
    for a, b in zip(got, want):
        diff = (a.float() - b.float()).abs()
        tol = (torch.full_like(diff, F32_TOL) if dt == torch.float32 else
               BWD_BF16_RTOL * b.float().abs() + BWD_BF16_ATOL)
        err = max(err, diff.max().item())
        share = max(share, (diff / tol).max().item())
        tile = max(tile, check_tiles(a, b)[1])
    return err, share, tile


def phase_flash_backward(torch):
    """Both backward kernels against flash_attention_bwd_plain on the same
    (q, k, v, o, lse, dO), then the autograd Function through the kernels
    against its plain backward. Launches here are not counted."""
    from kubeflow_tpu_torch.ops.attention import (
        flash_attention, flash_attention_bwd_cuda,
        flash_attention_bwd_dq_cuda, flash_attention_bwd_plain,
        flash_attention_cuda, prepare_bwd_inputs)
    cases = [  # (b, s, h, d, dtype, causal)
        (8, 1024, 8, 128, torch.bfloat16, True),    # the training shape
        (8, 1024, 8, 128, torch.float32, True),     # same template, f32
        (2, 77, 8, 128, torch.bfloat16, True),      # ragged edge
        (2, 77, 8, 128, torch.bfloat16, False),
        (2, 128, 4, 64, torch.float32, True),
        (1, 200, 2, 128, torch.float32, True),
        (1, 200, 2, 128, torch.float32, False),
    ]
    train_err = 0.0
    for i, (b, s, h, d, dt, causal) in enumerate(cases):
        q, k, v, do = _random_qkvdo(torch, b, s, h, d, dt, 20 + i)
        o, lse = flash_attention_cuda(q, k, v, causal, return_lse=True)
        got = flash_attention_bwd_cuda(q, k, v, o, lse, do, causal)
        torch.cuda.synchronize()
        want = flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
        err, share, tile = _bwd_err(torch, got, want, dt)
        scale = max(w.float().abs().max().item() for w in want)
        print(f"phase6 flash_attention_bwd b={b} s={s} h={h} d={d} "
              f"{str(dt)[6:]} causal={causal}: max|kernel-plain| over "
              f"dq/dk/dv={err:.3e} (max|plain| {scale:.3e}), worst element "
              f"at {share:.3f} of its tolerance, worst tile {tile:.3e} "
              f"(tol {TILE_REL_TOL:g})", flush=True)
        require(share <= 1 and tile <= TILE_REL_TOL and
                all(bool(torch.isfinite(x).all()) for x in got),
                f"flash_attention backward disagrees with its plain version "
                f"at {(b, s, h, d, dt, causal)}")
        if (b, s, dt) == (8, 1024, torch.bfloat16):
            train_err = err
            q2, k2, v2, do2, lse2, delta = prepare_bwd_inputs(q, k, v, o,
                                                              lse, do)
            same = torch.equal(
                flash_attention_bwd_dq_cuda(q2, k2, v2, do2, lse2, delta),
                flash_attention_bwd_dq_cuda(q2, k2, v2, do2, lse2, delta))
            print(f"phase6 dQ kernel at the train shape: two launches "
                  f"bit-identical: {same}", flush=True)
            require(same, "two launches of the dQ kernel differ")
            del q2, k2, v2, do2, lse2, delta
        del q, k, v, do, o, lse, got, want
    for b, s, h, d, dt in ((2, 77, 8, 128, torch.bfloat16),
                           (2, 128, 4, 64, torch.float32)):
        q, k, v, do = _random_qkvdo(torch, b, s, h, d, dt, 40)
        q, k, v = (x.requires_grad_() for x in (q, k, v))
        out = flash_attention(q, k, v, causal=True)
        # a strided dO, as grads out of an einsum arrive
        strided = do.transpose(1, 2).contiguous().transpose(1, 2)
        got = torch.autograd.grad(out, (q, k, v), strided)
        o, lse = flash_attention_cuda(q.detach(), k.detach(), v.detach(),
                                      True, return_lse=True)
        want = flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(),
                                         o, lse, do, True)
        err, share, tile = _bwd_err(torch, got, want, dt)
        print(f"phase6 autograd flash_attention b={b} s={s} {str(dt)[6:]}: "
              f"max|kernel grads - plain backward|={err:.3e}, worst element "
              f"at {share:.3f} of its tolerance, worst tile {tile:.3e}",
              flush=True)
        require(share <= 1 and tile <= TILE_REL_TOL,
                "flash_attention's autograd through the kernels disagrees "
                "with its plain backward")
    return train_err


# --------------------------------------------------------------- phase 7
def _step_ms(torch, step_fn, state, batch, n=3) -> tuple[float, float,
                                                          float]:
    """Mean host wall of ``n`` synchronised steps (after one warm-up), the
    peak device memory the steps allocate above what was allocated when
    they started, and the peak itself (GB)."""
    params, opt = state
    tokens, targets = batch
    params, opt, _ = step_fn(params, opt, tokens, targets)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.monotonic()
    for _ in range(n):
        params, opt, _ = step_fn(params, opt, tokens, targets)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return ((time.monotonic() - t0) / n * 1e3, (peak - base) / 1e9,
            peak / 1e9)


def phase_train(torch, flagship):
    """The train path at full flagship width: Trainer(bf16 params) on
    synthetic 8 x 1024 batches, 2 warm-up steps and 3 timed runs of 10,
    launch counts checked against the steps, throughput (the median run)
    and peak memory, what the host did in each run and what one call of
    each kernel wrapper costs it; then the checks and measurements listed
    in the module docstring."""
    from kubeflow_tpu_torch import ops
    from kubeflow_tpu_torch.models import train as train_lib
    from kubeflow_tpu_torch.models import transformer as tfm
    from kubeflow_tpu_torch.runtime.data import synthetic_lm_batches
    from kubeflow_tpu_torch.runtime.trainer import Trainer
    from kubeflow_tpu_torch.tools.train_step_time import (host_us_per_call,
                                                          timed_fit)

    c = flagship
    L, V, B, S = c.n_layers, c.vocab_size, 8, 1024
    warm, timed, runs = 2, 10, 3
    flops_tok = tfm.model_flops_per_token(c)
    stats: dict = {"shape": f"b{B} s{S} bf16 params + f32 masters",
                   "params": None}
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(c, train_lib.TrainConfig(bf16_params=True),
                      device="cuda", seed=0)
    stats["params"] = tfm.count_params(trainer.params)
    src = synthetic_lm_batches(B, S, V, seed=0)
    ops.reset_launch_counts()
    trainer.fit(src, steps=warm, log_every=warm)
    host = [timed_fit(trainer, src, timed) for _ in range(runs)]
    counts = ops.launch_counts()
    steps = warm + runs * timed
    expected = {"flash_attention": L * steps,
                "flash_attention_bwd_dkv": L * steps,
                "flash_attention_bwd_dq": L * steps}
    print(f"phase7 launches {counts} expected {expected}", flush=True)
    for name, want in expected.items():
        require(counts[name] == want, f"{name}: {counts[name]} launches on "
                                      f"the train path, expected {want}")
    stats["launches"] = {k: counts[k] for k in expected}
    # per run: wall and CPU ms a step, allocator calls, garbage collections
    for i, r in enumerate(host):
        print(f"phase7 host, run {i} of {timed} steps: {json.dumps(r)}",
              flush=True)
    calls = host_us_per_call()
    print(f"phase7 host us per wrapper call (behind a busy-wait; each "
          f"attention wrapper runs {L} times a step): {json.dumps(calls)}",
          flush=True)
    stats.update({"host_runs": host, "host_us_per_call": calls})
    losses = [loss for _, loss in trainer.stats.losses]
    require(all(math.isfinite(x) for x in losses), f"losses {losses}")
    ms = sorted(r["ms_per_step"] for r in host)[runs // 2]
    tok_s = B * S / ms * 1e3
    tflops = 3 * flops_tok * tok_s / 1e12
    stats.update({
        "steps_timed": runs * timed, "ms_per_step": ms,
        "tokens_per_s": tok_s, "model_tflops_per_s": tflops,
        "bf16_peak_share": tflops * 1e12 / PEAK_FLOPS["bfloat16"],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "losses": losses})
    print(f"phase7 train {stats['shape']}, {stats['params']} params: "
          f"{stats['ms_per_step']:.2f} ms/step (median of {runs} runs: "
          f"{[round(r['ms_per_step'], 2) for r in host]}), {tok_s:.1f} "
          f"tokens/s, "
          f"{tflops:.2f} model TFLOP/s = {100 * stats['bf16_peak_share']:.2f}"
          f"% of the bf16 peak, peak memory {stats['peak_mem_gb']:.2f} GB, "
          f"losses {losses}", flush=True)

    # one profiled step (launches not counted past this point)
    batch = next(iter(synthetic_lm_batches(B, S, V, seed=3)))
    batch = tuple(torch.from_numpy(x).cuda() for x in batch)
    state = (trainer.params, trainer.opt_state)
    prof = {"shape": f"train step b{B} s{S} bf16",
            **_profile(torch, lambda: trainer.step_fn(*state, *batch))}
    _print_profile("phase7", prof)
    # the profiler slows the host; against the unprofiled step time
    busy = prof["device_busy_ms"]
    prof["device_idle_share_unprofiled"] = \
        1 - busy / stats["ms_per_step"] if busy else None
    if busy:
        print(f"phase7 device busy {busy:.2f} ms of the unprofiled "
              f"{stats['ms_per_step']:.2f} ms step: idle "
              f"{100 * prof['device_idle_share_unprofiled']:.1f}%",
              flush=True)
    stats["profile"] = prof

    # whole-logits vs chunked CE, each loss named outright to train_step
    # (build_loss picks one by CE_FUSE_THRESHOLD_BYTES), in turns (whole,
    # chunked, chunked, whole), at b8, b32 and b64 (8.4e9 bytes of logits,
    # just above the threshold)
    optimizer = train_lib.make_optimizer(trainer.tc)
    losses = {"whole": lambda p, t, tg: train_lib.loss_fn(p, t, tg, c),
              "chunked": lambda p, t, tg: train_lib.fused_loss_fn(
                  p, t, tg, c, chunk_tokens=512)}
    ce = {}
    for b in (B, 32, 64):
        rows = tuple(torch.from_numpy(x).cuda() for x in next(iter(
            synthetic_lm_batches(b, S, V, seed=4))))
        turns = {"whole": [], "chunked": []}
        for name in ("whole", "chunked", "chunked", "whole"):
            step = functools.partial(train_lib.train_step,
                                     loss=losses[name], optimizer=optimizer)
            turns[name].append(_step_ms(torch, step, state, rows,
                                        n=3 if b == B else 2))
        ce[f"b{b}"] = turns
        print(f"phase7 CE at b{b} s{S} vocab {V} ({b * S * V * 4 / 1e9:.2f} "
              f"GB f32 logits), (ms/step, step's peak GB above its start, "
              f"peak GB) in turns: whole {turns['whole']}, chunked(512) "
              f"{turns['chunked']}", flush=True)
        del rows
        torch.cuda.empty_cache()
    stats["ce_ms_peak_gb"] = ce
    del trainer, state
    torch.cuda.empty_cache()

    # the loss on one repeated batch falls over 10 steps (warmup 1)
    one = next(iter(synthetic_lm_batches(B, S, V, seed=5)))
    with Trainer(c, train_lib.TrainConfig(bf16_params=True, warmup_steps=1),
                 device="cuda", seed=1) as tr:
        tr.fit([one] * 10, steps=10, log_every=1)
        curve = [loss for _, loss in tr.stats.losses]
    print(f"phase7 repeated batch, 10 steps: losses {curve}", flush=True)
    require(all(math.isfinite(x) for x in curve) and curve[-1] < curve[0],
            f"the loss on a repeated batch did not fall: {curve}")
    stats["repeated_batch_losses"] = curve

    # remat launches: True re-runs each layer's forward, "attn" replays it
    for remat, fwd in ((True, 2 * L), ("attn", L)):
        with Trainer(c.replace(remat=remat),
                     train_lib.TrainConfig(bf16_params=True),
                     device="cuda", seed=2) as tr:
            ops.reset_launch_counts()
            tr.fit([one], steps=1)
            got = ops.launch_counts()
        want = {"flash_attention": fwd, "flash_attention_bwd_dkv": L,
                "flash_attention_bwd_dq": L}
        print(f"phase7 remat={remat!r} one step: launches "
              f"{ {k: got[k] for k in want} } expected {want}, loss "
              f"{tr.stats.last_loss:.4f}", flush=True)
        require(all(got[k] == w for k, w in want.items()),
                f"remat={remat!r}: launches {got}, expected {want}")
    torch.cuda.empty_cache()
    stats["f32_check"] = _f32_train_check(torch, c)
    return stats


def _f32_train_check(torch, flagship):
    """f32 at full width, b2 s256: loss and grads through the kernels
    against attention="xla" (plain attention), same params and batch."""
    from kubeflow_tpu_torch.models import train as train_lib
    from kubeflow_tpu_torch.models.transformer import init_params
    from kubeflow_tpu_torch.runtime.data import synthetic_lm_batches
    c = flagship.replace(dtype="float32")
    params = init_params(torch.Generator(device="cuda").manual_seed(3), c,
                         device="cuda")
    tokens, targets = (torch.from_numpy(x).cuda() for x in next(iter(
        synthetic_lm_batches(2, 256, c.vocab_size, seed=6))))
    out = {}
    for attn in ("auto", "xla"):
        cfg = c.replace(attention=attn)
        p = train_lib.tree_map(lambda w: w.detach().requires_grad_(), params)
        out[attn] = train_lib.value_and_grad(
            lambda p, t, tg: train_lib.loss_fn(p, t, tg, cfg), p, tokens,
            targets)
    (lk, gk), (lp, gp) = out["auto"], out["xla"]
    loss_err = abs(lk.item() - lp.item())
    grad_err = max(
        ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
        for a, b in zip(train_lib.tree_leaves(gk), train_lib.tree_leaves(gp)))
    print(f"phase7 f32 b2 s256: loss kernels {lk.item():.6f} plain "
          f"{lp.item():.6f} (|diff| {loss_err:.2e}, tol 1e-4); grads max "
          f"|kernel-plain|/max|plain| per leaf {grad_err:.2e} (tol "
          f"{MODEL_GRAD_REL:g})", flush=True)
    require(loss_err <= 1e-4 and grad_err <= MODEL_GRAD_REL,
            "the f32 train path through the kernels disagrees with plain "
            "attention")
    return {"loss_abs_err": loss_err, "grad_rel_err": grad_err}


# --------------------------------------------------------------- phase 7b
def _state_tree(trainer) -> dict:
    """A bf16-params Trainer's whole state as one tree of tensors."""
    opt = trainer.opt_state
    return {"params": trainer.params, "master": opt.master,
            "mu": opt.inner.mu, "nu": opt.inner.nu}


def _tree_diff(torch, got: dict, want: dict) -> tuple[bool, float]:
    """(every leaf bit-equal, the largest max|got - want| / max|want| of
    a leaf)."""
    from kubeflow_tpu_torch.models.train import tree_leaves
    equal, worst = True, 0.0
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        if not torch.equal(a, b):
            equal = False
            worst = max(worst, ((a.float() - b.float()).abs().max() /
                                b.float().abs().max().clamp_min(1e-30))
                        .item())
    return equal, worst


def phase_checkpoint(torch, flagship, draft_config, root):
    """7b: a checkpoint round trip at full flagship width. Trainer A
    (bf16 params, f32 masters, checkpoints every 4 steps, keeping 1)
    trains 4 steps, which saves step 4, and waits for the write; Trainer B
    on the same directory resumes at step 4; both run steps 5 and 6 on the
    same batches and must agree bit for bit (losses, params, masters,
    moments). Prints the bytes of the step on disk and the seconds of the
    save (the blocking host snapshot and the background write apart) and
    of the restore. Also saves the small draft's seed-1 params for phase
    9. Returns A's step-4 params (a copy), stats and the launches."""
    from kubeflow_tpu_torch import ops
    from kubeflow_tpu_torch.models import train as train_lib
    from kubeflow_tpu_torch.models.transformer import init_params
    from kubeflow_tpu_torch.runtime.checkpoint import TrainCheckpointer
    from kubeflow_tpu_torch.runtime.data import synthetic_lm_batches
    from kubeflow_tpu_torch.runtime.trainer import Trainer

    c, L, dev = flagship, flagship.n_layers, "cuda"
    tdir, ddir = os.path.join(root, "flagship"), os.path.join(root, "draft")
    tc = train_lib.TrainConfig(bf16_params=True)
    src = synthetic_lm_batches(8, 1024, c.vocab_size, seed=0)
    batches = [next(src) for _ in range(6)]
    kw = dict(device=dev, checkpoint_dir=tdir, checkpoint_interval=4,
              max_checkpoints=1)
    ops.reset_launch_counts()
    a = Trainer(c, tc, **kw)
    # the save's two halves, timed around the checkpointer's own calls
    times: dict = {}
    save, write = a.checkpointer.save, a.checkpointer._write

    def timed_save(*args, **kwargs):
        t0 = time.monotonic()
        saved = save(*args, **kwargs)
        if saved:
            times["snapshot_s"] = time.monotonic() - t0
        return saved

    def timed_write(*args):
        t0 = time.monotonic()
        write(*args)
        times["write_s"] = time.monotonic() - t0
    a.checkpointer.save, a.checkpointer._write = timed_save, timed_write
    a.fit(batches[:4], steps=4, log_every=1)
    a.checkpointer.wait()
    require(a.checkpointer.all_steps() == [4],
            f"checkpoints {a.checkpointer.all_steps()}, expected [4]")
    step_dir = os.path.join(tdir, "4")
    nbytes = sum(os.path.getsize(os.path.join(step_dir, f))
                 for f in os.listdir(step_dir))
    params4 = train_lib.tree_map(lambda t: t.detach().clone(), a.params)

    t0 = time.monotonic()
    b = Trainer(c, tc, seed=1, **kw)
    build_s = time.monotonic() - t0
    require(b.stats.step == 4, f"Trainer B resumed at step {b.stats.step}")
    t0 = time.monotonic()
    b.checkpointer.restore(b.params, b.opt_state)   # the same step again
    torch.cuda.synchronize()
    restore_s = time.monotonic() - t0
    equal0, _ = _tree_diff(torch, _state_tree(b), _state_tree(a))

    a.fit(batches[4:], steps=2, log_every=1)
    b.fit(batches[4:], steps=2, log_every=1)
    losses_a, losses_b = list(a.stats.losses)[4:], list(b.stats.losses)
    equal, worst = _tree_diff(torch, _state_tree(b), _state_tree(a))
    for t in (a, b):
        require(t.checkpointer.all_steps() == [4], "steps 5 and 6 saved")
        t.close()
    counts = ops.launch_counts()
    stats = {"bytes_per_step": nbytes, **times, "restore_s": restore_s,
             "trainer_b_build_s": build_s, "losses_a": losses_a,
             "losses_b": losses_b, "restored_bit_equal": equal0,
             "continued_bit_equal": equal and losses_a == losses_b,
             "worst_leaf_rel_diff": worst}
    print(f"phase7b checkpoint of step 4: {nbytes / 1e9:.3f} GB on disk, "
          f"save: host snapshot {times.get('snapshot_s', 0):.3f} s, "
          f"background write {times.get('write_s', 0):.3f} s; restore "
          f"{restore_s:.3f} s (Trainer B built and resumed in {build_s:.3f}"
          f" s); restored state bit-equal to A's: {equal0}", flush=True)
    print(f"phase7b steps 5 and 6: A {losses_a}, B {losses_b}; every loss, "
          f"param, master and moment bit-equal: "
          f"{stats['continued_bit_equal']} (largest leaf difference "
          f"{worst:.3e} of the leaf's max)", flush=True)
    require(equal0, "the restored state differs from the saved one")
    require([s for s, _ in losses_b] == [5, 6], f"B's steps {losses_b}")
    require(stats["continued_bit_equal"],
            "the resumed run is not bit-equal to the uninterrupted one")
    want = {"flash_attention": 8 * L, "flash_attention_bwd_dkv": 8 * L,
            "flash_attention_bwd_dq": 8 * L}
    print(f"phase7b launches {counts} expected {want}", flush=True)
    require(all(counts[k] == w for k, w in want.items()),
            f"phase 7b launches {counts}, expected {want}")
    del a, b

    draft = init_params(torch.Generator(device=dev).manual_seed(1),
                        draft_config, device=dev)
    with TrainCheckpointer(ddir) as ckpt:
        require(ckpt.save(0, *train_lib.init_train_state(
            draft, train_lib.TrainConfig())), "the draft was not saved")
    return params4, stats, {k: counts.get(k, 0) for k in want}


# --------------------------------------------------------------- phase 9
def _write_config(root: str, name: str, config) -> str:
    import dataclasses
    path = os.path.join(root, name)
    with open(path, "w") as fh:
        json.dump(dataclasses.asdict(config), fh)
    return path


def _greedy_margins(torch, params, prompts, config, n):
    """generate's greedy loop written out (prefill, then decode steps at
    one pos): the ids and the smallest top-1/top-2 logit margin of its
    steps."""
    from kubeflow_tpu_torch.models.decode import decode_step, prefill
    logits, cache = prefill(params, prompts, config)
    ids, margin = [], math.inf
    for i in range(n):
        top = logits.topk(2, dim=-1).values
        margin = min(margin, (top[:, 0] - top[:, 1]).min().item())
        ids.append(logits.argmax(dim=-1))
        if i < n - 1:
            logits, cache = decode_step(params, cache, ids[-1],
                                        prompts.shape[1] + i, config)
    return torch.stack(ids, dim=1).tolist(), margin


def _first_diff(a: list, b: list):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)


def _identical_draft(torch, params, config, prompts, n):
    """Both engines with the target as its own draft (k=4,
    spec_exact_only=False) on 4 prompts: their ids and acceptance."""
    from kubeflow_tpu_torch.runtime.serving import (
        BatchedGenerator, ContinuousBatchedGenerator)
    kw = dict(draft_params=params, draft_config=config, spec_k=4,
              spec_exact_only=False, device="cuda")
    out = {}
    with ContinuousBatchedGenerator(params, config, n_slots=4,
                                    **kw) as gen:
        futures = [gen.submit(p, n) for p in prompts]
        out["continuous"] = ([f.result(timeout=300).tolist()
                              for f in futures],
                             gen.spec_accepted, gen.spec_drafted)
    with BatchedGenerator(params, config, max_batch=4, max_wait_s=0.5,
                          **kw) as gen:
        futures = [gen.submit(p, n) for p in prompts]
        out["bucketed"] = ([f.result(timeout=300).tolist()
                            for f in futures],
                           gen.spec_accepted, gen.spec_drafted)
        require(gen.spec_batches == 1, "the identical draft did not "
                                       "speculate in one batch")
    return out


def _check_spec_sync_free(torch, gen) -> None:
    """10 speculative ticks (greedy and sampling) on the idle engine
    under torch.cuda.set_sync_debug_mode("error")."""
    import traceback
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for sampling in (False, True):
            for _ in range(5):
                gen._spec_tick(sampling)
    except RuntimeError:
        torch.cuda.set_sync_debug_mode(0)
        fail(f"a speculative tick synchronises with the card:\n"
             f"{traceback.format_exc()[-3000:]}")
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print("phase9 10 speculative ticks (greedy and sampling) ran under "
          "set_sync_debug_mode('error') without a synchronising op",
          flush=True)


def phase_speculative(torch, flagship, draft_config, root, params4,
                      baseline: dict):
    """9: speculative serving of phase 7b's restored flagship, with the
    small draft from its checkpoint, through ``build_server`` (k=4,
    --spec-inexact, both engines). The restored params' ids against the
    in-memory ones; the flagship as its own draft in f32 (every proposal
    accepted, ids = generate's) and bf16 (the exactness gate's
    measurement: how often flash-decode and the einsum window agree);
    the small draft over HTTP (tokens/s, acceptance, time to first
    token); the gate with spec_exact_only=True; exact launch counts; the
    tick under set_sync_debug_mode("error") and torch.profiler."""
    from kubeflow_tpu_torch import ops
    from kubeflow_tpu_torch.models.decode import generate
    from kubeflow_tpu_torch.models.transformer import init_params
    from kubeflow_tpu_torch.runtime.server import build_server
    from kubeflow_tpu_torch.runtime.serving import (
        BatchedGenerator, ContinuousBatchedGenerator)

    c, dc, V, dev = flagship, draft_config, flagship.vocab_size, "cuda"
    L, Ld, k = c.n_layers, dc.n_layers, 4
    prompt_len, n_stagger = 128, 16
    rng = torch.Generator().manual_seed(17)

    def prompt(n):
        return torch.randint(0, V, (n,), generator=rng).tolist()

    target = ["--config", _write_config(root, "flagship.json", c),
              "--checkpoint", os.path.join(root, "flagship"), "--device",
              dev, "--port", "0"]
    spec = ["--draft-config", _write_config(root, "draft.json", dc),
            "--draft-checkpoint", os.path.join(root, "draft"), "--spec-k",
            str(k), "--spec-inexact"]
    stats: dict = {}
    launches = {"flash_attention": 0, "flash_decode": 0}

    # 1. the restore: --checkpoint's ids against the in-memory params'
    probe = [prompt(prompt_len) for _ in range(2)]
    server = build_server(target).start()
    try:
        served = [_post(server.url, {"prompt": p, "max_new_tokens": 32})
                  ["ids"] for p in probe]
    finally:
        server.stop()
    with ContinuousBatchedGenerator(params4, c, device=dev) as gen:
        in_memory = [gen.generate_sync(p, 32, timeout=300).tolist()
                     for p in probe]
    print(f"phase9 --checkpoint serves step 4's params: greedy ids equal "
          f"the in-memory params' engine's: {served == in_memory}",
          flush=True)
    require(served == in_memory, "the restored params serve other ids")

    # 2. and 3. the flagship as its own draft, f32 then bf16
    prompts4 = [prompt(prompt_len) for _ in range(4)]
    batch4 = torch.tensor(prompts4, device=dev)
    c32 = c.replace(dtype="float32")
    want32, margin = _greedy_margins(torch, params4, batch4, c32, 32)
    require(generate(params4, batch4, c32, 32).tolist() == want32,
            "the written-out greedy loop is not generate's")
    for engine, (ids, acc, drafted) in _identical_draft(
            torch, params4, c32, prompts4, 32).items():
        same = [a == b for a, b in zip(ids, want32)]
        print(f"phase9 f32, the flagship as its own draft, {engine}: "
              f"accepted {acc} of {drafted} proposals; ids equal "
              f"generate's for {sum(same)} of 4 requests (smallest "
              f"top-1/top-2 logit margin of generate's steps "
              f"{margin:.3e})", flush=True)
        require(acc == drafted > 0 and all(same),
                f"f32 identical draft ({engine}): accepted {acc} of "
                f"{drafted}, ids equal {same}")
        stats[f"f32_identical_{engine}"] = {"accepted": acc,
                                            "drafted": drafted}
    stats["f32_min_margin"] = margin
    want16 = generate(params4, batch4, c, 32).tolist()
    for engine, (ids, acc, drafted) in _identical_draft(
            torch, params4, c, prompts4, 32).items():
        diffs = [_first_diff(a, b) for a, b in zip(ids, want16)]
        print(f"phase9 bf16, the flagship as its own draft, {engine}: "
              f"acceptance {acc / drafted:.4f} ({acc} of {drafted}); per "
              f"request, the first position where the ids leave "
              f"generate's (None: equal): {diffs}", flush=True)
        stats[f"bf16_identical_{engine}"] = {
            "accepted": acc, "drafted": drafted, "first_diff": diffs}

    # 4. the small draft over HTTP, bucketed then continuous, each with
    # one sampled request added; 6. launches exact
    greedy = [prompt(prompt_len) for _ in range(8)]
    server = build_server(target + spec + ["--engine", "bucketed"]).start()
    gen = server.generator
    try:
        ops.reset_launch_counts()
        _check_ids(_post(server.url, {"prompt": prompt(8),
                                      "max_new_tokens": 2}), 2, V, "warm-up")
        outs, wall = _concurrent(server.url, [
            {"prompt": p, "max_new_tokens": 64} for p in greedy] + [
            {"prompt": prompt(prompt_len), "max_new_tokens": 64,
             "temperature": 0.8}])
        for i, out in enumerate(outs):
            _check_ids(out, 64, V, f"speculative bucketed request {i}")
        counts = ops.launch_counts()
        want = {"flash_attention": gen.spec_batches * (L + Ld),
                "flash_decode": gen.spec_blocks * (k + 1) * Ld,
                "flash_decode_int8": 0}
        bucketed = {"tokens_per_s": 9 * 64 / wall, "wall_s": wall,
                    "spec_batches": gen.spec_batches,
                    "spec_blocks": gen.spec_blocks,
                    "acceptance": gen.spec_accepted / gen.spec_drafted}
        print(f"phase9 bucketed, small draft (6 layers, 8 heads of 64), 8 "
              f"greedy + 1 sampled (prompt {prompt_len}, 64 new): "
              f"{bucketed['tokens_per_s']:.1f} generated tokens/s (phase "
              f"3, no draft: {baseline.get('bucketed_tokens_per_s', 0):.1f})"
              f", {wall:.3f} s, {gen.spec_batches} speculative batches of "
              f"{gen.batches_total} (warm-up included), {gen.spec_blocks} "
              f"blocks, acceptance {bucketed['acceptance']:.4f}; launches "
              f"{counts} expected {want}", flush=True)
        require(gen.spec_batches == gen.batches_total and
                all(n == want.get(name, 0) for name, n in counts.items())
                and want["flash_decode"] > 0,
                f"bucketed speculative launches {counts}, expected {want}")
        for name in launches:
            launches[name] += want[name]
    finally:
        server.stop()
    stats["bucketed_small_draft"] = bucketed

    stagger = [prompt(prompt_len) for _ in range(n_stagger)] + \
        [prompt(prompt_len)]
    server = build_server(target + spec).start()
    gen = server.generator
    try:
        ops.reset_launch_counts()
        run = _staggered(server.url, stagger, 64, V,
                         temperatures=[0.0] * n_stagger + [0.8])
        counts = ops.launch_counts()
        want = {"flash_attention": 0, "flash_decode_int8": 0,
                "flash_decode": gen.spec_ticks * (k + 1) * Ld}
        continuous = {k_: v for k_, v in run.items() if k_ != "ids"}
        continuous.update(spec_ticks=gen.spec_ticks,
                          acceptance=gen.spec_accepted / gen.spec_drafted)
        print(f"phase9 continuous, small draft, {n_stagger} greedy + 1 "
              f"sampled streamed requests 25 ms apart (prompt "
              f"{prompt_len}, 64 new): {run['tokens_per_s']:.1f} generated "
              f"tokens/s (phase 8, no draft: "
              f"{baseline.get('continuous_tokens_per_s', 0):.1f}), wall "
              f"{run['wall_s']:.3f} s, time to first token median "
              f"{1e3 * run['ttft_median_s']:.1f} ms max "
              f"{1e3 * run['ttft_max_s']:.1f} ms, {gen.spec_ticks} ticks, "
              f"acceptance {continuous['acceptance']:.4f}; launches "
              f"{counts} expected {want}", flush=True)
        require(all(n == want.get(name, 0) for name, n in counts.items())
                and want["flash_decode"] > 0,
                f"continuous speculative launches {counts}, expected {want}")
        launches["flash_decode"] += want["flash_decode"]
        stats["continuous_small_draft"] = continuous

        # 7. the tick never synchronises; 10 ticks profiled
        _check_spec_sync_free(torch, gen)
        prof = {"shape": "10 speculative ticks, continuous engine, 8 "
                         "slots, small draft, k=4",
                **_profile(torch, lambda: [gen._spec_tick(False).cpu()
                                           for _ in range(10)])}
        _print_profile("phase9", prof)
        if prof["device_busy_ms"]:
            print(f"phase9 a speculative tick: wall "
                  f"{prof['wall_ms'] / 10:.2f} ms, device busy "
                  f"{prof['device_busy_ms'] / 10:.3f} ms (idle "
                  f"{100 * prof['device_idle_share']:.1f}%), "
                  f"{prof['device_kernels'] / 10:.0f} kernels", flush=True)
        stats["tick_profile"] = prof
    finally:
        server.stop()

    # 5. the gate: spec_exact_only=True on the card's flash-decode path
    draft = init_params(torch.Generator(device=dev).manual_seed(1), dc,
                        device=dev)
    p = prompt(prompt_len)
    with BatchedGenerator(params4, c, draft_params=draft, draft_config=dc,
                          device=dev) as gen:
        ids = gen.generate_sync(p, 16, timeout=300).tolist()
        fell_back = gen.spec_batches == 0
    plain = generate(params4, torch.tensor([p], device=dev), c,
                     16)[0].tolist()
    try:
        ContinuousBatchedGenerator(params4, c, draft_params=draft,
                                   draft_config=dc, device=dev).close()
        refused = None
    except ValueError as e:
        refused = str(e)
    print(f"phase9 spec_exact_only=True: the bucketed engine fell back to "
          f"generate: {fell_back}, ids equal generate's: {ids == plain}; "
          f"the continuous engine refused the draft: {refused!r}",
          flush=True)
    require(fell_back and ids == plain and refused is not None and
            "spec_exact_only=False" in refused,
            "the exactness gate did not hold on the card")
    return stats, launches


# -------------------------------------------------------------- phase 10
def _tree_bytes(tree) -> int:
    from kubeflow_tpu_torch.models.train import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _record_routing():
    """Wrap models/moe.py's ``route_indices`` so each call's (expert,
    slot) is kept; returns (records, restore)."""
    from kubeflow_tpu_torch.models import moe
    records, original = [], moe.route_indices

    def recording(*args, **kwargs):
        out = original(*args, **kwargs)
        records.append((out[0].clone(), out[1].clone()))
        return out

    moe.route_indices = recording

    def restore():
        moe.route_indices = original
    return records, restore


def _same_routing(torch, a: list, b: list) -> bool:
    return len(a) == len(b) and all(
        torch.equal(ea, eb) and torch.equal(sa, sb)
        for (ea, sa), (eb, sb) in zip(a, b))


def _moe_kernel_vs_plain(torch, params, c32) -> dict:
    """f32 at a non-binding capacity: prefill (8 x 128) through the flash
    forward against plain attention, then one decode step from the same
    cache through flash-decode against the einsum path. Each pair routes
    every layer identically (expert and slot of every pick) and its
    logits agree within MOE_LOGITS_TOL. Launches here are not counted."""
    from kubeflow_tpu_torch.models.decode import decode_step, prefill
    plain = c32.replace(attention="xla", decode_attention="xla")
    prompt = torch.randint(0, c32.vocab_size, (8, 128),
                           generator=torch.Generator().manual_seed(21)
                           ).cuda()
    records, restore = _record_routing()
    try:
        with torch.no_grad():
            lk, _ = prefill(params, prompt, c32)
            rk = records[:]
            records.clear()
            lp, cache = prefill(params, prompt, plain)
            rp = records[:]
            records.clear()
            token = lp.argmax(dim=-1).int()
            copy = {k: v.clone() for k, v in cache.items()}
            dk, _ = decode_step(params, copy, token, 128, c32)
            dk_r = records[:]
            records.clear()
            dp, _ = decode_step(params, cache, token, 128, plain)
            dp_r = records[:]
    finally:
        restore()
    out = {"prefill_max_abs_err": (lk - lp).abs().max().item(),
           "prefill_same_routing": _same_routing(torch, rk, rp),
           "decode_max_abs_err": (dk - dp).abs().max().item(),
           "decode_same_routing": _same_routing(torch, dk_r, dp_r),
           "routed_layers": len(rk) + len(dk_r)}
    print(f"phase10 f32, capacity factor {c32.capacity_factor} (no drops): "
          f"prefill 8 x 128 flash vs plain max|diff| "
          f"{out['prefill_max_abs_err']:.3e}, decode step flash-decode vs "
          f"einsum {out['decode_max_abs_err']:.3e} (tol {MOE_LOGITS_TOL:g}); "
          f"every layer's expert and slot of every pick identical: "
          f"prefill {out['prefill_same_routing']}, decode "
          f"{out['decode_same_routing']}", flush=True)
    require(out["prefill_same_routing"] and out["decode_same_routing"] and
            len(rk) == len(dk_r) == c32.n_layers,
            "the kernel path routes otherwise than the plain path")
    require(out["prefill_max_abs_err"] <= MOE_LOGITS_TOL and
            out["decode_max_abs_err"] <= MOE_LOGITS_TOL,
            "the MoE kernel path disagrees with the plain path")
    return out


def _engine_tick(torch, gen, phase="phase10", what="MoE bf16") -> dict:
    """10 ticks of the idle continuous engine (8 rows; an MoE's dead rows
    still route their pad tokens), each read back as the engine's loop
    does: unprofiled wall, then under torch.profiler."""
    def ticks():
        for _ in range(10):
            gen._tick(1, False).cpu()
    ticks()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    ticks()
    tick_ms = (time.monotonic() - t0) / 10 * 1e3
    prof = {"shape": f"10 ticks, continuous engine, 8 slots, {what}",
            **_profile(torch, ticks)}
    _print_profile(phase, prof)
    busy = prof["device_busy_ms"]
    out = {"tick_ms_unprofiled": tick_ms, "profile": prof,
           "kernels_a_tick": prof["device_kernels"] / 10,
           "launches_a_tick": prof["host_launches"] / 10,
           "enqueues_a_tick": prof["host_enqueues"] / 10}
    if busy:
        out["device_busy_ms_a_tick"] = busy / 10
        out["device_idle_share_unprofiled"] = 1 - busy / 10 / tick_ms
        print(f"{phase} a tick ({what}): {tick_ms:.2f} ms unprofiled, "
              f"device busy {busy / 10:.3f} ms (idle "
              f"{100 * out['device_idle_share_unprofiled']:.1f}% of the "
              f"unprofiled tick), {out['kernels_a_tick']:.1f} kernels on "
              f"the device, {out['launches_a_tick']:.1f} launched by the "
              f"host", flush=True)
    return out


def _moe_serving(torch, params, moe, draft) -> tuple[dict, dict]:
    """The MoE served at the default capacity factor in bf16: the bucketed
    engine over HTTP (8 concurrent 128 → 64), the continuous engine over
    HTTP (16 streams 25 ms apart; an identical request twice; its tick),
    an int8-weight engine and a speculative engine with phase 9's small
    draft; launch counts exact per engine."""
    from kubeflow_tpu_torch import ops
    from kubeflow_tpu_torch.runtime.server import ServingServer
    from kubeflow_tpu_torch.runtime.serving import (
        BatchedGenerator, ContinuousBatchedGenerator)

    L, V = moe.n_layers, moe.vocab_size
    rng = torch.Generator().manual_seed(23)

    def prompt(n):
        return torch.randint(0, V, (n,), generator=rng).tolist()

    stats: dict = {}
    launches = {"flash_attention": 0, "flash_decode": 0}

    gen = BatchedGenerator(params, moe, max_batch=8, max_wait_s=0.5,
                           device="cuda")
    server = ServingServer(gen, moe, port=0).start()
    try:
        ops.reset_launch_counts()
        _check_ids(_post(server.url, {"prompt": prompt(8),
                                      "max_new_tokens": 2}), 2, V, "warm-up")
        warm = gen.batches_total
        outs, wall = _concurrent(server.url, [
            {"prompt": prompt(128), "max_new_tokens": 64}
            for _ in range(8)])
        for i, out in enumerate(outs):
            _check_ids(out, 64, V, f"MoE bucketed request {i}")
        batches = gen.batches_total - warm
        counts = ops.launch_counts()
        want = {**{k: 0 for k in counts},
                "flash_attention": (warm + batches) * L,
                "flash_decode": (warm * 1 + batches * 63) * L}
        stats["bucketed"] = {"tokens_per_s": 8 * 64 / wall, "wall_s": wall,
                             "batches": batches}
        print(f"phase10 bucketed, 8 concurrent greedy (prompt 128, 64 new): "
              f"{batches} batch(es), {wall:.3f} s, {8 * 64 / wall:.1f} "
              f"generated tokens/s; launches {counts} expected {want}",
              flush=True)
        require(counts == want, f"MoE bucketed launches {counts}, expected "
                                f"{want}")
        for name in launches:
            launches[name] += want[name]
    finally:
        server.stop()
    del gen, server

    served = _ServedEngine(torch, params, moe, phase="phase10")
    gen = served.gen
    try:
        _check_ids(_post(served.url, {"prompt": prompt(128),
                                      "max_new_tokens": 8}), 8, V, "warm-up")
        run = _staggered(served.url, [prompt(128) for _ in range(16)], 64,
                         V)
        stats["continuous"] = {k: v for k, v in run.items() if k != "ids"}
        print(f"phase10 continuous, 16 x (prompt 128, 64 new) streamed "
              f"25 ms apart: {run['tokens_per_s']:.1f} generated tokens/s, "
              f"wall {run['wall_s']:.3f} s, time to first token median "
              f"{1e3 * run['ttft_median_s']:.1f} ms max "
              f"{1e3 * run['ttft_max_s']:.1f} ms, {gen.steps_total} ticks",
              flush=True)
        # the same request twice on the idle engine: same slot, the other
        # rows dead and unchanged, so the same routing and ids
        p = prompt(128)
        twice = [_post(served.url, {"prompt": p, "max_new_tokens": 32})
                 ["ids"] for _ in range(2)]
        print(f"phase10 an identical request twice: bit-identical ids "
              f"{twice[0] == twice[1]}", flush=True)
        require(twice[0] == twice[1], "an identical request gave other ids")
        launches["flash_decode"] += served.launches("flash_decode",
                                                    "MoE continuous engine")
        _check_sync_free(torch, gen, "MoE engine", phase="phase10")
        stats["tick"] = _engine_tick(torch, gen)
    finally:
        served.close()
    del served, gen

    # int8 weights (per-expert scales, the router in f32)
    with ContinuousBatchedGenerator(params, moe, quantize=True,
                                    device="cuda") as gen:
        ops.reset_launch_counts()
        futures = [gen.submit(prompt(128), 32) for _ in range(4)]
        for f in futures:
            require(len(f.result(timeout=300)) == 32, "int8 MoE request")
        counts = ops.launch_counts()
        router = gen.params["blocks"]["router"]
        require(router.dtype == torch.float32 and
                gen.params["blocks"]["w_gate"]["q"].dtype == torch.int8,
                "the int8 engine quantised the router or not the experts")
        want = gen.steps_total * L
    print(f"phase10 quantize=True, 4 requests (prompt 128, 32 new): "
          f"{gen.steps_total} ticks, launches {counts}, expected "
          f"flash_decode = {want}", flush=True)
    require(counts["flash_decode"] == want and
            sum(counts.values()) == want, f"int8 MoE launches {counts}")
    launches["flash_decode"] += want

    # an MoE target verified through decode_window, the small dense draft
    dparams, dconfig = draft
    k = 4
    with ContinuousBatchedGenerator(
            params, moe, draft_params=dparams, draft_config=dconfig,
            spec_k=k, spec_exact_only=False, device="cuda") as gen:
        ops.reset_launch_counts()
        futures = [gen.submit(prompt(128), 32) for _ in range(4)]
        for f in futures:
            require(len(f.result(timeout=300)) == 32, "speculative request")
        counts = ops.launch_counts()
        want = gen.spec_ticks * (k + 1) * dconfig.n_layers
        stats["speculative"] = {"spec_ticks": gen.spec_ticks,
                                "acceptance": gen.spec_accepted /
                                max(gen.spec_drafted, 1)}
    print(f"phase10 MoE target + small draft, 4 requests (prompt 128, 32 "
          f"new): {gen.spec_ticks} speculative ticks, acceptance "
          f"{stats['speculative']['acceptance']:.4f}; launches {counts}, "
          f"expected flash_decode = spec ticks x {k + 1} x "
          f"{dconfig.n_layers} = {want}", flush=True)
    require(counts["flash_decode"] == want > 0 and
            sum(counts.values()) == want, f"MoE speculative launches "
                                          f"{counts}")
    launches["flash_decode"] += want
    return stats, launches


def _moe_train(torch, moe, root) -> tuple[dict, dict]:
    """The MoE train path at full width (f32 params, bf16 compute):
    Trainer at b8 x s1024, 2 warm-up steps and 3 timed runs of 3; a
    falling loss on a repeated batch under remat="mlp"; launches 12 of
    each attention kernel a step in both; a checkpoint of step 3 resumed
    bit-equal over steps 4 and 5."""
    from kubeflow_tpu_torch import ops
    from kubeflow_tpu_torch.models import train as train_lib
    from kubeflow_tpu_torch.models.moe import count_active_params
    from kubeflow_tpu_torch.models.transformer import count_params
    from kubeflow_tpu_torch.runtime.data import synthetic_lm_batches
    from kubeflow_tpu_torch.runtime.trainer import Trainer
    from kubeflow_tpu_torch.tools.train_step_time import timed_fit

    L, V, B, S = moe.n_layers, moe.vocab_size, 8, 1024
    names = ("flash_attention", "flash_attention_bwd_dkv",
             "flash_attention_bwd_dq")
    warm, timed, runs = 2, 3, 3
    stats: dict = {}
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(moe, train_lib.TrainConfig(), device="cuda", seed=0)
    stats["params"] = count_params(trainer.params)
    src = synthetic_lm_batches(B, S, V, seed=0)
    ops.reset_launch_counts()
    trainer.fit(src, steps=warm, log_every=warm)
    host = [timed_fit(trainer, src, timed) for _ in range(runs)]
    counts = ops.launch_counts()
    steps = warm + runs * timed
    launches = {n: L * steps for n in names}
    print(f"phase10 train launches {counts} expected {launches}",
          flush=True)
    require(all(counts[n] == w for n, w in launches.items()),
            f"MoE train launches {counts}, expected {launches}")
    mid = sorted(host, key=lambda r: r["ms_per_step"])[runs // 2]
    ms = mid["ms_per_step"]
    tok_s = B * S / ms * 1e3
    active = count_active_params(moe)
    stats.update({
        "ms_per_step": ms, "cpu_ms_per_step": mid["cpu_ms_per_step"],
        "runs_ms_per_step": [r["ms_per_step"] for r in host],
        "tokens_per_s": tok_s, "active_params": active,
        "active_tflops_per_s": 6 * active * tok_s / 1e12,
        "trainer_dense_formula_tflops_per_s":
            trainer.stats.model_tflops_per_sec,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "losses": [x for _, x in trainer.stats.losses]})
    stats["active_bf16_peak_share"] = \
        stats["active_tflops_per_s"] * 1e12 / PEAK_FLOPS["bfloat16"]
    print(f"phase10 train b{B} s{S}, {stats['params']} params "
          f"({active:.0f} active a token), f32 params + bf16 compute: "
          f"{ms:.2f} ms/step (median of {runs} runs of {timed}: "
          f"{[round(x, 2) for x in stats['runs_ms_per_step']]}; CPU "
          f"{mid['cpu_ms_per_step']:.2f} ms/step), {tok_s:.1f} tokens/s, "
          f"{stats['active_tflops_per_s']:.2f} TFLOP/s on active params "
          f"(6 x active x tokens/s; "
          f"{100 * stats['active_bf16_peak_share']:.2f}% of the bf16 peak; "
          f"the Trainer's dense formula: "
          f"{stats['trainer_dense_formula_tflops_per_s']:.2f}), peak "
          f"memory {stats['peak_mem_gb']:.2f} GB, losses {stats['losses']}",
          flush=True)
    require(all(math.isfinite(x) for x in stats["losses"]),
            f"MoE losses {stats['losses']}")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()

    # a repeated batch, remat="mlp": the loss falls; the attention is not
    # recomputed, so the launches stay 12 of each a step
    one = next(iter(synthetic_lm_batches(B, S, V, seed=5)))
    with Trainer(moe.replace(remat="mlp"),
                 train_lib.TrainConfig(warmup_steps=1), device="cuda",
                 seed=1) as tr:
        ops.reset_launch_counts()
        tr.fit([one] * 8, steps=8, log_every=1)
        counts = ops.launch_counts()
        curve = [x for _, x in tr.stats.losses]
    want = {n: 8 * L for n in names}
    print(f"phase10 remat='mlp', a repeated batch, 8 steps: losses {curve}; "
          f"launches {counts} expected {want}", flush=True)
    require(all(math.isfinite(x) for x in curve) and curve[-1] < curve[0],
            f"the MoE loss on a repeated batch did not fall: {curve}")
    require(all(counts[n] == w for n, w in want.items()),
            f"remat='mlp' launches {counts}, expected {want}")
    for n in names:
        launches[n] += want[n]
    stats["remat_mlp_losses"] = curve
    del tr
    gc.collect()
    torch.cuda.empty_cache()

    # checkpoint and resume: A saves step 3 and runs on; B resumes at 3;
    # steps 4 and 5 bit-equal (no step of theirs is saved again)
    tdir = os.path.join(root, "moe")
    batches = [next(src) for _ in range(5)]
    kw = dict(device="cuda", checkpoint_dir=tdir, checkpoint_interval=3,
              max_checkpoints=1)
    ops.reset_launch_counts()
    a = Trainer(moe, train_lib.TrainConfig(), **kw)
    a.fit(batches[:3], steps=3, log_every=1)
    a.checkpointer.wait()
    step_dir = os.path.join(tdir, "3")
    nbytes = sum(os.path.getsize(os.path.join(step_dir, f))
                 for f in os.listdir(step_dir))
    t0 = time.monotonic()
    b = Trainer(moe, train_lib.TrainConfig(), seed=1, **kw)
    resume_s = time.monotonic() - t0
    require(b.stats.step == 3, f"MoE Trainer B resumed at {b.stats.step}")
    a.fit(batches[3:], steps=2, log_every=1)
    b.fit(batches[3:], steps=2, log_every=1)
    losses_a, losses_b = list(a.stats.losses)[3:], list(b.stats.losses)
    state = [(t.params, t.opt_state.mu, t.opt_state.nu) for t in (a, b)]
    equal, worst = _tree_diff(torch, dict(zip("pmn", state[1])),
                              dict(zip("pmn", state[0])))
    for t in (a, b):
        t.close()
    counts = ops.launch_counts()
    want = {n: 7 * L for n in names}
    stats["checkpoint"] = {"bytes_per_step": nbytes, "resume_s": resume_s,
                           "losses_a": losses_a, "losses_b": losses_b,
                           "bit_equal": equal and losses_a == losses_b,
                           "worst_leaf_rel_diff": worst}
    print(f"phase10 MoE checkpoint of step 3: {nbytes / 1e9:.3f} GB on "
          f"disk; Trainer B built and resumed in {resume_s:.3f} s; steps 4 "
          f"and 5: A {losses_a}, B {losses_b}; every loss, param and moment "
          f"bit-equal: {stats['checkpoint']['bit_equal']} (largest leaf "
          f"difference {worst:.3e}); launches {counts} expected {want}",
          flush=True)
    require(stats["checkpoint"]["bit_equal"],
            "the resumed MoE run is not bit-equal to the uninterrupted one")
    require(all(counts[n] == w for n, w in want.items()),
            f"MoE resume launches {counts}, expected {want}")
    for n in names:
        launches[n] += want[n]
    del a, b, state
    shutil.rmtree(tdir, ignore_errors=True)
    return stats, launches


def phase_moe(torch, moe, draft_config, root) -> tuple[dict, dict]:
    """10: the MoE family at the flagship's width (``FLAGSHIP_MOE``: 8
    experts, top-2, capacity factor 1.25, route groups of 2048): f32
    params from a seed and their bf16 serving copy; the kernel path
    against the plain path in f32 at a non-binding capacity (same
    routing, logits within MOE_LOGITS_TOL); the continuous engine over
    HTTP in f32 at that capacity, its ids teacher-forced through the
    plain forward; both engines over HTTP in bf16 at the default
    capacity, an int8 engine and a speculative one; the train path and a
    resume. Returns stats and the launches of the served and trained
    paths."""
    from kubeflow_tpu_torch.models.moe import (expert_capacity,
                                               init_moe_params, moe_forward,
                                               num_route_groups)
    from kubeflow_tpu_torch.models.transformer import init_params
    from kubeflow_tpu_torch.runtime.serving import cast_matmul_weights

    V = moe.vocab_size
    params = init_moe_params(torch.Generator(device="cuda").manual_seed(20),
                             moe, device="cuda")
    serving = cast_matmul_weights(params, moe.compute_dtype)
    groups = num_route_groups(8 * 1024, moe.route_group_size)
    stats: dict = {"f32_param_bytes": _tree_bytes(params),
                   "bf16_serving_bytes": _tree_bytes(serving),
                   "route_groups_b8_s1024": groups,
                   "capacity_b8_s1024": expert_capacity(8192 // groups, moe),
                   "capacity_decode_8_rows": expert_capacity(8, moe)}
    del serving
    print(f"phase10 MoE {moe.n_experts} experts, top-{moe.experts_per_token}"
          f", capacity factor {moe.capacity_factor}, route groups of "
          f"{moe.route_group_size} (b8 s1024: {groups} groups, capacity "
          f"{stats['capacity_b8_s1024']}; a decode step of 8 rows: "
          f"capacity {stats['capacity_decode_8_rows']}), aux coef "
          f"{moe.router_aux_coef}: f32 params "
          f"{stats['f32_param_bytes'] / 1e9:.3f} GB, bf16 serving copy "
          f"{stats['bf16_serving_bytes'] / 1e9:.3f} GB", flush=True)

    # f32 at capacity factor E/k = 4: every group's capacity covers it
    free = moe.replace(dtype="float32", capacity_factor=moe.n_experts /
                       moe.experts_per_token)
    stats["kernel_vs_plain"] = _moe_kernel_vs_plain(torch, params, free)
    launches = {"flash_attention": 0, "flash_decode": 0}
    f32 = _ServedEngine(torch, params, free, phase="phase10")
    try:
        rng = torch.Generator().manual_seed(22)
        prompts = [torch.randint(0, V, (128,), generator=rng).tolist()
                   for _ in range(4)]
        run = _staggered(f32.url, prompts, 16, V)
        plain = free.replace(attention="xla")
        gap = _teacher_forced_gap(
            torch, lambda t: moe_forward(params, t, plain)[0], prompts,
            run["ids"])
        launches["flash_decode"] += f32.launches("flash_decode",
                                                 "f32 MoE engine")
    finally:
        f32.close()
    stats["f32_teacher_forced_gap"] = gap
    print(f"phase10 f32 continuous engine over HTTP, 4 streams of 16, no "
          f"drops: the largest gap between a streamed token's "
          f"teacher-forced logit (plain forward) and its position's "
          f"maximum is {gap:.3e} (tol 1e-3)", flush=True)
    require(gap <= 1e-3, "the f32 MoE engine chose a token the plain "
                         "forward does not rank first")
    gc.collect()
    torch.cuda.empty_cache()

    draft = init_params(torch.Generator(device="cuda").manual_seed(1),
                        draft_config, device="cuda")
    stats["serving"], served = _moe_serving(torch, params, moe,
                                            (draft, draft_config))
    for name, n in served.items():
        launches[name] += n
    del params, draft
    gc.collect()
    torch.cuda.empty_cache()
    stats["train"], trained = _moe_train(torch, moe, root)
    for name, n in trained.items():
        launches[name] = launches.get(name, 0) + n
    return stats, launches


# -------------------------------------------------------------- phase 11
def phase_lora(torch, flagship, root, params4) -> tuple[dict, dict]:
    """11: LoRA on the flagship. A lora-mode Trainer (LoRAConfig():
    rank 8, alpha 16, wq/wk/wv/wo) finetunes phase 7b's restored params
    for 6 steps on a repeated batch, checkpointing the adapters: ms/step,
    adapter bytes on disk, launches 12 of each attention kernel a step,
    the base bit-identical after, a falling loss, ``merged_params()`` =
    ``merge_lora``. Then ``build_server`` with --checkpoint (7b),
    --lora-config and --lora-checkpoint serves 4 greedy requests whose
    ids equal an engine's on the merge made in memory."""
    from kubeflow_tpu_torch import ops
    from kubeflow_tpu_torch.models import train as train_lib
    from kubeflow_tpu_torch.models.lora import (LoRAConfig, lora_num_params,
                                                merge_lora)
    from kubeflow_tpu_torch.runtime.data import synthetic_lm_batches
    from kubeflow_tpu_torch.runtime.server import build_server
    from kubeflow_tpu_torch.runtime.serving import ContinuousBatchedGenerator
    from kubeflow_tpu_torch.runtime.trainer import Trainer
    from kubeflow_tpu_torch.tools.train_step_time import timed_fit

    c, L, V = flagship, flagship.n_layers, flagship.vocab_size
    lora = LoRAConfig()
    ldir = os.path.join(root, "lora")
    names = ("flash_attention", "flash_attention_bwd_dkv",
             "flash_attention_bwd_dq")
    before = train_lib.tree_map(lambda t: t.detach().clone(), params4)
    one = next(iter(synthetic_lm_batches(8, 1024, V, seed=7)))
    # lr 1e-3 from the second step: the bf16 base rounds smaller deltas
    # away (a weight of ~0.03 has a bf16 ulp of ~2.4e-4)
    tc = train_lib.TrainConfig(warmup_steps=1, learning_rate=1e-3)
    ops.reset_launch_counts()
    with Trainer(c, tc, device="cuda", lora=lora, base_params=params4,
                 checkpoint_dir=ldir, checkpoint_interval=6) as tr:
        tr.fit([one] * 2, steps=2, log_every=1)
        run = timed_fit(tr, [one] * 4, 4)
        curve = [x for _, x in tr.stats.losses]
        tr.checkpointer.wait()
        counts = ops.launch_counts()
        merged = tr.merged_params()
        same_merge = all(torch.equal(a, b) for a, b in zip(
            train_lib.tree_leaves(merged), train_lib.tree_leaves(
                merge_lora(params4, tr.params, lora))))
        adapters = train_lib.tree_map(lambda t: t.detach().clone(),
                                      tr.params)
        base_kept = all(torch.equal(a, b) for a, b in zip(
            train_lib.tree_leaves(params4), train_lib.tree_leaves(before)))
    del merged, before
    step_dir = os.path.join(ldir, "6")
    nbytes = sum(os.path.getsize(os.path.join(step_dir, f))
                 for f in os.listdir(step_dir))
    want = {n: 6 * L for n in names}
    stats = {"adapter_params": lora_num_params(c, lora),
             "ms_per_step": run["ms_per_step"],
             "cpu_ms_per_step": run["cpu_ms_per_step"],
             "checkpoint_bytes": nbytes, "losses": curve,
             "base_bit_identical": base_kept,
             "merged_params_equal_merge_lora": same_merge}
    print(f"phase11 LoRA rank {lora.rank} on {','.join(lora.targets)} "
          f"({stats['adapter_params']} adapter params) over 7b's bf16 "
          f"flagship, b8 s1024: {run['ms_per_step']:.2f} ms/step (4 timed "
          f"steps after 2; CPU {run['cpu_ms_per_step']:.2f} ms/step), "
          f"adapter checkpoint {nbytes / 1e6:.3f} MB on disk, losses "
          f"{curve}; base bit-identical after: {base_kept}; "
          f"merged_params() = merge_lora: {same_merge}; launches {counts} "
          f"expected {want}", flush=True)
    require(all(counts[n] == w for n, w in want.items()),
            f"LoRA train launches {counts}, expected {want}")
    require(base_kept and same_merge, "LoRA changed the base or merged "
                                      "otherwise")
    require(all(math.isfinite(x) for x in curve) and curve[-1] < curve[0],
            f"the LoRA loss on a repeated batch did not fall: {curve}")
    launches = dict(want)
    gc.collect()
    torch.cuda.empty_cache()

    # serve the finetune: the server restores 7b and the adapters and
    # merges once; the in-memory engine serves the same merge
    lora_json = os.path.join(root, "lora.json")
    with open(lora_json, "w") as fh:
        json.dump({"rank": lora.rank, "alpha": lora.alpha,
                   "targets": list(lora.targets)}, fh)
    rng = torch.Generator().manual_seed(29)
    prompts = [torch.randint(0, V, (128,), generator=rng).tolist()
               for _ in range(4)]
    server = build_server([
        "--config", _write_config(root, "flagship.json", c),
        "--checkpoint", os.path.join(root, "flagship"), "--lora-config",
        lora_json, "--lora-checkpoint", ldir, "--device", "cuda",
        "--port", "0"])
    server.start()
    try:
        ops.reset_launch_counts()
        served = [_check_ids(_post(server.url, {"prompt": p,
                                                "max_new_tokens": 32}),
                             32, V, f"LoRA request {i}")
                  for i, p in enumerate(prompts)]
        ticks = server.generator.steps_total
        counts = ops.launch_counts()
    finally:
        server.stop()
    require(counts["flash_decode"] == ticks * L and
            sum(counts.values()) == ticks * L,
            f"LoRA server launches {counts}, expected flash_decode = "
            f"{ticks} ticks x {L}")
    launches["flash_decode"] = ticks * L
    base32 = train_lib.tree_map(lambda t: t.float(), params4)
    with ContinuousBatchedGenerator(merge_lora(base32, adapters, lora), c,
                                    device="cuda") as gen:
        in_memory = [gen.generate_sync(p, 32, timeout=300).tolist()
                     for p in prompts]
    stats["served_equal_in_memory"] = served == in_memory
    print(f"phase11 build_server --checkpoint --lora-config "
          f"--lora-checkpoint, 4 greedy requests (prompt 128, 32 new): ids "
          f"equal the in-memory merge's engine: {served == in_memory}; "
          f"{ticks} ticks, launches {counts}", flush=True)
    require(served == in_memory, "the LoRA server serves other ids than "
                                 "the in-memory merge")
    return stats, launches


# --------------------------------------------------------------- phase 12
def _timed_steps(torch, step_fn, state, batches) -> dict:
    """Run ``batches`` through ``step_fn``: every step's loss, ms/step over
    the steps after the first two (a synchronised host clock), and the
    peak device memory of the run (GB)."""
    params, opt = state
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, t0 = [], None
    for i, (tokens, targets) in enumerate(batches):
        if i == 2:
            torch.cuda.synchronize()
            t0 = time.monotonic()
        params, opt, loss = step_fn(params, opt, tokens, targets)
        losses.append(loss)
    torch.cuda.synchronize()
    ms = (time.monotonic() - t0) / (len(batches) - 2) * 1e3
    return {"losses": [x.item() for x in losses], "ms_per_step": ms,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "state": (params, opt)}


def _nccl_collectives(torch, dev) -> None:
    """The differentiated collectives of parallel/comm.py on the NCCL
    world of one rank: each is the identity there, forward and backward
    (the sharded paths skip size-1 axes, so this is what shows NCCL)."""
    import torch.distributed as dist

    from kubeflow_tpu_torch.parallel import comm
    g = dist.group.WORLD
    x = torch.randn(4, 6, device=dev, requires_grad=True)
    checks = {}
    for name, fn in (("all_gather/reduce_scatter",
                      lambda t: comm.AllGather.apply(t, g, 1)),
                     ("all_reduce", lambda t: comm.ReduceFrom.apply(t, g)),
                     ("grad all_reduce", lambda t: comm.CopyTo.apply(t, g)),
                     ("all_to_all", lambda t: comm.AllToAll.apply(t, g, 0,
                                                                  1))):
        x.grad = None
        y = fn(x)
        y.backward(torch.full_like(y, 2.0))
        torch.cuda.synchronize()
        checks[name] = bool(torch.equal(y, x)) and bool(
            torch.equal(x.grad, torch.full_like(x, 2.0)))
    m = x.detach().clone()
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=g)
    checks["all_reduce max"] = bool(torch.equal(m, x))
    print(f"phase12 NCCL world of 1 on {dev}: collectives forward and "
          f"backward are the identity: {checks}", flush=True)
    require(all(checks.values()), f"NCCL collectives at world 1: {checks}")


def phase_multidevice(torch, flagship, root, phase7: dict, moe, lora_base,
                      phase10: dict):
    """12: the multi-device entry points on a NCCL world of one rank at the
    flagship's width: NCCL collectives, make_sharded_train_step (auto and
    ulysses attention) beside make_train_step on phase 7's seed and
    batches, a Trainer(mesh=...) resume, tp-sharded generate and
    speculative decode, and dryrun_multidevice(1, "cuda"). In the same
    world, phase 13 (``phase_multidevice_training``) with ``moe``,
    ``lora_base`` and phase 10's train stats."""
    import tempfile

    from kubeflow_tpu_torch import ops
    from kubeflow_tpu_torch.models import train as train_lib
    from kubeflow_tpu_torch.models.decode import generate
    from kubeflow_tpu_torch.models.speculative import speculative_generate
    from kubeflow_tpu_torch.models.transformer import init_params
    from kubeflow_tpu_torch.parallel.mesh import MeshConfig, build_mesh, world
    from kubeflow_tpu_torch.runtime.data import (shard_batch,
                                                 synthetic_lm_batches)
    from kubeflow_tpu_torch.runtime.sharded_decode import shard_decode_params
    from kubeflow_tpu_torch.runtime.trainer import Trainer
    from kubeflow_tpu_torch.tools.dryrun_multidevice import (
        dryrun_multidevice)

    c, L, V, B, S = flagship, flagship.n_layers, flagship.vocab_size, 8, 1024
    n_steps = 10
    tc = train_lib.TrainConfig(bf16_params=True)
    stats: dict = {}
    attn = ("flash_attention", "flash_attention_bwd_dkv",
            "flash_attention_bwd_dq")
    launched: dict = {}
    t_phase = time.monotonic()

    def take() -> dict:
        """The launches since the last call, added to the phase's."""
        counts = ops.launch_counts()
        ops.reset_launch_counts()
        for k, n in counts.items():
            launched[k] = launched.get(k, 0) + n
        return counts
    store = tempfile.mkdtemp(prefix="phase12-")
    with world("cuda", rank=0, world_size=1,
               store_path=os.path.join(store, "store"), timeout=300) as dev:
        _nccl_collectives(torch, dev)
        mesh = build_mesh(MeshConfig(), "cuda")
        src = synthetic_lm_batches(B, S, V, seed=0)
        batches = [tuple(torch.from_numpy(shard_batch(x, mesh)).to(dev)
                         for x in next(src)) for _ in range(n_steps)]

        # phase 7's one-device step and the sharded one (auto and ulysses
        # attention) on the same seed-0 init and batches, in turns, so
        # the host's drift between runs falls on both sides
        turns = ("one_device", "auto", "ulysses", "auto", "one_device")
        runs: dict = {kind: [] for kind in turns}
        for kind in turns:
            if kind == "one_device":
                init_fn, step_fn = train_lib.make_train_step(c, tc, dev)
            else:
                init_fn, step_fn = train_lib.make_sharded_train_step(
                    mesh, c.replace(attention=kind), tc)
            state = init_fn(torch.Generator(device=dev).manual_seed(0))
            ops.reset_launch_counts()
            run = _timed_steps(torch, step_fn, state, batches)
            del run["state"], state, init_fn, step_fn
            runs[kind].append(run)
            torch.cuda.empty_cache()
            if kind == "one_device":
                ops.reset_launch_counts()   # phase 7's path, counted there
                continue
            counts = take()
            got = {k: counts[k] for k in attn}
            require(got == {k: L * n_steps for k in attn},
                    f"sharded step launches {got}, expected {L * n_steps} "
                    f"of each")
        one = runs["one_device"][0]["losses"]
        summary = {}
        for kind in ("one_device", "auto", "ulysses"):
            losses = [r["losses"] for r in runs[kind]]
            diff = max(abs(a - b) / abs(b) for r in losses
                       for a, b in zip(r, one))
            ms = [r["ms_per_step"] for r in runs[kind]]
            summary[kind] = {
                "bit_equal": all(r == one for r in losses),
                "max_rel_loss_diff": diff, "ms_per_step": ms,
                "tokens_per_s": [B * S / m * 1e3 for m in ms],
                "peak_mem_gb": max(r["peak_mem_gb"] for r in runs[kind])}
            print(f"phase12 {kind} step at world 1, b{B} s{S} bf16 params, "
                  f"{len(ms)} turn(s) of {n_steps} steps: losses bit-equal "
                  f"to make_train_step's {summary[kind]['bit_equal']} "
                  f"(largest relative difference {diff:.3e}); ms/step "
                  f"{[round(m, 2) for m in ms]}, tokens/s "
                  f"{[round(t, 1) for t in summary[kind]['tokens_per_s']]}, "
                  f"peak {summary[kind]['peak_mem_gb']:.3f} GB", flush=True)
            require(diff <= 1e-6, f"{kind}: the step's losses differ from "
                                  f"make_train_step's by {diff:.3e}")
        stats["losses"] = one
        print(f"phase12 losses of the 10 steps: {one}; launches 12 of each "
              f"attention kernel a sharded step; phase 7's Trainer in this "
              f"call: {phase7['ms_per_step']:.2f} ms/step, "
              f"{phase7['tokens_per_s']:.1f} tokens/s, peak "
              f"{phase7['peak_mem_gb']:.2f} GB", flush=True)
        stats["train"] = summary

        # Trainer(mesh=...): A saves step 4, B resumes it, both run 5-6
        tdir = os.path.join(root, "multidevice")
        kw = dict(mesh=mesh, checkpoint_dir=tdir, checkpoint_interval=4,
                  max_checkpoints=1)
        host = [tuple(x.cpu().numpy() for x in b) for b in batches[:6]]
        a = Trainer(c, tc, **kw)
        a.fit(host[:4], steps=4, log_every=1)
        a.checkpointer.wait()
        b = Trainer(c, tc, seed=1, **kw)
        require(b.stats.step == 4, f"Trainer B resumed at {b.stats.step}")
        a.fit(host[4:], steps=2, log_every=1)
        b.fit(host[4:], steps=2, log_every=1)
        losses_a, losses_b = list(a.stats.losses)[4:], list(b.stats.losses)
        equal, worst = _tree_diff(torch, _state_tree(b), _state_tree(a))
        for t in (a, b):
            t.close()
        counts = take()
        counts = {k: counts[k] for k in attn}
        print(f"phase12 Trainer(mesh=...) resumed at step 4: steps 5 and 6 "
              f"A {losses_a}, B {losses_b}; state bit-equal {equal} "
              f"(largest leaf difference {worst:.3e}); launches {counts} "
              f"(8 steps)", flush=True)
        require(equal and losses_a == losses_b,
                "the sharded resume is not bit-equal")
        require(counts == {k: 8 * L for k in attn},
                f"the sharded Trainer's launches {counts}")
        stats["resume_bit_equal"] = equal
        del a, b, batches, host
        gc.collect()
        torch.cuda.empty_cache()

        # tp-sharded decode: greedy 8 x 128 -> 64 as phase 3, then the
        # flagship as its own draft (f32: the verify window and
        # flash-decode then agree on every greedy pick)
        params = init_params(torch.Generator(device=dev).manual_seed(0), c,
                             device=dev)
        rng = torch.Generator().manual_seed(7)
        prompt = torch.randint(0, V, (8, 128), generator=rng).to(dev)
        want = generate(params, prompt, c, 64)
        sharded = shard_decode_params(params, mesh, c)
        ops.reset_launch_counts()   # the unsharded comparison's
        got = generate(sharded, prompt, c, 64)
        torch.cuda.synchronize()
        n_decode = take()["flash_decode"]
        print(f"phase12 tp-sharded generate 8 x 128 -> 64: ids equal to "
              f"unsharded {bool(torch.equal(got, want))}, flash_decode "
              f"launches {n_decode} (expected {63 * L})", flush=True)
        require(torch.equal(got, want), "sharded generate diverged")
        require(n_decode == 63 * L, f"flash_decode launches {n_decode}")
        c32 = c.replace(dtype="float32")
        sharded = shard_decode_params(params, mesh, c32)
        ids, spec = speculative_generate(sharded, sharded, prompt, c32, c32,
                                         max_new_tokens=64, k=4)
        greedy = generate(sharded, prompt, c32, 64)
        accepted, drafted = int(spec.accepted.sum()), int(spec.drafted.sum())
        print(f"phase12 speculative_generate, the f32 flagship as its own "
              f"draft on the sharded params: accepted {accepted}/{drafted}, "
              f"ids equal generate's {bool(torch.equal(ids, greedy))}",
              flush=True)
        require(accepted == drafted > 0, f"accepted {accepted}/{drafted}")
        require(torch.equal(ids, greedy), "sharded speculative ids differ")
        stats["speculative_accepted"] = [accepted, drafted]
        take()
        stats["launches"] = {k: n for k, n in launched.items() if n}
        print(f"phase12 launches on its sharded paths: {stats['launches']}",
              flush=True)
        del params, sharded, want, got, ids, greedy
        gc.collect()
        torch.cuda.empty_cache()
        stats["seconds"] = time.monotonic() - t_phase
        stats["training"] = phase_multidevice_training(
            torch, flagship, moe, root, dev, mesh, take, lora_base, phase10,
            stats["losses"])
        stats["mesh_serving"] = phase_mesh_serving_and_elastic(
            torch, flagship, moe, root, dev, mesh, take, lora_base)
        stats["launches"] = {k: n for k, n in launched.items() if n}
    shutil.rmtree(store, ignore_errors=True)
    t0 = time.monotonic()
    stats["dryrun"] = dryrun_multidevice(1, "cuda", timeout=600)
    dryrun_s = time.monotonic() - t0
    stats["seconds"] += dryrun_s
    print(f"phase12 dryrun_multidevice(1, 'cuda') in {dryrun_s:.1f} s; "
          f"phase 12 in {stats['seconds']:.1f} s", flush=True)
    ran = [ln for ln in stats["dryrun"] if "skipped" not in ln]
    skipped = [ln for ln in stats["dryrun"] if "skipped" in ln]
    print(f"phase13 dryrun_multidevice(1, 'cuda'): ran {len(ran)} "
          f"layout(s), skipped {len(skipped)}: "
          f"{[ln.split('] ', 1)[1] for ln in skipped]}", flush=True)
    require(len(ran) == 1 and len(skipped) == 7,
            f"the dryrun at one rank: {stats['dryrun']}")
    return stats


# --------------------------------------------------------------- phase 13
def phase_multidevice_training(torch, flagship, moe, root, dev, mesh, take,
                               lora_base, phase10: dict,
                               dense_losses: list) -> dict:
    """13: the training half of multi-device part 2 on phase 12's NCCL
    world of one rank, at full width: make_sharded_moe_train_step on
    MeshConfig() in turns with make_moe_train_step (phase 10's MoE, f32
    params, 10 steps a turn, losses bit-equal), make_sharded_lora_step in
    turns with make_lora_step (phase 11's setup, 6 steps, adapters
    bit-equal, the base untouched), a Trainer(MoEConfig, mesh=...)
    resumed from a step-3 checkpoint (steps 4-5 bit-equal), a
    Trainer(lora=..., mesh=...)'s evaluate against the one-device
    Trainer's, and make_sharded_train_step with the pp arguments
    (n_microbatches=4, unused at pp = 1) against phase 12's losses.
    ``take()`` returns the launches since its last call (phase 12's
    counter)."""
    from kubeflow_tpu_torch.models import train as train_lib
    from kubeflow_tpu_torch.models.lora import (LoRAConfig, make_lora_step,
                                                make_sharded_lora_step)
    from kubeflow_tpu_torch.models.moe import (make_moe_train_step,
                                               make_sharded_moe_train_step)
    from kubeflow_tpu_torch.runtime.data import synthetic_lm_batches
    from kubeflow_tpu_torch.runtime.trainer import Trainer

    t_phase = time.monotonic()
    L, V, B, S = moe.n_layers, moe.vocab_size, 8, 1024
    attn = ("flash_attention", "flash_attention_bwd_dkv",
            "flash_attention_bwd_dq")
    stats: dict = {}
    src = synthetic_lm_batches(B, S, V, seed=0)
    batches = [tuple(torch.from_numpy(x).to(dev) for x in next(src))
               for _ in range(10)]

    # the MoE: one-device, sharded, one-device, on the same seed and
    # batches; each turn's state freed before the next
    turns = ("one_device", "sharded", "one_device")
    runs: dict = {k: [] for k in turns}
    tc = train_lib.TrainConfig()
    take()
    for kind in turns:
        init_fn, step_fn = make_moe_train_step(moe, tc, dev) \
            if kind == "one_device" else \
            make_sharded_moe_train_step(mesh, moe, tc)
        state = init_fn(torch.Generator(device=dev).manual_seed(0))
        run = _timed_steps(torch, step_fn, state, batches)
        del run["state"], state, init_fn, step_fn
        gc.collect()
        torch.cuda.empty_cache()
        runs[kind].append(run)
        counts = take()
        got = {k: counts.get(k, 0) for k in attn}
        require(got == {k: L * 10 for k in attn},
                f"MoE {kind} step launches {got}, expected {L * 10} of each")
    want = runs["one_device"][0]["losses"]
    equal = all(r["losses"] == want for rs in runs.values() for r in rs)
    summary = {kind: {"ms_per_step": [r["ms_per_step"] for r in rs],
                      "tokens_per_s": [B * S / r["ms_per_step"] * 1e3
                                       for r in rs],
                      "peak_mem_gb": max(r["peak_mem_gb"] for r in rs)}
               for kind, rs in runs.items()}
    stats["moe"] = {"losses": want, "bit_equal": equal, **summary}
    for kind, r in summary.items():
        print(f"phase13 MoE {kind} step at world 1, b{B} s{S}, f32 params: "
              f"ms/step {[round(m, 2) for m in r['ms_per_step']]}, tokens/s "
              f"{[round(t, 1) for t in r['tokens_per_s']]}, peak "
              f"{r['peak_mem_gb']:.2f} GB (phase 10's Trainer: "
              f"{phase10['ms_per_step']:.2f} ms/step, "
              f"{phase10['tokens_per_s']:.1f} tokens/s, peak "
              f"{phase10['peak_mem_gb']:.2f} GB)", flush=True)
    print(f"phase13 MoE sharded step losses bit-equal to make_moe_train_"
          f"step's over 10 steps, both one-device turns: {equal}; losses "
          f"{want}; launches 12 of each attention kernel a step", flush=True)
    require(equal, "the sharded MoE step's losses differ from the "
                   "one-device step's")

    # LoRA: phase 11's adapters and batch over its bf16 base, in turns
    lora = LoRAConfig()
    ltc = train_lib.TrainConfig(warmup_steps=1, learning_rate=1e-3)
    one = tuple(torch.from_numpy(x).to(dev) for x in next(iter(
        synthetic_lm_batches(B, S, flagship.vocab_size, seed=7))))
    before = [t.detach().clone() for t in train_lib.tree_leaves(lora_base)]
    adapters = {}
    for kind, (init_fn, step_fn) in (
            ("one_device", make_lora_step(flagship, lora, ltc, dev)),
            ("sharded", make_sharded_lora_step(mesh, flagship, lora, ltc))):
        lp, opt = init_fn(torch.Generator(device=dev).manual_seed(0))
        losses = []
        for _ in range(6):
            lp, opt, loss = step_fn(lora_base, lp, opt, *one)
            losses.append(loss.item())
        adapters[kind] = (losses, lp)
        counts = take()
        got = {k: counts.get(k, 0) for k in attn}
        require(got == {k: 6 * flagship.n_layers for k in attn},
                f"LoRA {kind} launches {got}")
    (la, pa), (lb, pb) = adapters["one_device"], adapters["sharded"]
    equal_lora = la == lb and all(torch.equal(a, b) for a, b in zip(
        train_lib.tree_leaves(pa), train_lib.tree_leaves(pb)))
    base_kept = all(torch.equal(a, b) for a, b in zip(
        train_lib.tree_leaves(lora_base), before))
    stats["lora"] = {"losses": lb, "bit_equal": equal_lora,
                     "base_bit_identical": base_kept}
    print(f"phase13 LoRA sharded step at world 1, 6 steps: losses {lb}; "
          f"adapters and losses bit-equal to make_lora_step's "
          f"{equal_lora}; the base bit-identical {base_kept}", flush=True)
    require(equal_lora and base_kept, "the sharded LoRA step differs from "
                                      "the one-device step")
    del before

    # Trainer(lora=..., mesh=...).evaluate against the one-device Trainer's
    held_out = list(synthetic_lm_batches(B, S, flagship.vocab_size,
                                         n_batches=2, seed=8))
    evals = {}
    for kind, kw in (("one_device", dict(device=dev)),
                     ("mesh", dict(mesh=mesh))):
        with Trainer(flagship, ltc, lora=lora, base_params=lora_base,
                     **kw) as tr:
            tr.params = pb
            evals[kind] = tr.evaluate(held_out)
    take()
    stats["lora_eval"] = evals
    print(f"phase13 LoRA Trainer evaluate on 2 held-out batches: mesh "
          f"{evals['mesh']}, one device {evals['one_device']}", flush=True)
    require(evals["mesh"] == evals["one_device"],
            "Trainer(lora=..., mesh=...).evaluate differs from the "
            "one-device Trainer's")
    del adapters, pa, pb
    gc.collect()
    torch.cuda.empty_cache()

    # Trainer(MoEConfig, mesh=...): A saves step 3, B resumes it
    tdir = os.path.join(root, "moe-mesh")
    host = [tuple(x.cpu().numpy() for x in b) for b in batches[:5]]
    kw = dict(mesh=mesh, checkpoint_dir=tdir, checkpoint_interval=3,
              max_checkpoints=1)
    a = Trainer(moe, tc, **kw)
    a.fit(host[:3], steps=3, log_every=1)
    a.checkpointer.wait()
    b = Trainer(moe, tc, seed=1, **kw)
    require(b.stats.step == 3, f"MoE mesh Trainer B resumed at "
                               f"{b.stats.step}")
    a.fit(host[3:], steps=2, log_every=1)
    b.fit(host[3:], steps=2, log_every=1)
    losses_a, losses_b = list(a.stats.losses)[3:], list(b.stats.losses)
    state = [(t.params, t.opt_state.mu, t.opt_state.nu) for t in (a, b)]
    equal, worst = _tree_diff(torch, dict(zip("pmn", state[1])),
                              dict(zip("pmn", state[0])))
    for t in (a, b):
        t.close()
    counts = take()
    got = {k: counts.get(k, 0) for k in attn}
    stats["moe_resume"] = {"losses_a": losses_a, "losses_b": losses_b,
                           "bit_equal": equal and losses_a == losses_b}
    print(f"phase13 Trainer(MoEConfig, mesh=...) resumed at step 3: steps 4 "
          f"and 5 A {losses_a}, B {losses_b}; state bit-equal {equal} "
          f"(largest leaf difference {worst:.3e}); launches {got} (7 "
          f"steps)", flush=True)
    require(stats["moe_resume"]["bit_equal"],
            "the MoE Trainer's resume on a mesh is not bit-equal")
    require(got == {k: 7 * L for k in attn}, f"MoE mesh Trainer launches "
                                             f"{got}")
    del a, b, state
    shutil.rmtree(tdir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    # the dense step with the pp arguments: at pp = 1 n_microbatches is
    # unused, as in the reference
    init_fn, step_fn = train_lib.make_sharded_train_step(
        mesh, flagship, train_lib.TrainConfig(bf16_params=True),
        n_microbatches=4)
    params, opt = init_fn(torch.Generator(device=dev).manual_seed(0))
    losses = []
    for tokens, targets in batches[:3]:
        params, opt, loss = step_fn(params, opt, tokens, targets)
        losses.append(loss.item())
    counts = take()
    stats["dense_pp_args"] = {"losses": losses,
                              "bit_equal": losses == dense_losses[:3]}
    print(f"phase13 make_sharded_train_step(n_microbatches=4) at world 1, 3 "
          f"steps: losses {losses}, bit-equal to phase 12's "
          f"{stats['dense_pp_args']['bit_equal']}; launches "
          f"{ {k: counts.get(k, 0) for k in attn} }", flush=True)
    require(stats["dense_pp_args"]["bit_equal"],
            "the dense step with the pp arguments differs from phase 12's")
    del params, opt, batches
    gc.collect()
    torch.cuda.empty_cache()
    stats["seconds"] = time.monotonic() - t_phase
    print(f"phase13 in {stats['seconds']:.1f} s (the dryrun's lines come "
          f"after phase 12's dryrun)", flush=True)
    return stats


# --------------------------------------------------------------- phase 14
class _DictNotebookClient:
    """A Notebook store of one process for the elastic agent: ``get``
    returns a copy, ``patch`` merges annotations (None deletes)."""

    def __init__(self, annotations: dict):
        self.obj = {"kind": "Notebook", "metadata": {
            "name": "nb", "namespace": "smoke", "annotations":
            dict(annotations)}}

    def get(self, kind, namespace, name):
        return json.loads(json.dumps(self.obj))

    def patch(self, kind, namespace, name, body):
        anns = self.obj["metadata"]["annotations"]
        for k, v in body["metadata"]["annotations"].items():
            if v is None:
                anns.pop(k, None)
            else:
                anns[k] = v

    def annotation(self, key):
        return self.obj["metadata"]["annotations"].get(key)


def _engine_staggered(gen, prompts: list, max_new: int) -> dict:
    """One request a prompt submitted 25 ms apart straight to the engine:
    ids, wall (first submit to last id), generated tokens/s, median time
    to first token."""
    first: dict = {}
    t_sub: dict = {}
    futures = []
    t0 = time.monotonic()
    for i, p in enumerate(prompts):
        t_sub[i] = time.monotonic()
        futures.append(gen.submit(p, max_new, on_token=(
            lambda tok, i=i: first.setdefault(i, time.monotonic()))))
        time.sleep(0.025)
    ids = [[int(t) for t in f.result(timeout=600)] for f in futures]
    wall = time.monotonic() - t0
    ttft = sorted(first[i] - t_sub[i] for i in first)
    return {"ids": ids, "wall_s": wall,
            "tokens_per_s": len(prompts) * max_new / wall,
            "ttft_median_s": ttft[len(ttft) // 2] if ttft else None}


def _serve_both(torch, make, prompts: list, max_new: int, take, what: str,
                drive="staggered", profile=False) -> dict:
    """The same traffic through the unsharded engine and the sharded one
    (``make(sharded)`` builds each), one after the other: ids prompt by
    prompt, tokens/s, ticks and the launches of each (the sharded
    engine's count toward the phase through ``take``; the unsharded
    comparison's and, with ``profile``, the timed idle ticks' are
    dropped)."""
    from kubeflow_tpu_torch import ops
    out = {}
    for side in ("unsharded", "sharded"):
        ops.reset_launch_counts()
        with make(side == "sharded") as gen:
            if drive == "staggered":
                run = _engine_staggered(gen, prompts, max_new)
            else:  # one after the other: the rows beside are the same
                t0 = time.monotonic()
                run = {"ids": [[int(t) for t in gen.generate_sync(
                    p, max_new, timeout=600)] for p in prompts]}
                run["wall_s"] = time.monotonic() - t0
                run["tokens_per_s"] = len(prompts) * max_new / run["wall_s"]
            counts = take() if side == "sharded" else ops.launch_counts()
            run["ticks"] = getattr(gen, "steps_total", None)
            run["batches"] = getattr(gen, "batches_total", None)
            run["launches"] = {k: n for k, n in counts.items() if n}
            if profile:
                tick = _engine_tick(torch, gen, "phase14", f"{what}, {side}")
                run["tick"] = {k: v for k, v in tick.items()
                               if k != "profile"}
                run["tick"]["device_counts"] = \
                    tick["profile"]["device_counts"]
            ops.reset_launch_counts()
        out[side] = run
    same = out["sharded"]["ids"] == out["unsharded"]["ids"]
    out["ids_equal"] = same
    un, sh = out["unsharded"], out["sharded"]
    print(f"phase14 {what}: ids equal to the unsharded engine's prompt by "
          f"prompt {same}; tokens/s sharded {sh['tokens_per_s']:.1f} "
          f"unsharded {un['tokens_per_s']:.1f}; ticks {sh['ticks']} / "
          f"{un['ticks']}, batches {sh['batches']} / {un['batches']}; "
          f"launches sharded {sh['launches']} unsharded {un['launches']}",
          flush=True)
    require(same, f"{what}: the sharded engine's ids differ from the "
                  f"unsharded engine's")
    return out


def phase_mesh_serving_and_elastic(torch, flagship, moe, root, dev, mesh,
                                   take, params4) -> dict:
    """14: the serving half of multi-device and elastic training on phase
    12's NCCL world of one rank (MeshConfig()), at the flagship's width.
    Phase 7b's bf16 flagship through shard_decode_params: phase 3's
    traffic (8 x 128 -> 64) in the bucketed engine and 8 streams 25 ms
    apart (128 -> 32) in the continuous engine, then an int8 engine
    (quantize, kv_quant; 4 x 128 -> 32), each beside the unsharded
    engine; phase 10's flagship-MoE (bf16, and its f32 factor-4 twin)
    through generate and the continuous engine (2 x 128 -> 32 each); an
    ElasticTrainer whose ElasticAgent drains and reshards to 1 slice
    between fits, against an uninterrupted Trainer; a
    CheckpointMigrationDriver checkpoint at step 4 resumed into a fresh
    Trainer. At world 1 no plan is broadcast: the sharded
    engines launch what the unsharded ones do, tick for tick."""
    from kubeflow_tpu_torch import ops
    from kubeflow_tpu_torch.models import train as train_lib
    from kubeflow_tpu_torch.models.decode import generate
    from kubeflow_tpu_torch.models.moe import init_moe_params
    from kubeflow_tpu_torch.models.transformer import param_specs
    from kubeflow_tpu_torch.parallel.mesh import MeshConfig
    from kubeflow_tpu_torch.runtime.data import synthetic_lm_batches
    from kubeflow_tpu_torch.runtime.elastic import (ElasticAgent,
                                                    ElasticTrainer)
    from kubeflow_tpu_torch.runtime.migrate import CheckpointMigrationDriver
    from kubeflow_tpu_torch.runtime.serving import (
        BatchedGenerator, ContinuousBatchedGenerator)
    from kubeflow_tpu_torch.runtime.sharded_decode import shard_decode_params
    from kubeflow_tpu_torch.runtime.trainer import Trainer
    from kubeflow_tpu_torch.utils import names

    t_phase = time.monotonic()
    c, L, V = flagship, flagship.n_layers, flagship.vocab_size
    stats: dict = {"card": CARD[0]}
    print(f"phase14 on {CARD[0]}: a NCCL world of one rank, "
          f"MeshConfig()", flush=True)
    rng = torch.Generator().manual_seed(31)

    def prompt(n):
        return torch.randint(0, V, (n,), generator=rng).tolist()

    # ---- dense bf16: bucketed (phase 3's traffic), continuous (phase 8's)
    sharded = shard_decode_params(params4, mesh, c)
    batch = [prompt(128) for _ in range(8)]

    def bucketed(on_mesh):
        return BatchedGenerator(sharded if on_mesh else params4, c,
                                max_batch=8, max_wait_s=0.5, device="cuda")

    def run_bucketed(on_mesh):
        with bucketed(on_mesh) as gen:
            gen.generate_sync(prompt(8), 2, timeout=600)     # warm-up
            ops.reset_launch_counts()
            t0 = time.monotonic()
            futures = [gen.submit(p, 64) for p in batch]
            ids = [[int(t) for t in f.result(timeout=600)] for f in futures]
            wall = time.monotonic() - t0
            counts = take() if on_mesh else ops.launch_counts()
            ops.reset_launch_counts()
            return {"ids": ids, "wall_s": wall,
                    "tokens_per_s": 8 * 64 / wall,
                    "batches": gen.batches_total - 1, "launches": counts}
    b_un, b_sh = run_bucketed(False), run_bucketed(True)
    want = {"flash_attention": b_sh["batches"] * L,
            "flash_decode": b_sh["batches"] * 63 * L}
    got = {k: b_sh["launches"].get(k, 0) for k in want}
    same_counts = got == {k: b_un["launches"].get(k, 0) for k in want}
    stats["bucketed"] = {
        "ids_equal": b_sh["ids"] == b_un["ids"],
        "tokens_per_s": {"sharded": b_sh["tokens_per_s"],
                         "unsharded": b_un["tokens_per_s"]},
        "batches": [b_sh["batches"], b_un["batches"]], "launches": got}
    print(f"phase14 bucketed engine, 8 x (prompt 128, 64 new) on the "
          f"sharded bf16 flagship (phase 7b's step-4 params): ids equal to "
          f"the unsharded engine's prompt by prompt "
          f"{stats['bucketed']['ids_equal']}; {b_sh['tokens_per_s']:.1f} "
          f"generated tokens/s sharded, {b_un['tokens_per_s']:.1f} "
          f"unsharded; batches {b_sh['batches']} / {b_un['batches']}; "
          f"launches {got} (= unsharded {same_counts}, expected {want})",
          flush=True)
    require(stats["bucketed"]["ids_equal"], "sharded bucketed ids differ")
    require(got == want and same_counts,
            f"sharded bucketed launches {got}, expected {want}")
    launched = dict(got)

    def continuous(**kw):
        def make(on_mesh):
            return ContinuousBatchedGenerator(
                sharded if on_mesh else params4, c, n_slots=8,
                device="cuda", **kw)
        return make
    # the serving over a mesh is cut to half the streams and half the new
    # tokens of phase 8's traffic (and the int8 and MoE runs below to
    # half their prompts) to keep the whole run's time: every check
    # stays (ids prompt by prompt, launches a tick)
    streams = [prompt(128) for _ in range(8)]
    run = _serve_both(torch, continuous(), streams, 32, take,
                      "continuous engine, 8 x (prompt 128, 32 new) 25 ms "
                      "apart", profile=True)
    for side in ("sharded", "unsharded"):
        r = run[side]
        r["flash_decode_a_tick"] = r["launches"].get("flash_decode", 0) / \
            r["ticks"]
    sh, un = run["sharded"], run["unsharded"]
    print(f"phase14 continuous engine: flash_decode a tick sharded "
          f"{sh['flash_decode_a_tick']:.2f} unsharded "
          f"{un['flash_decode_a_tick']:.2f} (expected {L}); kernels a tick "
          f"launched by the host sharded "
          f"{sh['tick']['launches_a_tick']:.1f} unsharded "
          f"{un['tick']['launches_a_tick']:.1f} (on the device "
          f"{sh['tick']['kernels_a_tick']:.1f} / "
          f"{un['tick']['kernels_a_tick']:.1f}); tick ms sharded "
          f"{sh['tick']['tick_ms_unprofiled']:.2f} unsharded "
          f"{un['tick']['tick_ms_unprofiled']:.2f}; time to first token "
          f"median {1e3 * sh['ttft_median_s']:.1f} / "
          f"{1e3 * un['ttft_median_s']:.1f} ms; on {CARD[0]}", flush=True)
    require(sh["launches"] == {"flash_decode": sh["ticks"] * L},
            f"sharded continuous launches {sh['launches']}, ticks "
            f"{sh['ticks']}")
    # the check covers ``_tick`` only (``_engine_tick`` calls it
    # directly): the loop's plan and agreement are not in the window, and
    # at world 1 they make no call. The host's calls that put work on the
    # device (kernel launches, copies, sets) must be equal over the 10
    # ticks. The device's own record is printed, not compared: it loses
    # kernels as a run goes on (one every 2-3 profiled windows of the
    # same ticks, and now and then a block of 20-40) while the host's
    # calls stay exact
    a, b = (r["tick"].pop("device_counts") for r in (sh, un))
    differ = {k: (a.get(k, 0), b.get(k, 0)) for k in set(a) | set(b)
              if a.get(k, 0) != b.get(k, 0)}
    print(f"phase14 calls putting work on the device over 10 ticks "
          f"(launches, copies, sets): sharded "
          f"{sh['tick']['enqueues_a_tick'] * 10:.0f} unsharded "
          f"{un['tick']['enqueues_a_tick'] * 10:.0f}; device events "
          f"recorded {sh['tick']['kernels_a_tick'] * 10:.0f} / "
          f"{un['tick']['kernels_a_tick'] * 10:.0f}, {len(differ)} kinds "
          f"recorded unequally", flush=True)
    require(sh["flash_decode_a_tick"] == un["flash_decode_a_tick"] == L and
            sh["tick"]["enqueues_a_tick"] == un["tick"]["enqueues_a_tick"]
            > 0 and sh["tick"]["launches_a_tick"] ==
            un["tick"]["launches_a_tick"],
            "the sharded tick puts other work on the device than the "
            "unsharded one at world 1")
    stats["continuous"] = {k: {kk: vv for kk, vv in v.items() if kk != "ids"}
                           if isinstance(v, dict) else v
                           for k, v in run.items()}
    stats["dense_seconds"] = time.monotonic() - t_phase
    launched["flash_decode"] += sh["launches"].get("flash_decode", 0)

    # ---- int8 weights and KV on the sharded tree
    q_prompts = [prompt(128) for _ in range(4)]
    run = _serve_both(torch, continuous(quantize=True, kv_quant=True),
                      q_prompts, 32, take,
                      "int8 engine (quantize, kv_quant), 4 x (prompt 128, "
                      "32 new)")
    sh = run["sharded"]
    require(sh["launches"] == {"flash_decode_int8": sh["ticks"] * L},
            f"sharded int8 launches {sh['launches']}")
    stats["int8"] = {"ids_equal": run["ids_equal"],
                     "tokens_per_s": sh["tokens_per_s"],
                     "launches": sh["launches"]}
    launched["flash_decode_int8"] = sh["launches"].get("flash_decode_int8",
                                                       0)
    del sharded
    gc.collect()
    torch.cuda.empty_cache()

    # ---- the MoE (phase 10's seed-20 params), bf16 then the f32 twin
    mparams = init_moe_params(torch.Generator(device="cuda").manual_seed(20),
                              moe, device="cuda")
    stats["moe"] = {}
    for label, mc, drive in (
            ("bf16", moe, "in_turn"),
            ("f32_factor4", moe.replace(dtype="float32", capacity_factor=(
                moe.n_experts / moe.experts_per_token)), "staggered")):
        msharded = shard_decode_params(mparams, mesh, mc)
        m_prompts = torch.randint(0, V, (2, 128), generator=rng).to(dev)
        want_ids = generate(mparams, m_prompts, mc, 32)
        torch.cuda.synchronize()
        ops.reset_launch_counts()    # the unsharded comparison's launches
        got_ids = generate(msharded, m_prompts, mc, 32)
        torch.cuda.synchronize()
        counts = take()
        require(counts.get("flash_decode", 0) == 31 * L,
                f"MoE sharded generate launches {counts}")
        launched["flash_decode"] += counts.get("flash_decode", 0)
        launched["flash_attention"] += counts.get("flash_attention", 0)

        def make(on_mesh, mc=mc, msharded=msharded):
            return ContinuousBatchedGenerator(
                msharded if on_mesh else mparams, mc, n_slots=8,
                device="cuda")
        run = _serve_both(torch, make, m_prompts.tolist(), 32, take,
                          f"MoE {label} continuous engine, 2 x (prompt "
                          f"128, 32 new) "
                          + ("one after the other" if drive == "in_turn"
                             else "25 ms apart"), drive=drive)
        sh = run["sharded"]
        launched["flash_decode"] += sh["launches"].get("flash_decode", 0)
        gen_equal = bool(torch.equal(got_ids, want_ids))
        stats["moe"][label] = {"generate_ids_equal": gen_equal,
                               "engine_ids_equal": run["ids_equal"],
                               "engine_tokens_per_s": sh["tokens_per_s"],
                               "launches": sh["launches"]}
        print(f"phase14 MoE {label} (experts over ep, capacity factor "
              f"{mc.capacity_factor}): sharded generate 2 x 128 -> 32 ids "
              f"equal to unsharded {gen_equal}; engine ids equal "
              f"{run['ids_equal']}", flush=True)
        require(gen_equal, f"MoE {label}: sharded generate ids differ")
        del msharded
    del mparams
    gc.collect()
    torch.cuda.empty_cache()
    stats["serving_seconds"] = time.monotonic() - t_phase
    print(f"phase14 serving: dense bf16 {stats['dense_seconds']:.1f} s, "
          f"with int8 and the MoE {stats['serving_seconds']:.1f} s",
          flush=True)

    # ---- elastic and migration against one uninterrupted Trainer
    t_train = time.monotonic()
    tc = train_lib.TrainConfig(bf16_params=True)
    src = synthetic_lm_batches(8, 1024, V, seed=0)
    host = [next(src) for _ in range(6)]
    attn = ("flash_attention", "flash_attention_bwd_dkv",
            "flash_attention_bwd_dq")
    ops.reset_launch_counts()
    u = Trainer(c, tc, mesh=mesh)
    u.fit(host[:4], steps=4, log_every=1)
    mdir = os.path.join(root, "migration")
    holder = {}
    driver = CheckpointMigrationDriver(
        lambda nb: mdir, lambda nb: (u.stats.step, u.params, u.opt_state),
        lambda nb: (holder["b"].params, holder["b"].opt_state), mesh=mesh,
        param_specs=param_specs(c, train_lib.mesh_rules(mesh)))
    client = _DictNotebookClient({names.RUNTIME_STEP_ANNOTATION: "4"})
    nb = client.get("Notebook", "smoke", "nb")
    t0 = time.monotonic()
    token = driver.checkpoint(client, nb)
    ckpt_s = time.monotonic() - t0
    step_dir = os.path.join(mdir, "4")
    ckpt_bytes = sum(os.path.getsize(os.path.join(step_dir, f))
                     for f in os.listdir(step_dir))
    u.fit(host[4:], steps=2, log_every=1)
    want_losses = [x for _, x in u.stats.losses]

    # the elastic trainer: 4 steps, the agent's drain (a forced save)
    # and reshard to 1 slice (a no-op on one card), 2 steps
    edir = os.path.join(root, "elastic")
    agent_client = _DictNotebookClient({
        names.ELASTIC_ANNOTATION: "true",
        names.ELASTIC_SLICES_ANNOTATION: "1",
        names.ELASTIC_CURRENT_SLICES_ANNOTATION: "1"})
    et = ElasticTrainer(MeshConfig(), 1, c, tc, edir, device="cuda")
    agent = ElasticAgent(et, agent_client, "smoke", "nb")
    et.fit(host[:4], steps=4, log_every=1)
    agent_client.patch("Notebook", "smoke", "nb", {"metadata": {
        "annotations": {names.ELASTIC_RESIZE_ANNOTATION: "Draining",
                        names.ELASTIC_TARGET_ANNOTATION: "1"}}})
    t0 = time.monotonic()
    agent.poll_once()
    drain_s = time.monotonic() - t0
    acks = [agent_client.annotation(names.ELASTIC_ACK_ANNOTATION)]
    agent_client.patch("Notebook", "smoke", "nb", {"metadata": {
        "annotations": {names.ELASTIC_RESIZE_ANNOTATION: "Resharding"}}})
    agent.poll_once()
    acks.append(agent_client.annotation(names.ELASTIC_ACK_ANNOTATION))
    agent_client.patch("Notebook", "smoke", "nb", {"metadata": {
        "annotations": {names.ELASTIC_RESIZE_ANNOTATION: None,
                        names.ELASTIC_ACK_ANNOTATION: None}}})
    agent.poll_once()
    et.fit(host[4:], steps=2, log_every=1)
    e_losses = [x for _, x in et.stats.losses]
    saved = sorted(os.listdir(edir))
    try:
        et.resize(2)
        refused = None
    except ValueError as exc:
        refused = str(exc)
    et_equal, _ = _tree_diff(torch, _state_tree(et.trainer), _state_tree(u))
    et.close()
    del et, agent
    stats["elastic"] = {"losses": e_losses,
                        "bit_equal": e_losses == want_losses and et_equal,
                        "acks": acks, "drain_save_s": drain_s,
                        "saved_steps": saved, "resize_2_refused": refused}
    print(f"phase14 ElasticTrainer(MeshConfig(), 1, flagship, bf16 params): "
          f"4 steps, the agent's drain (forced durable save of step 4) "
          f"{drain_s:.3f} s, acks {acks}, 2 steps; losses {e_losses} "
          f"bit-equal to an uninterrupted Trainer's "
          f"{stats['elastic']['bit_equal']}; resize(2) on one card: "
          f"{refused!r}; on {CARD[0]}", flush=True)
    require(stats["elastic"]["bit_equal"],
            "the elastic run is not bit-equal to the uninterrupted one")
    require(acks == ["Draining", "Resharding"] and saved == ["4"],
            f"elastic handshake acks {acks}, saved steps {saved}")
    require(refused is not None and "exceed" in refused,
            f"resize(2) on one card: {refused!r}")

    # migration: the step-4 checkpoint resumed into a fresh Trainer
    holder["b"] = b = Trainer(c, tc, mesh=mesh, seed=1)
    t0 = time.monotonic()
    step, b.params, b.opt_state = driver.resume(client, nb, token)
    torch.cuda.synchronize()
    resume_s = time.monotonic() - t0
    b.stats.step = step
    b.fit(host[4:], steps=2, log_every=1)
    b_losses = [x for _, x in b.stats.losses]
    b_equal, worst = _tree_diff(torch, _state_tree(b), _state_tree(u))
    counts = take()
    b.close()
    u.close()
    del b, u, holder
    stats["migration"] = {
        "token": token, "checkpoint_s": ckpt_s, "resume_s": resume_s,
        "bytes": ckpt_bytes, "losses": b_losses,
        "bit_equal": b_losses == want_losses[4:] and b_equal,
        "resumed_annotation": client.annotation(
            names.RESUMED_STEP_ANNOTATION)}
    print(f"phase14 migration of a live flagship Trainer at step 4: "
          f"checkpoint {ckpt_s:.3f} s, {ckpt_bytes / 1e9:.3f} GB on disk; "
          f"resume into a fresh Trainer {resume_s:.3f} s; token {token}; "
          f"steps 5-6 {b_losses} bit-equal to the uninterrupted run "
          f"{stats['migration']['bit_equal']} (largest leaf difference "
          f"{worst:.3e}); on {CARD[0]}", flush=True)
    require(stats["migration"]["bit_equal"] and step == 4 and
            stats["migration"]["resumed_annotation"] == "4",
            "the migrated run is not bit-equal to the uninterrupted one")
    got = {k: counts.get(k, 0) for k in attn}
    # U 6 steps, the elastic trainer 6, B 2
    require(got == {k: 14 * L for k in attn},
            f"elastic and migration launches {got}, expected {14 * L} each")
    for k in attn:
        launched[k] = launched.get(k, 0) + got[k]
    shutil.rmtree(mdir, ignore_errors=True)
    shutil.rmtree(edir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    stats["training_seconds"] = time.monotonic() - t_train
    stats["launches"] = launched
    stats["seconds"] = time.monotonic() - t_phase
    print(f"phase14 launches on its paths {launched}; serving "
          f"{stats['serving_seconds']:.1f} s, elastic and migration "
          f"{stats['training_seconds']:.1f} s; phase 14 in "
          f"{stats['seconds']:.1f} s", flush=True)
    return stats


# --------------------------------------------------------------- phase 15
def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _pod_env(pod: dict, nb_name: str) -> dict:
    """The env of the notebook container of ``pod``, its pod-index
    fieldRef resolved from the pod's own label, as the kubelet would."""
    from kubeflow_tpu_torch.utils import k8s, names
    container = k8s.pod_spec_notebook_container(pod["spec"], nb_name)
    env = {}
    for e in container["env"]:
        if "valueFrom" in e:
            path = e["valueFrom"]["fieldRef"]["fieldPath"]
            require(path == f"metadata.labels['{names.POD_INDEX_LABEL}']",
                    f"{e['name']} refers to {path}")
            env[e["name"]] = k8s.get_label(pod, names.POD_INDEX_LABEL)
        else:
            env[e["name"]] = e["value"]
    return env


def _form_world(env: dict, device: str = "cuda") -> tuple[dict, float]:
    """Form the world of a pod's ``env`` on a free coordinator port
    (``initialize_slice``) and check it (``verify_slice``); returns the
    report and the seconds both took."""
    from kubeflow_tpu_torch.runtime.bootstrap import (SliceEnv,
                                                      initialize_slice,
                                                      verify_slice)
    env = dict(env, KFTPU_COORDINATOR_PORT=str(_free_port()))
    t0 = time.monotonic()
    report = verify_slice(initialize_slice(SliceEnv.from_env(env),
                                           device=device, timeout=120))
    return report, time.monotonic() - t0


class _SliceGate:
    """The simulator's ``ready_hook``: a pod of the gated notebook (one
    worker) turns Ready only once ``initialize_slice`` and
    ``verify_slice`` have formed and checked its NCCL world from the
    pod's own env, on a free coordinator port; every other pod is not
    gated. One world per pod uid: a pod of a new uid (the old pod is
    gone, as a slice-atomic repair rolls it) first ends the world formed
    for the old one (``leave_world``), then forms its own. ``worlds``
    lists each world formed (pod uid, seconds, report). A failure is kept
    and raised again on every poll, so that pod never turns Ready.
    ``device="cpu"`` forms gloo worlds (the tests)."""

    def __init__(self, nb_name: str, device: str = "cuda"):
        self.nb_name = nb_name
        self.device = device
        self.uid = None
        self.env = None
        self.report = None
        self.seconds = None
        self.error = None
        self.worlds: list = []

    def __call__(self, pod: dict) -> bool:
        from kubeflow_tpu_torch.parallel.mesh import leave_world
        from kubeflow_tpu_torch.utils import k8s, names
        if k8s.get_label(pod, names.NOTEBOOK_NAME_LABEL) != self.nb_name:
            return True
        # one pod, so the simulator never runs this for it on two workers
        if self.error is not None:
            raise self.error
        if k8s.uid(pod) == self.uid:
            return True
        try:
            if self.uid is not None:
                leave_world()
            self.env = _pod_env(pod, self.nb_name)
            self.report, self.seconds = _form_world(self.env, self.device)
            self.uid = k8s.uid(pod)
            self.worlds.append({"uid": self.uid, "seconds": self.seconds,
                                "report": self.report})
        except Exception as exc:  # noqa: BLE001 — kept, raised each poll
            self.error = exc
            raise
        return True


def _wait_for(what: str, cond, timeout: float,
              phase: str = "phase15") -> float:
    """Poll ``cond`` until it holds; the seconds it took. Fails the run
    at ``timeout``."""
    t0 = time.monotonic()
    while not cond():
        if time.monotonic() - t0 > timeout:
            fail(f"{phase}: {what} did not happen within {timeout:.0f} s")
        time.sleep(0.01)
    return time.monotonic() - t0


def _settle(count, what: str, phase: str, still_s: float = 0.5,
            limit: float = 30.0) -> None:
    """Wait until ``count()`` holds still for ``still_s``: the
    controllers have answered the last change (``what`` names the
    count). Fails the run at ``limit``."""
    last = [count(), time.monotonic()]

    def still() -> bool:
        now = count()
        if now != last[0]:
            last[:] = [now, time.monotonic()]
        return time.monotonic() - last[1] > still_s
    _wait_for(f"{what} to settle", still, limit, phase=phase)


def _reconcile_totals(mgr) -> dict:
    metric = mgr.metrics.counter("controller_runtime_reconcile_total", "")
    return {f"{c}/{r}": metric.get({"controller": c, "result": r})
            for c in ("notebook-controller", "sim-statefulset-controller",
                      "culling-controller", "slice-repair-controller",
                      "slice-pool-controller", "fleet-scheduler",
                      "extension-controller")
            for r in ("success", "requeue_after", "error")
            if metric.get({"controller": c, "result": r})}


def _notebook_fleet(n_by_shape: dict, namespaces: int = 10,
                    config=None, components: str = "core",
                    store=None) -> dict:
    """Reconcile a fleet of Notebooks on a fresh ``build_manager`` (on
    ``config``, else the default one, ``components`` and ``store``, else
    a fresh ``ClusterStore()``) under
    ``start()`` with 4 workers, the kubelet simulator not gated, the
    reconcilers reading through the manager's cache: each CR's create →
    SliceReady=True latency in ms (host time, measured on the store's
    watch), the writes (resourceVersions), reconciles and the cache's
    index lookups and full scans."""
    from kubeflow_tpu_torch.api import types as api
    from kubeflow_tpu_torch.cluster.store import ClusterStore
    from kubeflow_tpu_torch.main import build_manager
    from kubeflow_tpu_torch.utils import k8s, names

    store = store if store is not None else ClusterStore()
    mgr, _ = build_manager(store, config, simulate_kubelet=True,
                           max_concurrent_reconciles=4,
                           components=components, webhooks=False)
    created: dict = {}
    ready: dict = {}

    def on_notebook(event) -> None:
        key = (k8s.namespace(event.obj), k8s.name(event.obj))
        if key in created and key not in ready and \
                k8s.condition_true(event.obj, api.CONDITION_SLICE_READY):
            ready[key] = time.monotonic()
    store.watch(api.KIND, on_notebook)
    mgr.start()
    try:
        t0 = time.monotonic()
        i = 0
        for shape, n in n_by_shape.items():
            for _ in range(n):
                key = (f"team-{i % namespaces}", f"nb-{shape}-{i}")
                created[key] = time.monotonic()
                store.create(api.new_notebook(key[1], key[0], annotations={
                    names.TPU_ACCELERATOR_ANNOTATION: shape}))
                i += 1
        _wait_for(f"SliceReady on {len(created)} notebooks",
                  lambda: len(ready) == len(created), 60.0)
        seconds = time.monotonic() - t0
    finally:
        mgr.stop()
    lat = sorted((ready[k] - created[k]) * 1e3 for k in created)
    # the manager's read cache attached the store's lock histograms
    write_lock = mgr.metrics.histogram("store_write_lock_seconds", "")
    pods = store.list("Pod")
    stss = store.list("StatefulSet")
    return {"notebooks": len(created), "pods": len(pods),
            "replicas": sum(s["spec"]["replicas"] for s in stss),
            "seconds": seconds,
            "ready_p50_ms": lat[len(lat) // 2],
            "ready_p95_ms": lat[min(len(lat) - 1, int(0.95 * len(lat)))],
            "ready_max_ms": lat[-1], "writes": store._last_rv,
            "reconciles": _reconcile_totals(mgr),
            "cache_index_lookups": mgr.metrics.counter(
                "cache_index_lookups_total", "").total(),
            "cache_full_scans": mgr.metrics.counter(
                "cache_full_scans_total", "").total(),
            "write_lock": {"count": write_lock.total_count(),
                           "sum_s": write_lock.total_sum()}}


class _KubectlProxy:
    """Plays ``kubectl proxy`` for the culler's dev-mode probes, so the
    port's production probers run unchanged. It answers exactly three
    paths: ``/api/v1/namespaces/{ns}/services/{name}:{port}/proxy/healthz``
    is forwarded to ``resolve(ns, name, port)`` (the Service must expose
    that port; its upstream URL, else None); ``.../services/{name}/proxy/
    notebook/{ns}/{name}/api/kernels`` answers one idle kernel whose
    ``last_activity`` is ``kernel_age_s`` old; ``.../api/terminals``
    answers ``[]``. Any other request gets a 404, and every refusal is
    kept in ``refused`` (the caller fails on it)."""

    HEALTHZ = re.compile(r"^/api/v1/namespaces/([^/]+)/services/"
                         r"([^/:]+):(\d+)/proxy/healthz$")
    JUPYTER = re.compile(r"^/api/v1/namespaces/([^/]+)/services/([^/:]+)/"
                         r"proxy/notebook/([^/]+)/([^/]+)/api/"
                         r"(kernels|terminals)$")

    def __init__(self, resolve, kernel_age_s: float = 86400.0):
        import datetime
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        proxy = self
        self.resolve = resolve
        self.refused: list = []
        self.seen: list = []

        def stamp(t: float) -> str:
            return datetime.datetime.fromtimestamp(
                t, datetime.timezone.utc).strftime("%Y-%m-%dT%H:%M:%S.%fZ")

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _reply(self, code: int, body: bytes) -> None:
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _refuse(self, code: int, why: str) -> None:
                proxy.refused.append((self.path, code, why))
                self._reply(code, json.dumps({"error": why}).encode())

            def do_GET(self):
                proxy.seen.append(self.path)
                m = proxy.HEALTHZ.match(self.path)
                if m:
                    upstream = proxy.resolve(m[1], m[2], int(m[3]))
                    if upstream is None:
                        return self._refuse(503, "no Service port")
                    with urllib.request.urlopen(upstream + "/healthz",
                                                timeout=10) as resp:
                        return self._reply(resp.status, resp.read())
                m = proxy.JUPYTER.match(self.path)
                if m and m[1] == m[3] and m[2] == m[4]:
                    body = [] if m[5] == "terminals" else [{
                        "id": "k0", "name": "python3",
                        "execution_state": "idle", "connections": 0,
                        "last_activity": stamp(time.time() - kernel_age_s)}]
                    return self._reply(200, json.dumps(body).encode())
                self._refuse(404, "not a path kubectl proxy serves here")

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.httpd.daemon_threads = True
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=5)


def _served_port_resolver(store):
    """``resolve`` for ``_KubectlProxy``: the upstream of a Service port
    the store's Service ``name`` exposes (a local server on that port)."""
    def resolve(ns: str, name: str, port: int) -> str | None:
        svc = store.get_or_none("Service", ns, name)
        ports = [p.get("port") for p in (svc or {}).get("spec", {})
                 .get("ports", [])]
        return f"http://127.0.0.1:{port}" if port in ports else None
    return resolve


def _cull_sequence(store, mgr, offset: list, config, url: str, port: int,
                   vocab: int, ns: str, nb: str, big: str,
                   phase: str = "phase15") -> dict:
    """Drive the idle culler (registered on ``mgr`` with the clock
    ``time.time() + offset[0]``) through a served notebook's life: a
    check (initialising the idle clock if the Notebook's own events have
    not); the serving-port annotation patched to ``port`` (the Service
    must expose it); 8 requests (128 -> 16) to ``url``, then a check one
    minute on arms the observed counter at 8; 8 more, then a check the
    cull time plus one minute on credits the traffic (last-activity =
    the check's time, no stop annotation) although Jupyter (the proxy's
    day-old idle kernel) is idle past the cull time; no traffic, the
    cull time plus one minute on: ``nb`` and ``big`` (idle Jupyter, no
    serving) are culled at the same check, their StatefulSets to 0
    replicas, no pods, SliceReady False. Checks are enqueued, never
    slept out. ``store`` is the backing store (live reads)."""
    from kubeflow_tpu_torch.api import types as api
    from kubeflow_tpu_torch.controllers import Request
    from kubeflow_tpu_torch.controllers.culling import (
        parse_time, serving_requests_prober)
    from kubeflow_tpu_torch.utils import k8s, names

    cull_s = config.cull_idle_time_min * 60
    probe = serving_requests_prober(config)
    rng = random.Random(15)
    out: dict = {"probe_ms": [], "tokens_per_s": []}

    def ann(name: str, key: str):
        return k8s.get_annotation(store.get(api.KIND, ns, name), key)

    def check(advance_s: float, *nbs: str) -> float:
        """Advance the culler's clock, enqueue one check of each notebook
        and wait until each has stamped it (or been culled); the clock."""
        offset[0] += advance_s
        now = time.time() + offset[0]
        for name in nbs:
            mgr.enqueue("culling-controller", Request(ns, name))
        for name in nbs:
            _wait_for(f"the culling check of {name}", lambda: (
                ann(name, names.STOP_ANNOTATION) is not None or parse_time(
                    ann(name, names.LAST_ACTIVITY_CHECK_TIMESTAMP_ANNOTATION)
                    or "1970-01-01T00:00:00Z") >= int(now)), 30.0)
        return now

    def serve_8(what: str) -> None:
        payloads = [{"prompt": [rng.randrange(vocab) for _ in range(128)],
                     "max_new_tokens": 16} for _ in range(8)]
        results, wall = _concurrent(url, payloads)
        for i, r in enumerate(results):
            _check_ids(r, 16, vocab, f"{what} request {i}")
        out["tokens_per_s"].append(8 * 16 / wall)

    def probed() -> int:
        t0 = time.monotonic()
        total = probe(store.get(api.KIND, ns, nb), str(port))
        out["probe_ms"].append((time.monotonic() - t0) * 1e3)
        require(total is not None, f"{phase}: the serving probe through "
                                   f"the proxy answered None")
        return total

    # 1: a check; the Notebook's first check initialised the idle clock
    check(60.0 + 1.0, nb)
    init = ann(nb, names.LAST_ACTIVITY_ANNOTATION)
    require(init is not None, f"{phase}: no idle clock on {nb}")
    # the author points the culler at the model server (this patch's own
    # check falls inside the check period, so it probes nothing)
    store.patch(api.KIND, ns, nb, {"metadata": {"annotations": {
        names.SERVING_PORT_ANNOTATION: str(port)}}})
    _wait_for(f"the Service of {nb} exposing port {port}", lambda: any(
        p.get("port") == port for p in
        store.get("Service", ns, nb)["spec"]["ports"]), 30.0)
    # 2: 8 requests; the next check, one minute on, arms the counter
    serve_8("the first 8")
    out["requests_total"] = [probed()]
    check(60.0, nb)
    require(ann(nb, names.SERVING_REQUESTS_OBSERVED_ANNOTATION) == "8" and
            ann(nb, names.LAST_ACTIVITY_ANNOTATION) == init,
            f"{phase}: the first serving check did not arm at 8 without "
            f"credit: {store.get(api.KIND, ns, nb)['metadata']}")
    # 3: 8 more; past the cull time the traffic alone keeps it up
    serve_8("the next 8")
    out["requests_total"].append(probed())
    now3 = check(cull_s + 60.0, nb)
    last = ann(nb, names.LAST_ACTIVITY_ANNOTATION)
    require(ann(nb, names.SERVING_REQUESTS_OBSERVED_ANNOTATION) == "16" and
            last == ann(nb, names.LAST_ACTIVITY_CHECK_TIMESTAMP_ANNOTATION)
            and parse_time(last) >= int(now3) and
            ann(nb, names.STOP_ANNOTATION) is None,
            f"{phase}: served traffic past the cull time was not credited: "
            f"{store.get(api.KIND, ns, nb)['metadata']}")
    out["credited"] = {"last_activity": last, "idle_jupyter_s":
                       now3 - parse_time(init)}
    # 4: no traffic; both notebooks culled at one check. The culler's own
    # requeue of ``big`` (its check period, on the real clock) must not
    # have culled it on step 3's clock before this check
    require(ann(big, names.STOP_ANNOTATION) is None and
            store.get("StatefulSet", ns, big)["spec"]["replicas"] == 2,
            f"{phase}: {big} was culled before the traffic-free check: "
            f"{store.get(api.KIND, ns, big)['metadata']}")
    t_enqueue = time.monotonic()
    check(cull_s + 60.0, nb, big)
    out["requests_total"].append(probed())
    for name in (nb, big):
        _wait_for(f"the cull of {name}", lambda: (
            store.get("StatefulSet", ns, name)["spec"]["replicas"] == 0
            and not store.list("Pod", ns, {names.NOTEBOOK_NAME_LABEL: name})
            and not k8s.condition_true(store.get(api.KIND, ns, name),
                                       api.CONDITION_SLICE_READY)), 30.0)
    out["t_enqueue"] = t_enqueue
    out["stop"] = {name: ann(name, names.STOP_ANNOTATION)
                   for name in (nb, big)}
    out["culled_total"] = {name: mgr.metrics.notebook_culling_total.get(
        {"namespace": ns, "name": name}) for name in (nb, big)}
    require(all(v == 1 for v in out["culled_total"].values()),
            f"{phase}: notebook_culling_total {out['culled_total']}")
    return out


def phase_bootstrap(torch, flagship) -> tuple[dict, dict]:
    """15: the port's control plane provisions the card. ``build_manager
    (simulate_kubelet=True)`` reconciles an h100-1 Notebook under
    ``start()``; the simulator's ready hook turns worker 0 Ready only once
    ``initialize_slice`` and ``verify_slice`` have formed its NCCL world
    from the pod's env, so the Notebook's SliceReady is the card's. In
    that world: an h100-16 expectation raises TimeoutError, then
    ``Trainer(mesh=...)`` on ``build_mesh(MeshConfig.auto(device_count))``
    for 3 steps at b8 x s1024 with bf16 params after a one-device Trainer
    on the same seed and batches (losses bit-equal), and greedy
    ``generate`` (8 x 128 -> 16) on ``shard_decode_params`` of the
    trained params (ids equal to the unsharded ``generate``'s). The same
    manager renders an h100-16 Notebook (2 replicas, a headless Service,
    two hostnames; not gated). Then the idle culler, registered on the
    manager with a clock the phase advances and probing through a local
    ``kubectl proxy`` (``_KubectlProxy``; Jupyter idle for a day): the
    h100-1 notebook serves the trained params through ``ServingServer``
    over a continuous engine on the card, its served traffic keeps it up
    past the cull time, and once the traffic stops it and the h100-16
    notebook are culled at one check, each StatefulSet straight to 0
    (``_cull_sequence``). Last, 100 Notebooks (60 h100-1, 30 h100-8, 10
    h100-16) on a fresh manager must all reach SliceReady within 60 s.
    Returns (stats, the launches of the mesh Trainer, the sharded
    ``generate`` and the served requests)."""
    import torch.distributed as dist

    from kubeflow_tpu_torch import ops
    from kubeflow_tpu_torch.api import types as api
    from kubeflow_tpu_torch.cluster.store import ClusterStore
    from kubeflow_tpu_torch.controllers import CullingReconciler
    from kubeflow_tpu_torch.main import build_manager
    from kubeflow_tpu_torch.models import train as train_lib
    from kubeflow_tpu_torch.models.decode import generate
    from kubeflow_tpu_torch.parallel.mesh import (MeshConfig, build_mesh,
                                                  leave_world)
    from kubeflow_tpu_torch.runtime.bootstrap import SliceEnv, verify_slice
    from kubeflow_tpu_torch.runtime.data import synthetic_lm_batches
    from kubeflow_tpu_torch.runtime.sharded_decode import shard_decode_params
    from kubeflow_tpu_torch.runtime.trainer import Trainer
    from kubeflow_tpu_torch.utils import k8s, names
    from kubeflow_tpu_torch.utils.config import ControllerConfig

    t_phase = time.monotonic()
    c, L, V, B, S, n_steps = (flagship, flagship.n_layers,
                              flagship.vocab_size, 8, 1024, 3)
    require(not dist.is_initialized(), "phase 12's world is still formed")
    ns, nb_name, big = "user-ns", "smoke", "smoke-big"
    gate = _SliceGate(nb_name)
    # mgr.client is the manager's read cache; the backing store is read
    # live (its resourceVersion counter counts the writes)
    store = ClusterStore()
    proxy = _KubectlProxy(_served_port_resolver(store))
    config = ControllerConfig(dev_mode=True, dev_proxy_url=proxy.url,
                              cull_idle_time_min=60,
                              idleness_check_period_min=1)
    mgr, _ = build_manager(store, config, simulate_kubelet=True,
                           ready_hook=gate, components="core")
    offset = [0.0]
    CullingReconciler(mgr.client, config, mgr.metrics,
                      clock=lambda: time.time() + offset[0]).setup(mgr)
    # every replicas value each StatefulSet takes, and smoke-big's
    # StatefulSet and Pod events in write order (which thread wrote them)
    replicas: dict = {nb_name: [], big: []}
    big_log: list = []

    def on_sts(event) -> None:
        name = k8s.name(event.obj)
        if k8s.namespace(event.obj) != ns or name not in replicas:
            return
        seq = replicas[name]
        r = event.obj["spec"]["replicas"]
        if not seq or seq[-1][1] != r:
            seq.append((time.monotonic(), r))
        if name == big:
            big_log.append(("StatefulSet", event.type, r,
                            threading.get_ident()))

    def on_pod(event) -> None:
        if event.type == "DELETED" and k8s.get_label(
                event.obj, names.NOTEBOOK_NAME_LABEL) == big:
            big_log.append(("Pod", event.type, k8s.name(event.obj),
                            threading.get_ident()))
    store.watch("StatefulSet", on_sts)
    store.watch("Pod", on_pod)

    def notebook(name):
        return store.get(api.KIND, ns, name)

    def slice_ready(name) -> bool:
        return k8s.condition_true(notebook(name), api.CONDITION_SLICE_READY)

    stats: dict = {}
    launched: dict = {}
    mgr.start()
    try:
        store.create(api.new_notebook(nb_name, ns, image=(
            "kubeflownotebookswg/jupyter-pytorch-cuda-full:v1.9.0"),
            annotations={names.TPU_ACCELERATOR_ANNOTATION: "h100-1"}))
        store.create(api.new_notebook(big, ns, annotations={
            names.TPU_ACCELERATOR_ANNOTATION: "h100-16"}))
        stats["slice_ready_s"] = _wait_for(
            f"SliceReady on {nb_name}",
            lambda: gate.error is not None or slice_ready(nb_name), 180.0)
        require(gate.error is None,
                f"the ready hook failed: {gate.error!r}")
        _wait_for(f"SliceReady on {big}", lambda: slice_ready(big), 30.0)
        nb = notebook(nb_name)
        sts = store.get("StatefulSet", ns, nb_name)
        pod_spec = sts["spec"]["template"]["spec"]
        resources = pod_spec["containers"][0]["resources"]
        report = gate.report
        stats["bootstrap_s"] = gate.seconds
        print(f"phase15 h100-1 Notebook reconciled by the port's manager: "
              f"SliceReady {api.get_condition(nb, 'SliceReady')} "
              f"{stats['slice_ready_s']:.2f} s after the create, "
              f"status.readyReplicas {nb['status']['readyReplicas']}; "
              f"StatefulSet replicas {sts['spec']['replicas']}, resources "
              f"{resources}, nodeSelector {pod_spec['nodeSelector']}; "
              f"worker 0's env {gate.env}", flush=True)
        print(f"phase15 the ready hook's initialize_slice + verify_slice in "
              f"{gate.seconds:.2f} s: {report}", flush=True)
        require(nb["status"]["readyReplicas"] == 1,
                f"h100-1 status: {nb['status']}")
        require(sts["spec"]["replicas"] == 1 and resources == {
            "requests": {names.GPU_RESOURCE_KEY: "1"},
            "limits": {names.GPU_RESOURCE_KEY: "1"}} and
            pod_spec["nodeSelector"] == {
                names.GKE_GPU_ACCELERATOR_LABEL: "nvidia-h100-80gb",
                names.NODE_INSTANCE_TYPE_LABEL: "a3-highgpu-1g"},
            f"the h100-1 StatefulSet: {sts}")
        require(report["backend"] == "nccl" and report["device_count"] == 1
                and report["local_device_count"] == 1,
                f"verify_slice: {report}")
        sts16 = store.get("StatefulSet", ns, big)
        env16 = k8s.env_list_to_dict(
            sts16["spec"]["template"]["spec"]["containers"][0]["env"])
        hosts = env16["TPU_WORKER_HOSTNAMES"].split(",")
        headless = store.get_or_none("Service", ns, f"{big}-workers")
        print(f"phase15 h100-16 Notebook: replicas "
              f"{sts16['spec']['replicas']}, serviceName "
              f"{sts16['spec']['serviceName']}, headless Service "
              f"{headless is not None}, TPU_WORKER_HOSTNAMES {hosts}, "
              f"{len(store.list('Pod', ns, {names.NOTEBOOK_NAME_LABEL: big}))}"
              f" pods Ready (not gated)", flush=True)
        require(sts16["spec"]["replicas"] == 2 and headless is not None
                and headless["spec"]["clusterIP"] == "None"
                and hosts == [f"{big}-{i}.{big}-workers.{ns}.svc"
                              for i in range(2)],
                f"the h100-16 render: {sts16}")

        wrong = SliceEnv.from_env({**gate.env,
                                   "TPU_ACCELERATOR_TYPE": "h100-16"})
        try:
            verify_slice(wrong)
            fail("verify_slice accepted a world of 1 for h100-16")
        except TimeoutError as exc:
            print(f"phase15 verify_slice with TPU_ACCELERATOR_TYPE=h100-16: "
                  f"TimeoutError({exc})", flush=True)

        mesh = build_mesh(MeshConfig.auto(report["device_count"]), "cuda")
        src = synthetic_lm_batches(B, S, V, seed=0)
        batches = [next(src) for _ in range(n_steps)]
        tc = train_lib.TrainConfig(bf16_params=True)
        runs: dict = {}
        for kind in ("one_device", "mesh"):
            kw = {"mesh": mesh} if kind == "mesh" else {}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            trainer = Trainer(c, tc, seed=0, **kw)
            ops.reset_launch_counts()
            trainer.fit(batches[:1], steps=1, log_every=1)
            torch.cuda.synchronize()
            t0 = time.monotonic()
            trainer.fit(batches[1:], steps=n_steps - 1, log_every=1)
            torch.cuda.synchronize()
            runs[kind] = {
                "losses": [x for _, x in trainer.stats.losses],
                "ms_per_step": (time.monotonic() - t0) / (n_steps - 1) * 1e3,
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                "launches": ops.launch_counts()}
            if kind == "mesh":
                params = trainer.params
            trainer.close()
            del trainer
            gc.collect()
            torch.cuda.empty_cache()
        one, got = runs["one_device"], runs["mesh"]
        attn = ("flash_attention", "flash_attention_bwd_dkv",
                "flash_attention_bwd_dq")
        counts = {k: got["launches"][k] for k in attn}
        for k, n in counts.items():
            launched[k] = launched.get(k, 0) + n
        print(f"phase15 Trainer(mesh=build_mesh(MeshConfig.auto(1))), b{B} "
              f"s{S} bf16 params, {n_steps} steps: losses {got['losses']}, "
              f"bit-equal to the one-device Trainer's "
              f"{got['losses'] == one['losses']}; {got['ms_per_step']:.2f} "
              f"ms/step over steps 2-{n_steps} (one device "
              f"{one['ms_per_step']:.2f}), peak {got['peak_mem_gb']:.3f} GB "
              f"(one device {one['peak_mem_gb']:.3f}); launches {counts} "
              f"({CARD[0]})", flush=True)
        require(got["losses"] == one["losses"] and
                all(math.isfinite(x) for x in got["losses"]),
                f"the bootstrapped Trainer's losses {got['losses']} differ "
                f"from one device's {one['losses']}")
        require(counts == {k: L * n_steps for k in attn},
                f"the bootstrapped Trainer's launches {counts}, expected "
                f"{L * n_steps} of each")
        stats.update({"losses": got["losses"], "train": runs})

        rng = torch.Generator().manual_seed(7)
        prompt = torch.randint(0, V, (8, 128), generator=rng).to("cuda")
        want = generate(params, prompt, c, 16)
        sharded = shard_decode_params(params, mesh, c)
        ops.reset_launch_counts()
        ids = generate(sharded, prompt, c, 16)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        for k in ("flash_attention", "flash_decode"):
            launched[k] = launched.get(k, 0) + counts[k]
        print(f"phase15 generate 8 x 128 -> 16 on shard_decode_params of the "
              f"trained params: ids equal to unsharded "
              f"{bool(torch.equal(ids, want))}; launches flash_attention "
              f"{counts['flash_attention']} (expected {L}), flash_decode "
              f"{counts['flash_decode']} (expected {15 * L})", flush=True)
        require(torch.equal(ids, want), "the sharded generate's ids differ")
        require(counts["flash_attention"] == L and
                counts["flash_decode"] == 15 * L,
                f"the sharded generate's launches {counts}")

        # the culled notebook's model server: an engine of the trained
        # params on the card, behind the port's HTTP server
        served = _ServedEngine(torch, params, c, phase="phase15")
        try:
            require(str(served.gen.device).startswith("cuda"),
                    f"the served engine runs on {served.gen.device}")
            del params, sharded, mesh
            cull = _cull_sequence(store, mgr, offset, config, served.url,
                                  served.server.port, V, ns, nb_name, big)
            n_decode = served.launches(
                "flash_decode", "the culled notebook's 16 served requests")
        finally:
            served.close()
        launched["flash_decode"] = launched.get("flash_decode", 0) + n_decode
        stats["culling"] = cull
        seqs = {name: [r for _, r in replicas[name]] for name in replicas}
        to_zero = {name: next(t for t, r in replicas[name] if r == 0)
                   - cull["t_enqueue"] for name in replicas}
        deletes = [e for e in big_log if e[0] == "Pod"]
        i = big_log.index(deletes[0]) if deletes else 0
        one_reconcile = (len(deletes) == 2 and big_log[i + 1] == deletes[1]
                         and deletes[0][3] == deletes[1][3])
        cond = api.get_condition(notebook(nb_name), api.CONDITION_SLICE_READY)
        stats["culling"].update({
            "replicas": seqs, "check_to_zero_ms":
            {k: v * 1e3 for k, v in to_zero.items()},
            "pods_in_one_reconcile": one_reconcile,
            "proxy_paths": len(proxy.seen)})
        for what, value in (
                ("serving probe round trip through the proxy, ms",
                 cull["probe_ms"]),
                ("requests_total at each check", cull["requests_total"]),
                ("served tokens/s, 8 x (128 -> 16) twice",
                 cull["tokens_per_s"]),
                ("flash_decode launches = ticks x layers", n_decode),
                ("traffic-credited check: last-activity, Jupyter idle s",
                 cull["credited"]),
                ("culling check enqueue -> 0 replicas, ms",
                 stats["culling"]["check_to_zero_ms"]),
                ("replicas each StatefulSet took", seqs),
                ("smoke-big's 2 pods deleted in one reconcile",
                 one_reconcile),
                ("stop annotations", cull["stop"]),
                ("notebook_culling_total", cull["culled_total"])):
            print(f"phase15 culler: {what}: {value} ({CARD[0]})", flush=True)
        print(f"phase15 culled: SliceReady {cond['status']} "
              f"({cond['message']}); proxy refused {proxy.refused}",
              flush=True)
        require(all(v > 0 for v in to_zero.values()),
                f"a notebook reached 0 replicas before its culling check: "
                f"{to_zero}")
        require(seqs == {nb_name: [1, 0], big: [2, 0]},
                f"the culled StatefulSets' replicas {seqs}")
        require(one_reconcile, f"smoke-big's pods went in more than one "
                               f"reconcile: {big_log}")
        require(not proxy.refused, f"the proxy refused {proxy.refused}")
        require(cull["requests_total"] == [8, 16, 16],
                f"requests_total {cull['requests_total']}")
    finally:
        mgr.stop()
        proxy.close()
        store.unwatch(on_sts)
        store.unwatch(on_pod)
        leave_world()
    stats["control_plane"] = {"writes": store._last_rv,
                              "reconciles": _reconcile_totals(mgr)}
    print(f"phase15 control plane: {store._last_rv} writes, reconciles "
          f"{stats['control_plane']['reconciles']}", flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    fleet = _notebook_fleet({"h100-1": 60, "h100-8": 30, "h100-16": 10})
    stats["fleet"] = fleet
    print(f"phase15 {fleet['notebooks']} Notebooks (60 h100-1, 30 h100-8, "
          f"10 h100-16 over 10 namespaces; {fleet['pods']} pods, "
          f"{fleet['replicas']} replicas) under start() with 4 workers: all "
          f"SliceReady in {fleet['seconds']:.2f} s; CR→SliceReady p50 "
          f"{fleet['ready_p50_ms']:.1f} ms, p95 {fleet['ready_p95_ms']:.1f} "
          f"ms, max {fleet['ready_max_ms']:.1f} ms (host time); "
          f"{fleet['writes']} writes, reconciles {fleet['reconciles']} "
          f"with the SlicePool reconciler and the fleet scheduler in "
          f"build_manager, no pool and no gang (phase 18 runs the fleet "
          f"without and with the scheduler in turns); cache index lookups "
          f"{fleet['cache_index_lookups']:g}, full scans "
          f"{fleet['cache_full_scans']:g} ({CARD[0]})", flush=True)
    require(fleet["pods"] == fleet["replicas"] == 60 + 30 + 20,
            f"the fleet's pods: {fleet}")
    stats["seconds"] = time.monotonic() - t_phase
    stats["launches"] = launched
    print(f"phase15 in {stats['seconds']:.1f} s; launches {launched} "
          f"({CARD[0]})", flush=True)
    return stats, launched


# --------------------------------------------------------------- phase 16
def _notebook_reasons(store, ns: str, name: str) -> set:
    """The reasons of the Events written on Notebook ``ns/name``."""
    return {e["reason"] for e in store.list("Event", ns)
            if (e.get("involvedObject") or {}).get("kind") == "Notebook"
            and e["involvedObject"].get("name") == name}


def _repair_sequence(store, mgr, gate, ns: str, name: str,
                     timeout: float = 180.0) -> dict:
    """Kill the node of the one worker of ``name`` (an h100-1 Notebook of
    ``mgr``, SliceReady in the world ``gate`` formed for its pod) and
    wait until the slice repair reconciler has rolled its StatefulSet
    whole, 1 -> 0 -> 1, and the gate has formed and verified a new world
    for the new pod: SliceReady again, the slice's health cleared and
    the SliceRepaired event written. Watches on the backing ``store``
    record every replicas value, the first Degraded health, each
    SliceRepairing condition that turns True and the first SliceReady
    after the scale to 0 (host times)."""
    from kubeflow_tpu_torch.api import types as api
    from kubeflow_tpu_torch.cluster.kubelet import kill_node
    from kubeflow_tpu_torch.controllers.slicerepair import (DEGRADED,
                                                            slice_health)
    from kubeflow_tpu_torch.utils import k8s, names

    seen: dict = {"replicas": [store.get("StatefulSet", ns, name)[
        "spec"]["replicas"]], "repairing": 0, "degraded": None,
        "zero": None, "ready": None}
    repairing = [False]

    def mine(event) -> bool:
        return event.type != "DELETED" and k8s.namespace(event.obj) == ns \
            and k8s.name(event.obj) == name

    def on_sts(event) -> None:
        if not mine(event):
            return
        r = event.obj["spec"]["replicas"]
        if seen["replicas"][-1] != r:
            seen["replicas"].append(r)
        if r == 0 and seen["zero"] is None:
            seen["zero"] = time.monotonic()

    def on_notebook(event) -> None:
        if not mine(event):
            return
        now = time.monotonic()
        if seen["degraded"] is None and slice_health(event.obj) == DEGRADED:
            seen["degraded"] = now
        up = k8s.condition_true(event.obj, api.CONDITION_SLICE_REPAIRING)
        if up and not repairing[0]:
            seen["repairing"] += 1
        repairing[0] = up
        if seen["zero"] is not None and seen["ready"] is None and \
                k8s.condition_true(event.obj, api.CONDITION_SLICE_READY):
            seen["ready"] = now

    def repaired() -> bool:
        nb = store.get(api.KIND, ns, name)
        return gate.error is not None or (
            len(gate.worlds) == 2 and slice_health(nb) is None and
            k8s.condition_true(nb, api.CONDITION_SLICE_READY) and
            "SliceRepaired" in _notebook_reasons(store, ns, name))

    store.watch("StatefulSet", on_sts)
    store.watch(api.KIND, on_notebook)
    try:
        pod = store.list("Pod", ns, {names.NOTEBOOK_NAME_LABEL: name})[0]
        node = pod["spec"]["nodeName"]
        t_kill = time.monotonic()
        kill_node(store, node)
        seconds = _wait_for(f"the repair of {name}", repaired, timeout,
                            phase="phase16")
    finally:
        store.unwatch(on_sts)
        store.unwatch(on_notebook)
    require(gate.error is None, f"phase16: the ready hook failed in the "
                                f"repair: {gate.error!r}")
    nb = store.get(api.KIND, ns, name)
    pods = store.list("Pod", ns, {names.NOTEBOOK_NAME_LABEL: name})
    out = {"seconds": seconds, "node": node,
           "nodes_after": [p["spec"]["nodeName"] for p in pods],
           "replicas": seen["replicas"], "repairing_true": seen["repairing"],
           "health": slice_health(nb),
           "reasons": sorted(_notebook_reasons(store, ns, name)),
           "repairs_total": mgr.metrics.counter(
               "slice_repairs_total", "").total(),
           "repair_duration_samples": mgr.metrics.histogram(
               "slice_repair_duration_seconds", "").total_count(),
           "world": gate.worlds[-1]}
    for key, start, end in (("kill_to_degraded_ms", t_kill, "degraded"),
                            ("degraded_to_zero_ms", seen["degraded"], "zero"),
                            ("zero_to_ready_ms", seen["zero"], "ready")):
        out[key] = None if start is None or seen[end] is None else \
            (seen[end] - start) * 1e3
    require(set(out["replicas"]) <= {0, 1} and out["replicas"][-1] == 1
            and 0 in out["replicas"],
            f"phase16: the replicas the slice took: {out['replicas']}")
    require(out["repairing_true"] >= 1 and out["health"] is None,
            f"phase16: SliceRepairing seen True {out['repairing_true']} "
            f"times, health {out['health']}")
    require(out["repairs_total"] >= 1 and
            out["repair_duration_samples"] == 1,
            f"phase16: slice_repairs_total {out['repairs_total']}, "
            f"slice_repair_duration_seconds samples "
            f"{out['repair_duration_samples']}")
    require({"SliceDegraded", "SliceRepairStarted", "SliceRepaired"} <=
            set(out["reasons"]), f"phase16: events {out['reasons']}")
    require(node not in out["nodes_after"],
            f"phase16: the worker is back on the dead node {node}")
    return out


class _WedgedGate:
    """The quarantine part's ``ready_hook``: a pod of ``nb_name`` turns
    Ready only once ``fixed`` is set. Until then its slice check is
    ``verify_slice`` on the pod's own env in this process's world of one
    card, which an h100-8 slice refuses (TimeoutError): the wedged
    image. The verdict is kept per pod uid, as a readiness probe that
    keeps failing; ``refusals`` maps each uid to its error."""

    def __init__(self, nb_name: str):
        self.nb_name = nb_name
        self.fixed = False
        self.refusals: dict = {}

    def __call__(self, pod: dict) -> bool:
        from kubeflow_tpu_torch.runtime.bootstrap import (SliceEnv,
                                                          verify_slice)
        from kubeflow_tpu_torch.utils import k8s, names
        if k8s.get_label(pod, names.NOTEBOOK_NAME_LABEL) != self.nb_name \
                or self.fixed:
            return True
        uid = k8s.uid(pod)
        if uid not in self.refusals:
            try:
                verify_slice(SliceEnv.from_env(_pod_env(pod, self.nb_name)))
                self.refusals[uid] = None
            except TimeoutError as exc:
                self.refusals[uid] = str(exc)
        return self.refusals[uid] is None


def _quarantine_sequence(ns: str = "quarantine-ns",
                         name: str = "wedged") -> dict:
    """Quarantine on a second ``build_manager`` stack, with its repair
    reconciler off and one ``SliceRepairReconciler`` registered on the
    manager with a clock (``time.time() + offset``) this advances, so
    each notebook has one writer. An h100-8 Notebook whose pods fail
    their slice check (``_WedgedGate``) gets a preemption notice on its
    node; two repairs time out (K = 2), each rolled slice-atomically, and
    the notebook is quarantined; three checks further on, no repair has
    started. Then the image is fixed (the gate admits its pods without a
    world) and the quarantine annotation cleared: repairs resume and the
    notebook reaches SliceReady. Checks are enqueued after the clock
    advances, never slept out. Needs a formed world of one rank."""
    from kubeflow_tpu_torch.api import types as api
    from kubeflow_tpu_torch.cluster.kubelet import preempt_node
    from kubeflow_tpu_torch.cluster.store import ClusterStore
    from kubeflow_tpu_torch.controllers import (Request,
                                                SliceRepairReconciler)
    from kubeflow_tpu_torch.controllers.slicerepair import (
        DEGRADED, QUARANTINED, REPAIRING, slice_health)
    from kubeflow_tpu_torch.main import build_manager
    from kubeflow_tpu_torch.utils import k8s, names
    from kubeflow_tpu_torch.utils.config import ControllerConfig

    store = ClusterStore()
    config = ControllerConfig(enable_slice_repair=False,
                              slice_repair_timeout_s=60.0,
                              slice_repair_max_failures=2,
                              slice_repair_backoff_base_s=1.0,
                              slice_repair_backoff_max_s=5.0)
    gate = _WedgedGate(name)
    mgr, _ = build_manager(store, config, simulate_kubelet=True,
                           ready_hook=gate, components="core")
    require("slice-repair-controller" not in mgr._reconcilers,
            "phase16: enable_slice_repair=False registered a repairer")
    offset = [0.0]
    SliceRepairReconciler(mgr.client, config, mgr.metrics,
                          clock=lambda: time.time() + offset[0]).setup(mgr)
    replicas: list = [None]

    def on_sts(event) -> None:
        if event.type != "DELETED" and k8s.name(event.obj) == name and \
                replicas[-1] != event.obj["spec"]["replicas"]:
            replicas.append(event.obj["spec"]["replicas"])

    def nb():
        return store.get(api.KIND, ns, name)

    def repairs() -> float:
        return mgr.metrics.counter("slice_repairs_total", "").total()

    def pod_uids() -> list:
        return [k8s.uid(p) for p in
                store.list("Pod", ns, {names.NOTEBOOK_NAME_LABEL: name})]

    def refused_pod() -> bool:
        uids = pod_uids()
        return len(uids) == 1 and gate.refusals.get(uids[0]) is not None

    def check(advance_s: float, what: str, cond) -> None:
        offset[0] += advance_s
        mgr.enqueue("slice-repair-controller", Request(ns, name))
        _wait_for(what, cond, 60.0, phase="phase16")

    store.watch("StatefulSet", on_sts)
    out: dict = {}
    t0 = time.monotonic()
    mgr.start()
    try:
        store.create(api.new_notebook(name, ns, annotations={
            names.TPU_ACCELERATOR_ANNOTATION: "h100-8"}))
        _wait_for(f"the slice check of {name}'s pod", refused_pod, 60.0,
                  phase="phase16")
        first = pod_uids()[0]
        preempt_node(store, store.get("Pod", ns, f"{name}-0")["spec"][
            "nodeName"])
        # the first repair rolls the slice onto a pod the check refuses
        _wait_for("the first repair's roll", lambda: slice_health(nb()) ==
                  REPAIRING and refused_pod() and pod_uids()[0] != first,
                  60.0, phase="phase16")
        check(config.slice_repair_timeout_s + 1, "the first repair's "
              "timeout", lambda: slice_health(nb()) == DEGRADED)
        second = pod_uids()[0]
        check(config.slice_repair_backoff_max_s + 1, "the second repair's "
              "roll", lambda: repairs() == 2 and refused_pod() and
              pod_uids()[0] != second)
        # the repairer writes the annotation, the core reconciler then
        # mirrors it into the condition: wait for both writes
        check(config.slice_repair_timeout_s + 1, "the quarantine",
              lambda: slice_health(nb()) == QUARANTINED and
              k8s.condition_true(nb(), api.CONDITION_SLICE_QUARANTINED))
        quarantined = nb()
        out["quarantine"] = k8s.get_annotation(quarantined,
                                               names.QUARANTINE_ANNOTATION)
        out["repairs_at_quarantine"] = repairs()
        out["quarantines_total"] = mgr.metrics.counter(
            "slice_quarantines_total", "").get({"namespace": ns})
        out["quarantined_condition"] = k8s.condition_true(
            quarantined, api.CONDITION_SLICE_QUARANTINED)
        for _ in range(3):     # advanced checks: no repair starts
            check(config.slice_repair_timeout_s * 2, "a quarantined check",
                  lambda: mgr.run_until_idle(timeout=10) >= 0)
        out["repairs_after_checks"] = repairs()
        out["health_after_checks"] = slice_health(nb())
        # the image is fixed; the operator clears the poison pill
        gate.fixed = True
        store.patch(api.KIND, ns, name, {"metadata": {"annotations": {
            names.QUARANTINE_ANNOTATION: None}}})
        out["cleared_to_ready_s"] = _wait_for(
            f"SliceReady on {name} after the clear", lambda: (
                slice_health(nb()) is None and
                k8s.condition_true(nb(), api.CONDITION_SLICE_READY)),
            60.0, phase="phase16")
    finally:
        mgr.stop()
        store.unwatch(on_sts)
    out["replicas"] = replicas[1:]
    out["reasons"] = sorted(_notebook_reasons(store, ns, name))
    out["refusals"] = sorted({v for v in gate.refusals.values() if v})
    out["seconds"] = time.monotonic() - t0
    require(out["quarantine"] is not None and
            out["quarantines_total"] == 1 and out["quarantined_condition"],
            f"phase16: the wedged notebook was not quarantined: {out}")
    require(out["repairs_after_checks"] == out["repairs_at_quarantine"] == 2
            and out["health_after_checks"] == QUARANTINED,
            f"phase16: a repair started while quarantined: {out}")
    require({"SliceQuarantined", "SliceQuarantineCleared"} <=
            set(out["reasons"]), f"phase16: events {out['reasons']}")
    require(set(out["replicas"]) <= {0, 1} and out["replicas"][-1] == 1,
            f"phase16: the wedged slice's replicas {out['replicas']}")
    require(out["refusals"] and all(
        "want 8" in r for r in out["refusals"]),
        f"phase16: the slice check's refusals {out['refusals']}")
    return out


def phase_repair(torch, flagship) -> tuple[dict, dict]:
    """16: slice repair on the card. ``build_manager(simulate_kubelet=
    True)`` with its slice repair reconciler, under ``start()``, an
    h100-1 Notebook SliceReady in world A (the gate's NCCL world for its
    pod). In world A a ``Trainer(mesh=...)`` with a ``checkpoint_dir``
    runs 4 steps at b8 x s1024 with bf16 params and saves step 4
    durably, and greedy ``generate`` (8 x 128 -> 16) of its params gives
    ``ids_before``; the Trainer and its mesh are closed. Then the
    worker's node dies (``_repair_sequence``): the StatefulSet is rolled
    whole 1 -> 0 -> 1 and the gate ends world A and forms and verifies
    world B for the new pod. In world B a fresh Trainer (another seed)
    on the same directory restores step 4: its ``generate`` equals
    ``ids_before`` id for id, and steps 5-6 make 6 losses bit-equal to
    an uninterrupted 6-step Trainer on the same seed and batches. Last,
    the quarantine of a wedged h100-8 notebook on a second stack
    (``_quarantine_sequence``). Returns (stats, the launches of the
    resumed path: world A's steps and generate, world B's)."""
    import torch.distributed as dist

    from kubeflow_tpu_torch import ops
    from kubeflow_tpu_torch.api import types as api
    from kubeflow_tpu_torch.cluster.store import ClusterStore
    from kubeflow_tpu_torch.main import build_manager
    from kubeflow_tpu_torch.models import train as train_lib
    from kubeflow_tpu_torch.models.decode import generate
    from kubeflow_tpu_torch.parallel.mesh import (MeshConfig, build_mesh,
                                                  leave_world)
    from kubeflow_tpu_torch.runtime.data import synthetic_lm_batches
    from kubeflow_tpu_torch.runtime.trainer import Trainer
    from kubeflow_tpu_torch.utils import k8s, names
    from kubeflow_tpu_torch.utils.config import ControllerConfig

    t_phase = time.monotonic()
    torch.cuda.reset_peak_memory_stats()
    c, L, V, B, S = (flagship, flagship.n_layers, flagship.vocab_size, 8,
                     1024)
    require(not dist.is_initialized(), "phase 15's world is still formed")
    ns, nb_name = "repair-ns", "trainer"
    attn = ("flash_attention", "flash_attention_bwd_dkv",
            "flash_attention_bwd_dq")
    gate = _SliceGate(nb_name)
    store = ClusterStore()
    mgr, _ = build_manager(store, ControllerConfig(), simulate_kubelet=True,
                           ready_hook=gate, components="core")
    require("slice-repair-controller" in mgr._reconcilers,
            "phase16: build_manager registered no slice repair reconciler")
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        f"smoke-repair-{os.getpid()}")
    src = synthetic_lm_batches(B, S, V, seed=0)
    batches = [next(src) for _ in range(6)]
    tc = train_lib.TrainConfig(bf16_params=True)
    kw = dict(checkpoint_dir=root, checkpoint_interval=4, max_checkpoints=1)
    rng = torch.Generator().manual_seed(7)
    prompt = torch.randint(0, V, (8, 128), generator=rng).to("cuda")
    stats: dict = {}
    launched: dict = {}

    def take(got: dict) -> None:
        """Add the launches since the last reset to ``got`` and to the
        phase's."""
        for k, n in ops.launch_counts().items():
            launched[k] = launched.get(k, 0) + n
            got[k] = got.get(k, 0) + n

    mgr.start()
    try:
        store.create(api.new_notebook(nb_name, ns, image=(
            "kubeflownotebookswg/jupyter-pytorch-cuda-full:v1.9.0"),
            annotations={names.TPU_ACCELERATOR_ANNOTATION: "h100-1"}))
        stats["slice_ready_s"] = _wait_for(
            f"SliceReady on {nb_name}", lambda: gate.error is not None or
            k8s.condition_true(store.get(api.KIND, ns, nb_name),
                               api.CONDITION_SLICE_READY), 180.0,
            phase="phase16")
        require(gate.error is None, f"phase16: the ready hook failed: "
                                    f"{gate.error!r}")
        print(f"phase16 world A: h100-1 Notebook SliceReady "
              f"{stats['slice_ready_s']:.2f} s after the create; the gate's "
              f"initialize_slice + verify_slice in {gate.seconds:.2f} s: "
              f"{gate.report}", flush=True)

        # world A: 4 steps, step 4 saved durably, then greedy ids
        counts_a: dict = {}
        ops.reset_launch_counts()
        mesh = build_mesh(MeshConfig.auto(gate.report["device_count"]),
                          "cuda")
        trainer = Trainer(c, tc, seed=0, mesh=mesh, **kw)
        t0 = time.monotonic()
        trainer.fit(batches[:4], steps=4, log_every=1)
        trainer.save()
        torch.cuda.synchronize()
        stats["world_a_train_s"] = time.monotonic() - t0
        losses = [x for _, x in trainer.stats.losses]
        ids_before = generate(trainer.params, prompt, c, 16)
        torch.cuda.synchronize()
        take(counts_a)
        trainer.close()
        del trainer, mesh
        gc.collect()
        torch.cuda.empty_cache()
        print(f"phase16 world A: Trainer(mesh=...) b{B} s{S} bf16 params, "
              f"steps 1-4 losses {losses}, step 4 saved durably in "
              f"{stats['world_a_train_s']:.2f} s; generate 8 x 128 -> 16; "
              f"launches {counts_a}; the Trainer and its mesh closed "
              f"({CARD[0]})", flush=True)
        require(all(counts_a[k] == 4 * L + (L if k == "flash_attention"
                                             else 0) for k in attn),
                f"phase16: world A's launches {counts_a}")

        rep = _repair_sequence(store, mgr, gate, ns, nb_name)
        stats["repair"] = rep
        print(f"phase16 the worker's node {rep['node']} killed: kill_node -> "
              f"Degraded {rep['kill_to_degraded_ms']:.1f} ms, Degraded -> "
              f"replicas 0 {rep['degraded_to_zero_ms']:.1f} ms, replicas 0 "
              f"-> SliceReady {rep['zero_to_ready_ms']:.1f} ms (host time; "
              f"the new world's bootstrap in it); replicas {rep['replicas']}, "
              f"SliceRepairing True {rep['repairing_true']}x, health "
              f"{rep['health']}, slice_repairs_total {rep['repairs_total']:g},"
              f" slice_repair_duration_seconds samples "
              f"{rep['repair_duration_samples']:g}, events {rep['reasons']}, "
              f"the worker now on {rep['nodes_after']} ({CARD[0]})",
              flush=True)
        print(f"phase16 world B formed by the gate for pod "
              f"{rep['world']['uid']} in {rep['world']['seconds']:.2f} s: "
              f"verify_slice {rep['world']['report']}", flush=True)
        require(rep["world"]["report"]["backend"] == "nccl" and
                rep["world"]["report"]["device_count"] == 1,
                f"phase16: world B's verify_slice {rep['world']['report']}")

        # world B: a fresh Trainer restores step 4, then steps 5-6
        counts_b: dict = {}
        ops.reset_launch_counts()
        mesh = build_mesh(MeshConfig.auto(gate.report["device_count"]),
                          "cuda")
        trainer = Trainer(c, tc, seed=1, mesh=mesh, **kw)
        require(trainer.stats.step == 4,
                f"phase16: world B's Trainer resumed at {trainer.stats.step}")
        ids_after = generate(trainer.params, prompt, c, 16)
        trainer.fit(batches[4:], steps=2, log_every=1)
        torch.cuda.synchronize()
        take(counts_b)
        losses += [x for _, x in trainer.stats.losses]
        trainer.close()
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        # the uninterrupted run: same seed and batches, no checkpoint
        ref = Trainer(c, tc, seed=0, mesh=mesh)
        ref.fit(batches, steps=6, log_every=1)
        want = [x for _, x in ref.stats.losses]
        ref.close()
        del ref, mesh
        gc.collect()
        torch.cuda.empty_cache()
        same_ids = bool(torch.equal(ids_after, ids_before))
        print(f"phase16 world B: Trainer(seed=1) restored step 4; generate "
              f"ids equal to world A's {same_ids}; steps 5-6; the 6 losses "
              f"{losses}, bit-equal to an uninterrupted 6-step Trainer's "
              f"{losses == want}; launches {counts_b} ({CARD[0]})",
              flush=True)
        require(same_ids, "phase16: generate on the restored step 4 "
                          "differs from world A's")
        require(losses == want and all(math.isfinite(x) for x in losses),
                f"phase16: the repaired run's losses {losses} differ from "
                f"the uninterrupted {want}")
        require(all(counts_b[k] == 2 * L + (L if k == "flash_attention"
                                             else 0) for k in attn) and
                counts_b["flash_decode"] == counts_a["flash_decode"]
                == 15 * L, f"phase16: world B's launches {counts_b}, "
                           f"world A's {counts_a}")
        stats.update({"losses": losses, "ids_equal": same_ids,
                      "launches_a": counts_a, "launches_b": counts_b})

        q = _quarantine_sequence()
        stats["quarantine"] = q
        print(f"phase16 quarantine (second stack, one repairer on an "
              f"advanced clock): the h100-8 pods' slice check refused "
              f"{q['refusals']}; 2 timed-out repairs -> quarantined "
              f"({q['quarantine']}), slice_quarantines_total "
              f"{q['quarantines_total']:g}, slice_repairs_total "
              f"{q['repairs_at_quarantine']:g} then "
              f"{q['repairs_after_checks']:g} after 3 more checks; cleared "
              f"-> SliceReady in {q['cleared_to_ready_s']:.2f} s; replicas "
              f"{q['replicas']}; events {q['reasons']}; "
              f"{q['seconds']:.1f} s", flush=True)
    finally:
        mgr.stop()
        if dist.is_initialized():
            leave_world()
        shutil.rmtree(root, ignore_errors=True)
    stats["control_plane"] = {"writes": store._last_rv,
                              "reconciles": _reconcile_totals(mgr)}
    stats["seconds"] = time.monotonic() - t_phase
    stats["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"phase16 control plane: {store._last_rv} writes, reconciles "
          f"{stats['control_plane']['reconciles']}; phase 16 in "
          f"{stats['seconds']:.1f} s, peak {stats['peak_mem_gb']:.3f} GB; "
          f"launches {launched} ({CARD[0]})", flush=True)
    return stats, launched


# --------------------------------------------------------------- phase 17
def _warm_check_worker(conn) -> None:
    """The warm checker's process: for each pod env it receives, form a
    NCCL world of one rank on a free coordinator port (``_form_world``),
    end it, and send back ``("ok", report, seconds)`` or ``("error",
    repr, seconds)``; ``None`` ends the loop."""
    from kubeflow_tpu_torch.parallel.mesh import leave_world
    while True:
        env = conn.recv()
        if env is None:
            break
        t0 = time.monotonic()
        try:
            report, seconds = _form_world(env)
            leave_world()
            conn.send(("ok", report, seconds))
        except Exception as exc:  # noqa: BLE001 — reported to the parent
            conn.send(("error", repr(exc), time.monotonic() - t0))
    conn.close()


class _WarmChecker:
    """The slice check of a pool slice's pod, run in one spawned child
    process (``_warm_check_worker``): each check forms its own world of
    one rank there and ends it before it returns, so a notebook's world
    in this process (one default world a process) is never touched. One
    check at a time; a pod uid that passed is kept in ``checked``.
    ``checks`` lists
    each check (pod uid, slice, seconds, report). A failed check, a
    child that died or one that did not answer within ``timeout`` is
    kept in ``error`` and raised on every later call, so that pod never
    turns Ready. ``close`` ends the child."""

    def __init__(self, timeout: float = 300.0):
        import multiprocessing as mp
        ctx = mp.get_context("spawn")
        self._conn, child = ctx.Pipe()
        self.proc = ctx.Process(target=_warm_check_worker,
                                args=(child,), daemon=True,
                                name="warm-slice-check")
        self.proc.start()
        child.close()
        self.timeout = timeout
        self._lock = threading.Lock()
        self.checked: set = set()
        self.checks: list = []
        self.error = None

    def __call__(self, pod: dict) -> bool:
        from kubeflow_tpu_torch.utils import k8s
        uid = k8s.uid(pod)
        with self._lock:
            if self.error is not None:
                raise self.error
            if uid in self.checked:
                return True
            try:
                self._conn.send(_pod_env(pod, ""))
                if not self._conn.poll(self.timeout):
                    raise TimeoutError(f"no warm check of {k8s.name(pod)} "
                                       f"within {self.timeout:.0f} s")
                status, out, seconds = self._conn.recv()
            except (OSError, EOFError, TimeoutError) as exc:
                self.error = RuntimeError(f"the warm checker failed: "
                                          f"{exc!r}")
                raise self.error from exc
            if status != "ok":
                self.error = RuntimeError(f"the warm check of "
                                          f"{k8s.name(pod)} failed: {out}")
                raise self.error
            self.checked.add(uid)
            self.checks.append({"uid": uid, "pod": k8s.name(pod),
                                "seconds": seconds, "report": out})
            return True

    def close(self) -> None:
        try:
            self._conn.send(None)
        except OSError:
            pass
        self.proc.join(30)
        if self.proc.is_alive():
            self.proc.terminate()
            self.proc.join(10)
        self._conn.close()


class _PoolGate:
    """Phase 17's ``ready_hook``: a pod of a pool slice (the pool label)
    turns Ready once the warm checker's child process has checked it; a
    pod of the cold baseline notebook once ``cold`` (a ``_SliceGate``)
    has formed and verified its world in this process; every other pod
    is not gated."""

    def __init__(self, checker: _WarmChecker, cold: _SliceGate):
        self.checker = checker
        self.cold = cold

    def __call__(self, pod: dict) -> bool:
        from kubeflow_tpu_torch.utils import k8s, names
        if k8s.get_label(pod, names.POOL_LABEL) is not None:
            return self.checker(pod)
        return self.cold(pod)


class _PoolRuntime:
    """A pool-bound notebook's runtime in this process: ``form`` makes
    its world from the env of the pod of the slice it is bound to (as the
    notebook's container would, on a free coordinator port) and a mesh
    over it, ``start`` a ``Trainer`` on that mesh. ``state`` and
    ``abstract`` are the ``CheckpointMigrationDriver``'s providers: the
    live train state, and, when the repairer resumes the notebook on its
    new slice, the trees to restore into — ``abstract`` ends the old
    world, forms the new one from the newly bound pod's env and builds a
    fresh Trainer (seed 1) on it. ``worlds`` lists each world formed."""

    def __init__(self, store, ns: str, name: str, config, tc):
        self.store, self.ns, self.name = store, ns, name
        self.config, self.tc = config, tc
        self.trainer = None
        self.mesh = None
        self.worlds: list = []

    def form(self) -> dict:
        from kubeflow_tpu_torch.api import slicepool as pool_api
        from kubeflow_tpu_torch.api import types as api
        from kubeflow_tpu_torch.parallel.mesh import MeshConfig, build_mesh
        bound = pool_api.bound_slice_ref(
            self.store.get(api.KIND, self.ns, self.name))
        (pod,) = pool_api.bound_slice_pods(self.store, bound)
        report, seconds = _form_world(_pod_env(pod, self.name))
        self.mesh = build_mesh(MeshConfig.auto(report["device_count"]),
                               "cuda")
        world = {"slice": bound[1], "pod": pod["metadata"]["uid"],
                 "seconds": seconds, "report": report}
        self.worlds.append(world)
        return world

    def start(self, seed: int):
        from kubeflow_tpu_torch.runtime.trainer import Trainer
        self.trainer = Trainer(self.config, self.tc, seed=seed,
                               mesh=self.mesh)
        return self.trainer

    def state(self, notebook: dict):
        t = self.trainer
        return t.stats.step, t.params, t.opt_state

    def abstract(self, notebook: dict):
        self.end()
        self.form()
        t = self.start(seed=1)
        return t.params, t.opt_state

    def end(self) -> None:
        import torch.distributed as dist

        from kubeflow_tpu_torch.parallel.mesh import leave_world
        if self.trainer is not None:
            self.trainer.close()
        self.trainer = self.mesh = None
        gc.collect()
        if dist.is_initialized():
            leave_world()


def _pool_sequence(torch, c, tc, B: int, S: int, prompt_len: int,
                   new: int, timeout: float = 180.0):
    """Phase 17's drive at any size: ``build_manager`` (its slice repair
    reconciler off, its SlicePool reconciler on) under ``start()``, one
    ``SliceRepairReconciler`` registered on it whose migrator is a
    ``CheckpointMigrationDriver`` over notebook A's live Trainer, the
    simulator gated by ``_PoolGate``. In order: an h100-1 notebook with
    no pool (the cold baseline) to SliceReady and deleted; the pool
    ``h100-1-pool`` (warmReplicas 1) warmed; notebook A bound to its
    slice w0 in one pool reconcile, no pod rolled; A's world from w0's
    pod env, the pool's capacity raised to 2 (w1 warmed meanwhile), a
    Trainer for 4 steps and greedy ``generate`` on
    ``shard_decode_params``; a preemption notice on w0's node: the
    repairer checkpoints step 4, the pool re-binds A to w1 under the same
    identity and drains w0, the driver restores step 4 in world B (formed
    from w1's pod env); steps 5-6, ``generate`` again, an uninterrupted
    6-step Trainer on world B's mesh; world B ended, A stopped: w1
    released scrubbed, re-warmed, bound by notebook B of another
    namespace. Returns (stats, the launches of A's steps and generates in
    both worlds)."""
    import torch.distributed as dist

    from kubeflow_tpu_torch import ops
    from kubeflow_tpu_torch.api import slicepool as pool_api
    from kubeflow_tpu_torch.api import types as api
    from kubeflow_tpu_torch.cluster.kubelet import preempt_node
    from kubeflow_tpu_torch.cluster.store import ClusterStore
    from kubeflow_tpu_torch.controllers import SliceRepairReconciler
    from kubeflow_tpu_torch.main import build_manager
    from kubeflow_tpu_torch.models.decode import generate
    from kubeflow_tpu_torch.parallel.mesh import leave_world
    from kubeflow_tpu_torch.runtime.data import synthetic_lm_batches
    from kubeflow_tpu_torch.runtime.migrate import CheckpointMigrationDriver
    from kubeflow_tpu_torch.runtime.sharded_decode import shard_decode_params
    from kubeflow_tpu_torch.runtime.trainer import Trainer
    from kubeflow_tpu_torch.utils import k8s, names
    from kubeflow_tpu_torch.utils.config import (DEFAULT_GPU_IMAGE,
                                                 ControllerConfig)
    from kubeflow_tpu_torch.webhook.mutating import _cannot_drive_h100

    require(not dist.is_initialized(), "phase 16's world is still formed")
    L, V = c.n_layers, c.vocab_size
    ns, cold_name, a_name = "pool-ns", "cold", "trainer"
    b_ns, b_name = "pool-b-ns", "second"
    pool_name, pool_ns = "h100-1-pool", "tpu-slice-pools"
    attn = ("flash_attention", "flash_attention_bwd_dkv",
            "flash_attention_bwd_dq")
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        f"smoke-pool-{os.getpid()}")
    checker = _WarmChecker()
    gate = _PoolGate(checker, _SliceGate(cold_name))
    store = ClusterStore()
    config = ControllerConfig(enable_slice_repair=False)
    mgr, _ = build_manager(store, config, simulate_kubelet=True,
                           ready_hook=gate, components="core")
    require("slice-pool-controller" in mgr._reconcilers and
            "slice-repair-controller" not in mgr._reconcilers,
            f"phase17: build_manager registered {sorted(mgr._reconcilers)}")
    runtime = _PoolRuntime(store, ns, a_name, c, tc)

    class _Migration(CheckpointMigrationDriver):
        """The driver, timed; its restore becomes world B's Trainer's
        state."""
        seconds: dict = {}

        def checkpoint(self, client, notebook):
            t0 = time.monotonic()
            token = super().checkpoint(client, notebook)
            self.seconds["checkpoint_s"] = time.monotonic() - t0
            return token

        def resume(self, client, notebook, token):
            t0 = time.monotonic()
            step, params, opt_state = super().resume(client, notebook, token)
            t = runtime.trainer
            t.params, t.opt_state, t.stats.step = params, opt_state, step
            self.seconds["restore_s"] = time.monotonic() - t0
            self.seconds["resumed_step"] = step
            return step, params, opt_state

    driver = _Migration(lambda nb: os.path.join(root, k8s.name(nb)),
                        runtime.state, runtime.abstract)
    SliceRepairReconciler(mgr.client, config, mgr.metrics,
                          migrator=driver).setup(mgr)
    reconciles = mgr.metrics.counter("controller_runtime_reconcile_total", "")

    def reconciled(controller: str) -> float:
        return sum(reconciles.get({"controller": controller, "result": r})
                   for r in ("success", "requeue_after", "error"))

    # host times: each create, each first SliceReady, each migration state
    seen: dict = {"created": {}, "ready": {}, "ready_counts": {},
                  "bound_counts": {}, "migration": [], "w0_replicas": []}

    def on_notebook(event) -> None:
        if event.type == "DELETED":
            return
        key = k8s.name(event.obj)
        now = time.monotonic()
        if key in seen["created"] and key not in seen["bound_counts"] and \
                pool_api.bound_slice_ref(event.obj) is not None:
            seen["bound_counts"][key] = reconciled("slice-pool-controller")
        if key in seen["created"] and key not in seen["ready"] and \
                k8s.condition_true(event.obj, api.CONDITION_SLICE_READY):
            seen["ready"][key] = now
            seen["ready_counts"][key] = {
                c: reconciled(c) for c in ("notebook-controller",
                                           "slice-pool-controller")}
        if key == a_name:
            state = k8s.get_annotation(event.obj,
                                       names.MIGRATION_STATE_ANNOTATION)
            if state and (not seen["migration"] or
                          seen["migration"][-1][0] != state):
                seen["migration"].append((state, now))
            if seen["migration"] and "resumed" not in seen and state is None \
                    and k8s.condition_true(event.obj,
                                           api.CONDITION_SLICE_READY):
                seen["resumed"] = now

    def on_sts(event) -> None:
        if event.type != "DELETED" and k8s.name(event.obj) == \
                f"{pool_name}-w0" and (not seen["w0_replicas"] or
                                       seen["w0_replicas"][-1] !=
                                       event.obj["spec"]["replicas"]):
            seen["w0_replicas"].append(event.obj["spec"]["replicas"])

    def create(name: str, namespace: str) -> None:
        seen["created"][name] = time.monotonic()
        seen["created_counts"] = {
            c: reconciled(c) for c in ("notebook-controller",
                                       "slice-pool-controller")}
        store.create(api.new_notebook(
            name, namespace, image=DEFAULT_GPU_IMAGE,
            annotations={names.TPU_ACCELERATOR_ANNOTATION: "h100-1"}))

    def wait(what: str, cond) -> float:
        def ok():
            for err in (checker.error, gate.cold.error):
                require(err is None, f"phase17: the ready hook failed "
                                     f"while waiting for {what}: {err!r}")
            return cond()
        return _wait_for(what, ok, timeout, phase="phase17")

    def slice_of(i: int):
        return store.get_or_none("StatefulSet", pool_ns, f"{pool_name}-w{i}")

    def slice_state(i: int):
        sts = slice_of(i)
        return sts and k8s.get_annotation(sts, names.POOL_STATE_ANNOTATION)

    def slice_pods(i: int) -> list:
        return store.list("Pod", pool_ns, {"statefulset": f"{pool_name}-w{i}"})

    def bound(name: str, namespace: str = ns):
        nb = store.get_or_none(api.KIND, namespace, name)
        return nb and pool_api.bound_slice_ref(nb)

    def ready_ms(name: str) -> float:
        return (seen["ready"][name] - seen["created"][name]) * 1e3

    def take(got: dict) -> None:
        for k, n in ops.launch_counts().items():
            launched[k] = launched.get(k, 0) + n
            got[k] = got.get(k, 0) + n

    src = synthetic_lm_batches(B, S, V, seed=0)
    batches = [next(src) for _ in range(6)]
    rng = torch.Generator().manual_seed(7)
    prompt = torch.randint(0, V, (B, prompt_len), generator=rng).to("cuda")
    stats: dict = {}
    launched: dict = {}
    store.watch(api.KIND, on_notebook)
    store.watch("StatefulSet", on_sts)
    mgr.start()
    try:
        # 1. the cold baseline: no pool matches; its world in this process
        create(cold_name, ns)
        wait(f"SliceReady on {cold_name}", lambda: cold_name in seen["ready"])
        stats["cold_ready_ms"] = ready_ms(cold_name)
        stats["cold_world"] = gate.cold.worlds[-1]
        stats["cold_reconciles"] = {
            k: v - seen["created_counts"][k]
            for k, v in seen["ready_counts"][cold_name].items()}
        require(store.get_or_none("StatefulSet", ns, cold_name) is not None,
                "phase17: the cold notebook rolled no StatefulSet")
        store.delete(api.KIND, ns, cold_name)
        wait(f"{cold_name}'s pod gone", lambda: not store.list(
            "Pod", ns, {names.NOTEBOOK_NAME_LABEL: cold_name}))
        leave_world()     # the cold notebook's, formed by its gate
        print(f"phase17 cold baseline: h100-1 Notebook {cold_name} (no "
              f"matching pool) CR -> SliceReady {stats['cold_ready_ms']:.1f}"
              f" ms (host time), its own StatefulSet rolled, the ready "
              f"hook's world in {stats['cold_world']['seconds']:.2f} s "
              f"({stats['cold_world']['report']['backend']}); reconciles "
              f"{stats['cold_reconciles']}; deleted ({CARD[0]})",
              flush=True)

        # 2. the pool warms w0: its pod checked in the checker's process
        t0 = time.monotonic()
        store.create(pool_api.new_slice_pool(pool_name, "h100-1", 1))
        stats["warm_s"] = wait("w0 Warm", lambda: slice_state(0) == "Warm")
        require(len(checker.checks) == 1, f"phase17: warm checks "
                                          f"{checker.checks}")
        w0_pod = slice_pods(0)[0]["metadata"]["uid"]
        stats["warm_image"] = slice_pods(0)[0]["spec"]["containers"][0][
            "image"]
        print(f"phase17 SlicePool {pool_name} (h100-1, warmReplicas 1): "
              f"{pool_name}-w0 Warming -> Warm in {stats['warm_s']:.2f} s "
              f"after the create, its pod ({stats['warm_image']}) checked "
              f"in a child process (world of one on a free port, ended): "
              f"{checker.checks[-1]['seconds']:.2f} s, "
              f"{checker.checks[-1]['report']} ({CARD[0]})", flush=True)
        require(stats["warm_image"] == config.tpu_default_image and
                not _cannot_drive_h100(stats["warm_image"]),
                f"phase17: the warm pod's image {stats['warm_image']} "
                f"cannot drive an H100")

        # 3. bind: notebook A in one pool reconcile, no pod rolled
        create(a_name, ns)
        wait(f"SliceReady on {a_name}", lambda: a_name in seen["ready"])
        nb = store.get(api.KIND, ns, a_name)
        stats["warm_ready_ms"] = ready_ms(a_name)
        stats["bind_reconciles"] = {
            k: v - seen["created_counts"][k]
            for k, v in seen["ready_counts"][a_name].items()}
        # pool reconciles that had finished when the bind patch landed
        stats["pool_reconciles_before_bind"] = \
            seen["bound_counts"][a_name] - \
            seen["created_counts"]["slice-pool-controller"]
        stats["bind"] = {
            "slice": pool_api.bound_slice_ref(nb),
            "identity": k8s.get_annotation(nb,
                                           names.SLICE_IDENTITY_ANNOTATION),
            "pod_unchanged": slice_pods(0)[0]["metadata"]["uid"] == w0_pod,
            "w0_replicas": list(seen["w0_replicas"]),
            "own_statefulset": store.get_or_none("StatefulSet", ns, a_name)
            is not None,
            "events": sorted(_notebook_reasons(store, ns, a_name)),
            "latency_samples": mgr.metrics.histogram(
                "slicepool_bind_latency_seconds", "").total_count()}
        print(f"phase17 warm bind: Notebook {a_name} CR -> SliceReady "
              f"{stats['warm_ready_ms']:.1f} ms (cold "
              f"{stats['cold_ready_ms']:.1f} ms, same call; host time); "
              f"reconciles between the two {stats['bind_reconciles']} (the "
              f"first pool reconcile bound it); "
              f"{stats['bind']} ({CARD[0]})", flush=True)
        require(stats["bind"]["slice"] == (pool_ns, f"{pool_name}-w0") and
                stats["bind"]["pod_unchanged"] and
                0 not in stats["bind"]["w0_replicas"] and
                not stats["bind"]["own_statefulset"] and
                "SliceBound" in stats["bind"]["events"] and
                stats["bind"]["latency_samples"] == 1 and
                stats["bind"]["identity"] == "localhost",
                f"phase17: the warm bind {stats['bind']}")
        require(stats["pool_reconciles_before_bind"] == 0,
                f"phase17: {stats['pool_reconciles_before_bind']} pool "
                f"reconciles finished before the one that bound {a_name}")

        # 4. world A from w0's pod env; the capacity raised to 2, so w1
        # is checked in the child while world A trains here
        world_a = runtime.form()
        store.patch(pool_api.KIND, "", pool_name,
                    {"spec": {"warmReplicas": 2}})
        counts_a: dict = {}
        ops.reset_launch_counts()
        trainer = runtime.start(seed=0)
        t0 = time.monotonic()
        trainer.fit(batches[:4], steps=4, log_every=1)
        torch.cuda.synchronize()
        stats["world_a_train_s"] = time.monotonic() - t0
        losses = [x for _, x in trainer.stats.losses]
        ids_before = generate(shard_decode_params(trainer.params,
                                                  runtime.mesh, c),
                              prompt, c, new)
        torch.cuda.synchronize()
        take(counts_a)
        del trainer
        stats["w1_warm_s"] = wait("w1 Warm", lambda: slice_state(1) ==
                                  "Warm")
        print(f"phase17 world A from {world_a['slice']}'s pod env in "
              f"{world_a['seconds']:.2f} s: {world_a['report']}; "
              f"Trainer(mesh=...) b{B} s{S}: steps 1-4 losses {losses} in "
              f"{stats['world_a_train_s']:.2f} s; generate {B} x "
              f"{prompt_len} -> {new} on shard_decode_params; launches "
              f"{counts_a}; meanwhile {pool_name}-w1 warmed (its check in "
              f"the child: {checker.checks[-1]['seconds']:.2f} s, world A "
              f"untouched) ({CARD[0]})", flush=True)
        require(len(checker.checks) == 2 and len(runtime.worlds) == 1,
                f"phase17: checks {checker.checks}, worlds {runtime.worlds}")

        # 5. a preemption notice on w0's node: migrate to w1
        node = slice_pods(0)[0]["spec"]["nodeName"]
        t_preempt = time.monotonic()
        preempt_node(store, node)

        def migrated() -> bool:
            nb = store.get(api.KIND, ns, a_name)
            return "resumed" in seen and \
                pool_api.bound_slice_ref(nb) == (pool_ns,
                                                 f"{pool_name}-w1") and \
                k8s.get_annotation(nb, names.RESUMED_STEP_ANNOTATION) == "4"
        stats["migration_s"] = wait("the migration of A to w1", migrated)
        nb = store.get(api.KIND, ns, a_name)
        states = {s: (t - t_preempt) * 1e3 for s, t in seen["migration"]}
        ckpt_dir = os.path.join(root, a_name, "4")
        stats["migration"] = {
            "states_ms": states, "ready_ms": (seen["resumed"] - t_preempt)
            * 1e3, **driver.seconds,
            "checkpoint_bytes": sum(
                os.path.getsize(os.path.join(ckpt_dir, f))
                for f in os.listdir(ckpt_dir)),
            "identity": k8s.get_annotation(nb,
                                           names.SLICE_IDENTITY_ANNOTATION),
            "migrations_total": mgr.metrics.counter(
                "notebook_migrations_total", "").get({"outcome": "success"}),
            "events": sorted(_notebook_reasons(store, ns, a_name)),
            "world_b": runtime.worlds[-1]}
        wait("w0 drained and a fresh slice warming", lambda: slice_of(0)
             is None and slice_of(2) is not None)
        mig = stats["migration"]
        print(f"phase17 preempt_node({node}) -> "
              + " -> ".join(f"{s} {ms:.1f} ms" for s, ms in states.items())
              + f" -> SliceReady {mig['ready_ms']:.1f} ms (host time); "
              f"checkpoint of step 4 {mig['checkpoint_s']:.3f} s, "
              f"{mig['checkpoint_bytes'] / 1e9:.3f} GB; restore "
              f"{mig['restore_s']:.3f} s (world B's bootstrap "
              f"{mig['world_b']['seconds']:.2f} s in it); identity "
              f"{mig['identity']!r}; notebook_migrations_total "
              f"{mig['migrations_total']:g}; events {mig['events']}; "
              f"{pool_name}-w0 drained (deleted), {pool_name}-w2 "
              f"{slice_state(2)} ({CARD[0]})", flush=True)
        require(list(states) == ["Checkpointing", "Binding", "Resuming"] and
                mig["resumed_step"] == 4 and mig["identity"] == "localhost"
                and mig["migrations_total"] == 1 and
                {"NotebookMigrationStarted", "NotebookMigrated",
                 "SliceReleased"} <= set(mig["events"]) and
                mig["world_b"]["slice"] == f"{pool_name}-w1",
                f"phase17: the migration {mig}")

        # world B: the restored step 4, then steps 5-6
        counts_b: dict = {}
        ops.reset_launch_counts()
        trainer = runtime.trainer
        require(trainer.stats.step == 4,
                f"phase17: world B's Trainer at step {trainer.stats.step}")
        ids_after = generate(shard_decode_params(trainer.params,
                                                 runtime.mesh, c),
                             prompt, c, new)
        trainer.fit(batches[4:], steps=2, log_every=1)
        torch.cuda.synchronize()
        take(counts_b)
        losses += [x for _, x in trainer.stats.losses]
        # world B's Trainer closed before the uninterrupted one is built
        trainer.close()
        runtime.trainer = None
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        ref = Trainer(c, tc, seed=0, mesh=runtime.mesh)
        ref.fit(batches, steps=6, log_every=1)
        want = [x for _, x in ref.stats.losses]
        ref.close()
        del ref
        runtime.end()
        same_ids = bool(torch.equal(ids_after, ids_before))
        print(f"phase17 world B: step 4 restored; generate ids equal to "
              f"world A's {same_ids}; steps 5-6; the 6 losses {losses}, "
              f"bit-equal to an uninterrupted 6-step Trainer's "
              f"{losses == want}; launches {counts_b}; world B ended "
              f"({CARD[0]})", flush=True)
        require(same_ids, "phase17: generate on the restored step 4 differs "
                          "from world A's")
        require(losses == want and all(math.isfinite(x) for x in losses),
                f"phase17: the migrated run's losses {losses} differ from "
                f"the uninterrupted {want}")
        require(all(counts_a[k] == 4 * L + (L if k == "flash_attention"
                                             else 0) for k in attn) and
                all(counts_b[k] == 2 * L + (L if k == "flash_attention"
                                             else 0) for k in attn) and
                counts_a["flash_decode"] == counts_b["flash_decode"] ==
                (new - 1) * L,
                f"phase17: launches world A {counts_a}, B {counts_b}")
        stats.update({"losses": losses, "ids_equal": same_ids,
                      "launches_a": counts_a, "launches_b": counts_b})

        # 6. A stops: w1 released scrubbed, re-warmed, bound by B
        w1_pod = slice_pods(1)[0]["metadata"]["uid"]
        checks = len(checker.checks)
        t0 = time.monotonic()
        store.patch(api.KIND, ns, a_name, {"metadata": {"annotations": {
            names.STOP_ANNOTATION: k8s.now_iso()}}})
        stats["rewarm_s"] = wait("w1 released and re-warmed", lambda: (
            bound(a_name) is None and slice_state(1) == "Warm" and
            len(slice_pods(1)) == 1 and
            slice_pods(1)[0]["metadata"]["uid"] != w1_pod and
            len(checker.checks) > checks))
        w1 = slice_of(1)
        tenant = {names.NOTEBOOK_NAME_LABEL, names.BOUND_NAMESPACE_LABEL}
        idle = {names.LAST_ACTIVITY_ANNOTATION,
                names.LAST_ACTIVITY_CHECK_TIMESTAMP_ANNOTATION}
        (pod,) = slice_pods(1)
        scrub = {
            "annotations": sorted(k8s.annotations(w1) or {}),
            "labels": sorted(set(k8s.labels(w1) or {}) & tenant),
            "template_labels": sorted(set(k8s.get_in(
                w1, "spec", "template", "metadata", "labels",
                default={}) or {}) & tenant),
            "template_annotations": k8s.get_in(
                w1, "spec", "template", "metadata", "annotations"),
            "pod_labels": sorted(set(k8s.labels(pod) or {}) & tenant),
            "idle_clock": sorted((set(k8s.annotations(w1) or {}) |
                                  set(k8s.annotations(pod) or {})) & idle),
            "pod_recreated": pod["metadata"]["uid"] != w1_pod}
        stats["release"] = scrub
        require(scrub == {"annotations": [names.POOL_STATE_ANNOTATION],
                          "labels": [], "template_labels": [],
                          "template_annotations": None, "pod_labels": [],
                          "idle_clock": [], "pod_recreated": True},
                f"phase17: the released w1 {scrub}")
        create(b_name, b_ns)
        wait(f"SliceReady on {b_name}", lambda: b_name in seen["ready"])
        stats["second_ready_ms"] = ready_ms(b_name)
        stats["second_slice"] = bound(b_name, b_ns)
        size = [line for line in mgr.metrics.expose().splitlines()
                if line.startswith("slicepool_size{")]
        stats["slicepool_size"] = size
        stats["warm_checks"] = [x["seconds"] for x in checker.checks]
        print(f"phase17 {a_name} stopped: {pool_name}-w1 released and "
              f"scrubbed {scrub}, its new pod checked and Warm in "
              f"{stats['rewarm_s']:.2f} s; Notebook {b_name} ({b_ns}) CR "
              f"-> SliceReady {stats['second_ready_ms']:.1f} ms, bound to "
              f"{stats['second_slice']}; SliceReleased on {a_name} "
              f"{'SliceReleased' in _notebook_reasons(store, ns, a_name)}; "
              f"{size}; warm checks (s) {stats['warm_checks']} "
              f"({CARD[0]})", flush=True)
        require(stats["second_slice"] == (pool_ns, f"{pool_name}-w1"),
                f"phase17: {b_name} bound to {stats['second_slice']}")
    finally:
        mgr.stop()
        store.unwatch(on_notebook)
        store.unwatch(on_sts)
        checker.close()
        runtime.end()
        shutil.rmtree(root, ignore_errors=True)
    stats["control_plane"] = {"writes": store._last_rv,
                              "reconciles": _reconcile_totals(mgr)}
    return stats, launched


def phase_pool(torch, flagship) -> tuple[dict, dict]:
    """17: the warm pool on the card (``_pool_sequence`` at the
    flagship's width: b8 x s1024 with bf16 params, generate 8 x 128 ->
    16). Returns (stats, the launches of notebook A's path)."""
    from kubeflow_tpu_torch.models import train as train_lib

    t_phase = time.monotonic()
    torch.cuda.reset_peak_memory_stats()
    stats, launched = _pool_sequence(
        torch, flagship, train_lib.TrainConfig(bf16_params=True), 8, 1024,
        128, 16)
    stats["seconds"] = time.monotonic() - t_phase
    stats["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase17 control plane: {stats['control_plane']['writes']} "
          f"writes, reconciles {stats['control_plane']['reconciles']}; "
          f"phase 17 in {stats['seconds']:.1f} s, peak "
          f"{stats['peak_mem_gb']:.3f} GB; launches {launched} "
          f"({CARD[0]})", flush=True)
    return stats, launched


# --------------------------------------------------------------- phase 18
def _sched_sequence(torch, c, tc, B: int, S: int, prompt_len: int,
                    new: int, device: str = "cuda",
                    timeout: float = 180.0) -> tuple[dict, dict]:
    """Phase 18's drive at any size, on ``device`` ("cuda": NCCL worlds;
    "cpu": gloo worlds, the tests): ``build_manager`` with the fleet
    scheduler on, ``sched_default_capacity=1`` and the scheduler's poll
    out of reach, under ``start()``, the simulator gated by a
    ``_SliceGate`` for each of notebooks ``train`` and ``ds``. In order:
    a TPUQuota caps team-ds at 0 and ds (h100-1, a gang of 1, tier
    interactive) is held Pending, quota-denied, with no StatefulSet and,
    once the core's gate has run again past its grace, no
    SchedulerAdmissionTimeout; train (team-train, a gang of 1, tier
    training) is admitted in two phases and rolled, and in its world a
    ``Trainer(mesh=...)`` takes 4 steps, held bit-equal to a one-device
    Trainer; the quota raised to 1 leaves ds Pending with no capacity and
    train unpreempted; train's world is ended and the notebook deleted,
    and ds is reserved by its first scheduler pass after the deletion,
    admitted and rolled into a world of its own, where greedy
    ``generate`` on ``shard_decode_params`` of train's final params is
    held equal to the one-device ``generate``. Returns (stats, the
    launches of the main path: train's 4 steps and ds's ``generate``,
    each counted from 0)."""
    import torch.distributed as dist

    from kubeflow_tpu_torch import ops
    from kubeflow_tpu_torch.api import types as api
    from kubeflow_tpu_torch.api.tpuquota import KIND as QUOTA
    from kubeflow_tpu_torch.api.tpuquota import new_tpu_quota
    from kubeflow_tpu_torch.cluster.store import ClusterStore
    from kubeflow_tpu_torch.controllers import Request
    from kubeflow_tpu_torch.main import build_manager
    from kubeflow_tpu_torch.models.decode import generate
    from kubeflow_tpu_torch.parallel.mesh import (MeshConfig, build_mesh,
                                                  leave_world)
    from kubeflow_tpu_torch.runtime.data import synthetic_lm_batches
    from kubeflow_tpu_torch.runtime.sharded_decode import shard_decode_params
    from kubeflow_tpu_torch.runtime.trainer import Trainer
    from kubeflow_tpu_torch.utils import k8s, names
    from kubeflow_tpu_torch.utils.config import ControllerConfig

    require(not dist.is_initialized(), "phase18: a world is still formed")
    V = c.vocab_size
    tenants = {"train": "team-train", "ds": "team-ds"}
    gates = {name: _SliceGate(name, device) for name in tenants}

    def hook(pod: dict) -> bool:
        gate = gates.get(k8s.get_label(pod, names.NOTEBOOK_NAME_LABEL))
        return gate(pod) if gate is not None else True
    store = ClusterStore()
    config = ControllerConfig(sched_default_capacity=1,
                              sched_admission_grace_s=1.0,
                              sched_poll_s=3600.0)
    mgr, _ = build_manager(store, config, simulate_kubelet=True,
                           ready_hook=hook, components="core")
    sched = mgr._reconcilers.get("fleet-scheduler")
    require(sched is not None, f"phase18: build_manager registered "
                               f"{sorted(mgr._reconcilers)}")
    # the scheduler's passes (key, state before, state after, host time)
    # and writes, recorded on the instance the manager calls
    passes: list = []
    writes = {"patch": 0, "create": 0, "update": 0}
    reconcile = sched.reconcile

    def recorded(req):
        before = store.get_or_none(api.KIND, req.namespace, req.name)
        try:
            return reconcile(req)
        finally:
            after = store.get_or_none(api.KIND, req.namespace, req.name)
            passes.append((req.name, before and k8s.get_annotation(
                before, names.SCHED_STATE_ANNOTATION), after and
                k8s.get_annotation(after, names.SCHED_STATE_ANNOTATION),
                time.monotonic()))
    sched.reconcile = recorded
    for verb in writes:
        def counted(*a, _verb=verb, _fn=getattr(sched.client, verb), **kw):
            writes[_verb] += 1
            return _fn(*a, **kw)
        setattr(sched.client, verb, counted)
    seen: dict = {"created": {}, "states": {}, "ready": {}, "sts": {}}

    def on_notebook(event) -> None:
        if event.type == "DELETED":
            return
        name, now = k8s.name(event.obj), time.monotonic()
        st = k8s.get_annotation(event.obj, names.SCHED_STATE_ANNOTATION)
        seq = seen["states"].setdefault(name, [])
        if st is not None and (not seq or seq[-1][0] != st):
            seq.append((st, now))
        if name in seen["created"] and name not in seen["ready"] and \
                k8s.condition_true(event.obj, api.CONDITION_SLICE_READY):
            seen["ready"][name] = now

    def on_sts(event) -> None:
        name = k8s.name(event.obj)
        if event.type != "DELETED" and name in tenants:
            seen["sts"].setdefault(name, time.monotonic())

    def create(name: str, tier: str) -> None:
        seen["created"][name] = time.monotonic()
        store.create(api.new_notebook(name, tenants[name], annotations={
            names.TPU_ACCELERATOR_ANNOTATION: "h100-1",
            names.SCHED_GANG_ANNOTATION: "1",
            names.SCHED_TIER_ANNOTATION: tier}))

    def state(name: str):
        nb = store.get_or_none(api.KIND, tenants[name], name)
        return nb and k8s.get_annotation(nb, names.SCHED_STATE_ANNOTATION)

    def outcome(name: str, what: str) -> float:
        return sched.admissions_total.get({"tenant": tenants[name],
                                           "outcome": what})

    def reasons(name: str) -> set:
        return _notebook_reasons(store, tenants[name], name)

    def wait(what: str, cond) -> float:
        def ok():
            for gate in gates.values():
                require(gate.error is None, f"phase18: the ready hook "
                                            f"failed while waiting for "
                                            f"{what}: {gate.error!r}")
            return cond()
        return _wait_for(what, ok, timeout, phase="phase18")

    def ms(name: str, since: float) -> dict:
        admitted = [t for st, t in seen["states"][name] if st == "Admitted"]
        return {"admitted": (admitted[0] - since) * 1e3,
                "slice_ready": (seen["ready"][name] - since) * 1e3}

    def take(got: dict) -> None:
        for k, n in ops.launch_counts().items():
            launched[k] = launched.get(k, 0) + n
            got[k] = got.get(k, 0) + n

    src = synthetic_lm_batches(B, S, V, seed=0)
    batches = [next(src) for _ in range(4)]
    rng = torch.Generator().manual_seed(7)
    prompt = torch.randint(0, V, (B, prompt_len), generator=rng).to(device)
    stats: dict = {}
    launched: dict = {}
    store.watch(api.KIND, on_notebook)
    store.watch("StatefulSet", on_sts)
    mgr.start()
    try:
        # 1. team-ds frozen at 0 slices: ds queued, never rolled
        store.create(new_tpu_quota("team-ds-quota", tenants["ds"], 0))
        create("ds", "interactive")
        wait("ds quota-denied", lambda: state("ds") == "Pending" and
             outcome("ds", "quota-denied") >= 1)
        time.sleep(config.sched_admission_grace_s + 0.5)
        core = mgr.metrics.counter("controller_runtime_reconcile_total", "")

        def core_passes() -> float:
            return sum(core.get({"controller": "notebook-controller",
                                 "result": r})
                       for r in ("success", "requeue_after", "error"))
        before = core_passes()
        mgr.enqueue("notebook-controller", Request(tenants["ds"], "ds"))
        wait("the core's gate past the grace", lambda: core_passes() > before)
        stats["denied"] = {
            "state": state("ds"),
            "quota_denied": outcome("ds", "quota-denied"),
            "statefulset": "ds" in seen["sts"],
            "timeout_event": "SchedulerAdmissionTimeout" in reasons("ds")}
        denied = stats["denied"]
        require(denied["state"] == "Pending" and denied["quota_denied"] >= 1
                and not denied["statefulset"] and
                not denied["timeout_event"],
                f"phase18: ds under a quota of 0: {denied}")

        # 2. train admitted in two phases, rolled, its world trains
        create("train", "training")
        wait("SliceReady on train", lambda: "train" in seen["ready"])
        stats["train_states"] = [st for st, _ in seen["states"]["train"]]
        stats["train_ms"] = ms("train", seen["created"]["train"])
        require(stats["train_states"] == ["Pending", "Reserving", "Admitted"]
                and seen["sts"]["train"] >= seen["states"]["train"][-1][1]
                and "GangAdmitted" in reasons("train"),
                f"phase18: train's admission {seen['states']['train']}, "
                f"events {sorted(reasons('train'))}")
        world_train = gates["train"].worlds[-1]
        mesh = build_mesh(MeshConfig.auto(
            world_train["report"]["device_count"]), device)
        counts_train: dict = {}
        ops.reset_launch_counts()
        trainer = Trainer(c, tc, seed=0, mesh=mesh)
        t0 = time.monotonic()
        trainer.fit(batches, steps=4, log_every=1)
        if device == "cuda":
            torch.cuda.synchronize()
        stats["train_s"] = time.monotonic() - t0
        take(counts_train)
        losses = [x for _, x in trainer.stats.losses]
        params = trainer.params
        trainer.close()
        del trainer
        one = Trainer(c, tc, seed=0, device=device)
        one.fit(batches, steps=4, log_every=1)
        want = [x for _, x in one.stats.losses]
        one.close()
        del one
        ops.reset_launch_counts()     # the comparison's launches
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        stats.update({"losses": losses, "launches_train": counts_train,
                      "world_train": world_train})
        require(losses == want and all(math.isfinite(x) for x in losses),
                f"phase18: train's losses {losses} differ from one "
                f"device's {want}")

        # 3. team-ds may hold 1 slice, but the one card is train's
        quota = store.get(QUOTA, "", "team-ds-quota")
        quota["spec"]["maxSlices"] = 1
        store.update(quota)
        wait("ds no-capacity", lambda: outcome("ds", "no-capacity") >= 1)
        mgr.metrics.expose()          # a scrape computes the usage gauge
        nb = store.get(api.KIND, tenants["train"], "train")
        stats["no_capacity"] = {
            "state": state("ds"), "statefulset": "ds" in seen["sts"],
            "train_resize": k8s.get_annotation(
                nb, names.ELASTIC_RESIZE_ANNOTATION),
            "train_preempted": k8s.get_annotation(
                nb, names.SCHED_PREEMPTED_ANNOTATION),
            "preemptions": sched.preemptions_total.total(),
            "quota_used": {t: sched.quota_used.get({"tenant": t})
                           for t in tenants.values()}}
        require(stats["no_capacity"] == {
            "state": "Pending", "statefulset": False, "train_resize": None,
            "train_preempted": None, "preemptions": 0,
            "quota_used": {tenants["train"]: 1, tenants["ds"]: 0}},
            f"phase18: ds with a quota of 1 {stats['no_capacity']}")

        # 4. train goes: ds is reserved by the pass the deletion fans out
        leave_world()
        gc.collect()
        t_delete = time.monotonic()
        store.delete(api.KIND, tenants["train"], "train")
        wait("SliceReady on ds", lambda: "ds" in seen["ready"])
        after = [p for p in passes if p[0] == "ds" and p[3] >= t_delete]
        stats["ds_passes_after_delete"] = [p[1:3] for p in after]
        stats["ds_ms"] = ms("ds", t_delete)
        require(after and after[0][1:3] == ("Pending", "Reserving") and
                [st for st, _ in seen["states"]["ds"]] ==
                ["Pending", "Reserving", "Admitted"] and
                seen["sts"]["ds"] >= seen["states"]["ds"][-1][1] > t_delete,
                f"phase18: ds after the deletion: passes "
                f"{stats['ds_passes_after_delete']}, states "
                f"{seen['states']['ds']}")
        world_ds = gates["ds"].worlds[-1]
        mesh = build_mesh(MeshConfig.auto(
            world_ds["report"]["device_count"]), device)
        counts_ds: dict = {}
        ops.reset_launch_counts()
        ids = generate(shard_decode_params(params, mesh, c), prompt, c, new)
        if device == "cuda":
            torch.cuda.synchronize()
        take(counts_ds)
        want_ids = generate(params, prompt, c, new)
        ops.reset_launch_counts()     # the comparison's launches
        stats.update({"ids_equal": bool(torch.equal(ids, want_ids)),
                      "launches_ds": counts_ds, "world_ds": world_ds})
        require(stats["ids_equal"], "phase18: ds's generate on train's "
                                    "params differs from one device's")
        stats["gang_wait_s"] = {
            t: (sched.gang_wait.count({"tenant": t}),
                sched.gang_wait.sum({"tenant": t}))
            for t in tenants.values()}
        stats["admissions"] = {
            f"{t}/{o}": sched.admissions_total.get({"tenant": t,
                                                    "outcome": o})
            for t in tenants.values()
            for o in ("admitted", "reverted", "quota-denied", "no-capacity")
            if sched.admissions_total.get({"tenant": t, "outcome": o})}
    finally:
        mgr.stop()
        store.unwatch(on_notebook)
        store.unwatch(on_sts)
        if dist.is_initialized():
            leave_world()
    stats["scheduler"] = {"passes": len(passes), "writes": dict(writes)}
    stats["control_plane"] = {"writes": store._last_rv,
                              "reconciles": _reconcile_totals(mgr)}
    return stats, launched


def phase_sched(torch, flagship) -> tuple[dict, dict]:
    """18: the fleet scheduler on the card (``_sched_sequence`` at the
    flagship's width: b8 x s1024 with bf16 params, generate 8 x 128 ->
    16), then phase 15's fleet without and with the scheduler, in turns.
    Returns (stats, the launches of the main path)."""
    from kubeflow_tpu_torch.models import train as train_lib
    from kubeflow_tpu_torch.utils.config import ControllerConfig

    t_phase = time.monotonic()
    L = flagship.n_layers
    torch.cuda.reset_peak_memory_stats()
    stats, launched = _sched_sequence(
        torch, flagship, train_lib.TrainConfig(bf16_params=True), 8, 1024,
        128, 16)
    stats["seconds"] = time.monotonic() - t_phase
    stats["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    gc.collect()
    torch.cuda.empty_cache()
    attn = ("flash_attention", "flash_attention_bwd_dkv",
            "flash_attention_bwd_dq")
    counts_train, counts_ds = stats["launches_train"], stats["launches_ds"]
    for what, value in (
            ("ds under a TPUQuota of 0: Pending, quota-denied evaluations, "
             "a StatefulSet, a SchedulerAdmissionTimeout past the grace",
             stats["denied"]),
            ("train CR -> Admitted -> SliceReady ms (host time)",
             stats["train_ms"]),
            ("train's admission states", stats["train_states"]),
            ("train's world (seconds, report)",
             (stats["world_train"]["seconds"],
              stats["world_train"]["report"])),
            ("Trainer(mesh=...) b8 s1024 4 steps: losses, bit-equal to one "
             "device's, seconds", (stats["losses"], True,
                                   stats["train_s"])),
            ("launches of train's 4 steps", counts_train),
            ("ds with a quota of 1 while train holds the card",
             stats["no_capacity"]),
            ("delete train -> ds Admitted -> SliceReady ms (host time)",
             stats["ds_ms"]),
            ("ds's scheduler passes after the deletion (state before, "
             "after)", stats["ds_passes_after_delete"]),
            ("ds's world (seconds, report)",
             (stats["world_ds"]["seconds"], stats["world_ds"]["report"])),
            ("ds's generate 8 x 128 -> 16 on train's params: ids equal to "
             "one device's, launches", (stats["ids_equal"], counts_ds)),
            ("scheduler_gang_wait_seconds per tenant (count, sum s)",
             stats["gang_wait_s"]),
            ("scheduler_admissions_total by tenant/outcome",
             stats["admissions"]),
            ("the scheduler's reconciles and writes", stats["scheduler"]),
            ("control plane writes and reconciles",
             stats["control_plane"])):
        print(f"phase18 {what}: {value} ({CARD[0]})", flush=True)
    require(all(counts_train.get(k) == 4 * L for k in attn) and
            not counts_train.get("flash_decode") and
            counts_ds.get("flash_attention") == L and
            counts_ds.get("flash_decode") == (16 - 1) * L and
            not counts_ds.get("flash_attention_bwd_dkv"),
            f"phase18: launches train {counts_train}, ds {counts_ds}")
    fleets = {}
    for enable in (False, True):
        fleets[enable] = _notebook_fleet(
            {"h100-1": 60, "h100-8": 30, "h100-16": 10},
            config=ControllerConfig(enable_scheduler=enable))
        f = fleets[enable]
        print(f"phase18 fleet of phase 15 with the scheduler "
              f"{'on' if enable else 'off'}: {f['notebooks']} Notebooks "
              f"SliceReady in {f['seconds']:.2f} s; CR→SliceReady p50 "
              f"{f['ready_p50_ms']:.1f} ms, p95 {f['ready_p95_ms']:.1f} ms "
              f"(host time); {f['writes']} writes, reconciles "
              f"{f['reconciles']}; cache index lookups "
              f"{f['cache_index_lookups']:g}, full scans "
              f"{f['cache_full_scans']:g} ({CARD[0]})", flush=True)
        require(f["pods"] == f["replicas"] == 60 + 30 + 20,
                f"phase18: the fleet's pods: {f}")
    require(not any(k.startswith("fleet-scheduler/")
                    for k in fleets[True]["reconciles"]),
            f"phase18: the scheduler reconciled a fleet with no gang: "
            f"{fleets[True]['reconciles']}")
    stats["fleet"] = {"off": fleets[False], "on": fleets[True]}
    stats["seconds_with_fleets"] = time.monotonic() - t_phase
    print(f"phase18 in {stats['seconds']:.1f} s ("
          f"{stats['seconds_with_fleets']:.1f} s with the two fleets), peak "
          f"{stats['peak_mem_gb']:.3f} GB; launches {launched} ({CARD[0]})",
          flush=True)
    return stats, launched


# --------------------------------------------------------------- phase 19
# the trust source phase 19 seeds: one valid PEM block (base64 of
# "certificate-bytes") and one whose body is not base64; the bundle the
# extension writes into the notebook's namespace holds only the first
_VALID_PEM = ("-----BEGIN CERTIFICATE-----\nY2VydGlmaWNhdGUtYnl0ZXM=\n"
              "-----END CERTIFICATE-----")
_GARBAGE_PEM = ("-----BEGIN CERTIFICATE-----\n!!!not-base64!!!\n"
                "-----END CERTIFICATE-----")


def _ext_sequence(torch, c, tc, B: int, S: int, prompt_len: int,
                  new: int, device: str = "cuda",
                  timeout: float = 180.0) -> tuple[dict, dict]:
    """Phase 19's drive at any size, on ``device`` ("cuda": an NCCL
    world; "cpu": gloo, the tests): ``build_manager(components="all",
    webhooks=False)`` under ``start()``, the simulator gated by a ``_SliceGate`` for
    notebook ``wb``. The controller namespace first gets the cluster's
    trust bundle (a valid PEM block and a garbage one) and a runtime-image
    ImageStream. In order: ``wb`` (h100-1, auth on) is created with the
    reconciliation lock on the CR, as the reference's webhook sets it;
    while the lock stands its StatefulSet stays at 0 replicas and no pod
    exists, and when the extension removes it every prerequisite is
    there (the three finalizers, the auth ServiceAccount, TLS Service
    (targetPort 8443), SAR ConfigMap and ClusterRoleBinding, both
    NetworkPolicies, the HTTPRoute in the controller namespace to the
    TLS Service on port 443, the ReferenceGrant, the workbench bundle
    with the valid block only, ``pipeline-runtime-images``); the core
    scales 0 → 1 and the pod turns Ready once its world passes
    ``verify_slice``. In that world a ``Trainer(mesh=...)`` takes 2
    steps, held bit-equal to a one-device Trainer. Auth is switched off
    on the running notebook: the auth objects go, the CRB finalizer is
    dropped and the route is replaced by one to ``wb``:80, the pod not
    rolled (same uid, replicas never 0). Greedy ``generate`` on
    ``shard_decode_params`` of the trained params is held equal to the
    one-device ``generate``. Last the Trainer is closed, the world ended
    and ``wb`` deleted: its route and the ReferenceGrant go with it, its
    finalizers are stripped and it is gone. Returns (stats, the launches
    of the main path: the 2 steps and the ``generate``, each counted
    from 0)."""
    import torch.distributed as dist

    from kubeflow_tpu_torch import ops
    from kubeflow_tpu_torch.api import types as api
    from kubeflow_tpu_torch.cluster.store import ClusterStore
    from kubeflow_tpu_torch.controllers import (auth, cacert, extension,
                                                routes, runtime_images)
    from kubeflow_tpu_torch.main import build_manager
    from kubeflow_tpu_torch.models.decode import generate
    from kubeflow_tpu_torch.parallel.mesh import (MeshConfig, build_mesh,
                                                  leave_world)
    from kubeflow_tpu_torch.runtime.data import synthetic_lm_batches
    from kubeflow_tpu_torch.runtime.sharded_decode import shard_decode_params
    from kubeflow_tpu_torch.runtime.trainer import Trainer
    from kubeflow_tpu_torch.utils import k8s, names
    from kubeflow_tpu_torch.utils.config import ControllerConfig

    require(not dist.is_initialized(), "phase19: a world is still formed")
    V = c.vocab_size
    ns, name = "ext-ns", "wb"
    store = ClusterStore()
    config = ControllerConfig()
    central = config.controller_namespace
    gate = _SliceGate(name, device)

    def backend(route: dict) -> tuple:
        ref = route["spec"]["rules"][0]["backendRefs"][0]
        return k8s.namespace(route), ref["name"], ref["port"]

    def auth_objects() -> dict:
        return {kind: store.get_or_none(kind, n_s, n) is not None
                for kind, n_s, n in (
                    ("ServiceAccount", ns, auth.sa_name(name)),
                    ("Service", ns, auth.tls_service_name(name)),
                    ("ConfigMap", ns, auth.rbac_config_name(name)),
                    ("ClusterRoleBinding", "", auth.crb_name(ns, name)))}

    def prerequisites(nb: dict) -> dict:
        """What the extension has provisioned for ``nb``, from the
        store."""
        tls = store.get_or_none("Service", ns, auth.tls_service_name(name))
        bundle = store.get_or_none("ConfigMap", ns, cacert.WORKBENCH_BUNDLE)
        images = store.get_or_none("ConfigMap", ns,
                                   runtime_images.CONFIGMAP_NAME)
        return {
            "finalizers": sorted(nb["metadata"].get("finalizers") or []),
            **auth_objects(),
            "tls_target_port": tls and tls["spec"]["ports"][0]["targetPort"],
            "network_policies": sorted(
                k8s.name(p) for p in store.list("NetworkPolicy", ns)),
            "routes": [backend(r)
                       for r in routes.find_routes(store, config, nb)],
            "reference_grant": store.get_or_none(
                "ReferenceGrant", ns, routes.REFERENCE_GRANT_NAME)
            is not None,
            "ca_bundle": bundle and bundle["data"]["ca-bundle.crt"],
            "runtime_images": sorted((images or {}).get("data") or {})}

    seen: dict = {"lock_off": None, "ready": None, "at_unlock": None,
                  "gone": None, "replicas": [], "pods": []}

    def on_notebook(event) -> None:
        if k8s.name(event.obj) != name:
            return
        now = time.monotonic()
        if event.type == "DELETED":
            seen["gone"] = now
            return
        lock = k8s.get_annotation(event.obj, names.STOP_ANNOTATION)
        if seen["lock_off"] is None and \
                lock != names.RECONCILIATION_LOCK_VALUE:
            seen["lock_off"] = now
            seen["at_unlock"] = prerequisites(event.obj)
        if seen["ready"] is None and \
                k8s.condition_true(event.obj, api.CONDITION_SLICE_READY):
            seen["ready"] = now

    def on_sts(event) -> None:
        if event.type != "DELETED" and k8s.name(event.obj) == name:
            n = event.obj["spec"]["replicas"]
            if not seen["replicas"] or seen["replicas"][-1][0] != n:
                seen["replicas"].append((n, time.monotonic()))

    def on_pod(event) -> None:
        if event.type == "ADDED" and \
                k8s.get_label(event.obj, names.NOTEBOOK_NAME_LABEL) == name:
            seen["pods"].append((k8s.uid(event.obj), time.monotonic()))
    # watched before the manager's own watches, so each callback runs
    # before the event reaches a workqueue
    store.watch(api.KIND, on_notebook)
    store.watch("StatefulSet", on_sts)
    store.watch("Pod", on_pod)
    mgr, _ = build_manager(store, config, simulate_kubelet=True,
                           components="all", webhooks=False,
                           ready_hook=gate)
    ext = mgr._reconcilers.get("extension-controller")
    require(ext is not None and "notebook-controller" in mgr._reconcilers,
            f"phase19: build_manager(components='all') registered "
            f"{sorted(mgr._reconcilers)}")
    # the extension's reconciles and writes by kind, recorded on the
    # instance the manager calls
    passes: list = []
    writes: dict = {}
    reconcile = ext.reconcile

    def recorded(req):
        passes.append(time.monotonic())
        return reconcile(req)
    ext.reconcile = recorded
    for verb in ("create", "update", "patch", "delete"):
        def counted(*a, _verb=verb, _fn=getattr(ext.client, verb), **kw):
            kind = a[0]["kind"] if _verb in ("create", "update") else a[0]
            writes[f"{kind}/{_verb}"] = writes.get(f"{kind}/{_verb}", 0) + 1
            return _fn(*a, **kw)
        setattr(ext.client, verb, counted)

    def wait(what: str, cond) -> float:
        def ok():
            require(gate.error is None, f"phase19: the ready hook failed "
                                        f"while waiting for {what}: "
                                        f"{gate.error!r}")
            return cond()
        return _wait_for(what, ok, timeout, phase="phase19")

    def take(got: dict) -> None:
        for k, n in ops.launch_counts().items():
            launched[k] = launched.get(k, 0) + n
            got[k] = got.get(k, 0) + n

    store.create({"apiVersion": "v1", "kind": "ConfigMap",
                  "metadata": {"name": cacert.TRUSTED_CA_BUNDLE,
                               "namespace": central},
                  "data": {"ca-bundle.crt":
                           _VALID_PEM + "\n" + _GARBAGE_PEM}})
    store.create({
        "apiVersion": "image.openshift.io/v1", "kind": "ImageStream",
        "metadata": {"name": "pytorch-runtime", "namespace": central,
                     "labels": {runtime_images.RUNTIME_IMAGE_LABEL: "true"}},
        "spec": {"tags": [{
            "name": "2025a",
            "from": {"kind": "DockerImage",
                     "name": config.tpu_default_image},
            "annotations": {runtime_images.METADATA_ANNOTATION: json.dumps(
                [{"display_name": "PyTorch CUDA", "metadata": {}}])}}]}})
    src = synthetic_lm_batches(B, S, V, seed=0)
    batches = [next(src) for _ in range(2)]
    rng = torch.Generator().manual_seed(7)
    prompt = torch.randint(0, V, (B, prompt_len), generator=rng).to(device)
    stats: dict = {}
    launched: dict = {}
    trainer = None
    mgr.start()
    try:
        # 1. created locked: provisioned, unlocked, rolled, Ready
        t_create = time.monotonic()
        store.create(api.new_notebook(name, ns, annotations={
            names.TPU_ACCELERATOR_ANNOTATION: "h100-1",
            names.INJECT_AUTH_ANNOTATION: "true",
            names.STOP_ANNOTATION: names.RECONCILIATION_LOCK_VALUE}))
        wait("SliceReady on wb", lambda: seen["ready"] is not None)
        unlock = seen["lock_off"]
        stats["ready_ms"] = {"lock_removed": (unlock - t_create) * 1e3,
                             "slice_ready": (seen["ready"] - t_create) * 1e3}
        stats["while_locked"] = {
            "replicas": sorted({n for n, t in seen["replicas"]
                                if t < unlock}),
            "pods": sum(t < unlock for _, t in seen["pods"])}
        stats["at_unlock"] = at_unlock = seen["at_unlock"]
        want = {
            "finalizers": sorted(extension.ALL_FINALIZERS),
            "ServiceAccount": True, "Service": True, "ConfigMap": True,
            "ClusterRoleBinding": True, "tls_target_port": 8443,
            "network_policies": sorted([f"{name}-auth-np",
                                        f"{name}-ctrl-np"]),
            "routes": [(central, auth.tls_service_name(name), 443)],
            "reference_grant": True, "ca_bundle": _VALID_PEM + "\n",
            "runtime_images": ["pytorch-cuda.json"]}
        require(stats["while_locked"] == {"replicas": [0], "pods": 0},
                f"phase19: while locked {stats['while_locked']}, replicas "
                f"{seen['replicas']}")
        require(at_unlock == want,
                f"phase19: at the unlock {at_unlock}, want {want}")
        require([n for n, _ in seen["replicas"]] == [0, 1] and
                len(seen["pods"]) == 1,
                f"phase19: replicas {seen['replicas']}, pods {seen['pods']}")
        world = gate.worlds[-1]
        stats["world"] = world

        # 2. two steps on the card in the notebook's world
        mesh = build_mesh(MeshConfig.auto(world["report"]["device_count"]),
                          device)
        counts_train: dict = {}
        ops.reset_launch_counts()
        trainer = Trainer(c, tc, seed=0, mesh=mesh)
        t0 = time.monotonic()
        trainer.fit(batches, steps=2, log_every=1)
        if device == "cuda":
            torch.cuda.synchronize()
        stats["train_s"] = time.monotonic() - t0
        take(counts_train)
        losses = [x for _, x in trainer.stats.losses]
        params = trainer.params
        one = Trainer(c, tc, seed=0, device=device)
        one.fit(batches, steps=2, log_every=1)
        want_losses = [x for _, x in one.stats.losses]
        one.close()
        del one
        ops.reset_launch_counts()     # the comparison's launches
        gc.collect()
        stats.update({"losses": losses, "launches_train": counts_train})
        require(losses == want_losses and
                all(math.isfinite(x) for x in losses),
                f"phase19: wb's losses {losses} differ from one device's "
                f"{want_losses}")

        # 3. auth off on the running notebook: a plain route, no bounce
        t_off = time.monotonic()
        store.patch(api.KIND, ns, name, {"metadata": {"annotations": {
            names.INJECT_AUTH_ANNOTATION: "false"}}})

        def plain() -> bool:
            nb = store.get(api.KIND, ns, name)
            return not any(auth_objects().values()) and \
                extension.FINALIZER_CRB not in \
                (nb["metadata"].get("finalizers") or []) and \
                [backend(r) for r in routes.find_routes(store, config, nb)] \
                == [(central, name, 80)]
        wait("the plain route", plain)
        stats["auth_off_ms"] = (time.monotonic() - t_off) * 1e3
        after = prerequisites(store.get(api.KIND, ns, name))
        stats["auth_off"] = {
            "routes": after["routes"],
            "network_policies": after["network_policies"],
            "finalizers": after["finalizers"],
            "pod_uids": sorted({u for u, _ in seen["pods"]}),
            "replicas": [n for n, _ in seen["replicas"]]}
        pod = store.list("Pod", ns, {names.NOTEBOOK_NAME_LABEL: name})
        require(len(pod) == 1 and k8s.uid(pod[0]) == seen["pods"][0][0] and
                len(seen["pods"]) == 1 and
                stats["auth_off"]["replicas"] == [0, 1] and
                stats["auth_off"]["network_policies"] == [f"{name}-ctrl-np"],
                f"phase19: after auth off {stats['auth_off']}")

        # 4. generate on the trained params in the same world
        counts_gen: dict = {}
        ops.reset_launch_counts()
        ids = generate(shard_decode_params(params, mesh, c), prompt, c, new)
        if device == "cuda":
            torch.cuda.synchronize()
        take(counts_gen)
        want_ids = generate(params, prompt, c, new)
        ops.reset_launch_counts()     # the comparison's launches
        stats.update({"ids_equal": bool(torch.equal(ids, want_ids)),
                      "launches_generate": counts_gen})
        require(stats["ids_equal"], "phase19: wb's generate differs from "
                                    "one device's")

        # 5. the Trainer closed, the world ended, the notebook deleted
        trainer.close()
        trainer = None
        del params
        leave_world()
        gc.collect()
        t_del = time.monotonic()
        store.delete(api.KIND, ns, name)
        wait("wb gone", lambda: seen["gone"] is not None)
        stats["delete_ms"] = (seen["gone"] - t_del) * 1e3
        stats["after_delete"] = {
            "routes": len(store.list("HTTPRoute", central,
                                     {names.NOTEBOOK_NAME_LABEL: name})),
            "reference_grant": store.get_or_none(
                "ReferenceGrant", ns, routes.REFERENCE_GRANT_NAME)
            is not None,
            **auth_objects(),
            "notebook": store.get_or_none(api.KIND, ns, name) is not None}
        require(not any(stats["after_delete"].values()),
                f"phase19: after the delete {stats['after_delete']}")
    finally:
        if trainer is not None:
            trainer.close()
        mgr.stop()
        for cb in (on_notebook, on_sts, on_pod):
            store.unwatch(cb)
        if dist.is_initialized():
            leave_world()
    stats["extension"] = {"reconciles": len(passes),
                          "writes": dict(sorted(writes.items()))}
    stats["control_plane"] = {"writes": store._last_rv,
                              "reconciles": _reconcile_totals(mgr)}
    return stats, launched


def phase_ext(torch, flagship, sched_losses: list) -> tuple[dict, dict]:
    """19: the extension tier on the card (``_ext_sequence`` at the
    flagship's width: b8 x s1024 with bf16 params, generate 8 x 128 ->
    16; the 2 losses equal to phase 18's steps 1-2), then phase 15's
    fleet on ``components="core"`` and ``"all"``, in turns. Returns
    (stats, the launches of the main path)."""
    from kubeflow_tpu_torch.models import train as train_lib

    t_phase = time.monotonic()
    L = flagship.n_layers
    torch.cuda.reset_peak_memory_stats()
    stats, launched = _ext_sequence(
        torch, flagship, train_lib.TrainConfig(bf16_params=True), 8, 1024,
        128, 16)
    stats["seconds"] = time.monotonic() - t_phase
    stats["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    gc.collect()
    torch.cuda.empty_cache()
    counts_train, counts_gen = stats["launches_train"], \
        stats["launches_generate"]
    for what, value in (
            ("wb CR -> lock removed -> SliceReady ms (host time)",
             stats["ready_ms"]),
            ("while locked: StatefulSet replicas, pods",
             stats["while_locked"]),
            ("provisioned at the unlock", stats["at_unlock"]),
            ("wb's world (seconds, report)",
             (stats["world"]["seconds"], stats["world"]["report"])),
            ("Trainer(mesh=...) b8 s1024 2 steps: losses, bit-equal to one "
             "device's and to phase 18's steps 1-2, seconds",
             (stats["losses"], True, stats["train_s"])),
            ("launches of wb's 2 steps", counts_train),
            ("auth off -> plain route ms (host time)", stats["auth_off_ms"]),
            ("after auth off", stats["auth_off"]),
            ("wb's generate 8 x 128 -> 16 on the trained params: ids equal "
             "to one device's, launches", (stats["ids_equal"], counts_gen)),
            ("delete -> notebook gone ms (host time)", stats["delete_ms"]),
            ("after the delete (left behind)", stats["after_delete"]),
            ("the extension's reconciles and writes by kind",
             stats["extension"]),
            ("control plane writes and reconciles",
             stats["control_plane"])):
        print(f"phase19 {what}: {value} ({CARD[0]})", flush=True)
    require(stats["losses"] == list(sched_losses[:2]),
            f"phase19: losses {stats['losses']} differ from phase 18's "
            f"steps 1-2 {sched_losses[:2]}")
    attn = ("flash_attention", "flash_attention_bwd_dkv",
            "flash_attention_bwd_dq")
    require(all(counts_train.get(k) == 2 * L for k in attn) and
            not counts_train.get("flash_decode") and
            counts_gen.get("flash_attention") == L and
            counts_gen.get("flash_decode") == (16 - 1) * L and
            not counts_gen.get("flash_attention_bwd_dkv"),
            f"phase19: launches train {counts_train}, generate "
            f"{counts_gen}")
    fleets = {}
    for components in ("core", "all"):
        fleets[components] = f = _notebook_fleet(
            {"h100-1": 60, "h100-8": 30, "h100-16": 10},
            components=components)
        ext = sum(n for k, n in f["reconciles"].items()
                  if k.startswith("extension-controller/"))
        print(f"phase19 fleet of phase 15 on components={components!r}: "
              f"{f['notebooks']} Notebooks SliceReady in "
              f"{f['seconds']:.2f} s; CR→SliceReady p50 "
              f"{f['ready_p50_ms']:.1f} ms, p95 {f['ready_p95_ms']:.1f} ms "
              f"(host time); {f['writes']} writes; extension reconciles "
              f"{ext:g}; reconciles {f['reconciles']}; cache index lookups "
              f"{f['cache_index_lookups']:g}, full scans "
              f"{f['cache_full_scans']:g} ({CARD[0]})", flush=True)
        require(f["pods"] == f["replicas"] == 60 + 30 + 20,
                f"phase19: the fleet's pods: {f}")
        require((ext > 0) == (components == "all"),
                f"phase19: extension reconciles {ext} on {components}")
    stats["fleet"] = fleets
    stats["seconds_with_fleets"] = time.monotonic() - t_phase
    print(f"phase19 in {stats['seconds']:.1f} s ("
          f"{stats['seconds_with_fleets']:.1f} s with the two fleets), peak "
          f"{stats['peak_mem_gb']:.3f} GB; launches {launched} ({CARD[0]})",
          flush=True)
    return stats, launched


# --------------------------------------------------------------- phase 20
def _apply_json_patch(doc, ops):
    """RFC 6902 ``add``/``remove``/``replace`` ops applied to a copy of
    ``doc``."""
    import copy
    doc = copy.deepcopy(doc)
    for op in ops:
        parts = [p.replace("~1", "/").replace("~0", "~")
                 for p in op["path"].split("/")[1:]]
        if not parts:
            doc = copy.deepcopy(op["value"])
            continue
        parent = doc
        for p in parts[:-1]:
            parent = parent[p]
        if op["op"] == "remove":
            del parent[parts[-1]]
        else:
            parent[parts[-1]] = copy.deepcopy(op["value"])
    return doc


def _review_over_http(port: int, path: str, body: bytes) -> tuple:
    """POST ``body`` to the AdmissionReview server on 127.0.0.1:``port``;
    (HTTP status, the response's ``response`` or None, host ms)."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=body,
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            out = resp.status, json.loads(resp.read())["response"]
    except urllib.error.HTTPError as exc:
        out = exc.code, None
    return (*out, (time.perf_counter() - t0) * 1e3)


def _admission_server_checks(reviews: int = 20) -> dict:
    """Phase 20's first part: the port's ``AdmissionServer`` on
    127.0.0.1, port 0, plain HTTP, over its webhooks on a store of its
    own. A CREATE review of an h100-1 notebook with a JAX image and auth
    on is answered with a JSONPatch that, applied to the request's
    object, equals the in-process ``handle()`` result (the lock, the CUDA
    image, the original image recorded, the kube-rbac-proxy sidecar with
    its default resources), ``reviews`` times; an h100-3 request is
    denied 403 with the ``GpuRequestError`` message; a body that is not
    JSON gets 400. Returns the host ms of each CREATE review and the
    answers. The server stops in a ``finally``."""
    import base64

    from kubeflow_tpu_torch.api import types as api
    from kubeflow_tpu_torch.cluster.store import ClusterStore
    from kubeflow_tpu_torch.gpu.topology import (GpuRequestError,
                                                 parse_slice_request)
    from kubeflow_tpu_torch.utils import k8s, names
    from kubeflow_tpu_torch.utils.config import (DEFAULT_GPU_IMAGE,
                                                 ControllerConfig)
    from kubeflow_tpu_torch.webhook import (NotebookMutatingWebhook,
                                            NotebookValidatingWebhook)
    from kubeflow_tpu_torch.webhook.server import (MUTATE_PATH,
                                                   VALIDATE_PATH,
                                                   AdmissionServer)

    store, config = ClusterStore(), ControllerConfig()
    mutating = NotebookMutatingWebhook(store, config)
    jax_image = "jupyter/jax-notebook:latest"
    nb = api.new_notebook("wb", "adm-ns", image=jax_image, annotations={
        names.TPU_ACCELERATOR_ANNOTATION: "h100-1",
        names.INJECT_AUTH_ANNOTATION: "true"})
    bad = api.new_notebook("bad", "adm-ns", annotations={
        names.TPU_ACCELERATOR_ANNOTATION: "h100-3"})
    try:
        parse_slice_request(bad["metadata"]["annotations"])
        fail("phase20: h100-3 parsed")
    except GpuRequestError as exc:
        bad_message = f"invalid GPU request: {exc.message}"
    want = mutating.handle("CREATE", k8s.deepcopy(nb), None)

    def review(uid: str, obj: dict) -> bytes:
        return json.dumps({"apiVersion": "admission.k8s.io/v1",
                           "kind": "AdmissionReview",
                           "request": {"uid": uid, "operation": "CREATE",
                                       "object": obj}}).encode()

    srv = AdmissionServer(mutating, NotebookValidatingWebhook(config),
                          host="127.0.0.1", port=0)
    srv.start()
    try:
        ms, patched = [], None
        for i in range(reviews):
            status, resp, t = _review_over_http(srv.port, MUTATE_PATH,
                                                review(f"c{i}", nb))
            ms.append(t)
            require(status == 200 and resp["allowed"] and
                    resp["uid"] == f"c{i}" and
                    resp["patchType"] == "JSONPatch",
                    f"phase20: the CREATE review answered {status} {resp}")
            patched = _apply_json_patch(nb, json.loads(
                base64.b64decode(resp["patch"])))
            require(patched == want, f"phase20: the JSONPatch gives "
                                     f"{patched}, handle() {want}")
        status, denied, _ = _review_over_http(srv.port, VALIDATE_PATH,
                                              review("bad", bad))
        malformed, _, _ = _review_over_http(srv.port, MUTATE_PATH,
                                            b"not json")
    finally:
        srv.stop()
    require(not srv.is_serving(), "phase20: the server still serves")
    sidecar = k8s.find_container(api.notebook_pod_spec(patched),
                                 "kube-rbac-proxy")
    out = {
        "lock": k8s.get_annotation(patched, names.STOP_ANNOTATION),
        "image": api.notebook_container(patched)["image"],
        "original_image": k8s.get_annotation(
            patched, names.TPU_ORIGINAL_IMAGE_ANNOTATION),
        "sidecar_resources": sidecar and sidecar["resources"],
        "denied": (status, denied and denied["allowed"],
                   denied and denied["status"]),
        "not_json": malformed}
    want_out = {
        "lock": names.RECONCILIATION_LOCK_VALUE, "image": DEFAULT_GPU_IMAGE,
        "original_image": jax_image,
        "sidecar_resources": {"requests": {"cpu": "100m", "memory": "64Mi"},
                              "limits": {"cpu": "100m", "memory": "64Mi"}},
        "denied": (200, False, {"code": 403, "message": bad_message}),
        "not_json": 400}
    require(out == want_out, f"phase20: the reviews gave {out}, want "
                             f"{want_out}")
    return {"review_ms": ms, **out}


def _left_behind(store, central: str, ns: str, name: str) -> dict:
    """What a deleted webhook-admitted notebook ``ns/name`` could leave
    behind: its routes in ``central``, its ReferenceGrant, its
    ClusterRoleBinding, its StatefulSet and the notebook itself (all
    falsy when nothing is left)."""
    from kubeflow_tpu_torch.api import types as api
    from kubeflow_tpu_torch.controllers import auth, routes
    from kubeflow_tpu_torch.utils import names
    return {
        "routes": len(store.list("HTTPRoute", central,
                                 {names.NOTEBOOK_NAME_LABEL: name})),
        "reference_grant": store.get_or_none(
            "ReferenceGrant", ns, routes.REFERENCE_GRANT_NAME) is not None,
        "ClusterRoleBinding": store.get_or_none(
            "ClusterRoleBinding", "", auth.crb_name(ns, name)) is not None,
        "StatefulSet": store.get_or_none("StatefulSet", ns, name)
        is not None,
        "notebook": store.get_or_none(api.KIND, ns, name) is not None}


def _admission_sequence(torch, c, tc, B: int, S: int, prompt_len: int,
                        new: int, device: str = "cuda",
                        timeout: float = 180.0) -> tuple[dict, dict]:
    """Phase 20's drive at any size, on ``device`` ("cuda": an NCCL
    world; "cpu": gloo, the tests). First ``_admission_server_checks``.
    Then ``build_manager(components="all")`` (the webhooks in process) under
    ``start()``, the simulator gated by a ``_SliceGate`` for notebook
    ``adm``: ``adm`` (h100-1, a JAX image, auth on, the MLflow
    annotation) is created with no stop annotation; the webhook stores
    it locked, with the CUDA image (the JAX one recorded) and the
    kube-rbac-proxy sidecar, and while the lock stands its StatefulSet
    stays at 0 replicas with no pod; the extension unlocks it, the core
    scales 0 → 1 and the pod turns Ready once its world passes
    ``verify_slice``. In that world a ``Trainer(mesh=...)`` takes 2
    steps and greedy ``generate`` on ``shard_decode_params`` of its
    params is held equal to the one-device ``generate``. Restart gating:
    the cluster's trust bundle appears in the controller namespace, the
    extension projects it into the notebook's namespace, and a user
    update that touches only a label has the webhook's CA mount parked
    in ``update-pending`` (the template's pod spec and the pod untouched,
    the label the template's one change, no new world); one more step
    continues, the 3 losses bit-equal to a
    one-device Trainer's. A resize to h100-2 and the MLflow annotation's
    removal are denied (403) while it runs. Stopped, the parked mount is
    applied (the diff is the one parked) and ``update-pending`` cleared.
    Last the world ends and ``adm`` is deleted, leaving nothing behind.
    Returns (stats, the launches of the main path: the 3 steps and the
    ``generate``, each counted from 0)."""
    import torch.distributed as dist

    from kubeflow_tpu_torch import ops
    from kubeflow_tpu_torch.api import types as api
    from kubeflow_tpu_torch.cluster.store import ClusterStore
    from kubeflow_tpu_torch.controllers import cacert
    from kubeflow_tpu_torch.main import build_manager
    from kubeflow_tpu_torch.models.decode import generate
    from kubeflow_tpu_torch.parallel.mesh import (MeshConfig, build_mesh,
                                                  leave_world)
    from kubeflow_tpu_torch.runtime.data import synthetic_lm_batches
    from kubeflow_tpu_torch.runtime.sharded_decode import shard_decode_params
    from kubeflow_tpu_torch.runtime.trainer import Trainer
    from kubeflow_tpu_torch.utils import k8s, names
    from kubeflow_tpu_torch.utils.config import (DEFAULT_GPU_IMAGE,
                                                 ControllerConfig)
    from kubeflow_tpu_torch.webhook import AdmissionDenied
    from kubeflow_tpu_torch.webhook.diff import first_differences

    require(not dist.is_initialized(), "phase20: a world is still formed")
    stats: dict = {"server": _admission_server_checks()}
    V = c.vocab_size
    ns, name = "adm-ns", "adm"
    jax_image = "jupyter/jax-notebook:latest"
    store = ClusterStore()
    config = ControllerConfig()
    central = config.controller_namespace
    gate = _SliceGate(name, device)
    seen: dict = {"added": None, "lock_off": None, "ready": None,
                  "gone": None, "replicas": [], "pods": []}

    def on_notebook(event) -> None:
        if k8s.name(event.obj) != name:
            return
        now = time.monotonic()
        if event.type == "ADDED":
            seen["added"] = event.obj
        elif event.type == "DELETED":
            seen["gone"] = now
            return
        lock = k8s.get_annotation(event.obj, names.STOP_ANNOTATION)
        if seen["lock_off"] is None and lock is None:
            seen["lock_off"] = now
        if seen["ready"] is None and \
                k8s.condition_true(event.obj, api.CONDITION_SLICE_READY):
            seen["ready"] = now

    def on_sts(event) -> None:
        if event.type != "DELETED" and k8s.name(event.obj) == name:
            n = event.obj["spec"]["replicas"]
            if not seen["replicas"] or seen["replicas"][-1][0] != n:
                seen["replicas"].append((n, time.monotonic()))

    def on_pod(event) -> None:
        if event.type != "MODIFIED" and \
                k8s.get_label(event.obj, names.NOTEBOOK_NAME_LABEL) == name:
            seen["pods"].append((event.type, k8s.uid(event.obj),
                                 time.monotonic()))
    store.watch(api.KIND, on_notebook)
    store.watch("StatefulSet", on_sts)
    store.watch("Pod", on_pod)
    mgr, _ = build_manager(store, config, simulate_kubelet=True,
                           components="all", ready_hook=gate)

    def wait(what: str, cond) -> float:
        def ok():
            require(gate.error is None, f"phase20: the ready hook failed "
                                        f"while waiting for {what}: "
                                        f"{gate.error!r}")
            return cond()
        return _wait_for(what, ok, timeout, phase="phase20")

    def take(got: dict) -> None:
        for k, n in ops.launch_counts().items():
            launched[k] = launched.get(k, 0) + n
            got[k] = got.get(k, 0) + n

    def nb() -> dict:
        return store.get(api.KIND, ns, name)

    def denial(patch: dict) -> tuple:
        try:
            store.patch(api.KIND, ns, name, {"metadata": patch})
        except AdmissionDenied as exc:
            return exc.code, exc.message
        fail(f"phase20: {patch} was admitted on the running notebook")

    src = synthetic_lm_batches(B, S, V, seed=0)
    batches = [next(src) for _ in range(3)]
    rng = torch.Generator().manual_seed(7)
    prompt = torch.randint(0, V, (B, prompt_len), generator=rng).to(device)
    launched: dict = {}
    trainer = None
    mgr.start()
    try:
        # 1. admitted locked by the webhook, unlocked, rolled, Ready
        t_create = time.monotonic()
        store.create(api.new_notebook(name, ns, image=jax_image, annotations={
            names.TPU_ACCELERATOR_ANNOTATION: "h100-1",
            names.INJECT_AUTH_ANNOTATION: "true",
            names.MLFLOW_INSTANCE_ANNOTATION: "mlflow"}))
        wait("SliceReady on adm", lambda: seen["ready"] is not None)
        added, unlock = seen["added"], seen["lock_off"]
        stats["ready_ms"] = {"lock_removed": (unlock - t_create) * 1e3,
                             "slice_ready": (seen["ready"] - t_create) * 1e3}
        stats["admitted"] = {
            "lock": k8s.get_annotation(added, names.STOP_ANNOTATION),
            "image": api.notebook_container(added)["image"],
            "original_image": k8s.get_annotation(
                added, names.TPU_ORIGINAL_IMAGE_ANNOTATION),
            "containers": [x["name"] for x in
                           api.notebook_pod_spec(added)["containers"]]}
        stats["while_locked"] = {
            "replicas": sorted({n for n, t in seen["replicas"]
                                if t < unlock}),
            "pods": sum(t < unlock for _, _, t in seen["pods"])}
        want = {"lock": names.RECONCILIATION_LOCK_VALUE,
                "image": DEFAULT_GPU_IMAGE, "original_image": jax_image,
                "containers": [name, "kube-rbac-proxy"]}
        require(stats["admitted"] == want,
                f"phase20: admitted {stats['admitted']}, want {want}")
        require(stats["while_locked"] == {"replicas": [0], "pods": 0},
                f"phase20: while locked {stats['while_locked']}, replicas "
                f"{seen['replicas']}")
        pods = [u for t, u, _ in seen["pods"] if t == "ADDED"]
        require([n for n, _ in seen["replicas"]] == [0, 1] and
                len(pods) == 1,
                f"phase20: replicas {seen['replicas']}, pods {seen['pods']}")
        world = gate.worlds[-1]
        stats["world"] = world

        # 2. two steps and generate on the card in the notebook's world
        mesh = build_mesh(MeshConfig.auto(world["report"]["device_count"]),
                          device)
        counts_train: dict = {}
        ops.reset_launch_counts()
        trainer = Trainer(c, tc, seed=0, mesh=mesh)
        t0 = time.monotonic()
        trainer.fit(batches[:2], steps=2, log_every=1)
        if device == "cuda":
            torch.cuda.synchronize()
        stats["train_s"] = time.monotonic() - t0
        take(counts_train)
        counts_gen: dict = {}
        ops.reset_launch_counts()
        ids = generate(shard_decode_params(trainer.params, mesh, c), prompt,
                       c, new)
        if device == "cuda":
            torch.cuda.synchronize()
        take(counts_gen)
        want_ids = generate(trainer.params, prompt, c, new)
        ops.reset_launch_counts()     # the comparison's launches
        stats.update({"ids_equal": bool(torch.equal(ids, want_ids)),
                      "launches_generate": counts_gen})
        require(stats["ids_equal"], "phase20: adm's generate differs from "
                                    "one device's")

        # 3. restart gating: the trust bundle's mount is parked
        sts_before = store.get("StatefulSet", ns, name)["spec"]["template"]
        pods_before = list(seen["pods"])
        worlds_before = len(gate.worlds)
        store.create({"apiVersion": "v1", "kind": "ConfigMap",
                      "metadata": {"name": cacert.TRUSTED_CA_BUNDLE,
                                   "namespace": central},
                      "data": {"ca-bundle.crt": _VALID_PEM}})
        wait("the workbench bundle", lambda: store.get_or_none(
            "ConfigMap", ns, cacert.WORKBENCH_BUNDLE) is not None)
        t_touch = time.monotonic()
        store.patch(api.KIND, ns, name,
                    {"metadata": {"labels": {"touch": "1"}}})
        parked = nb()
        stats["parked_ms"] = (time.monotonic() - t_touch) * 1e3
        pending = k8s.get_annotation(parked, names.UPDATE_PENDING_ANNOTATION)
        mounts = [m["name"] for m in api.notebook_container(parked).get(
            "volumeMounts", []) or []]
        stats["parked"] = {"pending": pending and json.loads(pending),
                           "trusted_ca_mounted": "trusted-ca" in mounts}
        require(bool(stats["parked"]["pending"]) and
                not stats["parked"]["trusted_ca_mounted"],
                f"phase20: after the touch {stats['parked']}")

        counts_step: dict = {}
        ops.reset_launch_counts()
        trainer.fit(batches[2:], steps=1, log_every=1)
        if device == "cuda":
            torch.cuda.synchronize()
        take(counts_step)
        for k, n in counts_step.items():
            counts_train[k] = counts_train.get(k, 0) + n
        losses = [x for _, x in trainer.stats.losses]
        one = Trainer(c, tc, seed=0, device=device)
        one.fit(batches, steps=3, log_every=1)
        want_losses = [x for _, x in one.stats.losses]
        one.close()
        del one
        ops.reset_launch_counts()     # the comparison's launches
        gc.collect()
        stats.update({"losses": losses, "launches_train": counts_train})
        require(losses == want_losses and len(losses) == 3 and
                all(math.isfinite(x) for x in losses),
                f"phase20: adm's losses {losses} differ from one device's "
                f"{want_losses}")
        sts_after = store.get("StatefulSet", ns, name)["spec"]["template"]
        stats["untouched"] = {
            "pod_spec_equal": sts_after["spec"] == sts_before["spec"],
            "template_changes": first_differences(sts_before, sts_after),
            "pods_added_or_deleted": seen["pods"] != pods_before,
            "worlds": len(gate.worlds) - worlds_before,
            "world_formed": dist.is_initialized()}
        require(stats["untouched"] == {
            "pod_spec_equal": True,
            "template_changes": ["metadata.labels.touch: <absent> → '1'"],
            "pods_added_or_deleted": False, "worlds": 0,
            "world_formed": True},
                f"phase20: the parked update touched the slice "
                f"{stats['untouched']}")

        # 4. a resize and the MLflow removal denied while running
        stats["denied"] = {
            "resize": denial({"annotations": {
                names.TPU_ACCELERATOR_ANNOTATION: "h100-2"}}),
            "mlflow": denial({"annotations": {
                names.MLFLOW_INSTANCE_ANNOTATION: None}})}
        want = {"resize": (403, "cannot change GPU slice of a running "
                                "notebook (h100-1 → h100-2); stop it "
                                "first"),
                "mlflow": (403, "cannot remove the MLflow annotation from "
                                "a running notebook; stop it first")}
        require(stats["denied"] == want,
                f"phase20: denials {stats['denied']}, want {want}")

        # 5. stopped: the parked mount applied, update-pending cleared
        trainer.close()
        trainer = None
        leave_world()
        gc.collect()
        store.patch(api.KIND, ns, name, {"metadata": {"annotations": {
            names.STOP_ANNOTATION: "2026-01-01T00:00:00Z"}}})
        stopped = nb()
        wait("adm at 0 replicas", lambda: seen["replicas"][-1][0] == 0)
        applied = first_differences(parked["spec"], stopped["spec"],
                                    path="spec")
        mounts = [m["name"] for m in api.notebook_container(stopped).get(
            "volumeMounts", []) or []]
        stats["stopped"] = {
            "pending": k8s.get_annotation(stopped,
                                          names.UPDATE_PENDING_ANNOTATION),
            "trusted_ca_mounted": "trusted-ca" in mounts,
            "applied_is_parked": applied == stats["parked"]["pending"]}
        require(stats["stopped"] == {"pending": None,
                                     "trusted_ca_mounted": True,
                                     "applied_is_parked": True},
                f"phase20: stopped {stats['stopped']}; applied {applied}")

        # 6. deleted at rest: a reconcile still in flight from the stop
        # could read the notebook before the delete and create its
        # StatefulSet again after the cascade (no GC collects an object
        # whose owner is gone)
        _settle(lambda: store._last_rv, "adm's writes", "phase20")
        t_del = time.monotonic()
        store.delete(api.KIND, ns, name)
        wait("adm gone", lambda: seen["gone"] is not None)
        stats["delete_ms"] = (seen["gone"] - t_del) * 1e3
        stats["after_delete"] = _left_behind(store, central, ns, name)
        require(not any(stats["after_delete"].values()),
                f"phase20: after the delete {stats['after_delete']}")
    finally:
        if trainer is not None:
            trainer.close()
        mgr.stop()
        for cb in (on_notebook, on_sts, on_pod):
            store.unwatch(cb)
        if dist.is_initialized():
            leave_world()
    stats["control_plane"] = {"writes": store._last_rv,
                              "reconciles": _reconcile_totals(mgr)}
    return stats, launched


def phase_admission(torch, flagship, ext_losses: list) -> tuple[dict, dict]:
    """20: the admission webhooks on the card (``_admission_sequence`` at
    the flagship's width: b8 x s1024 with bf16 params, generate 8 x 128
    -> 16; the first 2 losses equal to phase 19's). Returns (stats, the
    launches of the main path)."""
    from kubeflow_tpu_torch.models import train as train_lib

    t_phase = time.monotonic()
    L = flagship.n_layers
    torch.cuda.reset_peak_memory_stats()
    stats, launched = _admission_sequence(
        torch, flagship, train_lib.TrainConfig(bf16_params=True), 8, 1024,
        128, 16)
    stats["seconds"] = time.monotonic() - t_phase
    stats["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    gc.collect()
    torch.cuda.empty_cache()
    server = stats["server"]
    ms = sorted(server["review_ms"])
    counts_train, counts_gen = stats["launches_train"], \
        stats["launches_generate"]
    for what, value in (
            (f"AdmissionReview CREATE over HTTP, {len(ms)} reviews: host ms "
             f"min / median / max",
             (ms[0], ms[len(ms) // 2], ms[-1])),
            ("the review's JSONPatch = handle(): lock, image, original, "
             "sidecar resources",
             (server["lock"], server["image"], server["original_image"],
              server["sidecar_resources"])),
            ("h100-3 review (HTTP status, allowed, status); not JSON",
             (server["denied"], server["not_json"])),
            ("adm CR -> lock removed -> SliceReady ms (host time)",
             stats["ready_ms"]),
            ("as stored at the create", stats["admitted"]),
            ("while locked: StatefulSet replicas, pods",
             stats["while_locked"]),
            ("adm's world (seconds, report)",
             (stats["world"]["seconds"], stats["world"]["report"])),
            ("Trainer(mesh=...) b8 s1024 3 steps: losses, bit-equal to one "
             "device's, the first 2 to phase 19's; seconds of steps 1-2",
             (stats["losses"], True, stats["train_s"])),
            ("launches of adm's 3 steps", counts_train),
            ("adm's generate 8 x 128 -> 16: ids equal to one device's, "
             "launches", (stats["ids_equal"], counts_gen)),
            ("label touch on the running slice -> parked ms (host time), "
             "update-pending", (stats["parked_ms"], stats["parked"])),
            ("after the parked update and step 3 (the template's pod spec "
             "equal, its changes, pods added or deleted, new worlds, world "
             "formed)", stats["untouched"]),
            ("denied while running", stats["denied"]),
            ("stopped", stats["stopped"]),
            ("delete -> notebook gone ms (host time)", stats["delete_ms"]),
            ("after the delete (left behind)", stats["after_delete"]),
            ("control plane writes and reconciles",
             stats["control_plane"])):
        print(f"phase20 {what}: {value} ({CARD[0]})", flush=True)
    require(stats["losses"][:2] == list(ext_losses[:2]),
            f"phase20: losses {stats['losses']} differ from phase 19's "
            f"{ext_losses}")
    attn = ("flash_attention", "flash_attention_bwd_dkv",
            "flash_attention_bwd_dq")
    require(all(counts_train.get(k) == 3 * L for k in attn) and
            not counts_train.get("flash_decode") and
            counts_gen.get("flash_attention") == L and
            counts_gen.get("flash_decode") == (16 - 1) * L and
            not counts_gen.get("flash_attention_bwd_dkv"),
            f"phase20: launches train {counts_train}, generate "
            f"{counts_gen}")
    print(f"phase20 in {stats['seconds']:.1f} s, peak "
          f"{stats['peak_mem_gb']:.3f} GB; launches {launched} ({CARD[0]})",
          flush=True)
    return stats, launched


# -------------------------------------------------------------- phase 21
class _OtlpCollector:
    """A local OTLP/HTTP collector: an HTTP server on 127.0.0.1 (a free
    port) that keeps the JSON body of every POST to ``/v1/traces``."""

    def __init__(self):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        bodies: list = []
        self.bodies = bodies

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                body = self.rfile.read(int(self.headers["Content-Length"]))
                if self.path == "/v1/traces":
                    bodies.append(json.loads(body))
                self.send_response(200 if self.path == "/v1/traces"
                                   else 404)
                self.send_header("Content-Length", "2")
                self.end_headers()
                self.wfile.write(b"{}")

            def log_message(self, *args):
                pass

        self._server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self._server.server_address[1]}"
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()

    def spans(self) -> list:
        """Every span of every body received so far."""
        return [span for body in list(self.bodies)
                for rs in body["resourceSpans"]
                for ss in rs["scopeSpans"] for span in ss["spans"]]

    def stop(self) -> None:
        self._server.shutdown()
        self._thread.join(timeout=5)
        self._server.server_close()


def _otlp_attrs(attributes: list) -> dict:
    return {a["key"]: next(iter(a["value"].values())) for a in attributes}


def _trace_sequence(torch, c, tc, B: int, S: int, prompt_len: int,
                    new: int, device: str = "cuda",
                    timeout: float = 180.0) -> tuple[dict, dict]:
    """Phase 21's drive at any size, on ``device`` ("cuda": an NCCL
    world; "cpu": gloo, the tests). Recording on: a local
    ``_OtlpCollector``, ``OtlpHttpExporter(url, flush_interval_s=0.1)``
    behind ``FlightRecorder(inner=exporter, traces_per_key=64)`` in
    ``SDKProvider`` (set as the provider; the ring is wider than the
    default 8 so that reconciles of ``trc`` that start traces of their
    own, more of them on a slower host, cannot push the stamped trace
    out before it is read), a ``JsonFormatter`` handler with the
    ``CorrelationFilter`` on a ``StringIO`` (on the port's loggers, at
    INFO) and a ``HealthServer`` on 127.0.0.1 with the manager's
    registry and the recorder. Then ``build_manager(components="all")``
    (the webhooks in process) under ``start()``, the simulator gated by a
    ``_SliceGate`` for notebook ``trc`` (h100-1, a JAX image): the
    webhook stores it locked with the CUDA image, the notebook
    reconciler stamps it once with the trace-context annotation, the
    extension unlocks it and worker 0 turns Ready once its world passes
    ``verify_slice``. The debug endpoint serves the stamped trace; every
    ``reconcile`` root of ``trc``'s key that a Notebook event delivered
    after the stamp caused is in it, each with a ``workqueue.wait``
    child; its ``trace_phase_breakdown`` sums (wire and apf 0); the
    webhook's root span carries the image-swapped event; once flushed,
    the collector holds every span id the recorder holds for ``trc``;
    a ``workqueue_queue_duration_seconds`` exemplar on ``/metrics``
    carries the stamped trace id; the JSON log lines of ``trc``'s
    reconciles carry its key and a trace id. In its world a
    ``Trainer(mesh=...)`` takes 2 steps (held to a one-device
    Trainer's) and greedy ``generate`` on ``shard_decode_params`` of its
    params is held to the one-device ``generate``. Last ``trc`` is
    deleted and the world ends, leaving nothing behind. In a
    ``finally``: the exporter shut down, the health server and the
    collector stopped, the log handler removed, ``NoopProvider()``
    restored. Returns (stats, the launches of the main path: the 2 steps
    and the ``generate``, each counted from 0)."""
    import io
    import logging

    import torch.distributed as dist

    from kubeflow_tpu_torch import ops
    from kubeflow_tpu_torch.api import types as api
    from kubeflow_tpu_torch.cluster.store import ClusterStore
    from kubeflow_tpu_torch.main import build_manager
    from kubeflow_tpu_torch.models.decode import generate
    from kubeflow_tpu_torch.parallel.mesh import (MeshConfig, build_mesh,
                                                  leave_world)
    from kubeflow_tpu_torch.runtime.data import synthetic_lm_batches
    from kubeflow_tpu_torch.runtime.sharded_decode import shard_decode_params
    from kubeflow_tpu_torch.runtime.trainer import Trainer
    from kubeflow_tpu_torch.utils import k8s, names, tracing
    from kubeflow_tpu_torch.utils import logging as logging_mod
    from kubeflow_tpu_torch.utils.config import (DEFAULT_GPU_IMAGE,
                                                 ControllerConfig)
    from kubeflow_tpu_torch.utils.health import HealthServer

    require(not dist.is_initialized(), "phase21: a world is still formed")
    require(not tracing.is_recording(), "phase21: a provider records")
    V = c.vocab_size
    ns, name = "trc-ns", "trc"
    key = f"{ns}/{name}"
    jax_image = "jupyter/jax-notebook:latest"
    stats: dict = {}
    store = ClusterStore()
    config = ControllerConfig()
    central = config.controller_namespace
    gate = _SliceGate(name, device)
    seen: dict = {"added": None, "ready": None, "gone": None,
                  "stamps": [], "stamped_at": None}

    def on_notebook(event) -> None:
        if k8s.name(event.obj) != name:
            return
        if event.type == "ADDED":
            seen["added"] = event.obj
        elif event.type == "DELETED":
            seen["gone"] = time.monotonic()
            return
        stamp = k8s.get_annotation(event.obj,
                                   names.TRACE_CONTEXT_ANNOTATION)
        seen["stamps"].append(stamp)
        if stamp is not None and seen["stamped_at"] is None:
            seen["stamped_at"] = time.time()
        if seen["ready"] is None and \
                k8s.condition_true(event.obj, api.CONDITION_SLICE_READY):
            seen["ready"] = time.monotonic()
    store.watch(api.KIND, on_notebook)

    collector = _OtlpCollector()
    exporter = tracing.OtlpHttpExporter(collector.url, flush_interval_s=0.1)
    # the default ring of 8 traces a key can lose the stamped trace to
    # the unstamped reconciles that follow it (pod and StatefulSet events)
    recorder = tracing.FlightRecorder(inner=exporter, traces_per_key=64)
    logs = io.StringIO()
    handler = logging.StreamHandler(logs)
    handler.addFilter(logging_mod.CorrelationFilter())
    handler.setFormatter(logging_mod.JsonFormatter())
    port_log = logging.getLogger("kubeflow_tpu_torch")
    level = port_log.level
    port_log.addHandler(handler)
    port_log.setLevel(logging.INFO)
    health = None
    mgr = None
    trainer = None
    launched: dict = {}
    try:
        tracing.set_provider(tracing.SDKProvider(recorder))
        mgr, _ = build_manager(store, config, simulate_kubelet=True,
                               components="all", ready_hook=gate)
        health = HealthServer(metrics_registry=mgr.metrics,
                              host="127.0.0.1", port=0,
                              flight_recorder=recorder)
        health.start()
        base = f"http://127.0.0.1:{health.port}"

        def wait(what: str, cond) -> float:
            def ok():
                require(gate.error is None,
                        f"phase21: the ready hook failed while waiting for "
                        f"{what}: {gate.error!r}")
                return cond()
            return _wait_for(what, ok, timeout, phase="phase21")

        def get(path: str) -> tuple[int, str]:
            with urllib.request.urlopen(base + path, timeout=10) as resp:
                return resp.status, resp.read().decode()

        def take(got: dict) -> None:
            for k, n in ops.launch_counts().items():
                launched[k] = launched.get(k, 0) + n
                got[k] = got.get(k, 0) + n

        src = synthetic_lm_batches(B, S, V, seed=0)
        batches = [next(src) for _ in range(2)]
        rng = torch.Generator().manual_seed(7)
        prompt = torch.randint(0, V, (B, prompt_len),
                               generator=rng).to(device)
        mgr.start()

        # 1. admitted, stamped, unlocked, rolled, Ready: one trace
        t_create = time.monotonic()
        store.create(api.new_notebook(name, ns, image=jax_image,
                                      annotations={
            names.TPU_ACCELERATOR_ANNOTATION: "h100-1"}))
        wait("SliceReady on trc", lambda: seen["ready"] is not None)
        stats["ready_ms"] = (seen["ready"] - t_create) * 1e3
        added = seen["added"]
        stats["admitted"] = {
            "lock": k8s.get_annotation(added, names.STOP_ANNOTATION),
            "image": api.notebook_container(added)["image"]}
        require(stats["admitted"] == {
            "lock": names.RECONCILIATION_LOCK_VALUE,
            "image": DEFAULT_GPU_IMAGE},
                f"phase21: admitted {stats['admitted']}")
        header = k8s.get_annotation(store.get(api.KIND, ns, name),
                                    names.TRACE_CONTEXT_ANNOTATION)
        stamped = tracing.parse_traceparent(header)
        require(stamped is not None,
                f"phase21: trc's trace-context annotation {header!r}")
        trace_id = f"{stamped.trace_id:032x}"
        first = seen["stamps"].index(header)
        stats["stamp"] = {
            "values": sorted({s for s in seen["stamps"] if s is not None}),
            "events_before": first,
            "events_after": len(seen["stamps"]) - first,
            "rewritten": any(s != header for s in seen["stamps"][first:])}
        require(stats["stamp"]["values"] == [header] and
                not stats["stamp"]["rewritten"],
                f"phase21: trc's stamps {seen['stamps']}")
        world = gate.worlds[-1]
        stats["world"] = world

        # 2. the debug endpoint: the stamped trace and its roots
        status, body = get(f"/debug/notebooks/{ns}/{name}/trace")
        require(status == 200, f"phase21: the debug endpoint gave {status}")
        traces = json.loads(body)["traces"]
        spans = [s for t in traces for s in t["spans"]]
        by_parent: dict = {}
        for s in spans:
            by_parent.setdefault(s["parent_id"], []).append(s)
        roots = [s for s in spans if s["name"] == "reconcile" and
                 s["attributes"].get(tracing.KEY_ATTRIBUTE) == key]
        joined, controllers = [], set()
        for root in roots:
            kids = by_parent.get(root["span_id"], [])
            enq = [k for k in kids if k["name"] == "workqueue.enqueue"]
            if enq and enq[0]["attributes"].get("k8s.kind") == api.KIND \
                    and enq[0]["start"] >= seen["stamped_at"]:
                joined.append((root, kids))
                controllers.add(root["attributes"]["controller"])
        stamped_trace = [t for t in traces if t["trace_id"] == trace_id]
        stats["trace"] = {
            "held": len(traces), "roots": len(roots),
            "joined_roots": len(joined),
            "joined_in_stamped": sum(r["trace_id"] == trace_id
                                     for r, _ in joined),
            "joined_with_wait": sum(any(k["name"] == "workqueue.wait"
                                        for k in kids)
                                    for _, kids in joined),
            "controllers": sorted(controllers),
            "stamped_spans": (len(stamped_trace[0]["spans"])
                              if stamped_trace else 0)}
        t = stats["trace"]
        require(stamped_trace and t["joined_roots"] >= 1 and
                t["joined_in_stamped"] == t["joined_roots"] ==
                t["joined_with_wait"],
                f"phase21: trc's trace on the debug endpoint {t}")
        # the breakdown's identity holds where the legs do not overlap:
        # over each reconcile root with its children (one worker ran it
        # serially); the whole stitched trace's roots ran on 4 workers,
        # so its queue legs may overlap (printed, not held)
        breakdowns = []
        for root in [s for s in stamped_trace[0]["spans"]
                     if s["name"] == "reconcile"]:
            b = tracing.trace_phase_breakdown(
                [root] + by_parent.get(root["span_id"], []))
            breakdowns.append(b)
            require(abs(b["queue"] + b["wire"] + b["reconcile"] -
                        b["wall"]) <= 1e-9 and
                    b["wire"] == 0 and b["apf"] == 0,
                    f"phase21: the breakdown of a {root['attributes']} "
                    f"root of the stamped trace {b}")
        stats["breakdown"] = {
            "roots": len(breakdowns),
            "sum": {k: sum(b[k] for b in breakdowns)
                    for k in ("wall", "queue", "wire", "apf", "reconcile")},
            "trace": tracing.trace_phase_breakdown(
                stamped_trace[0]["spans"])}

        # the collector: every span the recorder holds for trc, and the
        # webhook's root span with its image-swapped event
        held = {s["span_id"] for t in recorder.trace_for(ns, name)
                for s in t["spans"]}
        exporter.force_flush()
        _wait_for("the collector to hold trc's spans",
                  lambda: held <= {s["spanId"] for s in collector.spans()},
                  timeout, phase="phase21")
        hooks = [s for s in collector.spans()
                 if s["name"] == "notebook-mutating-webhook" and
                 _otlp_attrs(s["attributes"]).get("notebook.name") == name]
        stats["exported"] = {
            "posts": len(collector.bodies),
            "spans": len(collector.spans()), "trc_spans_held": len(held),
            "webhook_spans": len(hooks),
            "image_swapped": sum(any(e["name"] == "image-swapped"
                                     for e in s["events"]) for s in hooks),
            "failed": exporter.failed_total}
        require(stats["exported"]["image_swapped"] >= 1 and
                stats["exported"]["failed"] == 0,
                f"phase21: exported {stats['exported']}")

        # a queue-duration exemplar on /metrics carries the stamped id
        status, text = get("/metrics")
        exemplars = [ln for ln in text.splitlines()
                     if ln.startswith("workqueue_queue_duration_seconds_"
                                      "bucket{") and
                     f'trace_id="{trace_id}"' in ln]
        stats["exemplars"] = len(exemplars)
        require(status == 200 and exemplars,
                f"phase21: no queue-duration exemplar of {trace_id} on "
                f"/metrics ({status})")

        # the JSON log lines of trc's reconciles
        lines = [json.loads(ln) for ln in logs.getvalue().splitlines()]
        mine = [ln for ln in lines if ln.get("reconcile_key") == key]
        stats["logs"] = {"lines": len(lines), "trc": len(mine),
                         "trc_with_trace_id": sum("trace_id" in ln
                                                  for ln in mine)}
        require(mine and stats["logs"]["trc_with_trace_id"] == len(mine),
                f"phase21: trc's log lines {stats['logs']}: {mine[:3]}")

        # 3. two steps and generate on the card in the notebook's world
        mesh = build_mesh(MeshConfig.auto(world["report"]["device_count"]),
                          device)
        counts_train: dict = {}
        ops.reset_launch_counts()
        trainer = Trainer(c, tc, seed=0, mesh=mesh)
        t0 = time.monotonic()
        trainer.fit(batches, steps=2, log_every=1)
        if device == "cuda":
            torch.cuda.synchronize()
        stats["train_s"] = time.monotonic() - t0
        take(counts_train)
        counts_gen: dict = {}
        ops.reset_launch_counts()
        ids = generate(shard_decode_params(trainer.params, mesh, c), prompt,
                       c, new)
        if device == "cuda":
            torch.cuda.synchronize()
        take(counts_gen)
        want_ids = generate(trainer.params, prompt, c, new)
        losses = [x for _, x in trainer.stats.losses]
        trainer.close()
        trainer = None
        one = Trainer(c, tc, seed=0, device=device)
        one.fit(batches, steps=2, log_every=1)
        want_losses = [x for _, x in one.stats.losses]
        one.close()
        del one
        ops.reset_launch_counts()     # the comparisons' launches
        gc.collect()
        stats.update({"losses": losses, "launches_train": counts_train,
                      "ids_equal": bool(torch.equal(ids, want_ids)),
                      "launches_generate": counts_gen})
        require(stats["ids_equal"], "phase21: trc's generate differs from "
                                    "one device's")
        require(losses == want_losses and len(losses) == 2 and
                all(math.isfinite(x) for x in losses),
                f"phase21: trc's losses {losses} differ from one device's "
                f"{want_losses}")

        # 4. deleted: nothing of it left
        leave_world()
        t_del = time.monotonic()
        store.delete(api.KIND, ns, name)
        wait("trc gone", lambda: seen["gone"] is not None)
        stats["delete_ms"] = (seen["gone"] - t_del) * 1e3
        stats["after_delete"] = dict(
            _left_behind(store, central, ns, name),
            pods=len(store.list("Pod", ns)))
        require(not any(stats["after_delete"].values()),
                f"phase21: after the delete {stats['after_delete']}")
    finally:
        if trainer is not None:
            trainer.close()
        if mgr is not None:
            mgr.stop()
        store.unwatch(on_notebook)
        if dist.is_initialized():
            leave_world()
        tracing.set_provider(tracing.NoopProvider())
        exporter.shutdown()
        if health is not None:
            health.stop()
        collector.stop()
        port_log.removeHandler(handler)
        port_log.setLevel(level)
    stats["control_plane"] = {"writes": store._last_rv,
                              "reconciles": _reconcile_totals(mgr)}
    return stats, launched


def _traced_fleets(n_by_shape: dict, runs: int = 4) -> list:
    """Phase 15's fleet (``_notebook_fleet``, ``components="core"``)
    ``runs`` times in turns: untraced (the no-op provider), then recorded
    (``SDKProvider(FlightRecorder(inner=InMemorySpanExporter()))``), and
    again.
    Each run: its stats and CPU seconds, and for a recorded one the spans
    recorded, the traces the recorder holds and the notebooks with a
    trace. The no-op provider is restored in a ``finally``."""
    from kubeflow_tpu_torch.utils import tracing

    out = []
    for i in range(runs):
        recorded = i % 2 == 1
        every = tracing.InMemorySpanExporter()
        recorder = tracing.FlightRecorder(inner=every)
        cpu0 = time.process_time()
        try:
            if recorded:
                tracing.set_provider(tracing.SDKProvider(recorder))
            fleet = _notebook_fleet(n_by_shape)
        finally:
            tracing.set_provider(tracing.NoopProvider())
        fleet["cpu_s"] = time.process_time() - cpu0
        fleet["recorded"] = recorded
        fleet["spans"] = len(every.spans)
        fleet["traces_held"] = len(recorder._traces)
        fleet["notebooks_traced"] = sum(k.split("/")[1].startswith("nb-")
                                        for k in recorder.keys())
        require(fleet["traces_held"] <= recorder.max_traces,
                f"phase21: the recorder holds {fleet['traces_held']} "
                f"traces, above its bound {recorder.max_traces}")
        out.append(fleet)
    return out


def phase_tracing(torch, flagship, adm_losses: list) -> tuple[dict, dict]:
    """21: the tracing tier on the card (``_trace_sequence`` at the
    flagship's width: b8 x s1024 with bf16 params, generate 8 x 128 ->
    16; the 2 losses equal to phase 20's first two), then phase 15's
    fleet twice in turns, untraced and recorded (``_traced_fleets``).
    Returns (stats, the launches of the main path)."""
    from kubeflow_tpu_torch.models import train as train_lib

    t_phase = time.monotonic()
    L = flagship.n_layers
    torch.cuda.reset_peak_memory_stats()
    stats, launched = _trace_sequence(
        torch, flagship, train_lib.TrainConfig(bf16_params=True), 8, 1024,
        128, 16)
    stats["seconds"] = time.monotonic() - t_phase
    stats["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    gc.collect()
    torch.cuda.empty_cache()
    counts_train, counts_gen = stats["launches_train"], \
        stats["launches_generate"]
    for what, value in (
            ("trc CR -> SliceReady ms (host time), recording on",
             stats["ready_ms"]),
            ("as stored at the create", stats["admitted"]),
            ("the trace-context stamp (one value, never rewritten; Notebook "
             "events before and after it)", stats["stamp"]),
            ("trc's world (seconds, report)",
             (stats["world"]["seconds"], stats["world"]["report"])),
            ("the debug endpoint: traces held, reconcile roots, roots a "
             "Notebook event caused after the stamp (in the stamped trace, "
             "with a workqueue.wait child), their controllers, spans of the "
             "stamped trace", stats["trace"]),
            ("the stamped trace's breakdown, s: its reconcile roots, each "
             "root's (queue + wire + reconcile = wall) summed over them, "
             "and the whole trace's (roots overlap)", stats["breakdown"]),
            ("exported to the local collector", stats["exported"]),
            ("queue-duration exemplars with the stamped trace id",
             stats["exemplars"]),
            ("JSON log lines (all, trc's, trc's with a trace_id)",
             stats["logs"]),
            ("Trainer(mesh=...) b8 s1024 2 steps: losses, bit-equal to one "
             "device's and to phase 20's steps 1-2; seconds",
             (stats["losses"], True, stats["train_s"])),
            ("launches of trc's 2 steps", counts_train),
            ("trc's generate 8 x 128 -> 16: ids equal to one device's, "
             "launches", (stats["ids_equal"], counts_gen)),
            ("delete -> notebook gone ms (host time)", stats["delete_ms"]),
            ("after the delete (left behind)", stats["after_delete"]),
            ("control plane writes and reconciles",
             stats["control_plane"])):
        print(f"phase21 {what}: {value} ({CARD[0]})", flush=True)
    require(stats["losses"] == list(adm_losses[:2]),
            f"phase21: losses {stats['losses']} differ from phase 20's "
            f"{adm_losses}")
    attn = ("flash_attention", "flash_attention_bwd_dkv",
            "flash_attention_bwd_dq")
    require(all(counts_train.get(k) == 2 * L for k in attn) and
            not counts_train.get("flash_decode") and
            counts_gen.get("flash_attention") == L and
            counts_gen.get("flash_decode") == (16 - 1) * L and
            not counts_gen.get("flash_attention_bwd_dkv"),
            f"phase21: launches train {counts_train}, generate "
            f"{counts_gen}")
    t0 = time.monotonic()
    stats["fleets"] = _traced_fleets({"h100-1": 60, "h100-8": 30,
                                      "h100-16": 10}, runs=2)
    for i, f in enumerate(stats["fleets"]):
        how = "recorded" if f["recorded"] else "untraced"
        print(f"phase21 fleet run {i + 1} ({how}): "
              f"100 Notebooks SliceReady in {f['seconds']} s, CPU "
              f"{f['cpu_s']} s; CR→SliceReady p50 {f['ready_p50_ms']} ms, "
              f"p95 {f['ready_p95_ms']} ms (host time); {f['writes']} "
              f"writes; spans {f['spans']}, traces held "
              f"{f['traces_held']}, notebooks with a trace "
              f"{f['notebooks_traced']} ({CARD[0]})", flush=True)
    print(f"phase21 in {stats['seconds']:.1f} s "
          f"({stats['seconds'] + time.monotonic() - t0:.1f} s with the "
          f"fleets), peak {stats['peak_mem_gb']:.3f} GB; launches "
          f"{launched} ({CARD[0]})", flush=True)
    return stats, launched


# --------------------------------------------------------------- phase 22
def _http(base: str, method: str, path: str, body=None,
          headers: dict | None = None, timeout: float = 30.0) -> tuple:
    """One request through ``http.client``: (status, headers, body bytes).
    A dict ``body`` is sent as JSON."""
    import http.client
    from urllib.parse import urlparse
    u = urlparse(base)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=timeout)
    try:
        hdrs = dict(headers or {})
        if isinstance(body, dict):
            body = json.dumps(body).encode()
            hdrs.setdefault("Content-Type", "application/json")
        conn.request(method, path, body=body, headers=hdrs)
        resp = conn.getresponse()
        return resp.status, dict(resp.headers), resp.read()
    finally:
        conn.close()


class _WatchStream:
    """One ``?watch=true`` stream of the apiserver, read on a thread
    through ``http.client``: NDJSON, or with ``binary`` the codec's
    length-prefixed frames (``Accept:`` the binary media type), decoded
    with the port's codec. ``frames`` holds (type, rv, object, wire
    bytes) in order, BOOKMARKs included; ``status`` the response's
    status (the body of a refused one in ``body``)."""

    def __init__(self, base: str, path: str, binary: bool = False):
        import http.client
        import struct
        from urllib.parse import urlparse

        from kubeflow_tpu_torch.cluster import codec
        u = urlparse(base)
        self.binary = binary
        self.frames: list = []
        self.error = None
        self.lock = threading.Lock()
        self.conn = http.client.HTTPConnection(u.hostname, u.port,
                                               timeout=60)
        accept = codec.BINARY_CONTENT_TYPE if binary else "application/json"
        self.conn.request("GET", path, headers={"Accept": accept})
        # the response takes the socket over (Connection: close)
        self.sock = self.conn.sock
        self.resp = self.conn.getresponse()
        self.status = self.resp.status
        self.body = None
        self.thread = None
        if self.status != 200:
            self.body = self.resp.read()
            self.conn.close()
            return

        def read() -> None:
            try:
                while True:
                    if binary:
                        head = self.resp.read(4)
                        if len(head) < 4:
                            return
                        (n,) = struct.unpack(">I", head)
                        payload = self.resp.read(n)
                        if len(payload) < n:
                            return
                        etype, obj = codec.parse_event(payload)
                        size = 4 + n
                    else:
                        line = self.resp.readline()
                        if not line:
                            return
                        frame = json.loads(line)
                        etype, obj = frame["type"], frame["object"]
                        size = len(line)
                    rv = int(obj["metadata"]["resourceVersion"])
                    with self.lock:
                        self.frames.append((etype, rv, obj, size))
            except (OSError, ValueError) as exc:
                self.error = exc

        self.thread = threading.Thread(target=read, daemon=True)
        self.thread.start()

    def events(self) -> list:
        """The frames so far, BOOKMARKs left out."""
        with self.lock:
            return [f for f in self.frames if f[0] != "BOOKMARK"]

    def close(self) -> None:
        import socket
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        if self.thread is not None:
            self.thread.join(timeout=10)
        self.resp.close()
        self.conn.close()


class _JupyterStandIn:
    """The Jupyter server behind a notebook's Service for the culler's
    dev-mode probes through the apiserver's service proxy:
    ``/notebook/{ns}/{name}/api/kernels`` answers one idle kernel whose
    ``last_activity`` is ``kernel_age_s`` old, ``.../api/terminals``
    answers ``[]``. ``hits`` counts the 200s; any other path gets a 404,
    kept in ``refused``."""

    PATH = re.compile(r"^/notebook/([^/]+)/([^/]+)/api/(kernels|terminals)$")

    def __init__(self, kernel_age_s: float = 86400.0):
        import datetime
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        stand_in = self
        self.hits = 0
        self.refused: list = []
        self.lock = threading.Lock()

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_GET(self):
                m = stand_in.PATH.match(self.path)
                if m is None:
                    stand_in.refused.append(self.path)
                    body, code = b'{"error": "no such path"}', 404
                else:
                    age = datetime.datetime.fromtimestamp(
                        time.time() - kernel_age_s, datetime.timezone.utc)
                    body = json.dumps([] if m[3] == "terminals" else [{
                        "id": "k0", "name": "python3",
                        "execution_state": "idle", "connections": 0,
                        "last_activity": age.strftime(
                            "%Y-%m-%dT%H:%M:%S.%fZ")}]).encode()
                    code = 200
                    with stand_in.lock:
                        stand_in.hits += 1
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.httpd.daemon_threads = True
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=5)


class _Endpoints:
    """The in-process cluster's Service endpoints as the apiserver serves
    them: wraps the store for ``ApiServerProxy`` (every call goes to the
    store) so that a GET of a Service named in ``backends`` ((ns, name)
    → {annotation key: base URL}) carries those proxy-backend
    annotations. They are not stored: the notebook reconciler copies its
    Service's annotations from its desired Service, which names none, so
    a stored one is dropped at its next reconcile, and one put back on
    every write makes the two fight for ever (a Service write a
    reconcile)."""

    def __init__(self, store, backends: dict):
        self._store = store
        self._backends = backends

    def get(self, kind: str, namespace: str, name: str) -> dict:
        from kubeflow_tpu_torch.utils import k8s
        obj = self._store.get(kind, namespace, name)
        if kind == "Service":
            for key, url in self._backends.get((namespace, name),
                                               {}).items():
                k8s.set_annotation(obj, key, url)
        return obj

    def __getattr__(self, name: str):
        return getattr(self._store, name)


def _wire_sequence(torch, c, tc, B: int, S: int, prompt_len: int,
                   new: int, device: str = "cuda",
                   timeout: float = 180.0) -> tuple[dict, dict]:
    """Phase 22's drive at any size, on ``device`` ("cuda": an NCCL
    world; "cpu": gloo, the tests). The port's ``ClusterStore()`` (8
    shards) behind its ``ApiServerProxy`` on 127.0.0.1 (APF on, metrics
    attached), and beside it ``build_manager(components="all")`` (the
    webhooks in process) on the same store under ``start()``, the simulator
    gated by a ``_SliceGate`` for notebook ``wir``, the idle culler in
    dev mode probing through the apiserver (``dev_proxy_url``) on a
    clock the phase advances. Over HTTP: a LIST of Notebooks gives the
    anchor rv; two watches from it with bookmarks, one JSON, one binary;
    ``wir`` (h100-1, a JAX image) is POSTed and answered 201 locked with
    the CUDA image; worker 0 turns Ready once its world passes
    ``verify_slice``; both streams carry the same (type, rv) sequence up
    to SliceReady, each binary frame decoding to its JSON twin's object.
    The JSON stream is closed, ``wir``'s labels patched, and the stream
    reopened from the last rv it read: it replays exactly the frames it
    missed, in order. A second apiserver over a store with an 8-frame
    ring answers 410 with a Status body to a resume from before its
    window and from an rv it never issued. In ``wir``'s world a
    ``Trainer(mesh=...)`` takes 2 steps (held to one device's) and
    greedy ``generate`` on ``shard_decode_params`` is held to the
    one-device ``generate``. Then ``_cull_sequence`` on ``wir`` (served
    by a ``ServingServer`` over a continuous engine of the trained
    params) and ``wir-big`` (h100-16), every probe through the
    apiserver's service proxy to a Jupyter stand-in or the serving
    server (``_Endpoints`` serves their Services with the backends),
    each answered 200. Last both notebooks are deleted over
    HTTP and nothing of ``wir`` is left. Every server stops in a
    ``finally``. Returns (stats, the launches of the main path: the 2
    steps, the ``generate`` and the served requests, each counted from
    0)."""
    import torch.distributed as dist

    from kubeflow_tpu_torch import ops
    from kubeflow_tpu_torch.api import types as api
    from kubeflow_tpu_torch.cluster.apiserver import ApiServerProxy
    from kubeflow_tpu_torch.cluster.store import ClusterStore
    from kubeflow_tpu_torch.controllers import CullingReconciler
    from kubeflow_tpu_torch.main import build_manager
    from kubeflow_tpu_torch.models.decode import generate
    from kubeflow_tpu_torch.parallel.mesh import (MeshConfig, build_mesh,
                                                  leave_world)
    from kubeflow_tpu_torch.runtime.data import synthetic_lm_batches
    from kubeflow_tpu_torch.runtime.server import ServingServer
    from kubeflow_tpu_torch.runtime.serving import ContinuousBatchedGenerator
    from kubeflow_tpu_torch.runtime.sharded_decode import shard_decode_params
    from kubeflow_tpu_torch.runtime.trainer import Trainer
    from kubeflow_tpu_torch.utils import k8s, names
    from kubeflow_tpu_torch.utils.config import (DEFAULT_GPU_IMAGE,
                                                 ControllerConfig)
    from kubeflow_tpu_torch.utils.metrics import MetricsRegistry

    require(not dist.is_initialized(), "phase22: a world is still formed")
    V, L = c.vocab_size, c.n_layers
    ns, name, big = "wir-ns", "wir", "wir-big"
    jax_image = "jupyter/jax-notebook:latest"
    coll = f"/apis/kubeflow.org/v1/namespaces/{ns}/notebooks"
    stats: dict = {}
    launched: dict = {}
    store = ClusterStore()
    registry = MetricsRegistry()
    backends: dict = {}
    proxy = ApiServerProxy(_Endpoints(store, backends))
    proxy.attach_metrics(registry)
    proxy.start()
    small = jupyter = mgr = trainer = server = None
    gate = _SliceGate(name, device)
    streams: list = []

    def wait(what: str, cond, limit: float = timeout) -> float:
        def ok():
            require(gate.error is None,
                    f"phase22: the ready hook failed while waiting for "
                    f"{what}: {gate.error!r}")
            return cond()
        return _wait_for(what, ok, limit, phase="phase22")

    def watch(rv: int, binary: bool) -> "_WatchStream":
        s = _WatchStream(proxy.url, f"{coll}?watch=true&resourceVersion="
                         f"{rv}&allowWatchBookmarks=true", binary=binary)
        require(s.status == 200, f"phase22: a watch from {rv} answered "
                                 f"{s.status} {s.body!r}")
        streams.append(s)
        return s

    def ready_rv(s: "_WatchStream"):
        return next((rv for t, rv, obj, _ in s.events() if k8s.condition_true(
            obj, api.CONDITION_SLICE_READY)), None)

    try:
        jupyter = _JupyterStandIn()
        config = ControllerConfig(dev_mode=True, dev_proxy_url=proxy.url,
                                  cull_idle_time_min=60,
                                  idleness_check_period_min=1)
        central = config.controller_namespace
        mgr, _ = build_manager(store, config, simulate_kubelet=True,
                               components="all", ready_hook=gate)
        offset = [0.0]
        CullingReconciler(mgr.client, config, mgr.metrics,
                          clock=lambda: time.time() + offset[0]).setup(mgr)
        src = synthetic_lm_batches(B, S, V, seed=0)
        batches = [next(src) for _ in range(2)]
        rng = torch.Generator().manual_seed(7)
        prompt = torch.randint(0, V, (B, prompt_len),
                               generator=rng).to(device)
        mgr.start()

        # 1. watched from the start, created over the wire
        status, _, body = _http(proxy.url, "GET", coll)
        require(status == 200, f"phase22: LIST answered {status}")
        anchor = int(json.loads(body)["metadata"]["resourceVersion"])
        js, bs = watch(anchor, False), watch(anchor, True)
        t_create = time.monotonic()
        status, _, body = _http(proxy.url, "POST", coll, api.new_notebook(
            name, ns, image=jax_image, annotations={
                names.TPU_ACCELERATOR_ANNOTATION: "h100-1"}))
        require(status == 201, f"phase22: POST answered {status} {body!r}")
        created = json.loads(body)
        stats["admitted"] = {
            "lock": k8s.get_annotation(created, names.STOP_ANNOTATION),
            "image": api.notebook_container(created)["image"]}
        require(stats["admitted"] == {
            "lock": names.RECONCILIATION_LOCK_VALUE,
            "image": DEFAULT_GPU_IMAGE},
                f"phase22: admitted {stats['admitted']}")
        wait("SliceReady on wir's JSON stream",
             lambda: ready_rv(js) is not None)
        stats["ready_ms"] = (time.monotonic() - t_create) * 1e3
        r_rv = ready_rv(js)
        wait("SliceReady on wir's binary stream",
             lambda: ready_rv(bs) is not None)
        upto = {k: [f for f in s.events() if f[1] <= r_rv]
                for k, s in (("json", js), ("binary", bs))}
        stats["streams"] = {
            k: {"events": len(v),
                "bytes_per_event": sum(f[3] for f in v) / len(v)}
            for k, v in upto.items()}
        require([f[:2] for f in upto["json"]] ==
                [f[:2] for f in upto["binary"]] and upto["json"] and
                all(a[2] == b[2] for a, b in zip(upto["json"],
                                                 upto["binary"])),
                f"phase22: the JSON and binary streams differ up to "
                f"SliceReady: {[f[:2] for f in upto['json']]} vs "
                f"{[f[:2] for f in upto['binary']]}")
        stats["world"] = gate.worlds[-1]

        # 2. resumed, not relisted
        last = max(f[1] for f in js.events())
        js.close()
        status, _, body = _http(
            proxy.url, "PATCH", f"{coll}/{name}",
            {"metadata": {"labels": {"wire": "resumed"}}},
            headers={"Content-Type": "application/merge-patch+json"})
        require(status == 200, f"phase22: PATCH answered {status}")
        patched_rv = int(json.loads(body)["metadata"]["resourceVersion"])
        wait("the patch on the binary stream",
             lambda: any(f[1] == patched_rv for f in bs.events()))
        quiet = [len(bs.frames), time.monotonic()]

        def settled() -> bool:
            if len(bs.frames) != quiet[0]:
                quiet[:] = [len(bs.frames), time.monotonic()]
            return time.monotonic() - quiet[1] > 0.5
        wait("the reconcilers to answer the patch", settled)
        again = watch(last, False)
        wait("the resumed stream's connect bookmark",
             lambda: any(f[0] == "BOOKMARK" for f in again.frames))
        with again.lock:
            cut = next(i for i, f in enumerate(again.frames)
                       if f[0] == "BOOKMARK")
            replay = [f[:2] for f in again.frames[:cut]]
            upto_rv = again.frames[cut][1]
        missed = [f[:2] for f in bs.events() if last < f[1] <= upto_rv]
        stats["resume"] = {"from": last, "through": upto_rv,
                           "replayed": len(replay),
                           "patch_in_it": any(rv == patched_rv
                                              for _, rv in replay)}
        require(replay == missed and replay and
                len({rv for _, rv in replay}) == len(replay) and
                stats["resume"]["patch_in_it"],
                f"phase22: resumed from {last}: {replay}, missed {missed}")
        again.close()
        small_store = ClusterStore()
        small_store.watch_cache_capacity = 8
        small = ApiServerProxy(small_store)
        small.start()
        for i in range(20):
            small_store.create({"kind": "ConfigMap", "apiVersion": "v1",
                                "metadata": {"name": f"cm-{i}",
                                             "namespace": ns}})
        gone = {}
        for rv in (1, 10**6):
            status, _, body = _http(
                small.url, "GET", f"/api/v1/namespaces/{ns}/configmaps?"
                f"watch=true&resourceVersion={rv}")
            doc = json.loads(body)
            gone[rv] = (status, doc.get("kind"), doc.get("reason"))
        stats["gone"] = gone
        require(all(v[:2] == (410, "Status") for v in gone.values()),
                f"phase22: resumes past the ring {gone}")

        # 3. two steps and generate on the card in wir's world
        world = stats["world"]
        mesh = build_mesh(MeshConfig.auto(world["report"]["device_count"]),
                          device)
        ops.reset_launch_counts()
        trainer = Trainer(c, tc, seed=0, mesh=mesh)
        t0 = time.monotonic()
        trainer.fit(batches, steps=2, log_every=1)
        if device == "cuda":
            torch.cuda.synchronize()
        stats["train_s"] = time.monotonic() - t0
        counts_train = ops.launch_counts()
        ops.reset_launch_counts()
        ids = generate(shard_decode_params(trainer.params, mesh, c), prompt,
                       c, new)
        if device == "cuda":
            torch.cuda.synchronize()
        counts_gen = ops.launch_counts()
        want_ids = generate(trainer.params, prompt, c, new)
        losses = [x for _, x in trainer.stats.losses]
        params = trainer.params
        trainer.close()
        trainer = None
        one = Trainer(c, tc, seed=0, device=device)
        one.fit(batches, steps=2, log_every=1)
        want_losses = [x for _, x in one.stats.losses]
        one.close()
        del one
        ops.reset_launch_counts()     # the comparisons' launches
        gc.collect()
        for got in (counts_train, counts_gen):
            for k, n in got.items():
                launched[k] = launched.get(k, 0) + n
        stats.update({"losses": losses, "launches_train": counts_train,
                      "ids_equal": bool(torch.equal(ids, want_ids)),
                      "launches_generate": counts_gen})
        require(stats["ids_equal"], "phase22: wir's generate differs from "
                                    "one device's")
        require(losses == want_losses and len(losses) == 2 and
                all(math.isfinite(x) for x in losses),
                f"phase22: wir's losses {losses} differ from one device's "
                f"{want_losses}")

        # 4. culled through the apiserver's service proxy
        status, _, body = _http(proxy.url, "POST", coll, api.new_notebook(
            big, ns, annotations={names.TPU_ACCELERATOR_ANNOTATION:
                                  "h100-16"}))
        require(status == 201, f"phase22: POST {big} answered {status}")
        wait(f"SliceReady on {big}", lambda: k8s.condition_true(
            store.get(api.KIND, ns, big), api.CONDITION_SLICE_READY))
        gen = ContinuousBatchedGenerator(params, c, n_slots=8, device=device)
        server = ServingServer(gen, c, port=0).start()
        del params
        ops.reset_launch_counts()
        key = names.PROXY_BACKEND_ANNOTATION
        # the Jupyter probe's URL names no port: the bare key serves it
        backends[(ns, name)] = {key: jupyter.url, f"{key}-80": jupyter.url,
                                f"{key}-{server.port}": server.url}
        backends[(ns, big)] = {key: jupyter.url}
        status, _, body = _http(proxy.url, "GET",
                                f"/api/v1/namespaces/{ns}/services/{name}")
        served_svc = json.loads(body)
        stats["backends"] = {k: v for k, v in k8s.annotations(
            served_svc).items() if k.startswith(key)}
        require(status == 200 and stats["backends"] == backends[(ns, name)],
                f"phase22: wir's Service as served {status} {served_svc}")
        healthz = server.metrics.counter("serving_http_requests_total", "")
        probes0 = proxy.requests_served
        cull = _cull_sequence(store, mgr, offset, config, server.url,
                              server.port, V, ns, name, big, phase="phase22")
        probes = proxy.requests_served - probes0
        # the serving server counts a request after it has written the
        # answer, which the proxy may already have relayed
        served = {"route": "/healthz", "method": "GET", "code": "200"}
        wait("the last probe's count", lambda: jupyter.hits +
             healthz.get(served) >= probes, 10.0)
        n_decode = gen.steps_total * L
        counts_served = ops.launch_counts()
        stats["culling"] = dict(cull, probes={
            "through_the_apiserver": probes, "jupyter": jupyter.hits,
            "healthz": healthz.get({"route": "/healthz", "method": "GET",
                                    "code": "200"}),
            "jupyter_refused": list(jupyter.refused)})
        p = stats["culling"]["probes"]
        require(probes > 0 and probes == p["jupyter"] + p["healthz"] and
                not p["jupyter_refused"],
                f"phase22: probes through the apiserver {p}")
        require(cull["requests_total"] == [8, 16, 16],
                f"phase22: requests_total {cull['requests_total']}")
        # every tick launches flash-decode once a layer, and nothing else
        # launches (the plain versions run on the CPU)
        want = {k: (n_decode if k == "flash_decode" and device == "cuda"
                    else 0) for k in counts_served}
        require(counts_served == want,
                f"phase22: the served requests' launches {counts_served}, "
                f"expected {want} ({gen.steps_total} ticks x {L})")
        launched["flash_decode"] = launched.get("flash_decode", 0) + \
            counts_served.get("flash_decode", 0)
        stats["launches_served"] = counts_served
        server.stop()
        server = None

        # 5. deleted over the wire: nothing of wir left
        leave_world()
        t_del = time.monotonic()
        for nb in (name, big):
            status, _, _ = _http(proxy.url, "DELETE", f"{coll}/{nb}")
            require(status == 200, f"phase22: DELETE {nb} answered {status}")
        wait("wir's DELETED on the binary stream", lambda: any(
            t == "DELETED" and obj["metadata"]["name"] == name
            for t, _, obj, _ in bs.events()))
        stats["delete_ms"] = (time.monotonic() - t_del) * 1e3
        wait("wir's objects gone", lambda: not any(
            _left_behind(store, central, ns, name).values()) and not
            store.list("Pod", ns))
        status, _, _ = _http(proxy.url, "GET", f"{coll}/{name}")
        stats["after_delete"] = dict(_left_behind(store, central, ns, name),
                                     pods=len(store.list("Pod", ns)),
                                     get_status=status)
        require(status == 404, f"phase22: GET after the delete {status}")
        stats["fanout"] = {
            enc: {"bytes": registry.counter("watch_fanout_bytes_total",
                                            "").get({"encoding": enc}),
                  "frames": registry.counter("watch_frames_sent_total",
                                             "").get({"encoding": enc})}
            for enc in ("json", "binary")}
        stats["requests_served"] = proxy.requests_served
    finally:
        for s in streams:
            s.close()
        if trainer is not None:
            trainer.close()
        if server is not None:
            server.stop()
        if dist.is_initialized():
            leave_world()
        if mgr is not None:
            mgr.stop()
        proxy.stop()
        if small is not None:
            small.stop()
        if jupyter is not None:
            jupyter.close()
    stats["control_plane"] = {"writes": store._last_rv,
                              "reconciles": _reconcile_totals(mgr)}
    # two notebooks' lives take ~100 writes; thousands mean a reconciler
    # fights a write of its own objects
    require(store._last_rv < 400,
            f"phase22: {store._last_rv} writes: {stats['control_plane']}")
    return stats, launched


def _wire_fleets(n_by_shape: dict, shards=(8, 1)) -> list:
    """Phase 15's fleet (``_notebook_fleet``, ``components="core"``) on
    ``ClusterStore(shards=n)`` for each n in turn: SliceReady seconds,
    CPU seconds and ``store_write_lock_seconds``' count and sum. The
    last sharded run's
    store is served by an ``ApiServerProxy`` with one JSON and one
    binary Pod watcher open through the run; after it, over HTTP: a
    ``limit=7`` LIST of Notebooks walked through ``continue`` equals the
    unpaginated LIST's (namespace, name) set, a ``resourceVersion=0``
    LIST is served from the serve cache (``apiserver_cache_lists_total``
    up by one) and a malformed ``continue`` answers 422; and each
    watcher's fan-out bytes per frame."""
    from kubeflow_tpu_torch.cluster.apiserver import ApiServerProxy
    from kubeflow_tpu_torch.cluster.store import ClusterStore
    from kubeflow_tpu_torch.utils.metrics import MetricsRegistry

    out = []
    last_sharded = max(i for i, n in enumerate(shards) if n > 1)
    for i, n in enumerate(shards):
        store = ClusterStore(shards=n)
        proxy, watchers = None, []
        if i == last_sharded:
            registry = MetricsRegistry()
            proxy = ApiServerProxy(store)
            proxy.attach_metrics(registry)
            proxy.start()
            for binary in (False, True):
                watchers.append(_WatchStream(
                    proxy.url, "/api/v1/pods?watch=true&resourceVersion=0",
                    binary=binary))
        try:
            cpu0 = time.process_time()
            fleet = _notebook_fleet(n_by_shape, store=store)
            fleet["cpu_s"] = time.process_time() - cpu0
            fleet["shards"] = n
            if proxy is not None:
                fleet["http"] = _paged_checks(proxy, registry)
                _wait_for("both Pod watchers to hold the fleet's pods",
                          lambda: all(len(w.events()) >= fleet["pods"]
                                      for w in watchers), 60.0,
                          phase="phase22")
                fleet["fanout"] = {}
                for w, enc in zip(watchers, ("json", "binary")):
                    frames = list(w.frames)
                    fleet["fanout"][enc] = {
                        "frames": len(frames),
                        "bytes_per_frame": sum(f[3] for f in frames)
                        / len(frames)}
        finally:
            for w in watchers:
                w.close()
            if proxy is not None:
                proxy.stop()
        out.append(fleet)
    return out


def _paged_checks(proxy, registry) -> dict:
    """Over HTTP, on a fleet's store: the ``limit=7`` walk, the
    cache-served rv=0 LIST and the malformed continue token."""
    path = "/apis/kubeflow.org/v1/notebooks"
    status, _, body = _http(proxy.url, "GET", path)
    require(status == 200, f"phase22: LIST answered {status}")
    want = {(n["metadata"]["namespace"], n["metadata"]["name"])
            for n in json.loads(body)["items"]}
    got, pages, token = [], 0, None
    while True:
        q = f"?limit=7&continue={token}" if token else "?limit=7"
        status, _, body = _http(proxy.url, "GET", path + q)
        require(status == 200, f"phase22: page {pages} answered {status}")
        doc = json.loads(body)
        require(len(doc["items"]) <= 7, f"phase22: a page of "
                                        f"{len(doc['items'])}")
        got += [(n["metadata"]["namespace"], n["metadata"]["name"])
                for n in doc["items"]]
        pages += 1
        token = doc["metadata"].get("continue")
        if not token:
            break
    cache = registry.counter("apiserver_cache_lists_total", "")
    before = cache.total()
    status, _, body = _http(proxy.url, "GET", path + "?resourceVersion=0")
    cached = {(n["metadata"]["namespace"], n["metadata"]["name"])
              for n in json.loads(body)["items"]}
    served_from_cache = cache.total() - before
    bad, _, bad_body = _http(proxy.url, "GET", path + "?continue=!!bad!!")
    out = {"notebooks": len(want), "pages": pages,
           "paged_equal": got == sorted(want) and len(got) == len(want),
           "rv0_from_cache": served_from_cache,
           "rv0_equal": status == 200 and cached == want,
           "malformed_continue": (bad, json.loads(bad_body).get("reason"))}
    require(out["paged_equal"] and out["rv0_from_cache"] == 1 and
            out["rv0_equal"] and out["malformed_continue"][0] == 422,
            f"phase22: the paged LISTs {out}")
    return out


def phase_wire(torch, flagship, trc_losses: list) -> tuple[dict, dict]:
    """22: the wire's server half on the card (``_wire_sequence`` at the
    flagship's width: b8 x s1024 with bf16 params, generate 8 x 128 ->
    16; the 2 losses equal to phase 21's), then phase 15's fleet twice,
    on 8 shards and on 1 (``_wire_fleets``). Returns
    (stats, the launches of the main path)."""
    from kubeflow_tpu_torch.models import train as train_lib

    t_phase = time.monotonic()
    L = flagship.n_layers
    torch.cuda.reset_peak_memory_stats()
    stats, launched = _wire_sequence(
        torch, flagship, train_lib.TrainConfig(bf16_params=True), 8, 1024,
        128, 16)
    stats["seconds"] = time.monotonic() - t_phase
    stats["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    gc.collect()
    torch.cuda.empty_cache()
    counts_train, counts_gen = stats["launches_train"], \
        stats["launches_generate"]
    cull = stats["culling"]
    for what, value in (
            ("wir POSTed -> SliceReady on the JSON watch ms (host time)",
             stats["ready_ms"]),
            ("as answered to the POST", stats["admitted"]),
            ("wir's world (seconds, report)",
             (stats["world"]["seconds"], stats["world"]["report"])),
            ("the two streams up to SliceReady (events, bytes per event)",
             stats["streams"]),
            ("resumed from the last rv read (from, through, frames "
             "replayed, the patch among them)", stats["resume"]),
            ("resumes past an 8-frame ring and from an rv never issued "
             "(status, kind, reason)", stats["gone"]),
            ("Trainer(mesh=...) b8 s1024 2 steps: losses, bit-equal to one "
             "device's and to phase 21's steps 1-2; seconds",
             (stats["losses"], True, stats["train_s"])),
            ("launches of wir's 2 steps", counts_train),
            ("wir's generate 8 x 128 -> 16: ids equal to one device's, "
             "launches", (stats["ids_equal"], counts_gen)),
            ("wir's Service as the apiserver serves it: its backends",
             stats["backends"]),
            ("culler probes through the apiserver's service proxy "
             "(requests served, Jupyter 200s, serving /healthz 200s)",
             cull["probes"]),
            ("serving probe round trip through the apiserver, ms",
             cull["probe_ms"]),
            ("requests_total at each check", cull["requests_total"]),
            ("served tokens/s, 8 x (128 -> 16) twice", cull["tokens_per_s"]),
            ("launches of the 16 served requests",
             stats["launches_served"]),
            ("stop annotations", cull["stop"]),
            ("delete -> wir's DELETED on the binary watch ms (host time)",
             stats["delete_ms"]),
            ("after the delete (left behind)", stats["after_delete"]),
            ("watch fan-out over the phase (bytes, frames by encoding)",
             stats["fanout"]),
            ("control plane writes and reconciles",
             stats["control_plane"])):
        print(f"phase22 {what}: {value} ({CARD[0]})", flush=True)
    require(stats["losses"] == list(trc_losses[:2]),
            f"phase22: losses {stats['losses']} differ from phase 21's "
            f"{trc_losses}")
    attn = ("flash_attention", "flash_attention_bwd_dkv",
            "flash_attention_bwd_dq")
    require(all(counts_train.get(k) == 2 * L for k in attn) and
            not counts_train.get("flash_decode") and
            counts_gen.get("flash_attention") == L and
            counts_gen.get("flash_decode") == (16 - 1) * L and
            not counts_gen.get("flash_attention_bwd_dkv"),
            f"phase22: launches train {counts_train}, generate "
            f"{counts_gen}")
    t0 = time.monotonic()
    stats["fleets"] = _wire_fleets({"h100-1": 60, "h100-8": 30,
                                    "h100-16": 10}, shards=(8, 1))
    for i, f in enumerate(stats["fleets"]):
        print(f"phase22 fleet run {i + 1} (ClusterStore(shards="
              f"{f['shards']})): 100 Notebooks SliceReady in "
              f"{f['seconds']} s, CPU {f['cpu_s']} s; CR→SliceReady p50 "
              f"{f['ready_p50_ms']} ms, p95 {f['ready_p95_ms']} ms (host "
              f"time); {f['writes']} writes; store_write_lock_seconds "
              f"count {f['write_lock']['count']}, sum "
              f"{f['write_lock']['sum_s']} s ({CARD[0]})", flush=True)
        if "http" in f:
            print(f"phase22 fleet run {i + 1} over HTTP: {f['http']}; Pod "
                  f"watchers' fan-out {f['fanout']} ({CARD[0]})",
                  flush=True)
    print(f"phase22 in {stats['seconds']:.1f} s "
          f"({stats['seconds'] + time.monotonic() - t0:.1f} s with the "
          f"fleets), peak {stats['peak_mem_gb']:.3f} GB; launches "
          f"{launched} ({CARD[0]})", flush=True)
    return stats, launched


class _EchoDrops:
    """Counts what the controllers' echo filters drop
    (``EchoTrackingClient.is_echo`` answering True, by kind) while it is
    entered; the class's method is restored on the way out."""

    def __init__(self):
        self.by_kind: dict = {}

    def __enter__(self):
        from kubeflow_tpu_torch.cluster import echo
        self._orig = orig = echo.EchoTrackingClient.is_echo
        by_kind = self.by_kind

        def counted(client, event):
            out = orig(client, event)
            if out:
                kind = event.obj.get("kind")
                by_kind[kind] = by_kind.get(kind, 0) + 1
            return out
        echo.EchoTrackingClient.is_echo = counted
        return self

    def __exit__(self, *exc):
        from kubeflow_tpu_torch.cluster import echo
        echo.EchoTrackingClient.is_echo = self._orig
        return False

    def total(self) -> int:
        return sum(self.by_kind.values())


def _requests_by_method(registry) -> dict:
    """``rest_client_requests_total`` summed over codes, by method."""
    metric = registry.counter("rest_client_requests_total", "")
    return {m: metric.sum_where({"method": m})
            for m in ("GET", "POST", "PUT", "PATCH", "DELETE")
            if metric.sum_where({"method": m})}


def _server_side(shards: int = 8, ready_hook=None, audit_log=None):
    """The apiserver's side of the wire: a ``ClusterStore(shards)`` with
    the Notebook, SlicePool and TPUQuota CRDs, a ``Manager`` over it with
    the StatefulSet simulator (its readiness gated by ``ready_hook``)
    and an ``ApiServerProxy`` on it, neither started. Returns (store,
    simulator manager, proxy)."""
    from kubeflow_tpu_torch.api.slicepool import install_slicepool_crd
    from kubeflow_tpu_torch.api.tpuquota import install_tpuquota_crd
    from kubeflow_tpu_torch.api.types import install_notebook_crd
    from kubeflow_tpu_torch.cluster.apiserver import ApiServerProxy
    from kubeflow_tpu_torch.cluster.cache import CachingClient
    from kubeflow_tpu_torch.cluster.kubelet import StatefulSetSimulator
    from kubeflow_tpu_torch.cluster.store import ClusterStore
    from kubeflow_tpu_torch.controllers import Manager

    store = ClusterStore(shards=shards)
    install_notebook_crd(store)
    install_slicepool_crd(store)
    install_tpuquota_crd(store)
    # the simulator reads through its own cache, as a kubelet's informers
    sim_cache = CachingClient(store, auto_informer=False, disable_for=())
    sim_mgr = Manager(sim_cache, read_cache=sim_cache)
    StatefulSetSimulator(sim_cache, ready_hook=ready_hook).setup(sim_mgr)
    return store, sim_mgr, ApiServerProxy(store, audit_log=audit_log)


def _http_fleet(n_by_shape: dict, wire_format: str = "json",
                namespaces: int = 10, components: str = "core",
                timeout: float = 120.0, phase: str = "phase23") -> dict:
    """Phase 15's fleet with the manager over the wire: ``_server_side``
    served by its ``ApiServerProxy``, and ``build_manager(HttpApiClient(
    url, wire_format=...), components=...)`` under ``start()`` with 4
    workers. The notebooks are created on the store (so the client's
    counters hold the controllers' traffic alone); each CR's create →
    SliceReady latency is taken on a store watch. Returns the seconds to
    the last SliceReady and the CPU seconds of the fan-out, the
    controllers' requests per notebook by method (from the first create
    to the last SliceReady), the connections the client opened by type,
    what the echo filters dropped by kind, and the writes."""
    from kubeflow_tpu_torch.api import types as api
    from kubeflow_tpu_torch.cluster.http_client import HttpApiClient
    from kubeflow_tpu_torch.main import build_manager
    from kubeflow_tpu_torch.utils import k8s, names

    store, sim_mgr, proxy = _server_side()
    client = mgr = None
    created: dict = {}
    ready: dict = {}

    def on_notebook(event) -> None:
        key = (k8s.namespace(event.obj), k8s.name(event.obj))
        if key in created and key not in ready and \
                k8s.condition_true(event.obj, api.CONDITION_SLICE_READY):
            ready[key] = time.monotonic()
    store.watch(api.KIND, on_notebook)
    stops: list = []   # each server and manager once started
    try:
        sim_mgr.start()
        stops.append(sim_mgr.stop)
        proxy.start()
        stops.append(proxy.stop)
        client = HttpApiClient(proxy.url, wire_format=wire_format)
        with _EchoDrops() as echoes:
            mgr, _ = build_manager(client, max_concurrent_reconciles=4,
                                   components=components)
            mgr.start()
            requests = mgr.metrics.counter("rest_client_requests_total", "")
            _settle(requests.total, "the controllers' requests", phase,
                    still_s=0.3)
            base = _requests_by_method(mgr.metrics)
            cpu0 = time.process_time()
            t0 = time.monotonic()
            i = 0
            for shape, n in n_by_shape.items():
                for _ in range(n):
                    key = (f"team-{i % namespaces}", f"nb-{shape}-{i}")
                    created[key] = time.monotonic()
                    store.create(api.new_notebook(key[1], key[0], annotations={
                        names.TPU_ACCELERATOR_ANNOTATION: shape}))
                    i += 1
            _wait_for(f"SliceReady on {len(created)} notebooks over "
                      f"{wire_format}", lambda: len(ready) == len(created),
                      timeout, phase=phase)
            seconds = time.monotonic() - t0
            cpu_s = time.process_time() - cpu0
            after = _requests_by_method(mgr.metrics)
    finally:
        if mgr is not None:
            mgr.stop()
        if client is not None:
            client.close()
        for stop in reversed(stops):
            stop()
    n = len(created)
    per_method = {m: (after.get(m, 0) - base.get(m, 0)) / n for m in after
                  if after.get(m, 0) != base.get(m, 0)}
    conns = mgr.metrics.counter("rest_client_connections_opened_total", "")
    lat = sorted((ready[k] - created[k]) * 1e3 for k in created)
    return {"wire_format": wire_format, "notebooks": n, "seconds": seconds,
            "cpu_s": cpu_s, "ready_p50_ms": lat[len(lat) // 2],
            "ready_p95_ms": lat[min(len(lat) - 1, int(0.95 * len(lat)))],
            "requests_per_notebook": sum(per_method.values()),
            "requests_per_notebook_by_method": per_method,
            "connections": {t: conns.get({"type": t})
                            for t in ("pooled", "stream")},
            "echoes_dropped": dict(echoes.by_kind),
            "writes": store._last_rv}


def _webhook_configuration(kind: str, name: str, url: str) -> dict:
    """A Mutating/ValidatingWebhookConfiguration whose one webhook sends
    Notebook CREATEs and UPDATEs to ``url`` (failurePolicy Fail)."""
    return {"kind": kind, "apiVersion": "admissionregistration.k8s.io/v1",
            "metadata": {"name": name},
            "webhooks": [{
                "name": "notebooks.kubeflow.org", "failurePolicy": "Fail",
                "clientConfig": {"url": url},
                "rules": [{"apiGroups": ["kubeflow.org"],
                           "apiVersions": ["v1"],
                           "operations": ["CREATE", "UPDATE"],
                           "resources": ["notebooks"]}]}]}


def _http_sequence(torch, c, tc, B: int, S: int, prompt_len: int,
                   new: int, device: str = "cuda",
                   timeout: float = 180.0) -> tuple[dict, dict]:
    """Phase 23's drive at any size, on ``device`` ("cuda": an NCCL
    world; "cpu": gloo, the tests): the manager over the wire.

    The apiserver's side (``_server_side``: 8 shards, the three CRDs,
    the simulator gated by a ``_SliceGate`` for notebook ``wcl``) served
    by its ``ApiServerProxy`` with an audit log; the port's
    ``AdmissionServer`` (mutating, then validating) on a free port, plain
    HTTP, registered by a Mutating- and a ValidatingWebhookConfiguration
    created through a second ``HttpApiClient`` (``kubectl``); and the
    controllers' side, ``build_manager(HttpApiClient(url),
    components="all")`` under ``start()`` with a ``FlightRecorder``
    provider. ``wcl`` (h100-1, a JAX image) is created through
    ``kubectl``: the answer is locked with the CUDA image, one mutating
    and one validating AdmissionReview reached the server for its
    CREATE; the extension unlocks it, worker 0 turns Ready once its
    world passes ``verify_slice``, and SliceReady is read through the
    manager's cache. In its world a ``Trainer(mesh=...)`` takes 2 steps
    (held to one device's) and greedy ``generate`` on
    ``shard_decode_params`` is held to the one-device ``generate``.
    Then what the wire shows: the controllers' requests for ``wcl``'s
    bring-up by method, its stitched trace with its ``rest.*`` spans and
    a ``wire`` leg above 0, and the audit lines that carry its trace id
    (the traceparent the client sent). Then the apiserver stops,
    ``wcl-late`` is created on the store during the outage, a new
    apiserver starts on the same port: every watch resumes from its
    last rv (``watch_resumes_total{mode="resume"}``, no relist) and
    ``wcl-late`` turns SliceReady (no world of its own: the gate holds
    ``wcl``'s only). Last both are deleted through ``kubectl`` and
    nothing of either is left. Every server, client and manager stops
    and the no-op provider is restored in a ``finally``. Returns (stats,
    the launches of the main path: the 2 steps and the ``generate``,
    each counted from 0)."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from kubeflow_tpu_torch import ops
    from kubeflow_tpu_torch.api import types as api
    from kubeflow_tpu_torch.cluster.apiserver import ApiServerProxy
    from kubeflow_tpu_torch.cluster.http_client import HttpApiClient
    from kubeflow_tpu_torch.main import build_manager
    from kubeflow_tpu_torch.models.decode import generate
    from kubeflow_tpu_torch.parallel.mesh import (MeshConfig, build_mesh,
                                                  leave_world)
    from kubeflow_tpu_torch.runtime.data import synthetic_lm_batches
    from kubeflow_tpu_torch.runtime.sharded_decode import shard_decode_params
    from kubeflow_tpu_torch.runtime.trainer import Trainer
    from kubeflow_tpu_torch.utils import k8s, names, tracing
    from kubeflow_tpu_torch.utils.config import (DEFAULT_GPU_IMAGE,
                                                 ControllerConfig)
    from kubeflow_tpu_torch.webhook import (NotebookMutatingWebhook,
                                            NotebookValidatingWebhook)
    from kubeflow_tpu_torch.webhook.server import (MUTATE_PATH,
                                                   VALIDATE_PATH,
                                                   AdmissionServer)

    require(not dist.is_initialized(), "phase23: a world is still formed")
    require(not tracing.is_recording(), "phase23: a provider records")
    V = c.vocab_size
    ns, name, late = "wcl-ns", "wcl", "wcl-late"
    jax_image = "jupyter/jax-notebook:latest"
    stats: dict = {}
    launched: dict = {}
    config = ControllerConfig()
    central = config.controller_namespace
    gate = _SliceGate(name, device)
    audit_dir = tempfile.mkdtemp(prefix="phase23-audit-")
    audit = os.path.join(audit_dir, "audit.ndjson")
    store, sim_mgr, proxy = _server_side(ready_hook=gate, audit_log=audit)
    adm = AdmissionServer(NotebookMutatingWebhook(store, config),
                          NotebookValidatingWebhook(config),
                          host="127.0.0.1", port=0)
    reviews: list = []
    review = adm.review

    def counted_review(path, body):
        req = body.get("request") or {}
        md = (req.get("object") or {}).get("metadata") or {}
        reviews.append((path, req.get("operation"), md.get("name")))
        return review(path, body)
    adm.review = counted_review
    recorder = tracing.FlightRecorder(traces_per_key=64)
    kubectl = client = mgr = trainer = None

    def wait(what: str, cond, limit: float = timeout) -> float:
        def ok():
            require(gate.error is None,
                    f"phase23: the ready hook failed while waiting for "
                    f"{what}: {gate.error!r}")
            return cond()
        return _wait_for(what, ok, limit, phase="phase23")

    def ready_in_cache(nb: str) -> bool:
        obj = mgr.client.get_or_none(api.KIND, ns, nb)
        return obj is not None and k8s.condition_true(
            obj, api.CONDITION_SLICE_READY)

    stops: list = []   # each server and manager once started
    with _EchoDrops() as echoes:
        try:
            sim_mgr.start()
            stops.append(sim_mgr.stop)
            proxy.start()
            stops.append(proxy.stop)
            adm.start()
            stops.append(adm.stop)
            kubectl = HttpApiClient(proxy.url)
            scheme = "http"
            for kind, cfg_name, path in (
                    ("MutatingWebhookConfiguration", "wcl-mutating",
                     MUTATE_PATH),
                    ("ValidatingWebhookConfiguration", "wcl-validating",
                     VALIDATE_PATH)):
                kubectl.create(_webhook_configuration(
                    kind, cfg_name, f"{scheme}://127.0.0.1:{adm.port}{path}"))
            stats["admission_scheme"] = scheme
            tracing.set_provider(tracing.SDKProvider(recorder))
            client = HttpApiClient(proxy.url)
            plugins = len(store._admission)
            mgr, _ = build_manager(client, config, components="all")
            requests = mgr.metrics.counter("rest_client_requests_total", "")
            require(not client.supports_inprocess_admission and
                    len(store._admission) == plugins,
                    "phase23: build_manager installed admission in process")
            src = synthetic_lm_batches(B, S, V, seed=0)
            batches = [next(src) for _ in range(2)]
            rng = torch.Generator().manual_seed(7)
            prompt = torch.randint(0, V, (B, prompt_len),
                                   generator=rng).to(device)
            mgr.start()
            _settle(requests.total, "the controllers' requests",
                    "phase23")

            # 1. created through the client, admitted over AdmissionReview
            r0 = _requests_by_method(mgr.metrics)
            t_create = time.monotonic()
            created = kubectl.create(api.new_notebook(
                name, ns, image=jax_image,
                annotations={names.TPU_ACCELERATOR_ANNOTATION: "h100-1"}))
            stats["post_ms"] = (time.monotonic() - t_create) * 1e3
            stats["admitted"] = {
                "lock": k8s.get_annotation(created, names.STOP_ANNOTATION),
                "image": api.notebook_container(created)["image"],
                "reviews": {p: sum(1 for r in reviews
                                   if r == (p, "CREATE", name))
                            for p in (MUTATE_PATH, VALIDATE_PATH)}}
            require(stats["admitted"] == {
                "lock": names.RECONCILIATION_LOCK_VALUE,
                "image": DEFAULT_GPU_IMAGE,
                "reviews": {MUTATE_PATH: 1, VALIDATE_PATH: 1}},
                    f"phase23: admitted {stats['admitted']}")
            stats["ready_ms"] = 1e3 * wait(
                "SliceReady on wcl through the manager's cache",
                lambda: ready_in_cache(name))
            stats["world"] = gate.worlds[-1]
            _settle(requests.total, "the controllers' requests",
                    "phase23")
            r1 = _requests_by_method(mgr.metrics)
            stats["requests_bringup"] = {m: r1.get(m, 0) - r0.get(m, 0)
                                         for m in r1
                                         if r1.get(m, 0) != r0.get(m, 0)}
            stats["reviews_bringup"] = {
                f"{p} {op}": sum(1 for r in reviews if r == (p, op, name))
                for p in (MUTATE_PATH, VALIDATE_PATH)
                for op in ("CREATE", "UPDATE")}

            # 2. two steps and generate on the card in wcl's world
            world = stats["world"]
            mesh = build_mesh(MeshConfig.auto(world["report"]["device_count"]),
                              device)
            ops.reset_launch_counts()
            trainer = Trainer(c, tc, seed=0, mesh=mesh)
            t0 = time.monotonic()
            trainer.fit(batches, steps=2, log_every=1)
            if device == "cuda":
                torch.cuda.synchronize()
            stats["train_s"] = time.monotonic() - t0
            counts_train = ops.launch_counts()
            ops.reset_launch_counts()
            ids = generate(shard_decode_params(trainer.params, mesh, c),
                           prompt, c, new)
            if device == "cuda":
                torch.cuda.synchronize()
            counts_gen = ops.launch_counts()
            want_ids = generate(trainer.params, prompt, c, new)
            losses = [x for _, x in trainer.stats.losses]
            trainer.close()
            trainer = None
            one = Trainer(c, tc, seed=0, device=device)
            one.fit(batches, steps=2, log_every=1)
            want_losses = [x for _, x in one.stats.losses]
            one.close()
            del one
            ops.reset_launch_counts()     # the comparisons' launches
            gc.collect()
            for got in (counts_train, counts_gen):
                for k, n in got.items():
                    launched[k] = launched.get(k, 0) + n
            stats.update({"losses": losses, "launches_train": counts_train,
                          "ids_equal": bool(torch.equal(ids, want_ids)),
                          "launches_generate": counts_gen})
            require(stats["ids_equal"], "phase23: wcl's generate differs from "
                                        "one device's")
            require(losses == want_losses and len(losses) == 2 and
                    all(math.isfinite(x) for x in losses),
                    f"phase23: wcl's losses {losses} differ from one device's "
                    f"{want_losses}")
            leave_world()

            # 3. what the wire shows: the stitched trace and the audit lines
            stamp = k8s.get_annotation(store.get(api.KIND, ns, name),
                                       names.TRACE_CONTEXT_ANNOTATION)
            stamped = tracing.parse_traceparent(stamp)
            require(stamped is not None, f"phase23: wcl's stamp {stamp!r}")
            trace_id = f"{stamped.trace_id:032x}"
            traces = recorder.trace_for(ns, name)
            mine = [t for t in traces if t["trace_id"] == trace_id]
            require(mine, f"phase23: wcl's stamped trace {trace_id} is not "
                          f"among the {len(traces)} held")
            spans = mine[0]["spans"]
            rest = [s for s in spans if s["name"].startswith("rest.")]
            ids_in = {s["span_id"] for s in spans}
            by_parent: dict = {}
            for s in spans:
                by_parent.setdefault(s["parent_id"], []).append(s)
            roots = [s for s in spans if s["name"] == "reconcile"]
            per_root = []
            for root in roots:
                b = tracing.trace_phase_breakdown(
                    [root] + by_parent.get(root["span_id"], []))
                legs = b["queue"] + b["wire"] + b["reconcile"]
                require(abs(legs - b["wall"]) <= 1e-9,
                        f"phase23: a reconcile root's breakdown {b}")
                per_root.append(b)
            breakdown = tracing.trace_phase_breakdown(spans)
            with open(audit) as fh:
                lines = [json.loads(ln) for ln in fh if ln.strip()]
            joined = [ln for ln in lines if ln.get("trace_id") == trace_id]
            stats["trace"] = {
                "trace_id": trace_id, "spans": len(spans),
                "rest_spans": {n: sum(1 for s in rest if s["name"] == n)
                               for n in sorted({s["name"] for s in rest})},
                "rest_under_a_root": sum(1 for s in rest
                                         if s["parent_id"] in ids_in),
                "apiserver_spans": sum(1 for s in spans
                                       if s["name"] == "apiserver.request"),
                "roots": len(roots),
                "breakdown": breakdown,
                "wire_over_roots": sum(b["wire"] for b in per_root)}
            stats["audit"] = {
                "lines": len(lines), "with_wcl_trace_id": len(joined),
                "first": ({k: joined[0].get(k) for k in ("verb", "path",
                                                         "code", "trace_id")}
                          if joined else None)}
            require(rest and breakdown["wire"] > 0 and joined,
                    f"phase23: the wire in wcl's trace {stats['trace']}, "
                    f"audit {stats['audit']}")

            # 4. an apiserver restart: every watch resumes, no relist
            port = proxy.port
            resumes = mgr.metrics.counter("watch_resumes_total", "")
            before = {m: resumes.sum_where({"mode": m})
                      for m in ("resume", "relist")}
            t_out = time.monotonic()
            stops.remove(proxy.stop)
            proxy.stop()
            store.create(api.new_notebook(late, ns, annotations={
                names.TPU_ACCELERATOR_ANNOTATION: "h100-1"}))
            proxy = ApiServerProxy(store, port=port, audit_log=audit)
            proxy.start()
            stops.append(proxy.stop)
            stats["outage_ms"] = (time.monotonic() - t_out) * 1e3
            t_back = time.monotonic()
            wait(f"SliceReady on {late} after the restart",
                 lambda: k8s.condition_true(store.get(api.KIND, ns, late),
                                            api.CONDITION_SLICE_READY))
            stats["late_ready_ms"] = (time.monotonic() - t_back) * 1e3
            _settle(requests.total, "the controllers' requests",
                    "phase23")
            stats["resumes"] = {m: resumes.sum_where({"mode": m}) - before[m]
                                for m in ("resume", "relist")}
            require(stats["resumes"]["resume"] >= 1 and
                    stats["resumes"]["relist"] == 0,
                    f"phase23: watches after the restart {stats['resumes']}")
            stats["late_world"] = "none: the gate forms wcl's world only"

            # 5. deleted through the client: nothing of either left
            t_del = time.monotonic()
            for nb in (name, late):
                kubectl.delete(api.KIND, ns, nb)
            wait("both notebooks' objects gone", lambda: not any(
                v for nb in (name, late)
                for v in _left_behind(store, central, ns, nb).values())
                and not store.list("Pod", ns))
            stats["delete_ms"] = (time.monotonic() - t_del) * 1e3
            stats["after_delete"] = {
                nb: dict(_left_behind(store, central, ns, nb),
                         pods=len(store.list("Pod", ns)))
                for nb in (name, late)}
            _settle(requests.total, "the controllers' requests",
                    "phase23")
            r2 = _requests_by_method(mgr.metrics)
            stats["requests_both_lives"] = {m: r2.get(m, 0) - r0.get(m, 0)
                                            for m in r2
                                            if r2.get(m, 0) != r0.get(m, 0)}
            stats["requests_per_notebook"] = \
                sum(stats["requests_both_lives"].values()) / 2
            stats["connections"] = {
                t: mgr.metrics.counter("rest_client_connections_opened_total",
                                       "").get({"type": t})
                for t in ("pooled", "stream")}
            stats["echoes_dropped"] = dict(echoes.by_kind)
            stats["reviews"] = len(reviews)
        finally:
            if trainer is not None:
                trainer.close()
            if dist.is_initialized():
                leave_world()
            if mgr is not None:
                mgr.stop()
            for cl in (client, kubectl):
                if cl is not None:
                    cl.close()
            tracing.set_provider(tracing.NoopProvider())
            for stop in reversed(stops):
                stop()
            shutil.rmtree(audit_dir, ignore_errors=True)
    stats["control_plane"] = {"writes": store._last_rv,
                              "reconciles": _reconcile_totals(mgr)}
    require(store._last_rv < 600,
            f"phase23: {store._last_rv} writes: {stats['control_plane']}")
    return stats, launched


def phase_http(torch, flagship, wire_losses: list) -> tuple[dict, dict]:
    """23: the manager over the wire on the card (``_http_sequence`` at
    the flagship's width: b8 x s1024 with bf16 params, generate 8 x 128
    -> 16; the 2 losses equal to phase 22's), then phase 15's fleet with
    the manager on ``HttpApiClient``, once JSON and once binary
    (``_http_fleet``), each under 60 requests a notebook. Returns
    (stats, the launches of the main path)."""
    from kubeflow_tpu_torch.models import train as train_lib

    t_phase = time.monotonic()
    L = flagship.n_layers
    torch.cuda.reset_peak_memory_stats()
    stats, launched = _http_sequence(
        torch, flagship, train_lib.TrainConfig(bf16_params=True), 8, 1024,
        128, 16)
    stats["seconds"] = time.monotonic() - t_phase
    stats["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    gc.collect()
    torch.cuda.empty_cache()
    counts_train, counts_gen = stats["launches_train"], \
        stats["launches_generate"]
    for what, value in (
            (f"admission over AdmissionReview ({stats['admission_scheme']}"
             f"://), as the POST answered it", stats["admitted"]),
            ("POST ms, create -> SliceReady through the manager's cache ms "
             "(host time)", (stats["post_ms"], stats["ready_ms"])),
            ("AdmissionReviews for wcl's bring-up by path and operation",
             stats["reviews_bringup"]),
            ("wcl's world (seconds, report)",
             (stats["world"]["seconds"], stats["world"]["report"])),
            ("Trainer(mesh=...) b8 s1024 2 steps: losses, bit-equal to one "
             "device's and to phase 22's; seconds",
             (stats["losses"], True, stats["train_s"])),
            ("launches of wcl's 2 steps", counts_train),
            ("wcl's generate 8 x 128 -> 16: ids equal to one device's, "
             "launches", (stats["ids_equal"], counts_gen)),
            ("controllers' requests for wcl's bring-up by method",
             stats["requests_bringup"]),
            ("wcl's stitched trace (spans, rest.* spans, breakdown s)",
             stats["trace"]),
            ("audit lines carrying wcl's trace id (the client's "
             "traceparent)", stats["audit"]),
            ("apiserver restart: outage ms, wcl-late create -> SliceReady "
             "after it ms", (stats["outage_ms"], stats["late_ready_ms"])),
            ("watch reconnects after the restart by mode",
             stats["resumes"]),
            ("wcl-late's world", stats["late_world"]),
            ("delete -> nothing left ms (host time)", stats["delete_ms"]),
            ("after the delete (left behind)", stats["after_delete"]),
            ("controllers' requests over both lives by method; per "
             "notebook", (stats["requests_both_lives"],
                          stats["requests_per_notebook"])),
            ("connections opened by type", stats["connections"]),
            ("echoes the filters dropped by kind", stats["echoes_dropped"]),
            ("control plane writes and reconciles",
             stats["control_plane"])):
        print(f"phase23 {what}: {value} ({CARD[0]})", flush=True)
    require(stats["losses"] == list(wire_losses[:2]),
            f"phase23: losses {stats['losses']} differ from phase 22's "
            f"{wire_losses}")
    attn = ("flash_attention", "flash_attention_bwd_dkv",
            "flash_attention_bwd_dq")
    require(all(counts_train.get(k) == 2 * L for k in attn) and
            not counts_train.get("flash_decode") and
            counts_gen.get("flash_attention") == L and
            counts_gen.get("flash_decode") == (16 - 1) * L and
            not counts_gen.get("flash_attention_bwd_dkv"),
            f"phase23: launches train {counts_train}, generate "
            f"{counts_gen}")
    t0 = time.monotonic()
    stats["fleets"] = [_http_fleet({"h100-1": 60, "h100-8": 30,
                                    "h100-16": 10}, wire_format=fmt)
                       for fmt in ("json", "binary")]
    for f in stats["fleets"]:
        print(f"phase23 fleet over HTTP ({f['wire_format']}): 100 Notebooks "
              f"SliceReady in {f['seconds']} s, CPU {f['cpu_s']} s; "
              f"CR→SliceReady p50 {f['ready_p50_ms']} ms, p95 "
              f"{f['ready_p95_ms']} ms (host time); requests per notebook "
              f"{f['requests_per_notebook']} "
              f"{f['requests_per_notebook_by_method']}; connections "
              f"{f['connections']}; echoes dropped {f['echoes_dropped']}; "
              f"{f['writes']} writes ({CARD[0]})", flush=True)
        require(f["requests_per_notebook"] < 60,
                f"phase23: {f['requests_per_notebook']} requests a notebook "
                f"over {f['wire_format']}")
    print(f"phase23 in {stats['seconds']:.1f} s "
          f"({stats['seconds'] + time.monotonic() - t0:.1f} s with the "
          f"fleets), peak {stats['peak_mem_gb']:.3f} GB; launches "
          f"{launched} ({CARD[0]})", flush=True)
    return stats, launched


CORE_LEASE = "kubeflow-tpu-notebook-controller-leader"
EXTENSION_LEASE = "kubeflow-tpu-extension-controller-leader"


def _spawn_binary(module: str, args: list, log_path: str,
                  env_extra: dict | None = None):
    """``python -m <module> <args>`` from the checkout this file sits in
    (``PYTHONPATH`` set to it), stdout and stderr appended to
    ``log_path``; the caller kills it."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here, **(env_extra or {}))
    with open(log_path, "ab") as log:
        return subprocess.Popen([sys.executable, "-m", module, *args],
                                cwd=here, env=env, stdout=log,
                                stderr=subprocess.STDOUT)


def _cli(url: str, args: list, timeout: float = 120.0):
    """One ``python -m kubeflow_tpu_torch.cli --server <url> <args>``
    process, run to its end: (exit code, stdout, stderr)."""
    here = os.path.dirname(os.path.abspath(__file__))
    out = subprocess.run(
        [sys.executable, "-m", "kubeflow_tpu_torch.cli", "--server", url,
         *args], cwd=here, env=dict(os.environ, PYTHONPATH=here,
                                    CUDA_VISIBLE_DEVICES=""),
        capture_output=True, text=True, timeout=timeout)
    return out.returncode, out.stdout, out.stderr


def _http_get(url: str, timeout: float = 5.0) -> tuple:
    """(status, body) of a GET; (None, "") when nothing answers."""
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as err:
        with err:
            return err.code, err.read().decode()
    except OSError:
        return None, ""


def _metric(text: str, family: str, **labels) -> float:
    """The sum of ``family``'s samples in an exposition whose labels
    include ``labels``."""
    pat = re.compile(rf"^{family}(?:\{{([^}}]*)\}})? (\S+)")
    total = 0.0
    for line in text.splitlines():
        m = pat.match(line)
        if m and all(f'{k}="{v}"' in (m.group(1) or "")
                     for k, v in labels.items()):
            total += float(m.group(2))
    return total


def _binary_sequence(torch, c, tc, B: int, S: int, prompt_len: int,
                     new: int, device: str = "cuda",
                     timeout: float = 180.0, lease_s: float = 6.0,
                     renew_s: float = 0.2) -> tuple[dict, dict]:
    """Phase 24's drive at any size, on ``device`` ("cuda": an NCCL
    world; "cpu": gloo, the tests): the control plane as the port's own
    binaries, each a process of its own.

    The apiserver's side stays in this process (``_server_side``: the
    store, its CRDs, the simulator gated by a ``_SliceGate`` for notebook
    ``bin``, an ``ApiServerProxy`` with an audit log). Three controller
    processes against it: two core managers A and B (``python -m
    kubeflow_tpu_torch.main --api-server URL --leader-elect --components
    core --health-port P --trace-debug``) and one extension manager E
    (``--components extension --leader-elect --webhook-port Q``), the
    leases short through ``LEADER_LEASE_DURATION`` (``lease_s``) and
    ``LEADER_RENEW_PERIOD`` (``renew_s``). One ``python -m
    kubeflow_tpu_torch.cli apply -f`` creates the two webhook
    configurations pointing at E's AdmissionServer and then the h100-1
    notebook with a JAX image: it is stored locked with the CUDA image,
    E unlocks it, the leader among A and B rolls it (its reconciles
    counted on its ``/metrics``, the standby's 0), ``cli get -o json``
    reads SliceReady. In its world a ``Trainer(mesh=...)`` takes 2 steps
    (held to one device's) and ``generate`` on ``shard_decode_params``
    is held to the one-device ``generate``; ``cli trace`` renders its
    stamped trace from the leader's debug endpoint. Then SIGTERM to the
    leader: it exits 0, its Lease released, and the standby holds it
    well under ``lease_s``; ``cli stop`` takes the notebook to 0 replicas
    through the new leader; the apiserver stops until the new leader's
    breaker opens (readyz fails on ``apiserver``,
    ``apiserver_breaker_state`` 2) and comes back on the same port: the
    breaker closes and ``resync_all`` re-enqueues (its
    ``workqueue_retries_total`` grows); ``cli delete`` leaves nothing;
    SIGTERM to the new leader and E, each exiting 0. Every process is
    killed, every server stopped, in a ``finally`` (a failed run prints
    each process's log tail). Returns (stats, the launches of the main
    path: the 2 steps and the ``generate``, each counted from 0)."""
    import copy
    import signal
    import tempfile

    import torch.distributed as dist

    from kubeflow_tpu_torch import ops
    from kubeflow_tpu_torch.api import types as api
    from kubeflow_tpu_torch.cluster.apiserver import ApiServerProxy
    from kubeflow_tpu_torch.models.decode import generate
    from kubeflow_tpu_torch.parallel.mesh import (MeshConfig, build_mesh,
                                                  leave_world)
    from kubeflow_tpu_torch.runtime.data import synthetic_lm_batches
    from kubeflow_tpu_torch.runtime.sharded_decode import shard_decode_params
    from kubeflow_tpu_torch.runtime.trainer import Trainer
    from kubeflow_tpu_torch.utils import k8s, names, tracing
    from kubeflow_tpu_torch.utils.config import (DEFAULT_GPU_IMAGE,
                                                 ControllerConfig)
    from kubeflow_tpu_torch.webhook.server import MUTATE_PATH, VALIDATE_PATH

    require(not dist.is_initialized(), "phase24: a world is still formed")
    t_phase = time.monotonic()
    V = c.vocab_size
    ns, name = "bin-ns", "bin"
    jax_image = "jupyter/jax-notebook:latest"
    stats: dict = {}
    launched: dict = {}
    central = ControllerConfig().controller_namespace
    gate = _SliceGate(name, device)
    work = tempfile.mkdtemp(prefix="phase24-")
    audit = os.path.join(work, "audit.ndjson")
    store, sim_mgr, proxy = _server_side(ready_hook=gate, audit_log=audit)
    seen: dict = {}

    def on_notebook(event) -> None:
        if k8s.name(event.obj) != name or event.type == "DELETED":
            return
        now = time.monotonic()
        if "created" not in seen:
            seen["created"] = (now, copy.deepcopy(event.obj))
        if "ready" not in seen and k8s.condition_true(
                event.obj, api.CONDITION_SLICE_READY):
            seen["ready"] = now
    store.watch(api.KIND, on_notebook)
    ports = {k: _free_port() for k in ("a", "b", "e", "webhook")}
    logs = {k: os.path.join(work, f"{k}.log") for k in ("a", "b", "e")}
    env = {"LEADER_LEASE_DURATION": str(lease_s),
           "LEADER_RENEW_PERIOD": str(renew_s), "CUDA_VISIBLE_DEVICES": ""}
    procs: dict = {}
    trainer = None
    done = False

    def wait(what: str, cond, limit: float = timeout) -> float:
        def ok():
            require(gate.error is None,
                    f"phase24: the ready hook failed while waiting for "
                    f"{what}: {gate.error!r}")
            for k, p in procs.items():
                require(p.poll() is None or k in stats.get("exited", {}),
                        f"phase24: process {k} exited {p.returncode} while "
                        f"waiting for {what}")
            return cond()
        return _wait_for(what, ok, limit, phase="phase24")

    def health(k: str, path: str) -> tuple:
        return _http_get(f"http://127.0.0.1:{ports[k]}{path}")

    def lease_holder(lease: str):
        obj = store.get_or_none("Lease", central, lease)
        return obj["spec"].get("holderIdentity") if obj else None

    def identity(k: str):
        with open(logs[k], errors="replace") as fh:
            m = re.search(rf"became leader for \S+/{CORE_LEASE} as (\S+)",
                          fh.read())
        return m.group(1) if m else None

    def reconciles(k: str) -> float:
        return _metric(health(k, "/metrics")[1],
                       "controller_runtime_reconcile_total",
                       controller="notebook-controller")

    stops: list = []   # each server once started
    try:
        sim_mgr.start()
        stops.append(sim_mgr.stop)
        proxy.start()
        stops.append(proxy.stop)
        url = proxy.url
        core = ["--api-server", url, "--leader-elect", "--components",
                "core", "--webhook-port", "0", "--trace-debug"]
        t_spawn = time.monotonic()
        for k in ("a", "b"):
            procs[k] = _spawn_binary(
                "kubeflow_tpu_torch.main",
                core + ["--health-port", str(ports[k])], logs[k], env)
        procs["e"] = _spawn_binary(
            "kubeflow_tpu_torch.main",
            ["--api-server", url, "--leader-elect", "--components",
             "extension", "--webhook-port", str(ports["webhook"]),
             "--health-port", str(ports["e"])], logs["e"], env)
        wait("A, B and E ready (readyz 200)", lambda: all(
            health(k, "/readyz")[0] == 200 for k in ("a", "b", "e")))
        wait("the core and the extension Lease held", lambda: all(
            lease_holder(lease) for lease in (CORE_LEASE, EXTENSION_LEASE)))
        stats["start_s"] = time.monotonic() - t_spawn
        holder = lease_holder(CORE_LEASE)
        wait("the leader's log naming its identity",
             lambda: holder in (identity("a"), identity("b")))
        lead = "a" if identity("a") == holder else "b"
        standby = "b" if lead == "a" else "a"
        stats["leader"] = {"process": lead, "identity": holder,
                           "extension": lease_holder(EXTENSION_LEASE)}

        # 1. one cli apply: the webhook configurations, then the notebook
        hook = f"http://127.0.0.1:{ports['webhook']}"
        docs = [_webhook_configuration("MutatingWebhookConfiguration",
                                       "bin-mutating", hook + MUTATE_PATH),
                _webhook_configuration("ValidatingWebhookConfiguration",
                                       "bin-validating",
                                       hook + VALIDATE_PATH),
                api.new_notebook(name, ns, image=jax_image, annotations={
                    names.TPU_ACCELERATOR_ANNOTATION: "h100-1"})]
        manifest = os.path.join(work, "bin.json")
        with open(manifest, "w") as fh:
            fh.write("\n---\n".join(json.dumps(d) for d in docs))
        rc, out, err = _cli(url, ["apply", "-f", manifest])
        stats["apply"] = {"rc": rc, "out": out.strip().splitlines()}
        require(rc == 0 and f"notebook/{name} created" in out,
                f"phase24: cli apply rc {rc}: {out} {err}")
        t_created, created = seen["created"]
        stats["admitted"] = {
            "lock": k8s.get_annotation(created, names.STOP_ANNOTATION),
            "image": api.notebook_container(created)["image"]}
        require(stats["admitted"] == {"lock": names.RECONCILIATION_LOCK_VALUE,
                                      "image": DEFAULT_GPU_IMAGE},
                f"phase24: stored {stats['admitted']}")
        wait("SliceReady on bin", lambda: "ready" in seen)
        stats["ready_ms"] = (seen["ready"] - t_created) * 1e3
        stats["world"] = gate.worlds[-1]
        rc, out, err = _cli(url, ["-n", ns, "get", "notebook", name,
                                  "-o", "json"])
        got = json.loads(out) if rc == 0 else {}
        stats["cli_get"] = {"rc": rc, "SliceReady": (api.get_condition(
            got, api.CONDITION_SLICE_READY) or {}).get("status")}
        require(stats["cli_get"] == {"rc": 0, "SliceReady": "True"},
                f"phase24: cli get {stats['cli_get']}: {err}")
        stats["reconciles"] = {"leader": reconciles(lead),
                               "standby": reconciles(standby)}
        require(stats["reconciles"]["leader"] > 0 and
                stats["reconciles"]["standby"] == 0,
                f"phase24: notebook reconciles {stats['reconciles']}")

        # 2. two steps and generate on the card in bin's world
        src = synthetic_lm_batches(B, S, V, seed=0)
        batches = [next(src) for _ in range(2)]
        rng = torch.Generator().manual_seed(7)
        prompt = torch.randint(0, V, (B, prompt_len),
                               generator=rng).to(device)
        world = stats["world"]
        mesh = build_mesh(MeshConfig.auto(world["report"]["device_count"]),
                          device)
        ops.reset_launch_counts()
        trainer = Trainer(c, tc, seed=0, mesh=mesh)
        trainer.fit(batches, steps=2, log_every=1)
        if device == "cuda":
            torch.cuda.synchronize()
        counts_train = ops.launch_counts()
        ops.reset_launch_counts()
        ids = generate(shard_decode_params(trainer.params, mesh, c),
                       prompt, c, new)
        if device == "cuda":
            torch.cuda.synchronize()
        counts_gen = ops.launch_counts()
        want_ids = generate(trainer.params, prompt, c, new)
        losses = [x for _, x in trainer.stats.losses]
        trainer.close()
        trainer = None
        one = Trainer(c, tc, seed=0, device=device)
        one.fit(batches, steps=2, log_every=1)
        want_losses = [x for _, x in one.stats.losses]
        one.close()
        del one
        ops.reset_launch_counts()     # the comparisons' launches
        gc.collect()
        for counts in (counts_train, counts_gen):
            for k, n in counts.items():
                launched[k] = launched.get(k, 0) + n
        stats.update({"losses": losses, "launches_train": counts_train,
                      "ids_equal": bool(torch.equal(ids, want_ids)),
                      "launches_generate": counts_gen})
        require(stats["ids_equal"], "phase24: bin's generate differs from "
                                    "one device's")
        require(losses == want_losses and len(losses) == 2 and
                all(math.isfinite(x) for x in losses),
                f"phase24: bin's losses {losses} differ from one device's "
                f"{want_losses}")
        leave_world()

        # 3. cli trace: the stamped trace from the leader's debug endpoint
        stamp = tracing.parse_traceparent(k8s.get_annotation(
            store.get(api.KIND, ns, name), names.TRACE_CONTEXT_ANNOTATION))
        require(stamp is not None, "phase24: bin carries no trace stamp")
        trace_id = f"{stamp.trace_id:032x}"
        rc, out, err = _cli(url, ["-n", ns, "trace", name, "--debug-server",
                                  f"http://127.0.0.1:{ports[lead]}"])
        stats["cli_trace"] = {
            "rc": rc, "traces": len(re.findall(r"^Trace \d+/", out, re.M)),
            "stamped_shown": trace_id in out,
            "critical_path": sum(1 for ln in out.splitlines()
                                 if ln.lstrip().startswith("*")),
            "lifecycle": next((ln for ln in out.splitlines()
                               if ln.startswith("Lifecycle:")), None)}
        require(rc == 0 and stats["cli_trace"]["stamped_shown"] and
                stats["cli_trace"]["lifecycle"],
                f"phase24: cli trace {stats['cli_trace']}: {err}")

        # 4. SIGTERM the leader: exit 0, its Lease released, B adopts
        t_term = time.monotonic()
        procs[lead].send_signal(signal.SIGTERM)
        stats.setdefault("exited", {})[lead] = rc = procs[lead].wait(
            timeout=60)
        stats["leader_exit_ms"] = (time.monotonic() - t_term) * 1e3
        require(rc == 0, f"phase24: the leader exited {rc}")
        wait("the standby holding the core Lease", lambda: (
            lambda ident: ident is not None and
            lease_holder(CORE_LEASE) == ident)(identity(standby)),
             lease_s * 4)
        stats["handover_ms"] = (time.monotonic() - t_term) * 1e3
        require(stats["handover_ms"] < lease_s * 1e3 / 2,
                f"phase24: handover took {stats['handover_ms']:.1f} ms of "
                f"a {lease_s} s lease")
        before = reconciles(standby)

        # 5. cli stop: 0 replicas through the new leader
        t_stop = time.monotonic()
        rc, out, err = _cli(url, ["-n", ns, "stop", "notebook", name])
        require(rc == 0, f"phase24: cli stop rc {rc}: {err}")
        wait("bin at 0 replicas", lambda: (store.get_or_none(
            "StatefulSet", ns, name) or {}).get("spec", {}).get(
            "replicas") == 0 and not store.list("Pod", ns))
        stats["stop_ms"] = (time.monotonic() - t_stop) * 1e3
        stats["new_leader_reconciles"] = reconciles(standby) - before
        require(stats["new_leader_reconciles"] > 0,
                "phase24: the new leader reconciled nothing for the stop")

        # 6. an apiserver outage opens the new leader's breaker
        _, text = health(standby, "/metrics")
        retries0 = _metric(text, "workqueue_retries_total")
        port = proxy.port
        t_out = time.monotonic()
        stops.remove(proxy.stop)
        proxy.stop()
        wait("the breaker open (readyz failing on apiserver)", lambda: (
            lambda r: r[0] == 503 and "[-]apiserver failed" in r[1])(
                health(standby, "/readyz")), 60)
        stats["breaker_open_ms"] = (time.monotonic() - t_out) * 1e3
        stats["readyz_open"] = health(standby, "/readyz")
        _, text = health(standby, "/metrics")
        stats["breaker_state_open"] = _metric(text, "apiserver_breaker_state")
        require(stats["breaker_state_open"] == 2.0 and
                _metric(text, "apiserver_available") == 0.0,
                f"phase24: breaker state {stats['breaker_state_open']}")
        proxy = ApiServerProxy(store, port=port, audit_log=audit)
        proxy.start()
        stops.append(proxy.stop)
        t_back = time.monotonic()
        wait("the breaker closed (readyz 200)",
             lambda: health(standby, "/readyz")[0] == 200, 60)
        stats["breaker_close_ms"] = (time.monotonic() - t_back) * 1e3
        wait("resync_all's re-enqueues", lambda: _metric(
            health(standby, "/metrics")[1], "workqueue_retries_total")
            > retries0, 30)
        _, text = health(standby, "/metrics")
        stats["breaker"] = {
            "state": _metric(text, "apiserver_breaker_state"),
            "transitions": {to: _metric(
                text, "apiserver_breaker_transitions_total", to=to)
                for to in ("open", "half_open", "closed")},
            "resync_retries": _metric(text, "workqueue_retries_total")
            - retries0}
        require(stats["breaker"]["state"] == 0.0 and
                stats["breaker"]["transitions"]["open"] >= 1 and
                stats["breaker"]["transitions"]["closed"] >= 1,
                f"phase24: breaker after the restart {stats['breaker']}")

        # 7. cli delete: nothing left
        t_del = time.monotonic()
        rc, out, err = _cli(url, ["-n", ns, "delete", "notebook", name])
        require(rc == 0, f"phase24: cli delete rc {rc}: {err}")
        wait("bin's objects gone", lambda: not any(
            _left_behind(store, central, ns, name).values())
            and not store.list("Pod", ns))
        stats["delete_ms"] = (time.monotonic() - t_del) * 1e3
        stats["after_delete"] = dict(_left_behind(store, central, ns, name),
                                     pods=len(store.list("Pod", ns)))

        # 8. SIGTERM the new leader and E: each exits 0
        for k in (standby, "e"):
            t0 = time.monotonic()
            procs[k].send_signal(signal.SIGTERM)
            stats["exited"][k] = procs[k].wait(timeout=60)
            stats.setdefault("exit_ms", {})[k] = \
                (time.monotonic() - t0) * 1e3
        stats["exit_ms"][lead] = stats["leader_exit_ms"]
        require(stats["exited"] == {"a": 0, "b": 0, "e": 0},
                f"phase24: exit codes {stats['exited']}")
        stats["released"] = {lease: lease_holder(lease) for lease in
                             (CORE_LEASE, EXTENSION_LEASE)}
        require(stats["released"] == {CORE_LEASE: "", EXTENSION_LEASE: ""},
                f"phase24: leases after the exits {stats['released']}")
        done = True
    finally:
        if trainer is not None:
            trainer.close()
        if dist.is_initialized():
            leave_world()
        for k, p in procs.items():
            if p.poll() is None:
                p.kill()
                p.wait()
        for stop in reversed(stops):
            stop()
        if not done:
            for k, path in logs.items():
                if os.path.exists(path):
                    with open(path, errors="replace") as fh:
                        tail = fh.read().splitlines()[-30:]
                    print(f"phase24 process {k} log tail:", *tail,
                          sep="\n  ", file=sys.stderr, flush=True)
        shutil.rmtree(work, ignore_errors=True)
    stats["seconds"] = time.monotonic() - t_phase
    stats["writes"] = store._last_rv
    return stats, launched


def phase_binaries(torch, flagship, http_losses: list) -> tuple[dict, dict]:
    """24: the control plane as the port's binaries on the card
    (``_binary_sequence`` at the flagship's width: b8 x s1024 with bf16
    params, generate 8 x 128 -> 16; the 2 losses equal to phase 23's).
    Returns (stats, the launches of the main path)."""
    from kubeflow_tpu_torch.models import train as train_lib

    L = flagship.n_layers
    torch.cuda.reset_peak_memory_stats()
    stats, launched = _binary_sequence(
        torch, flagship, train_lib.TrainConfig(bf16_params=True), 8, 1024,
        128, 16)
    stats["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    gc.collect()
    torch.cuda.empty_cache()
    counts_train, counts_gen = stats["launches_train"], \
        stats["launches_generate"]
    for what, value in (
            ("processes A, B (core) and E (extension) up, Leases held s",
             stats["start_s"]),
            ("leader", stats["leader"]),
            ("cli apply", stats["apply"]),
            ("stored by E's webhook", stats["admitted"]),
            ("create -> SliceReady ms (host time)", stats["ready_ms"]),
            ("cli get -o json", stats["cli_get"]),
            ("notebook reconciles, leader and standby", stats["reconciles"]),
            ("bin's world (seconds, report)",
             (stats["world"]["seconds"], stats["world"]["report"])),
            ("Trainer(mesh=...) b8 s1024 2 steps: losses, bit-equal to one "
             "device's and to phase 23's", stats["losses"]),
            ("launches of bin's 2 steps", counts_train),
            ("bin's generate 8 x 128 -> 16: ids equal to one device's, "
             "launches", (stats["ids_equal"], counts_gen)),
            ("cli trace from the leader's debug endpoint", stats["cli_trace"]),
            ("SIGTERM -> leader exit ms, -> standby holds the Lease ms "
             "(lease duration 6 s)",
             (stats["leader_exit_ms"], stats["handover_ms"])),
            ("cli stop -> 0 replicas ms; the new leader's reconciles",
             (stats["stop_ms"], stats["new_leader_reconciles"])),
            ("apiserver down -> breaker open ms; readyz; state",
             (stats["breaker_open_ms"], stats["readyz_open"],
              stats["breaker_state_open"])),
            ("apiserver back -> breaker closed ms; breaker",
             (stats["breaker_close_ms"], stats["breaker"])),
            ("cli delete -> nothing left ms; left behind",
             (stats["delete_ms"], stats["after_delete"])),
            ("exit codes; SIGTERM -> exit ms",
             (stats["exited"], stats["exit_ms"])),
            ("Leases after the exits", stats["released"])):
        print(f"phase24 {what}: {value} ({CARD[0]})", flush=True)
    require(stats["losses"] == list(http_losses[:2]),
            f"phase24: losses {stats['losses']} differ from phase 23's "
            f"{http_losses}")
    attn = ("flash_attention", "flash_attention_bwd_dkv",
            "flash_attention_bwd_dq")
    require(all(counts_train.get(k) == 2 * L for k in attn) and
            not counts_train.get("flash_decode") and
            counts_gen.get("flash_attention") == L and
            counts_gen.get("flash_decode") == (16 - 1) * L and
            not counts_gen.get("flash_attention_bwd_dkv"),
            f"phase24: launches train {counts_train}, generate "
            f"{counts_gen}")
    print(f"phase24 in {stats['seconds']:.1f} s, peak "
          f"{stats['peak_mem_gb']:.3f} GB; launches {launched} "
          f"({CARD[0]})", flush=True)
    return stats, launched


# --------------------------------------------------------------- phase 5
def _time_flash(torch, timer, b, s, h, d, seed=4, lse=False):
    import torch.nn.functional as F

    from kubeflow_tpu_torch.ops.attention import (flash_attention_cuda,
                                                  flash_attention_plain)
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn((b, s, h, d), generator=g, device="cuda",
                           dtype=torch.bfloat16) for _ in range(3))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    got = flash_attention_cuda(q, k, v, True)
    want = flash_attention_plain(q, k, v, True)
    err = (got.float() - want.float()).abs().max().item()
    tiles_ok, _ = check_tiles(got, want)
    nbytes = 4 * b * s * h * d * 2 + (b * h * s * 4 if lse else 0)
    flops = 4 * b * h * d * (s * (s + 1) // 2)
    b_ms, b_by = bound(nbytes, flops, "bfloat16")
    return {
        "max_abs_err": err, "flops": flops,
        "agrees": err <= BF16_TOL and tiles_ok,
        "ms": timer.ms(lambda: flash_attention_cuda(q, k, v, True, lse)),
        "plain_ms": timer.ms(lambda: flash_attention_plain(q, k, v, True,
                                                           lse)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": timer.ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True)),
        "shape": f"b={b} s={s} h={h} d={d} bf16 causal"
                 + (" with lse" if lse else "")}


def _time_bwd(torch, timer, b, s, h, d, seed=5):
    """The dK/dV and the dQ kernel alone on prepared inputs (Δ formed
    once outside the timing), beside the plain backward (dq, dk, dv in
    one function) and SDPA's backward (dq, dk, dv in one op)."""
    import torch.nn.functional as F

    from kubeflow_tpu_torch.ops import attention as attn
    from kubeflow_tpu_torch.ops.attention import (
        flash_attention_bwd_dkv_cuda, flash_attention_bwd_dq_cuda,
        flash_attention_bwd_plain, flash_attention_cuda)
    q, k, v, do = _random_qkvdo(torch, b, s, h, d, torch.bfloat16, seed)
    o, lse = flash_attention_cuda(q, k, v, True, return_lse=True)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, True)
    q2, k2, v2, do2, lse2, delta = attn.prepare_bwd_inputs(q, k, v, o, lse,
                                                           do)
    dk, dv = flash_attention_bwd_dkv_cuda(q2, k2, v2, do2, lse2, delta)
    dq = flash_attention_bwd_dq_cuda(q2, k2, v2, do2, lse2, delta)
    torch.cuda.synchronize()
    errs = {"flash_attention_bwd_dkv": _bwd_err(torch, (dk, dv), want[1:],
                                                torch.bfloat16),
            "flash_attention_bwd_dq": _bwd_err(torch, (dq,), want[:1],
                                               torch.bfloat16)}
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2)
    lib_ms = timer.ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                                  retain_graph=True))
    plain_ms = timer.ms(lambda: flash_attention_bwd_plain(q, k, v, o, lse,
                                                          do, True))
    pairs = b * h * (s * (s + 1) // 2)   # causal (query, key) pairs
    el, rows = b * s * h * d * 2, b * h * s * 4   # one bf16 tensor, lse/Δ
    rows_out = {}
    for name, fn, nbytes, products in (
            ("flash_attention_bwd_dkv",
             lambda: flash_attention_bwd_dkv_cuda(q2, k2, v2, do2, lse2,
                                                  delta),
             6 * el + 2 * rows, 4),
            ("flash_attention_bwd_dq",
             lambda: flash_attention_bwd_dq_cuda(q2, k2, v2, do2, lse2,
                                                 delta),
             5 * el + 2 * rows, 3)):
        flops = products * 2 * d * pairs
        b_ms, b_by = bound(nbytes, flops, "bfloat16")
        err, share, tile = errs[name]
        rows_out[name] = {
            "max_abs_err": err, "flops": flops,
            "agrees": share <= 1 and tile <= TILE_REL_TOL, "ms": timer.ms(fn),
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms,
            "shape": f"b={b} s={s} h={h} d={d} bf16 causal (plain and "
                     f"library: dq, dk, dv together)"}
    return rows_out


def _time_decode(torch, timer, pos_list, quant, B=8, S=1024, G=4, rep=2,
                 D=128):
    import torch.nn.functional as F

    from kubeflow_tpu_torch.models.decode import _quantize_kv
    from kubeflow_tpu_torch.ops.decode_attention import (
        flash_decode_attention_cuda, flash_decode_attention_plain)
    q, k, v = decode_inputs(torch, B, S, G, rep, D)
    pos = torch.tensor(pos_list, dtype=torch.int32, device="cuda")
    kw = {}
    qh = q.reshape(B, G * rep, 1, D)
    kl, vl = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    mask = (torch.arange(S, device="cuda")[None, :]
            <= pos[:, None])[:, None, None, :]
    if quant:
        (k, kw["k_scale"]), (v, kw["v_scale"]) = (_quantize_kv(k),
                                                  _quantize_kv(v))
    live = sum(min(p, S - 1) + 1 for p in pos_list)
    nbytes = (2 * B * G * rep * D * 2 + B * 4             # q, o, pos
              + 2 * live * G * D * (1 if quant else 2)    # live K and V
              + (2 * live * G * 4 if quant else 0))       # their scales
    flops = 4 * G * rep * D * live
    b_ms, b_by = bound(nbytes, flops, "bfloat16")
    # what one call allocates beyond its output (the splits' partials),
    # as the caching allocator counts it (in 512-byte blocks)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = flash_decode_attention_cuda(q, k, v, pos, **kw)
    scratch = (torch.cuda.max_memory_allocated() - base
               - 512 * math.ceil(got.numel() * got.element_size() / 512))
    err = (got.float() - flash_decode_attention_plain(q, k, v, pos, **kw)
           .float()).abs().max().item()
    return {
        "max_abs_err": err, "flops": flops,
        "ms": timer.ms(lambda: flash_decode_attention_cuda(q, k, v, pos,
                                                           **kw)),
        "plain_ms": timer.ms(lambda: flash_decode_attention_plain(
            q, k, v, pos, **kw)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None if quant else timer.ms(
            lambda: F.scaled_dot_product_attention(
                qh, kl, vl, attn_mask=mask, enable_gqa=True)),
        "workspace_bytes": scratch,   # printed, not a ``kernels`` key
        "shape": f"B={B} S={S} G={G} rep={rep} D={D} pos={pos_list} "
                 f"{'int8' if quant else 'bf16'} cache"}


def _print_row(name, r):
    """Print one timed kernel; turn its FLOP count into the achieved rate
    and the share of the bound it reaches."""
    r["tflops_per_s"] = r.pop("flops", 0) / r["ms"] / 1e9
    r["bound_share"] = r["bound_ms"] / r["ms"]
    lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
    ws = (f", {r['workspace_bytes']} bytes of workspace allocated"
          if "workspace_bytes" in r else "")
    print(f"phase5 {name} [{r['shape']}]: kernel {r['ms']:.4f} ms "
          f"({r['tflops_per_s']:.2f} TFLOP/s), bound {r['bound_ms']:.4f} ms "
          f"({r['bound_by']}; {100 * r['bound_share']:.2f}% of it reached)"
          f"{ws}, plain {r['plain_ms']:.4f} ms, library {lib}, "
          f"max|kernel-plain| {r['max_abs_err']:.3e}", flush=True)


def phase_times(torch, errs, counts):
    """Each kernel at the main path's shapes (the served 128-token
    prefill; a decode step in the middle of the served 64 tokens) — the
    ``kernels`` record — and at the phase-1/2 shapes (printed)."""
    timer = Timer(torch)
    S = 1024
    main = {
        "flash_attention": _time_flash(torch, timer, 8, 128, 8, 128),
        "flash_decode": _time_decode(torch, timer, [159] * 8, False),
        "flash_decode_int8": _time_decode(torch, timer, [159] * 8, True),
    }
    wide = {
        "flash_attention": _time_flash(torch, timer, 8, 512, 8, 128),
        "flash_decode": _time_decode(
            torch, timer, [0, 1, 127, 128, 500, 777, S - 2, S - 1], False),
        "flash_decode_int8": _time_decode(
            torch, timer, [0, 1, 127, 128, 500, 777, S - 2, S - 1], True),
    }
    sources = {
        "flash_attention": ("kubeflow_tpu_torch/csrc/flash_attention.cu",
                            "kubeflow_tpu/ops/attention.py:47"),
        "flash_decode": ("kubeflow_tpu_torch/csrc/flash_decode.cu",
                         "kubeflow_tpu/ops/decode_attention.py:40"),
        "flash_decode_int8": ("kubeflow_tpu_torch/csrc/flash_decode.cu",
                              "kubeflow_tpu/ops/decode_attention.py:40"),
        "flash_attention_bwd_dkv": (
            "kubeflow_tpu_torch/csrc/flash_attention_bwd.cu",
            "kubeflow_tpu/ops/attention.py:195"),
        "flash_attention_bwd_dq": (
            "kubeflow_tpu_torch/csrc/flash_attention_bwd.cu",
            "kubeflow_tpu/ops/attention.py:231"),
    }
    # the train path's shape (b8 s1024 h8 d128 bf16 causal): the forward
    # with lse (printed), and the two backward kernels (recorded)
    wide["flash_attention_train"] = _time_flash(torch, timer, 8, 1024, 8,
                                                128, lse=True)
    main.update(_time_bwd(torch, timer, 8, 1024, 8, 128))
    # decode at a full cache: every row at pos S - 1 (printed)
    full = {name: _time_decode(torch, timer, [S - 1] * 8, quant)
            for name, quant in (("flash_decode", False),
                                ("flash_decode_int8", True))}
    # the small draft's shapes (phase 9: d_head 64), printed
    draft = {"flash_attention": _time_flash(torch, timer, 8, 128, 8, 64),
             "flash_decode": _time_decode(torch, timer, [159] * 8, False,
                                          D=64)}
    rows = []
    for name, r in main.items():
        _print_row(name, r)
        if name in wide:
            _print_row(name, wide[name])
        if name in full:
            _print_row(name, full[name])
            wide[f"{name}_full_cache"] = full[name]
        if name in draft:
            _print_row(name, draft[name])
            require(draft[name].pop("agrees", draft[name]["max_abs_err"]
                                    <= BF16_TOL),
                    f"{name} disagrees with its plain version at the small "
                    f"draft's shape")
            wide[f"{name}_draft_d64"] = draft[name]
        require(r.pop("agrees", r["max_abs_err"] <= BF16_TOL),
                f"{name} disagrees with its plain version at the main "
                f"path's shape")
        if "workspace_bytes" in r:
            wide[f"{name}_workspace_bytes"] = r.pop("workspace_bytes")
        rows.append({"name": name, "route": "cuda",
                     "source": sources[name][0],
                     "replaces": sources[name][1],
                     "launches": counts[name],
                     **r, "max_abs_err": max(r["max_abs_err"], errs[name])})
    train = wide["flash_attention_train"]
    _print_row("flash_attention", train)
    dkv = main["flash_attention_bwd_dkv"]
    dq = main["flash_attention_bwd_dq"]
    print(f"phase5 at b8 s1024 h8 d128 bf16 causal: forward with lse "
          f"{train['ms'] / train['library_ms']:.2f}x SDPA's forward (target "
          f"<= 2), dK/dV {dkv['ms'] / dkv['library_ms']:.2f}x SDPA's whole "
          f"backward (target <= 1.5), dQ {dq['ms'] / dq['library_ms']:.2f}x "
          f"SDPA's whole backward (target <= 1)", flush=True)
    dec = main["flash_decode"]
    print(f"phase5 flash_decode at the served pos 159: "
          f"{dec['ms'] / dec['library_ms']:.2f}x SDPA (target <= 1); at a "
          f"full cache {100 * full['flash_decode']['bound_share']:.1f}% "
          f"(bf16) and {100 * full['flash_decode_int8']['bound_share']:.1f}"
          f"% (int8) of the byte bound", flush=True)
    return rows, wide


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from kubeflow_tpu_torch.ops import _build
    from kubeflow_tpu_torch.tools.train_step_time import (FLAGSHIP,
                                                          FLAGSHIP_MOE)

    # the "small" draft of ci/spec_acceptance.py: half the width and depth,
    # so 8 heads of 64 and 4 KV heads
    SMALL_DRAFT = FLAGSHIP.replace(d_model=512, d_ff=2048, n_layers=6)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    CARD.append(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.monotonic()
    names = _build.build_all()
    print(f"built {names} in {time.monotonic() - t0:.1f} s", flush=True)
    for name, log in sorted(_build.build_logs.items()):
        for kernel, (regs, st, ld) in sorted(ptxas_report(log).items()):
            print(f"ptxas[{name}] {kernel}: {regs} registers, {st} bytes "
                  f"spill stores, {ld} bytes spill loads")
            require("wgmma" not in kernel or st == ld == 0,
                    f"{kernel} spills under ptxas")
    for name in ("flash_attention", "flash_attention_bwd"):
        counts = sass_counts(_build._target(name))
        for kernel, (mma, tma) in sorted(counts.items()):
            print(f"sass[{name}] {kernel}: {mma} HGMMA, {tma} UTMALDG")
        require(counts and all(m and t for m, t in counts.values()),
                f"csrc/{name}.cu: a tensor-core kernel has no HGMMA or no "
                f"UTMALDG in its SASS: {counts}")
        if name == "flash_attention_bwd":
            require(sum("flash_bwd_dq_kernel_wgmma" in k for k in counts)
                    == 3, f"the bf16 dQ kernel is not on wgmma at d 32, 64 "
                          f"and 128: {sorted(counts)}")

    errs = {"flash_attention": phase_flash_attention(torch)}
    errs.update(phase_flash_decode(torch))
    params, counts, stats = phase_serving(torch, FLAGSHIP)
    phase_reference_tokens(torch, FLAGSHIP, params)
    stats["profile"] = phase_where_time_goes(torch, FLAGSHIP, params)
    cont_launches, stats["continuous"] = phase_continuous(torch, FLAGSHIP,
                                                          params)
    for name, n in cont_launches.items():
        counts[name] += n
    del params
    # each server and its engine hold each other in a reference cycle:
    # free phase 8's caches and weight copies before phase 7's peak
    gc.collect()
    torch.cuda.empty_cache()
    bwd_err = phase_flash_backward(torch)
    errs["flash_attention_bwd_dkv"] = errs["flash_attention_bwd_dq"] = bwd_err
    train = phase_train(torch, FLAGSHIP)
    # a kernel's launches: the sum over the main paths that run it
    for name, n in train["launches"].items():
        counts[name] = counts.get(name, 0) + n
    gc.collect()
    torch.cuda.empty_cache()
    # the checkpoints of phases 7b and 9 live under build/ (ignored by
    # git) and are deleted at the end of the run
    root = os.path.join(here, "build", f"smoke-checkpoints-{os.getpid()}")
    os.makedirs(root, exist_ok=True)
    baseline = {"bucketed_tokens_per_s":
                stats["serve_8x128p_64n_tokens_per_s"],
                "continuous_tokens_per_s":
                stats["continuous"]["staggered"]["tokens_per_s"]}
    try:
        params4, train["checkpoint"], launched = phase_checkpoint(
            torch, FLAGSHIP, SMALL_DRAFT, root)
        for name, n in launched.items():
            counts[name] += n
        gc.collect()
        torch.cuda.empty_cache()
        stats["speculative"], launched = phase_speculative(
            torch, FLAGSHIP, SMALL_DRAFT, root, params4, baseline)
        for name, n in launched.items():
            counts[name] += n
        # phase 9's servers and engines hold each other in cycles
        gc.collect()
        torch.cuda.empty_cache()
        stats["moe"], launched = phase_moe(torch, FLAGSHIP_MOE, SMALL_DRAFT,
                                           root)
        for name, n in launched.items():
            counts[name] += n
        gc.collect()
        torch.cuda.empty_cache()
        stats["lora"], launched = phase_lora(torch, FLAGSHIP, root, params4)
        for name, n in launched.items():
            counts[name] += n
        gc.collect()
        torch.cuda.empty_cache()
        # phases 12 and 13 in one NCCL world; 13 finetunes 7b's params
        # again, with LoRA, and trains the MoE of phase 10
        train["multidevice"] = phase_multidevice(
            torch, FLAGSHIP, root, train, FLAGSHIP_MOE, params4,
            stats["moe"]["train"])
        del params4
        for name, n in train["multidevice"]["launches"].items():
            counts[name] += n
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    train["bootstrap"], launched = phase_bootstrap(torch, FLAGSHIP)
    for name, n in launched.items():
        counts[name] += n
    gc.collect()
    torch.cuda.empty_cache()
    train["repair"], launched = phase_repair(torch, FLAGSHIP)
    for name, n in launched.items():
        counts[name] += n
    gc.collect()
    torch.cuda.empty_cache()
    train["pool"], launched = phase_pool(torch, FLAGSHIP)
    for name, n in launched.items():
        counts[name] += n
    gc.collect()
    torch.cuda.empty_cache()
    train["sched"], launched = phase_sched(torch, FLAGSHIP)
    for name, n in launched.items():
        counts[name] += n
    gc.collect()
    torch.cuda.empty_cache()
    train["ext"], launched = phase_ext(torch, FLAGSHIP,
                                       train["sched"]["losses"])
    for name, n in launched.items():
        counts[name] += n
    gc.collect()
    torch.cuda.empty_cache()
    train["admission"], launched = phase_admission(torch, FLAGSHIP,
                                                   train["ext"]["losses"])
    for name, n in launched.items():
        counts[name] += n
    gc.collect()
    torch.cuda.empty_cache()
    train["tracing"], launched = phase_tracing(
        torch, FLAGSHIP, train["admission"]["losses"])
    for name, n in launched.items():
        counts[name] += n
    gc.collect()
    torch.cuda.empty_cache()
    train["wire"], launched = phase_wire(torch, FLAGSHIP,
                                         train["tracing"]["losses"])
    for name, n in launched.items():
        counts[name] += n
    gc.collect()
    torch.cuda.empty_cache()
    train["http"], launched = phase_http(torch, FLAGSHIP,
                                         train["wire"]["losses"])
    for name, n in launched.items():
        counts[name] += n
    gc.collect()
    torch.cuda.empty_cache()
    train["binaries"], launched = phase_binaries(torch, FLAGSHIP,
                                                 train["http"]["losses"])
    for name, n in launched.items():
        counts[name] += n
    rows, wide = phase_times(torch, errs, counts)
    print(json.dumps({"serving": stats, "train": train,
                      "kernels_at_other_shapes": wide}), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
