#!/usr/bin/env python3
"""Start the PyTorch/CUDA port (``nomad_tpu_torch``) on one card.

    python3 chip_smoke.py            # every phase, one CUDA device

Phases:

1. build — compile every hand-written kernel from ``nomad_tpu_torch/ops/
   csrc`` (one ``nvcc`` per source, in parallel) and print what ptxas
   reported, with the card's name and power limit.
2. kernels — on a 10,000-node cluster (capacity 10240, B=64 lanes, P=16
   placements) run each kernel and its plain PyTorch version on the same
   inputs on the card: a batch of the bench's eight job shapes, and a
   batch with preemption, static and dynamic ports, distinct_hosts, dead
   lanes, in-flight deltas and lanes that collide on a few nearly full
   nodes.  Rows, preemption flags, counters and the VERIFIED column must
   be equal; scores and binpack within rtol 1e-4, atol 1e-5.
3. solo — the stack's solo path (more than 32 plan deltas) at the same
   width: ``place_task_group``, which launches fused_place at B=1, over a
   dense usage with 40 plan deltas folded in by ``_dense_used0``, against
   the plain version on five lanes of the second batch, under the same
   contract.
3b. place_batch — K2, the staged dispatch: ``place_batch``
   (``fused_place.cu`` with every lane live, at full features as the
   staged path runs it) against ``place_batch_plain`` on both batches
   (the second's six dead lanes become padding lanes with all-False host
   masks), exactly, and equal to ``fused_place`` on every live lane; its
   CUDA-event and device time beside ``fused_place``'s at the same
   features, its plain time and its bound (``fused_place_work``).
3c. edge shapes — the cases of ``tests/torch_edge_cases.py`` built with
   the port on the card (300 nodes at capacity 333 and 11 lanes, B=1, ties
   across node tiles and cluster CTAs, spread tables with duplicate hashes
   and a free slot that the scan fills, s_width=2, lanes that fail at step
   0, distinct_hosts, preemption, a dead lane): ``fused_place`` at each
   case's own widths, ``place_batch`` at full widths and ``score_batch`` at
   both, each against its plain version under the full contract.  Then
   the three on both batches at 80,000 rows, where a lane's candidate
   state no longer fits its cluster's shared memory and ``fused_place``
   keeps it in device scratch (the phase fails if the launch shape says
   otherwise).  Each kernel's launch shape (cluster size, lanes per CTA or
   node span, node tile, dynamic shared memory, loop-width tier) is logged
   here and in the timing phases.  Then ``allocs_fit_verify`` on the
   event streams of ``VERIFY_CASES`` (the bench batch's sizes, one row
   every lane picks, B=64 with 1,024 delta rows a lane, B=1, every lane
   dead, order-sensitive values with rows out of range) against
   ``verify_lanes``, exactly, in both tiers of the kernel (event keys in
   shared memory, and in device scratch for the large case), and
   ``system_feasible`` at the node counts of ``SYSTEM_ROWS`` (1 to 80,000)
   on every constraint kind, all sixteen slots, a device ask, a static
   port and an escaped class, against its plain version, exactly.
4. system kernel — ``system_feasible`` against its plain version on the
   same cluster, over ten system-job requests (a static port some nodes
   hold, datacenter lists, numeric, version, presence and NaN-column
   constraints, a device ask, an escaped class and a host mask, a dense
   base usage with deltas of both signs, an ask that exhausts nodes):
   both rows of the (2, N) result must be equal.
5. server — a ``Server(device="cuda")`` with 32 workers and 64 lanes:
   register 10,000 nodes over four datacenters, pre-load usage, submit 64
   service jobs of count 2, wait until every eval is terminal, and check
   the 128 placements.  Every launch count is zeroed just before the jobs
   go in and read just after: both kernels must have launched, the plain
   version never.  Then, with the counts zeroed again, one distinct_hosts
   group of 56 whose plan outgrows 32 deltas: it must take the solo path,
   launch fused_place and never the plain version.  A burst of 64 jobs
   runs under the CUDA profiler and prints the card's busy and idle share
   and its device time by activity; each of its jobs must be placed in
   full.  Last, with the counts zeroed again,
   the system path: two system jobs (``node-exporter`` everywhere with
   static port 9100, ``log-shipper`` in dc1 off class-3) must hold one
   alloc on exactly the nodes their specs call for; 32 nodes join and get
   theirs; the smoke plays the client (pending allocs report running);
   16 nodes holding service allocs drain (service allocs re-place through
   fused_place, system allocs stop, each drain completes) and 16 others
   go down (their allocs are lost and the service ones replaced).
   ``system_feasible`` must have launched once per system eval and its
   plain version never.  Then the job lifecycle on the same server, the
   smoke playing the client and its health reports: a destructive
   rolling update (count 8, max_parallel 2) to successful, a canary
   placed alone and auto-promoted, a failing update auto-reverted, an
   interval periodic job's children, a dispatched parameterized job, a
   scale up and down within policy, and ``system_gc`` reaping a stopped
   job and 16 down nodes, whose freed matrix rows 16 new nodes take and
   the system jobs cover through ``system_feasible``.
5b. staged server — a second server built under ``NOMAD_TPU_MEGABATCH=0``
   over the same 10,000 nodes takes the same 64-job burst: exactly 128
   fitting allocs, counts zeroed just before, ``place_batch`` launched and
   neither fused kernel nor a plain version; its evals/s, applier
   refusals and retries are logged beside the fused burst's.
6. timing — each kernel and its plain version at the phase-2 shape (for
   ``system_feasible``, the node-exporter request at N=10240), timed with
   CUDA events (median of 20 launches after warm-up; fused_place's and
   allocs_fit_verify's plain versions the median of 3 runs), beside its
   bound: the larger of the bytes it must move over the card's memory
   rate and the float32 operations it needs over the card's float32
   rate, and its device time from the profiler.  Then the fused
   dispatch's device total (``fused_place`` + ``allocs_fit_verify``) and
   its CUDA-event time, ``allocs_fit_verify`` on the hot-row stream and
   in its device-scratch tier, and its wrapper's host time.
   ``system_feasible`` also gets the time of one whole system dispatch,
   and its wrapper's host time split into its parts beside the CUDA
   events' floor on an empty function.

7. batched scoring — ``score_batch`` (one launch scores every node for
   B independent evals and picks each one's best) on a fresh cluster
   built as phase 2's (10,000 nodes, 2M allocs' usage), at the bench's
   shapes: lane i the bench's job shape i mod 8, operands
   from ``parallel.build_batch_inputs``, features widened over the eight
   shapes.  Against the plain version (run in chunks of 256 lanes: its
   (B, N, V) intermediates are gigabytes each at B=4096) at B=4096 and
   B=256, on the feature batch's shapes at B=64 and full features with
   tg counts, penalties, class eligibility, host masks and spread tables
   that are not trivial, and through ``nomad_tpu_torch.entry.entry()``:
   rows, preemption flags and counters equal, scores and binpack within
   rtol 1e-4, atol 1e-5.  Then the main path, with every count zeroed
   just before and read just after: ``entry()``, 100 sync dispatches at
   B=4096 and at B=256 (each ending in a ``.cpu()`` of rows; median and
   p99) and 100 pipelined dispatches at B=4096, depth 8 (evals/s): the
   kernel must have launched once per dispatch and the plain version
   never.  Last, its CUDA-event time (median of 20), profiler device time,
   the plain version's time, the bound, and 20 sync dispatches under the
   profiler (busy share, kernel vs copy).
8. plan verify — ``verify_plan_fit`` on a seeded plan of 10,000 rows
   (padding, deltas past a node's room, negative deltas, ineligible
   nodes, a mixed eligible_required) and on each (rows, deltas,
   eligible_required) the applier checked for node-exporter in phase 5
   (recorded through ``server/plan_apply.py:host_verify``), launch counts
   zeroed around those calls; against its plain version and
   ``host_verify`` on every row (and the applier's own verdicts); every
   output byte 0 or 1; its times and bound at K=10,000, and the
   wrapper's host microseconds a call split by part (the memoised column
   check, the operand checks, the library entry, the output allocation,
   the stream handle, the ``ctypes`` launch, the CUDA events' floor on an
   empty function).
9. restart — first a server without a ``data_dir`` registers 10,000
   ``server_node``s and takes a 64-job burst: the baseline of the
   journaled run.  Then a ``Server(device="cuda")`` with a ``data_dir`` in a
   temporary directory (the server phase's config: long heartbeat TTLs)
   journals 10,000 ``server_node``s, a 64-job burst, ``node-exporter``
   and a job whose eval blocks, and is crash-stopped (no snapshot).  A
   second server restores it from the write-ahead log: its tables
   (``to_snapshot_wire()``), latest index and matrix host arrays equal
   the first's, and its first sync is one full upload whose columns are
   bitwise equal to the first server's device columns.  With the counts
   zeroed it places 64 more count-2 jobs (exactly 128 fitting allocs),
   ``log-shipper`` on exactly its nodes and the restored blocked eval on
   a big node that registers, through ``fused_place``,
   ``allocs_fit_verify`` and ``system_feasible``, never a plain version.
   Its clean shutdown leaves a snapshot and an empty log; a third server
   restores from the snapshot alone to the same tables and arrays.  That
   image is installed into a running server whose 512-node matrix is
   already on the card (``Server.install_snapshot``: it steps down and
   its workers finish first): one full upload follows, the kernels' memoised
   column pointers are the new tensors', and a system job and a 64-job
   burst place on the installed nodes through the same kernels.  Logs
   the restore and install seconds, the full upload's bytes and time,
   the burst's evals/s with the WAL and without, events per topic and the
   observatory's and controller's states; removes the directory.
10. guarded and traced — a ``Server(device="cuda")`` with the server
   phase's config and ACLs on, over the 10,000 ``server_node``s: one
   bootstrap (a second raises), a policy granting ``submit-job`` in
   ``default`` and a token holding it, which may submit there and nowhere
   else (an empty and an unknown secret may not).  The 64 burst jobs and
   node-exporter, written in HCL and parsed by ``jobspec.parse_job``
   (each equal in ``job_to_api`` to the struct the server phase builds),
   submitted with the token: exactly 128 fitting allocs and node-exporter
   on exactly its nodes, through ``fused_place``, ``allocs_fit_verify``
   and ``system_feasible``, never a plain version (counts zeroed just
   before).  Every eval of the burst has one trace holding the service
   path's spans, each lane's device window holds a ``coalescer.launch``
   span, the registry the 13 ``nomad.phase.*`` timers and the health
   signals ``plan_queue_wait_p99_ms``; the Perfetto export (in a
   temporary directory, removed) covers the burst and ``obs.top``
   renders the breaker's row.  Bursts in the order A, B, B, A, A, B, B,
   A log the
   first-pass evals/s with tracing on and off, and with the resolver
   polling its ticket's event and waiting on a sacrificial thread.  Then the wedge
   drill, on a server whose breaker has a 200 ms deadline: spins on the
   card's stream (``torch.cuda._sleep``, calibrated with CUDA events)
   enqueued through ``run_device_op`` ahead of the next dispatch; one
   in the slow band gives a slow verdict whose placements are used, one
   of twice the wedge bound wedges a dispatch (its lanes fail with
   ``DeviceWedgedError``), trips the breaker, which refuses dispatches
   (their evals are nacked) until its canary closes it; every one of 16
   jobs is then placed in full, no plain version having run.  Logs the
   seconds from the spin to the trip, to the close and to the last
   placement, and how long an upload returns behind a spin from pageable
   and from page-locked memory.

11. agents — real node agents run what the card places.  A
   ``Server(device="cuda")`` with the server phase's config (blocked
   retries every 2 s, as in phase 10) over the 10,000 ``server_node``s,
   and 16 in-process ``nomad_tpu_torch.client.Client``s beside them
   (datacenter dc1, class ``agent``, each with its own data directory in
   a temporary directory, a fingerprinted node and the default drivers
   mock, raw_exec and exec): 10,016 rows.  The exec driver runs the
   Python sidecar (``NOMAD_TPU_EXECUTOR_BIN`` set empty for the phase,
   restored after; ``native/nomad-executor``, where built, does not
   survive a sidecar kill, ROADMAP R11); the log names its command line.
   With the counts zeroed just before, 64 count-2 service jobs
   constrained to the agents' class, job i with an affinity for the
   pair of agents i % 8, run the mock driver: 128 allocs
   placed by ``fused_place`` and ``allocs_fit_verify``, every one
   reported running by its agent through ``update_allocs_from_client``,
   every agent holding some and its runners equal to the store's allocs
   of its node; logs
   submit -> all placed and -> all running, evals/s and the p50/p99 of
   commit -> running per alloc; then the burst is stopped.  A raw_exec
   batch of 16 echoes ``$NOMAD_ALLOC_INDEX``, read back through
   ``Client.read_file``; an exec job of 8 runs ``sleep 600`` under the
   sidecar, one agent's sidecar is killed -9 and the task survives,
   recovered by pid by its replacement.  An agent holding an exec task
   crashes (loops stopped, tasks left running) and a new ``Client`` on
   its data directory comes back as the same node and re-attaches its
   tasks, same pids, no restart.  A mock task that fails on one agent
   (its node meta: run 0.2 s, exit 1; restart policy 1 attempt, 0.1 s,
   mode fail) restarts once and fails; its replacement is placed through
   the kernels onto another agent and runs.  A count-4 service job with
   an update stanza (max_parallel 2, min_healthy_time 1 s) moves to a new
   version and its deployment is judged successful on the agents' own
   health reports.  A system job constrained to the class places one
   raw_exec alloc on each agent through ``system_feasible``.  An agent is
   shut down and its node marked down as a missed TTL does: its allocs
   are lost and the service ones replaced through the kernels on the
   others, running.  Last every job is stopped: every alloc stops on its
   agent, no task process of the phase is left, and agents, sidecars and
   server shut down within 60 s; a failed check still kills every
   sidecar and task process of the phase.  Nothing in this phase plays
   the client.
12. front door — the HTTP API, the CLI and agents in their own processes.
   12a: ``python -m nomad_tpu_torch.cli agent --server-only --device cuda
   --port 0 --config <file>`` in a subprocess (fork and exec) of a
   temporary directory, its address read from its start line; 64 nodes
   registered over the wire; ``job run`` and ``job status`` of a small
   HCL service job through the CLI in subprocesses: the eval complete,
   its 2 allocs placed, ``/v1/metrics`` counting coalescer dispatches,
   the agent holding a CUDA context (``nvidia-smi --query-compute-apps``,
   or its open ``/dev/nvidia<N>`` where the tool lists another pid
   namespace); SIGINT stops it with exit code 0 within 30 s.  12b: an
   in-process server agent built from the config file ``cmd_agent``
   reads (``load_config_files``/``apply_config``, 32 workers, capacity
   10240, heartbeat TTLs 3600/7200 s, ACLs on; blocked retries every 2 s
   set in-process) with ``Agent(cfg, device="cuda")``; ``acl bootstrap``
   through the CLI; the server phases' 10,000 nodes registered over the
   wire (``HTTPServerRPC.register_node``, 8 threads); 4 client-only
   agents, each its own ``python -m nomad_tpu_torch.cli agent
   --client-only`` process (dc1, class ``agent``, the management token,
   a data directory each, the Python sidecar): 10,004 rows, each agent
   advertising its address.  With the counts zeroed, the server phase's
   64 count-2 jobs in HCL through ``POST /v1/jobs`` from 8 threads
   (anonymous: 403): every eval complete over HTTP, 128 fitting allocs,
   read back over ``GET /v1/allocations``.  An
   ``/v1/event/stream?topic=Allocation:*`` reader opens; through ``job
   run`` on the CLI, constrained to the agents: 4 raw_exec allocs whose
   ``alloc logs`` and ``alloc fs`` through the server agent (forwarded to
   the node agent) return each alloc's own index, and ``alloc exec``
   with stdin its stdout and exit code; a system job on exactly the 4
   agents; a sticky, migrating disk whose alloc ``node drain`` moves to
   another agent process with the file's bytes.  ``fused_place``,
   ``allocs_fit_verify`` and ``system_feasible`` must have launched,
   no plain version and no ``place_batch``; the stream saw every alloc of
   the agents' jobs; ``/v1/health``, ``/v1/slo`` and ``/v1/overload``
   answer with the reference's keys, ``/v1/metrics?format=prometheus``
   carries the coalescer and kernel gauges, ``top --count 1`` renders,
   ``/v1/internal/raft/stats`` answers 501, and no client-only agent
   holds a CUDA context.  Last the jobs stop (no task process left) and
   every agent stops (SIGINT, exit code 0).  Logs the registration
   seconds, the HTTP burst's evals/s beside the in-process server
   phase's, submit -> running of the agents' jobs, the migration and
   drain seconds.
13. replicated — replication and membership in front of the kernels.
   13a, in-process at full width: a ``Agent(cfg, device="cuda")`` server
   agent with ``raft_enabled`` and the cluster secret (the server phases'
   config, blocked retries every 2 s) leads alone and takes the server
   phases' 10,000 ``server_node``s, their pre-loaded usage carried as
   node reservations (a reservation replicates; usage written straight
   into one server's matrix would not).  ``server join`` (the CLI) adds
   two more agents one at a time; each catches up by snapshot install
   (10,000 entries are more than the log ring's 4,096) before the next
   joins.  64 count-2 service jobs go in from 8 threads to whichever
   server leads; after 32 acknowledged submits the leader is shut down.
   A survivor that caught up by snapshot wins the election; its first
   ``NodeMatrix.sync`` is a full upload.  When the shutdown has returned
   the counts are zeroed, and 8 more jobs go to the new leader once the
   burst's evals complete.  Every acknowledged submit is on both
   survivors and its eval completes; both survivors' ``to_snapshot_wire()``
   images are equal; the 144 allocs fit by the host AllocsFit; the new
   leader's device matrix, read back, equals one built from scratch from
   its store on every node's row; since the counts were zeroed
   ``fused_place`` and ``allocs_fit_verify`` launched and no plain
   version or ``place_batch``, and neither the old leader's nor the
   other survivor's coalescer dispatched, so the launches are the new
   leader's.  Logs the install seconds, the
   first sync's bytes and milliseconds, the seconds from the shutdown's
   start to the election and to the first placement, and the burst's
   evals/s.  13b, processes: three processes each build one kernel
   into one empty directory at once and load it; then three ``python
   -m nomad_tpu_torch.cli agent --server-only --device cuda --config
   <file>`` processes (peers and the secret in the file; 8 workers,
   capacity 1,280) elect a leader, each holding its own CUDA context;
   1,024 nodes (13a carries the full width) register through
   ``FailoverRPC``; the same burst goes over HTTP from 8 threads, and
   the leader's process is SIGKILLed after 32 acknowledged submits; the
   survivors elect a leader, every acknowledged eval completes there, its
   ``/v1/metrics`` counts fused launches and 128 allocs read back; ``server
   members`` and ``server remove-peer`` of the dead address run through
   the CLI; SIGINT stops the survivors, each with exit code 0.  Logs the
   election seconds after the kill and the burst's evals/s.
14. sharded — K9, the node-sharded dispatch, at the same width (10,000
   nodes, capacity 10240, 64 lanes, P=16).  On each mesh of
   ``["cuda:0"] * 4`` (batch 2 x node 2) and ``["cuda:0"] * 8`` (2 x 4)
   of virtual shards, and of every card when there are several, on both
   batches of phase 2: ``sharded_fused_place_batch`` against the
   unsharded ``fused_place_batch``, ``sharded_place_batch`` against
   ``place_batch`` and ``sharded_schedule_step`` against ``score_batch``,
   every column exactly (scores and binpack max |err| 0), the step's
   usage against the unsharded usage plus the picks' asks exactly (its
   ``sharded_usage`` launches counted around the steps), and
   ``sharded_place`` (the kernel, one launch a card a step over every
   shard there: P + 1 launches and no offer copy on one card),
   ``sharded_usage`` and the windowed
   ``allocs_fit_verify`` against their plain versions.  14b times the
   kernels on node shard 1 of x4 (``sharded_usage`` after the feature
   batch's step, B=64, with its wrapper's host split) and 14b' times
   ``sharded_usage`` at B=4,096 on node shard 1 of x4 (5,120 rows) and
   of x8 (2,560 rows), n_batch 2, on phase 7's picks (``score_batch`` on
   a fresh bench cluster, packed as the step packs them) and on picks
   spread over several rows of a CTA (``SPREAD_USAGE_CASES`` of
   ``tests/torch_edge_cases.py``, node shard 1 of x4): bit for bit
   against its plain version, CUDA events, device time and bound beside
   ``index_add``'s events and device time.  Then live servers: one on ``["cuda:0"] * 4``
   and one on the card alone register the server phases' 10,000 nodes
   with the same usage, place 16 service jobs one at a time onto the
   same nodes, and take a burst of 64 (evals/s of both; with several
   cards a third server over all of them does the same); with the counts
   zeroed around the sharded burst, ``sharded_place`` and the windowed
   ``allocs_fit_verify`` must have launched, and no plain version.  A
   server on ``["cuda:0"] * 8`` evacuates node shard 1 mid-burst
   (``coalescer.evacuate_shard``): every eval completes, and the layout
   equals a from-scratch one on the three survivors; after the heal a
   second burst completes on four shards again, the layout equal to a
   from-scratch one.  Logs the launch counts and offer copies per
   dispatch (14b fails unless a virtual mesh's dispatch is P + 1
   launches and no copy), the dispatch time and both bursts' evals/s.
15. chaos — the port's own chaos scenarios (``nomad_tpu_torch/chaos/
   scenarios.py``) and the shard-partition step on the card, the kernel
   counts zeroed before each part and read after it; no plain version
   may run.  15a ``wedged_dispatch_recovers`` at 10,000 nodes (pipeline
   depth 8, crowd 24): the wedge fires once, the breaker trips, every
   dispatch it refused while open launched nothing, the half-open canary
   re-closes it, every crowd job is placed in full through ``fused_place``
   and ``allocs_fit_verify``, and the throughput ratio holds ≥ 0.5; logs
   crowd → trip, trip → close and crowd → placed beside phase 10's drill.
   15b ``device_slow_flapping`` on a 10,000-node matrix (60 dispatches,
   p = 0.5): flips within the budget, every placement completed (a
   refused one re-sent), a fetch classified slow.  15c
   ``shard_loss_evacuation`` on ``["cuda"] * 8`` (four node shards) over
   10,000 nodes: ``sharded_place`` launched before the loss, for the
   in-flight placement on the survivors' mesh and after the heal; the
   evacuated layout equals a from-scratch 3-shard one row for row and
   the resident copy a from-scratch lay-out bit for bit; logs the
   evacuation's host ms and re-upload bytes.  15d the shard partition on
   the same mesh: a placement launched before the darkening onto the
   dark shard is refused by the applier's eligibility-gated re-verify
   for every pick, a placement after it finds no row there, the heal
   re-lights it and later placements land and commit there.  15e
   ``leader_kill_mid_apply`` and ``partition_then_heal`` (twice, one seed)
   with three in-process server agents on the card: equal images, the
   new leader's own dispatches launch ``fused_place`` and
   ``allocs_fit_verify`` after the old leader's shutdown returned (no
   other server's coalescer dispatching), and the partition's fired
   ``(seam, kind)`` list the same in both runs.  These run at the
   reference's node counts: phase 13 holds a failover at 10,000 nodes,
   and registering 10,000 nodes through a replicated leader (a write's
   quorum is 7-16 ms) would take minutes.
16. cache, counters and sanitizer — 16a the encoded-matrix cache: a
   server's 10,000 registered nodes (capacity 10240, usage pre-loaded,
   the cold build timed) written with ``NodeMatrix.save_encoded`` and
   read into a fresh matrix with ``load_encoded``: the host arrays equal
   the built ones bit for bit, and the first ``sync("cuda")`` is one full
   upload whose device columns equal the built matrix's bit for bit.  A
   second server over a load of the same file, its nodes registered onto
   the loaded rows, places the 64-job count-2 burst: 128 fitting allocs
   through ``fused_place`` and ``allocs_fit_verify``, no plain version.
   The same again with ``shard_count`` 4 on ``["cuda"] * 8`` (four node
   shards): ``sharded_place`` runs, every node keeps its home shard and
   the resident copy equals a from-scratch ``shard_matrix_arrays`` bit for
   bit.  16b the counters over both bursts: ``topk_host_bytes_total`` is
   the sum of the tickets' result copies, ``operand_bytes_total`` the sum
   of the uploads the dispatches' shapes call for, ``verify_conflicts``
   the VERIFIED 0.0 picks of the results the lanes got back,
   ``feature_recompiles`` the widenings; the four gauges of
   ``/v1/metrics`` equal the counters, and ``top``'s shard line on the
   x4 server reads the non-zero result bytes.  16c 15a's seeded wedge at
   10,000 nodes inside ``tsan.sanitized()``: the store, matrix,
   coalescer and broker instrumented, the kernels launched throughout,
   no plain version, zero race reports.

Each phase logs its seconds.  Prints the kernel table as one JSON line
before the last, and ends with
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
when there is no CUDA device or when any phase fails.
"""

from __future__ import annotations

import copy
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

import numpy as np

N_NODES = 10_000
CAPACITY = 10_240
LANES = 64
SCAN = 16
JOB_SHAPES = 8
SERVER_JOBS = 64
SERVER_COUNT = 2
SERVER_WORKERS = 32
RTOL, ATOL = 1e-4, 1e-5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM, non-tensor float32
REPRESENTATIVES = 96  # distinct node shapes, replicated to N_NODES rows
SOLO_DELTAS = 40  # plan deltas of the solo case: more than MAX_DELTA_ROWS
# Feature-batch lanes the solo case replays: preemption, ports,
# distinct_hosts, targeted spread, rack spread.
SOLO_LANES = (0, 1, 2, 3, 6)
SOLO_COUNT = 56  # distinct_hosts group whose fourth chunk goes solo
DATACENTERS = ["dc1", "dc2", "dc3", "dc4"]
SYSTEM_PORT = 9100
SYSTEM_NEW_NODES = 32
SYSTEM_DRAINS = 16
SYSTEM_DOWNS = 16
LIFECYCLE_TIMEOUT_S = 300.0
# Batched scoring (bench.py's kernel phase: BATCH, INTERACTIVE_BATCH,
# DISPATCHES, PIPELINE_DEPTH).
SCORE_BATCH = 4096
INTERACTIVE_BATCH = 256
FEATURE_LANES = 64
DISPATCHES = 100
PIPELINE_DEPTH = 8
PIPE_DISPATCHES = 100
PLAIN_CHUNK = 256  # lanes per call of the plain version on the card
VERIFY_ROWS = 10_000  # plan rows of the seeded verify case
# fused_place's state past a cluster's shared memory (phase 3c).
LARGE_ROWS = 80_000
LARGE_LANES = 16


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else (
            f"nvidia-smi gave nothing (rc {out.returncode})"
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"


# ---------------------------------------------------------------------------
# Cluster and request batches (the bench's shapes, built with the port)
# ---------------------------------------------------------------------------


def build_cluster(n_nodes: int, capacity: int, device, seed: int = 42):
    """A bench-shaped cluster: datacenters dc1-4, six classes, 32 racks,
    seeded usage capped at 75% and spread over four priority buckets."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.state.matrix import (
        PRIORITY_BUCKETS, NodeMatrix, stable_hash,
    )

    rng = np.random.default_rng(seed)
    m = NodeMatrix(capacity=capacity, device=device)

    def sim_node(i: int):
        node = mock.node()
        node.datacenter = f"dc{i % 4 + 1}"
        node.node_class = f"class-{i % 6}"
        node.attributes = dict(node.attributes)
        node.attributes["rack"] = f"r{i % 32}"
        node.attributes["platform.tpu.type"] = "v5e" if i % 3 else "v5p"
        return node

    reps = min(REPRESENTATIVES, n_nodes)
    for i in range(reps):
        m.upsert_node(sim_node(i))
    host = m.snapshot_host()
    if n_nodes > reps:
        rows = np.arange(reps, n_nodes)
        src = rows % reps
        for key in host:
            host[key][rows] = host[key][src]
        ids = [f"sim-node-{int(r)}" for r in rows]
        id_hash = np.fromiter((stable_hash(s) for s in ids), np.int32, len(ids))
        for attr in ("node.unique.name", "node.unique.id"):
            slot = m.attrs.lookup(attr)
            if slot is not None:
                host["attr_hash"][rows, slot] = id_hash
        for r, node_id in zip(rows, ids):
            m.row_of[node_id] = int(r)
            m.node_of[int(r)] = node_id
        m._next_row = n_nodes
    per_node = 2_000_000 / n_nodes
    usage = rng.poisson(per_node, n_nodes)[:, None] * np.array(
        [[100.0, 128.0, 30.0]]
    ) * rng.uniform(0.05, 0.12, (n_nodes, 1))
    usage = np.round(np.minimum(usage, host["totals"][:n_nodes] * 0.75))
    host["used"][:n_nodes] = usage
    shares = rng.dirichlet(np.ones(4), n_nodes)
    for j, b in enumerate(rng.choice(PRIORITY_BUCKETS, 4, replace=False)):
        host["prio_used"][:n_nodes, b] = np.round(usage * shares[:, j:j + 1])
    # A few occupied static ports.
    host["port_words"][: n_nodes: 7, 8080 >> 5] |= np.uint32(1 << (8080 & 31))
    host["port_words"][3: n_nodes: 13, SYSTEM_PORT >> 5] |= np.uint32(
        1 << (SYSTEM_PORT & 31))
    # Two GPUs on every fifth node, one of them in use on every tenth.
    gpu = m.devices.register("gpu")
    host["dev_total"][: n_nodes: 5, gpu] = 2
    host["dev_used"][: n_nodes: 10, gpu] = 1
    m._dirty.update(range(n_nodes))
    m.version += 1
    return m


def bench_jobs():
    """The bench's eight job shapes: plain, affinity, spread, constraint."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.structs.types import Affinity, Constraint, Op, Spread

    jobs = []
    for i in range(JOB_SHAPES):
        job = mock.job()
        tg = job.task_groups[0]
        tg.tasks[0].resources.cpu = 100 + 50 * (i % 4)
        tg.tasks[0].resources.memory_mb = 128 + 64 * (i % 3)
        if i % 4 == 1:
            tg.affinities = [Affinity(
                l_target="${attr.platform.tpu.type}", r_target="v5e",
                operand=Op.EQ.value, weight=50)]
        if i % 4 == 2:
            tg.spreads = [Spread(attribute="${attr.rack}", weight=50)]
        if i % 4 == 3:
            tg.constraints = [Constraint(
                l_target="${attr.kernel.name}", r_target="linux",
                operand=Op.EQ.value)]
        jobs.append((job, False))
    return jobs


def feature_jobs():
    """Preemption, static and dynamic ports, distinct_hosts, a targeted
    spread and a version constraint."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.structs.types import (
        Constraint, NetworkResource, Spread, SpreadTarget,
    )

    out = []
    j = mock.job(priority=90)
    j.task_groups[0].tasks[0].resources.cpu = 3000
    j.task_groups[0].tasks[0].resources.memory_mb = 6000
    out.append((j, True))
    j = mock.job()
    j.task_groups[0].tasks[0].resources.networks = [NetworkResource(
        reserved_ports=[8080], dynamic_ports=["http", "admin"])]
    out.append((j, False))
    j = mock.job()
    j.task_groups[0].constraints = [Constraint(operand="distinct_hosts")]
    out.append((j, False))
    j = mock.job()
    j.task_groups[0].spreads = [Spread(
        attribute="${node.datacenter}", weight=60,
        targets=[SpreadTarget(value="dc1", percent=70),
                 SpreadTarget(value="dc2", percent=20)])]
    j.task_groups[0].constraints = [Constraint(
        l_target="${attr.os.name}", operand="!=", r_target="windows")]
    out.append((j, False))
    return out


class Batch:
    """One dispatch's operands, as numpy and as tensors on a device."""

    def __init__(self, arrays, np_ops, device):
        import torch

        from nomad_tpu_torch.ops import kernels as k

        self.arrays = arrays
        self.np = np_ops
        ri, rf = k.pack_requests(np_ops["reqs"])
        t = {name: torch.from_numpy(np.ascontiguousarray(v)).to(device)
             for name, v in np_ops.items() if name != "reqs"}
        t["req_i"] = torch.from_numpy(ri).to(device)
        t["req_f"] = torch.from_numpy(rf).to(device)
        self.t = t
        self.features = k.features_of(np_ops["reqs"])

    def args(self):
        t = self.t
        return (self.arrays, self.arrays.used, t["delta_rows"],
                t["delta_vals"], t["tg_counts"], t["spread_counts"],
                t["penalties"], t["req_i"], t["req_f"], t["class_eligs"],
                t["host_masks"], t["lane_mask"])


def make_batches(m, device, lanes: int = LANES, seed: int = 3):
    """(plain batch, feature batch) at the main path's shape."""
    from nomad_tpu_torch.ops.encode import (
        MAX_SPREAD_VALUES, MAX_SPREADS, RequestEncoder, pow2_bucket,
    )
    from nomad_tpu_torch.scheduler.coalescer import MAX_DELTA_ROWS

    rng = np.random.default_rng(seed)
    enc = RequestEncoder(m)
    arrays = m.sync(device)
    n = int(arrays.used.shape[0])
    n_cls = pow2_bucket(max(1, len(m.class_ids)))

    def operands(compiled):
        b = len(compiled)
        reqs = [c.request for c in compiled]
        stacked = type(reqs[0])(*[np.stack(f) for f in zip(*reqs)])
        return {
            "reqs": stacked,
            "delta_rows": np.full((b, MAX_DELTA_ROWS), -1, np.int32),
            "delta_vals": np.zeros((b, MAX_DELTA_ROWS, 3), np.float32),
            "tg_counts": np.zeros((b, n), np.int32),
            "spread_counts": np.zeros((b, MAX_SPREADS, MAX_SPREAD_VALUES),
                                      np.float32),
            "penalties": np.zeros((b, n), bool),
            "class_eligs": np.ones((b, n_cls), bool),
            "host_masks": np.ones((b, n), bool),
            "lane_mask": np.ones((b,), bool),
        }

    shapes = bench_jobs()
    plain = [enc.compile(j, j.task_groups[0]) for j, _ in
             (shapes[i % len(shapes)] for i in range(lanes))]
    ops1 = operands(plain)

    mix = feature_jobs() + shapes
    comp2 = []
    for i in range(lanes):
        j, pre = mix[i % len(mix)]
        comp2.append(enc.compile(j, j.task_groups[0],
                                 preemption_enabled=pre))
    ops2 = operands(comp2)
    # Dead lanes.
    ops2["lane_mask"][lanes - 6:] = False
    ops2["host_masks"][lanes - 6:] = False
    # In-flight deltas, some on duplicate rows.
    for lane in range(0, lanes, 5):
        k = int(rng.integers(1, 8))
        rows = rng.integers(0, min(n, 64), k)
        rows[-1] = rows[0]
        ops2["delta_rows"][lane, :k] = rows
        ops2["delta_vals"][lane, :k] = rng.integers(50, 400, (k, 3))
    # Collisions: lanes restricted to three nearly full nodes.
    host = m.snapshot_host()
    hot = np.array([11, 12, 13])
    collide = list(range(lanes // 2, min(lanes // 2 + 12, lanes - 6)))
    for lane in collide:
        ops2["host_masks"][lane] = False
        ops2["host_masks"][lane, hot] = True
    ask_max = max(float(np.asarray(comp2[l].request.ask)[0]) for l in collide)
    with m._host_lock:
        for r in hot:
            host["used"][r] = host["totals"][r] - np.float32(1.5 * ask_max)
            m._mark_dirty_locked(int(r))
    # Existing allocs of the lane's own job (anti-affinity) and penalties.
    ops2["tg_counts"][::3, 100:140] = 1
    ops2["penalties"][1::4, 200:260] = True
    # Re-sync after the collision rows changed, then rebuild both batches on
    # the fresh snapshot.
    arrays = m.sync(device)
    return Batch(arrays, ops1, device), Batch(arrays, ops2, device)


# ---------------------------------------------------------------------------
# Comparison and bounds
# ---------------------------------------------------------------------------


def compare(got, want, width: int):
    """(ok, max_abs_err, message) under the parity contract."""
    got = np.asarray(got)
    want = np.asarray(want)
    if got.shape != want.shape:
        return False, float("inf"), f"shape {got.shape} != {want.shape}"
    exact = [0, 3, 4, 5, 6] + ([7] if width == 8 else [])
    bad = np.argwhere(np.any(got[..., exact] != want[..., exact], axis=-1))
    err = float(np.max(np.abs(got[..., 1:3] - want[..., 1:3]))) if got.size else 0.0
    close = np.allclose(got[..., 1:3], want[..., 1:3], rtol=RTOL, atol=ATOL)
    if len(bad):
        lane, step = bad[0]
        return False, err, (
            f"{len(bad)} lane-steps differ in exact columns; first lane "
            f"{lane} step {step}: kernel {got[lane, step].tolist()} plain "
            f"{want[lane, step].tolist()}"
        )
    if not close:
        return False, err, f"scores/binpack outside rtol {RTOL} atol {ATOL}"
    return True, err, "ok"


# Float32 operations of the fused_place kernel body (csrc/fused_place.cu)
# for one node, by term.  Only float arithmetic and float compares count:
# the integer compares, selects and bit tests (hash predicates, device and
# port checks, class eligibility, masks) have no rate in the card's
# published table, and leaving them out keeps the bound a lower bound.
FIT_OPS = 24  # u + ask (3), fits (3), 1 - u/max(t, 1) (6), exp2 args (2),
#               exp2f (2), sum (1), two clamps (6), x (1/18) (1)
ANTI_AFFINITY_OPS = 4  # coll > 0, coll + 1, negate, / desired_count
NUMERIC_PREDICATE_OPS = 3  # v < want, v > want, v == want
AFFINITY_SLOT_OPS = 2  # match x weight, running sum
AFFINITY_TAIL_OPS = 4  # total != 0, wsum > 0, max(wsum, 1e-9), divide
SPREAD_VALUE_OPS = 2  # isnan(desired), desired sum, per value table entry
SPREAD_STEP_OPS = 6  # even or targeted score of the node's count, sum
PREEMPT_BUCKET_OPS = 10  # three prefix sums, three presence compares,
#                          the bucket midpoint (add, mul), max, sum
PREEMPT_TAIL_OPS = 18  # usable (3), fits without victims (6), net (4),
#                        logistic (5)
COMBINE_OPS = 11  # five component adds, five count adds, total / count


def _is_numeric(op: int) -> bool:
    return 2 <= op <= 5 or op >= 8


class LaneTerms:
    """What one lane's request makes a kernel read and compute: the
    attribute slots it refers to (hash, numeric, version), the port words
    of its static ports, its numeric constraint count, and its float32
    operations for a scored node, for the winner row, and per node and
    step (the spread term and the argmax compare)."""

    def __init__(self, reqs, lane: int, f):
        from nomad_tpu_torch.ops.encode import MAX_SPREAD_VALUES
        from nomad_tpu_torch.state.matrix import PRIORITY_BUCKETS

        self.slots, self.num_slots, self.ver_slots = set(), set(), set()
        self.words = set()
        c_slot, c_op = reqs.c_slot[lane], reqs.c_op[lane]
        a_slot, a_op = reqs.a_slot[lane], reqs.a_op[lane]
        s_slot = reqs.s_slot[lane]
        if int(reqs.dc_hash[lane][0]) != -1:
            self.slots.add(0)
        for slot, op in list(zip(c_slot, c_op))[:f.c_width] + list(
                zip(a_slot, a_op))[:f.a_width]:
            if slot < 0:
                continue
            self.slots.add(int(slot))
            if 2 <= op <= 5:
                self.num_slots.add(int(slot))
            elif op >= 8:
                self.ver_slots.add(int(slot))
        live_s = [int(s) for s in s_slot[:f.s_width] if s >= 0]
        self.slots.update(live_s)
        if f.ports:
            self.words.update(int(p) >> 5 for p in reqs.p_static[lane]
                              if p >= 0)
        kb = int(np.clip(reqs.preempt_bucket[lane], 0, PRIORITY_BUCKETS))
        pre = f.preempt and int(reqs.preempt_bucket[lane]) >= 0

        self.c_num = sum(_is_numeric(int(o)) for s, o in zip(
            c_slot[:f.c_width], c_op[:f.c_width]) if s >= 0)
        a_live = [(s, o) for s, o in zip(a_slot[:f.a_width], a_op[:f.a_width])
                  if s >= 0]
        self.winner = (FIT_OPS + ANTI_AFFINITY_OPS + COMBINE_OPS
                       + (PREEMPT_TAIL_OPS if pre else 0))
        self.scored = (self.winner + (PREEMPT_BUCKET_OPS * kb if pre else 0)
                       + sum(AFFINITY_SLOT_OPS
                             + NUMERIC_PREDICATE_OPS * _is_numeric(int(o))
                             for _, o in a_live)
                       + (AFFINITY_TAIL_OPS if a_live else 0)
                       + SPREAD_VALUE_OPS * MAX_SPREAD_VALUES * len(live_s))
        self.step = 1 + (SPREAD_STEP_OPS * len(live_s) + 3 if live_s else 0)


def matrix_bytes(n: int, reqs, live, f, terms) -> int:
    """Bytes of the matrix columns that the live lanes' ``terms`` refer
    to, each read once over ``n`` rows."""
    from nomad_tpu_torch.state.matrix import PRIORITY_BUCKETS

    slots = set().union(*(t.slots for t in terms))
    num_slots = set().union(*(t.num_slots for t in terms))
    ver_slots = set().union(*(t.ver_slots for t in terms))
    words = set().union(*(t.words for t in terms))
    return n * (
        12 + 12 + 1 + 4  # totals, used, eligible, class_id
        + 4 * len(slots) + 4 * len(num_slots) + 4 * len(ver_slots)
        + (64 if np.any(np.asarray(reqs.dev_ask)[live] > 0) else 0)
        + (4 + 4 * len(words) if f.ports else 0)  # dyn_used, port words
        + (PRIORITY_BUCKETS * 12 if f.preempt else 0)  # prio_used
    )


def fused_place_work(batch: Batch, packed, n_placements: int):
    """(bytes, float32 ops) the fused_place function needs on this batch.

    Bytes: each input read once — matrix columns only where a live lane
    refers to them, the per-lane arrays of live lanes — and the output
    written once.  Operations: what the data needs, not what the kernel
    does.  The numeric constraint predicates are counted once per
    (lane, node).  The other step-invariant terms (fit and binpack,
    preemption state, anti-affinity, affinity, the spread targets, the sum
    of the components) are counted once per (lane, feasible node): a node
    that fails feasibility needs no score.  Each step adds only what the
    carry changes: the spread term of every feasible node and its sum into
    the score, the argmax compare, and the winner row's fit,
    anti-affinity, preemption and score redone.  A lane runs steps until
    its first failed one (the kernel stops there); ``packed`` gives the
    steps and each step's feasible-node count."""
    from nomad_tpu_torch.ops import kernels as k

    arrays, f, reqs = batch.arrays, batch.features, batch.np["reqs"]
    n = int(arrays.used.shape[0])
    live = np.asarray(batch.np["lane_mask"], bool)
    out = np.asarray(packed.cpu())
    rows = out[..., k.PACKED_ROW]
    evaluated = out[..., k.PACKED_EVALUATED].astype(np.int64)

    terms = []
    ops = 0
    for lane in np.flatnonzero(live):
        t = LaneTerms(reqs, lane, f)
        terms.append(t)
        failed = np.flatnonzero(rows[lane, :n_placements] < 0)
        steps = int(failed[0]) + 1 if len(failed) else n_placements
        deltas = int((batch.np["delta_rows"][lane] >= 0).sum())
        ops += (n * NUMERIC_PREDICATE_OPS * t.c_num
                + int(evaluated[lane, 0]) * t.scored
                + int(evaluated[lane, :steps].sum()) * t.step
                + steps * t.winner + 3 * deltas)

    b_live = int(live.sum())
    lane_bytes = b_live * sum(
        v[0].nbytes for name, v in batch.np.items()
        if name not in ("reqs", "lane_mask"))
    lane_bytes += live.nbytes + b_live * (
        batch.t["req_i"][0].numel() + batch.t["req_f"][0].numel()) * 4
    out_bytes = live.shape[0] * n_placements * k.PACKED_WIDTH * 4
    return matrix_bytes(n, reqs, live, f, terms) + lane_bytes + out_bytes, ops


def score_batch_work(arrays, reqs, f, args, packed):
    """(bytes, float32 ops) the score_batch function needs on these
    inputs.  Bytes: the matrix columns the lanes refer to, once; every
    per-lane operand (``args[2:]``: tg counts, spread counts, penalties,
    the packed request, class eligibility, host masks) once; the (B, 7)
    output once.  Operations, as ``fused_place_work`` counts them for one
    step: the numeric constraint predicates on every (lane, node), and
    on every (lane, feasible node) the score terms, the spread term and
    the argmax compare (``packed`` gives each lane's feasible count)."""
    from nomad_tpu_torch.ops import kernels as k

    n = int(arrays.used.shape[0])
    out = np.asarray(packed.cpu())
    evaluated = out[:, k.PACKED_EVALUATED].astype(np.int64)
    b = out.shape[0]
    live = np.ones((b,), bool)
    terms = []
    ops = 0
    for lane in range(b):
        t = LaneTerms(reqs, lane, f)
        terms.append(t)
        ops += (n * NUMERIC_PREDICATE_OPS * t.c_num
                + int(evaluated[lane]) * (t.scored + t.step))
    lane_bytes = sum(a.numel() * a.element_size() for a in args[2:])
    out_bytes = b * k.PACKED_WIDTH * 4
    return matrix_bytes(n, reqs, live, f, terms) + lane_bytes + out_bytes, ops


def verify_work(batch: Batch, packed, n_placements: int, window=None):
    """(bytes, float32 ops) of the cross-lane AllocsFit scan: the rows the
    live lanes' deltas and placements touch (totals and used, 12 bytes
    each), the live lanes' deltas and asks, the packed columns in and out;
    three adds per delta, three adds and three compares per placement.

    With ``window`` (``(lo, hi)``, global rows) it is the windowed launch
    of the node-sharded verify, which decides only rows inside it: it
    reads every pick's and delta's row to find them, but totals, used,
    delta values and asks only for the rows and lanes inside, and does
    the adds and compares only there."""
    from nomad_tpu_torch.ops import kernels as k

    live = np.asarray(batch.np["lane_mask"], bool)
    b = live.shape[0]
    rows = np.asarray(packed.cpu())[..., k.PACKED_ROW][live]
    drows = batch.np["delta_rows"][live]
    lo, hi = window if window is not None else (0, np.inf)

    def inside(r):
        return (r >= lo) & (r < hi)

    touched = np.union1d(rows[(rows >= 0) & inside(rows)],
                         drows[(drows >= 0) & inside(drows)])
    n_deltas = int(((drows >= 0) & inside(drows)).sum())
    n_placed = int(((rows >= 0) & inside(rows)).sum())
    if window is None:
        lanes = int(live.sum())
        delta_bytes = lanes * drows.shape[1] * 16
    else:
        lanes = int(((rows >= 0) & inside(rows)).any(axis=1).sum())
        delta_bytes = drows.size * 4 + n_deltas * 12
    nbytes = (len(touched) * 12 * 2
              + b * n_placements * (k.PACKED_WIDTH + k.FUSED_PACKED_WIDTH) * 4
              + lanes * 3 * 4 + delta_bytes + b)
    ops = 3 * n_deltas + 6 * n_placed
    return nbytes, ops


def sharded_usage_work(rows, n_local: int, row_offset: int):
    """(bytes, float32 ops) of the sharded step's usage update on one
    shard of ``n_local`` rows from ``row_offset``: every pick's row read
    once (4 bytes), the asks of the picks inside the window (12 bytes
    each), the shard's usage in and out (12 bytes a row each way); three
    adds per pick inside."""
    rows = np.asarray(rows)
    mine = int(((rows >= row_offset) & (rows < row_offset + n_local)).sum())
    return rows.size * 4 + mine * 12 + n_local * 24, 3 * mine


def system_feasible_work(arrays, req, n_classes: int):
    """(bytes, float32 ops) the system_feasible function needs for one
    request.  Every row needs its eligible bit, host-mask byte, totals,
    base usage and two output bytes; only an eligible row needs the rest
    of the feasibility columns the request refers to (class id, the
    attribute columns of its datacenter list and constraints, the asked
    device slots, ``dyn_used`` and the port words of its static ports).
    Operations: the fit's three adds and three compares on every row, and
    three float compares per numeric or version constraint on each
    eligible row; integer work has no rate in the card's table."""
    from nomad_tpu_torch.ops import kernels as k

    n = int(arrays.used.shape[0])
    n_elig = int(arrays.eligible.sum())
    hash_slots, num_slots, ver_slots = set(), set(), set()
    if int(req.dc_hash[0]) != -1:
        hash_slots.add(0)
    n_numeric = 0
    for slot, op in zip(req.c_slot, req.c_op):
        if slot < 0:
            continue
        hash_slots.add(int(slot))
        if 2 <= op <= 5:
            num_slots.add(int(slot))
        elif op >= 8:
            ver_slots.add(int(slot))
        n_numeric += _is_numeric(int(op))
    words = {int(p) >> 5 for p in req.p_static if p >= 0}
    per_row = 1 + 1 + 12 + 12 + 2
    per_elig = (4 + 4 * (len(hash_slots) + len(num_slots) + len(ver_slots))
                + 8 * int((np.asarray(req.dev_ask) > 0).sum())
                + 4 + 4 * len(words))
    req_bytes = (k.REQ_INT_WIDTH + k.REQ_FLOAT_WIDTH) * 4
    nbytes = n * per_row + n_elig * per_elig + n_classes + req_bytes
    ops = 6 * n + 3 * n_numeric * n_elig
    return nbytes, ops


def bound(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_cuda(fn, runs: int, warmup: int = 2) -> float:
    """Median milliseconds of ``fn`` over ``runs`` launches, CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
            enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_build(card: str) -> float:
    from nomad_tpu_torch.ops import build

    secs = build.build_all()
    log(f"build: {len(build.KERNELS)} kernels in {secs:.3f} s "
        f"(card: {card})")
    for name, report in build.ptxas_report.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  ptxas {name}: {line.strip()}")
    return secs


def _sync() -> None:
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def phase_kernels(batches, results: dict) -> None:
    from nomad_tpu_torch.ops import kernels as k

    for label, batch in zip(("bench-shapes", "features"), batches):
        args = batch.args()
        kern = k.fused_place(*args, SCAN, batch.features)
        plain = k.place_lanes(*args, SCAN, batch.features)
        _sync()
        ok, err, msg = compare(kern.cpu(), plain.cpu(), k.PACKED_WIDTH)
        r = results.setdefault("fused_place", {"max_abs_err": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        log(f"kernels[{label}] fused_place vs plain: {msg} "
            f"(max |err| {err:.3g})")
        if not ok:
            raise AssertionError(f"fused_place disagrees on {label}: {msg}")

        t = batch.t
        vk = k.allocs_fit_verify(batch.arrays.totals, batch.arrays.used, kern,
                                 t["req_f"], t["delta_rows"],
                                 t["delta_vals"], t["lane_mask"])
        vp = k.verify_lanes(batch.arrays.totals, batch.arrays.used, kern,
                            t["req_f"], t["delta_rows"], t["delta_vals"],
                            t["lane_mask"])
        _sync()
        ok, err, msg = compare(vk.cpu(), vp.cpu(), k.FUSED_PACKED_WIDTH)
        r = results.setdefault("allocs_fit_verify", {"max_abs_err": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        verified = vk.cpu().numpy()[..., k.FUSED_PACKED_VERIFIED]
        rows = vk.cpu().numpy()[..., k.PACKED_ROW]
        zeros = int(((verified == 0.0) & (rows >= 0)).sum())
        log(f"kernels[{label}] allocs_fit_verify vs plain: {msg}; "
            f"VERIFIED 0.0 on {zeros} placements")
        if not ok:
            raise AssertionError(f"allocs_fit_verify disagrees on {label}: {msg}")
        if label == "features" and zeros == 0:
            raise AssertionError("collision batch produced no VERIFIED 0.0")
        placed = int((rows >= 0).sum())
        if placed == 0:
            raise AssertionError(f"{label}: nothing placed")
        # The whole fused entry against the whole plain version.
        full_k = k.fused_place_batch(*args, SCAN, batch.features)
        full_p = k.verify_lanes(
            batch.arrays.totals, batch.arrays.used,
            k.place_lanes(*args, SCAN, batch.features), t["req_f"],
            t["delta_rows"], t["delta_vals"], t["lane_mask"])
        ok, err, msg = compare(full_k.cpu(), full_p.cpu(), k.FUSED_PACKED_WIDTH)
        log(f"kernels[{label}] fused_place_batch vs plain: {msg}; "
            f"{placed} placements")
        if not ok:
            raise AssertionError(f"fused_place_batch disagrees on {label}: {msg}")
    for name in ("fused_place", "allocs_fit_verify"):
        results[name]["matches_plain"] = True


def phase_solo(batch: Batch, results: dict) -> None:
    """The stack's solo path at the main path's width: ``place_task_group``
    (fused_place at B=1) over the dense usage ``_dense_used0`` folds
    SOLO_DELTAS plan deltas into, against the plain version on the same
    inputs, lane by lane, under the full contract."""
    import torch

    from nomad_tpu_torch.ops import kernels as k
    from nomad_tpu_torch.ops.encode import SchedRequest
    from nomad_tpu_torch.scheduler.coalescer import MAX_DELTA_ROWS
    from nomad_tpu_torch.scheduler.stack import _dense_used0

    rng = np.random.default_rng(11)
    arrays, t, reqs = batch.arrays, batch.t, batch.np["reqs"]
    dev = arrays.used.device
    # Half the deltas on rows the batch picks first, so they move the
    # picks; the rest on random rows.
    picked = k.fused_place(*batch.args(), SCAN, batch.features).cpu().numpy()
    picked = picked[..., k.PACKED_ROW]
    hot = np.unique(picked[picked >= 0].astype(np.int64))[: SOLO_DELTAS // 2]
    nodes = np.flatnonzero(arrays.eligible.cpu().numpy())
    rest = rng.choice(np.setdiff1d(nodes, hot),
                      SOLO_DELTAS - len(hot), replace=False)
    deltas = {int(r): rng.integers(50, 400, 3).astype(np.float32)
              for r in np.concatenate([hot, rest])}
    if len(deltas) <= MAX_DELTA_ROWS:
        raise AssertionError(f"solo case has only {len(deltas)} deltas")
    used0 = _dense_used0(arrays, deltas)
    want0 = arrays.used.cpu().clone()
    for r, d in deltas.items():
        want0[r] += torch.from_numpy(d)
    if not torch.equal(used0.cpu(), want0):
        raise AssertionError("_dense_used0 differs from the row-by-row sum")

    err_max = 0.0
    for lane in SOLO_LANES:
        req = SchedRequest(*[np.asarray(f)[lane] for f in reqs])
        res = k.place_task_group(
            arrays, req, used0, t["tg_counts"][lane], t["spread_counts"][lane],
            t["penalties"][lane], t["class_eligs"][lane], t["host_masks"][lane],
            SCAN, batch.features)
        got = np.stack([res.rows, res.scores, res.binpack, res.preempted,
                        res.nodes_evaluated, res.nodes_filtered,
                        res.nodes_exhausted], axis=-1).astype(np.float32)[None]
        ri, rf = k.pack_requests(
            SchedRequest(*[np.asarray(f)[None] for f in req]))
        one = slice(lane, lane + 1)
        want = k.place_lanes(
            arrays, used0, torch.full((1, 1), -1, dtype=torch.int32, device=dev),
            torch.zeros((1, 1, 3), dtype=torch.float32, device=dev),
            t["tg_counts"][one], t["spread_counts"][one], t["penalties"][one],
            torch.from_numpy(ri).to(dev), torch.from_numpy(rf).to(dev),
            t["class_eligs"][one], t["host_masks"][one],
            torch.ones((1,), dtype=torch.bool, device=dev), SCAN,
            batch.features)
        ok, err, msg = compare(got, want.cpu(), k.PACKED_WIDTH)
        err_max = max(err_max, err)
        placed = int((res.rows >= 0).sum())
        log(f"kernels[solo lane {lane}] place_task_group vs plain over "
            f"{len(deltas)} deltas: {msg}; {placed} placements")
        if not ok:
            raise AssertionError(f"solo lane {lane} disagrees: {msg}")
        if placed == 0:
            raise AssertionError(f"solo lane {lane}: nothing placed")
    r = results["fused_place"]
    r["max_abs_err"] = max(r["max_abs_err"], err_max)


def phase_place_batch(batches, card: str, results: dict) -> None:
    """K2, the staged dispatch: ``place_batch`` (``fused_place.cu`` with
    every lane live, at full features as the staged path runs it) against
    ``place_batch_plain`` on both batches, under the full contract; the
    feature batch's last six lanes are padding (all-False host masks).  On
    live lanes it must also equal ``fused_place``'s output exactly.  Then,
    on the bench batch: its CUDA-event time, device time (profiler), plain
    time and bound, beside ``fused_place``'s at the same features."""
    from nomad_tpu_torch.ops import kernels as k

    full = k.FULL_FEATURES
    r = results.setdefault("place_batch", {"max_abs_err": 0.0})
    for label, batch in zip(("bench-shapes", "features"), batches):
        args = batch.args()[:-1]
        kern = k.place_batch(*args, SCAN)
        plain = k.place_batch_plain(*args, SCAN)
        fused = k.fused_place(*batch.args(), SCAN, full)
        _sync()
        ok, err, msg = compare(kern.cpu(), plain.cpu(), k.PACKED_WIDTH)
        r["max_abs_err"] = max(r["max_abs_err"], err)
        live = batch.np["lane_mask"]
        pad = ~batch.np["host_masks"].any(axis=1)
        got = kern.cpu().numpy()
        same_live = np.array_equal(got[live], fused.cpu().numpy()[live])
        pad_rows = got[pad][..., k.PACKED_ROW]
        log(f"kernels[{label}] place_batch vs plain: {msg} (max |err| "
            f"{err:.3g}); {int((got[..., k.PACKED_ROW] >= 0).sum())} "
            f"placements; live lanes equal fused_place: {same_live}; "
            f"{int(pad.sum())} pad lanes")
        if not ok:
            raise AssertionError(f"place_batch disagrees on {label}: {msg}")
        if not same_live or (pad_rows != -1).any():
            raise AssertionError(f"place_batch on {label}: live lanes differ "
                                 "from fused_place or a pad lane placed")
    r["matches_plain"] = True

    batch = batches[0]
    args = batch.args()[:-1]
    packed = k.place_batch(*args, SCAN)

    def run():
        k.place_batch(*args, SCAN)

    def run_plain():
        k.place_batch_plain(*args, SCAN)

    def run_fused():
        k.fused_place(*batch.args(), SCAN, full)

    ms = time_cuda(run, runs=20)
    fused_ms = time_cuda(run_fused, runs=20)
    dev_us = device_us_per_launch(run, "fused_place_kernel")
    fused_us = device_us_per_launch(run_fused, "fused_place_kernel")
    plain_ms = time_cuda(run_plain, runs=3, warmup=1)
    # The same function of the same inputs as fused_place's (the wider
    # loops of full features add no work these lanes need).
    work = fused_place_work(batch, packed, SCAN)
    b_ms, by = bound(*work)
    r.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
             library_ms=None, device_us=dev_us)
    shape = k.fused_place_shape(int(batch.arrays.used.shape[0]), LANES,
                                batch.t["delta_rows"].shape[1], SCAN, full)
    r["launch"] = shape
    log(f"timing place_batch: {ms:.4f} ms by CUDA events, {fmt_us(dev_us)} "
        f"a launch on the device (profiler); fused_place at the same full "
        f"features {fused_ms:.4f} ms, {fmt_us(fused_us)}; plain version "
        f"{plain_ms:.3f} ms; bound {b_ms:.5f} ms by {by}; {work[0]} bytes, "
        f"{work[1]:.4g} ops; launch {shape} (card: {card})")


def edge_cases_module():
    """``tests/torch_edge_cases.py``: the edge shapes the CPU parity tests
    and the card tests share (it imports neither package itself)."""
    here = str(Path(__file__).resolve().parent / "tests")
    if here not in sys.path:
        sys.path.insert(0, here)
    import torch_edge_cases

    return torch_edge_cases


def edge_case(case):
    """Case ``case`` of ``tests/torch_edge_cases.py``, built with the port
    on the card: (arrays, numpy inputs, tensors on the card)."""
    import torch

    from nomad_tpu_torch.ops import kernels as k

    edge = edge_cases_module()

    w = edge.build(edge.port_pkg(), case)
    arrays = w["m"].sync("cuda")
    ri, rf = k.pack_requests(w["reqs"])
    t = {name: torch.from_numpy(np.ascontiguousarray(w[name])).to("cuda")
         for name in ("drows", "dvals", "tg", "counts", "pen", "ce", "hm",
                      "lane_mask")}
    t["ri"] = torch.from_numpy(ri).to("cuda")
    t["rf"] = torch.from_numpy(rf).to("cuda")
    return arrays, w, t


def phase_edge_shapes(results: dict) -> None:
    """The redesigned kernels on the edge shapes the tiling and the hoisted
    scan make risky (ragged node and lane counts, B=1, ties across node
    tiles and cluster CTAs, spread tables with duplicate hashes filled
    mid-scan, s_width=2, lanes that fail at step 0): fused_place at the
    case's own widths, place_batch at full widths and score_batch at both,
    each against its plain version under the full contract, with the
    launch shape each took."""
    from nomad_tpu_torch.ops import kernels as k

    edge = edge_cases_module()

    for case in edge.CASES:
        arrays, w, t = edge_case(case)
        n, b = int(arrays.used.shape[0]), int(t["ri"].shape[0])
        own = k.features_of(w["reqs"])
        args = (arrays, arrays.used, t["drows"], t["dvals"], t["tg"],
                t["counts"], t["pen"], t["ri"], t["rf"], t["ce"], t["hm"])
        checks = (
            ("fused_place", own, k.fused_place(*args, t["lane_mask"],
                                               w["scan"], own),
             k.place_lanes(*args, t["lane_mask"], w["scan"], own),
             k.fused_place_shape(n, b, w["drows"].shape[1], w["scan"], own)),
            ("place_batch", k.FULL_FEATURES, k.place_batch(*args, w["scan"]),
             k.place_batch_plain(*args, w["scan"]),
             k.fused_place_shape(n, b, w["drows"].shape[1], w["scan"],
                                 k.FULL_FEATURES)),
        )
        sb = (arrays, arrays.used, t["tg"], t["counts"], t["pen"], t["ri"],
              t["rf"], t["ce"], t["hm"])
        for f in (own, k.FULL_FEATURES):
            checks += (("score_batch", f,
                        k.pack_batch_result(k.score_batch(*sb, f))[:, None],
                        k.pack_batch_result(k.score_batch_plain(*sb, f))[:, None],
                        k.score_batch_shape(n, b, f)),)
        _sync()
        for name, f, got, want, shape in checks:
            ok, err, msg = compare(got.cpu(), want.cpu(), k.PACKED_WIDTH)
            r = results.setdefault(name, {"max_abs_err": 0.0})
            r["max_abs_err"] = max(r["max_abs_err"], err)
            log(f"edge[{case}] {name} at {tuple(f)} vs plain: {msg} (max "
                f"|err| {err:.3g}); N={n}, B={b}; launch {shape}")
            if not ok:
                raise AssertionError(f"{name} disagrees on edge case {case}: "
                                     f"{msg}")
    check_past_shared_memory(results)
    check_verify_cases(results)
    check_system_rows(results)


def verify_operands(case: str):
    """Case ``case`` of ``torch_edge_cases.VERIFY_CASES`` as the seven
    operands of ``allocs_fit_verify`` on the card."""
    import torch

    from nomad_tpu_torch.ops import kernels as k

    w = edge_cases_module().verify_case(case)
    b = w["asks"].shape[0]
    req_f = np.zeros((b, k.REQ_FLOAT_WIDTH), np.float32)
    off = k.REQ_FLOAT_OFF["ask"][0]
    req_f[:, off:off + 3] = w["asks"]
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to("cuda")
                 for x in (w["totals"], w["used"], w["packed"], req_f,
                           w["drows"], w["dvals"], w["lane_mask"]))


def check_verify_cases(results: dict) -> None:
    """``allocs_fit_verify`` on the event streams of
    ``torch_edge_cases.VERIFY_CASES`` (the bench batch's sizes, one hot row
    picked by every lane, B=64 with 1,024 delta rows a lane, B=1, every
    lane dead, order-sensitive values with rows out of range): every
    column exactly as ``verify_lanes``'s, each in the tier its event count
    calls for.  Both tiers must launch: the large case keeps its event
    keys in device scratch, the others in shared memory."""
    from nomad_tpu_torch.ops import kernels as k

    tiers = set()
    r = results.setdefault("allocs_fit_verify", {"max_abs_err": 0.0})
    for case in edge_cases_module().VERIFY_CASES:
        ops = verify_operands(case)
        n, (b, p, _), d = ops[0].shape[0], ops[2].shape, ops[4].shape[1]
        plan = k.allocs_fit_verify_shape(n, b, p, d)
        before = k.allocs_fit_verify.launches
        got = k.allocs_fit_verify(*ops)
        _sync()
        if k.allocs_fit_verify.launches != before + 1:
            raise AssertionError(f"allocs_fit_verify did not launch on {case}")
        want = k.verify_lanes(*[x.cpu() for x in ops]).numpy()
        got = got.cpu().numpy()
        err = float(np.abs(got - want).max())
        r["max_abs_err"] = max(r["max_abs_err"], err)
        zeros = int((want[..., k.FUSED_PACKED_VERIFIED] == 0.0).sum())
        log(f"edge[verify {case}] allocs_fit_verify vs plain: max |err| "
            f"{err:.3g}, {'equal' if np.array_equal(got, want) else 'DIFFERENT'}"
            f"; B={b}, P={p}, D={d}, N={n}; VERIFIED 0.0 on {zeros} "
            f"placements; plan {plan}")
        if not np.array_equal(got, want):
            raise AssertionError(f"allocs_fit_verify disagrees on {case}")
        if plan["tier"] != (1 if case == "large" else 0):
            raise AssertionError(f"allocs_fit_verify on {case}: tier {plan}")
        tiers.add(plan["tier"])
    if tiers != {0, 1}:
        raise AssertionError(f"allocs_fit_verify tiers launched: {tiers}")


def check_system_rows(results: dict) -> None:
    """``system_feasible`` at the node counts of
    ``torch_edge_cases.SYSTEM_ROWS`` (1 to 80,000 rows, ragged ones
    included) on every request of ``system_case`` (every constraint kind,
    all sixteen slots, a datacenter list, a device ask, a static port, an
    exhausting ask, an escaped class with a host mask): both rows exactly
    as the plain version's, every byte 0 or 1."""
    import torch

    from nomad_tpu_torch.ops import kernels as k

    edge = edge_cases_module()
    r = results.setdefault("system_feasible", {"max_abs_err": 0.0})
    for n in edge.SYSTEM_ROWS:
        w = edge.system_case(edge.port_pkg(), n)
        arrays = edge.first_rows(w["m"].sync("cuda"), n)
        feasible = []
        for label, req, class_elig, host_mask in w["reqs"]:
            ri, rf = k.pack_request(req, "cuda")
            ce = torch.from_numpy(class_elig).to("cuda")
            hm = torch.from_numpy(host_mask[:n].copy()).to("cuda")
            got = k.system_feasible(arrays, arrays.used, ri, rf, ce, hm)
            want = k.system_feasible_plain(arrays, arrays.used, ri, rf, ce, hm)
            _sync()
            diff = (got.cpu().to(torch.int32) - want.cpu().to(torch.int32))
            err = float(diff.abs().max())
            r["max_abs_err"] = max(r.get("max_abs_err", 0.0), err)
            if int(got.view(torch.uint8).max()) > 1:
                raise AssertionError(f"system rows {n} {label}: a byte not 0/1")
            if not torch.equal(got.cpu(), want.cpu()):
                raise AssertionError(f"system_feasible disagrees at N={n} on "
                                     f"{label}")
            feasible.append(int(want[0].sum()))
        log(f"edge[system N={n}] system_feasible vs plain: equal on "
            f"{len(w['reqs'])} requests; feasible {feasible}")


def check_past_shared_memory(results: dict) -> None:
    """At LARGE_ROWS rows a lane's candidate state no longer fits its
    cluster's shared memory and ``fused_place`` keeps it in device scratch,
    in the same kernel: on both batches (built as phase 2's, LARGE_LANES
    lanes), ``fused_place`` at the batch's widths, ``place_batch`` at full
    widths and ``score_batch`` against their plain versions under the full
    contract.  Fails if the launch shape keeps the state in shared memory."""
    from nomad_tpu_torch.ops import kernels as k

    m = build_cluster(LARGE_ROWS, LARGE_ROWS, "cuda")
    for label, batch in zip(("bench", "features"),
                            make_batches(m, "cuda", lanes=LARGE_LANES)):
        a = batch.args()
        n, b, d = int(a[1].shape[0]), int(a[7].shape[0]), int(a[2].shape[1])
        own = batch.features
        sb = a[:2] + a[4:11]
        checks = (
            ("fused_place", own, k.fused_place(*a, SCAN, own),
             k.place_lanes(*a, SCAN, own),
             k.fused_place_shape(n, b, d, SCAN, own)),
            ("place_batch", k.FULL_FEATURES, k.place_batch(*a[:11], SCAN),
             k.place_batch_plain(*a[:11], SCAN),
             k.fused_place_shape(n, b, d, SCAN, k.FULL_FEATURES)),
            ("score_batch", own,
             k.pack_batch_result(k.score_batch(*sb, own))[:, None],
             k.pack_batch_result(k.score_batch_plain(*sb, own))[:, None],
             k.score_batch_shape(n, b, own)),
        )
        _sync()
        for name, f, got, want, shape in checks:
            if name != "score_batch" and shape["state_in_smem"]:
                raise AssertionError(f"{name} at N={n} kept its state in "
                                     f"shared memory: {shape}")
            ok, err, msg = compare(got.cpu(), want.cpu(), k.PACKED_WIDTH)
            r = results.setdefault(name, {"max_abs_err": 0.0})
            r["max_abs_err"] = max(r["max_abs_err"], err)
            log(f"past shared memory [{label}] {name} at {tuple(f)} vs plain: "
                f"{msg} (max |err| {err:.3g}); N={n}, B={b}; launch {shape}")
            if not ok:
                raise AssertionError(f"{name} disagrees at N={n} "
                                     f"({label} batch): {msg}")


def system_jobs():
    """The two system jobs of the server phase."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.structs.types import Constraint, NetworkResource

    exporter = mock.system_job()
    exporter.id = exporter.name = "node-exporter"
    exporter.datacenters = list(DATACENTERS)
    exporter.task_groups[0].tasks[0].resources.networks = [
        NetworkResource(reserved_ports=[SYSTEM_PORT])]
    shipper = mock.system_job()
    shipper.id = shipper.name = "log-shipper"
    shipper.datacenters = ["dc1"]
    shipper.task_groups[0].constraints = [Constraint(
        l_target="${node.class}", operand="!=", r_target="class-3")]
    return exporter, shipper


def system_cases(m, arrays):
    """(label, request, class_elig, host_mask, plan deltas) for the kernel
    phase: the shapes a system eval can hand ``system_feasible``."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.ops.encode import RequestEncoder, pow2_bucket
    from nomad_tpu_torch.structs.types import Constraint, RequestedDevice

    rng = np.random.default_rng(17)
    enc = RequestEncoder(m)
    n = int(arrays.used.shape[0])
    k_cls = pow2_bucket(max(1, len(m.class_ids)))
    exporter, shipper = system_jobs()

    def variant(**kw):
        job = mock.system_job()
        job.datacenters = list(DATACENTERS)
        tg = job.task_groups[0]
        for key, val in kw.items():
            if key in ("cpu", "memory_mb"):
                setattr(tg.tasks[0].resources, key, val)
            elif key == "devices":
                tg.tasks[0].resources.devices = val
            elif key == "datacenters":
                job.datacenters = val
            else:
                setattr(tg, key, val)
        return job

    c = Constraint
    jobs = [
        ("node-exporter", exporter),
        ("log-shipper", shipper),
        ("datacenters", variant(datacenters=["dc2", "dc3"])),
        ("numeric-version", variant(constraints=[
            c(l_target="${attr.os.version}", operand=">=", r_target="20"),
            c(l_target="${attr.os.version}", operand="version",
              r_target=">= 22.0"),
            c(l_target="${attr.rack}", operand="!=", r_target="r3")])),
        ("presence", variant(constraints=[
            c(l_target="${attr.platform.tpu.type}", operand="is_set"),
            c(l_target="${attr.gpu.model}", operand="is_not_set"),
            c(l_target="${attr.platform.tpu.type}", operand="=",
              r_target="v5e")])),
        # rack values ("r7") parse to NaN: every ordered compare fails.
        ("nan-column", variant(constraints=[
            c(l_target="${attr.rack}", operand="<", r_target="100")])),
        ("device", variant(devices=[RequestedDevice(name="gpu", count=2)])),
        ("escaped-class-host-mask", variant()),
        ("signed-deltas", variant(cpu=900, memory_mb=1024)),
        ("exhausting", variant(cpu=3000, memory_mb=4000)),
    ]
    out = []
    for label, job in jobs:
        req = enc.compile(job, job.task_groups[0]).request
        class_elig = np.ones((k_cls,), bool)
        host_mask = np.ones((n,), bool)
        deltas = {}
        if label == "escaped-class-host-mask":
            # Four entries for more class ids than that: the ids past the
            # end read the last entry.
            class_elig = np.array([True, False, True, True])
            host_mask[::17] = False
        if label == "signed-deltas":
            rows = rng.choice(N_NODES, N_NODES // 8, replace=False)
            half = len(rows) // 2
            for r in rows[:half]:  # this job's own allocs, subtracted
                deltas[int(r)] = -np.array([900, 1024, 0], np.float32)
            for r in rows[half:]:  # other placements in the plan
                deltas[int(r)] = rng.integers(100, 3000, 3).astype(np.float32)
        out.append((label, req, class_elig, host_mask, deltas))
    return out


def phase_system_kernel(m, results: dict) -> None:
    """system_feasible against its plain version at N=10240 on every
    request of ``system_cases``: both rows exactly equal, every output
    byte 0 or 1."""
    import torch

    from nomad_tpu_torch.ops import kernels as k
    from nomad_tpu_torch.scheduler.stack import _dense_used0

    arrays = m.sync("cuda")
    dev = arrays.used.device
    err = 0.0
    for label, req, class_elig, host_mask, deltas in system_cases(m, arrays):
        used0 = _dense_used0(arrays, deltas)
        ri, rf = k.pack_request(req, dev)
        ce = torch.from_numpy(class_elig).to(dev)
        hm = torch.from_numpy(host_mask).to(dev)
        got = k.system_feasible(arrays, used0, ri, rf, ce, hm)
        want = k.system_feasible_plain(arrays, used0, ri, rf, ce, hm)
        _sync()
        raw = got.view(torch.uint8).cpu()
        got, want = got.cpu(), want.cpu()
        diff = (got.to(torch.int32) - want.to(torch.int32)).abs()
        err = max(err, float(diff.max()))
        mask, fits = want[0], want[1]
        log(f"kernels[system {label}] system_feasible vs plain: "
            f"{int((diff != 0).sum())} entries differ; feasible "
            f"{int(mask.sum())}, fit {int(fits.sum())}, exhausted "
            f"{int((mask & ~fits).sum())} of {mask.shape[0]} rows, "
            f"{len(deltas)} deltas")
        if int(raw.max()) > 1:
            raise AssertionError(f"system {label}: an output byte is not 0/1")
        if not torch.equal(got, want):
            raise AssertionError(f"system_feasible disagrees on {label}")
    r = results.setdefault("system_feasible", {"max_abs_err": 0.0})
    r["max_abs_err"] = max(r["max_abs_err"], err)
    r["matches_plain"] = True


def server_config():
    """The server phases' config: 32 workers, 64 lanes, long heartbeat TTLs
    (the smoke plays no client heartbeats, and marks nodes down itself
    through the RPC that heartbeat expiry calls)."""
    from nomad_tpu_torch.server.server import ServerConfig

    return ServerConfig(num_workers=SERVER_WORKERS, coalescer_lanes=LANES,
                        node_capacity=CAPACITY, heartbeat_min_ttl=3600.0,
                        heartbeat_max_ttl=7200.0)


def register_cluster(srv, label: str, preload: bool = True) -> dict:
    """Register the server phases' 10,000 nodes and, with ``preload``,
    pre-load their usage (seeded, written into the matrix, so not
    journaled); returns node id -> (datacenter, class)."""
    rng = np.random.default_rng(7)
    t0 = time.perf_counter()
    specs = {}
    for i in range(N_NODES):
        node = server_node(i)
        specs[node.id] = (node.datacenter, node.node_class)
        srv.register_node(node)
    if not preload:
        log(f"{label}: {N_NODES} nodes registered in "
            f"{time.perf_counter() - t0:.2f} s")
        return specs
    with srv.matrix._host_lock:
        host = srv.matrix.snapshot_host()
        usage = np.round(rng.uniform(0.1, 0.6, (N_NODES, 3))
                         * host["totals"][:N_NODES])
        host["used"][:N_NODES] = usage
        srv.matrix._dirty.update(range(N_NODES))
        srv.matrix.version += 1
    log(f"{label}: {N_NODES} nodes registered in "
        f"{time.perf_counter() - t0:.2f} s")
    return specs


def service_job(i: int):
    """The service bursts' i-th job: count 2 over the four datacenters."""
    from nomad_tpu_torch import mock

    job = mock.job()
    job.datacenters = list(DATACENTERS)
    tg = job.task_groups[0]
    tg.count = SERVER_COUNT
    tg.tasks[0].resources.cpu = 50 + 25 * (i % 4)
    tg.tasks[0].resources.memory_mb = 64 + 32 * (i % 3)
    return job


def check_burst(srv, evals, label: str, n_jobs: int = SERVER_JOBS) -> dict:
    """Every job of a service burst (``n_jobs`` of them) holds exactly
    SERVER_COUNT allocs, each on a registered node whose usage fits its
    capacity; returns the burst's counts."""
    statuses = {srv.store.eval_by_id(e.id).status for e in evals}
    allocs = [a for a in srv.store.allocs.values()
              if not a.terminal_status()]
    want = n_jobs * SERVER_COUNT
    if len(allocs) != want:
        raise AssertionError(f"{label}: {len(allocs)} allocations, "
                             f"expected {want}")
    host = srv.matrix.snapshot_host()
    per_job = {}
    for a in allocs:
        row = srv.matrix.row_of.get(a.node_id)
        if row is None or srv.store.node_by_id(a.node_id) is None:
            raise AssertionError(f"alloc {a.id} on unknown node {a.node_id}")
        if not np.all(host["used"][row] <= host["totals"][row]):
            raise AssertionError(f"node row {row} over capacity")
        per_job[a.job_id] = per_job.get(a.job_id, 0) + 1
    if sorted(set(per_job.values())) != [SERVER_COUNT]:
        raise AssertionError(f"{label}: allocs per job "
                             f"{sorted(set(per_job.values()))}")
    return {"allocs": len(allocs), "statuses": sorted(statuses),
            "retried": retried_evals(srv, evals)}


def phase_server(card: str, results: dict, recorder) -> None:
    from nomad_tpu_torch.ops import kernels as k
    from nomad_tpu_torch.server.server import Server

    srv = Server(server_config(), device="cuda")
    srv.start()
    try:
        specs = register_cluster(srv, "server")
        k.reset_counts()
        refused0 = srv.plan_applier.nodes_refused
        evals, elapsed = burst(srv, [service_job(i) for i in range(SERVER_JOBS)])
        launches = {
            "fused_place": k.fused_place.launches,
            "allocs_fit_verify": k.allocs_fit_verify.launches,
            "place_batch": k.place_batch.launches,
            "plain": k.place_lanes.calls + k.verify_lanes.calls,
        }
        refused = srv.plan_applier.nodes_refused - refused0
        counts = check_burst(srv, evals, "server")
        log(f"server: {SERVER_JOBS} jobs x {SERVER_COUNT} in {elapsed:.3f} s = "
            f"{SERVER_JOBS / elapsed:.1f} evals/s, {counts['allocs']} "
            f"allocations, eval statuses {counts['statuses']} "
            f"({counts['retried']} retried after placement conflicts), "
            f"{refused} node placements refused by the applier, "
            f"{srv.coalescer.dispatches} dispatches / "
            f"{srv.coalescer.fused_lanes} lanes (card: {card})")
        log(f"server: launches during the run {launches}")
        if launches["fused_place"] <= 0 or launches["allocs_fit_verify"] <= 0:
            raise AssertionError(f"a kernel never launched: {launches}")
        if launches["plain"] != 0 or launches["place_batch"] != 0:
            raise AssertionError(f"plain version or the staged kernel ran "
                                 f"on the fused path: {launches}")
        results["fused_place"]["launches"] = launches["fused_place"]
        results["allocs_fit_verify"]["launches"] = launches["allocs_fit_verify"]
        results["server"] = {
            "evals_per_s": SERVER_JOBS / elapsed, "seconds": elapsed,
            "dispatches": srv.coalescer.dispatches,
            "lanes": srv.coalescer.fused_lanes, "refused": refused,
            "retried": counts["retried"],
        }
        solo_run(srv, service_job, results)
        trace_burst(srv, [service_job(i) for i in range(SERVER_JOBS)], card)
        system_run(srv, specs, card, results, recorder)
        lifecycle_run(srv, specs, card, results)
    finally:
        srv.shutdown()


def phase_staged_server(card: str, results: dict) -> None:
    """The staged dispatch end to end: a second server built under
    ``NOMAD_TPU_MEGABATCH=0`` over the same 10,000 nodes takes the same
    64-job burst through ``place_batch`` (no verify column, so the applier
    alone judges each pick).  Counts zeroed just before the burst and read
    just after: place_batch launched, the fused kernels and the plain
    versions never."""
    import os

    from nomad_tpu_torch.ops import kernels as k
    from nomad_tpu_torch.server.server import Server

    prev = os.environ.get("NOMAD_TPU_MEGABATCH")
    os.environ["NOMAD_TPU_MEGABATCH"] = "0"
    try:
        srv = Server(server_config(), device="cuda")
    finally:
        if prev is None:
            del os.environ["NOMAD_TPU_MEGABATCH"]
        else:
            os.environ["NOMAD_TPU_MEGABATCH"] = prev
    if srv.coalescer.megabatch:
        raise AssertionError("the staged server's coalescer is fused")
    srv.start()
    try:
        register_cluster(srv, "staged")
        k.reset_counts()
        evals, elapsed = burst(srv, [service_job(i) for i in range(SERVER_JOBS)])
        launches = {
            "place_batch": k.place_batch.launches,
            "fused_place": k.fused_place.launches,
            "allocs_fit_verify": k.allocs_fit_verify.launches,
            "plain": k.place_lanes.calls + k.verify_lanes.calls,
        }
        refused = srv.plan_applier.nodes_refused
        counts = check_burst(srv, evals, "staged")
        plan_retries = sum(1 for e in srv.store.evals.values()
                           if e.triggered_by == "max-plan-attempts")
        log(f"staged: {SERVER_JOBS} jobs x {SERVER_COUNT} in {elapsed:.3f} s "
            f"= {SERVER_JOBS / elapsed:.1f} evals/s, {counts['allocs']} "
            f"allocations, eval statuses {counts['statuses']} "
            f"({counts['retried']} retried after placement conflicts, "
            f"{plan_retries} max-plan-attempts evals), {refused} node "
            f"placements refused by the applier, "
            f"{srv.plan_applier.plans_partial} plans partly or wholly "
            f"refused, {srv.coalescer.dispatches} dispatches / "
            f"{srv.coalescer.coalesced_requests} lanes (card: {card})")
        log(f"staged: launches during the run {launches}")
        if launches["place_batch"] <= 0:
            raise AssertionError(f"place_batch never launched: {launches}")
        if (launches["allocs_fit_verify"] or launches["fused_place"]
                or launches["plain"]):
            raise AssertionError(f"the staged path ran another kernel or "
                                 f"a plain version: {launches}")
        if srv.coalescer.fused_dispatches:
            raise AssertionError("the staged server made a fused dispatch")
        results["place_batch"]["launches"] = launches["place_batch"]
        results["staged_server"] = {
            "evals_per_s": SERVER_JOBS / elapsed, "seconds": elapsed,
            "dispatches": srv.coalescer.dispatches,
            "lanes": srv.coalescer.coalesced_requests, "refused": refused,
            "retried": counts["retried"], "plan_retries": plan_retries,
        }
    finally:
        srv.shutdown()


def server_node(i: int):
    """The server phase's i-th node: four datacenters, six classes."""
    from nomad_tpu_torch import mock

    node = mock.node()
    node.datacenter = DATACENTERS[i % len(DATACENTERS)]
    node.node_class = f"class-{i % 6}"
    node.attributes = dict(node.attributes)
    node.attributes["rack"] = f"r{i % 32}"
    return node


def live_allocs(srv, job_id=None, node_id=None):
    allocs = (srv.store.allocs_by_node(node_id) if node_id is not None
              else list(srv.store.allocs.values()))
    return [a for a in allocs if not a.terminal_status()
            and (job_id is None or a.job_id == job_id)]


def play_client(srv) -> int:
    """Report every pending alloc the scheduler wants running as running
    (what each node's client would do); returns how many."""
    updates = []
    for a in list(srv.store.allocs.values()):
        if a.client_status == "pending" and a.desired_status == "run":
            upd = a.copy()
            upd.client_status = "running"
            updates.append(upd)
    if updates:
        srv.update_allocs_from_client(updates)
    return len(updates)


def wait_quiet(srv, what: str, timeout_s: float = LIFECYCLE_TIMEOUT_S) -> float:
    """Wait until no eval is queued or in flight and every eval in the
    store is terminal or blocked for want of room, three polls in a row;
    returns seconds.  An eval blocked after placement conflicts is still
    open: the server runs it again."""
    t0 = time.perf_counter()
    broker = srv.eval_broker
    quiet = 0
    while quiet < 3:
        if time.perf_counter() - t0 > timeout_s:
            raise AssertionError(f"{what}: evals still open after {timeout_s:.0f} s")
        busy = (broker.ready_count() + broker.unacked_count()
                + broker.pending_count() + broker.delayed_count())
        open_evals = any(not e.terminal_status() and (
            e.status != "blocked" or e.triggered_by == "max-plan-attempts")
            for e in list(srv.store.evals.values()))
        quiet = quiet + 1 if not busy and not open_evals else 0
        time.sleep(0.02)
    return time.perf_counter() - t0


def expect_system(srv, job, want_nodes, label: str) -> None:
    """``job`` holds exactly one live alloc on each node of ``want_nodes``
    and on no other node."""
    allocs = live_allocs(srv, job.id)
    nodes = [a.node_id for a in allocs]
    if len(nodes) != len(set(nodes)):
        raise AssertionError(f"{label}: {job.id} has two allocs on a node")
    if set(nodes) != set(want_nodes):
        raise AssertionError(
            f"{label}: {job.id} on {len(set(nodes))} nodes, expected "
            f"{len(want_nodes)} ({len(set(nodes) - set(want_nodes))} extra, "
            f"{len(set(want_nodes) - set(nodes))} missing)")


def check_capacity(srv, label: str) -> None:
    host = srv.matrix.snapshot_host()
    over = np.flatnonzero(np.any(host["used"] > host["totals"], axis=1))
    if len(over):
        raise AssertionError(f"{label}: {len(over)} node rows over capacity")


def system_run(srv, specs: dict, card: str, results: dict,
               recorder) -> None:
    """The system path on the server phase's 10,000 nodes: two system jobs,
    then 32 joining nodes, 16 drains and 16 nodes down, with every count
    checked exactly.  Launch counts are zeroed just before and read just
    after."""
    from nomad_tpu_torch.ops import kernels as k
    from nomad_tpu_torch.scheduler.system import MAX_SYSTEM_SCHEDULE_ATTEMPTS
    from nomad_tpu_torch.structs.types import DrainStrategy

    exporter, shipper = system_jobs()
    matches = {
        exporter.id: lambda dc, cls: True,
        shipper.id: lambda dc, cls: dc == "dc1" and cls != "class-3",
    }
    placed = {}  # job id -> the nodes that got an alloc at submit

    def wanted(job, gone=()):
        """The nodes ``job`` must hold: those that took it at submit and
        the joined nodes its spec matches (they join empty), less the
        gone ones."""
        joined = {nid for nid, spec in specs.items()
                  if nid in new_nodes and matches[job.id](*spec)}
        return (placed[job.id] | joined) - set(gone)

    evals_before = set(srv.store.evals)
    service_jobs = {a.job_id for a in live_allocs(srv)}
    service_count = {j: len(live_allocs(srv, j)) for j in service_jobs}
    parked = [e for e in srv.store.evals.values() if e.status == "blocked"]
    if parked:
        raise AssertionError(f"{len(parked)} blocked evals before the system "
                             "phase: its service counts would move")
    new_nodes: set = set()
    sched = srv.metrics.timer("nomad.worker.invoke_scheduler")
    sched0 = (sched.count, sched.sum)
    k.reset_counts()
    t_phase = time.perf_counter()

    # 1. Two system jobs on 10,000 nodes, one after the other.  The nodes
    # a job must land on follow from the specs registered and the room
    # each node has for its ask; a node without room is exhausted, which
    # the eval must report and park a blocked eval for.
    results["system_server"] = {}
    for job in (exporter, shipper):
        r = job.task_groups[0].combined_resources()
        ask = np.array([r.cpu, r.memory_mb, r.disk_mb], np.float32)
        with srv.matrix._host_lock:
            host = srv.matrix.snapshot_host()
            room_rows = np.all(host["used"] + ask <= host["totals"], axis=1)
        match = {nid for nid, spec in specs.items() if matches[job.id](*spec)}
        room = {nid for nid in match if room_rows[srv.matrix.row_of[nid]]}
        t0 = time.perf_counter()
        recorder.armed = job is exporter  # phase 8 replays its checks
        ev = srv.submit_job(job)
        while not srv.store.eval_by_id(ev.id).terminal_status():
            if time.perf_counter() - t0 > LIFECYCLE_TIMEOUT_S:
                raise AssertionError(f"{job.id}: eval not terminal in time")
            time.sleep(0.005)
        secs = time.perf_counter() - t0
        recorder.armed = False
        cur = srv.store.eval_by_id(ev.id)
        exhausted = sum(m.nodes_exhausted for m in cur.failed_tg_allocs.values())
        log(f"system: {job.id} eval {cur.status} in {secs:.3f} s (submit -> "
            f"complete), {len(live_allocs(srv, job.id))} allocs on "
            f"{len(match)} matching nodes, {exhausted} exhausted (predicted "
            f"{len(match) - len(room)}), blocked eval "
            f"{bool(cur.blocked_eval)} (card: {card})")
        if cur.status != "complete" or exhausted != len(match) - len(room):
            raise AssertionError(f"{job.id}: eval {cur.status}, "
                                 f"{exhausted} nodes exhausted")
        if bool(cur.blocked_eval) != (exhausted > 0):
            raise AssertionError(f"{job.id}: blocked eval {cur.blocked_eval!r}")
        placed[job.id] = room
        expect_system(srv, job, wanted(job), "submit")
        results["system_server"][f"{job.id}_eval_s"] = secs
    check_capacity(srv, "submit")

    # 2. 32 nodes join: each gets the system allocs its spec calls for.
    t0 = time.perf_counter()
    for i in range(N_NODES, N_NODES + SYSTEM_NEW_NODES):
        node = server_node(i)
        specs[node.id] = (node.datacenter, node.node_class)
        new_nodes.add(node.id)
        srv.register_node(node)
    secs = wait_quiet(srv, "node joins")
    joins = [e for e in srv.store.evals.values()
             if e.id not in evals_before and e.triggered_by == "node-update"]
    log(f"system: {SYSTEM_NEW_NODES} nodes joined, {len(joins)} node-update "
        f"evals done in {time.perf_counter() - t0:.3f} s "
        f"({secs:.3f} s after the last registration)")
    expect_system(srv, exporter, wanted(exporter), "joins")
    expect_system(srv, shipper, wanted(shipper), "joins")
    reported = play_client(srv)
    log(f"system: the client reported {reported} allocs running")

    # 3. Drain 16 nodes that hold service allocs.
    old_nodes = sorted(nid for nid in specs
                       if any(a.job_id in service_jobs
                              for a in live_allocs(srv, node_id=nid)))
    drained = old_nodes[:SYSTEM_DRAINS]
    down = old_nodes[SYSTEM_DRAINS:SYSTEM_DRAINS + SYSTEM_DOWNS]
    if len(down) != SYSTEM_DOWNS:
        raise AssertionError(f"only {len(old_nodes)} nodes hold service allocs")
    moved = [a.id for nid in drained for a in live_allocs(srv, node_id=nid)
             if a.job_id in service_jobs]
    t0 = time.perf_counter()
    for nid in drained:
        srv.update_node_drain(nid, DrainStrategy())
    while any(srv.store.node_by_id(nid).drain for nid in drained):
        if time.perf_counter() - t0 > LIFECYCLE_TIMEOUT_S:
            raise AssertionError("drains did not complete in time")
        play_client(srv)
        time.sleep(0.05)
    wait_quiet(srv, "drains")
    play_client(srv)
    log(f"system: {SYSTEM_DRAINS} drains complete in "
        f"{time.perf_counter() - t0:.3f} s, {len(moved)} service allocs "
        f"migrated")
    for nid in drained:
        node = srv.store.node_by_id(nid)
        if node.drain or node.scheduling_eligibility != "ineligible":
            raise AssertionError(f"drained node {nid}: drain {node.drain}, "
                                 f"{node.scheduling_eligibility}")
        if live_allocs(srv, node_id=nid):
            raise AssertionError(f"drained node {nid} still holds allocs")
    if not all(srv.store.alloc_by_id(a).desired_status == "stop" for a in moved):
        raise AssertionError("a drained service alloc was not stopped")

    # 4. 16 other nodes go down (the RPC a missed heartbeat calls).
    lost = [a.id for nid in down for a in live_allocs(srv, node_id=nid)]
    t0 = time.perf_counter()
    for nid in down:
        srv.update_node_status(nid, "down")
    wait_quiet(srv, "nodes down")
    play_client(srv)
    log(f"system: {SYSTEM_DOWNS} nodes down, {len(lost)} allocs lost and "
        f"handled in {time.perf_counter() - t0:.3f} s")
    not_lost = [srv.store.alloc_by_id(a) for a in lost
                if srv.store.alloc_by_id(a).client_status != "lost"]
    if not_lost:
        raise AssertionError(
            f"{len(not_lost)} allocs on down nodes not lost: " + "; ".join(
                f"{a.name} ({a.job.type if a.job else '?'}) desired "
                f"{a.desired_status} ({a.desired_description}) client "
                f"{a.client_status}, migrate "
                f"{a.desired_transition.should_migrate()}"
                for a in not_lost[:4]))

    # Final state: every count exact.
    gone = set(drained) | set(down)
    expect_system(srv, exporter, wanted(exporter, gone), "final")
    expect_system(srv, shipper, wanted(shipper, gone), "final")
    for job_id, count in service_count.items():
        allocs = live_allocs(srv, job_id)
        if len(allocs) != count or {a.node_id for a in allocs} & gone:
            evals = sorted(
                (e.create_index, e.triggered_by, e.status, e.status_description)
                for e in srv.store.evals.values()
                if e.job_id == job_id and e.id not in evals_before)
            raise AssertionError(f"service job {job_id}: {len(allocs)} live "
                                 f"allocs, expected {count} off the gone "
                                 f"nodes; its evals {evals}")
    check_capacity(srv, "final")

    sys_evals = [e for e in srv.store.evals.values()
                 if e.id not in evals_before and e.type == "system"]
    statuses = sorted({e.status for e in sys_evals})
    # Evals that ran the scheduler end complete; the blocked evals that
    # exhausted nodes park stay blocked, or are cancelled when a newer one
    # of the same job replaces them.  An eval whose plan only partly
    # commits runs the scheduler (and the kernel) again, up to five times.
    ran = [e for e in sys_evals if e.status == "complete"]
    parked = [e for e in sys_evals if e.status != "complete"]
    launches = {
        "system_feasible": k.system_feasible.launches,
        "system_feasible_plain": k.system_feasible_plain.calls,
        "fused_place": k.fused_place.launches,
        "plain": k.place_lanes.calls + k.verify_lanes.calls,
    }
    log(f"system: {len(sys_evals)} system evals {statuses} ({len(ran)} ran "
        f"the scheduler, {launches['system_feasible'] - len(ran)} extra "
        f"attempts after partial commits) in "
        f"{time.perf_counter() - t_phase:.3f} s; launches {launches}")
    if any(e.status not in ("blocked", "cancelled")
           or e.triggered_by != "queued-allocs" for e in parked):
        raise AssertionError(f"system eval statuses {statuses}")
    if not (len(ran) <= launches["system_feasible"]
            <= MAX_SYSTEM_SCHEDULE_ATTEMPTS * len(ran)):
        raise AssertionError(
            f"system_feasible launched {launches['system_feasible']} times "
            f"for {len(ran)} system evals of one task group each")
    if launches["system_feasible_plain"] or launches["plain"]:
        raise AssertionError(f"plain version ran on the card: {launches}")
    if launches["fused_place"] <= 0:
        raise AssertionError("no service replacement went through fused_place")
    results["system_feasible"]["launches"] = launches["system_feasible"]
    results["system_server"].update(
        system_evals=len(ran), fused_place=launches["fused_place"],
        seconds=time.perf_counter() - t_phase)
    n_sched = sched.count - sched0[0]
    mean_ms = (sched.sum - sched0[1]) / max(1, n_sched) * 1e3
    results["system_server"]["scheduler_ms_mean"] = mean_ms
    log(f"system: {n_sched} scheduler invocations (system and service) in "
        f"this phase, {mean_ms:.3f} ms each on average (card: {card})")


def play_health(srv, healthy=lambda a: True) -> int:
    """The client under deployments: report each alloc the scheduler wants
    running that was not reported yet, or not judged healthy or unhealthy
    yet, as running with the ``healthy`` verdict (allocs outside a
    deployment get no verdict); returns how many."""
    from nomad_tpu_torch.structs.types import AllocDeploymentStatus

    updates = []
    for a in list(srv.store.allocs.values()):
        if a.desired_status != "run" or a.terminal_status():
            continue
        unjudged = a.deployment_id and (
            a.deployment_status is None or a.deployment_status.healthy is None)
        if a.client_status != "pending" and not unjudged:
            continue
        upd = a.copy()
        upd.client_status = "running"
        if a.deployment_id:
            prev = a.deployment_status
            upd.deployment_status = AllocDeploymentStatus(
                healthy=healthy(a), timestamp=time.time(),
                canary=prev.canary if prev is not None else False)
        updates.append(upd)
    if updates:
        srv.update_allocs_from_client(updates)
    return len(updates)


def drive(srv, pred, what: str, healthy=lambda a: True,
          timeout_s: float = LIFECYCLE_TIMEOUT_S) -> float:
    """Play the client until ``pred()``; returns seconds."""
    t0 = time.perf_counter()
    while not pred():
        if time.perf_counter() - t0 > timeout_s:
            raise AssertionError(f"{what}: not reached in {timeout_s:.0f} s")
        play_health(srv, healthy)
        time.sleep(0.05)
    return time.perf_counter() - t0


def lifecycle_job(job_id: str, count: int, job_type: str = "service"):
    from nomad_tpu_torch import mock

    job = mock.job()
    job.id = job.name = job_id
    job.type = job_type
    job.datacenters = list(DATACENTERS)
    tg = job.task_groups[0]
    tg.count = count
    tg.tasks[0].resources.cpu = 100
    tg.tasks[0].resources.memory_mb = 64
    return job


def lifecycle_run(srv, specs: dict, card: str, results: dict) -> None:
    """The job lifecycle on the server phase's 10,000 nodes, the smoke as
    the client: a destructive rolling update (count 8, max_parallel 2) to
    successful, a canary auto-promoted, a failing update auto-reverted, an
    interval periodic job's children, a dispatched parameterized job, a
    scale up and down within policy, and ``system_gc``: a stopped job and
    16 down nodes reaped, then 16 nodes registered into the freed matrix
    rows and covered by the system jobs through ``system_feasible``.
    Launch counts zeroed just before and read just after."""
    from nomad_tpu_torch.ops import kernels as k
    from nomad_tpu_torch.structs.types import (
        PeriodicConfig, ScalingPolicy, UpdateStrategy,
    )

    def update(**kw):
        kw.setdefault("max_parallel", 1)
        kw.setdefault("min_healthy_time", 0.1)
        kw.setdefault("healthy_deadline", 120.0)
        kw.setdefault("progress_deadline", 600.0)
        return UpdateStrategy(**kw)

    def deployment(job_id, version):
        for d in list(srv.store.deployments.values()):
            if d.job_id == job_id and d.job_version == version:
                return d
        return None

    def successful(job_id, version):
        d = deployment(job_id, version)
        return d is not None and d.status == "successful"

    def new_version(job, env, **upd):
        job2 = job.copy()
        job2.task_groups[0].tasks[0].env = dict(env)
        if upd:
            job2.task_groups[0].update = update(**upd)
        return job2

    def versions(job_id):
        return sorted(a.job.version for a in live_allocs(srv, job_id))

    timings = {}
    k.reset_counts()
    t_phase = time.perf_counter()

    # 1. Rolling update: eight allocs, two at a time.
    t0 = time.perf_counter()
    web = lifecycle_job("rolling", 8)
    web.task_groups[0].update = update(max_parallel=2)
    srv.submit_job(web)
    drive(srv, lambda: successful("rolling", 0), "rolling v0")
    srv.submit_job(new_version(web, {"V": "2"}))
    drive(srv, lambda: successful("rolling", 1), "rolling v1")
    dep = deployment("rolling", 1)
    batches = sum(1 for e in list(srv.store.evals.values())
                  if e.deployment_id == dep.id
                  and e.triggered_by == "deployment-watcher")
    if versions("rolling") != [1] * 8 or batches < 3:
        raise AssertionError(f"rolling update: live versions "
                             f"{versions('rolling')}, {batches} batch evals")
    timings["rolling"] = time.perf_counter() - t0
    log(f"lifecycle: rolling update of 8 (max_parallel 2) successful in "
        f"{timings['rolling']:.3f} s, {batches} watcher batch evals")

    # 2. Canary, auto-promoted (the first version has none: ROADMAP R7).
    t0 = time.perf_counter()
    api = lifecycle_job("canary", 3)
    api.task_groups[0].update = update()
    srv.submit_job(api)
    drive(srv, lambda: successful("canary", 0), "canary v0")
    srv.submit_job(new_version(api, {"V": "2"}, canary=1, auto_promote=True))
    wait_quiet(srv, "canary placed")
    canaries = [a for a in live_allocs(srv, "canary")
                if a.deployment_status is not None and a.deployment_status.canary]
    drive(srv, lambda: successful("canary", 1), "canary v1")
    promoted = [s.promoted for s in deployment("canary", 1).task_groups.values()]
    if len(canaries) != 1 or promoted != [True] or versions("canary") != [1] * 3:
        raise AssertionError(f"canary: {len(canaries)} canaries before "
                             f"promotion, promoted {promoted}, live versions "
                             f"{versions('canary')}")
    timings["canary"] = time.perf_counter() - t0
    log(f"lifecycle: canary placed alone, auto-promoted, successful in "
        f"{timings['canary']:.3f} s")

    # 3. A failing update, auto-reverted.
    t0 = time.perf_counter()
    rev = lifecycle_job("revert", 2)
    rev.task_groups[0].update = update(auto_revert=True)
    srv.submit_job(rev)
    drive(srv, lambda: successful("revert", 0), "revert v0")
    srv.submit_job(new_version(rev, {"BAD": "1"}))

    def reverted():
        return (srv.store.job_by_id("default", "revert").version == 2
                and versions("revert") == [2, 2]
                and all(a.client_status == "running"
                        for a in live_allocs(srv, "revert")))

    drive(srv, reverted, "auto-revert",
          healthy=lambda a: not a.job.task_groups[0].tasks[0].env.get("BAD"))
    failed = deployment("revert", 1)
    if failed.status != "failed":
        raise AssertionError(f"revert: v1 deployment {failed.status}")
    timings["revert"] = time.perf_counter() - t0
    log(f"lifecycle: failing update {failed.status} "
        f"({failed.status_description}), reverted to version 2 in "
        f"{timings['revert']:.3f} s")

    # 4. An interval periodic batch job: two children or more, each placed.
    t0 = time.perf_counter()
    cron = lifecycle_job("cron", 1, "batch")
    cron.periodic = PeriodicConfig(spec="0.5", spec_type="interval")
    if srv.submit_job(cron) is not None:
        raise AssertionError("a periodic job got an eval at register")

    def children():
        return [jid for (_, jid) in list(srv.store.jobs)
                if jid.startswith("cron/periodic-")]

    drive(srv, lambda: len(children()) >= 2, "two periodic children")
    srv.deregister_job("default", "cron")
    wait_quiet(srv, "periodic children")
    kids = children()
    unplaced = [j for j in kids if len(live_allocs(srv, j)) != 1]
    if unplaced:
        raise AssertionError(f"periodic children not placed: {unplaced}")
    timings["periodic"] = time.perf_counter() - t0
    log(f"lifecycle: {len(kids)} periodic children launched and placed in "
        f"{timings['periodic']:.3f} s")

    # 5. A dispatched parameterized job.
    t0 = time.perf_counter()
    param = lifecycle_job("param", 1, "batch")
    param.parameterized = {"meta_required": ["k"], "payload": "optional"}
    srv.submit_job(param)
    try:
        srv.dispatch_job("default", "param")
        raise AssertionError("dispatch without required meta was accepted")
    except ValueError:
        pass
    child, ev = srv.dispatch_job("default", "param", payload=b"hi",
                                 meta={"k": "v"})
    wait_quiet(srv, "dispatch")
    if (srv.store.eval_by_id(ev.id).status != "complete"
            or len(live_allocs(srv, child.id)) != 1):
        raise AssertionError(f"dispatched child {child.id} not placed")
    timings["dispatch"] = time.perf_counter() - t0
    log(f"lifecycle: dispatched {child.id} placed in "
        f"{timings['dispatch']:.3f} s")

    # 6. Scale up and down within the group's policy.
    t0 = time.perf_counter()
    sc = lifecycle_job("scaled", 2)
    sc.task_groups[0].scaling = ScalingPolicy(min=1, max=5)
    srv.submit_job(sc)
    wait_quiet(srv, "scaled v0")
    try:
        srv.scale_job("default", "scaled", "web", 6)
        raise AssertionError("scale past the policy was accepted")
    except ValueError:
        pass
    counts = []
    for count in (4, 1):
        srv.scale_job("default", "scaled", "web", count)
        wait_quiet(srv, f"scale to {count}")
        counts.append(len(live_allocs(srv, "scaled")))
    if counts != [4, 1]:
        raise AssertionError(f"scale: live allocs {counts}, expected [4, 1]")
    timings["scale"] = time.perf_counter() - t0
    log(f"lifecycle: scaled 2 -> 4 -> 1 in {timings['scale']:.3f} s")

    # 7. system_gc: the stopped job and 16 down nodes (in a datacenter no
    # job runs in, so they hold no allocs), then 16 nodes into their rows.
    t0 = time.perf_counter()
    first = N_NODES + SYSTEM_NEW_NODES
    doomed = []
    for i in range(first, first + SYSTEM_DOWNS):
        node = server_node(i)
        node.datacenter = "dc5"
        srv.register_node(node)
        doomed.append(node.id)
    wait_quiet(srv, "dc5 joins")
    for nid in doomed:
        srv.update_node_status(nid, "down")
    srv.deregister_job("default", "scaled")
    wait_quiet(srv, "down and deregister")
    freed = {srv.matrix.row_of[nid] for nid in doomed}
    launches = {"fused_place": k.fused_place.launches,
                "plain": (k.place_lanes.calls + k.verify_lanes.calls
                          + k.system_feasible_plain.calls)}
    if launches["fused_place"] <= 0 or launches["plain"]:
        raise AssertionError(f"lifecycle placements: launches {launches}")
    k.reset_counts()
    srv.system_gc()
    drive(srv, lambda: any(e.type == "_core" and e.status == "complete"
                           for e in list(srv.store.evals.values())),
          "the force-gc eval")
    wait_quiet(srv, "gc")
    gone = [nid for nid in doomed if srv.store.node_by_id(nid) is None]
    if (len(gone) != len(doomed) or srv.store.job_by_id("default", "scaled")
            or freed & set(srv.matrix.row_of.values())):
        raise AssertionError(f"gc: {len(gone)} of {len(doomed)} down nodes "
                             f"reaped, stopped job still stored: "
                             f"{bool(srv.store.job_by_id('default', 'scaled'))}")
    strays = [a.id for a in live_allocs(srv)
              if srv.store.node_by_id(a.node_id) is None]
    if strays:
        raise AssertionError(f"gc: {len(strays)} live allocs on unknown nodes")
    reaped_s = time.perf_counter() - t0
    fresh = []
    for i in range(first + SYSTEM_DOWNS, first + 2 * SYSTEM_DOWNS):
        node = server_node(i)
        specs[node.id] = (node.datacenter, node.node_class)
        srv.register_node(node)
        fresh.append(node.id)
    wait_quiet(srv, "joins into freed rows")
    rows = {srv.matrix.row_of[nid] for nid in fresh}
    if rows != freed:
        raise AssertionError(f"new nodes took rows {sorted(rows)}, freed "
                             f"{sorted(freed)}")
    exporter, shipper = system_jobs()
    for nid in fresh:
        dc, cls = specs[nid]
        want = {exporter.id} | ({shipper.id} if dc == "dc1"
                                and cls != "class-3" else set())
        have = [a.job_id for a in live_allocs(srv, node_id=nid)]
        if sorted(have) != sorted(want):
            raise AssertionError(f"node {nid} in a freed row holds {have}, "
                                 f"expected {sorted(want)}")
    sys_launches = k.system_feasible.launches
    if sys_launches <= 0:
        raise AssertionError("no system eval of the joins ran system_feasible")
    timings["gc"] = time.perf_counter() - t0
    log(f"lifecycle: system_gc reaped the stopped job and {len(gone)} down "
        f"nodes in {reaped_s:.3f} s; {len(fresh)} nodes registered into "
        f"the freed rows got their system allocs ({sys_launches} "
        f"system_feasible launches) in {timings['gc'] - reaped_s:.3f} s")

    gc_plain = (k.place_lanes.calls + k.verify_lanes.calls
                + k.system_feasible_plain.calls)
    if gc_plain:
        raise AssertionError(f"plain version ran on the card: {gc_plain}")
    check_capacity(srv, "lifecycle")
    timings["total"] = time.perf_counter() - t_phase
    results["lifecycle"] = timings
    log(f"lifecycle: every check passed in {timings['total']:.3f} s; "
        f"launches before the gc step {launches}, in it system_feasible "
        f"{sys_launches} (card: {card})")


def solo_run(srv, make_job, results: dict) -> None:
    """One distinct_hosts group of SOLO_COUNT: its plan outgrows
    MAX_DELTA_ROWS deltas after three chunks, so the stack's solo path
    places the rest.  Launch counts are zeroed just before and read just
    after."""
    from nomad_tpu_torch.ops import kernels as k
    from nomad_tpu_torch.structs.types import Constraint

    wide = make_job(0)
    wide.task_groups[0].count = SOLO_COUNT
    wide.task_groups[0].constraints = [Constraint(operand="distinct_hosts")]
    solo0 = srv.coalescer.solo_ops
    k.reset_counts()
    _, elapsed = burst(srv, [wide])
    launches = {
        "fused_place": k.fused_place.launches,
        "allocs_fit_verify": k.allocs_fit_verify.launches,
        "plain": k.place_lanes.calls + k.verify_lanes.calls,
    }
    solo_ops = srv.coalescer.solo_ops - solo0
    nodes = [a.node_id for a in srv.store.allocs.values()
             if a.job_id == wide.id and not a.terminal_status()]
    log(f"server solo: 1 job x {SOLO_COUNT} (distinct_hosts) in "
        f"{elapsed:.3f} s, {len(nodes)} allocations on {len(set(nodes))} "
        f"nodes, {solo_ops} solo selects; launches {launches}")
    if len(nodes) != SOLO_COUNT or len(set(nodes)) != SOLO_COUNT:
        raise AssertionError(f"solo job placed {len(nodes)} allocs on "
                             f"{len(set(nodes))} nodes")
    if solo_ops <= 0 or launches["fused_place"] < solo_ops:
        raise AssertionError(f"solo path not driven: {solo_ops} solo "
                             f"selects, launches {launches}")
    if launches["plain"] != 0:
        raise AssertionError(f"plain version ran on the card: {launches}")
    results["fused_place"]["solo_run"] = {
        "launches": launches["fused_place"], "solo_selects": solo_ops}


def last_eval(srv, eval_id: str):
    """The eval that ``eval_id`` ends in: an eval that failed on placement
    conflicts hands its job to a blocked retry (``blocked_eval``), which
    the server runs again after a while."""
    ev = srv.store.eval_by_id(eval_id)
    while ev is not None and ev.status == "failed" and ev.blocked_eval:
        ev = srv.store.eval_by_id(ev.blocked_eval)
    return ev


def retried_evals(srv, evals) -> int:
    """How many of ``evals`` failed on placement conflicts and left their
    job to a blocked retry."""
    return sum(1 for e in evals
               if srv.store.eval_by_id(e.id).blocked_eval
               and srv.store.eval_by_id(e.id).status == "failed")


def burst(srv, jobs, timeout_s: float = 300.0):
    """Submit ``jobs`` and wait until every eval, or the retry it left
    after placement conflicts, is terminal; returns (evals, seconds)."""
    t0 = time.perf_counter()
    evals = [srv.submit_job(job) for job in jobs]
    deadline = time.time() + timeout_s
    pending = {e.id for e in evals}
    while pending and time.time() < deadline:
        pending = {
            eid for eid in pending
            if not (last_eval(srv, eid) is not None
                    and last_eval(srv, eid).terminal_status())
        }
        if pending:
            time.sleep(0.005)
    if pending:
        raise AssertionError(
            f"{len(pending)} evals not terminal after {timeout_s:.0f} s")
    return evals, time.perf_counter() - t0


def trace_burst(srv, jobs, card: str) -> None:
    """A second burst of the same size under the CUDA profiler (device
    activity only): how much of the burst's wall time the card spent on
    kernels and copies, by name.  The sum over activities counts any
    overlap twice, so the busy share is an upper bound.  Every job of the
    burst must hold its full count after it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from nomad_tpu_torch.ops import kernels as k

    launched = k.fused_place.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        evals, wall = burst(srv, jobs)
        torch.cuda.synchronize()
    launched = k.fused_place.launches - launched
    # Every job of the traced burst placed in full: the system phase counts
    # on each service job holding its count.
    short = []
    for job, ev in zip(jobs, evals):
        have = len(live_allocs(srv, job.id))
        if have != job.task_groups[0].count:
            cur = last_eval(srv, ev.id)
            short.append(f"{job.id}: {have} allocs, eval {cur.status} "
                         f"({cur.status_description})")
    if short:
        raise AssertionError(f"traced burst left {len(short)} jobs short: "
                             + "; ".join(short[:4]))
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((us, e.count, e.key))
    busy_s = sum(us for us, _, _ in rows) / 1e6
    if not rows:
        log(f"server trace: {len(jobs)} jobs in {wall:.3f} s under the "
            "profiler; device busy share not measured (the profiler "
            "recorded no device activity)")
        return
    log(f"server trace: {len(jobs)} jobs in {wall:.3f} s under the profiler "
        f"({retried_evals(srv, evals)} retried after placement conflicts); "
        f"device busy {busy_s * 1e3:.3f} ms = {100.0 * busy_s / wall:.2f}% "
        f"of the burst, idle {100.0 - 100.0 * busy_s / wall:.2f}% "
        f"(card: {card})")
    for us, count, key in sorted(rows, reverse=True)[:6]:
        log(f"  device {us / 1e3:9.3f} ms  x{count:<5d} {key[:70]}")
    kept_records(rows, "fused_place_kernel", launched)


def kept_records(rows, name: str, launched: int) -> None:
    """Log when the profiler kept fewer records of kernel ``name`` than
    its wrapper launched: the busy share then misses their time."""
    kept = sum(count for _, count, key in rows if name in key)
    if kept < launched:
        log(f"  the profiler kept {kept} of {launched} {name} launches: "
            "the busy share misses the rest")


def phase_timing(batch: Batch, card: str, results: dict) -> None:
    from nomad_tpu_torch.ops import kernels as k

    args = batch.args()
    t = batch.t
    packed = k.fused_place(*args, SCAN, batch.features)

    def run_fp():
        k.fused_place(*args, SCAN, batch.features)

    def run_fp_plain():
        k.place_lanes(*args, SCAN, batch.features)

    def run_v():
        k.allocs_fit_verify(batch.arrays.totals, batch.arrays.used, packed,
                            t["req_f"], t["delta_rows"], t["delta_vals"],
                            t["lane_mask"])

    def run_v_plain():
        k.verify_lanes(batch.arrays.totals, batch.arrays.used, packed,
                       t["req_f"], t["delta_rows"], t["delta_vals"],
                       t["lane_mask"])

    for name, fn, plain, work in (
        ("fused_place", run_fp, run_fp_plain,
         fused_place_work(batch, packed, SCAN)),
        ("allocs_fit_verify", run_v, run_v_plain,
         verify_work(batch, packed, SCAN)),
    ):
        ms = time_cuda(fn, runs=20)
        dev_us = device_us_per_launch(fn, f"{name}_kernel")
        plain_ms = time_cuda(plain, runs=3, warmup=1)
        b_ms, by = bound(*work)
        r = results[name]
        r.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                 library_ms=None, device_us=dev_us)
        shape = ""
        if name == "fused_place":
            r["launch"] = k.fused_place_shape(
                int(batch.arrays.used.shape[0]), LANES,
                t["delta_rows"].shape[1], SCAN, batch.features)
            shape = f"; launch {r['launch']}"
        log(f"timing {name}: {ms:.4f} ms by CUDA events, {fmt_us(dev_us)} a "
            f"launch on the device (profiler); plain version {plain_ms:.3f} "
            f"ms, bound {b_ms:.5f} ms by {by}; {work[0]} bytes, "
            f"{work[1]:.4g} ops{shape} (card: {card})")
    r = results["allocs_fit_verify"]
    r["launch"] = k.allocs_fit_verify_shape(
        int(batch.arrays.used.shape[0]), LANES, SCAN,
        t["delta_rows"].shape[1])
    r["host_us"] = host_us_per_call(run_v)
    log(f"timing allocs_fit_verify: plan {r['launch']}; the wrapper's host "
        f"time {r['host_us']:.3f} us a call (card: {card})")

    # The fused dispatch: both launches of fused_place_batch.
    fp_us = results["fused_place"]["device_us"]
    v_us = results["allocs_fit_verify"]["device_us"]
    dispatch_ms = time_cuda(
        lambda: k.fused_place_batch(*args, SCAN, batch.features), runs=20)
    both_us = None if fp_us is None or v_us is None else fp_us + v_us
    results["fused_dispatch"] = {"device_us": both_us, "ms": dispatch_ms}
    log(f"timing fused dispatch: fused_place {fmt_us(fp_us)} + "
        f"allocs_fit_verify {fmt_us(v_us)} = {fmt_us(both_us)} on the device; "
        f"fused_place_batch {dispatch_ms:.4f} ms by CUDA events (card: {card})")

    # allocs_fit_verify on the hot-row stream and in its device-scratch tier.
    tiers = {}
    for case in ("hot_row", "large"):
        ops = verify_operands(case)
        n, (b, p, _), d = ops[0].shape[0], ops[2].shape, ops[4].shape[1]

        def run_case():
            k.allocs_fit_verify(*ops)

        tiers[case] = {
            "ms": time_cuda(run_case, runs=20),
            "device_us": device_us_per_launch(run_case,
                                              "allocs_fit_verify_kernel"),
            "launch": k.allocs_fit_verify_shape(n, b, p, d),
        }
        log(f"timing allocs_fit_verify [{case}]: {tiers[case]['ms']:.4f} ms "
            f"by CUDA events, {fmt_us(tiers[case]['device_us'])} a launch on "
            f"the device (profiler); B={b}, P={p}, D={d}; plan "
            f"{tiers[case]['launch']} (card: {card})")
    r["cases"] = tiers


def host_us_per_call(fn, runs: int = 2000) -> float:
    """Mean host microseconds of ``fn`` over ``runs`` calls after a
    warm-up (launches queue on the stream; the card is not waited for)."""
    import torch

    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    us = (time.perf_counter() - t0) / runs * 1e6
    torch.cuda.synchronize()
    return us


def device_us_per_launch(fn, name: str, runs: int = 20,
                         passes: int = 3) -> Optional[float]:
    """Median device time of kernel ``name`` per launch over ``runs``
    calls of ``fn`` (one launch each), from the CUDA profiler's kernel
    records.  Late in this long process the profiler keeps only some of
    a trace's records (14 of 20, or none, on the H100); a pass that kept
    fewer than half is profiled again, up to ``passes`` in all.  None
    (not measured) when no pass did."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(passes):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        durations = [e.time_range.elapsed_us() for e in prof.events()
                     if name in e.name]
        if len(durations) < runs:
            log(f"profiler: {len(durations)} of {runs} {name} launches "
                "recorded")
        if 2 * len(durations) >= runs:
            return statistics.median(durations)
    return None


def fmt_us(x: Optional[float]) -> str:
    """A profiler time for the log, or "not measured"."""
    return "not measured" if x is None else f"{x:.3f} us"


def phase_system_timing(m, card: str, results: dict) -> None:
    """system_feasible alone on the node-exporter request at N=10240
    (CUDA events and the profiler), its plain version, its bound, and one
    whole dispatch of a node-update eval: ``_dense_used0`` over one plan
    delta per node, the kernel, and the (2, N) copy back."""
    import torch

    from nomad_tpu_torch.ops import kernels as k
    from nomad_tpu_torch.scheduler.stack import _dense_used0

    arrays = m.sync("cuda")
    dev = arrays.used.device
    _, req, class_elig, host_mask, _ = next(
        c for c in system_cases(m, arrays) if c[0] == "node-exporter")
    used0 = arrays.used.clone()
    ri, rf = k.pack_request(req, dev)
    ce = torch.from_numpy(class_elig).to(dev)
    hm = torch.from_numpy(host_mask).to(dev)

    def run():
        k.system_feasible(arrays, used0, ri, rf, ce, hm)

    def run_plain():
        k.system_feasible_plain(arrays, used0, ri, rf, ce, hm)

    ms = time_cuda(run, runs=20)
    dev_us = device_us_per_launch(run, "system_feasible_kernel")
    plain_ms = time_cuda(run_plain, runs=20)
    work = system_feasible_work(arrays, req, len(class_elig))
    split = system_wrapper_split(arrays, used0, ri, rf, ce, hm, card)
    b_ms, by = bound(*work)
    own = {r: -np.array([100.0, 64.0, 0.0], np.float32) for r in range(N_NODES)}

    def dispatch():
        return k.system_feasible(arrays, _dense_used0(arrays, own), ri, rf,
                                 ce, hm).cpu()

    for _ in range(3):
        dispatch()
    times = []
    for _ in range(20):
        t0 = time.perf_counter()
        dispatch()
        times.append((time.perf_counter() - t0) * 1e3)
    dispatch_ms = statistics.median(times)
    results["system_feasible"].update(
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by, library_ms=None,
        device_us=dev_us, host_split_us=split)
    results["system_server"]["dispatch_ms"] = dispatch_ms
    log(f"timing system_feasible: {ms:.4f} ms by CUDA events, "
        f"{fmt_us(dev_us)} a launch on the device (profiler); plain version "
        f"{plain_ms:.3f} ms; bound {b_ms:.6f} ms by {by}; {work[0]} bytes, "
        f"{work[1]:.4g} ops; one node-update dispatch ({len(own)} deltas, "
        f"kernel, copy back) {dispatch_ms:.3f} ms on the host clock "
        f"(card: {card})")


def system_wrapper_split(arrays, used0, ri, rf, ce, hm, card: str) -> dict:
    """Where the host time of one ``system_feasible`` call goes: the CUDA
    events' floor on an empty function, the wrapper's host microseconds
    a call, and each of its parts alone — the matrix check (memoised with
    the columns' pointers), the four operand checks, the library entry
    (resolved once), the output allocation, the stream handle, the
    ``ctypes`` launch — beside what the earlier wrapper did instead (a
    Stream object for the handle)."""
    import torch

    from nomad_tpu_torch.ops import kernels as k

    dev = used0.device
    n = int(used0.shape[0])
    kk = int(ce.shape[0])
    _, cols = k._checked_cols(arrays, used0, dev)
    fn = k._entry("system_feasible", "nomad_system_feasible")
    out = torch.empty((2, n), dtype=torch.bool, device=dev)
    a, w = int(arrays.attr_hash.shape[1]), int(arrays.port_words.shape[1])

    def checks():
        k._check("req_i", ri, torch.int32, (1, k.REQ_INT_WIDTH), dev)
        k._check("req_f", rf, torch.float32, (1, k.REQ_FLOAT_WIDTH), dev)
        k._check("class_elig", ce, torch.bool, (kk,), dev)
        k._check("host_mask", hm, torch.bool, (n,), dev)

    def launch():
        fn(cols, used0.data_ptr(), ri.data_ptr(), rf.data_ptr(),
           ce.data_ptr(), hm.data_ptr(), out.data_ptr(), n, a, w, kk,
           k._stream(dev))

    parts = {
        "wrapper": lambda: k.system_feasible(arrays, used0, ri, rf, ce, hm),
        "check_matrix": lambda: k._checked_cols(arrays, used0, dev),
        "four_checks": checks,
        "entry": lambda: k._entry("system_feasible",
                                  "nomad_system_feasible"),
        "torch_empty": lambda: torch.empty((2, n), dtype=torch.bool,
                                           device=dev),
        "stream": lambda: k._stream(dev),
        "ctypes_launch": launch,
        "earlier_stream_object":
            lambda: torch.cuda.current_stream().cuda_stream,
    }
    return host_split("system_feasible", parts, card)


def host_split(label: str, parts: dict, card: str) -> dict:
    """Host microseconds a call of each of ``parts`` (the wrapper first,
    then its pieces alone), with the CUDA events' floor on an empty
    function and the wrapper by CUDA events, logged as one line."""
    split = {name: host_us_per_call(f) for name, f in parts.items()}
    split["event_floor_us"] = time_cuda(lambda: None, runs=50) * 1e3
    split["event_us"] = time_cuda(parts["wrapper"], runs=50) * 1e3
    log(f"timing {label} host split (us a call): " + ", ".join(
        f"{name} {us:.3f}" for name, us in split.items()) + f" (card: {card})")
    return split


def plan_fit_wrapper_split(arrays, rows, deltas, er, card: str) -> dict:
    """Where the host time of one ``verify_plan_fit`` call goes: the
    memoised column check, the three operand checks, the library entry
    (resolved once), the output allocation, the stream handle and the
    ``ctypes`` launch."""
    import torch

    from nomad_tpu_torch.ops import kernels as k

    dev = rows.device
    n, cols = k._plan_cols(arrays, dev)
    kk = int(rows.shape[0])
    fn = k._entry("verify_plan_fit", "nomad_verify_plan_fit")
    out = torch.empty(kk, dtype=torch.bool, device=dev)

    def checks():
        k._check("rows", rows, torch.int32, (kk,), dev)
        k._check("deltas", deltas, torch.float32, (kk, 3), dev)
        k._check("eligible_required", er, torch.bool, (kk,), dev)

    def launch():
        fn(cols, rows.data_ptr(), deltas.data_ptr(), er.data_ptr(),
           out.data_ptr(), kk, n, k._stream(dev))

    return host_split("verify_plan_fit", {
        "wrapper": lambda: k.verify_plan_fit(arrays, rows, deltas, er),
        "plan_cols": lambda: k._plan_cols(arrays, dev),
        "three_checks": checks,
        "entry": lambda: k._entry("verify_plan_fit", "nomad_verify_plan_fit"),
        "torch_empty": lambda: torch.empty(kk, dtype=torch.bool, device=dev),
        "stream": lambda: k._stream(dev),
        "ctypes_launch": launch,
    }, card)


def usage_wrapper_split(used, packed, req_f, n_batch: int, off: int,
                        card: str) -> dict:
    """Where the host time of one ``sharded_usage`` call goes: the lane
    limit and three operand checks, the library entry (resolved once),
    the output allocation, the stream handle and the ``ctypes`` launch."""
    import torch

    from nomad_tpu_torch.ops import kernels as k

    dev = used.device
    n, b, p = int(used.shape[0]), int(packed.shape[0]), int(packed.shape[1])
    fn = k._entry("sharded_place", "nomad_sharded_usage")
    out = torch.empty_like(used)

    def checks():
        k._check_usage_lanes(b)
        k._check("used", used, torch.float32, (n, 3), dev)
        k._check("packed", packed, torch.float32, (b, p, k.PACKED_WIDTH),
                 dev)
        k._check("req_f", req_f, torch.float32, (b, k.REQ_FLOAT_WIDTH), dev)

    def launch():
        fn(used.data_ptr(), packed.data_ptr(), req_f.data_ptr(),
           out.data_ptr(), n, off, b, p, n_batch, k._stream(dev))

    return host_split("sharded_usage", {
        "wrapper": lambda: k.sharded_usage(used, packed, req_f, n_batch, off),
        "checks": checks,
        "entry": lambda: k._entry("sharded_place", "nomad_sharded_usage"),
        "torch_empty_like": lambda: torch.empty_like(used),
        "stream": lambda: k._stream(dev),
        "ctypes_launch": launch,
    }, card)


# ---------------------------------------------------------------------------
# Phase 7: batched scoring (the bench's kernel phase, on the port)
# ---------------------------------------------------------------------------


def stacked(reqs):
    from nomad_tpu_torch.ops.encode import SchedRequest

    return SchedRequest(*[np.stack(f) for f in zip(*reqs)])


def score_args(arrays, inp):
    return (arrays, arrays.used, inp["tg_counts"], inp["spread_counts"],
            inp["penalties"], inp["req_i"], inp["req_f"], inp["class_eligs"],
            inp["host_masks"])


def score_plain_in_chunks(args, features):
    """score_batch_plain over chunks of PLAIN_CHUNK lanes, stacked as the
    (B, 7) packed output: its (B, N) and (B, N, V) intermediates are
    gigabytes each at B=4096 in one piece."""
    import torch

    from nomad_tpu_torch.ops import kernels as k

    arrays, used, lane_args = args[0], args[1], args[2:]
    b = lane_args[0].shape[0]
    parts = []
    for c in range(0, b, PLAIN_CHUNK):
        sl = slice(c, c + PLAIN_CHUNK)
        parts.append(k.pack_batch_result(k.score_batch_plain(
            arrays, used, *[a[sl] for a in lane_args], features)))
    return torch.cat(parts)


def bench_requests(m, lanes: int):
    """Lane i the bench's job shape i mod 8 (bench.py build_requests), and
    the features widened over the eight shapes as bench.py does."""
    from nomad_tpu_torch.ops import kernels as k
    from nomad_tpu_torch.ops.encode import RequestEncoder

    enc = RequestEncoder(m)
    shapes = [enc.compile(j, j.task_groups[0]).request for j, _ in bench_jobs()]
    feats = k.features_of(shapes[0])
    for sh in shapes[1:]:
        feats = feats.widen(k.features_of(sh))
    return [shapes[i % len(shapes)] for i in range(lanes)], feats


def feature_score_inputs(m, device, lanes: int = FEATURE_LANES, seed: int = 21):
    """The feature batch's shapes (preemption, ports, distinct_hosts, a
    targeted spread, then the bench's eight) with per-lane operands that
    are not trivial: tg counts, penalties, class eligibility with holes,
    host masks (one lane masked out entirely) and spread tables holding
    rack values with counts.  Returns (inputs on ``device``, stacked numpy
    request)."""
    import torch

    from nomad_tpu_torch.ops import kernels as k
    from nomad_tpu_torch.ops.encode import (
        MAX_SPREAD_VALUES, MAX_SPREADS, RequestEncoder, pow2_bucket,
    )
    from nomad_tpu_torch.state.matrix import stable_hash

    rng = np.random.default_rng(seed)
    enc = RequestEncoder(m)
    mix = feature_jobs() + bench_jobs()
    reqs = stacked([
        enc.compile(j, j.task_groups[0], preemption_enabled=pre).request
        for j, pre in (mix[i % len(mix)] for i in range(lanes))])
    n = m.capacity
    s_hash = np.array(reqs.s_value_hash, copy=True)
    counts = np.zeros((lanes, MAX_SPREADS, MAX_SPREAD_VALUES), np.float32)
    for lane in range(lanes):
        for s in range(MAX_SPREADS):
            if reqs.s_slot[lane, s] < 0:
                continue
            for v in range(6):
                if s_hash[lane, s, v] == 0:
                    s_hash[lane, s, v] = stable_hash(f"r{v}")
                counts[lane, s, v] = float(rng.integers(0, 5))
    reqs = reqs._replace(s_value_hash=s_hash)
    tg = np.zeros((lanes, n), np.int32)
    tg[:, :N_NODES] = (rng.random((lanes, N_NODES)) < 0.02) * rng.integers(
        1, 4, (lanes, N_NODES))
    pen = rng.random((lanes, n)) < 0.05
    k_cls = pow2_bucket(max(1, len(m.class_ids)))
    ce = rng.random((lanes, k_cls)) < 0.85
    ce[:, 0] = True
    hm = rng.random((lanes, n)) < 0.9
    hm[lanes - 1] = False
    ri, rf = k.pack_requests(reqs)

    def on(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    inp = dict(req_i=on(ri), req_f=on(rf), tg_counts=on(tg),
               spread_counts=on(counts), penalties=on(pen),
               class_eligs=on(ce), host_masks=on(hm))
    return inp, reqs


def check_score(label: str, got, want, results: dict) -> None:
    from nomad_tpu_torch.ops import kernels as k

    ok, err, msg = compare(got.cpu()[:, None], want.cpu()[:, None],
                           k.PACKED_WIDTH)
    r = results.setdefault("score_batch", {"max_abs_err": 0.0})
    r["max_abs_err"] = max(r["max_abs_err"], err)
    rows = got.cpu().numpy()[:, k.PACKED_ROW]
    pre = int(got.cpu().numpy()[:, k.PACKED_PREEMPT].sum())
    log(f"batched[{label}] score_batch vs plain: {msg} (max |err| {err:.3g}); "
        f"{int((rows >= 0).sum())} of {len(rows)} lanes placed, "
        f"{len(set(rows[rows >= 0].tolist()))} distinct rows, "
        f"{pre} preempting")
    if not ok:
        raise AssertionError(f"score_batch disagrees on {label}: {msg}")


def pct(xs, q):
    return float(np.percentile(np.asarray(xs), q))


def phase_batched_scoring(m, card: str, results: dict) -> None:
    """score_batch at the bench's shapes: parity with the plain version
    (B=4096, B=256, the feature batch at B=64 and entry()), then the main
    path with the counts zeroed around it (entry(), 100 sync dispatches
    at B=4096 and at B=256, 100 pipelined dispatches at B=4096), then the
    kernel's CUDA-event and profiler times, the plain version's time, the
    bound and a traced window of sync dispatches."""
    import torch

    from nomad_tpu_torch.entry import entry
    from nomad_tpu_torch.ops import kernels as k
    from nomad_tpu_torch.parallel import build_batch_inputs

    arrays = m.sync("cuda")
    big_reqs, feats = bench_requests(m, SCORE_BATCH)
    big = build_batch_inputs(m, big_reqs, "cuda")
    small = build_batch_inputs(m, big_reqs[:INTERACTIVE_BATCH], "cuda")
    big_args, small_args = score_args(arrays, big), score_args(arrays, small)
    log(f"batched: {SCORE_BATCH} and {INTERACTIVE_BATCH} lanes of the "
        f"bench's eight shapes on {N_NODES} nodes (capacity "
        f"{arrays.used.shape[0]}), features {tuple(feats)}")

    # Parity (the plain version in chunks of PLAIN_CHUNK lanes).
    for label, args, f in (
        (f"bench B={SCORE_BATCH}", big_args, feats),
        (f"bench B={INTERACTIVE_BATCH}", small_args, feats),
    ):
        got = k.pack_batch_result(k.score_batch(*args, f))
        check_score(label, got, score_plain_in_chunks(args, f), results)
    f_inp, f_reqs = feature_score_inputs(m, "cuda")
    f_args = score_args(arrays, f_inp)
    got = k.pack_batch_result(k.score_batch(*f_args, k.FULL_FEATURES))
    check_score(f"features B={FEATURE_LANES} full", got,
                score_plain_in_chunks(f_args, k.FULL_FEATURES), results)
    rows = got.cpu().numpy()[:, k.PACKED_ROW]
    if rows[-1] != -1 or not got.cpu().numpy()[:, k.PACKED_PREEMPT].any():
        raise AssertionError("feature batch lost its masked lane or its "
                             "preempting picks")
    fn, e_args = entry()
    if e_args[1].device.type != "cuda":
        raise AssertionError("entry() did not take the card")
    check_score("entry()", k.pack_batch_result(fn(*e_args)),
                k.pack_batch_result(k.score_batch_plain(*e_args)), results)

    # The main path: entry() and the bench's dispatch loops.
    pinned = [torch.empty((SCORE_BATCH,), dtype=torch.int32, pin_memory=True)
              for _ in range(PIPELINE_DEPTH)]

    def sync_loop(args, label):
        for _ in range(2):
            k.score_batch(*args, feats).rows.cpu()
        total, launch, fetch = [], [], []
        for _ in range(DISPATCHES):
            t0 = time.perf_counter()
            res = k.score_batch(*args, feats)
            t1 = time.perf_counter()
            res.rows.cpu()
            t2 = time.perf_counter()
            total.append((t2 - t0) * 1e3)
            launch.append((t1 - t0) * 1e3)
            fetch.append((t2 - t1) * 1e3)
        b = args[2].shape[0]
        out = {"p50_ms": statistics.median(total), "p99_ms": pct(total, 99),
               "launch_p50_ms": statistics.median(launch),
               "fetch_p50_ms": statistics.median(fetch),
               "evals_per_s": DISPATCHES * b / (sum(total) / 1e3)}
        log(f"batched[sync {label}] {DISPATCHES} dispatches, each ending in "
            f"a .cpu() of rows: p50 {out['p50_ms']:.4f} ms, p99 "
            f"{out['p99_ms']:.4f} ms (launch p50 {out['launch_p50_ms']:.4f} "
            f"ms, fetch p50 {out['fetch_p50_ms']:.4f} ms), "
            f"{out['evals_per_s']:.1f} evals/s (card: {card})")
        return out

    def pipelined():
        """PIPELINE_DEPTH dispatches in flight; each dispatch's rows copy
        into its own pinned buffer right behind its kernel, and the host
        reads the oldest as it drains."""
        inflight = []
        t0 = time.perf_counter()
        for i in range(PIPE_DISPATCHES):
            res = k.score_batch(*big_args, feats)
            buf = pinned[i % PIPELINE_DEPTH]
            buf.copy_(res.rows, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
            inflight.append((ev, buf))
            if len(inflight) >= PIPELINE_DEPTH:
                ev0, buf0 = inflight.pop(0)
                ev0.synchronize()
                int(buf0[0])
        for ev0, buf0 in inflight:
            ev0.synchronize()
            int(buf0[0])
        secs = time.perf_counter() - t0
        return PIPE_DISPATCHES * SCORE_BATCH / secs, secs

    k.reset_counts()
    fn(*e_args).rows.cpu()
    sync_big = sync_loop(big_args, f"B={SCORE_BATCH}")
    sync_small = sync_loop(small_args, f"B={INTERACTIVE_BATCH}")
    pipe_rate, pipe_s = pipelined()
    launches = k.score_batch.launches
    plain_calls = k.score_batch_plain.calls
    made = 1 + 2 * (2 + DISPATCHES) + PIPE_DISPATCHES
    log(f"batched[pipelined B={SCORE_BATCH}] depth {PIPELINE_DEPTH}, "
        f"{PIPE_DISPATCHES} dispatches in {pipe_s:.4f} s = {pipe_rate:.1f} "
        f"evals/s (card: {card})")
    log(f"batched: launches during the main path {launches} for {made} "
        f"dispatches, plain version {plain_calls} calls")
    if launches != made or plain_calls != 0:
        raise AssertionError(f"score_batch launched {launches} times for "
                             f"{made} dispatches, plain {plain_calls}")

    # Times of the kernel alone, the plain version, the bound.
    r = results["score_batch"]
    timing = {}
    for label, args in ((SCORE_BATCH, big_args), (INTERACTIVE_BATCH, small_args)):
        ms = time_cuda(lambda: k.score_batch(*args, feats), runs=20)
        dev_us = device_us_per_launch(lambda: k.score_batch(*args, feats),
                                      "score_batch_kernel")
        timing[label] = (ms, dev_us)
    packed = k.pack_batch_result(k.score_batch(*big_args, feats))
    plain_ms = time_cuda(lambda: score_plain_in_chunks(big_args, feats),
                         runs=3, warmup=1)
    work = score_batch_work(arrays, stacked(big_reqs), feats, big_args, packed)
    b_ms, by = bound(*work)
    ms, dev_us = timing[SCORE_BATCH]
    r.update(launches=launches, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
             bound_by=by, library_ms=None, device_us=dev_us,
             matches_plain=True)
    results["batched"] = {
        "sync_4096": sync_big, "sync_256": sync_small,
        "pipelined_evals_per_s": pipe_rate,
        "ms_256": timing[INTERACTIVE_BATCH][0],
        "device_us_256": timing[INTERACTIVE_BATCH][1],
    }
    n = int(arrays.used.shape[0])
    r["launch"] = {b: k.score_batch_shape(n, b, feats) for b in timing}
    for label, (t_ms, t_us) in timing.items():
        log(f"timing score_batch B={label}: {t_ms:.4f} ms by CUDA events, "
            f"{fmt_us(t_us)} a launch on the device (profiler); launch "
            f"{r['launch'][label]} (card: {card})")
    log(f"timing score_batch B={SCORE_BATCH}: plain version {plain_ms:.3f} ms "
        f"(chunks of {PLAIN_CHUNK} lanes); bound {b_ms:.5f} ms by {by}; "
        f"{work[0]} bytes, {work[1]:.4g} ops (card: {card})")
    trace_sync(big_args, feats, card)


def trace_sync(args, feats, card: str, n: int = 20) -> None:
    """``n`` sync dispatches at B=4096 under the CUDA profiler: the card's
    busy share of the window's wall time, and device time by activity
    (the kernel, the result conversions, the device-to-host copy)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from nomad_tpu_torch.ops import kernels as k

    k.score_batch(*args, feats).rows.cpu()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            k.score_batch(*args, feats).rows.cpu()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((us, e.count, e.key))
    if not rows:
        log(f"batched trace: {n} sync dispatches in {wall:.4f} s; device busy "
            "share not measured (the profiler recorded no device activity)")
        return
    busy_s = sum(us for us, _, _ in rows) / 1e6
    log(f"batched trace: {n} sync dispatches at B={SCORE_BATCH} in "
        f"{wall * 1e3:.3f} ms under the profiler; device busy "
        f"{busy_s * 1e3:.3f} ms = {100.0 * busy_s / wall:.2f}%, idle "
        f"{100.0 - 100.0 * busy_s / wall:.2f}% (card: {card})")
    for us, count, key in sorted(rows, reverse=True)[:6]:
        log(f"  device {us / 1e3:9.3f} ms  x{count:<5d} {key[:70]}")
    kept_records(rows, "score_batch_kernel", n)


# ---------------------------------------------------------------------------
# Phase 8: the plan verify
# ---------------------------------------------------------------------------


class HostVerifyRecorder:
    """Wraps the applier's ``host_verify`` (server/plan_apply.py) and, while
    ``armed``, keeps each call's inputs, the host mirror's used, totals and
    eligible columns it read, and its verdicts."""

    def __init__(self):
        from nomad_tpu_torch.server import plan_apply

        self.module = plan_apply
        self.real = plan_apply.host_verify
        self.armed = False
        self.calls = []
        plan_apply.host_verify = self

    def __call__(self, host, rows, deltas, elig_required):
        out = self.real(host, rows, deltas, elig_required)
        if self.armed:
            self.calls.append(dict(
                used=np.array(host["used"]), totals=np.array(host["totals"]),
                eligible=np.array(host["eligible"]),
                rows=np.asarray(rows, np.int32), deltas=np.stack(deltas),
                elig_required=np.asarray(elig_required, bool), verdicts=out))
        return out

    def close(self) -> None:
        self.module.host_verify = self.real


def seeded_plan(m):
    """(host columns, rows, deltas, elig_required): a seeded plan of
    K=10,000 rows on cluster ``m`` (padding, deltas past the node's room,
    negative deltas, exact room, ineligible nodes, a mixed
    elig_required)."""
    rng = np.random.default_rng(31)
    host = m.snapshot_host()
    cols = {"used": np.array(host["used"]), "totals": np.array(host["totals"]),
            "eligible": np.array(host["eligible"])}
    off = rng.choice(N_NODES, 300, replace=False)
    cols["eligible"][off] = False
    k_rows = VERIFY_ROWS
    rows = rng.integers(0, N_NODES, k_rows).astype(np.int32)
    rows[rng.random(k_rows) < 0.05] = -1
    safe = np.maximum(rows, 0)
    room = cols["totals"][safe] - cols["used"][safe]
    deltas = (room * rng.uniform(0.3, 1.3, (k_rows, 3))).astype(np.float32)
    deltas[rng.random(k_rows) < 0.05] *= -1.0
    exact = rng.random(k_rows) < 0.02
    deltas[exact] = room[exact]
    elig_required = rng.random(k_rows) < 0.6
    return cols, rows, deltas, elig_required


def plan_verify_cases(m, recorder):
    """(label, host columns, rows, deltas, elig_required, applier verdicts
    or None): (a) the seeded plan of K=10,000 rows on the phase-2 cluster
    (``seeded_plan``), (b) each plan check the applier made for
    node-exporter in the system phase."""
    cases = [("seeded", *seeded_plan(m), None)]
    for i, c in enumerate(recorder.calls):
        cases.append((f"node-exporter plan {i}",
                      {f: c[f] for f in ("used", "totals", "eligible")},
                      c["rows"], c["deltas"], c["elig_required"],
                      c["verdicts"]))
    return cases


def verify_plan_fit_work(cols, rows):
    """(bytes, float32 ops): each row's index, delta, elig_required and
    verdict byte, and the used, totals and eligible byte of each distinct
    node a live row names, once; three adds and three compares a live
    row."""
    live = rows[rows >= 0]
    nbytes = len(rows) * (4 + 12 + 1 + 1) + len(np.unique(live)) * (12 + 12 + 1)
    return nbytes, 6 * len(live)


def phase_plan_verify(card: str, m, recorder, results: dict) -> None:
    """verify_plan_fit on the seeded plan and on the applier's recorded
    node-exporter plans, with the counts zeroed around those calls; then
    against its plain version and the applier's host_verify, every row;
    then its times at K=10,000."""
    import types

    import torch

    from nomad_tpu_torch.ops import kernels as k
    from nomad_tpu_torch.server.plan_apply import host_verify

    cases = plan_verify_cases(m, recorder)
    if len(cases) < 2:
        raise AssertionError("no node-exporter plan check was recorded")
    on = {}
    for label, cols, rows, deltas, er, _ in cases:
        arrays = types.SimpleNamespace(**{
            f: torch.from_numpy(v).to("cuda") for f, v in cols.items()})
        on[label] = (arrays, torch.from_numpy(rows).to("cuda"),
                     torch.from_numpy(deltas).to("cuda"),
                     torch.from_numpy(er).to("cuda"))
    k.reset_counts()
    got = {label: k.verify_plan_fit(*on[label]) for label, *_ in cases}
    torch.cuda.synchronize()
    launches = k.verify_plan_fit.launches
    plain_calls = k.verify_plan_fit_plain.calls
    if launches != len(cases) or plain_calls:
        raise AssertionError(f"verify_plan_fit launched {launches} times for "
                             f"{len(cases)} plans, plain {plain_calls}")
    err = 0.0
    for label, cols, rows, deltas, er, applier in cases:
        g = got[label]
        raw = g.view(torch.uint8).cpu()
        g = g.cpu().numpy()
        plain = k.verify_plan_fit_plain(*on[label]).cpu().numpy()
        hv = host_verify(cols, rows, list(deltas), er)
        diff = int((g != plain).sum()) + int((g != hv).sum())
        if applier is not None:
            diff += int((g != applier).sum())
        err = max(err, float(np.abs(g.astype(np.int32)
                                    - plain.astype(np.int32)).max()))
        log(f"verify[{label}] verify_plan_fit vs plain vs host_verify"
            f"{' vs the applier' if applier is not None else ''}: {diff} rows "
            f"differ of {len(rows)}; {int((rows < 0).sum())} padding, "
            f"{int((~g).sum())} refused")
        if int(raw.max()) > 1:
            raise AssertionError(f"verify {label}: an output byte is not 0/1")
        if diff:
            raise AssertionError(f"verify_plan_fit disagrees on {label}")
        if label == "seeded" and (g.all() or not g.any()):
            raise AssertionError("the seeded plan refused nothing or all")

    label, cols, rows, *_ = cases[0]
    args = on[label]
    ms = time_cuda(lambda: k.verify_plan_fit(*args), runs=20)
    dev_us = device_us_per_launch(lambda: k.verify_plan_fit(*args),
                                  "verify_plan_fit_kernel")
    plain_ms = time_cuda(lambda: k.verify_plan_fit_plain(*args), runs=20)
    work = verify_plan_fit_work(cols, rows)
    b_ms, by = bound(*work)
    split = plan_fit_wrapper_split(*args, card)
    results["verify_plan_fit"] = {
        "launches": launches, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
        "library_ms": None, "device_us": dev_us, "matches_plain": True,
        "host_split_us": split,
    }
    log(f"timing verify_plan_fit K={len(rows)}: {ms:.4f} ms by CUDA events, "
        f"{fmt_us(dev_us)} a launch on the device (profiler); plain version "
        f"{plain_ms:.3f} ms; bound {b_ms:.6f} ms by {by}; {work[0]} bytes, "
        f"{work[1]} ops (card: {card})")


# ---------------------------------------------------------------------------
# Phase 9: restart (the write-ahead log, snapshots, restore, snapshot install)
# ---------------------------------------------------------------------------

RESTART_BIG_CPU = 64_000  # the node that unblocks the restored blocked eval


def crash_stop(srv) -> None:
    """Stop a server's threads without the clean-shutdown snapshot: what
    is on disk is what a crash leaves (each append is flushed before its
    mutation applies)."""
    wal = srv.store.wal
    srv.store.wal = None
    srv.shutdown()
    wal.close()


def restart_config(data_dir: str):
    cfg = server_config()
    cfg.data_dir = data_dir
    return cfg


def restart_job(label: str, i: int):
    job = service_job(i)
    job.id = job.name = f"restart-{label}-{i:02d}"
    return job


def huge_job():
    """A job no server node has room for: its eval blocks, and places on
    the big node that registers after the restart."""
    job = restart_job("huge", 0)
    job.task_groups[0].count = 1
    job.task_groups[0].tasks[0].resources.cpu = RESTART_BIG_CPU // 2
    return job


def big_node():
    node = server_node(0)
    node.id = node.name = "restart-big"
    node.resources.cpu = RESTART_BIG_CPU
    node.resources.memory_mb = 1 << 20
    return node


def host_equal(ma, mb, label: str) -> None:
    """Every field of two matrices' host arrays equal row for row (NaN
    columns included), and the same node on every row."""
    ha, hb = ma.snapshot_host(), mb.snapshot_host()
    for f in ha:
        if not np.array_equal(ha[f], hb[f],
                              equal_nan=ha[f].dtype.kind == "f"):
            raise AssertionError(f"{label}: matrix field {f} differs")
    if ma.row_of != mb.row_of:
        raise AssertionError(f"{label}: matrix rows hold other nodes")


def tensors_equal(a, b) -> bool:
    """Bitwise equality (NaN columns compare equal to themselves)."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.is_floating_point:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def new_allocs(srv, before: set, prefix: str) -> list:
    return [a for a in srv.store.allocs.values()
            if a.id not in before and not a.terminal_status()
            and a.job_id.startswith(prefix)]


def check_new_burst(srv, before: set, prefix: str, label: str) -> int:
    """Each job of a restart burst holds exactly SERVER_COUNT live allocs,
    on nodes the store holds, and no node is over capacity."""
    allocs = new_allocs(srv, before, prefix)
    per_job = {}
    for a in allocs:
        if srv.store.node_by_id(a.node_id) is None:
            raise AssertionError(f"{label}: alloc on unknown node {a.node_id}")
        per_job[a.job_id] = per_job.get(a.job_id, 0) + 1
    if (len(allocs) != SERVER_JOBS * SERVER_COUNT
            or set(per_job.values()) != {SERVER_COUNT}):
        raise AssertionError(f"{label}: {len(allocs)} allocs over "
                             f"{len(per_job)} jobs, expected "
                             f"{SERVER_JOBS} x {SERVER_COUNT}")
    check_capacity(srv, label)
    return len(allocs)


def system_targets(srv, job, match) -> set:
    """The nodes ``job`` must land on: those ``match(node)`` takes with
    room for its ask."""
    r = job.task_groups[0].combined_resources()
    ask = np.array([r.cpu, r.memory_mb, r.disk_mb], np.float32)
    with srv.matrix._host_lock:
        host = srv.matrix.snapshot_host()
        room = np.all(host["used"] + ask <= host["totals"], axis=1)
    return {nid for nid, node in list(srv.store.nodes.items())
            if match(node) and room[srv.matrix.row_of[nid]]}


def run_system_job(srv, job, want: set, label: str) -> float:
    t0 = time.perf_counter()
    ev = srv.submit_job(job)
    while not srv.store.eval_by_id(ev.id).terminal_status():
        if time.perf_counter() - t0 > LIFECYCLE_TIMEOUT_S:
            raise AssertionError(f"{label}: {job.id} eval not terminal")
        time.sleep(0.005)
    secs = time.perf_counter() - t0
    if srv.store.eval_by_id(ev.id).status != "complete":
        raise AssertionError(f"{label}: {job.id} eval "
                             f"{srv.store.eval_by_id(ev.id).status}")
    expect_system(srv, job, want, label)
    return secs


def path_launches(k) -> dict:
    return {
        "fused_place": k.fused_place.launches,
        "allocs_fit_verify": k.allocs_fit_verify.launches,
        "system_feasible": k.system_feasible.launches,
        "place_batch": k.place_batch.launches,
        "plain": (k.place_lanes.calls + k.verify_lanes.calls
                  + k.system_feasible_plain.calls),
    }


def check_path_launches(launches: dict, label: str) -> None:
    """The restored and the installed server place through the three
    kernels of the fused and system paths, never a plain version."""
    if (launches["fused_place"] <= 0 or launches["allocs_fit_verify"] <= 0
            or launches["system_feasible"] <= 0):
        raise AssertionError(f"{label}: a kernel never launched: {launches}")
    if launches["plain"] or launches["place_batch"]:
        raise AssertionError(f"{label}: a plain version or the staged "
                             f"kernel ran: {launches}")


def phase_restart(card: str, results: dict) -> None:
    """A server that journals to a data directory takes the server phase's
    work, is crash-stopped, and a second server restores it from the
    write-ahead log; its tables, matrix host arrays and (after one full
    upload) device tensors equal the first's, and it places a burst, a
    system job and its restored blocked eval through the kernels.  Its
    clean shutdown writes a snapshot a third server restores alone; that
    image is then installed into a running server whose matrix is already
    on the card, which places a system job and a burst on it."""
    import collections

    import torch

    from nomad_tpu_torch.ops import kernels as k
    from nomad_tpu_torch.server.server import Server
    from nomad_tpu_torch.state.wal import WriteAheadLog

    exporter, shipper = system_jobs()
    tmp = tempfile.mkdtemp(prefix="nomad-restart-")
    data = str(Path(tmp) / "data")
    servers = []
    out = results.setdefault("restart", {})
    try:
        # 0. The journaled run's baseline: the same cluster and burst on a
        # server without a data directory.
        base = Server(server_config(), device="cuda")
        servers.append(base)
        base.start()
        t0 = time.perf_counter()
        register_cluster(base, "restart (no WAL)", preload=False)
        out["register_s"] = time.perf_counter() - t0
        evals, elapsed = burst(base, [restart_job("a", i)
                                      for i in range(SERVER_JOBS)])
        check_new_burst(base, set(), "restart-a-", "restart burst (no WAL)")
        out["burst_evals_per_s"] = SERVER_JOBS / elapsed
        out["burst_retried"] = retried_evals(base, evals)
        base.shutdown()

        # 1. The first server journals the work: 10,000 nodes, a 64-job
        # burst, node-exporter, and a job whose eval blocks.
        srv = Server(restart_config(data), device="cuda")
        servers.append(srv)
        srv.start()
        t0 = time.perf_counter()
        register_cluster(srv, "restart", preload=False)
        out["wal_register_s"] = time.perf_counter() - t0
        evals, elapsed = burst(srv, [restart_job("a", i)
                                     for i in range(SERVER_JOBS)])
        check_new_burst(srv, set(), "restart-a-", "restart burst (WAL)")
        out["wal_burst_evals_per_s"] = SERVER_JOBS / elapsed
        out["wal_burst_retried"] = retried_evals(srv, evals)
        run_system_job(srv, exporter, system_targets(
            srv, exporter, lambda n: True), "restart")
        srv.submit_job(huge_job())
        wait_quiet(srv, "restart: first server")
        if not any(e.status == "blocked" and e.job_id == "restart-huge-00"
                   for e in srv.store.evals.values()):
            raise AssertionError("restart: the huge job's eval did not block")
        n_entries = srv.store.wal.seq
        log(f"restart: WAL burst {SERVER_JOBS} jobs x {SERVER_COUNT} in "
            f"{elapsed:.3f} s = {out['wal_burst_evals_per_s']:.1f} evals/s "
            f"({out['wal_burst_retried']} retried), the same cluster's "
            f"burst without the WAL {out['burst_evals_per_s']:.1f} evals/s "
            f"({out['burst_retried']} retried); {N_NODES} registrations "
            f"{out['wal_register_s']:.3f} s with it, "
            f"{out['register_s']:.3f} s without; {n_entries} log entries, "
            f"{os.path.getsize(Path(data) / 'wal.jsonl')} bytes "
            f"(card: {card})")

        # 2. Crash-stop; bring the first server's device copy up to date.
        crash_stop(srv)
        src_arrays = srv.matrix.sync()
        image = srv.store.to_snapshot_wire()

        # 3. The second server restores from the log alone.
        t0 = time.perf_counter()
        srv2 = Server(restart_config(data), device="cuda")
        out["restore_wal_s"] = time.perf_counter() - t0
        servers.append(srv2)
        if srv2.store.to_snapshot_wire() != image:
            raise AssertionError("restart: restored tables differ")
        if srv2.store.latest_index != srv.store.latest_index:
            raise AssertionError("restart: restored latest index differs")
        host_equal(srv.matrix, srv2.matrix, "restart (WAL)")
        if srv2.matrix.full_uploads:
            raise AssertionError("restart: uploaded before the first sync")
        t0 = time.perf_counter()
        arrays2 = srv2.matrix.sync()
        torch.cuda.synchronize()
        out["full_upload_ms"] = (time.perf_counter() - t0) * 1e3
        if srv2.matrix.full_uploads != 1 or srv2.matrix.scatter_syncs:
            raise AssertionError("restart: the first sync was not one full "
                                 "upload")
        out["full_upload_bytes"] = srv2.matrix.upload_bytes_total
        for f, a in arrays2._asdict().items():
            if not tensors_equal(a, getattr(src_arrays, f)):
                raise AssertionError(f"restart: device column {f} differs "
                                     "from the first server's")
        log(f"restart: {len(srv2.store.nodes)} nodes, "
            f"{len(srv2.store.allocs)} allocs, {len(srv2.store.evals)} evals "
            f"restored from {n_entries} log entries in "
            f"{out['restore_wal_s']:.3f} s; first sync one full upload of "
            f"{out['full_upload_bytes']} bytes in {out['full_upload_ms']:.3f} "
            f"ms, every column equal to the first server's (card: {card})")

        # 4. The restored server places, counts zeroed just before.
        sub = srv2.store.events.subscribe()
        srv2.start()
        k.reset_counts()
        before = set(srv2.store.allocs)
        evals, elapsed = burst(srv2, [restart_job("b", i)
                                      for i in range(SERVER_JOBS)])
        check_new_burst(srv2, before, "restart-b-", "restored burst")
        out["restored_burst_evals_per_s"] = SERVER_JOBS / elapsed
        sys_s = run_system_job(
            srv2, shipper, system_targets(
                srv2, shipper,
                lambda n: n.datacenter == "dc1" and n.node_class != "class-3"),
            "restored")
        srv2.register_node(big_node())
        t0 = time.perf_counter()
        while [a.node_id for a in live_allocs(srv2, "restart-huge-00")] != [
                "restart-big"]:
            if time.perf_counter() - t0 > LIFECYCLE_TIMEOUT_S:
                raise AssertionError("restart: the restored blocked eval "
                                     "did not place on the big node")
            time.sleep(0.01)
        wait_quiet(srv2, "restored server")
        launches = path_launches(k)
        check_path_launches(launches, "restored server")
        out["restored_launches"] = launches
        mx = srv2.matrix
        out["scatters"] = {
            "syncs": mx.scatter_syncs, "rows": mx.rows_scattered_total,
            "bytes": mx.upload_bytes_total - out["full_upload_bytes"],
        }
        log(f"restart: restored server placed {SERVER_JOBS} jobs x "
            f"{SERVER_COUNT} at {out['restored_burst_evals_per_s']:.1f} "
            f"evals/s, log-shipper on its nodes in {sys_s:.3f} s, the "
            f"restored blocked eval on the big node; launches {launches}; "
            f"after the one full upload {mx.full_uploads - 1} more, "
            f"{mx.scatter_syncs} dirty-row scatters of "
            f"{mx.rows_scattered_total / max(1, mx.scatter_syncs):.1f} rows, "
            f"{out['scatters']['bytes']} bytes in all (card: {card})")

        # 5. Clean shutdown: a snapshot and an empty log; a third server
        # restores from the snapshot alone.
        srv2.shutdown()
        image2 = srv2.store.to_snapshot_wire()
        snap, entries = WriteAheadLog(data).load()
        if snap is None or entries:
            raise AssertionError(f"restart: shutdown left snapshot "
                                 f"{snap is not None}, {len(entries)} log "
                                 "entries")
        events = []
        while True:
            batch = sub.next(timeout=0.2)
            if not batch:
                break
            events.extend(batch)
        out["events_per_topic"] = dict(collections.Counter(
            e.topic for e in events))
        out["health"] = srv2.observatory.health_report()["status"]
        out["slo"] = {r["name"]: r["status"]
                      for r in srv2.observatory.slo_report()["slos"]}
        out["controller"] = srv2.overload_controller.report()["state"]
        t0 = time.perf_counter()
        srv3 = Server(restart_config(data), device="cuda")
        out["restore_snapshot_s"] = time.perf_counter() - t0
        servers.append(srv3)
        if srv3.store.to_snapshot_wire() != image2:
            raise AssertionError("restart: snapshot-restored tables differ")
        if {k_: v for k_, v in snap.items() if k_ != "wal_seq"} != image2:
            raise AssertionError("restart: the snapshot is not the image")
        host_equal(srv2.matrix, srv3.matrix, "restart (snapshot)")
        log(f"restart: snapshot of {os.path.getsize(Path(data) / 'snapshot.json')}"
            f" bytes restored in {out['restore_snapshot_s']:.3f} s; events "
            f"{out['events_per_topic']}; health {out['health']}, SLOs "
            f"{out['slo']}, controller {out['controller']} (card: {card})")

        # 6. Install the image into a running server whose matrix is on
        # the card; it places a system job and a burst on the new state.
        srv4 = Server(server_config(), device="cuda")
        servers.append(srv4)
        srv4.start()
        for i in range(512):
            node = server_node(i)
            node.id = node.name = f"other-{i:03d}"
            srv4.register_node(node)
        burst(srv4, [restart_job("c", i) for i in range(8)])
        old = srv4.matrix._device
        uploads = srv4.matrix.full_uploads
        t0 = time.perf_counter()
        srv4.install_snapshot(snap, seq=snap["wal_seq"])
        out["install_s"] = time.perf_counter() - t0
        if srv4.store.to_snapshot_wire() != image2:
            raise AssertionError("restart: installed tables differ")
        host_equal(srv2.matrix, srv4.matrix, "restart (install)")
        k.reset_counts()
        before = set(srv4.store.allocs)
        again = system_jobs()[0]
        again.id = again.name = "restart-exporter"
        again.task_groups[0].tasks[0].resources.networks[0].reserved_ports = [
            SYSTEM_PORT + 1]
        sys_s = run_system_job(srv4, again, system_targets(
            srv4, again, lambda n: True), "installed")
        evals, elapsed = burst(srv4, [restart_job("d", i)
                                      for i in range(SERVER_JOBS)])
        check_new_burst(srv4, before, "restart-d-", "installed burst")
        launches = path_launches(k)
        check_path_launches(launches, "installed server")
        if srv4.matrix.full_uploads != uploads + 1:
            raise AssertionError(
                f"restart: {srv4.matrix.full_uploads - uploads} full uploads "
                "after the install, expected one")
        cols = srv4.matrix._device
        if any(a is b for a, b in zip(cols, old)):
            raise AssertionError("restart: the install kept a device column")
        if not all(r() is t for r, t in zip(k._checked_matrices.entries[0][0], cols)):
            raise AssertionError("restart: the kernels' memoised columns are "
                                 "not the installed matrix's")
        out["installed_launches"] = launches
        out["installed_burst_evals_per_s"] = SERVER_JOBS / elapsed
        log(f"restart: installed {len(srv4.store.nodes)} nodes into a running "
            f"server in {out['install_s']:.3f} s; one full upload after it; "
            f"restart-exporter on every node in {sys_s:.3f} s, a burst at "
            f"{out['installed_burst_evals_per_s']:.1f} evals/s; launches "
            f"{launches} (card: {card})")
    finally:
        for s_ in servers:
            s_.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# Phase 10: guarded and traced
# ---------------------------------------------------------------------------

# The service burst's jobs as an operator writes them (``service_job``'s
# shape), and node-exporter (``system_jobs``'s first).
SERVICE_HCL = """
job "{id}" {{
  name        = "my-job"
  type        = "service"
  priority    = 50
  datacenters = ["dc1", "dc2", "dc3", "dc4"]
  group "web" {{
    count = {count}
    task "web" {{
      driver = "mock"
      resources {{
        cpu    = {cpu}
        memory = {memory}
      }}
    }}
  }}
}}
"""
EXPORTER_HCL = """
# One metrics exporter on every node, on a static port.
job "node-exporter" {
  name        = "node-exporter"
  type        = "system"
  priority    = 100
  datacenters = ["dc1", "dc2", "dc3", "dc4"]
  group "system" {
    count = 0
    task "sys" {
      driver = "mock"
      resources {
        cpu    = 100
        memory = 64
        network {
          port "metrics" { static = 9100 }
        }
      }
    }
  }
}
"""
SUBMIT_POLICY = 'namespace "default" { capabilities = ["submit-job"] }'
# Every eval of the burst carries these spans in its own trace;
# coalescer.launch is recorded once per dispatch on the dispatch thread.
EVAL_SPANS = ("broker.queue_wait", "eval.process", "worker.invoke_scheduler",
              "coalescer.queue_wait", "coalescer.device", "plan.submit",
              "plan.queue_wait", "plan.apply")
PHASE_TIMERS = ("broker.queue_wait", "coalescer.device", "coalescer.launch",
                "coalescer.queue_wait", "eval.process", "plan.apply",
                "plan.queue_wait", "plan.submit", "sched.dispatch",
                "sched.encode", "sched.feasibility", "worker.invoke_scheduler",
                "worker.wait_for_index")
# The wedge drill's breaker (NOMAD_TPU_DEVICE_* knobs) and reaper delay.
# No cooldown: with one, a canary whose verdict lands sooner than the
# cooldown after the half-open flip leaves the breaker half-open (and a
# drill whose jobs all place through such canaries ends there).
DRILL_KNOBS = {"NOMAD_TPU_DEVICE_DEADLINE_MS": "200",
               "NOMAD_TPU_DEVICE_WEDGE_FACTOR": "1.5",
               "NOMAD_TPU_DEVICE_PROBATION": "1",
               "NOMAD_TPU_DEVICE_COOLDOWN": "0"}
DRILL_UNBLOCK_DELAY_S = 3.0
DRILL_JOBS = 16
RETRY_INTERVAL_S = 2.0  # blocked retries after placement conflicts
# Bursts per comparison, in the order A, B, B, A, A, B, B, A.
PAIRED_ORDER = (0, 1, 1, 0, 0, 1, 1, 0)


def submit_as(srv, secret: str, job):
    """What the API's register route does: the caller's token must hold
    ``submit-job`` in the job's namespace."""
    if not srv.check_acl_capability(secret, "namespace", "submit-job",
                                    job.namespace):
        raise PermissionError(f"token may not submit {job.id}")
    return srv.submit_job(job)


def check_acls(srv) -> str:
    """Bootstrap once, a policy granting submit-job in default and a token
    holding it; returns the token's secret."""
    from nomad_tpu_torch.structs.types import ACLPolicy, ACLToken

    boot = srv.bootstrap_acl()
    try:
        srv.bootstrap_acl()
    except PermissionError:
        pass
    else:
        raise AssertionError("acl: a second bootstrap succeeded")
    srv.store.upsert_acl_policy(srv.next_index(), ACLPolicy(
        name="deployer", rules=SUBMIT_POLICY))
    token = ACLToken(name="deployer", type="client", policies=["deployer"])
    srv.store.upsert_acl_tokens(srv.next_index(), [token])
    verdicts = {
        "token in default": srv.check_acl_capability(
            token.secret_id, "namespace", "submit-job", "default"),
        "token in other": srv.check_acl_capability(
            token.secret_id, "namespace", "submit-job", "other"),
        "empty token": srv.check_acl_capability(
            "", "namespace", "submit-job", "default"),
        "unknown secret": srv.check_acl_capability(
            "not-a-secret", "namespace", "submit-job", "default"),
        "management in other": srv.check_acl_capability(
            boot.secret_id, "namespace", "submit-job", "other"),
    }
    want = {"token in default": True, "token in other": False,
            "empty token": False, "unknown secret": False,
            "management in other": True}
    if verdicts != want or srv.resolve_token("not-a-secret") is not None:
        raise AssertionError(f"acl: decisions {verdicts}")
    log(f"acl: bootstrapped once; decisions {verdicts}")
    return token.secret_id


def hcl_service_job(i: int, prefix: str):
    """The i-th burst job parsed from HCL; its API form must equal that of
    ``service_job(i)`` with the same id."""
    from nomad_tpu_torch.jobspec import job_to_api, parse_job

    want = service_job(i)
    want.id = f"{prefix}-{i:02d}"
    r = want.task_groups[0].tasks[0].resources
    job = parse_job(SERVICE_HCL.format(id=want.id, count=SERVER_COUNT,
                                       cpu=r.cpu, memory=r.memory_mb))
    if job_to_api(job) != job_to_api(want):
        raise AssertionError(f"hcl: {want.id} parses to another job")
    return job


def first_pass(srv, secret: str, jobs, timeout_s: float = 300.0):
    """Submit ``jobs`` with the token and time until each eval has run once
    (terminal, or failed into a blocked retry after placement conflicts);
    then wait for the retries.  Returns (evals, first-pass seconds)."""
    t0 = time.perf_counter()
    evals = [submit_as(srv, secret, job) for job in jobs]
    pending = {e.id for e in evals}
    while pending:
        if time.perf_counter() - t0 > timeout_s:
            raise AssertionError(f"{len(pending)} evals still open")
        pending = {eid for eid in pending
                   if not srv.store.eval_by_id(eid).terminal_status()}
        if pending:
            time.sleep(0.002)
    elapsed = time.perf_counter() - t0
    for job in jobs:
        while len(live_allocs(srv, job.id)) != job.task_groups[0].count:
            if time.perf_counter() - t0 > timeout_s:
                raise AssertionError(f"{job.id} not placed in full")
            time.sleep(0.01)
    return evals, elapsed


def check_spans(srv, evals, card: str, tmp: str) -> None:
    """Every eval's trace holds the service path's spans; each lane's
    device window holds a launch span; the registry has the phase timers;
    the health signals the plan-queue wait; the Perfetto export covers the
    burst; ``top`` renders the breaker's row."""
    import bisect

    from nomad_tpu_torch import trace
    from nomad_tpu_torch.obs import top
    from nomad_tpu_torch.obs.health import collect_signals

    recs = trace.dump()
    by = trace.traces_by_id(recs)
    launches = sorted((r["ts"], r["ts"] + r["dur"]) for r in recs
                      if r["name"] == "coalescer.launch")
    starts = [a for a, _ in launches]
    for ev in evals:
        mine = by.get(ev.id, [])
        missing = set(EVAL_SPANS) - {r["name"] for r in mine}
        if missing:
            raise AssertionError(f"trace: eval {ev.id} lacks {missing}")
        for r in mine:
            if r["name"] != "coalescer.device":
                continue
            i = bisect.bisect_left(starts, r["ts"])
            if i == len(launches) or launches[i][1] > r["ts"] + r["dur"]:
                raise AssertionError(f"trace: no launch inside eval "
                                     f"{ev.id}'s device window")
    snap = srv.metrics.snapshot()
    timers = {k[len("nomad.phase."):] for k in snap
              if k.startswith("nomad.phase.")}
    if set(PHASE_TIMERS) - timers:
        raise AssertionError(f"trace: phase timers lack "
                             f"{set(PHASE_TIMERS) - timers}")
    signals = collect_signals(srv)
    if "plan_queue_wait_p99_ms" not in signals:
        raise AssertionError(f"health: signals {sorted(signals)}")
    path = trace.dump_flight_record(path=str(Path(tmp) / "burst.json"),
                                    reason="chip-smoke")
    doc = json.loads(Path(path).read_text())
    covered = {e["args"]["trace"] for e in doc["traceEvents"]
               if e.get("ph") == "X"}
    if not {ev.id for ev in evals} <= covered:
        raise AssertionError("trace: the export misses evals of the burst")
    srv.observatory.tick()
    screen = top.render(snap, srv.observatory.slo_report(),
                        srv.observatory.health_report(),
                        overload=srv.overload_controller.report())
    rows = [ln for ln in screen.splitlines() if ln.startswith("device  :")]
    if not rows or "closed" not in rows[0]:
        raise AssertionError(f"top: no closed breaker row in\n{screen}")
    p = {k: snap["nomad.phase." + k]["p50_ms"] for k in
         ("coalescer.queue_wait", "coalescer.launch", "coalescer.device",
          "plan.queue_wait", "plan.apply", "eval.process")}
    log(f"trace: {len(recs)} records, {len(by)} traces, {len(launches)} "
        f"launch spans; every eval of the burst has {len(EVAL_SPANS)} "
        f"spans in its trace; {len(timers)} phase timers, p50 ms "
        f"{ {k: round(v, 3) for k, v in p.items()} }; export "
        f"{len(doc['traceEvents'])} events, {os.path.getsize(path)} bytes "
        f"(card: {card})")
    log("top: " + rows[0])


def thread_wait_fetch(ticket, deadline: float, factor: float):
    """The reference's way to wait for a ticket under the watchdog: on
    ``watchdog_fetch``'s sacrificial thread, which synchronises on the
    ticket's event (no thread when the event is already complete); a
    stand-in for ``DeviceCoalescer._wait_fetch``, which polls the event,
    for the comparison bursts."""
    from nomad_tpu_torch.obs.breaker import STALL_OK, watchdog_fetch

    event = ticket.done_event
    if event is None or event.query():
        return STALL_OK, ticket.host.numpy(), 0.0

    def fetch():
        event.synchronize()
        return ticket.host.numpy()

    return watchdog_fetch(fetch, deadline, factor)


def paired_bursts(srv, secret: str, label: str, a, b, prefix: str) -> dict:
    """Bursts of SERVER_JOBS jobs under setting ``a`` and ``b`` in the
    order of PAIRED_ORDER (``a``/``b`` are (name, apply) pairs);
    first-pass evals/s of each, and the retries they left."""
    got = {a[0]: [], b[0]: []}
    for n, (name, apply) in enumerate((a, b)[i] for i in PAIRED_ORDER):
        apply()
        jobs = [hcl_service_job(i, f"{prefix}{n}") for i in range(SERVER_JOBS)]
        evals, elapsed = first_pass(srv, secret, jobs)
        got[name].append((SERVER_JOBS / elapsed, retried_evals(srv, evals)))
    log(f"{label}: first-pass evals/s (retried) "
        + "; ".join(f"{k} {[(round(e, 1), r) for e, r in v]}"
                    for k, v in got.items()))
    return {k: [e for e, _ in v] for k, v in got.items()}


class NackCounter:
    """Counts the worker's "scheduler failed" log records by exception
    type (each is a nack) while installed, and keeps them off stderr."""

    def __init__(self):
        import logging

        self.counts: dict = {}
        self.logger = logging.getLogger("nomad_tpu_torch.server.worker")
        self.handler = logging.Handler()
        self.handler.emit = self._emit
        self.logger.addHandler(self.handler)
        self.propagate = self.logger.propagate
        self.logger.propagate = False

    def _emit(self, record) -> None:
        name = record.exc_info[1].__class__.__name__ if record.exc_info \
            else "none"
        self.counts[name] = self.counts.get(name, 0) + 1

    def close(self) -> None:
        self.logger.removeHandler(self.handler)
        self.logger.propagate = self.propagate


def spin_cycles_per_ms() -> float:
    """``torch.cuda._sleep`` cycles per millisecond, from CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    rates = []
    for _ in range(3):
        start.record()
        torch.cuda._sleep(50_000_000)
        end.record()
        end.synchronize()
        rates.append(50_000_000 / start.elapsed_time(end))
    return statistics.median(rates)


def upload_while_spinning(rate: float, card: str) -> dict:
    """How long an upload of the (lanes, N) tg counts takes to return
    while the stream runs a 300 ms spin: from pageable memory, and through
    a page-locked copy as the coalescer does."""
    import torch

    host = np.zeros((LANES, CAPACITY), np.int32)
    out = {}
    for name, make in (("pageable", lambda: torch.from_numpy(host)),
                       ("page-locked",
                        lambda: torch.from_numpy(host).pin_memory())):
        torch.cuda.synchronize()
        torch.cuda._sleep(int(rate * 300))
        t0 = time.perf_counter()
        make().to("cuda", non_blocking=True)
        out[name] = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
    log(f"drill: a {host.nbytes}-byte upload behind a 300 ms spin returns "
        f"after {out['pageable']:.3f} ms from pageable memory, "
        f"{out['page-locked']:.3f} ms through a page-locked copy "
        f"(card: {card})")
    return out


def wedge_drill(card: str, out: dict) -> None:
    """A server whose breaker has a 200 ms deadline: a spin on the card's
    stream ahead of a dispatch in the slow band gives a slow verdict whose
    placements are used; a longer one wedges a dispatch, trips the
    breaker, which refuses dispatches while open (their evals are nacked),
    and closes through its canary; every job is placed in full after."""
    import torch

    from nomad_tpu_torch.obs.breaker import BREAKER_CLOSED
    from nomad_tpu_torch.ops import kernels as k
    from nomad_tpu_torch.server.server import Server

    cfg = server_config()
    cfg.failed_eval_unblock_delay = DRILL_UNBLOCK_DELAY_S
    cfg.failed_eval_unblock_interval = RETRY_INTERVAL_S
    saved = {name: os.environ.get(name) for name in DRILL_KNOBS}
    os.environ.update(DRILL_KNOBS)
    try:
        srv = Server(cfg, device="cuda")
    finally:
        for name, value in saved.items():
            if value is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = value
    coal = srv.coalescer
    brk = coal.breaker
    deadline_ms = brk.cfg.deadline_ms
    bound_ms = deadline_ms * brk.cfg.wedge_factor
    # The breaker's verdict on each dispatch, and the launches: every
    # launch must follow an admitting verdict.
    verdicts, launched = [], []
    allow, dispatch = brk.allow_device_dispatch, coal._dispatch

    def watched_allow(*a, **kw):
        verdicts.append(allow(*a, **kw))
        return verdicts[-1]

    def watched_dispatch(batch):
        launched.append(len(batch))
        return dispatch(batch)

    brk.allow_device_dispatch = watched_allow
    coal._dispatch = watched_dispatch
    srv.start()
    nacks = NackCounter()
    try:
        register_cluster(srv, "drill", preload=False)
        secret = ""  # ACLs are off on this server
        first_pass(srv, secret, [hcl_service_job(i, "drill-w")
                                 for i in range(DRILL_JOBS)])
        rate = spin_cycles_per_ms()
        out["upload_ms"] = upload_while_spinning(rate, card)
        k.reset_counts()

        # Slow: a spin that ends inside (deadline, deadline x factor] of
        # the dispatch's wait (the wait starts a few ms after the spin).
        slows = brk.slows_total
        spin_ms = (deadline_ms + bound_ms) / 2 + 10.0
        coal.run_device_op(lambda: torch.cuda._sleep(int(rate * spin_ms)))
        job = hcl_service_job(0, "drill-slow")
        first_pass(srv, secret, [job])
        if brk.slows_total != slows + 1 or brk.state != BREAKER_CLOSED:
            raise AssertionError(f"drill: a {spin_ms:.0f} ms spin gave "
                                 f"{brk.report()['outcomes']}")
        log(f"drill: a {spin_ms:.0f} ms spin ahead of a dispatch gave a slow "
            f"verdict; its {SERVER_COUNT} placements were used")

        # Wedge: the spin outlasts the wedge bound twice over.
        spin_ms = 2 * bound_ms
        t_spin = time.time()
        coal.run_device_op(lambda: torch.cuda._sleep(int(rate * spin_ms)))
        jobs = [hcl_service_job(i, "drill") for i in range(DRILL_JOBS)]
        for j in jobs:
            srv.submit_job(j)
        t0 = time.perf_counter()
        while any(len(live_allocs(srv, j.id)) != SERVER_COUNT for j in jobs):
            if time.perf_counter() - t0 > LIFECYCLE_TIMEOUT_S:
                raise AssertionError("drill: jobs not placed after the wedge")
            time.sleep(0.005)
        t_last = time.time()
        wait_quiet(srv, "drill")
        report = brk.report()
        path = [(d["from"], d["to"], d["at"]) for d in report["decisions"]]
        trip = next((at for f, t, at in path if t == "open"), None)
        close = next((at for f, t, at in path
                      if f == "half_open" and t == "closed"), None)
        health = srv.observatory.tick()["device"]
        launches = path_launches(k)
        gauge = srv.metrics.snapshot()["nomad.coalescer.wedged_dispatches"]
        if (trip is None or close is None or close < trip
                or report["state"] != BREAKER_CLOSED):
            raise AssertionError(f"drill: breaker path {path}")
        if coal.wedged_dispatches < 1 or gauge < 1 or health["trips"] < 1:
            raise AssertionError(f"drill: wedged {coal.wedged_dispatches}, "
                                 f"gauge {gauge}, health {health}")
        if nacks.counts.get("DeviceWedgedError", 0) < 1:
            raise AssertionError(f"drill: nacks {nacks.counts}")
        admitted = sum(1 for ok, _ in verdicts if ok)
        refused = len(verdicts) - admitted
        if len(launched) != admitted or refused != report[
                "degraded_dispatches"] or refused < 1:
            raise AssertionError(f"drill: {len(launched)} launches, "
                                 f"{admitted} admitted, {refused} refused")
        if launches["plain"] or launches["fused_place"] <= 0:
            raise AssertionError(f"drill: launches {launches}")
        failed = sum(1 for e in srv.store.evals.values()
                     if e.status == "failed" and e.job_id.startswith("drill-"))
        out.update({
            "spin_to_trip_s": trip - t_spin, "trip_to_close_s": close - trip,
            "spin_to_last_placement_s": t_last - t_spin,
            "wedged_dispatches": coal.wedged_dispatches,
            "refused_dispatches": report["degraded_dispatches"],
            "nacks": dict(nacks.counts), "failed_evals": failed,
            "path": [(f, t) for f, t, _ in path], "launches": launches,
        })
        log(f"drill: a {spin_ms:.0f} ms spin; trip {trip - t_spin:.3f} s "
            f"after it, closed {close - trip:.3f} s after the trip, the last "
            f"of {DRILL_JOBS} jobs placed {t_last - t_spin:.3f} s after the "
            f"spin; breaker {out['path']}; {coal.wedged_dispatches} wedged "
            f"dispatches, {report['degraded_dispatches']} refused, nacks "
            f"{nacks.counts}, {failed} evals failed into reaper follow-ups; "
            f"health device {health}; launches {launches} (card: {card})")
    finally:
        nacks.close()
        srv.shutdown()


def phase_guarded(card: str, results: dict) -> None:
    """ACLs, HCL jobs, spans and their exports on a server of the server
    phase's shape; the burst with tracing on and off, and with the
    resolver polling and waiting on a sacrificial thread; then the wedge
    drill."""
    from nomad_tpu_torch import trace
    from nomad_tpu_torch.jobspec import job_to_api, parse_job
    from nomad_tpu_torch.ops import kernels as k
    from nomad_tpu_torch.server.server import Server

    out = results.setdefault("guarded", {})
    tmp = tempfile.mkdtemp(prefix="nomad-trace-")
    srv = None
    try:
        cfg = server_config()
        cfg.acl_enabled = True
        cfg.failed_eval_unblock_interval = RETRY_INTERVAL_S
        srv = Server(cfg, device="cuda")
        srv.start()
        secret = check_acls(srv)
        register_cluster(srv, "guarded")

        # The HCL burst and node-exporter, submitted with the token.
        exporter = parse_job(EXPORTER_HCL)
        if job_to_api(exporter) != job_to_api(system_jobs()[0]):
            raise AssertionError("hcl: node-exporter parses to another job")
        jobs = [hcl_service_job(i, "hcl") for i in range(SERVER_JOBS)]
        try:
            submit_as(srv, "", jobs[0])
        except PermissionError:
            pass
        else:
            raise AssertionError("acl: an empty token submitted a job")
        trace.configure(enabled=True)
        trace.clear()
        k.reset_counts()
        evals, elapsed = first_pass(srv, secret, jobs)
        counts = check_burst(srv, evals, "guarded burst")
        check_spans(srv, evals, card, tmp)
        # The nodes with room for it, counted before it places.
        want = system_targets(srv, exporter, lambda n: True)
        ev = submit_as(srv, secret, exporter)
        t0 = time.perf_counter()
        while not srv.store.eval_by_id(ev.id).terminal_status():
            if time.perf_counter() - t0 > LIFECYCLE_TIMEOUT_S:
                raise AssertionError("hcl: node-exporter eval not terminal")
            time.sleep(0.005)
        expect_system(srv, exporter, want, "guarded")
        launches = path_launches(k)
        check_path_launches(launches, "guarded")
        out.update({"hcl_evals_per_s": SERVER_JOBS / elapsed,
                    "retried": counts["retried"], "launches": launches})
        log(f"guarded: {SERVER_JOBS} HCL jobs submitted with the token, "
            f"{counts['allocs']} allocations ({counts['retried']} retried), "
            f"first pass {SERVER_JOBS / elapsed:.1f} evals/s; node-exporter "
            f"on its {len(live_allocs(srv, exporter.id))} nodes; launches "
            f"{launches} (card: {card})")

        out["tracing"] = paired_bursts(
            srv, secret, "tracing", ("on", lambda: trace.configure(
                enabled=True)), ("off", lambda: trace.configure(
                    enabled=False)), "tr")
        trace.configure(enabled=True)
        coal = srv.coalescer
        poll_wait = coal._wait_fetch
        out["wait"] = paired_bursts(
            srv, secret, "resolver wait",
            ("poll", lambda: setattr(coal, "_wait_fetch", poll_wait)),
            ("thread", lambda: setattr(coal, "_wait_fetch",
                                       thread_wait_fetch)),
            "wt")
        coal._wait_fetch = poll_wait
        srv.shutdown()
        srv = None
        wedge_drill(card, out)
    finally:
        trace.configure(enabled=True)
        if srv is not None:
            srv.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# Phase 11: real node agents
# ---------------------------------------------------------------------------

AGENTS = 16
AGENT_CLASS = "agent"
AGENT_JOBS = 64  # the service burst through the agents, count 2 each
AGENT_COUNT = 2
RAW_EXEC_COUNT = 16
EXEC_COUNT = 8
DEPLOY_COUNT = 4
FLAKY_AGENT = 3  # the agent whose meta makes the failing task fail
AGENT_WAIT_S = 120.0  # any one condition of the phase
AGENT_SHUTDOWN_S = 60.0  # agents and server down, at most


def agent_meta(i: int) -> dict:
    """Node meta of agent i.  The service burst's affinities read its
    ``pair`` (agents 2k and 2k+1 share pair k).  The failing task reads
    its ``run_for`` and ``exit_code`` from it: 0.2 s and 1 on the flaky
    agent (a node-local fault), an hour and 0 elsewhere, so the
    replacement runs."""
    flaky = i == FLAKY_AGENT
    return {"agent": str(i), "pair": str(i // 2),
            "flaky": "true" if flaky else "false",
            "fault_run_for": "0.2" if flaky else "3600",
            "fault_exit_code": "1" if flaky else "0"}


def agent_job(job_id: str, count: int, job_type: str = "service",
              cpu: int = 50, memory_mb: int = 64):
    """A job constrained to the agents' node class, in their datacenter."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.structs.types import Constraint

    job = mock.job()
    job.id = job.name = job_id
    job.type = job_type
    job.datacenters = ["dc1"]
    tg = job.task_groups[0]
    tg.count = count
    tg.constraints = [Constraint(l_target="${node.class}",
                                 r_target=AGENT_CLASS, operand="=")]
    tg.tasks[0].resources.cpu = cpu
    tg.tasks[0].resources.memory_mb = memory_mb
    tg.ephemeral_disk.size_mb = 10
    return job


def agent_task(name: str, driver: str, command: str, args: list,
               resources):
    from nomad_tpu_torch.structs.types import Task

    config = {"command": command, "args": list(args)}
    if driver == "exec":
        config["cgroup"] = False  # no host cgroup is touched
    return Task(name=name, driver=driver, config=config, resources=resources)


def wait_for(pred, what: str, timeout_s: float = AGENT_WAIT_S,
             tick=None) -> float:
    """Poll ``pred()`` every 5 ms (calling ``tick()`` first); returns
    seconds."""
    t0 = time.perf_counter()
    while True:
        if tick is not None:
            tick()
        if pred():
            return time.perf_counter() - t0
        if time.perf_counter() - t0 > timeout_s:
            raise AssertionError(f"agents: {what} not reached in "
                                 f"{timeout_s:.0f} s")
        time.sleep(0.005)


def job_allocs(srv, job_id: str) -> list:
    return srv.store.allocs_by_job("default", job_id)


def all_running(srv, job_id: str, n: int) -> bool:
    allocs = [a for a in job_allocs(srv, job_id) if not a.terminal_status()]
    return len(allocs) == n and all(a.client_status == "running"
                                    for a in allocs)


class AllocClock:
    """When each alloc of the watched jobs was first seen in the store
    (committed) and first seen reporting ``running``, polled."""

    def __init__(self, srv, job_ids):
        self.srv, self.job_ids = srv, set(job_ids)
        self.committed, self.running = {}, {}

    def tick(self) -> None:
        now = time.perf_counter()
        for a in list(self.srv.store.allocs.values()):
            if a.job_id not in self.job_ids:
                continue
            self.committed.setdefault(a.id, now)
            if a.client_status == "running":
                self.running.setdefault(a.id, now)

    def commit_to_running_ms(self) -> list:
        return sorted((self.running[i] - self.committed[i]) * 1e3
                      for i in self.running)


class _Detached:
    """A crashed agent's hold on its tasks: it reports no exit and touches
    no process."""

    name = "detached"

    def wait_task(self, handle, timeout=None):
        time.sleep(min(timeout or 0.05, 0.05))
        return None

    def stop_task(self, handle, kill_timeout: float) -> None:
        pass

    def destroy_task(self, handle) -> None:
        pass


def crash_agent(agent) -> None:
    """An agent crash in one process: its loops stop, and its runners let
    go of their tasks without stopping them, reporting or persisting (a
    process that died would do none of it either); the tasks and the
    exec sidecar run on."""
    import copy

    agent._shutdown.set()
    with agent._dirty_cond:
        agent._dirty_cond.notify_all()
    agent._run_allocs = lambda allocs: None
    agent._persist = lambda ar: None
    for ar in list(agent.allocs.values()):
        ar._destroyed = True
        ar.on_alloc_update = lambda ar: None
        for tr in list(ar.runners.values()):
            # The store shares these objects in one process: the detached
            # runner's last events go to a copy.
            tr.state = copy.deepcopy(tr.state)
            tr.driver = _Detached()
            tr.kill()


def dead_or_zombie(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as fh:
            return fh.read().split(")")[-1].split()[0] == "Z"
    except OSError:
        return True


def task_pids(agent) -> dict:
    """Process ids of the agent's raw_exec and exec tasks, by alloc id."""
    out = {}
    for aid, ar in list(agent.allocs.items()):
        for tr in list(ar.runners.values()):
            h = tr.handle
            if h is not None and h.driver in ("raw_exec", "exec") and h.pid:
                out.setdefault(aid, []).append(h.pid)
    return out


def sidecar_of(agent):
    return agent.drivers.get("exec")._sidecar


def supervisor_line(sidecar) -> str:
    """What runs the exec driver's tasks: the sidecar's command line."""
    pid = int(sidecar.call("ping")["pid"])
    with open(f"/proc/{pid}/cmdline", "rb") as fh:
        args = [a.decode() for a in fh.read().split(b"\0") if a]
    kind = ("the Python sidecar" if "nomad_tpu_torch.client.executor" in args
            else "a binary")
    return f"{kind} (pid {pid}: {' '.join(args[:3])} ...)"


def check_agent_launches(launches: dict, kernels, label: str) -> None:
    """Each kernel in ``kernels`` launched in the step, and no plain
    version ran."""
    if any(launches[name] <= 0 for name in kernels):
        raise AssertionError(f"agents: {label}: a kernel never launched: "
                             f"{launches}")
    if launches["plain"] or launches["place_batch"]:
        raise AssertionError(f"agents: {label}: a plain version or the "
                             f"staged kernel ran: {launches}")


def phase_agents(card: str, results: dict) -> None:
    """Real node agents (``nomad_tpu_torch.client``) run what the card
    places: 16 in-process agents beside the server phase's 10,000 nodes
    take a service burst, raw_exec and exec jobs (one sidecar killed), an
    agent restart, a failure and its reschedule, a deployment judged by
    their own health reports, a system job, an agent lost, and a stop.
    Nothing here plays the client."""
    from nomad_tpu_torch.client import Client, ClientConfig
    from nomad_tpu_torch.ops import kernels as k
    from nomad_tpu_torch.server.server import Server
    from nomad_tpu_torch.structs.types import (
        Affinity, JobType, ReschedulePolicy, RestartPolicy, UpdateStrategy,
    )

    out = results.setdefault("agents", {})
    # The exec driver runs the Python sidecar in this phase, whatever the
    # checkout holds: native/nomad-executor, where it is built, does not
    # survive the sidecar kill below (ROADMAP R11).
    exec_bin = os.environ.get("NOMAD_TPU_EXECUTOR_BIN")
    os.environ["NOMAD_TPU_EXECUTOR_BIN"] = ""
    tmp = tempfile.mkdtemp(prefix="nomad-agents-")
    cfg = server_config()
    cfg.failed_eval_unblock_interval = RETRY_INTERVAL_S
    srv = Server(cfg, device="cuda")
    agents: list = []   # every Client built, crashed and lost ones too
    sidecars: list = []  # every sidecar process started, to reap
    pids: dict = {}      # alloc id -> task pids seen
    jobs: list = []      # every job id of the phase
    t_phase = time.perf_counter()

    def agent_config(i):
        return ClientConfig(datacenter="dc1", node_class=AGENT_CLASS,
                            data_dir=str(Path(tmp) / f"agent-{i:02d}"),
                            meta=agent_meta(i))

    def note_pids():
        for a in agents:
            for aid, ps in task_pids(a).items():
                pids.setdefault(aid, set()).update(ps)

    def agent_of(node_id):
        live = [a for a in agents if a.node.id == node_id
                and not a._shutdown.is_set()]
        return live[0]

    def submit(job):
        jobs.append(job.id)
        return srv.submit_job(job)

    def reap(agent):
        """Keep the agent's sidecar process, to wait for it at the end."""
        sc = sidecar_of(agent)
        if sc is not None and sc._proc is not None:
            sidecars.append(sc._proc)

    try:
        srv.start()
        register_cluster(srv, "agents")
        t0 = time.perf_counter()
        for i in range(AGENTS):
            a = Client(srv, agent_config(i))
            a.start()
            agents.append(a)
        out["agents_start_s"] = time.perf_counter() - t0
        active = list(agents)
        rows = len(srv.store.nodes)
        if rows != N_NODES + AGENTS or any(
                srv.store.node_by_id(a.node.id).status != "ready"
                for a in agents):
            raise AssertionError(f"agents: {rows} nodes, the agents "
                                 "not all ready")
        n0 = agents[0].node
        log(f"agents: {AGENTS} agents registered in "
            f"{out['agents_start_s']:.3f} s beside {N_NODES} nodes "
            f"({rows} rows of {CAPACITY}); agent 0 fingerprinted cpu "
            f"{n0.resources.cpu} MHz, {n0.resources.memory_mb} MB, "
            f"{n0.attributes.get('cpu.numcores')} cores, drivers "
            f"{sorted(n0.drivers)}; NOMAD_TPU_EXECUTOR_BIN set empty for "
            f"the phase (it was "
            f"{'unset' if exec_bin is None else repr(exec_bin)}) (card: {card})")

        # 2. The service burst, counts zeroed just before: the fused
        # dispatch places, the agents report running.  Binpack alone would
        # stack it on one or two agents; job i's affinity for pair i % 8
        # (two agents, its two allocs kept apart by the job's
        # anti-affinity) spreads it over all of them.
        burst_jobs = []
        for i in range(AGENT_JOBS):
            job = agent_job(f"agents-svc-{i:02d}", AGENT_COUNT,
                            cpu=50 + 25 * (i % 4), memory_mb=64 + 32 * (i % 3))
            job.task_groups[0].affinities = [Affinity(
                l_target="${meta.pair}", r_target=str(i % (AGENTS // 2)),
                operand="=", weight=100)]
            burst_jobs.append(job)
        clock = AllocClock(srv, [j.id for j in burst_jobs])
        dispatches0 = srv.coalescer.dispatches
        k.reset_counts()
        t_submit = time.perf_counter()
        evals = []
        for j in burst_jobs:
            evals.append(submit(j))
            clock.tick()
        want = AGENT_JOBS * AGENT_COUNT

        def placed():
            ends = [last_eval(srv, ev.id) for ev in evals]
            return len(clock.committed) == want and all(
                e is not None and e.terminal_status() for e in ends)

        wait_for(placed, "the burst placed", tick=clock.tick)
        placed_s = time.perf_counter() - t_submit
        wait_for(lambda: len(clock.running) == want, "the burst running",
                 tick=clock.tick)
        running_s = time.perf_counter() - t_submit
        launches = path_launches(k)
        check_agent_launches(launches, ("fused_place", "allocs_fit_verify"),
                             "service burst")
        statuses = sorted({last_eval(srv, e.id).status for e in evals})
        if statuses != ["complete"]:
            raise AssertionError(f"agents: burst eval statuses {statuses}")
        for a in active:
            held = len(srv.store.allocs_by_node(a.node.id))
            if a.num_allocs() != held:
                raise AssertionError(f"agents: agent {a.node.id} runs "
                                     f"{a.num_allocs()} allocs, the store "
                                     f"holds {held}")
        if not all(all_running(srv, j.id, AGENT_COUNT) for j in burst_jobs):
            raise AssertionError("agents: a burst job is not running in full")
        per_agent = sorted(a.num_allocs() for a in active)
        if min(per_agent) == 0:
            raise AssertionError(f"agents: the burst left an agent idle: "
                                 f"allocs per agent {per_agent}")
        lat = clock.commit_to_running_ms()
        dispatches = srv.coalescer.dispatches - dispatches0
        out.update({"placed_s": placed_s, "running_s": running_s,
                    "evals_per_s": AGENT_JOBS / placed_s,
                    "commit_to_running_p50_ms": pct(lat, 50),
                    "commit_to_running_p99_ms": pct(lat, 99),
                    "burst_launches": launches, "per_agent": per_agent,
                    "retried": retried_evals(srv, evals),
                    "dispatches": dispatches})
        log(f"agents: {AGENT_JOBS} service jobs x {AGENT_COUNT}: submit -> "
            f"all placed {placed_s:.3f} s ({out['evals_per_s']:.1f} evals/s, "
            f"{out['retried']} retried), submit -> all running "
            f"{running_s:.3f} s; commit -> running p50 "
            f"{out['commit_to_running_p50_ms']:.1f} ms, p99 "
            f"{out['commit_to_running_p99_ms']:.1f} ms over {len(lat)} "
            f"allocs; allocs per agent {per_agent}; launches {launches} in "
            f"{dispatches} dispatches (card: {card})")
        # Stop the burst: the agents kill its tasks; what follows runs on
        # agents that hold only the phase's real processes.
        t0 = time.perf_counter()
        for j in burst_jobs:
            srv.deregister_job("default", j.id)
        wait_for(lambda: all(a.client_terminal() for j in burst_jobs
                             for a in job_allocs(srv, j.id)),
                 "the burst stopped")
        out["burst_stop_s"] = time.perf_counter() - t0
        log(f"agents: the burst stopped, every alloc terminal, in "
            f"{out['burst_stop_s']:.3f} s (card: {card})")

        # 3a. raw_exec: a batch job whose tasks echo their alloc index.
        t0 = time.perf_counter()
        echo = agent_job("agents-echo", RAW_EXEC_COUNT, job_type="batch",
                         cpu=20, memory_mb=32)
        echo.task_groups[0].tasks = [agent_task(
            "echo", "raw_exec", "/bin/sh", ["-c", "echo $NOMAD_ALLOC_INDEX"],
            echo.task_groups[0].tasks[0].resources)]
        submit(echo)
        wait_for(lambda: len(job_allocs(srv, echo.id)) == RAW_EXEC_COUNT
                 and all(a.client_status == "complete"
                         for a in job_allocs(srv, echo.id)),
                 "the raw_exec batch complete")
        for a in job_allocs(srv, echo.id):
            got = agent_of(a.node_id).read_file(
                a.id, Client.task_log_path("echo", "stdout")).decode()
            if got != f"{a.index}\n":
                raise AssertionError(f"agents: {a.name} printed {got!r}")
        out["raw_exec_s"] = time.perf_counter() - t0

        # 3b. exec under the sidecar; kill -9 one agent's sidecar.
        t0 = time.perf_counter()
        sleeper = agent_job("agents-exec", EXEC_COUNT, cpu=20, memory_mb=32)
        sleeper.task_groups[0].tasks = [agent_task(
            "sleeper", "exec", "/bin/sleep", ["600"],
            sleeper.task_groups[0].tasks[0].resources)]
        submit(sleeper)
        wait_for(lambda: all_running(srv, sleeper.id, EXEC_COUNT),
                 "the exec job running")
        out["exec_s"] = time.perf_counter() - t0
        note_pids()
        victim_alloc = sorted(job_allocs(srv, sleeper.id),
                              key=lambda a: a.name)[0]
        victim = agent_of(victim_alloc.node_id)
        sc = sidecar_of(victim)
        supervisor = supervisor_line(sc)
        if not supervisor.startswith("the Python sidecar"):
            raise AssertionError(f"agents: the exec driver runs {supervisor}, "
                                 "not the Python sidecar")
        old_proc = sc._proc
        old_pid = int(sc.call("ping")["pid"])
        tr = victim.allocs[victim_alloc.id].runners["sleeper"]
        task_pid = tr.handle.pid
        os.kill(old_pid, 9)
        old_proc.wait(timeout=30)
        if dead_or_zombie(task_pid):
            raise AssertionError("agents: the task died with its sidecar")
        t0 = time.perf_counter()
        wait_for(lambda: sc._proc is not old_proc
                 and sc.call("list")["tasks"].get(tr.handle.id, {}).get(
                     "pid") == task_pid, "the task recovered by a new sidecar")
        out["sidecar_recover_s"] = time.perf_counter() - t0
        sidecars.append(old_proc)
        new_pid = int(sc.call("ping")["pid"])
        time.sleep(0.3)  # a few of the runner's waits on the new sidecar
        if (dead_or_zombie(task_pid) or tr.state.restarts
                or not all_running(srv, sleeper.id, EXEC_COUNT)):
            raise AssertionError("agents: the exec task did not survive its "
                                 "sidecar")
        log(f"agents: raw_exec batch of {RAW_EXEC_COUNT} complete, each "
            f"printing its alloc index, in {out['raw_exec_s']:.3f} s; exec "
            f"job of {EXEC_COUNT} running in {out['exec_s']:.3f} s under "
            f"{supervisor}; sidecar {old_pid} killed -9, task {task_pid} "
            f"recovered by sidecar {new_pid} in "
            f"{out['sidecar_recover_s']:.3f} s with no restart (card: {card})")

        # 4. Agent restart: crash an agent holding an exec task, build a new
        # one on its data dir.
        held = {a.node_id for a in job_allocs(srv, sleeper.id)}
        candidates = [i for i, a in enumerate(agents) if a.node.id in held]
        idx = next((i for i in candidates if agents[i] is not victim),
                   candidates[0])
        old = agents[idx]
        old_pids = {aid: ps for aid, ps in task_pids(old).items()
                    if srv.store.alloc_by_id(aid).client_status == "running"}
        if not old_pids:
            raise AssertionError("agents: the restarted agent runs no task")
        reap(old)
        crash_agent(old)
        active.remove(old)
        t0 = time.perf_counter()
        new = Client(srv, agent_config(idx))
        agents.append(new)
        new.start()
        active.append(new)

        def reattached():
            for aid, ps in old_pids.items():
                ar = new.allocs.get(aid)
                if ar is None:
                    return False
                got = [tr.handle.pid for tr in ar.runners.values()
                       if tr.handle is not None]
                if got != ps:
                    return False
                a = srv.store.alloc_by_id(aid)
                if a.client_status != "running" or not any(
                        e["type"] == "Restored"
                        for ts in a.task_states.values() for e in ts.events):
                    return False
            return True

        wait_for(reattached, "the tasks re-attached")
        out["reattach_s"] = time.perf_counter() - t0
        restarts = [ts.restarts for aid in old_pids
                    for ts in srv.store.alloc_by_id(aid).task_states.values()]
        if new.node.id != old.node.id or any(restarts) or any(
                dead_or_zombie(p) for ps in old_pids.values() for p in ps):
            raise AssertionError(f"agents: restart: node {new.node.id} vs "
                                 f"{old.node.id}, restarts {restarts}")
        log(f"agents: agent {idx} crashed and rebuilt on its data dir: same "
            f"node id, {len(old_pids)} running tasks re-attached with the "
            f"same pids and no restart in {out['reattach_s']:.3f} s "
            f"(card: {card})")

        # 5. A failure and its reschedule: the flaky agent's task fails
        # twice; the replacement places through the kernel elsewhere and runs.
        flaky_node = next(a.node.id for a in active
                          if a.config.meta["agent"] == str(FLAKY_AGENT))
        t0 = time.perf_counter()
        k.reset_counts()
        fail = agent_job("agents-fail", 1, cpu=20, memory_mb=32)
        tg = fail.task_groups[0]
        tg.affinities = [Affinity(l_target="${meta.flaky}", r_target="true",
                                  operand="=", weight=100)]
        tg.restart_policy = RestartPolicy(attempts=1, interval=300.0,
                                          delay=0.1, mode="fail")
        tg.reschedule_policy = ReschedulePolicy(
            attempts=1, interval=300.0, delay=0.1, delay_function="constant",
            unlimited=False)
        tg.tasks[0].config = {"run_for": "${meta.fault_run_for}",
                              "exit_code": "${meta.fault_exit_code}"}
        submit(fail)

        def replaced():
            allocs = job_allocs(srv, fail.id)
            failed = [a for a in allocs if a.client_status == "failed"]
            live = [a for a in allocs if a.client_status == "running"
                    and not a.terminal_status()]
            return len(failed) == 1 and len(live) == 1

        wait_for(replaced, "the failed alloc replaced and running")
        out["reschedule_s"] = time.perf_counter() - t0
        launches = path_launches(k)
        check_agent_launches(launches, ("fused_place", "allocs_fit_verify"),
                             "reschedule")
        allocs = job_allocs(srv, fail.id)
        failed = next(a for a in allocs if a.client_status == "failed")
        repl = next(a for a in allocs if a.client_status == "running")
        ts = failed.task_states["web"]
        if (failed.node_id != flaky_node or ts.restarts != 1 or not ts.failed
                or repl.previous_allocation != failed.id
                or repl.node_id == failed.node_id):
            raise AssertionError(
                f"agents: failure: on the flaky agent "
                f"{failed.node_id == flaky_node}, restarts {ts.restarts}, "
                f"replacement of {repl.previous_allocation}, on another node "
                f"{repl.node_id != failed.node_id}")
        log(f"agents: a task failing on the flaky agent restarted once, "
            f"failed, and its replacement runs on another agent "
            f"{out['reschedule_s']:.3f} s after submit; events "
            f"{[e['type'] for e in ts.events]}; launches {launches} "
            f"(card: {card})")

        # 6. A deployment judged by the agents' own health reports.
        def deployment(version):
            for d in list(srv.store.deployments.values()):
                if d.job_id == "agents-deploy" and d.job_version == version:
                    return d
            return None

        def successful(version):
            d = deployment(version)
            return d is not None and d.status == "successful"

        dep = agent_job("agents-deploy", DEPLOY_COUNT, cpu=20, memory_mb=32)
        dep.task_groups[0].update = UpdateStrategy(
            max_parallel=2, min_healthy_time=1.0, healthy_deadline=120.0,
            progress_deadline=600.0)
        t0 = time.perf_counter()
        submit(dep)
        wait_for(lambda: successful(0), "deployment v0 successful")
        out["deploy_v0_s"] = time.perf_counter() - t0
        dep2 = dep.copy()
        dep2.task_groups[0].tasks[0].env = {"V": "2"}
        t0 = time.perf_counter()
        srv.submit_job(dep2)
        wait_for(lambda: successful(1), "deployment v1 successful")
        out["deploy_s"] = time.perf_counter() - t0
        live = [a for a in job_allocs(srv, dep.id) if not a.terminal_status()]
        if sorted(a.job.version for a in live) != [1] * DEPLOY_COUNT or not all(
                a.deployment_status is not None
                and a.deployment_status.healthy for a in live):
            raise AssertionError("agents: deployment: live allocs not all "
                                 "healthy on the new version")
        log(f"agents: deployment of {DEPLOY_COUNT} (max_parallel 2, "
            f"min_healthy_time 1 s): v0 successful in "
            f"{out['deploy_v0_s']:.3f} s, v1 in {out['deploy_s']:.3f} s, "
            f"judged by the agents' health reports (card: {card})")

        # 7. A system job on the agents, through system_feasible.
        t0 = time.perf_counter()
        k.reset_counts()
        sysjob = agent_job("agents-system", 1, cpu=20, memory_mb=32)
        sysjob.type = JobType.SYSTEM.value
        sysjob.task_groups[0].tasks = [agent_task(
            "tick", "raw_exec", "/bin/sleep", ["600"],
            sysjob.task_groups[0].tasks[0].resources)]
        submit(sysjob)
        want_nodes = {a.node.id for a in active}
        wait_for(lambda: all_running(srv, sysjob.id, AGENTS),
                 "the system job running on every agent")
        expect_system(srv, sysjob, want_nodes, "agents")
        launches = path_launches(k)
        check_agent_launches(launches, ("system_feasible",), "system job")
        out["system_s"] = time.perf_counter() - t0
        note_pids()
        log(f"agents: system job on exactly the {AGENTS} agents, each run "
            f"by raw_exec, in {out['system_s']:.3f} s; launches {launches} "
            f"(card: {card})")

        # 8. An agent lost: shut down, its node marked down as a missed
        # TTL does; its service allocs replaced on the others, running.
        service_jobs = (sleeper.id, dep.id, fail.id)
        lost = max(active, key=lambda a: sum(
            1 for x in srv.store.allocs_by_node(a.node.id)
            if x.job_id in service_jobs and not x.terminal_status()))
        lost_allocs = [x for x in srv.store.allocs_by_node(lost.node.id)
                       if not x.terminal_status()]
        want_counts = {j: sum(1 for x in job_allocs(srv, j)
                              if not x.terminal_status())
                       for j in service_jobs}
        note_pids()
        t0 = time.perf_counter()
        k.reset_counts()
        # It stops reporting first (an update batch in flight would report
        # its killed tasks complete), then dies.
        lost._shutdown.set()
        with lost._dirty_cond:
            lost._dirty_cond.notify_all()
        for t in lost._threads:
            if "update-allocs" in t.name:
                t.join(timeout=5.0)
        reap(lost)
        lost.shutdown()
        active.remove(lost)
        srv.update_node_status(lost.node.id, "down")
        wait_for(lambda: all(srv.store.alloc_by_id(x.id).client_status
                             == "lost" for x in lost_allocs),
                 "the lost agent's allocs lost")

        def replaced_all():
            for j, n in want_counts.items():
                if not all_running(srv, j, n):
                    return False
            return True

        wait_for(replaced_all, "the lost service allocs replaced, running")
        out["lost_s"] = time.perf_counter() - t0
        launches = path_launches(k)
        check_agent_launches(launches, ("fused_place", "allocs_fit_verify"),
                             "agent lost")
        moved = sum(1 for x in lost_allocs if x.job_id in service_jobs)
        if not moved:
            raise AssertionError("agents: the lost agent held no service alloc")
        log(f"agents: agent {lost.config.meta['agent']} lost with "
            f"{len(lost_allocs)} allocs ({moved} service); replacements "
            f"running on the others in {out['lost_s']:.3f} s; launches "
            f"{launches} (card: {card})")

        # 9. Stop every job: the agents kill every task.
        note_pids()
        t0 = time.perf_counter()
        for j in sorted(set(jobs)):
            job = srv.store.job_by_id("default", j)
            if job is not None and not job.stopped():
                srv.deregister_job("default", j)
        wait_for(lambda: all(x.client_terminal() for j in set(jobs)
                             for x in job_allocs(srv, j)),
                 "every alloc of the phase stopped")
        all_pids = sorted({p for ps in pids.values() for p in ps})
        wait_for(lambda: all(dead_or_zombie(p) for p in all_pids),
                 "every task process gone", timeout_s=30.0)
        out["stop_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        for a in active:
            reap(a)
            a.shutdown()
        for p in sidecars:
            p.wait(timeout=AGENT_SHUTDOWN_S)
        srv.shutdown()
        srv = None
        out["shutdown_s"] = time.perf_counter() - t0
        if out["shutdown_s"] > AGENT_SHUTDOWN_S:
            raise AssertionError(f"agents: shutdown took "
                                 f"{out['shutdown_s']:.1f} s")
        log(f"agents: {len(set(jobs))} jobs stopped, {len(all_pids)} task "
            f"processes gone in {out['stop_s']:.3f} s; agents, sidecars and "
            f"server down in {out['shutdown_s']:.3f} s; phase "
            f"{time.perf_counter() - t_phase:.1f} s (card: {card})")
    finally:
        for a in agents:
            if not a._shutdown.is_set():
                a.shutdown()
        if srv is not None:
            srv.shutdown()
        # A check that failed may leave sidecars (hung, or a crashed
        # agent's) and tasks behind: none outlives the phase.
        for a in agents:
            sc = sidecar_of(a)
            if sc is not None and sc._proc is not None:
                sidecars.append(sc._proc)
        for proc in sidecars:
            if proc.poll() is None:
                proc.kill()
            proc.wait(timeout=10)
        for ps in pids.values():
            for p in ps:
                if not dead_or_zombie(p):
                    try:
                        os.kill(p, 9)
                    except OSError:
                        pass
        shutil.rmtree(tmp, ignore_errors=True)
        if exec_bin is None:
            os.environ.pop("NOMAD_TPU_EXECUTOR_BIN", None)
        else:
            os.environ["NOMAD_TPU_EXECUTOR_BIN"] = exec_bin


# ---------------------------------------------------------------------------
# Phase 12: the front door (HTTP API, CLI, client-only agents)
# ---------------------------------------------------------------------------

FRONT_AGENTS = 4
FRONT_THREADS = 8  # registration and submission threads
FRONT_ECHO_COUNT = 4
FRONT_CLI_NODES = 64  # nodes of the CLI agent of part 12a
FRONT_SLEEP = "6121"  # every task of the phase sleeps this long (phase_tasks)
FRONT_WAIT_S = 120.0  # any one condition of the phase
FRONT_STOP_S = 30.0  # an agent process stopping on SIGINT, at most
FRONT_DEVICE = "cuda"  # the server agents' device
FRONT_SERVER_HCL = """
server {{
  workers           = {workers}
  node_capacity     = {capacity}
  heartbeat_min_ttl = 3600
  heartbeat_max_ttl = 7200
  acl_enabled       = {acl}
}}
client {{
  enabled = false
}}
"""
FRONT_AGENT_HCL = """
data_dir   = "{data_dir}"
datacenter = "dc1"
client {{
  enabled    = true
  node_class = "{node_class}"
  token      = "{token}"
  meta {{ agent = "{i}" }}
}}
"""
FRONT_CLI_JOB = """
job "front-cli" {
  datacenters = ["dc1", "dc2", "dc3", "dc4"]
  group "web" {
    count = 2
    task "web" {
      driver = "mock"
      resources {
        cpu    = 100
        memory = 64
      }
    }
  }
}
"""
# The agents' jobs: constrained to the agents' class, raw_exec tasks that
# end in `sleep FRONT_SLEEP`; drains move them within a second.
FRONT_AGENT_JOB = """
job "{id}" {{
  type        = "{type}"
  datacenters = ["dc1"]
  constraint {{
    attribute = "${{node.class}}"
    value     = "agent"
  }}
  group "g" {{
    count = {count}
    ephemeral_disk {{
      size    = 10
      sticky  = {sticky}
      migrate = {sticky}
    }}
    migrate {{
      max_parallel     = 4
      min_healthy_time = "0.5s"
    }}
    task "main" {{
      driver = "raw_exec"
      env {{ GREETING = "front" }}
      config {{
        command = "/bin/sh"
        args    = ["-c", "{script}; sleep {sleep}"]
      }}
      resources {{
        cpu    = 20
        memory = 32
      }}
    }}
  }}
}}
"""
FRONT_ECHO_SCRIPT = ("echo idx-$NOMAD_ALLOC_INDEX; "
                     "echo idx-$NOMAD_ALLOC_INDEX > local/idx.txt")
FRONT_STICKY_SCRIPT = ("test -f local/state.txt || "
                       "echo payload-$NOMAD_ALLOC_ID > local/state.txt")


def front_job_hcl(job_id: str, job_type: str, count: int, script: str,
                  sticky: bool = False) -> str:
    return FRONT_AGENT_JOB.format(id=job_id, type=job_type, count=count,
                                  sticky="true" if sticky else "false",
                                  script=script, sleep=FRONT_SLEEP)


def smoke_env(**extra) -> dict:
    """The environment of the processes the phase starts: the checkout on
    their ``PYTHONPATH``."""
    env = dict(os.environ)
    root = str(Path(__file__).resolve().parent)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH", "")) if p)
    env.update(extra)
    return env


def run_cli(cwd: str, *args, stdin: str = "",
            timeout: float = 60.0) -> subprocess.CompletedProcess:
    """``python -m nomad_tpu_torch.cli`` with ``args``, in a subprocess."""
    return subprocess.run(
        [sys.executable, "-m", "nomad_tpu_torch.cli", *args],
        input=stdin, capture_output=True, text=True, timeout=timeout,
        cwd=cwd, env=smoke_env())


def cli_ok(cwd: str, *args, stdin: str = "", rc: int = 0) -> str:
    out = run_cli(cwd, *args, stdin=stdin)
    if out.returncode != rc:
        raise AssertionError(f"front door: `{' '.join(args[2:])}` exited "
                             f"{out.returncode}: {out.stdout}{out.stderr}")
    return out.stdout


def spawn_cli_agent(tmp: str, name: str, args, env: dict):
    """``nomad-tpu agent`` in its own process (fork and exec), its output
    in files under ``tmp``."""
    with open(Path(tmp) / f"{name}.out", "w") as out, open(
            Path(tmp) / f"{name}.err", "w") as err:
        return subprocess.Popen(
            [sys.executable, "-u", "-m", "nomad_tpu_torch.cli", "agent",
             *args], stdout=out, stderr=err, cwd=tmp, env=env)


def cli_agent_addr(tmp: str, name: str, proc) -> str:
    """The address from a spawned agent's start line."""
    out_path = Path(tmp) / f"{name}.out"
    deadline = time.perf_counter() + FRONT_WAIT_S
    while time.perf_counter() < deadline:
        for line in out_path.read_text().splitlines():
            if line.startswith("agent started; HTTP API at "):
                return line.rsplit(" ", 1)[1].strip()
        if proc.poll() is not None:
            break
        time.sleep(0.05)
    proc.kill()
    proc.wait(timeout=10)
    raise AssertionError(f"front door: agent {name} did not start: "
                         f"{(Path(tmp) / f'{name}.err').read_text()[-2000:]}")


def stop_cli_agent(proc, name: str, signalled: bool = False) -> float:
    """SIGINT (unless ``signalled`` already), the agent's clean stop; it
    must exit 0 within FRONT_STOP_S.  Returns seconds."""
    import signal

    t0 = time.perf_counter()
    if not signalled:
        proc.send_signal(signal.SIGINT)
    try:
        rc = proc.wait(timeout=FRONT_STOP_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=10)
        raise AssertionError(f"front door: agent {name} still running "
                             f"{FRONT_STOP_S:.0f} s after SIGINT")
    if rc != 0:
        raise AssertionError(f"front door: agent {name} exited {rc}")
    return time.perf_counter() - t0


def cuda_holders(pids) -> dict:
    """Which of ``pids`` hold a CUDA context: the pids ``nvidia-smi
    --query-compute-apps`` lists, where it lists this process (which holds
    one); else, where the tool sees another pid namespace, the processes
    with a device node (``/dev/nvidia<N>``) open.  Returns {pid: bool} and
    the method under the key "method" and nvidia-smi's pids under
    "listed"."""
    import re

    import torch

    torch.zeros(1, device="cuda")  # this process's context exists
    listed = run_nvidia_smi_pids()
    out: dict = {"listed": sorted(listed)}
    if os.getpid() in listed:
        out["method"] = "nvidia-smi --query-compute-apps"
        for pid in pids:
            out[pid] = pid in listed
        return out
    out["method"] = "open /dev/nvidia<N> (nvidia-smi lists other pids)"
    node = re.compile(r"^/dev/nvidia\d+$")
    for pid in list(pids) + [os.getpid()]:
        held = False
        try:
            for fd in os.listdir(f"/proc/{pid}/fd"):
                try:
                    if node.match(os.readlink(f"/proc/{pid}/fd/{fd}")):
                        held = True
                        break
                except OSError:
                    continue
        except OSError:
            pass
        out[pid] = held
    if not out[os.getpid()]:
        raise AssertionError("front door: neither nvidia-smi nor /proc shows "
                             "this process's CUDA context")
    return out


def run_nvidia_smi_pids() -> set:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return set()
    return {int(x) for x in out.stdout.split() if x.strip().isdigit()}


def phase_tasks(tmp: str) -> list:
    """Pids of the phase's task processes still alive: a ``sleep
    FRONT_SLEEP``, or the shell of a task script that ends in it, whose
    working directory (the task's directory) lies under ``tmp``."""
    root = os.path.realpath(tmp)
    found = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/cmdline", "rb") as fh:
                args = fh.read().decode(errors="replace").split("\0")
            cwd = os.path.realpath(os.readlink(f"/proc/{entry}/cwd"))
        except OSError:
            continue
        if args and args[-1] == "":
            args.pop()
        task = (len(args) == 2 and os.path.basename(args[0]) == "sleep"
                and args[1] == FRONT_SLEEP) or (
                    len(args) == 3 and args[1] == "-c"
                    and args[2].endswith(f"; sleep {FRONT_SLEEP}"))
        if task and (cwd == root or cwd.startswith(root + os.sep)) and (
                not dead_or_zombie(int(entry))):
            found.append(int(entry))
    return found


def http_json(addr: str, method: str, path: str, body=None, token: str = ""):
    """One request; returns (status, decoded body), errors included."""
    import urllib.error
    import urllib.request

    data = json.dumps(body).encode() if body is not None else None
    headers = {"Content-Type": "application/json"}
    if token:
        headers["X-Nomad-Token"] = token
    req = urllib.request.Request(addr + path, data=data, method=method,
                                 headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            raw = resp.read()
            code = resp.status
    except urllib.error.HTTPError as exc:
        raw, code = exc.read(), exc.code
    try:
        return code, json.loads(raw) if raw else None
    except ValueError:
        return code, raw


def last_eval_of(table: dict, eval_id: str) -> dict:
    """``last_eval`` over the JSON of ``GET /v1/evaluations`` (id -> eval):
    the eval an eval ends in after placement conflicts hand its job to a
    blocked retry."""
    ev = table[eval_id]
    while ev["status"] == "failed" and ev.get("blocked_eval") in table:
        ev = table[ev["blocked_eval"]]
    return ev


def front_cli(card: str, tmp: str, out: dict) -> None:
    """12a: ``nomad-tpu agent --device cuda`` in a subprocess, fed and
    driven through the CLI."""
    from nomad_tpu_torch.api.client import APIClient
    from nomad_tpu_torch.api.rpc import HTTPServerRPC

    conf = Path(tmp) / "cli-server.hcl"
    conf.write_text(FRONT_SERVER_HCL.format(workers=4, capacity=256,
                                            acl="false"))
    job = Path(tmp) / "front-cli.hcl"
    job.write_text(FRONT_CLI_JOB)
    t0 = time.perf_counter()
    proc = spawn_cli_agent(tmp, "cli-agent", [
        "--server-only", "--device", FRONT_DEVICE, "--port", "0", "--config",
        str(conf)], smoke_env())
    try:
        addr = cli_agent_addr(tmp, "cli-agent", proc)
        out["cli_agent_start_s"] = time.perf_counter() - t0
        rpc = HTTPServerRPC(addr)
        for i in range(FRONT_CLI_NODES):
            rpc.register_node(server_node(i))
        t0 = time.perf_counter()
        text = cli_ok(tmp, "--address", addr, "job", "run", str(job))
        out["cli_job_run_s"] = time.perf_counter() - t0
        if "Evaluation" not in text or "complete" not in text:
            raise AssertionError(f"front door: job run said {text!r}")
        status = cli_ok(tmp, "--address", addr, "job", "status", "front-cli")
        api = APIClient(addr)
        allocs = [a for a in api.job_allocations("front-cli")
                  if a["desired_status"] == "run"]
        if len(allocs) != 2 or "front-cli" not in status:
            raise AssertionError(f"front door: the CLI agent placed "
                                 f"{len(allocs)} allocs; status {status!r}")
        dispatches = api.metrics().get("nomad.coalescer.dispatches", 0)
        if not dispatches:
            raise AssertionError("front door: the CLI agent's coalescer "
                                 "dispatched nothing")
        holders = cuda_holders([proc.pid])
        if not holders[proc.pid]:
            raise AssertionError(f"front door: the CLI agent (pid {proc.pid}) "
                                 f"holds no CUDA context ({holders['method']})")
        out["cli_stop_s"] = stop_cli_agent(proc, "cli-agent")
        log(f"front door: `nomad-tpu agent --device cuda` (pid {proc.pid}) up "
            f"in {out['cli_agent_start_s']:.3f} s, {FRONT_CLI_NODES} nodes "
            f"over the wire; `job run` {out['cli_job_run_s']:.3f} s, eval "
            f"complete, 2 allocs placed in {dispatches} dispatches; it holds "
            f"a CUDA context ({holders['method']}); SIGINT stopped it, rc 0, "
            f"in {out['cli_stop_s']:.3f} s (card: {card})")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)


def phase_front_door(card: str, results: dict) -> None:
    """The HTTP API, the CLI and client-only agents in their own processes
    in front of the card's kernels (module docstring, phase 12)."""
    import gc
    import signal
    import threading
    from collections import Counter
    from concurrent.futures import ThreadPoolExecutor
    from types import SimpleNamespace

    from nomad_tpu_torch.api import Agent, AgentConfig, APIClient
    from nomad_tpu_torch.api.client import APIError
    from nomad_tpu_torch.api.config_file import apply_config, load_config_files
    from nomad_tpu_torch.api.rpc import HTTPServerRPC
    from nomad_tpu_torch.jobspec import job_to_api
    from nomad_tpu_torch.ops import kernels as k

    out = results.setdefault("front_door", {})
    tmp = tempfile.mkdtemp(prefix="nomad-front-")
    t_phase = time.perf_counter()
    agent = None
    procs: dict = {}  # name -> client-only agent process
    reader = None
    try:
        front_cli(card, tmp, out)

        # 12b. The server agent from the config file cmd_agent reads.
        conf = Path(tmp) / "server.hcl"
        conf.write_text(FRONT_SERVER_HCL.format(
            workers=SERVER_WORKERS, capacity=CAPACITY, acl="true"))
        cfg = AgentConfig()
        apply_config(load_config_files([str(conf)]), cfg)
        cfg.server_config.coalescer_lanes = LANES
        cfg.server_config.failed_eval_unblock_interval = RETRY_INTERVAL_S
        if (cfg.server_config.num_workers != SERVER_WORKERS
                or cfg.server_config.node_capacity != CAPACITY
                or not cfg.server_config.acl_enabled or cfg.client_enabled):
            raise AssertionError(f"front door: config file read as {cfg}")
        agent = Agent(cfg, device=FRONT_DEVICE)
        agent.start()
        srv, addr = agent.server, agent.rpc_addr
        boot = cli_ok(tmp, "--address", addr, "acl", "bootstrap")
        mgmt = next(line.split("=", 1)[1].strip()
                    for line in boot.splitlines()
                    if line.startswith("Secret ID"))
        api = APIClient(addr, token=mgmt)

        # The server phases' nodes, over the wire.
        rpc = HTTPServerRPC(addr, token=mgmt)
        names = Counter(t.name.rstrip("0123456789").rstrip("-_ ")
                        for t in threading.enumerate())
        log(f"front door: {threading.active_count()} threads in this "
            f"process before the registrations {dict(names.most_common(8))}, "
            f"{len(gc.get_objects())} objects tracked by the collector")
        tenth = max(1, N_NODES // 10)
        marks = []
        t0 = time.perf_counter()
        with ThreadPoolExecutor(FRONT_THREADS) as pool:
            for lo in range(0, N_NODES, tenth):
                list(pool.map(lambda i: rpc.register_node(server_node(i)),
                              range(lo, min(lo + tenth, N_NODES))))
                marks.append(time.perf_counter() - t0)
        out["register_s"] = time.perf_counter() - t0
        out["register_tenths_s"] = [b - a for a, b in zip([0.0] + marks,
                                                          marks)]
        if len(srv.store.nodes) != N_NODES:
            raise AssertionError(f"front door: {len(srv.store.nodes)} nodes")
        log(f"front door: {N_NODES} nodes registered over the wire "
            f"(HTTPServerRPC.register_node, {FRONT_THREADS} threads) in "
            f"{out['register_s']:.3f} s, by tenths "
            f"{[round(x, 3) for x in out['register_tenths_s']]} "
            f"(card: {card})")

        # Client-only agents, each in its own process, started together.
        t0 = time.perf_counter()
        agent_env = smoke_env(NOMAD_TPU_EXECUTOR_BIN="")
        for i in range(FRONT_AGENTS):
            hcl = Path(tmp) / f"agent-{i}.hcl"
            hcl.write_text(FRONT_AGENT_HCL.format(
                data_dir=Path(tmp) / f"agent-{i}", node_class=AGENT_CLASS,
                token=mgmt, i=i))
            procs[f"agent-{i}"] = spawn_cli_agent(tmp, f"agent-{i}", [
                "--client-only", "--servers", addr, "--port", "0",
                "--config", str(hcl)], agent_env)
        addrs = {name: cli_agent_addr(tmp, name, proc)
                 for name, proc in procs.items()}

        def agent_nodes():
            return {n.id for n in list(srv.store.nodes.values())
                    if n.node_class == AGENT_CLASS and n.status == "ready"}

        wait_for(lambda: len(agent_nodes()) == FRONT_AGENTS,
                 "the client-only agents ready", timeout_s=FRONT_WAIT_S)
        out["agents_start_s"] = time.perf_counter() - t0
        nodes = agent_nodes()
        advertised = sorted(srv.store.node_by_id(n).attributes.get(
            "nomad.advertise.address") for n in nodes)
        if advertised != sorted(addrs.values()) or (
                len(srv.store.nodes) != N_NODES + FRONT_AGENTS):
            raise AssertionError(f"front door: agents advertise {advertised}, "
                                 f"{len(srv.store.nodes)} nodes")
        log(f"front door: {FRONT_AGENTS} client-only agents (python -m "
            f"nomad_tpu_torch.cli agent --client-only, NOMAD_TPU_EXECUTOR_BIN "
            f"empty) ready in {out['agents_start_s']:.3f} s: "
            f"{len(srv.store.nodes)} rows (card: {card})")

        # The burst: 64 HCL jobs through POST /v1/jobs from 8 threads.
        anon = APIClient(addr)
        try:
            anon.register_job(job_to_api(hcl_service_job(0, "front-anon")))
        except APIError as exc:
            if exc.code != 403:
                raise
        else:
            raise AssertionError("front door: an anonymous submit succeeded")
        jobs = [hcl_service_job(i, "front-svc") for i in range(SERVER_JOBS)]
        payloads = [job_to_api(j) for j in jobs]
        k.reset_counts()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(FRONT_THREADS) as pool:
            evals = list(pool.map(lambda p: api.register_job(p)["EvalID"],
                                  payloads))
        out["submit_s"] = time.perf_counter() - t0
        pending = set(evals)
        while pending:
            if time.perf_counter() - t0 > FRONT_WAIT_S:
                raise AssertionError(f"front door: {len(pending)} burst evals "
                                     "still open")
            # One GET /v1/evaluations a poll, as an operator's tooling
            # would; an eval's blocked retry is followed.
            table = {e["id"]: e for e in api.list_evaluations()}
            pending = {e for e in pending
                       if last_eval_of(table, e)["status"] != "complete"}
            if pending:
                time.sleep(0.005)
        out["burst_s"] = time.perf_counter() - t0
        out["evals_per_s"] = SERVER_JOBS / out["burst_s"]
        burst = check_burst(srv, [SimpleNamespace(id=e) for e in evals],
                            "front door")
        known = set(srv.store.nodes)
        over_http = [a for a in http_json(addr, "GET", "/v1/allocations",
                                          token=mgmt)[1]
                     if a["job_id"].startswith("front-svc")
                     and a["desired_status"] == "run"]
        if len(over_http) != SERVER_JOBS * SERVER_COUNT or not all(
                a["node_id"] in known for a in over_http):
            raise AssertionError(f"front door: {len(over_http)} burst allocs "
                                 "read back over HTTP")
        in_process = results.get("server", {}).get("evals_per_s")
        log(f"front door: {SERVER_JOBS} HCL jobs x {SERVER_COUNT} through "
            f"POST /v1/jobs ({FRONT_THREADS} threads): every POST answered "
            f"in {out['submit_s']:.3f} s, every eval complete "
            f"over HTTP in {out['burst_s']:.3f} s, {out['evals_per_s']:.1f} "
            f"evals/s (the in-process server phase: "
            f"{'not run' if in_process is None else f'{in_process:.1f}'} "
            f"evals/s this run); {burst['allocs']} fitting allocs, "
            f"{burst['retried']} retried; an anonymous submit got 403 "
            f"(card: {card})")
        for j in jobs:
            api.deregister_job(j.id)

        # The event stream, open before the agents' jobs.
        events: list = []
        subscribed = threading.Event()

        def read_events():
            import urllib.request

            req = urllib.request.Request(
                f"{addr}/v1/event/stream?topic=Allocation:*",
                headers={"X-Nomad-Token": mgmt})
            with urllib.request.urlopen(req, timeout=FRONT_WAIT_S) as resp:
                subscribed.set()
                for line in resp:
                    ev = json.loads(line)
                    if ev:
                        events.append(ev)

        subs0 = srv.store.events.subscriber_count()
        reader = threading.Thread(target=read_events, daemon=True)
        reader.start()
        wait_for(lambda: srv.store.events.subscriber_count() > subs0,
                 "the event stream subscribed", timeout_s=FRONT_WAIT_S)

        def running(job_id, n):
            allocs = [a for a in api.job_allocations(job_id)
                      if a["desired_status"] == "run"]
            ok = len(allocs) == n and all(a["client_status"] == "running"
                                          for a in allocs)
            return allocs if ok else None

        def job_file(name, *args, **kw):
            path = Path(tmp) / f"{name}.hcl"
            path.write_text(front_job_hcl(name, *args, **kw))
            return str(path)

        cli_head = ("--address", addr, "--token", mgmt)
        # raw_exec: each alloc echoes its index; logs, fs and exec through
        # the server agent, which forwards to the node agent.
        t0 = time.perf_counter()
        text = cli_ok(tmp, *cli_head, "job", "run", job_file(
            "front-echo", "service", FRONT_ECHO_COUNT, FRONT_ECHO_SCRIPT))
        if "complete" not in text:
            raise AssertionError(f"front door: job run said {text!r}")
        wait_for(lambda: running("front-echo", FRONT_ECHO_COUNT),
                 "the echo job running", timeout_s=FRONT_WAIT_S)
        out["echo_running_s"] = time.perf_counter() - t0
        echo = running("front-echo", FRONT_ECHO_COUNT)
        for a in echo:
            idx = a["name"].rsplit("[", 1)[1][:-1]
            want = f"idx-{idx}\n"

            def logged():
                got = run_cli(tmp, *cli_head, "alloc", "logs", a["id"],
                              "main")
                return got.returncode == 0 and got.stdout == want

            wait_for(logged, f"alloc {idx}'s log", timeout_s=FRONT_WAIT_S)
            cat = cli_ok(tmp, *cli_head, "alloc", "fs", a["id"],
                         "main/local/idx.txt")
            if cat != want:
                raise AssertionError(f"front door: alloc fs of {idx}: {cat!r}")
        exec_out = run_cli(tmp, *cli_head, "alloc", "exec", "--task", "main",
                           echo[0]["id"], "--", "/bin/sh", "-c",
                           "cat; echo $GREETING; exit 7", stdin="via-stdin\n")
        if (exec_out.returncode, exec_out.stdout) != (7, "via-stdin\nfront\n"):
            raise AssertionError(f"front door: alloc exec gave rc "
                                 f"{exec_out.returncode}, {exec_out.stdout!r}"
                                 f" {exec_out.stderr[-500:]!r}")
        log(f"front door: `job run` of {FRONT_ECHO_COUNT} raw_exec allocs on "
            f"the agents: submit -> running {out['echo_running_s']:.3f} s; "
            f"`alloc logs` and `alloc fs` through the server agent return "
            f"each alloc's own index; `alloc exec` returned its stdin and "
            f"exit code 7 (card: {card})")

        # A system job on exactly the agents.
        t0 = time.perf_counter()
        cli_ok(tmp, *cli_head, "job", "run", job_file(
            "front-system", "system", 1, "true"))
        wait_for(lambda: running("front-system", FRONT_AGENTS),
                 "the system job running on every agent",
                 timeout_s=FRONT_WAIT_S)
        out["system_running_s"] = time.perf_counter() - t0
        on = {a["node_id"] for a in running("front-system", FRONT_AGENTS)}
        if on != nodes:
            raise AssertionError("front door: the system job runs on "
                                 f"{sorted(on)}, not the agents")

        # A sticky, migrating disk follows its alloc off a drained agent.
        t0 = time.perf_counter()
        cli_ok(tmp, *cli_head, "job", "run", job_file(
            "front-sticky", "service", 1, FRONT_STICKY_SCRIPT, sticky=True))
        wait_for(lambda: running("front-sticky", 1),
                 "the sticky job running", timeout_s=FRONT_WAIT_S)
        first = running("front-sticky", 1)[0]
        out["sticky_running_s"] = time.perf_counter() - t0
        state_path = "main/local/state.txt"

        def state_of(alloc_id):
            got = run_cli(tmp, *cli_head, "alloc", "fs", alloc_id, state_path)
            return got.stdout if got.returncode == 0 else None

        wait_for(lambda: state_of(first["id"]), "the sticky state file",
                 timeout_s=FRONT_WAIT_S)
        content = state_of(first["id"])
        if content != f"payload-{first['id']}\n":
            raise AssertionError(f"front door: state file {content!r}")
        t0 = time.perf_counter()
        cli_ok(tmp, *cli_head, "node", "drain", first["node_id"])

        def moved():
            allocs = running("front-sticky", 1)
            return allocs if allocs and allocs[0]["node_id"] != first[
                "node_id"] else None

        wait_for(moved, "the sticky alloc moved", timeout_s=FRONT_WAIT_S)
        second = moved()[0]
        out["migration_s"] = time.perf_counter() - t0
        if state_of(second["id"]) != content or (
                second.get("previous_allocation") != first["id"]):
            raise AssertionError("front door: the migrated disk lost its file")
        wait_for(lambda: not api.get_node(first["node_id"])["drain"],
                 "the drain complete", timeout_s=FRONT_WAIT_S)
        out["drain_s"] = time.perf_counter() - t0
        log(f"front door: system job on exactly the {FRONT_AGENTS} agents in "
            f"{out['system_running_s']:.3f} s; sticky disk: running in "
            f"{out['sticky_running_s']:.3f} s, `node drain` -> replacement "
            f"running on another agent process with the file's bytes in "
            f"{out['migration_s']:.3f} s, drain complete in "
            f"{out['drain_s']:.3f} s (card: {card})")

        # The kernels of the path, and no plain version.
        launches = path_launches(k)
        check_path_launches(launches, "front door")
        out["launches"] = launches

        # Streams and surfaces.
        agent_allocs = {a["id"] for j in ("front-echo", "front-system",
                                          "front-sticky")
                        for a in api.job_allocations(j)}
        wait_for(lambda: agent_allocs <= {e["Key"] for e in list(events)},
                 "an event for every alloc of the agents' jobs",
                 timeout_s=FRONT_WAIT_S)
        keys = {
            "/v1/health": {"status", "score", "pressure", "inputs",
                           "breached_slos", "evaluated_at", "device"},
            "/v1/overload": {"state", "pressure", "thresholds", "hysteresis",
                             "flips", "actuators", "decisions"},
            "/v1/slo": {"slos"},
        }
        for path, want in keys.items():
            code, body = http_json(addr, "GET", path, token=mgmt)
            if code != 200 or not want <= set(body):
                raise AssertionError(f"front door: {path} gave {code} "
                                     f"{sorted(body) if code == 200 else body}")
        prom = api.metrics_prometheus()
        for name in ("nomad_coalescer_dispatches", "nomad_kernel_launches",
                     "nomad_kernel_fused_lanes"):
            if name not in prom:
                raise AssertionError(f"front door: {name} not in /v1/metrics"
                                     "?format=prometheus")
        top = cli_ok(tmp, *cli_head, "top", "--count", "1", "--no-clear")
        if not top.startswith("nomad top"):
            raise AssertionError(f"front door: top rendered {top[:200]!r}")
        code, body = http_json(addr, "GET", "/v1/internal/raft/stats",
                               token=mgmt)
        if code != 501:
            raise AssertionError(f"front door: raft stats gave {code}")
        holders = cuda_holders([p.pid for p in procs.values()])
        if any(holders[p.pid] for p in procs.values()):
            raise AssertionError(f"front door: a client-only agent holds a "
                                 f"CUDA context: {holders}")
        log(f"front door: {len(events)} Allocation events streamed, one for "
            f"each of the agents' {len(agent_allocs)} allocs; /v1/health, "
            f"/v1/slo, /v1/overload answer with the reference's keys; "
            f"prometheus carries the coalescer and kernel gauges; `top` "
            f"rendered; /v1/internal/raft/stats 501; launches {launches}; no "
            f"client-only agent holds a CUDA context ({holders['method']}) "
            f"(card: {card})")

        # Teardown: the jobs, then every agent.
        t0 = time.perf_counter()
        for j in ("front-echo", "front-system", "front-sticky"):
            api.deregister_job(j)
        wait_for(lambda: all(a["client_status"] in ("complete", "failed",
                                                    "lost")
                             for j in ("front-echo", "front-system",
                                       "front-sticky")
                             for a in api.job_allocations(j)),
                 "every alloc of the agents' jobs stopped",
                 timeout_s=FRONT_WAIT_S)
        wait_for(lambda: not phase_tasks(tmp), "every task process gone",
                 timeout_s=FRONT_STOP_S)
        out["stop_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        for proc in procs.values():
            proc.send_signal(signal.SIGINT)  # all at once; each must exit 0
        for name, proc in list(procs.items()):
            stop_cli_agent(proc, name, signalled=True)
        agent.shutdown()
        agent = None
        reader.join(timeout=FRONT_STOP_S)
        if reader.is_alive():
            raise AssertionError("front door: the event stream outlived the "
                                 "server agent")
        out["shutdown_s"] = time.perf_counter() - t0
        out["phase_s"] = time.perf_counter() - t_phase
        log(f"front door: jobs stopped, no task process left, in "
            f"{out['stop_s']:.3f} s; {FRONT_AGENTS} agent processes (SIGINT, "
            f"rc 0) and the server agent down in {out['shutdown_s']:.3f} s; "
            f"phase {out['phase_s']:.1f} s (card: {card})")
    finally:
        for proc in procs.values():
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
        if agent is not None:
            agent.shutdown()
        for pid in phase_tasks(tmp):
            try:
                os.kill(pid, 9)
            except OSError:
                pass
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# Phase 13: replication and membership
# ---------------------------------------------------------------------------

REPL_SERVERS = 3
REPL_SECRET = "smoke-cluster-secret"
REPL_THREADS = 8  # submitting threads of both bursts
REPL_KILL_AT = SERVER_JOBS // 2  # acknowledged submits before the kill
# 13a: jobs submitted to the new leader once the old one's shutdown has
# returned, so that the kernel counts read after them are its own.
REPL_AFTER_JOBS = 8
REPL_WAIT_S = 180.0  # any one condition of the phase
REPL_PROC_NODES = 1024  # 13b's nodes: 13a carries the full width
REPL_PROC_CAPACITY = 1280
REPL_PROC_WORKERS = 8
# 13a's raft timers: Nomad's defaults (raft_multiplier 1: 1 s).  The three
# servers of 13a share one interpreter, and the JSON of a 10,000-node image
# holds its lock for tenths of a second at a time, longer than the
# reference's 0.25-0.5 s election timeout; 13b's processes keep that one.
REPL_ELECTION_TIMEOUT = (1.0, 2.0)
REPL_HEARTBEAT = 0.1
REPL_SERVER_HCL = """
server {{
  workers           = {workers}
  node_capacity     = {capacity}
  heartbeat_min_ttl = 3600
  heartbeat_max_ttl = 7200
  server_id         = "{server_id}"
  peers             = [{peers}]
  cluster_secret    = "{secret}"
}}
client {{
  enabled = false
}}
"""
# 13b: three processes build one kernel into one empty directory at once.
REPL_COLD_BUILD = """
import sys
from nomad_tpu_torch.ops import build
build.BUILD_DIR = __import__("pathlib").Path(sys.argv[1])
build.KERNELS = ("verify_plan_fit",)
build.load_library("verify_plan_fit")
print("loaded", build._lib_path("verify_plan_fit").name)
"""


def reserved_node(i: int, usage) -> "object":
    """``server_node(i)`` with the server phases' pre-loaded usage as a
    reservation: a reservation is part of the node, so it replicates
    (usage written straight into one server's matrix would not)."""
    from nomad_tpu_torch.structs.types import NodeReservedResources

    node = server_node(i)
    r = node.reserved
    node.reserved = NodeReservedResources(
        cpu=r.cpu + int(usage[0]), memory_mb=r.memory_mb + int(usage[1]),
        disk_mb=r.disk_mb + int(usage[2]))
    return node


def seeded_usage(n: int) -> np.ndarray:
    """The seeded usage ``register_cluster`` pre-loads on ``n`` nodes."""
    node = server_node(0)
    totals = np.array([node.resources.cpu - node.reserved.cpu,
                       node.resources.memory_mb - node.reserved.memory_mb,
                       node.resources.disk_mb - node.reserved.disk_mb],
                      np.float64)
    rng = np.random.default_rng(7)
    return np.round(rng.uniform(0.1, 0.6, (n, 3)) * totals)


def repl_agent(i: int, port: int, peers, raft: bool):
    """An in-process server agent of the cluster: the server phases'
    config, the cluster secret, blocked retries every 2 s."""
    from nomad_tpu_torch.api import Agent, AgentConfig

    sc = server_config()
    sc.server_id = f"server-{i}"
    sc.peers = list(peers)
    sc.raft_enabled = raft
    sc.cluster_secret = REPL_SECRET
    sc.election_timeout = REPL_ELECTION_TIMEOUT
    sc.raft_heartbeat_interval = REPL_HEARTBEAT
    sc.failed_eval_unblock_interval = RETRY_INTERVAL_S
    return Agent(AgentConfig(
        name=f"server-{i}", server_enabled=True, client_enabled=False,
        http_host="127.0.0.1", http_port=port, server_config=sc),
        device=FRONT_DEVICE)


def free_ports(n: int) -> list:
    import socket

    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def leader_agent(agents):
    leaders = [a for a in agents if a.server.replicator.is_leader]
    return leaders[0] if len(leaders) == 1 else None


def repl_state(agents) -> str:
    """Each server's role, term, log position, node count and peers'
    health, for a failure message."""
    parts = []
    for a in agents:
        st = a.server.replicator.stats()
        parts.append(f"{a.config.name}: {st['Role']} term {st['Term']} seq "
                     f"{st['LastSeq']} nodes {len(a.server.store.nodes)} "
                     f"installs {a.server.replicator.snapshots_installed} "
                     f"peers {st['Peers']}")
    return "; ".join(parts)


def repl_wait(agents, pred, what: str) -> None:
    try:
        wait_for(pred, what, timeout_s=REPL_WAIT_S)
    except AssertionError as exc:
        raise AssertionError(f"replicated: {exc} ({repl_state(agents)})")


def timed_install(srv, out: list) -> None:
    """Record the seconds of each snapshot install the replicator hands
    ``srv``."""
    install = srv.install_snapshot

    def traced(image, seq):
        t0 = time.perf_counter()
        install(image, seq)
        out.append(time.perf_counter() - t0)

    srv.install_snapshot = traced


def timed_first_sync(m, out: dict) -> None:
    """Record the first ``NodeMatrix.sync`` of ``m``: its milliseconds
    (the card synchronised after it), bytes and whether it was a full
    upload."""
    import torch

    sync_locked = m._sync_locked

    def traced(dev):
        if "ms" in out:
            return sync_locked(dev)
        uploads, nbytes = m.full_uploads, m.upload_bytes_total
        t0 = time.perf_counter()
        arrays = sync_locked(dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        out["ms"] = (time.perf_counter() - t0) * 1e3
        out["bytes"] = m.upload_bytes_total - nbytes
        out["full"] = m.full_uploads == uploads + 1
        return arrays

    m._sync_locked = traced


def timed_replicate(rep, out: dict) -> None:
    """Count the quorum round trips of ``rep``'s writes and their
    seconds: each runs with the store's write lock held."""
    replicate = rep.replicate

    def traced(entry):
        t0 = time.perf_counter()
        try:
            replicate(entry)
        finally:
            out["n"] = out.get("n", 0) + 1
            out["s"] = out.get("s", 0.0) + time.perf_counter() - t0

    rep.replicate = traced


def device_matches_scratch(srv, label: str) -> int:
    """The server's device matrix, synced and read back, equals a matrix
    built from scratch from its own store, field by field on every node's
    row; returns the rows compared."""
    from nomad_tpu_torch.state.matrix import DeviceArrays, NodeMatrix
    from nomad_tpu_torch.state.store import StateStore

    arrays = srv.matrix.run_on_device(lambda: srv.matrix.sync())
    got = {f: getattr(arrays, f).cpu().numpy() for f in DeviceArrays._fields}
    fresh = StateStore(matrix=NodeMatrix(capacity=srv.matrix.capacity,
                                         device="cpu"))
    fresh.restore(srv.store.to_snapshot_wire(), [])
    want = fresh.matrix.snapshot_host()
    ids = sorted(srv.matrix.row_of)
    if ids != sorted(fresh.matrix.row_of):
        raise AssertionError(f"{label}: the device matrix holds other nodes "
                             "than its store")
    rows = [srv.matrix.row_of[n] for n in ids]
    rows_f = [fresh.matrix.row_of[n] for n in ids]
    for f in DeviceArrays._fields:
        a = got[f][rows].view(want[f].dtype) if got[f].dtype != want[f].dtype \
            else got[f][rows]
        b = want[f][rows_f]
        if not np.array_equal(a, b, equal_nan=b.dtype.kind == "f"):
            raise AssertionError(f"{label}: device column {f} differs from a "
                                 "matrix built from scratch")
    return len(rows)


def check_failover_launches(launches: dict, label: str) -> None:
    """After the failover the fused path ran its two kernels, and neither
    a plain version nor the staged kernel ran."""
    if launches["fused_place"] <= 0 or launches["allocs_fit_verify"] <= 0:
        raise AssertionError(f"{label}: a kernel never launched: {launches}")
    if launches["plain"] or launches["place_batch"]:
        raise AssertionError(f"{label}: a plain version or the staged "
                             f"kernel ran: {launches}")


class Submitter:
    """Submits jobs from REPL_THREADS threads to whichever server leads,
    following the leader across a failover; ``acked`` maps job index ->
    eval id of the submit that was acknowledged."""

    def __init__(self, jobs, submit, find_leader):
        import threading

        self.jobs = jobs
        self.submit = submit  # (leader, job index) -> eval id, or raises
        self.find_leader = find_leader  # () -> leader or None
        self.acked: dict = {}
        self.retries: dict = {}
        self.errors: list = []
        self._lock = threading.Lock()
        self._next = 0
        self._threads = [threading.Thread(target=self._run, daemon=True)
                         for _ in range(REPL_THREADS)]

    def start(self) -> None:
        for t in self._threads:
            t.start()

    def join(self) -> None:
        for t in self._threads:
            t.join(timeout=REPL_WAIT_S)
        if any(t.is_alive() for t in self._threads) or len(self.acked) != len(
                self.jobs):
            missing = sorted(set(range(len(self.jobs))) - set(self.acked))
            raise AssertionError(
                f"replicated: {len(self.acked)} of {len(self.jobs)} submits "
                f"acknowledged (missing {missing}; threads alive "
                f"{sum(t.is_alive() for t in self._threads)}; retries "
                f"{self.retries}; last errors {self.errors[-3:]})")

    def _run(self) -> None:
        deadline = time.perf_counter() + REPL_WAIT_S
        while True:
            with self._lock:
                i = self._next
                self._next += 1
            if i >= len(self.jobs):
                return
            while time.perf_counter() < deadline:
                try:
                    leader = self.find_leader()
                    if leader is None:
                        time.sleep(0.01)
                        continue
                    eval_id = self.submit(leader, i)
                except Exception as exc:  # noqa: BLE001 — retried on the next leader
                    with self._lock:
                        kind = type(exc).__name__
                        self.retries[kind] = self.retries.get(kind, 0) + 1
                        self.errors.append(f"job {i}: {exc!r}"[:300])
                    time.sleep(0.01)
                    continue
                with self._lock:
                    self.acked[i] = eval_id
                break


def repl_in_process(card: str, out: dict) -> None:
    """13a: three in-process server agents at full width; the cluster
    grows from one, the joiners catch up by snapshot, and the leader is
    shut down mid-burst."""
    import threading
    from types import SimpleNamespace

    from nomad_tpu_torch.ops import kernels as k

    tmp = tempfile.mkdtemp(prefix="nomad-repl-")
    ports = free_ports(REPL_SERVERS)
    addrs = [f"http://127.0.0.1:{p}" for p in ports]
    agents: list = []
    try:
        t0 = time.perf_counter()
        first = repl_agent(0, ports[0], [], raft=True)
        agents.append(first)
        first.start()
        wait_for(lambda: first.server.replicator.is_leader,
                 "the lone server to lead", timeout_s=REPL_WAIT_S)
        usage = seeded_usage(N_NODES)
        for i in range(N_NODES):
            first.server.register_node(reserved_node(i, usage[i]))
        out["register_s"] = time.perf_counter() - t0
        installs: list = []
        for i in (1, 2):
            joined = cli_ok(tmp, "--address", addrs[0], "server", "join",
                            addrs[i])
            if addrs[i] not in joined:
                raise AssertionError(f"replicated: `server join` said {joined}")
            t0 = time.perf_counter()
            a = repl_agent(i, ports[i], [addrs[0]], raft=True)
            timed_install(a.server, installs)
            agents.append(a)
            a.start()
            leader_rep = first.server.replicator
            repl_wait(agents, lambda a=a: (
                a.server.replicator.snapshots_installed >= 1
                and len(a.server.store.nodes) == N_NODES
                and a.server.replicator.leader_addr == addrs[0]
                and leader_rep.peers[addrs[i]].healthy
                and not leader_rep._installing(addrs[i])),
                f"server-{i} caught up")
            out[f"catch_up_{i}_s"] = time.perf_counter() - t0
        repl_wait(agents, lambda: all(len(a.server.replicator.peers) == 2
                                      for a in agents),
                  "three members on every server")
        if first.server.coalescer.dispatches or any(
                a.server.coalescer.dispatches for a in agents[1:]):
            raise AssertionError("replicated: a server dispatched before any "
                                 "job was submitted")
        out["install_s"] = installs
        members = http_json(addrs[0], "GET", "/v1/agent/members")[1]
        log(f"replicated: 13a grew one server to three (`server join`): "
            f"{N_NODES} nodes with the server phases' usage as reservations "
            f"registered on the lone leader in {out['register_s']:.3f} s; "
            f"each joiner caught up by snapshot install "
            f"({', '.join(f'{s:.3f}' for s in installs)} s) in "
            f"{out['catch_up_1_s']:.3f} / {out['catch_up_2_s']:.3f} s; "
            f"members {sorted(m['Addr'] for m in members['Members'])} "
            f"(card: {card})")

        # The burst: the leader goes down in its middle.
        syncs = {id(a): {} for a in agents[1:]}
        writes = {id(a): {} for a in agents[1:]}
        for a in agents[1:]:
            timed_first_sync(a.server.matrix, syncs[id(a)])
            timed_replicate(a.server.replicator, writes[id(a)])
        live = list(agents)
        jobs = [service_job(i) for i in range(SERVER_JOBS)]

        def submit(leader, i):
            return leader.server.submit_job(jobs[i]).id

        sub = Submitter(jobs, submit, lambda: leader_agent(live))
        t_start = time.perf_counter()
        sub.start()
        wait_for(lambda: len(sub.acked) >= REPL_KILL_AT,
                 "half the burst acknowledged", timeout_s=REPL_WAIT_S)
        old = leader_agent(live)
        t_kill = time.perf_counter()
        live.remove(old)
        marks: dict = {}

        def watch():
            while time.perf_counter() - t_kill < REPL_WAIT_S:
                new = leader_agent(live)
                if new is not None:
                    marks.setdefault("elected", time.perf_counter())
                    if new.server.plan_applier.plans_applied:
                        marks["placed"] = time.perf_counter()
                        return
                time.sleep(0.002)

        watcher = threading.Thread(target=watch, daemon=True)
        watcher.start()
        old.shutdown()
        out["shutdown_s"] = time.perf_counter() - t_kill
        # From here on only a survivor can launch: the counts are read
        # after jobs that go in later, and each server's dispatches are
        # checked.
        k.reset_counts()
        dispatched = {id(a): a.server.coalescer.dispatches for a in agents}
        fused0 = {id(a): a.server.coalescer.fused_dispatches for a in live}
        sub.join()
        watcher.join(timeout=REPL_WAIT_S)
        new = leader_agent(live)
        if new is None or "placed" not in marks:
            raise AssertionError(f"replicated: no survivor placed after the "
                                 f"leader went down ({repl_state(live)})")
        out["election_s"] = marks["elected"] - t_kill
        out["first_placement_s"] = marks["placed"] - t_kill
        srv = new.server
        evals = [SimpleNamespace(id=e) for e in sub.acked.values()]
        wait_for(lambda: all(
            (ev := last_eval(srv, e.id)) is not None
            and ev.status == "complete" for e in evals),
            "every acknowledged eval complete", timeout_s=REPL_WAIT_S)
        out["burst_s"] = time.perf_counter() - t_start
        out["evals_per_s"] = SERVER_JOBS / out["burst_s"]
        after_jobs = [service_job(SERVER_JOBS + i)
                      for i in range(REPL_AFTER_JOBS)]
        after = Submitter(after_jobs, lambda leader, i: leader.server.submit_job(
            after_jobs[i]).id, lambda: leader_agent(live))
        after.start()
        after.join()
        evals += [SimpleNamespace(id=e) for e in after.acked.values()]
        jobs = jobs + after_jobs
        wait_for(lambda: all(
            (ev := last_eval(srv, e.id)) is not None
            and ev.status == "complete" for e in evals),
            "every eval after the shutdown complete", timeout_s=REPL_WAIT_S)
        wait_quiet(srv, "replicated")
        launches = path_launches(k)
        check_failover_launches(launches, "replicated (13a)")
        other = next(a for a in live if a is not new)
        for a in (old, other):
            if a.server.coalescer.dispatches != dispatched[id(a)]:
                raise AssertionError(
                    f"replicated: {a.config.name} dispatched after the old "
                    f"leader's shutdown returned "
                    f"({dispatched[id(a)]} -> {a.server.coalescer.dispatches})")
        if srv.coalescer.fused_dispatches <= fused0[id(new)]:
            raise AssertionError("replicated: the new leader's coalescer ran "
                                 "no fused dispatch after the old leader's "
                                 "shutdown returned")
        if srv.replicator.snapshots_installed < 1:
            raise AssertionError("replicated: the new leader did not catch "
                                 "up by snapshot")
        first_sync = syncs[id(new)]
        if not first_sync.get("full"):
            raise AssertionError(f"replicated: the new leader's first sync "
                                 f"was not a full upload: {first_sync}")
        for a in live:
            for i, job in enumerate(jobs):
                if a.server.store.job_by_id(job.namespace, job.id) is None:
                    raise AssertionError(f"replicated: acknowledged job {i} "
                                         f"missing on {a.config.name}")
        wait_for(lambda: all(other.server.store.eval_by_id(e.id) is not None
                             for e in evals)
                 and other.server.store.latest_index == srv.store.latest_index,
                 "the follower caught up with the burst",
                 timeout_s=REPL_WAIT_S)
        wait_for(lambda: other.server.store.to_snapshot_wire()
                 == srv.store.to_snapshot_wire(),
                 "equal images on the survivors", timeout_s=REPL_WAIT_S)
        burst = check_burst(srv, evals, "replicated (13a)",
                            n_jobs=SERVER_JOBS + REPL_AFTER_JOBS)
        rows = device_matches_scratch(srv, "replicated (13a)")
        out["first_sync_ms"] = first_sync["ms"]
        out["first_sync_bytes"] = first_sync["bytes"]
        w = writes[id(new)]
        out["write_quorum_ms"] = w["s"] / w["n"] * 1e3
        out["writes"] = w["n"]
        out["retries"] = dict(sub.retries)
        out["launches"] = launches
        log(f"replicated: 13a {SERVER_JOBS} count-{SERVER_COUNT} jobs from "
            f"{REPL_THREADS} threads, the leader ({old.config.name}) shut down "
            f"after {REPL_KILL_AT} acknowledged submits (shutdown "
            f"{out['shutdown_s']:.3f} s); {new.config.name}, caught up by "
            f"snapshot, elected {out['election_s']:.3f} s after and placing "
            f"{out['first_placement_s']:.3f} s after; its first sync a full "
            f"upload of {first_sync['bytes']} bytes in "
            f"{first_sync['ms']:.3f} ms; every acknowledged submit on both "
            f"survivors, every eval complete, equal images, "
            f"{burst['allocs']} fitting allocs ({burst['retried']} retried), "
            f"device matrix equal to a from-scratch one on {rows} rows; "
            f"burst {out['evals_per_s']:.1f} evals/s, each of the new "
            f"leader's {out['writes']} writes waiting "
            f"{out['write_quorum_ms']:.3f} ms on average for its quorum under "
            f"the store's write lock; submits retried "
            f"{out['retries']}; {REPL_AFTER_JOBS} jobs more on the new "
            f"leader; launches since the old leader's shutdown returned, "
            f"all the new leader's: {launches} "
            f"(card: {card})")
    finally:
        for a in agents:
            try:
                a.shutdown()
            except Exception as exc:  # noqa: BLE001 — stopped already
                log(f"replicated: shutdown of {a.config.name}: {exc!r}")
        shutil.rmtree(tmp, ignore_errors=True)


def repl_cold_build(tmp: str, out: dict) -> None:
    """Three processes build one kernel into one empty directory at once
    (temporary file, then ``os.replace``); each must load a whole
    library."""
    build_dir = Path(tmp) / "cold-build"
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", REPL_COLD_BUILD,
                               str(build_dir)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True,
                              env=smoke_env()) for _ in range(3)]
    for p in procs:
        stdout, stderr = p.communicate(timeout=REPL_WAIT_S)
        if p.returncode != 0 or not stdout.startswith("loaded"):
            raise AssertionError(f"replicated: a cold build failed: "
                                 f"{stdout}{stderr[-2000:]}")
    out["cold_build_s"] = time.perf_counter() - t0


def raft_stats(addr: str):
    """``/v1/internal/raft/stats`` with the cluster secret, or None."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        addr + "/v1/internal/raft/stats", data=b"{}", method="POST",
        headers={"X-Nomad-Cluster-Secret": REPL_SECRET})
    try:
        with urllib.request.urlopen(req, timeout=5) as resp:
            return json.loads(resp.read())
    except (urllib.error.URLError, OSError, ValueError):
        return None


def fused_launches(addr: str) -> int:
    """The fused launches ``addr``'s ``/v1/metrics`` counts."""
    return http_json(addr, "GET", "/v1/metrics")[1].get(
        "nomad.kernel.launches{path=fused}", 0)


def proc_leader(addrs):
    for addr in addrs:
        st = raft_stats(addr)
        if st is not None and st["Role"] == "leader":
            return addr
    return None


def repl_processes(card: str, out: dict) -> None:
    """13b: three ``agent --server-only --device cuda`` processes, each
    with its own CUDA context; the leader's process is SIGKILLed
    mid-burst."""
    import re
    import signal
    from concurrent.futures import ThreadPoolExecutor

    from nomad_tpu_torch.api.rpc import FailoverRPC
    from nomad_tpu_torch.jobspec import job_to_api

    tmp = tempfile.mkdtemp(prefix="nomad-repl-proc-")
    procs: dict = {}
    try:
        repl_cold_build(tmp, out)
        ports = free_ports(REPL_SERVERS)
        addrs = [f"http://127.0.0.1:{p}" for p in ports]
        peers = ", ".join(f'"{a}"' for a in addrs)
        t0 = time.perf_counter()
        for i in range(REPL_SERVERS):
            conf = Path(tmp) / f"server-{i}.hcl"
            conf.write_text(REPL_SERVER_HCL.format(
                workers=REPL_PROC_WORKERS, capacity=REPL_PROC_CAPACITY,
                server_id=f"server-{i}", peers=peers, secret=REPL_SECRET))
            procs[addrs[i]] = spawn_cli_agent(tmp, f"server-{i}", [
                "--server-only", "--device", FRONT_DEVICE, "--port",
                str(ports[i]), "--config", str(conf)], smoke_env())
        for i, addr in enumerate(addrs):
            if cli_agent_addr(tmp, f"server-{i}", procs[addr]) != addr:
                raise AssertionError("replicated: an agent took another port")
        wait_for(lambda: proc_leader(addrs) is not None, "a leader elected",
                 timeout_s=REPL_WAIT_S)
        out["proc_start_s"] = time.perf_counter() - t0
        pids = [p.pid for p in procs.values()]
        holders = cuda_holders(pids)
        if not all(holders[pid] for pid in pids):
            raise AssertionError(f"replicated: not every server process holds "
                                 f"a CUDA context: {holders}")

        rpc = FailoverRPC(addrs)
        t0 = time.perf_counter()
        with ThreadPoolExecutor(REPL_THREADS) as pool:
            list(pool.map(lambda i: rpc.register_node(server_node(i)),
                          range(REPL_PROC_NODES)))
        out["proc_register_s"] = time.perf_counter() - t0

        payloads = []
        for i in range(SERVER_JOBS):
            job = service_job(i)
            job.id = job.name = f"repl-proc-{i}"
            payloads.append(job_to_api(job))
        live = list(addrs)

        def submit(leader, i):
            code, body = http_json(leader, "PUT", "/v1/jobs",
                                   {"Job": payloads[i]})
            if code != 200:
                raise RuntimeError(f"{code}: {body}")
            return body["EvalID"]

        sub = Submitter(payloads, submit, lambda: proc_leader(live))
        t_start = time.perf_counter()
        sub.start()
        wait_for(lambda: len(sub.acked) >= REPL_KILL_AT,
                 "half the burst acknowledged", timeout_s=REPL_WAIT_S)
        old = proc_leader(live)
        t_kill = time.perf_counter()
        procs[old].send_signal(signal.SIGKILL)
        live.remove(old)
        procs[old].wait(timeout=30)
        fused_at_kill = {a: fused_launches(a) for a in live}
        wait_for(lambda: proc_leader(live) is not None,
                 "the survivors elect a leader", timeout_s=REPL_WAIT_S)
        out["proc_election_s"] = time.perf_counter() - t_kill
        sub.join()
        new = proc_leader(live)

        def open_evals():
            table = {e["id"]: e for e in http_json(
                new, "GET", "/v1/evaluations")[1]}
            return [e for e in sub.acked.values() if e not in table
                    or last_eval_of(table, e)["status"] != "complete"]

        wait_for(lambda: not open_evals(),
                 "every acknowledged eval complete on the new leader",
                 timeout_s=REPL_WAIT_S)
        out["proc_burst_s"] = time.perf_counter() - t_start
        out["proc_evals_per_s"] = SERVER_JOBS / out["proc_burst_s"]
        fused = {a: fused_launches(a) - fused_at_kill[a] for a in live}
        if not sum(fused.values()):
            raise AssertionError(f"replicated: the survivors' metrics count "
                                 f"no fused launch after the kill: {fused}")
        allocs = [a for a in http_json(new, "GET", "/v1/allocations")[1]
                  if a["job_id"].startswith("repl-proc-")
                  and a["desired_status"] == "run"]
        if len(allocs) != SERVER_JOBS * SERVER_COUNT:
            raise AssertionError(f"replicated: {len(allocs)} allocs of the "
                                 "burst after the kill")
        members = cli_ok(tmp, "--address", new, "server", "members")
        # A write goes to whichever survivor leads now (a follower answers
        # 409 with the leader's address, which the CLI does not follow).
        deadline = time.perf_counter() + REPL_WAIT_S
        while True:
            leader = proc_leader(live)
            done = leader is not None and run_cli(
                tmp, "--address", leader, "server", "remove-peer", old)
            if done and done.returncode == 0:
                removed = done.stdout
                break
            if time.perf_counter() > deadline:
                raise AssertionError(f"replicated: `server remove-peer` "
                                     f"failed: {done and done.stderr}")
            time.sleep(0.1)
        terms = {a: (raft_stats(a) or {}).get("Term") for a in live}
        if old in removed or leader not in removed:
            raise AssertionError(f"replicated: `server remove-peer` said "
                                 f"{removed}")
        wait_for(lambda: all(old not in (raft_stats(a) or {"Peers": {old: 0}})
                             ["Peers"] for a in live),
                 "the dead peer gone from every survivor",
                 timeout_s=REPL_WAIT_S)
        t0 = time.perf_counter()
        for addr in live:
            procs[addr].send_signal(signal.SIGINT)
        for i, addr in enumerate(addrs):
            if addr in live:
                stop_cli_agent(procs[addr], f"server-{i}", signalled=True)
        out["proc_stop_s"] = time.perf_counter() - t0
        log(f"replicated: 13b three `agent --server-only --device "
            f"{FRONT_DEVICE}` processes (three cold builds of one kernel into "
            f"one directory at once, each loaded, in "
            f"{out['cold_build_s']:.3f} s) up and a leader elected in "
            f"{out['proc_start_s']:.3f} s, each holding a CUDA context "
            f"({holders['method']}); {REPL_PROC_NODES} nodes through "
            f"FailoverRPC in {out['proc_register_s']:.3f} s; {SERVER_JOBS} "
            f"jobs over HTTP from {REPL_THREADS} threads, the leader's "
            f"process SIGKILLed after {REPL_KILL_AT} acknowledged; the "
            f"survivors elected {new} {out['proc_election_s']:.3f} s after; "
            f"every acknowledged eval complete there, burst "
            f"{out['proc_evals_per_s']:.1f} evals/s, the survivors' "
            f"/v1/metrics counting {fused} fused launches after the kill "
            f"(terms now "
            f"{terms}); submits retried "
            f"{dict(sub.retries)}; `server members` listed "
            f"{len(set(re.findall(r'http://[0-9.:]+', members)))} addresses, "
            f"`server remove-peer` "
            f"took the dead one out; SIGINT stopped the survivors, rc 0, in "
            f"{out['proc_stop_s']:.3f} s (card: {card})")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
        shutil.rmtree(tmp, ignore_errors=True)


def repl_full_width(card: str = "") -> dict:
    """Not a phase of the smoke (13a widens the raft timers, 13b cuts the
    nodes): three ``agent --server-only --device cuda`` processes with the
    reference's timers (elections 0.25-0.5 s), grown from one by ``server
    join`` at the server phases' 10,000 nodes, registered over HTTP
    through ``FailoverRPC``; each joiner catches up by snapshot.  Logs
    each catch-up's seconds and the terms when the joiner answers and
    when it has caught up (an election during the catch-up shows as a
    higher term; from the join until the joiner answers, the lone leader
    has no quorum and campaigns), then SIGKILLs the leader, times the election
    and places REPL_AFTER_JOBS jobs on the new leader, whose
    ``/v1/metrics`` must count fused launches.  Returns the readings."""
    import signal
    from concurrent.futures import ThreadPoolExecutor

    from nomad_tpu_torch.api.rpc import FailoverRPC
    from nomad_tpu_torch.jobspec import job_to_api

    card = card or card_line()
    out: dict = {}
    tmp = tempfile.mkdtemp(prefix="nomad-repl-full-")
    procs: dict = {}
    try:
        # Each port is taken just before its server needs it: the 10,000
        # registrations' connections take local ports of their own.
        ports, addrs = [], []

        def take_port():
            ports.append(free_ports(1)[0])
            addrs.append(f"http://127.0.0.1:{ports[-1]}")

        def spawn(i, peers):
            conf = Path(tmp) / f"server-{i}.hcl"
            hcl = REPL_SERVER_HCL.format(
                workers=REPL_PROC_WORKERS, capacity=CAPACITY,
                server_id=f"server-{i}",
                peers=", ".join(f'"{a}"' for a in peers), secret=REPL_SECRET)
            conf.write_text(hcl.replace("server {", "server {\n  "
                                        "raft_enabled = true", 1))
            procs[addrs[i]] = spawn_cli_agent(tmp, f"server-{i}", [
                "--server-only", "--device", FRONT_DEVICE, "--port",
                str(ports[i]), "--config", str(conf)], smoke_env())
            if cli_agent_addr(tmp, f"server-{i}", procs[addrs[i]]) != addrs[i]:
                raise AssertionError("full width: an agent took another port")

        take_port()
        spawn(0, [])
        wait_for(lambda: proc_leader(addrs[:1]) is not None,
                 "the lone server to lead", timeout_s=REPL_WAIT_S)
        usage = seeded_usage(N_NODES)
        rpc = FailoverRPC(addrs[:1])
        t0 = time.perf_counter()
        with ThreadPoolExecutor(REPL_THREADS) as pool:
            list(pool.map(lambda i: rpc.register_node(
                reserved_node(i, usage[i])), range(N_NODES)))
        out["register_s"] = time.perf_counter() - t0
        out["terms"] = []

        def term(n):
            return max((raft_stats(a) or {}).get("Term", 0)
                       for a in addrs[:n])

        for i in (1, 2):
            leader = proc_leader(addrs[:i])
            take_port()
            cli_ok(tmp, "--address", leader, "server", "join", addrs[i])
            t0 = time.perf_counter()
            spawn(i, [addrs[0]])
            up = term(i + 1)

            def caught_up(i=i):
                lead = proc_leader(addrs[:i + 1])
                st, ls = raft_stats(addrs[i]), lead and raft_stats(lead)
                return (st is not None and ls is not None
                        and st["Role"] == "follower"
                        and st["LastSeq"] >= ls["LastSeq"] > 0
                        and ls["Peers"].get(addrs[i], {}).get("Healthy"))

            wait_for(caught_up, f"server-{i} caught up",
                     timeout_s=REPL_WAIT_S)
            out[f"catch_up_{i}_s"] = time.perf_counter() - t0
            out["terms"].append((up, term(i + 1)))
        live = list(addrs)
        old = proc_leader(live)
        t_kill = time.perf_counter()
        procs[old].send_signal(signal.SIGKILL)
        procs[old].wait(timeout=30)
        live.remove(old)
        wait_for(lambda: proc_leader(live) is not None,
                 "the survivors elect a leader", timeout_s=REPL_WAIT_S)
        out["election_s"] = time.perf_counter() - t_kill
        new = proc_leader(live)
        fused0 = fused_launches(new)
        payloads = []
        for i in range(REPL_AFTER_JOBS):
            job = service_job(i)
            job.id = job.name = f"repl-full-{i}"
            payloads.append(job_to_api(job))

        def submit(leader, i):
            code, body = http_json(leader, "PUT", "/v1/jobs",
                                   {"Job": payloads[i]})
            if code != 200:
                raise RuntimeError(f"{code}: {body}")
            return body["EvalID"]

        sub = Submitter(payloads, submit, lambda: proc_leader(live))
        t0 = time.perf_counter()
        sub.start()
        sub.join()
        new = proc_leader(live)

        def open_evals():
            table = {e["id"]: e for e in http_json(
                new, "GET", "/v1/evaluations")[1]}
            return [e for e in sub.acked.values() if e not in table
                    or last_eval_of(table, e)["status"] != "complete"]

        wait_for(lambda: not open_evals(), "the jobs placed",
                 timeout_s=REPL_WAIT_S)
        out["place_s"] = time.perf_counter() - t0
        out["fused"] = fused_launches(new) - fused0
        if out["fused"] <= 0:
            raise AssertionError("full width: the new leader counts no fused "
                                 "launch")
        for addr in live:
            procs[addr].send_signal(signal.SIGINT)
        for i, addr in enumerate(addrs):
            if addr in live:
                stop_cli_agent(procs[addr], f"server-{i}", signalled=True)
        log(f"replicated, full width: three `agent --server-only` processes "
            f"with elections of 0.25-0.5 s; {N_NODES} nodes through "
            f"FailoverRPC in {out['register_s']:.3f} s; catch-ups by "
            f"snapshot {out['catch_up_1_s']:.3f} / {out['catch_up_2_s']:.3f} "
            f"s; terms (joiner up, caught up) {out['terms']}; SIGKILL -> "
            f"election {out['election_s']:.3f} s; {REPL_AFTER_JOBS} jobs "
            f"placed on the new leader in {out['place_s']:.3f} s with "
            f"{out['fused']} fused launches (card: {card})")
        return out
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
        shutil.rmtree(tmp, ignore_errors=True)


def phase_replicated(card: str, results: dict) -> None:
    """Replication and membership in front of the card's kernels (module
    docstring, phase 13)."""
    out = results.setdefault("replicated", {})
    t0 = time.perf_counter()
    repl_in_process(card, out)
    repl_processes(card, out)
    out["phase_s"] = time.perf_counter() - t0


# ---------------------------------------------------------------------------
# Phase 14: the node-sharded dispatch (K9)
# ---------------------------------------------------------------------------

SHARD_SEQ_JOBS = 16  # jobs placed one at a time on both servers
# Bytes of one candidate's state in csrc/place_scan.cuh (cand_bytes) by
# instantiation tier: bench widths, full widths.
CAND_BYTES = (16 + 5 + 1, 16 + 4 + 5 * 2 + 1)


def shard_meshes():
    """The meshes phase 14 holds against the unsharded kernels: four and
    eight virtual shards of the first card, and every card when there are
    several."""
    import torch

    meshes = [["cuda:0"] * 4, ["cuda:0"] * 8]
    if torch.cuda.device_count() > 1:
        meshes.append([f"cuda:{i}" for i in range(torch.cuda.device_count())])
    return meshes


def sharded_operands(batch: Batch):
    """A batch's lane operands as host arrays, in the sharded programs'
    order (deltas, tg counts, spread counts, penalties, packed request,
    class eligibility, host masks, lane mask)."""
    from nomad_tpu_torch.ops import kernels as k

    n = batch.np
    ri, rf = k.pack_requests(n["reqs"])
    return (n["delta_rows"], n["delta_vals"], n["tg_counts"],
            n["spread_counts"], n["penalties"], ri, rf, n["class_eligs"],
            n["host_masks"], n["lane_mask"])


def exact(label: str, got, want) -> None:
    got, want = np.asarray(got.cpu()), np.asarray(want.cpu())
    if got.shape != want.shape or not np.array_equal(got, want):
        bad = np.argwhere(got != want) if got.shape == want.shape else []
        raise AssertionError(f"sharded: {label} differs from the unsharded "
                             f"kernel ({len(bad)} entries; first {bad[:3]})")


def sharded_place_work(batch: Batch, packed, mesh, cand_bytes: int):
    """(bytes, float32 ops) of the sharded placement scan on the busiest
    card: the function's own (``fused_place_work``: the columns the live
    lanes refer to read once, the lanes' operands once, the output once,
    and the operations the data needs) in that card's share of the node
    shards.  Also returns the bytes a later step of this design touches
    there, logged beside the bound: the candidates' state (``cand_bytes``
    a candidate; a live lane's candidates are the rows its step 0 found
    feasible and fitting, evaluated less exhausted)."""
    nbytes, ops = fused_place_work(batch, packed, SCAN)
    live = np.asarray(batch.np["lane_mask"], bool)
    first = np.asarray(packed[:, 0].cpu())[live]
    cands = float((first[:, 4] - first[:, 6]).sum())
    devs = [str(d) for d in mesh.flat()]
    share = max(devs.count(d) for d in set(devs)) / len(devs)
    return nbytes * share, ops * share, cands * cand_bytes * share


def step_usage(used, rows, asks, n_batch: int) -> np.ndarray:
    """The unsharded usage after a step's picks: ``used`` plus each pick's
    ask, summed in lane order per batch row, the rows' parts then added
    in order (float32, as the reference's scatter and psum)."""
    used = np.asarray(used, np.float32)
    rows = np.asarray(rows)
    per = len(rows) // n_batch
    delta = np.zeros_like(used)
    for i in range(n_batch):
        part = np.zeros_like(used)
        for lane in range(i * per, (i + 1) * per):
            if rows[lane] >= 0:
                part[rows[lane]] += asks[lane]
        delta = delta + part
    return used + delta


def same_layout(srv, order, shards: int, label: str) -> None:
    """The server's rows equal a from-scratch matrix of ``shards`` home
    shards that took the nodes ``order`` in that order."""
    from nomad_tpu_torch.state.matrix import NodeMatrix

    twin = NodeMatrix(capacity=srv.matrix.capacity, device="cpu")
    twin.set_shard_count(shards)
    for nid in order:
        twin.upsert_node(srv.store.node_by_id(nid))
    if twin.row_of != srv.matrix.row_of:
        raise AssertionError(f"{label}: the layout differs from a "
                             f"from-scratch one on {shards} shards")


def wait_terminal(srv, evals, timeout_s: float = 300.0) -> None:
    deadline = time.time() + timeout_s
    while time.time() < deadline and not all(
            last_eval(srv, e.id) is not None
            and last_eval(srv, e.id).terminal_status() for e in evals):
        time.sleep(0.01)
    statuses = {last_eval(srv, e.id).status for e in evals}
    if statuses != {"complete"}:
        raise AssertionError(f"eval statuses {statuses}")


def sharded_device_us(fn, per_call: int, runs: int = 4, passes: int = 3):
    """Device times of ``sharded_place_kernel`` over ``runs`` calls of
    ``fn`` (``per_call`` launches each, step 0 first), from the profiler's
    kernel records: ``dispatch_us`` (the launches' sum a call),
    ``step0_us`` (the median of the calls' first launches) and
    ``later_us`` (the median of the others).  None (not measured) when no
    pass kept every record."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(passes):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        recs = sorted((e.time_range.start, e.time_range.elapsed_us())
                      for e in prof.events()
                      if "sharded_place_kernel" in e.name)
        if len(recs) != runs * per_call:
            log(f"profiler: {len(recs)} of {runs * per_call} "
                "sharded_place_kernel launches recorded")
            continue
        us = [d for _, d in recs]
        return {"dispatch_us": sum(us) / runs,
                "step0_us": statistics.median(us[::per_call]),
                "later_us": statistics.median(
                    [d for i, d in enumerate(us) if i % per_call])}
    return None


def check_sharded_launches(launches: dict) -> None:
    """The sharded burst placed through ``sharded_place`` and the windowed
    ``allocs_fit_verify``, never a plain version or the unsharded path."""
    if (launches["sharded_place"] <= 0
            or launches["allocs_fit_verify_window"] <= 0):
        raise AssertionError(f"sharded: a kernel never launched: {launches}")
    if launches["plain"] or launches["fused_place"] or launches[
            "allocs_fit_verify"]:
        raise AssertionError(f"sharded: a plain version or the unsharded "
                             f"path ran: {launches}")


def check_usage_launches(launches: int) -> None:
    """The sharded steps updated the usage through ``sharded_usage``."""
    if launches <= 0:
        raise AssertionError("sharded: the step never launched sharded_usage")


def device_us_per_call(fn, runs: int = 20,
                       passes: int = 3) -> Optional[float]:
    """Device time of one call of ``fn`` that launches several kernels
    (a library call): the sum over its kernels, by name, of the median
    record of each, from the CUDA profiler.  None (not measured) when no
    pass kept at least half of every kernel's records."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(passes):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        by_name: dict = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by_name.setdefault(e.name, []).append(
                    e.time_range.elapsed_us())
        if by_name and all(2 * len(v) >= runs for v in by_name.values()):
            return sum(statistics.median(v) for v in by_name.values())
        log(f"profiler: kept {({n: len(v) for n, v in by_name.items()})} "
            f"of {runs} calls' kernel records")
    return None


def time_usage(used, packed, req_f, n_batch: int, off: int, label: str,
               card: str) -> dict:
    """``sharded_usage`` on one shard: equal to its plain version bit for
    bit (else fails), then its CUDA-event ms, profiler device us and host
    us a call, the plain version's ms (on the host's copies), the bound,
    and the library's scatter-add of the same asks into the same rows
    (``index_add`` of the picks inside the window, chosen before the
    timing) by CUDA events and on the device."""
    import torch

    from nomad_tpu_torch.ops import kernels as k

    args = (used, packed, req_f, n_batch, off)
    got = k.sharded_usage(*args)
    host = [x.cpu() for x in (used, packed, req_f)]
    want = k.sharded_usage_plain(*host, n_batch, off)
    if not torch.equal(got.cpu().view(torch.int32), want.view(torch.int32)):
        raise AssertionError(f"sharded_usage [{label}] disagrees with its "
                             f"plain version: max |err| "
                             f"{float((got.cpu() - want).abs().max())}")
    n = int(used.shape[0])
    rows = host[1][:, 0, k.PACKED_ROW].numpy().astype(np.int64)
    mine = np.flatnonzero((rows >= off) & (rows < off + n))
    ask = k.REQ_FLOAT_OFF["ask"][0]
    idx = torch.from_numpy(rows[mine] - off).to(used.device)
    src = req_f[torch.from_numpy(mine).to(used.device), ask:ask + 3]
    src = src.contiguous()

    def library():
        return used.index_add(0, idx, src)

    out = {
        "lanes": int(packed.shape[0]), "rows": n, "picks_inside": len(mine),
        "ms": time_cuda(lambda: k.sharded_usage(*args), 20),
        "device_us": device_us_per_launch(lambda: k.sharded_usage(*args),
                                          "sharded_usage_kernel"),
        "host_us": host_us_per_call(lambda: k.sharded_usage(*args), 500),
        "plain_ms": time_cuda(
            lambda: k.sharded_usage_plain(*host, n_batch, off), 3, warmup=1),
        "library_ms": time_cuda(library, 20),
        "library_device_us": device_us_per_call(library),
    }
    out["bound_ms"], out["bound_by"] = bound(
        *sharded_usage_work(rows, n, off))
    log(f"sharded: sharded_usage [{label}]: equal to its plain version bit "
        f"for bit; {out['ms']:.4f} ms by CUDA events (device "
        f"{fmt_us(out['device_us'])}, host {out['host_us']:.3f} us a call); "
        f"index_add {out['library_ms']:.4f} ms (device "
        f"{fmt_us(out['library_device_us'])}); plain {out['plain_ms']:.3f} "
        f"ms; bound {out['bound_ms']:.7f} ms by {out['bound_by']}; "
        f"{len(mine)} of {len(rows)} picks in {n} rows from {off} "
        f"(card: {card})")
    return out


def bench_batch_picks():
    """Phase 7's picks: ``score_batch`` at B=4096 on a fresh bench-shaped
    cluster, packed as the sharded step packs them ((B, 1, 7), step 0's
    row), with the asks' ``req_f``; and the cluster's columns."""
    from nomad_tpu_torch.ops import kernels as k
    from nomad_tpu_torch.parallel import build_batch_inputs

    m = build_cluster(N_NODES, CAPACITY, "cuda")
    arrays = m.sync("cuda")
    reqs, feats = bench_requests(m, SCORE_BATCH)
    inp = build_batch_inputs(m, reqs, "cuda")
    res = k.score_batch(*score_args(arrays, inp), feats)
    return arrays, k.pack_batch_result(res)[:, None].contiguous(), \
        inp["req_f"]


def usage_at_bench_batch(card: str) -> dict:
    """``sharded_usage`` at B=4096 (``bench_batch_picks``), n_batch 2, on
    node shard 1 of the x4 mesh (5,120 rows) and of the x8 mesh (2,560
    rows): ``time_usage`` of each."""
    from nomad_tpu_torch.parallel import sharding

    arrays, packed, req_f = bench_batch_picks()
    out = {}
    for devs in (["cuda:0"] * 4, ["cuda:0"] * 8):
        mesh = sharding.make_mesh(devices=devs)
        sharded = sharding.shard_matrix_arrays(mesh, arrays)
        shard = sharded.shards[0][1]
        out[f"x{len(devs)}"] = time_usage(
            shard.used, packed, req_f, mesh.shape[0], sharded.row_offset(1),
            f"x{len(devs)} shard 1, B={packed.shape[0]}", card)
    return out


# usage_case names of tests/torch_edge_cases.py timed beside the bench's
# picks: picks spread over the whole matrix (b4096), half of them on four
# hot rows (grouping), runs on one row between picks on others (runs);
# each on node shard 1 of x4 (5,120 rows from 5,120), n_batch 2.
SPREAD_USAGE_CASES = ("b4096", "grouping", "runs")


def usage_on_spread_picks(card: str) -> dict:
    """``time_usage`` of each of SPREAD_USAGE_CASES: the list walk over
    picks on several rows of a CTA, which the bench's picks (all on one
    row, or none in the shard) never reach."""
    import torch

    from nomad_tpu_torch.ops import kernels as k

    cases = edge_cases_module()
    out = {}
    for case in SPREAD_USAGE_CASES:
        w = cases.usage_case(case)
        used, packed, req_f = (torch.from_numpy(x).to("cuda") for x in
                               cases.usage_operands(
                                   w, k.PACKED_WIDTH, k.REQ_FLOAT_WIDTH,
                                   k.REQ_FLOAT_OFF["ask"][0]))
        out[case] = time_usage(used, packed, req_f, w["n_batch"],
                               w["row_offset"],
                               f"{case}, x4 shard 1, B={packed.shape[0]}",
                               card)
    return out


def kernel_ab() -> None:
    """The two kernels' times in whichever ``nomad_tpu_torch`` this process
    imports, at the smoke's shapes, as one JSON line: ``verify_plan_fit``
    on the seeded plan (K=10,000 on a fresh 10,000-node cluster), and
    ``sharded_usage`` on node shard 1 at B=64 (x4, the feature batch's
    step, as 14b) and at B=4096 (x4 and x8 on phase 7's picks, and the
    spread picks of SPREAD_USAGE_CASES, as 14b').  Only calls that an
    earlier tree's wrappers share, so an earlier tree is timed with the
    same inputs in the same call: from that tree's root, load this file
    by path (importlib) and call ``kernel_ab()``."""
    import types

    import torch

    from nomad_tpu_torch.ops import kernels as k
    from nomad_tpu_torch.parallel import sharding

    card = card_line()
    tree = str(Path(k.__file__).resolve().parents[2])
    m = build_cluster(N_NODES, CAPACITY, "cuda")
    cols, rows, deltas, er = seeded_plan(m)
    arrays = types.SimpleNamespace(**{
        f: torch.from_numpy(v).to("cuda") for f, v in cols.items()})
    args = (arrays, *(torch.from_numpy(x).to("cuda")
                      for x in (rows, deltas, er)))
    got = k.verify_plan_fit(*args)
    if not torch.equal(got.cpu(), k.verify_plan_fit_plain(*args).cpu()):
        raise AssertionError("verify_plan_fit disagrees with its plain "
                             "version")
    out = {"tree": tree, "card": card, "verify_plan_fit": {
        "ms": time_cuda(lambda: k.verify_plan_fit(*args), 20),
        "device_us": device_us_per_launch(lambda: k.verify_plan_fit(*args),
                                          "verify_plan_fit_kernel"),
        "host_us": host_us_per_call(lambda: k.verify_plan_fit(*args), 500),
    }}
    feat = make_batches(m, "cuda")[1]
    ops = sharded_operands(feat)
    mesh = sharding.make_mesh(devices=["cuda:0"] * 4)
    sharded = sharding.shard_matrix_arrays(mesh, feat.arrays)
    res, _ = sharding.sharded_schedule_step(mesh)(sharded, *ops[2:-1])
    packed = k.pack_batch_result(res)[:, None].contiguous()
    out["sharded_usage_b64"] = time_usage(
        sharded.shards[0][1].used, packed, torch.from_numpy(ops[6]).cuda(),
        mesh.shape[0], sharded.row_offset(1), "x4 shard 1, B=64", card)
    out["sharded_usage_b4096"] = usage_at_bench_batch(card)
    out["sharded_usage_spread"] = usage_on_spread_picks(card)
    print("ab: " + json.dumps(out), flush=True)


def burst_ab(rounds: int = 3) -> None:
    """The server phase's service burst in whichever ``nomad_tpu_torch``
    this process imports, as one JSON line: a one-card server over the
    server phases' 10,000 nodes (usage pre-loaded) takes ``rounds`` bursts
    of 64 count-2 jobs; evals/s of each.  Called as ``kernel_ab()`` is,
    from each tree's root, so host-bound paths are compared in one call."""
    from nomad_tpu_torch.ops import kernels as k
    from nomad_tpu_torch.server.server import Server

    card = card_line()
    tree = str(Path(k.__file__).resolve().parents[2])
    srv = Server(server_config(), device="cuda")
    srv.start()
    try:
        register_cluster(srv, "burst ab")
        rates = []
        for r in range(rounds):
            jobs = [service_job(i) for i in range(SERVER_JOBS)]
            _, secs = burst(srv, jobs)
            rates.append(SERVER_JOBS / secs)
    finally:
        srv.shutdown()
    print("ab: " + json.dumps({"tree": tree, "card": card,
                               "burst_evals_per_s": rates}), flush=True)


def phase_sharded(card: str, results: dict) -> None:
    import torch

    from nomad_tpu_torch.ops import kernels as k
    from nomad_tpu_torch.parallel import sharding
    from nomad_tpu_torch.server.server import Server

    m = build_cluster(N_NODES, CAPACITY, "cuda")
    batches = make_batches(m, "cuda")
    rp = results.setdefault("sharded_place", {"max_abs_err": 0.0})
    rv = results.setdefault("allocs_fit_verify_window", {"max_abs_err": 0.0})
    ru = results.setdefault("sharded_usage", {"max_abs_err": 0.0,
                                              "launches": 0})
    out = results.setdefault("sharded", {})
    ask = k.REQ_FLOAT_OFF["ask"][0]

    # -- 14a: the three programs against the unsharded kernels, and the
    # kernels against their plain versions.
    for devs in shard_meshes():
        mesh = sharding.make_mesh(devices=devs)
        sharded = sharding.shard_matrix_arrays(mesh, batches[0].arrays)
        for label, batch in zip(("bench-shapes", "features"), batches):
            ops = sharded_operands(batch)
            f = batch.features
            args = batch.args()
            got = sharding.sharded_fused_place_batch(mesh, SCAN)(
                sharded, *ops, features=f)
            exact(f"{mesh.shape} {label} fused", got,
                  k.fused_place_batch(*args, SCAN, f))
            got = sharding.sharded_place_batch(mesh, SCAN)(sharded, *ops[:-1])
            exact(f"{mesh.shape} {label} staged", got,
                  k.place_batch(*args[:-1], SCAN))
            # The step is the path of the sharded_usage kernel: its
            # launches count from here to the step's return.
            k.reset_counts()
            res, used_after = sharding.sharded_schedule_step(mesh)(
                sharded, *ops[2:-1])
            ru["launches"] += k.sharded_usage.launches
            want = k.score_batch(*args[:2], *args[4:-1])
            exact(f"{mesh.shape} {label} step", k.pack_batch_result(res),
                  k.pack_batch_result(want))
            want_used = torch.from_numpy(step_usage(
                batch.arrays.used.cpu(), want.rows.cpu(),
                ops[6][:, ask:ask + 3], mesh.shape[0]))
            for i, row in enumerate(used_after):
                exact(f"{mesh.shape} {label} step usage (batch row {i})",
                      torch.cat([u.cpu() for u in row]), want_used)
            # sharded_usage against its plain version on the last shard.
            step_packed = k.pack_batch_result(res)[:, None].contiguous()
            last = sharded.shards[0][-1]
            off = sharded.row_offset(mesh.shape[1] - 1)
            d = last.used.device
            rf = torch.from_numpy(ops[6]).to(d)
            uk = k.sharded_usage(last.used, step_packed.to(d), rf,
                                 mesh.shape[0], off)
            up = k.sharded_usage_plain(last.used.cpu(), step_packed.cpu(),
                                       rf.cpu(), mesh.shape[0], off)
            err = float((uk.cpu() - up).abs().max())
            ru["max_abs_err"] = max(ru["max_abs_err"], err)
            if not torch.equal(uk.cpu(), up):
                raise AssertionError(f"sharded_usage disagrees with its "
                                     f"plain version on {label}: max |err| "
                                     f"{err}")
            groups = sharding._lane_groups(sharded, *ops)
            kern = k.sharded_place(groups, SCAN, f)
            plain = [k.sharded_place_plain(row, SCAN, f) for row in groups]
            _sync()
            for a, b in zip(kern, plain):
                ok, err, msg = compare(a.cpu(), b.cpu(), k.PACKED_WIDTH)
                rp["max_abs_err"] = max(rp["max_abs_err"], err)
                if not ok or not torch.equal(a.cpu(), b.cpu()):
                    raise AssertionError(f"sharded_place disagrees with its "
                                         f"plain version on {label}: {msg}")
            last = sharded.shards[0][-1]
            off = sharded.row_offset(mesh.shape[1] - 1)
            d = last.used.device
            packed = torch.cat([o.to(d) for o in kern])
            t = batch.t
            vargs = (last.totals, last.used, packed, t["req_f"].to(d),
                     t["delta_rows"].to(d), t["delta_vals"].to(d),
                     t["lane_mask"].to(d))
            vk = k.allocs_fit_verify(*vargs, row_offset=off)
            vp = k.verify_lanes(*vargs, row_offset=off)
            ok, err, msg = compare(vk.cpu(), vp.cpu(), k.FUSED_PACKED_WIDTH)
            rv["max_abs_err"] = max(rv["max_abs_err"], err)
            if not ok or not torch.equal(vk.cpu(), vp.cpu()):
                raise AssertionError(f"windowed allocs_fit_verify disagrees "
                                     f"with its plain version: {msg}")
            log(f"sharded[{mesh.shape} {label}]: fused, staged and step "
                f"equal the unsharded kernels in every column, and the "
                f"step's usage the unsharded usage plus the picks' asks; "
                f"sharded_place, the windowed allocs_fit_verify and "
                f"sharded_usage equal their plain versions (max |err| "
                f"{rp['max_abs_err']:.3g} / {rv['max_abs_err']:.3g} / "
                f"{ru['max_abs_err']:.3g})")
    rp["matches_plain"] = rv["matches_plain"] = ru["matches_plain"] = True
    check_usage_launches(ru["launches"])

    # -- 14b: times at 4 and 8 virtual shards, on the feature batch.
    feat = batches[1]
    ops = sharded_operands(feat)
    for devs in shard_meshes()[:2]:
        mesh = sharding.make_mesh(devices=devs)
        sharded = sharding.shard_matrix_arrays(mesh, feat.arrays)
        groups = sharding._lane_groups(sharded, *ops)
        fn = sharding.sharded_fused_place_batch(mesh, SCAN)
        kern_ms = time_cuda(lambda: k.sharded_place(groups, SCAN,
                                                    feat.features), 5)
        t0 = time.perf_counter()
        for _ in range(5):
            fn(sharded, *ops, features=feat.features)
        _sync()
        dispatch_ms = (time.perf_counter() - t0) / 5 * 1e3
        # What one dispatch issues, counted by the wrapper.
        before = (k.sharded_place.launches, k.sharded_place.copies)
        packed = torch.cat([o.to(mesh.lead) for o in
                            k.sharded_place(groups, SCAN, feat.features)])
        n_launch = k.sharded_place.launches - before[0]
        n_copy = k.sharded_place.copies - before[1]
        if n_launch != SCAN + 1 or n_copy:
            raise AssertionError(f"sharded[x{len(devs)}]: a dispatch on one "
                                 f"card issued {n_launch} launches and "
                                 f"{n_copy} offer copies, not {SCAN + 1} "
                                 f"and 0")
        shape = k.sharded_place_shape(
            sharded.n_local, int(ops[5].shape[0]) // mesh.shape[0]
            * len(devs), int(ops[0].shape[1]), SCAN, feat.features)
        nbytes, nops, step_bytes = sharded_place_work(
            feat, packed, mesh, CAND_BYTES[shape["tier"]])
        b_ms, b_by = bound(nbytes, nops)
        key = f"x{len(devs)}"
        steps = sharded_device_us(
            lambda: k.sharded_place(groups, SCAN, feat.features), n_launch)
        out[key] = {"sharded_place_ms": kern_ms, "dispatch_ms": dispatch_ms,
                    "bound_ms": b_ms, "bound_by": b_by,
                    "step_bytes": step_bytes, "launches": n_launch,
                    "copies": n_copy, "shape": shape, "device": steps}
        log(f"sharded[x{len(devs)}]: sharded_place on the device "
            + ("not measured" if steps is None else
               f"{steps['dispatch_us']:.3f} us a dispatch: step 0 "
               f"{steps['step0_us']:.3f} us, a later step (median) "
               f"{steps['later_us']:.3f} us") + f" (card: {card})")
        log(f"sharded[{key}]: sharded_place {kern_ms:.4f} ms a dispatch "
            f"({n_launch} launches and {n_copy} offer copies counted, CUDA "
            f"events; cluster {shape['cluster']}, span {shape['span']}), "
            f"bound {b_ms:.6f} ms by {b_by} ({nbytes:.0f} bytes, "
            f"{nops:.4g} ops on the busiest card); a later step reads the "
            f"candidates' state, {step_bytes:.0f} bytes there "
            f"({step_bytes / HBM_BYTES_PER_S * 1e3:.6f} ms at the memory "
            f"rate); the whole fused dispatch {dispatch_ms:.3f} ms on the "
            f"host clock (card: {card})")
        if len(devs) != 4:
            continue
        rp["ms"], rp["bound_ms"], rp["bound_by"] = kern_ms, b_ms, b_by
        rp["plain_ms"] = time_cuda(
            lambda: [k.sharded_place_plain(row, SCAN, feat.features)
                     for row in groups], 1, warmup=0)
        rp["device_us"] = device_us_per_launch(
            lambda: k.sharded_place(groups, SCAN, feat.features),
            "sharded_place_kernel", runs=4)
        shard = sharded.shards[0][1]
        d = shard.used.device
        t = feat.t
        vargs = (shard.totals, shard.used, packed.to(d), t["req_f"].to(d),
                 t["delta_rows"].to(d), t["delta_vals"].to(d),
                 t["lane_mask"].to(d))
        off = sharded.row_offset(1)
        rv["ms"] = time_cuda(
            lambda: k.allocs_fit_verify(*vargs, row_offset=off), 20)
        rv["plain_ms"] = time_cuda(
            lambda: k.verify_lanes(*vargs, row_offset=off), 1, warmup=0)
        rv["bound_ms"], rv["bound_by"] = bound(*verify_work(
            feat, packed, SCAN, window=(off, off + sharded.n_local)))
        rv["device_us"] = device_us_per_launch(
            lambda: k.allocs_fit_verify(*vargs, row_offset=off),
            "allocs_fit_verify_kernel")
        rp["library_ms"] = rv["library_ms"] = None
        # sharded_usage on the same shard, after the feature batch's step.
        res, _ = sharding.sharded_schedule_step(mesh)(sharded, *ops[2:-1])
        step_packed = k.pack_batch_result(res)[:, None].contiguous().to(d)
        rf = torch.from_numpy(ops[6]).to(d)
        ru.update(time_usage(shard.used, step_packed, rf, mesh.shape[0], off,
                             f"x4 shard 1, B={step_packed.shape[0]}", card))
        ru["host_split_us"] = usage_wrapper_split(
            shard.used, step_packed, rf, mesh.shape[0], off, card)
        log(f"sharded: sharded_place device {fmt_us(rp['device_us'])} a "
            f"launch, plain version {rp['plain_ms']:.1f} ms; windowed "
            f"allocs_fit_verify {rv['ms']:.4f} ms (device "
            f"{fmt_us(rv['device_us'])}), plain {rv['plain_ms']:.1f} ms, "
            f"bound {rv['bound_ms']:.6f} ms (card: {card})")

    # -- 14b': sharded_usage at the bench's batch, phase 7's picks.
    ru["b4096"] = usage_at_bench_batch(card)
    ru["spread"] = usage_on_spread_picks(card)

    # -- 14c: live servers, sharded over four virtual shards and alone.
    def run(label, device, shards=None):
        cfg = server_config()
        # The one-device server says so: by default a host of several
        # cards shards over all of them.
        cfg.n_device_shards = shards
        srv = Server(cfg, device=device)
        srv.start()
        try:
            # Nodes by registration order (their ids are random).
            index = {nid: i for i, nid in enumerate(
                register_cluster(srv, label))}
            seq = {}
            for i in range(SHARD_SEQ_JOBS):
                ev = srv.submit_job(service_job(i))
                done = srv.wait_for_eval(ev.id, timeout=120.0)
                if done is None or done.status != "complete":
                    raise AssertionError(f"{label}: eval {done}")
                for a in srv.store.allocs_by_job("default", ev.job_id):
                    seq[(i, a.name.rsplit(".", 1)[-1])] = index[a.node_id]
            k.reset_counts()
            d0 = srv.coalescer.dispatches
            evals, elapsed = burst(
                srv, [service_job(i) for i in range(SERVER_JOBS)])
            launches = {
                "sharded_place": k.sharded_place.launches,
                "allocs_fit_verify_window": k.allocs_fit_verify.window_launches,
                "fused_place": k.fused_place.launches,
                "allocs_fit_verify": k.allocs_fit_verify.launches,
                "plain": (k.sharded_place_plain.calls + k.place_lanes.calls
                          + k.verify_lanes.calls
                          + k.sharded_usage_plain.calls),
                "copies": k.sharded_place.copies,
                "dispatches": srv.coalescer.dispatches - d0,
            }
            wait_terminal(srv, evals)
            return seq, SERVER_JOBS / elapsed, launches, srv.coalescer
        finally:
            srv.shutdown()

    one_seq, one_rate, one_l, _ = run("sharded one-device", "cuda:0", 1)
    seq, rate, launches, coal = run("sharded x4", ["cuda:0"] * 4)
    if coal.n_device_shards != 4:
        raise AssertionError(f"sharded: {coal.n_device_shards} shards")
    if seq != one_seq or len(seq) != SHARD_SEQ_JOBS * SERVER_COUNT:
        diff = [key for key in one_seq if seq.get(key) != one_seq[key]]
        raise AssertionError(f"sharded: the x4 server placed {len(diff)} of "
                             f"{len(one_seq)} allocs elsewhere than the "
                             f"one-device server")
    check_sharded_launches(launches)
    if torch.cuda.device_count() > 1:
        cards = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        c_seq, c_rate, c_l, c_coal = run("sharded cards", cards)
        if c_seq != one_seq or c_coal.n_device_shards != len(cards):
            raise AssertionError("sharded: the server over every card placed "
                                 "elsewhere than the one-device server")
        check_sharded_launches(c_l)
        out["cards_evals_per_s"] = c_rate
        log(f"sharded: a server over {len(cards)} cards placed the "
            f"{SHARD_SEQ_JOBS} jobs on the same nodes; burst {c_rate:.1f} "
            f"evals/s; launches {c_l} (card: {card})")
    rp["launches"] = launches["sharded_place"]
    rv["launches"] = launches["allocs_fit_verify_window"]
    copies = launches["copies"] / max(1, launches["dispatches"])
    out.update(evals_per_s=rate, one_device_evals_per_s=one_rate,
               launches=launches, copies_per_dispatch=copies)
    log(f"sharded: {SHARD_SEQ_JOBS} jobs one at a time placed on the same "
        f"nodes by the x4 and the one-device server; burst of {SERVER_JOBS} "
        f"x {SERVER_COUNT}: x4 {rate:.1f} evals/s, one device "
        f"{one_rate:.1f} evals/s (card: {card})")
    log(f"sharded: launches during the x4 burst {launches}; "
        f"{copies:.1f} offer copies a dispatch; one-device burst launches "
        f"{one_l}")

    # -- 14d: evacuation mid-burst and heal, on eight virtual shards.
    srv = Server(server_config(), device=["cuda:0"] * 8)
    srv.start()
    try:
        register_cluster(srv, "sharded x8")
        burst(srv, [service_job(i) for i in range(4)])
        coal = srv.coalescer
        if srv.matrix.shard_count != 4:
            raise AssertionError(f"x8: {srv.matrix.shard_count} home shards")
        jobs = [service_job(i) for i in range(SERVER_JOBS)]
        t0 = time.perf_counter()
        evals = [srv.submit_job(j) for j in jobs[:SERVER_JOBS // 2]]
        time.sleep(0.05)
        order = [srv.matrix.node_of[r] for r in sorted(srv.matrix.node_of)]
        survivors = coal.evacuate_shard(1)
        evals += [srv.submit_job(j) for j in jobs[SERVER_JOBS // 2:]]
        wait_terminal(srv, evals)
        evac_s = time.perf_counter() - t0
        if survivors != 3:
            raise AssertionError(f"x8 evacuation: {survivors} survivors")
        same_layout(srv, order, 3, "x8 evacuation")
        if coal.n_device_shards != 6 or coal._mesh.shape != (2, 3):
            raise AssertionError(f"x8: survivor mesh {coal._mesh}")
        order = [srv.matrix.node_of[r] for r in sorted(srv.matrix.node_of)]
        if coal.heal_shard_evacuations() != 4:
            raise AssertionError("x8: the heal did not restore 4 shards")
        same_layout(srv, order, 4, "x8 heal")
        evals2, heal_s = burst(srv, [service_job(i)
                                     for i in range(SERVER_JOBS)])
        wait_terminal(srv, evals2)
        if coal.n_device_shards != 8 or coal._mesh.shape != (2, 4):
            raise AssertionError(f"x8: healed mesh {coal._mesh}")
        if srv.metrics.snapshot().get(
                "nomad.coalescer.shard_evacuations") != 1:
            raise AssertionError("x8: the evacuation gauge did not count")
        out.update(evacuation_s=evac_s, heal_burst_s=heal_s)
        log(f"sharded x8: shard 1 evacuated mid-burst of {SERVER_JOBS}: every "
            f"eval complete in {evac_s:.3f} s on a (2, 3) survivor mesh, the "
            f"layout a from-scratch one on 3 shards; healed to (2, 4), the "
            f"next burst complete in {heal_s:.3f} s (card: {card})")
    finally:
        srv.shutdown()


# ---------------------------------------------------------------------------
# Phase 15: chaos on the card
# ---------------------------------------------------------------------------

CHAOS_CROWD = 24
CHAOS_MESH = 8  # ["cuda"] * 8: two batch rows by four node shards
CHAOS_PARTITION_SAMPLE = 64  # dark nodes whose plans must be refused


def chaos_launches(k) -> dict:
    return {
        "fused_place": k.fused_place.launches,
        "allocs_fit_verify": k.allocs_fit_verify.launches,
        "allocs_fit_verify_window": k.allocs_fit_verify.window_launches,
        "sharded_place": k.sharded_place.launches,
        "sharded_usage": k.sharded_usage.launches,
        "place_batch": k.place_batch.launches,
        "plain": (k.place_lanes.calls + k.verify_lanes.calls
                  + k.system_feasible_plain.calls
                  + k.sharded_place_plain.calls
                  + k.sharded_usage_plain.calls
                  + k.score_batch_plain.calls
                  + k.verify_plan_fit_plain.calls),
    }


def check_chaos(report: dict, launches: dict, label: str,
                kernels=("fused_place", "allocs_fit_verify")) -> None:
    """A scenario's report holds no violation, its kernels launched and no
    plain version (nor the staged kernel) ran."""
    if report["violations"]:
        raise AssertionError(f"{label}: violations {report['violations']}")
    if any(launches[name] <= 0 for name in kernels):
        raise AssertionError(f"{label}: a kernel never launched: {launches}")
    if launches["plain"] or launches["place_batch"]:
        raise AssertionError(f"{label}: a plain version or the staged "
                             f"kernel ran: {launches}")


class _Patched:
    """Replace attributes for a block and put them back after it."""

    def __init__(self, *triples):
        self.triples = triples

    def __enter__(self):
        self.saved = [(obj, name, getattr(obj, name))
                      for obj, name, _ in self.triples]
        for obj, name, value in self.triples:
            setattr(obj, name, value)
        return self

    def __exit__(self, *exc):
        for obj, name, value in self.saved:
            setattr(obj, name, value)
        return False


def chaos_wedge(card: str, out: dict) -> None:
    """15a: ``wedged_dispatch_recovers`` at the north-star width.  The
    breaker's verdicts and the coalescer's launches are recorded around
    it: every refused dispatch launched nothing."""
    from nomad_tpu_torch.chaos.scenarios import SCENARIOS
    from nomad_tpu_torch.obs.breaker import DeviceBreaker
    from nomad_tpu_torch.ops import kernels as k
    from nomad_tpu_torch.scheduler.coalescer import DeviceCoalescer

    verdicts, launched = [], []
    allow, dispatch = (DeviceBreaker.allow_device_dispatch,
                       DeviceCoalescer._dispatch)

    def watched_allow(self, *a, **kw):
        verdicts.append(allow(self, *a, **kw))
        return verdicts[-1]

    def watched_dispatch(self, batch):
        launched.append(len(batch))
        return dispatch(self, batch)

    tmp = tempfile.mkdtemp(prefix="nomad-smoke-chaos-")
    try:
        k.reset_counts()
        with _Patched((DeviceBreaker, "allow_device_dispatch", watched_allow),
                      (DeviceCoalescer, "_dispatch", watched_dispatch)):
            r = SCENARIOS["wedged_dispatch_recovers"](
                11, tmp, crowd=CHAOS_CROWD, device="cuda", n_nodes=N_NODES)
        launches = chaos_launches(k)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check_chaos(r, launches, "15a")
    wedges = [f for f in r["faults"] if f[1] == "wedge"]
    admitted = sum(1 for ok, _ in verdicts if ok)
    refused = len(verdicts) - admitted
    if len(wedges) != 1 or not r["tripped"] or r["wedged_dispatches"] != 1:
        raise AssertionError(f"15a: the wedge did not fire once and trip: "
                             f"{r}")
    if refused < 1 or refused != r["degraded_dispatches"] or len(
            launched) != admitted:
        raise AssertionError(f"15a: {len(launched)} launches, {admitted} "
                             f"admitted, {refused} refused, report "
                             f"{r['degraded_dispatches']}")
    if not r["recovered"] or not r["placed_after_close"] or r[
            "crowd_placed"] != CHAOS_CROWD:
        raise AssertionError(f"15a: not re-closed or the crowd not placed "
                             f"in full: {r}")
    if r["throughput_ratio"] < 0.5:
        raise AssertionError(f"15a: throughput ratio {r['throughput_ratio']}")
    out["wedge"] = dict(r, launches=launches, refused=refused,
                        launched=len(launched))
    drill = out.get("drill", {})
    log(f"15a wedged_dispatch_recovers ({N_NODES} nodes): crowd -> trip "
        f"{r['crowd_to_trip_s']:.3f} s, trip -> close "
        f"{r['trip_to_close_s']:.3f} s, crowd -> every crowd job placed "
        f"{r['crowd_to_placed_s']:.3f} s; {refused} dispatches refused while "
        f"open, {len(launched)} launched; rates pre {r['pre_rate']} / while "
        f"open {r['post_rate']} / after {r['recovered_rate']} evals/s, ratio "
        f"{r['throughput_ratio']}; launches {launches} (phase 10's drill: "
        f"spin -> trip {drill.get('spin_to_trip_s', float('nan')):.3f} s, "
        f"trip -> close {drill.get('trip_to_close_s', float('nan')):.3f} s, "
        f"spin -> last placement "
        f"{drill.get('spin_to_last_placement_s', float('nan')):.3f} s) "
        f"(card: {card})")


def chaos_slow(card: str, out: dict) -> None:
    """15b: ``device_slow_flapping`` on a 10,000-node matrix."""
    from nomad_tpu_torch.chaos.scenarios import SCENARIOS
    from nomad_tpu_torch.ops import kernels as k

    tmp = tempfile.mkdtemp(prefix="nomad-smoke-chaos-")
    try:
        k.reset_counts()
        t0 = time.perf_counter()
        r = SCENARIOS["device_slow_flapping"](7, tmp, device="cuda",
                                              n_nodes=N_NODES)
        took = time.perf_counter() - t0
        launches = chaos_launches(k)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check_chaos(r, launches, "15b")
    if (r["flips"] > r["flip_budget"] or r["placed"] != 60
            or r["slow_recorded"] < 1):
        raise AssertionError(f"15b: {r}")
    out["slow"] = dict(r, launches=launches, seconds=took)
    log(f"15b device_slow_flapping ({N_NODES} nodes): {r['placed']} placed, "
        f"{r['refused']} refusals re-sent, {r['slow_recorded']} slow, "
        f"{len(r['faults'])} faults fired, trips {r['trips']}, flips "
        f"{r['flips']} of {r['flip_budget']} ({r['flips_suppressed']} "
        f"suppressed), final {r['final_state']}; {took:.2f} s; launches "
        f"{launches} (card: {card})")


def chaos_shard_loss(card: str, out: dict) -> None:
    """15c: ``shard_loss_evacuation`` over 10,000 nodes on four virtual
    node shards.  Each dispatch of the scenario's mesh coalescer records
    its ``sharded_place`` launches and the mesh it ran on."""
    from nomad_tpu_torch.chaos.scenarios import SCENARIOS
    from nomad_tpu_torch.ops import kernels as k
    from nomad_tpu_torch.scheduler.coalescer import DeviceCoalescer

    per_dispatch = []
    dispatch = DeviceCoalescer._dispatch

    def watched_dispatch(self, batch):
        before = k.sharded_place.launches
        got = dispatch(self, batch)
        if self._mesh_devices is not None:
            per_dispatch.append((k.sharded_place.launches - before,
                                 self._mesh.shape[1]))
        return got

    tmp = tempfile.mkdtemp(prefix="nomad-smoke-chaos-")
    try:
        k.reset_counts()
        with _Patched((DeviceCoalescer, "_dispatch", watched_dispatch)):
            r = SCENARIOS["shard_loss_evacuation"](5, tmp, device="cuda",
                                                   n_nodes=N_NODES)
        launches = chaos_launches(k)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check_chaos(r, launches, "15c",
                kernels=("sharded_place", "allocs_fit_verify_window"))
    if [shards for _, shards in per_dispatch] != [4, 3, 4] or any(
            n <= 0 for n, _ in per_dispatch):
        raise AssertionError(f"15c: sharded_place launches and node shards "
                             f"a dispatch {per_dispatch}")
    if (r["parity_mismatches"] or r["resident_mismatches"]
            or r["restored_shards"] != 4 or r["post_shards"] != 3):
        raise AssertionError(f"15c: {r}")
    out["shard_loss"] = dict(r, launches=launches,
                             per_dispatch=per_dispatch)
    log(f"15c shard_loss_evacuation ({N_NODES} nodes, x{CHAOS_MESH} "
        f"virtual): shards {r['pre_counts']} -> {r['post_counts']} -> "
        f"{r['restored_shards']}; evacuation {r['evacuation_ms']:.3f} ms on "
        f"the host, re-upload {r['reupload_bytes']} bytes; sharded_place "
        f"launches and node shards a dispatch {per_dispatch}; rows "
        f"{r['pre_placed_row']}, {r['placed_row']}; launches {launches} "
        f"(card: {card})")


def chaos_partition(card: str, out: dict) -> None:
    """15d: the shard partition (the reference's TestShardPartitionSeam)
    on the 15c mesh over 10,000 nodes."""
    from nomad_tpu_torch import mock as tmock
    from nomad_tpu_torch.chaos import FaultSpec, check_store, injected
    from nomad_tpu_torch.chaos.scenarios import _coalescer_inputs
    from nomad_tpu_torch.ops import kernels as k
    from nomad_tpu_torch.scheduler.coalescer import DeviceCoalescer
    from nomad_tpu_torch.server.server import Server, ServerConfig
    from nomad_tpu_torch.structs.types import Plan

    srv = Server(ServerConfig(num_workers=2, heartbeat_min_ttl=3600.0,
                              heartbeat_max_ttl=7200.0,
                              node_capacity=CAPACITY), device="cuda")
    srv.start()
    coal = None
    try:
        m = srv.store.matrix
        m.set_shard_count(4)
        nodes = {}
        for _ in range(N_NODES):
            node = tmock.node()
            nodes[node.id] = node
            srv.register_node(node)
        coal = DeviceCoalescer(m, max_lanes=2, linger_s=0.0,
                               pipeline_depth=1,
                               device=["cuda"] * CHAOS_MESH)
        coal.start()
        # The target is shard 0 (equal claims tie to the lowest index):
        # a request that may only use shard 0's rows.
        shard0 = set(m.shard_nodes(0))
        job = tmock.job()

        def shard0_inputs():
            inp = _coalescer_inputs(m, job)
            inp["host_mask"][:] = False
            for nid in shard0:
                inp["host_mask"][m.row_of[nid]] = True
            return inp

        def plan_for(nid):
            j = tmock.job()
            j.task_groups[0].count = 1
            return Plan(job=j, node_allocation={
                nid: [tmock.alloc(j, nodes[nid])]})

        k.reset_counts()
        with injected(9, [FaultSpec("shard.partition", "dark",
                                    count=1)]) as inj:
            res = coal.place(**shard0_inputs())
        launches = chaos_launches(k)
        if [f.kind for f in inj.log] != ["dark"] or sorted(
                coal._dark_shards) != [0]:
            raise AssertionError(f"15d: fired {inj.log}, dark "
                                 f"{sorted(coal._dark_shards)}")
        if set(coal._dark_shards[0]) != shard0:
            raise AssertionError("15d: the darkened nodes are not shard 0's")
        picks = [m.node_of[int(r)] for r in res.rows if r >= 0]
        if not picks or any(nid not in shard0 for nid in picks):
            raise AssertionError(f"15d: the in-flight picks {res.rows}")
        sample = sorted(shard0)[::max(1, len(shard0)
                                      // CHAOS_PARTITION_SAMPLE)]
        targets = list(dict.fromkeys(picks + sample))
        committed = [nid for nid in targets
                     if srv.plan_applier.apply(plan_for(nid)).node_allocation]
        if committed:
            raise AssertionError(f"15d: {len(committed)} plans onto the dark "
                                 f"shard committed")
        after_dark = coal.place(**shard0_inputs())
        if (after_dark.rows >= 0).any():
            raise AssertionError(f"15d: a placement after the darkening "
                                 f"found rows {after_dark.rows}")
        healed = coal.heal_shard_partitions()
        later = coal.place(**shard0_inputs())
        later_picks = [m.node_of[int(r)] for r in later.rows if r >= 0]
        landed = [nid for nid in dict.fromkeys(later_picks + targets)
                  if srv.plan_applier.apply(plan_for(nid)).node_allocation]
        if healed != [0] or not later_picks or any(
                nid not in shard0 for nid in later_picks) or len(
                landed) != len(dict.fromkeys(later_picks + targets)):
            raise AssertionError(f"15d: healed {healed}, later picks "
                                 f"{later.rows}, {len(landed)} committed")
        launches_all = chaos_launches(k)
        violations = check_store(srv)
        if violations:
            raise AssertionError(f"15d: violations {violations}")
        check_chaos({"violations": []}, launches_all, "15d",
                    kernels=("sharded_place", "allocs_fit_verify_window"))
        if launches["sharded_place"] <= 0:
            raise AssertionError(f"15d: the in-flight placement launched "
                                 f"no sharded_place: {launches}")
        out["partition"] = {"refused": len(targets), "picks": len(picks),
                            "landed": len(landed), "launches": launches_all}
        log(f"15d shard partition ({N_NODES} nodes, x{CHAOS_MESH} virtual): "
            f"shard 0's {len(shard0)} nodes darkened mid-dispatch; all "
            f"{len(targets)} plans onto it refused ({len(picks)} in-flight "
            f"picks, {len(sample)} sampled nodes), a placement after it "
            f"found none there; healed {healed}, {len(landed)} plans there "
            f"committed; launches {launches_all} (card: {card})")
    finally:
        if coal is not None:
            coal.stop()
        srv.shutdown()


def chaos_cluster(card: str, out: dict) -> None:
    """15e: ``leader_kill_mid_apply`` and ``partition_then_heal`` (twice)
    with three in-process server agents on the card, at the reference's
    node counts (see the phase's docstring)."""
    from nomad_tpu_torch.api.agent import Agent
    from nomad_tpu_torch.chaos.scenarios import SCENARIOS
    from nomad_tpu_torch.ops import kernels as k

    agents, marks = [], {}
    start, shutdown = Agent.start, Agent.shutdown

    def watched_start(self, *a, **kw):
        agents.append(self)
        return start(self, *a, **kw)

    def watched_shutdown(self, *a, **kw):
        got = shutdown(self, *a, **kw)
        if "launches" not in marks:
            # The old leader's shutdown has returned: count from here.
            marks["launches"] = chaos_launches(k)
            marks["dispatches"] = {id(x): x.server.coalescer.dispatches
                                   for x in agents}
            marks["old"] = id(self)
            marks["at"] = time.perf_counter()
        return got

    tmp = tempfile.mkdtemp(prefix="nomad-smoke-chaos-")
    try:
        k.reset_counts()
        t0 = time.perf_counter()
        with _Patched((Agent, "start", watched_start),
                      (Agent, "shutdown", watched_shutdown)):
            r = SCENARIOS["leader_kill_mid_apply"](11, tmp, device="cuda")
        kill_s = time.perf_counter() - t0
        after = chaos_launches(k)
        grown = [x for x in agents
                 if x.server.coalescer.dispatches
                 > marks["dispatches"][id(x)]]
        since = {name: after[name] - marks["launches"][name]
                 for name in after}
        since["plain"], since["place_batch"] = (after["plain"],
                                                after["place_batch"])
        check_chaos(r, since, "15e leader kill")
        if len(grown) != 1 or id(grown[0]) == marks["old"]:
            raise AssertionError(f"15e: after the shutdown {len(grown)} "
                                 f"coalescers dispatched")
        if not any(k_ == "delay" for _, k_, _ in r["faults"]):
            raise AssertionError(f"15e: no delay fired: {r['faults']}")
        runs = []
        for i in range(2):
            k.reset_counts()
            t0 = time.perf_counter()
            rp = SCENARIOS["partition_then_heal"](3, os.path.join(
                tmp, f"p{i}"), device="cuda")
            runs.append((rp, chaos_launches(k), time.perf_counter() - t0))
        for rp, launches, _ in runs:
            check_chaos(rp, launches, "15e partition")
            if len([f for f in rp["faults"] if f[1] == "drop"]) != rp[
                    "drops"]:
                raise AssertionError(f"15e: drops {rp}")
        fired = [[(s, kind) for s, kind, _ in rp["faults"]]
                 for rp, _, _ in runs]
        if fired[0] != fired[1]:
            raise AssertionError(f"15e: the partition fired {fired[0]} then "
                                 f"{fired[1]}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["cluster"] = {"kill_launches": since, "kill_s": kill_s,
                      "partition_s": [t for _, _, t in runs],
                      "drops": runs[0][0]["drops"]}
    log(f"15e leader_kill_mid_apply: converged, the new leader launched "
        f"{since['fused_place']} fused_place / {since['allocs_fit_verify']} "
        f"allocs_fit_verify after the old leader's shutdown returned, "
        f"{kill_s:.2f} s; partition_then_heal twice: {runs[0][0]['drops']} "
        f"drops each, the same fired list, {runs[0][2]:.2f} / "
        f"{runs[1][2]:.2f} s, launches {runs[0][1]} (card: {card})")


def phase_chaos(card: str, results: dict) -> None:
    """Phase 15: the chaos scenarios through the card's kernels."""
    out = results.setdefault("chaos", {})
    out["drill"] = results.get("guarded", {})
    timed = {}
    for name, fn in (("15a", chaos_wedge), ("15b", chaos_slow),
                     ("15c", chaos_shard_loss), ("15d", chaos_partition),
                     ("15e", chaos_cluster)):
        t0 = time.perf_counter()
        fn(card, out)
        timed[name] = time.perf_counter() - t0
    out.pop("drill")
    out["seconds"] = timed
    log(f"chaos: parts {', '.join(f'{n} {t:.1f} s' for n, t in timed.items())}"
        f" (card: {card})")


# ----------------------------------------------------------------------
# Phase 16: the encoded-matrix cache, the coalescer's counters and
# TSan-lite
# ----------------------------------------------------------------------

CACHE_DEVICE = "cuda"  # the card the phase's servers and matrices use
CACHE_MESH = 8  # [CACHE_DEVICE] * 8: two batch rows by four node shards


def host_bits_equal(a: dict, b: dict, label: str) -> None:
    """Two matrices' host arrays equal field by field, bit for bit (NaN
    columns included), with the same types and shapes."""
    if sorted(a) != sorted(b):
        raise AssertionError(f"{label}: fields {sorted(a)} vs {sorted(b)}")
    for f in a:
        if (a[f].dtype != b[f].dtype or a[f].shape != b[f].shape
                or a[f].tobytes() != b[f].tobytes()):
            raise AssertionError(f"{label}: host field {f} differs")


def device_bits_equal(got, want, label: str) -> None:
    """Two ``DeviceArrays`` of tensors equal field by field, bit for bit."""
    from nomad_tpu_torch.state.matrix import DeviceArrays

    for f in DeviceArrays._fields:
        if not tensors_equal(getattr(got, f), getattr(want, f)):
            raise AssertionError(f"{label}: device field {f} differs")


def fused_operand_bytes(co, sharded: bool) -> int:
    """The bytes one fused dispatch of ``co`` uploads, from its shapes:
    the (max_lanes, ...) staging buffers and the packed requests; a
    sharded dispatch uploads the verify's request floats, delta rows and
    values and lane mask once more."""
    from nomad_tpu_torch.ops import kernels as k
    from nomad_tpu_torch.scheduler.coalescer import MAX_DELTA_ROWS

    lanes = co.max_lanes
    n = sum(a.nbytes for a in co._stage.values())
    n += lanes * 4 * (k.REQ_INT_WIDTH + k.REQ_FLOAT_WIDTH)
    if sharded:
        n += lanes * (4 * k.REQ_FLOAT_WIDTH + 4 * MAX_DELTA_ROWS
                      + 12 * MAX_DELTA_ROWS + 1)
    return n


class CounterWatch:
    """While open, records for each dispatch of the coalescer ``co`` the
    bytes its uploads must move (``fused_operand_bytes``), the bytes of
    its ticket's result copy, and, as each ticket resolves, the VERIFIED
    0.0 picks of the outcomes its lanes get back."""

    def __init__(self, co, sharded: bool):
        self.co, self.sharded = co, sharded
        self.dispatches = self.operand = self.result = self.conflicts = 0

    def __enter__(self):
        from nomad_tpu_torch.scheduler.coalescer import DeviceCoalescer

        dispatch, resolve = DeviceCoalescer._dispatch, DeviceCoalescer._resolve
        watch = self

        def watched_dispatch(co, batch):
            out = dispatch(co, batch)
            if co is watch.co:
                watch.dispatches += 1
                watch.result += out[0].numel() * out[0].element_size()
                watch.operand += fused_operand_bytes(co, watch.sharded)
            return out

        def watched_resolve(co, ticket):
            resolve(co, ticket)
            if co is watch.co:
                for p in ticket.entries:
                    fv = p.outcome.fit_verified if p.outcome else None
                    if fv is not None:
                        watch.conflicts += int((~fv).sum())

        self._patch = _Patched(
            (DeviceCoalescer, "_dispatch", watched_dispatch),
            (DeviceCoalescer, "_resolve", watched_resolve))
        self._patch.__enter__()
        return self

    def __exit__(self, *exc):
        return self._patch.__exit__(*exc)


COUNTERS = ("operand_bytes_total", "verify_conflicts", "feature_recompiles",
            "topk_host_bytes_total")
GAUGES = {"operand_bytes_total": "nomad.kernel.operand_bytes_total",
          "verify_conflicts": "nomad.kernel.verify_conflicts",
          "feature_recompiles": "nomad.kernel.feature_recompiles",
          "topk_host_bytes_total": "nomad.topk.host_bytes_total"}


def check_cache_launches(launches: dict, label: str, kernels) -> None:
    """Each of ``kernels`` launched on the path and no plain version (nor
    the staged kernel) ran."""
    if any(launches[name] <= 0 for name in kernels):
        raise AssertionError(f"{label}: a kernel never launched: {launches}")
    if launches["plain"] or launches["place_batch"]:
        raise AssertionError(f"{label}: a plain version or the staged "
                             f"kernel ran: {launches}")


def cache_burst(srv, label: str, sharded: bool, kernels) -> dict:
    """The 64-job count-2 burst on ``srv`` under a ``CounterWatch``: 128
    fitting allocs, the path's kernels launched, and each counter's
    growth equal to what the watch saw; the gauges equal the counters."""
    from nomad_tpu_torch.ops import kernels as k

    co = srv.coalescer
    before = {c: getattr(co, c) for c in COUNTERS}
    k.reset_counts()
    with CounterWatch(co, sharded) as watch:
        evals, elapsed = burst(srv, [service_job(i)
                                     for i in range(SERVER_JOBS)])
        quiet_s = wait_quiet(srv, label)
    launches = chaos_launches(k)
    check_cache_launches(launches, label, kernels)
    counts = check_burst(srv, evals, label)
    grew = {c: getattr(co, c) - before[c] for c in COUNTERS}
    want = {"operand_bytes_total": watch.operand,
            "topk_host_bytes_total": watch.result,
            "verify_conflicts": watch.conflicts}
    for c, v in want.items():
        if grew[c] != v:
            raise AssertionError(f"{label}: {c} grew {grew[c]}, the "
                                 f"dispatches show {v}")
    if not watch.dispatches or not grew["topk_host_bytes_total"]:
        raise AssertionError(f"{label}: no dispatch watched")
    if co.feature_recompiles < 1:
        raise AssertionError(f"{label}: the features never ratcheted")
    snap = srv.metrics.snapshot()
    for c, g in GAUGES.items():
        if snap.get(g) != getattr(co, c):
            raise AssertionError(f"{label}: gauge {g} = {snap.get(g)}, "
                                 f"counter {getattr(co, c)}")
    return {"evals_per_s": SERVER_JOBS / elapsed, "allocs": counts["allocs"],
            "burst_s": elapsed, "quiet_s": quiet_s,
            "retried": counts["retried"], "dispatches": watch.dispatches,
            "launches": launches, "grew": grew,
            "counters": {c: getattr(co, c) for c in COUNTERS}}


def nodes_in_row_order(srv) -> list:
    m = srv.matrix
    return [srv.store.node_by_id(m.node_of[r]) for r in sorted(m.node_of)]


def serve_loaded(path: str, nodes, devices, label: str, steps: dict):
    """A started server whose matrix is loaded from ``path`` before its
    nodes are registered onto the loaded rows (a registration rewrites a
    known node's row with the same values and keeps its usage)."""
    from nomad_tpu_torch.server.server import Server

    srv = Server(server_config(), device=devices)
    if not srv.matrix.load_encoded(path):
        srv.shutdown()
        raise AssertionError(f"{label}: load_encoded refused {path}")
    host0 = {f: a.copy() for f, a in srv.matrix.snapshot_host().items()}
    srv.start()
    t0 = time.perf_counter()
    for node in nodes:
        srv.register_node(copy.deepcopy(node))
    steps[f"{label} registrations"] = time.perf_counter() - t0
    host_bits_equal(srv.matrix.snapshot_host(), host0,
                    f"{label}: registrations onto the loaded rows")
    return srv


def cache_dense(card: str, tmp: str, out: dict):
    """16a and 16b on one device; returns the built server's nodes in
    row order and the encoded file's path."""
    from nomad_tpu_torch.server.server import Server
    from nomad_tpu_torch.state.matrix import NodeMatrix

    steps = out.setdefault("steps_s", {})
    built = Server(server_config(), device=CACHE_DEVICE)
    built.start()
    try:
        t0 = time.perf_counter()
        register_cluster(built, "16a cold build")
        out["cold_build_s"] = time.perf_counter() - t0
        nodes = nodes_in_row_order(built)
        path = os.path.join(tmp, "matrix.npz")
        t0 = time.perf_counter()
        built.matrix.save_encoded(path)
        out["save_s"] = time.perf_counter() - t0
        out["file_bytes"] = os.path.getsize(path)
        m = NodeMatrix(capacity=16, device=CACHE_DEVICE)
        t0 = time.perf_counter()
        if not m.load_encoded(path):
            raise AssertionError("16a: load_encoded refused its own file")
        out["load_s"] = time.perf_counter() - t0
        host_bits_equal(m.snapshot_host(), built.matrix.snapshot_host(),
                        "16a: loaded host arrays")
        if m.row_of != built.matrix.row_of:
            raise AssertionError("16a: loaded rows hold other nodes")
        full0, bytes0 = m.full_uploads, m.upload_bytes_total
        _sync()
        t0 = time.perf_counter()
        loaded = m.sync(CACHE_DEVICE)
        _sync()
        out["first_sync_ms"] = (time.perf_counter() - t0) * 1e3
        out["first_sync_bytes"] = m.upload_bytes_total - bytes0
        if m.full_uploads != full0 + 1 or m.scatter_syncs:
            raise AssertionError(f"16a: the first sync was not one full "
                                 f"upload ({m.full_uploads - full0} full, "
                                 f"{m.scatter_syncs} scatters)")
        if out["first_sync_bytes"] != sum(
                a.nbytes for a in m.snapshot_host().values()):
            raise AssertionError("16a: the first sync moved other bytes")
        device_bits_equal(loaded, built.matrix.run_on_device(
            lambda: built.matrix.sync(CACHE_DEVICE)), "16a: first sync")
    finally:
        t0 = time.perf_counter()
        built.shutdown()
        steps["16a built shutdown"] = time.perf_counter() - t0

    srv = serve_loaded(path, nodes, CACHE_DEVICE, "16a dense", steps)
    try:
        out["dense"] = cache_burst(srv, "16a dense burst", False,
                                   ("fused_place", "allocs_fit_verify"))
        if srv.matrix.full_uploads != 1:
            raise AssertionError(f"16a: {srv.matrix.full_uploads} full "
                                 f"uploads on the loaded server")
    finally:
        t0 = time.perf_counter()
        srv.shutdown()
        steps["16a dense shutdown"] = time.perf_counter() - t0
    return nodes, path


def cache_sharded(card: str, tmp: str, nodes, path: str, out: dict) -> None:
    """16a and 16b with ``shard_count`` 4 on four node shards of the
    card, and ``top``'s shard line."""
    from nomad_tpu_torch.obs.top import render
    from nomad_tpu_torch.parallel.sharding import shard_matrix_arrays
    from nomad_tpu_torch.state.matrix import (
        DEVICE_LOCK, DeviceArrays, NodeMatrix,
    )

    m = NodeMatrix(capacity=16, device=CACHE_DEVICE)
    if not m.load_encoded(path):
        raise AssertionError("16a x4: load_encoded refused the dense file")
    m.relayout_shards(4)
    path4 = os.path.join(tmp, "matrix4.npz")
    m.save_encoded(path4)
    counts = m.shard_row_counts()
    homes = {nid: m.home_shard(r) for nid, r in m.row_of.items()}
    steps = out.setdefault("steps_s", {})
    srv = serve_loaded(path4, nodes, [CACHE_DEVICE] * CACHE_MESH, "16a x4",
                       steps)
    try:
        if srv.matrix.shard_count != 4 or srv.matrix.full_uploads:
            raise AssertionError("16a x4: the loaded matrix lost its shards "
                                 "or synced before the first dispatch")
        out["x4"] = cache_burst(
            srv, "16a x4 burst", True,
            ("sharded_place", "allocs_fit_verify_window"))
        mx = srv.matrix
        if mx.shard_count != 4 or srv.coalescer._mesh.shape[1] != 4:
            raise AssertionError(f"16a x4: {mx.shard_count} shards, mesh "
                                 f"{srv.coalescer._mesh.shape}")
        moved = [nid for nid, s in homes.items()
                 if mx.home_shard(mx.row_of[nid]) != s]
        if moved or mx.shard_row_counts() != counts:
            raise AssertionError(f"16a x4: {len(moved)} nodes left their "
                                 f"home shard")
        with DEVICE_LOCK:
            resident = mx.sync_sharded(srv.coalescer._mesh)
            with mx._host_lock:
                host = DeviceArrays(**{
                    f: mx.snapshot_host()[f].copy()
                    for f in DeviceArrays._fields})
            fresh = shard_matrix_arrays(srv.coalescer._mesh, host)
        for i, row in enumerate(resident.shards):
            for j, sh in enumerate(row):
                device_bits_equal(sh, fresh.shards[i][j],
                                  f"16a x4 resident shard ({i}, {j})")
        if mx.full_uploads != 1:
            raise AssertionError(f"16a x4: {mx.full_uploads} full lay-outs")
        lines = [ln for ln in render(srv.metrics.snapshot(), None,
                                     None).splitlines()
                 if ln.startswith("shards")]
        got = int(lines[0].rsplit("topk host bytes", 1)[1]) if lines else 0
        if got <= 0 or got != srv.coalescer.topk_host_bytes_total:
            raise AssertionError(f"16b: top's shard line {lines} against "
                                 f"{srv.coalescer.topk_host_bytes_total}")
        out["top_shard_line"] = lines[0]
    finally:
        t0 = time.perf_counter()
        srv.shutdown()
        steps["16a x4 shutdown"] = time.perf_counter() - t0


def cache_sanitized(card: str, out: dict) -> None:
    """16c: 15a's seeded wedge at 10,000 nodes under TSan-lite."""
    from nomad_tpu_torch.chaos.scenarios import SCENARIOS
    from nomad_tpu_torch.lint import tsan
    from nomad_tpu_torch.ops import kernels as k

    kinds = []
    instrument = tsan.instrument

    def watched(kind, obj):
        kinds.append(kind)
        return instrument(kind, obj)

    tmp = tempfile.mkdtemp(prefix="nomad-smoke-tsan-")
    try:
        k.reset_counts()
        with _Patched((tsan, "instrument", watched)), tsan.sanitized():
            t0 = time.perf_counter()
            r = SCENARIOS["wedged_dispatch_recovers"](
                11, tmp, crowd=CHAOS_CROWD, device=CACHE_DEVICE,
                n_nodes=N_NODES)
            seconds = time.perf_counter() - t0
            races = tsan.reports()
        launches = chaos_launches(k)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check_chaos(r, launches, "16c")
    if not {"store", "matrix", "coalescer", "broker"} <= set(kinds):
        raise AssertionError(f"16c: instrumented only {sorted(set(kinds))}")
    if races:
        raise AssertionError("16c: race reports:\n" + "\n".join(
            f"{x['label']} {x['op']} in {x['thread']} held={x['held']}"
            for x in races))
    if not r["tripped"] or r["crowd_placed"] != CHAOS_CROWD:
        raise AssertionError(f"16c: the wedge drill did not trip and place "
                             f"its crowd: {r}")
    out["sanitized"] = {"seconds": seconds, "reports": 0,
                        "instrumented": sorted(set(kinds)),
                        "launches": launches}
    log(f"16c wedged_dispatch_recovers under TSan-lite ({N_NODES} nodes): "
        f"{seconds:.1f} s, 0 race reports, instrumented "
        f"{sorted(set(kinds))}, launches {launches} (card: {card})")


def phase_cache(card: str, results: dict) -> None:
    """Phase 16: the encoded-matrix cache, the counters and TSan-lite."""
    out = results.setdefault("cache", {})
    tmp = tempfile.mkdtemp(prefix="nomad-smoke-cache-")
    timed = {}
    try:
        t0 = time.perf_counter()
        nodes, path = cache_dense(card, tmp, out)
        timed["16a/b dense"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cache_sharded(card, tmp, nodes, path, out)
        timed["16a/b x4"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    d, x4 = out["dense"], out["x4"]
    log(f"16a cache ({N_NODES} nodes, capacity {CAPACITY}): cold build "
        f"{out['cold_build_s']:.3f} s, save {out['save_s']:.3f} s "
        f"({out['file_bytes']} bytes), load {out['load_s']:.3f} s, first "
        f"sync {out['first_sync_ms']:.3f} ms ({out['first_sync_bytes']} "
        f"bytes, one full upload, bit for bit); bursts over the loaded "
        f"matrix: dense {d['evals_per_s']:.1f} evals/s, x4 "
        f"{x4['evals_per_s']:.1f} evals/s, {d['allocs']} and "
        f"{x4['allocs']} allocs (card: {card})")
    for label, b in (("dense", d), ("x4", x4)):
        log(f"16b counters ({label}): grew {b['grew']} over "
            f"{b['dispatches']} dispatches, equal to the dispatches' "
            f"uploads, result copies and VERIFIED 0.0 picks; gauges equal "
            f"the counters {b['counters']}; launches {b['launches']} "
            f"(card: {card})")
    log(f"16b top: {out['top_shard_line']} (card: {card})")
    log(f"16a/b steps: " + ", ".join(
        f"{n} {t:.2f} s" for n, t in out["steps_s"].items())
        + f"; bursts {d['burst_s']:.2f} s + quiet {d['quiet_s']:.2f} s "
        f"dense, {x4['burst_s']:.2f} + {x4['quiet_s']:.2f} s x4, "
        f"retried {d['retried']} / {x4['retried']} (card: {card})")
    t0 = time.perf_counter()
    cache_sanitized(card, out)
    timed["16c"] = time.perf_counter() - t0
    out["seconds"] = timed
    log(f"cache: parts {', '.join(f'{n} {t:.1f} s' for n, t in timed.items())}"
        f" (card: {card})")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    try:
        import nomad_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e})",
              file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # The observatory's breach dumps go to a temporary directory, removed
    # at the end.
    traces = tempfile.mkdtemp(prefix="nomad-smoke-traces-")
    os.environ["NOMAD_TPU_TRACE_DIR"] = traces
    try:
        return run_phases()
    finally:
        shutil.rmtree(traces, ignore_errors=True)


def run_phases() -> int:
    """Every phase, then the kernel table and the result line."""
    import torch

    card = card_line()
    log(f"card: {card}")
    t_start = time.perf_counter()
    results: dict = {}
    seconds: dict = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        log(f"phase {name}: {seconds[name]:.1f} s")
        return out

    timed("build", phase_build, card)
    t0 = time.perf_counter()
    m = build_cluster(N_NODES, CAPACITY, "cuda")
    batches = make_batches(m, "cuda")
    log(f"cluster: {N_NODES} nodes (capacity {CAPACITY}), batches of "
        f"{LANES} lanes x {SCAN} placements in "
        f"{time.perf_counter() - t0:.2f} s; features "
        f"{tuple(batches[0].features)} / {tuple(batches[1].features)}")
    timed("kernels", phase_kernels, batches, results)
    timed("solo", phase_solo, batches[1], results)
    timed("place_batch", phase_place_batch, batches, card, results)
    timed("edge shapes", phase_edge_shapes, results)
    timed("system kernel", phase_system_kernel, m, results)
    recorder = HostVerifyRecorder()
    try:
        timed("server", phase_server, card, results, recorder)
    finally:
        recorder.close()
    timed("staged server", phase_staged_server, card, results)
    timed("timing", phase_timing, batches[0], card, results)
    timed("system timing", phase_system_timing, m, card, results)
    # A fresh bench-shaped cluster: phase 2 left three rows nearly full.
    timed("batched scoring", phase_batched_scoring,
          build_cluster(N_NODES, CAPACITY, "cuda"), card, results)
    timed("plan verify", phase_plan_verify, card, m, recorder, results)
    timed("restart", phase_restart, card, results)
    timed("guarded", phase_guarded, card, results)
    timed("agents", phase_agents, card, results)
    timed("front door", phase_front_door, card, results)
    timed("replicated", phase_replicated, card, results)
    timed("sharded", phase_sharded, card, results)
    timed("chaos", phase_chaos, card, results)
    timed("cache", phase_cache, card, results)
    fused, staged = results["server"], results["staged_server"]
    log(f"bursts: fused {fused['evals_per_s']:.1f} evals/s, "
        f"{fused['refused']} refusals, {fused['retried']} retried; staged "
        f"{staged['evals_per_s']:.1f} evals/s, {staged['refused']} "
        f"refusals, {staged['retried']} retried (card: {card})")
    restart = results["restart"]
    log(f"restart: WAL burst {restart['wal_burst_evals_per_s']:.1f} evals/s "
        f"(the same cluster's burst without it "
        f"{restart['burst_evals_per_s']:.1f}); "
        f"restore {restart['restore_wal_s']:.3f} s from the log, "
        f"{restart['restore_snapshot_s']:.3f} s from the snapshot; "
        f"install {restart['install_s']:.3f} s; first sync "
        f"{restart['full_upload_bytes']} bytes in "
        f"{restart['full_upload_ms']:.3f} ms (card: {card})")
    agents = results["agents"]
    log(f"agents: burst submit -> all placed {agents['placed_s']:.3f} s "
        f"({agents['evals_per_s']:.1f} evals/s), -> all running "
        f"{agents['running_s']:.3f} s, commit -> running p50 "
        f"{agents['commit_to_running_p50_ms']:.1f} ms / p99 "
        f"{agents['commit_to_running_p99_ms']:.1f} ms; reattach "
        f"{agents['reattach_s']:.3f} s; deployment {agents['deploy_s']:.3f} s "
        f"(card: {card})")
    front = results["front_door"]
    log(f"front door: {N_NODES} nodes over the wire in "
        f"{front['register_s']:.3f} s; HTTP burst {front['evals_per_s']:.1f} "
        f"evals/s (in-process server phase {fused['evals_per_s']:.1f}); "
        f"agents' echo job submit -> running {front['echo_running_s']:.3f} s; "
        f"migration {front['migration_s']:.3f} s, drain "
        f"{front['drain_s']:.3f} s; phase {front['phase_s']:.1f} s "
        f"(card: {card})")
    repl = results["replicated"]
    log(f"replicated: snapshot installs "
        f"{', '.join(f'{s:.3f}' for s in repl['install_s'])} s; the new "
        f"leader's first sync {repl['first_sync_ms']:.3f} ms "
        f"({repl['first_sync_bytes']} bytes); shutdown -> election "
        f"{repl['election_s']:.3f} s, -> first placement "
        f"{repl['first_placement_s']:.3f} s; burst {repl['evals_per_s']:.1f} "
        f"evals/s across the failover, a write's quorum "
        f"{repl['write_quorum_ms']:.3f} ms (fused server phase "
        f"{fused['evals_per_s']:.1f}, HTTP {front['evals_per_s']:.1f}); "
        f"processes: SIGKILL -> election {repl['proc_election_s']:.3f} s, "
        f"burst {repl['proc_evals_per_s']:.1f} evals/s; phase "
        f"{repl['phase_s']:.1f} s (card: {card})")

    sources = {
        "fused_place": ("nomad_tpu_torch/ops/csrc/fused_place.cu",
                        "nomad_tpu/ops/kernels.py:968"),
        "place_batch": ("nomad_tpu_torch/ops/csrc/fused_place.cu",
                        "nomad_tpu/ops/kernels.py:817"),
        "allocs_fit_verify": ("nomad_tpu_torch/ops/csrc/allocs_fit_verify.cu",
                              "nomad_tpu/ops/kernels.py:1026"),
        "system_feasible": ("nomad_tpu_torch/ops/csrc/system_feasible.cu",
                            "nomad_tpu/ops/kernels.py:289"),
        "score_batch": ("nomad_tpu_torch/ops/csrc/score_batch.cu",
                        "nomad_tpu/ops/kernels.py:627"),
        "verify_plan_fit": ("nomad_tpu_torch/ops/csrc/verify_plan_fit.cu",
                            "nomad_tpu/ops/kernels.py:1077"),
        "sharded_place": ("nomad_tpu_torch/ops/csrc/sharded_place.cu",
                          "nomad_tpu/parallel/sharding.py:334"),
        "allocs_fit_verify_window": (
            "nomad_tpu_torch/ops/csrc/allocs_fit_verify.cu",
            "nomad_tpu/parallel/sharding.py:590"),
        "sharded_usage": ("nomad_tpu_torch/ops/csrc/sharded_place.cu",
                          "nomad_tpu/parallel/sharding.py:284"),
    }
    table = []
    for name, (src, replaces) in sources.items():
        r = results.get(name, {})
        table.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": r.get("launches"),
            "max_abs_err": r.get("max_abs_err"), "ms": r.get("ms"),
            "plain_ms": r.get("plain_ms"), "bound_ms": r.get("bound_ms"),
            "bound_by": r.get("bound_by"), "library_ms": r.get("library_ms"),
            "solo_run": r.get("solo_run"), "device_us": r.get("device_us"),
            "launch": r.get("launch"), "host_us": r.get("host_us"),
            "host_split_us": r.get("host_split_us"),
            "library_device_us": r.get("library_device_us"),
            "b4096": r.get("b4096"),
            "spread": r.get("spread"),
            "cases": r.get("cases"),
            "matches_plain": r.get("matches_plain", False),
        })
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
