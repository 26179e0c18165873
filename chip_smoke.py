#!/usr/bin/env python3
"""Smoke run of kubernetes_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. device  — the card's name and power limit, the CUDA and torch versions;
  2. build   — compiles csrc/taint_ports.cu and csrc/preempt_whatif.cu
               for sm_90a from this checkout, one nvcc each, together;
  3. kernel  — the taint/host-port kernel against its plain PyTorch version
               on seeded worlds at the main path's shapes and at the
               kernel's edges (taint_ports.EDGE_TABLES; exact equality),
               then timed on a dense world, on a world with no toleration
               and no port (its store path alone), and beside a plain
               fill of the same two outputs (the card's write rate); the
               what-if kernels against their plain version run on a CPU
               copy of the same inputs (preempt.EDGE_WORLDS and two worlds
               at the drains' widths; exact equality — the plain version
               on the card sums by atomics in no fixed order), and timed
               on the dense edge world (see phase 9);
  4. density — the main path at full size: Scheduler(store,
               device="cuda").schedule_pending() over 5 000 nodes and a
               16 640-pod backlog (cut from 30 000 for the script's
               time); the store's bindings must respect every
               resource, taint, host-port and nodeSelector constraint, and
               the kernel must have launched during the run, on the live
               waves' rows only (printed per round). The host time
               of each phase of the rounds is printed; then the kernel is
               held against its plain version on a copy of the inputs the
               rounds gave it (one of each row count; exact equality), as
               it is after phases 6 and 7, and timed with its plain
               version by CUDA events on the first round's, beside the
               kernel's bound;
  5. parity  — reduced worlds of the density, mixed and spread shapes
               (500 nodes, 1 000 pods, same seed) scheduled on the card and
               on the CPU: identical bindings; then bench.py's preempt
               shape (50 nodes, 100 hogs, 100 vips) and its gangstorm
               shape (100 nodes, 48 gangs of 8, 32 high pods) on a virtual
               clock: identical bindings and victim sets; then the
               multi-key world: the reduced density world with anchor pods
               bound first, drained, then 1 pod and a gang of 2 whose
               required pod affinity spans the zone and the host key (the
               exact host path, plugins/golden.py): identical bindings,
               every multi-key pod bound where both terms hold (read back
               from the store), the host-path passes and their seconds
               printed; then the volumes world (500 nodes, 1 000 pods on
               bound zoned claims, on their own WaitForFirstConsumer
               claims against too few free PVs in two of three zones, on
               shared inline disks, aimed past the 16-PD limit, and one
               on a claim with no PV; VolumeScheduling on) with the
               equivalence cache off and then on: identical bindings,
               claim bindings and PodScheduled messages on card and CPU,
               and the cache changes none; then the policy world (500
               nodes, 1 000 pods under a Policy with a labelsPresence
               filter, labelPreference and ResourceLimitsPriority host
               scores and LeastRequestedPriority at 0, every wave
               per-wave with host scores): identical bindings;
  6. mixed   — bench.py's mixed5k shape at full width: 5 000 nodes with
               node-affinity labels, 30 000 pods in four quarters (density,
               required node affinity, service spreading, required hostname
               anti-affinity in 50 groups). Every placement invariant
               holds (resources, node affinity, no two pods of one
               anti-group on a node), every round runs at most 64 waves
               and launches the kernel on its live rows only, and at least
               one round runs with inter-pod affinity. Printed: pods/s,
               host seconds by phase, each round's has_ipa, waves and
               device_round seconds, ms per pod with and without ipa, the
               implicit host syncs of one ipa round (that round is left
               out of the per-pod and per-wave times), and
               incoming_statics timed on one full-width wave;
  7. spread  — 5 000 nodes and 2 500 pods (cut from 10 000, then
               from 5 000, for the script's time limit) of 20
               Deployments, each pod
               with a hard zone spread (maxSkew 1) and a soft hostname
               spread: every Deployment's zone counts differ by at most 1,
               every round runs with topology spread; the same timing
               lines, and topo_statics timed on one full-width wave;
  8. gang    — bench.py's gangstorm shape at 5 000 nodes, P = 16: 1 200
               gangs of 8 members (8 cores, priority 1, min-available 8)
               fill 96% of the CPU, one dispatch a gang; then 1 600
               single 4-core pods at priority 1000 get in by preemption.
               Every high pod bound, every gang with 0 or 8 members
               bound, every victim at priority 1, evictions a multiple of
               8, every resource respected. Printed: pods/s of the fill
               and of the high pods, gang dispatches, evictions, host
               seconds by phase, each kernel's launches; the what-if
               timed on the drain's chunk (P = 16) as in phase 9;
  9. preempt — bench.py's preempt shape at 5 000 nodes, P = 128: 10 000
               priority-1 hogs of 8 cores (two a node), then 384
               priority-100 vips of 8 cores, each placing only by
               evicting a hog. 384 placed, 384 evicted, every
               preemption done by the pipeline. Printed: vip pods/s,
               what-if chunks and launches, host validation seconds; on
               the largest chunk, the what-if by CUDA events as a whole
               call and as its two main kernels alone (on a prebuilt row
               list and slot table) beside its bound, the host syncs of
               one call, and the plain version's ms on the CPU.
  10. trickle — bench.py trickle at 5 000 nodes (DRIVER_SUITE runs 500):
               caps as bench.py _warmed_scheduler, 64 warm pods through
               warm_pipeline and deleted, a fresh Metrics, then 512
               pods (cut from 2 048 for the script's time) in chunks of
               64 with schedule_pending() after each.
               Printed: pods/s, the p99 of pod_scheduling_latency and of
               e2e_scheduling_latency, rounds, launches, and the implicit
               host syncs of one more chunk's round;
  11. paced  — bench.py paced at 5 000 nodes, 500 pods (cut from 4 000
               and then from 2 000 for the script's time limit) offered
               at 200 pods/s in chunks of 100 on the wall clock,
               then bench.py's stalled-drain loop (a stall fails the
               phase). Printed: the p99 of pod_scheduling_latency against
               the 5 s SLO and the offered rate achieved;
  12. preempt_host — bench.py run_preempt_config at its own size (50
               nodes, 100 hogs of 8 cores at priority 1, 100 vips at
               priority 100, wave 16) with device_preemption = False, on a
               virtual clock: every vip placed, 100 evictions, all hogs, no
               what-if launch; the same run with device="cpu" gives the
               same bindings and victims.
  13. statefulset — 5 000 nodes, 512 density pods, then 8 StatefulSets
               of 64 pods, each pod with its own claim: even replicas on
               a claim pre-bound to a zoned GCE PD PV, odd ones on an
               unbound WaitForFirstConsumer claim of 5-10 Gi against 320
               free PVs of 10, 20 and 50 Gi in three zones;
               VolumeScheduling on, the equivalence cache off. The host
               mask of 8 of the pods projects the phase; past 30 s the
               StatefulSet pods are halved (to 64). Every pod placed
               (check_bindings), every pod in its PV's zone, every claim
               bound to its own PV, no node over 16 GCE PDs, the kernel
               == plain on the per-wave dispatches' inputs. Printed:
               pods/s, pipeline passes and bail-outs, per-wave
               dispatches, host seconds by phase (host_mask,
               volume_bind, ...), taint/port launches, the implicit host
               syncs of one volume and one density wave, claims bound.
  14. traced — the flight recorder and the decision observatory: the
               density world at 5 000 nodes with a 2 048-pod backlog (16
               waves, one round; cut from 4 096 for the script's time)
               drained on two fresh schedulers from one
               seed, untraced and traced (utils/tracing.py enable() with
               a ledger file, a `live` WeightProfile equal to the default
               weights, a bin-packing and a spreading candidate,
               shadow_exact_interval=1): identical bindings; then the
               bin-packer promoted to live and 128 more pods, then the
               rollback (both live profiles deleted: the static table) and
               128 more. Checks: every decision's chosen parts re-add by
               `_f32_totals` to its total, every top list in lax.top_k
               order, every ledger line v2 with weights_version (same@ ->
               packer@ -> static), scores, an exact shadow sample and
               telemetry; the packed telemetry vector from the card equal
               bit for bit to the CPU's on a copy, 5 000 nodes, the zone
               sums tying out; no telemetry failure; the taint/port kernel
               == plain on the inputs. Printed: device_round ms a pod
               traced and untraced, the host syncs of one traced and one
               untraced wave, the host seconds a round of
               _record_decisions, _shadow_exact_sample and
               _emit_telemetry, the telemetry call's ms against its byte
               bound, the ledger's bytes a round. Then a reduced traced
               world (500 nodes, 1 000 pods, a gang, a preempting pod, a
               pod the host filter sends to the per-wave loop, a
               candidate) on the card and on the CPU: identical ledger
               rows (less timings, path and pod UIDs), decisions, shadow
               report, telemetry vector and scheduler metrics.
  15. autoscale — the cluster autoscaler (controllers/clusterautoscaler.py)
               on the scheduler's card: 5 000 nodes (no instance-type
               label) each with four bound replicated pods of 3.5 cores,
               a FakeCloud with std-16, std-32 and a tainted himem-64
               group, and 32 pending pods of 20 cores, half tolerating
               himem's taint; preemption off, as bench.py
               run_autoscale_config runs it. Scale-up passes (run_once, the virtual
               clock past the cooldown, a drain) until nothing is
               pending; then each himem node keeps one pod and 2
               scale-down passes run, the drained residents re-created
               and drained after each. Every pod bound, none without the
               toleration on himem, a node removed after a refit
               what-if, no pod pending or on a removed node, no
               autoscaler error, the taint/port kernel launched in every
               pass that ran a what-if. Printed: each pass's direction,
               P, N, shadow build, featurize and what-if seconds, and
               its pick or removal; the phase's launches; the implicit
               host syncs of one scale-up what-if. Then card == CPU on
               500 nodes and 32 pods: every verdict (chosen, feasible),
               the groups picked and their sizes, the nodes removed,
               the events and the bindings.
  16. zone_outage — the node-lifecycle controller (controllers/
               nodelifecycle.py, its zone tally on the card) on the
               scheduler's store: 5 000 nodes with heartbeats, four pods
               each with the 300 s default tolerations; zone A stops
               every heartbeat, 60% of zone B and 20 nodes of zone C
               stop; monitor passes at 0, 41, 342 and 442 s (past
               the 40 s grace, then the 300 s tolerations).
               Zone A FullDisruption with no eviction, B
               PartialDisruption, C Normal, the unreachable taint on
               exactly the stopped nodes, each zone's evictions equal to
               its token bucket's allowance; 256 density pods placed,
               none on a tainted node; after the heartbeats resume every
               zone Normal and no taint left; the card's tally equal to
               np.bincount on every pass, no tally off the device.
               Printed: host seconds a monitor pass by step, the tally's
               ms a call at N = 8 192 against its byte bound. Then card
               == CPU on 500 nodes: zone states, taint sets, evicted
               pods and bindings.
  17. faults — the device-fault ladder (sched/scheduler.py, ops/
               hostwave.py, utils/watchdog.py, utils/faultpoints.py) at
               5 000 nodes: (a) the numpy twin's wave against the card's
               on seeded density, mixed (inter-pod affinity) and spread
               worlds, one wave of 128 pods at N = 8 192, and its gang
               against the card's on 16 members (need met and not):
               every plane equal; the ms of a wave on each; (b) the
               density world of 2 048 pods with kernel.round raising
               once and kernel.wave twice: the round hands the backlog
               to the per-wave path, the breaker OPEN, the backlog
               drained through the twin a wave at a time (pods/s
               printed, wave_path 'host'); past the cooldown on a
               virtual clock 512 more pods: the half-open probe on the
               card closes the breaker and the kernel launches; the
               bindings equal a fault-free run of the same world
               through the per-wave path on the card (a round checks
               host ports against its start state, so a round and the
               per-wave path may place a port pod apart); (c) the
               watchdog armed at three times a measured healthy round
               dispatch and a kernel.hang of two deadlines:
               DispatchTimeout, the breaker OPEN at once, the round
               salvaged through the twin a wave at a time, equal to a
               healthy per-wave run, the wedge drained, the probe
               closing the breaker; (d) 2 048 pods with 4 NaN-spec pods
               and one wave.poison crash-kind pod: 2 043 placed, 5
               quarantined, the breaker CLOSED, no trip, the innocents
               equal to a clean run without the five but for pods
               asking a host port (the bisection's smaller rounds check
               ports against other start states), which pass
               check_bindings; (e) phase 15's world at 500
               nodes with the breaker forced OPEN: the autoscaler's
               what-if on backend="host" (no kernel launch) equal to the
               device branch's (chosen, feasible; refit too). (b) and
               (d) halve their pods (to no fewer than 256) when they
               project past 15 s.
  18. memory — the memory plane and load shedding (state/scrubber.py,
               Snapshot._compact, the capacity-fault ladder, the queue's
               shed area) at 5 000 nodes, waves of 128: (a) device.oom
               once in the density world's first round (256 pods):
               strike 1 compacts and retries, capacity_faults 1, the
               breaker CLOSED, no conviction, the bindings equal a
               fault-free run's; three times in a row (256 pods): strikes
               2 and 3 halve the wave cap, strike 3 salvages the round
               through the twin, the bindings equal a per-wave drain on
               the card;
               once at the first what-if chunk of the preempt world (5 000
               nodes full of bound hogs, 256 vips): the chunk salvaged on
               the twin, the drain complete; (b) 30 000 bound density
               pods, 4 cycles (cut from 12 for the script's time limit)
               of 32 Jobs x 8 pods (their own
               controller-uid and job-name values) bound and deleted, the
               compaction cadence crossed every 3 cycles on the virtual
               clock: per cycle the vocabulary sizes, caps, projected
               bytes, torch.cuda.memory_allocated() (before and after each
               compaction, which must free device memory), the compaction
               seconds and the upload bytes; the label-value vocabulary
               the same after every compaction, the first upload after
               each a full one and the next a row delta; a 500-node copy
               (1 500 bound pods, 2 pods a Job) with compaction on and off
               on the card and on the CPU: the same bindings in all four;
               (c) a budget just above the settled footprint and a wave of
               128 pods with 16 new label keys: the grow demands a
               compaction, housekeeping runs it (trigger governor), the
               headroom printed, the breaker untouched; (d) snapshot.write
               (corrupt) on 8 node rows, one scrub at 5 000 nodes and
               30 000 bound pods (seconds printed) reports exactly those
               rows and repairs them, the next upload is row deltas; on
               500 nodes the drain after the repair equals a clean
               run's; (e) tests/test_storm.py's burst at 5 000 nodes: 1 280
               priority-0 pods in bursts of 640 a tick with a pod at
               HIGH_PRIORITY_BAND after every 20, one wave a tick until
               nothing is pending, with shed_watermark 1 024 (shed_age_s 60 on the
               virtual clock) and with shedding off: every high pod bound
               before any shed pod, the shed area drained oldest first,
               every pod bound, no high pod shed; the p99 latency of each
               class on the virtual clock printed for both.
  19. store_outage — the store plane (sched/reconciler.py,
               sched/storehealth.py, state/journal.py, the scheduler's
               bind spool) on the density world at 5 000 nodes, on a
               virtual clock, the store breaker's cooldown 2 s and its
               jitter pinned: a fault-free run drains 512 density pods
               (cut from 1 024 for the script's time), then 512 more;
               (a) the same with store.outage armed
               (raise, unbounded) for the second batch: every bind
               spools and is journaled (fsync a record) in a temporary
               directory; disarmed, past the probe deadline one run_once
               drains the spool; the bindings equal the fault-free run's,
               no pod bound twice, store.outage hit 3 + 1 times (the
               first bind's POSTs and truth GET, then none while
               DISCONNECTED); printed: pods/s of both batches against the
               fault-free run's, host seconds spooling (journal append
               with fsync, and the rest), journal bytes, the drain's
               seconds, the breaker's state at each step; (b) the same
               outage with the journal capped at 32 768 B (one rotation),
               the process abandoned with its spool (watches dropped, no
               close, no drain); a fresh Scheduler over the same store
               and journal, the store still dark, replays every intent
               (re-spooled under its seq; the replay's seconds printed);
               healed and drained: bindings equal the fault-free run's,
               every pod bound once, nothing assumed or unresolved; (c)
               enter_dormant after the first batch: run_once and
               schedule_pending place 0; recover_leadership (a full
               scrubber.rebuild at 5 000 nodes, timed), then the second
               batch's bindings equal the fault-free run's; (d)
               spool_watermark 256 with shed_watermark 1 024: 256 pods
               spool, 128 low arrivals are held in the shed area, 8
               pods at HIGH_PRIORITY_BAND still schedule and spool;
               healed, everything binds.
  20. extender — HTTP extenders (sched/extender.py) through a Policy
               that lists one, served in this process by a stdlib
               ThreadingHTTPServer on 127.0.0.1 that bans a seventh of
               the nodes by name, gives 10 at weight 2 to zone-1's nodes,
               records each bind and drops the first candidate node of
               each preemption: (a) the density world at 5 000 nodes, 128
               pods (cut from 512, then 256, for the script's time) in
               waves of 128 with nodeCacheCapable false (the
               labels of every node in each filter POST): no pod on a
               banned node, the extender's binds == the store's bindings,
               one a pod, the taint/port kernel launched, no breaker
               trip; printed: pods/s, the POSTs per verb, the bytes of one
               filter request and the share of the drain in extender
               calls (the pods halved when the first wave projects the
               phase past 90 s); (b) the same backlog at 500 nodes:
               card == CPU bindings and request logs byte for byte; (c)
               500 nodes full of priority-1 hogs and 4 priority-100
               vips (not 64: with an extender the POSTs grow with the
               square of the vips, and extender_vips.py times this world
               at 16, 32 and 64 vips): card == CPU, no victim from a
               node the extender dropped; (d) 128 pods
               with the extender on a closed port: required, every pod
               parked and scheduling_errors{stage="extender"} 1;
               ignorable, the bindings of the same per-wave drain with
               no extender.
  21. deployed — the deployed kube-scheduler (cli/kube_scheduler.py:
               its config, build_scheduler, the scheduling loop, the
               HealthServer, leader election, the REST client, the
               reflectors and RemoteStore, the bind pool) on the card
               against the port's own APIServer (server/apiserver.py) on
               127.0.0.1 in this process, the nodes written into the
               server's store first: (a) 512 density pods (no host
               port, see deploy_world) created over REST at 5 000 nodes,
               one main([--server, --config cfg.json, --once,
               --tracing]): every pod bound once over REST (read back and
               held to check_bindings), one taint/port launch at least a
               per-wave dispatch, the kernel == plain on their inputs, no
               breaker trip; printed: pods/s from the first POST to the
               last bind, host seconds (the reflectors' LIST, the build,
               featurize, upload, the waves, commit, the pool's binds),
               REST requests by verb, the reflector's events, the binds in
               flight at most, the implicit host syncs of the first wave;
               (b) just before its HealthServer stops, every endpoint:
               /healthz, /metrics (pods_scheduled_total == the drain,
               reflector_relists_total == its reflectors), /debug/trace
               (Chrome JSON, text, ledger: one row a wave, path cuda),
               /debug/score (index, one pod's decision naming its
               binding, text), /debug/shadow, /debug/store (connected, no
               error, empty spool), /debug/profile, /debug/autopilot
               (404); (c) two run(--leader-elect) schedulers, leases of
               1.5 s, 512 pods: the leader's elector stopped halfway,
               the standby (held off the lease until the old leader's
               binds settled, ROADMAP queue 3) takes the lease and
               drains on (seconds to its first bind), then its renewals
               fail until it is dormant and it takes its lease back
               (recover_leadership's seconds); every pod bound once; (d)
               500 nodes, 256 pods,
               main(--once) on the card and on the CPU: the same bindings
               and the same /metrics less the wall-clock readings.
  22. autopilot — the scheduler autopilot (autopilot/: the ledger
               dataset, the ridge trainer, the replay CI, the promotion
               controller) and the cluster-invariant checker
               (chaos/invariants.py): (a) RidgeTrainer fitted on phase
               14's round ledger (5 000 nodes), its table emitted as a
               candidate into a traced scheduler on the density world
               (5 000 nodes, waves of 128), a shadow window of 2 rounds
               of 128 pods, step(): the shadow gate, then two replays on
               the card at 5 000 nodes and waves of 128 (production and
               candidate), the promotion and a watch of 2 rounds to
               `completed`, with no new shape bucket of the round across
               step, promotion and watch, and /debug/autopilot 200 ==
               status() through a HealthServer; then a candidate forced
               past the gates on the skewed 3-node world (on the density
               world every margin ties at 0), rolled back in memory by
               the watch and reconciled in the store by a later step();
               the ledger's transition trail and the promotion counts
               checked; printed: the table, the shadow flip rate and
               margin delta, each replay's seconds, placed and
               objective, the step's syncs, start to promoted, breach to
               restored; (b) phase 14's untraced density drain (5 000
               nodes, 2 048 pods, the same seed) on
               Scheduler(invariants=True): the same bindings, no
               violation; the checks' count and seconds, pods/s beside
               the unchecked drain, the syncs of a checked and an
               unchecked wave (checked no more); then on the drained
               scheduler a pending pod dropped from the queue
               (conservation at the second check) and one host row of
               the usage plane corrupted (snapshot_usage at once); (c)
               at 500 nodes on the card and on the CPU: a miniature of
               phase 14's traced drain (the recorder on a virtual clock)
               as the ledger, the trainer, the pipeline with replays at
               500 nodes, the forced regression and a checked drain:
               the same table bit for bit, transition trail, replays'
               deterministic fields and bindings.
  23. chaos  — the chaos campaign (chaos/campaign.py) and the kubemark
               hollow cluster (kubemark/, with kubelet/, proxy/ and
               volume/): (a) run_campaign(seed=7) over 4 schedules (bench.py
               run_chaoscampaign_config samples 50; cut for the script's
               time) on the card and on the CPU: no finding, faults
               injected, each schedule's env string, violation,
               placements, checks and hits equal, the seconds of each
               replay printed; (b) the broken builds, the gang rollback off
               with snapshot.write=corrupt x 4 and the journal replay off
               with store.outage=raise x 6 at seed 7: caught (conservation
               or gang_atomic; conservation, "outlived the outage"),
               shrunk to snapshot.write=corrupt::1 and
               store.outage=raise::4, re-triggered from the env string;
               the healthy build tolerates both; card == CPU replay by
               replay; (c) a HollowCluster of 5 000 nodes (3 zones, 8
               racks, 3 generations) on a virtual clock, every kubelet
               registered, a strict checker on the scheduler (waves of
               128, caps pre-sized), 4 ticks of the campaign's loop (the
               clock 1 s on, the 500 nodes whose index is the tick mod 10
               heartbeat, 128 pods of the campaign's mix, two run_once),
               a gang of 8 x 4 000m at tick 2 and one of 3 x 20 000m that
               no node holds at tick 3, kernel.hang=latency:0.02:2,
               heartbeat.deliver=drop::3, watch.deliver=latency:0.005:3
               and bind.post=raise::2 armed at tick 2, then ticks until
               only the big gang is pending: no violation, every armed
               point hit, check_bindings, the small gang whole, no breaker
               or store trip; printed: the seconds to build and register
               the nodes, a tick's heartbeats and the next upload's bytes,
               pods/s from the first arrival to the last bind, the checks
               (count, mean and max ms), per-wave dispatches and
               launches, the syncs of one checked wave; the same loop at
               500 nodes with 4 ticks of arrivals on the card and on the
               CPU: the same bindings, hits and checks. The kubelets are
               registered and heartbeat; none runs sync_once (its pod
               scan walks every pod for each node).
  24. kubeadm — kubeadm on the in-memory store (cli/kubeadm.py, its
               controller roster and the server's reconciler,
               service-account tokens and bootstrap tokens): (a)
               main(["init", "--once", "--secure"]) on the card, the
               torch preflight, seconds from the Cluster to ready; (b) a
               secure Cluster on the card, 4 998 hollow nodes in 3 zones
               (registered; a heartbeat thread beats each every 80 s
               when the process keeps up, the monitor grace 120 s;
               none runs) and 2 nodes joined over CSR and mTLS
               (join_with_csr, a HollowNode on a RemoteStore), a
               Deployment of 1 024 pods of 100m and 64Mi POSTed with the
               admin token, made by the deployment and ReplicaSet
               controllers and placed by the Cluster's scheduler thread
               over REST binds, upgrade_cluster to v1.12-tpu.0 live, then
               1 536 replicas: every pod bound within its node
               (check_bindings), the kernel launched and held to its plain
               version on the inputs it was given, the objects of before
               the upgrade served by the new API server, no store trip,
               the zone tally on the card; printed: seconds to ready and
               to settle, each join, pods/s from the POST and from the
               scale to the last bind, the restart and the seconds until
               the scheduler's streams are back, per-wave dispatches and
               launches; (c) the same at 500 nodes, 256 then 384 pods,
               driven in the script's thread (sync_all, then run_once
               once the scheduler's mirror holds what the store holds),
               on the card and on the CPU: the node of every pod, in
               creation order, equal.
After each of phases 4-16 every Scheduler the phase built is checked:
breaker CLOSED, no trip, no device failure (so no twin wave), no
watchdog abandonment, no quarantined pod, no capacity fault, compaction
or strike (a healthy phase that leaned on a ladder fails), no store
trip and no spooled bind; phase 17's schedulers are held to no capacity
fault and phases 17-18's to no store trip and no spooled bind; phase
19's to the device checks of phases 4-16, phases 20's, 21's and 22's
(the replays' too), phase 23's hollow clusters and phase 24's clusters
to both (phase 23's campaign replays arm faults on purpose and are held
by the campaign's own checker).
Phases 8, 9, 12 and 13 run with PodBackoff(initial=0.001), as bench.py
run_preempt_config does. In each, one what-if input of each pod-row
count is captured and the kernel held equal to the plain version on a
CPU copy of it. Each drain sets both kernels' launch counts to 0 before
it and reads them after. Then it prints the kernel table as one JSON
line (launches of every drain), the card's name and power limit, and
last {"ok": true, "device": {...}}.

It needs the kubernetes_tpu_torch package beside it, and a CUDA card.
"""

from __future__ import annotations

import contextlib
import copy
import gc
import io
import json
import logging
import re
import statistics
import subprocess
import sys
import threading
import time
import warnings
from pathlib import Path

REPO = Path(__file__).resolve().parent
SEED = 20261017
FULL_NODES, FULL_PODS = 5000, 30000
# phase 4's backlog: the first round keeps its 16 384 pods (128 waves of
# 128, the kernel's timed shape), the second is cut (from 30 000 pods in
# all) to make room for phase 22 (20 000), then to 1 024 pods for phase
# 23, then to 256 for phase 24
DENSITY_PODS = 16640
# phases 7, 9, 11, 13 and 18 (b) run at half their earlier depth (the
# same shapes, fewer pods, vips or cycles): the whole script with them
# at full depth took 1 441.8 s on an H100, past the 1 200 s limit
# (PERF.md section 4)
SPREAD_PODS, SPREAD_APPS = 2500, 20
SMALL_NODES, SMALL_PODS = 500, 1000
# phase 8 (bench.py gangstorm, scaled to 5 000 nodes): gangs of 8 pods at
# priority 1 fill 96% of the nodes' CPU, then 4-core high pods. Cut for
# the script's time: 1 200 gangs of 8-core members (2 slots a node), not
# 2 400 of 4-core members, so the fill keeps its 96% and the high pods
# still break gangs with half the gang dispatches
GANGS, GANG_SIZE, GANG_HIGH, GANG_CPU = 1200, 8, 1600, 8
GANG_P = 16
# phase 9 (bench.py preempt at 5 000 nodes): two 8-core hogs a node, then
# 384 8-core vips (cut for the script's time from 10 000, one a hog, to
# 2 500, then to 1 250, then to 384 for phase 23: three what-if chunks)
PREEMPT_VIPS = 384
# phase 5's reduced preempt and gangstorm worlds (bench.py's own sizes)
SMALL_PREEMPT_NODES, SMALL_VIPS = 50, 100
SMALL_GANG_NODES, SMALL_GANGS, SMALL_HIGH = 100, 48, 32
# phase 5's multi-key pods: single pods and one gang, each pod with
# required pod affinity over the zone and the host (2 single pods and a
# gang of 2, cut from 16, then 8, then 4 single pods and a gang of 4, then
# to 1 single pod for phase 23, for the script's time: each host-path
# pass scans every bound pod for every node)
MULTIKEY_PODS, MULTIKEY_GANG = 1, 2
# phases 10 and 11 (bench.py trickle and paced; DRIVER_SUITE runs
# trickle at 500 nodes, paced at 5 000); trickle cut from 2 048 pods (32
# chunks) to 1 024 to make room for phase 21 and to 512 for phase 22,
# paced from 1 000 to 500 for phase 22
TRICKLE_PODS, TRICKLE_CHUNK = 512, 64
PACED_PODS, PACED_RATE, PACED_CHUNK = 500, 200.0, 100
PACED_SLO_S = 5.0
# phase 12 (bench.py preempt_host, its own size)
HOST_PREEMPT_NODES, HOST_PREEMPT_VIPS, HOST_PREEMPT_WAVE = 50, 100, 16
# phase 13: 8 StatefulSets of 64 replicas, each pod with its own claim,
# beside density pods; free zonal PVs. The StatefulSet pods are halved
# (to no fewer than SS_MIN_PODS) when the phase projects past
# SS_PHASE_BUDGET_S: the host mask timed on SS_PROBE_PODS of them, for
# every StatefulSet pod and the wave the pipeline's bail-out masks again,
# plus a per-wave dispatch a wave at the density drain's ms a pod.
# SS_DENSITY cut from 2 048 to make room for phase 22; SS_MIN_PODS (from
# 128) and SS_PHASE_BUDGET_S (from 40 s) cut to make room for phase 23,
# SS_DENSITY (from 1 024) for phase 24
SS_SETS, SS_REPLICAS, SS_DENSITY, SS_FREE_PVS = 8, 64, 512, 320
SS_MIN_PODS, SS_PHASE_BUDGET_S, SS_PROBE_PODS = 64, 30.0, 8
# phase 14: the density world's backlog drained untraced and traced (16
# waves, one round; cut from 4 096 pods and 32 waves to make room for
# phase 21), then twice more traced after a promotion and after the
# rollback (TRACED_EXTRA cut from 512 to make room for phase 22, and to
# 128 for phase 23)
TRACED_PODS, TRACED_EXTRA = 2048, 128
# phase 22 (the autopilot and the invariant checker): the promotion
# pipeline's shadow window and watch take AP_SHADOW_ROUNDS and
# AP_WATCH_ROUNDS rounds of WAVE density pods; part (c)'s ledger comes
# from AP_SMALL_PODS pods at SMALL_NODES nodes, then AP_SMALL_EXTRA after
# the swap and AP_SMALL_EXTRA after the rollback
AP_SHADOW_ROUNDS, AP_WATCH_ROUNDS = 2, 2
AP_SMALL_PODS, AP_SMALL_EXTRA = 512, 128
# phase 15 (the cluster autoscaler): AUTOSCALE_RESIDENTS replicated pods
# of AUTOSCALE_RESIDENT_CPU bound on each real node (88% of its CPU), a
# backlog of AUTOSCALE_BACKLOG pods of AUTOSCALE_POD_CPU cores (half
# tolerating himem's taint) that no real node can host, and three node
# groups (name, cores, price, tainted, max size) under the autoscaler's
# defaults; at most AUTOSCALE_UP_PASSES scale-up passes, then
# AUTOSCALE_DOWN_PASSES scale-down passes; card == CPU on a reduced copy.
# The backlog (cut from 128) and the scale-down passes (cut from 8) are
# halved to make room for phase 22, and both again (from 64 and 4) for
# phase 23
AUTOSCALE_RESIDENTS, AUTOSCALE_RESIDENT_CPU = 4, "3500m"
AUTOSCALE_BACKLOG, AUTOSCALE_POD_CPU = 32, 20
AUTOSCALE_GROUPS = (("std-16", 16, 1.0, False, 16),
                    ("std-32", 32, 2.0, False, 96),
                    ("himem-64", 64, 4.5, True, 32))
AUTOSCALE_UP_PASSES, AUTOSCALE_DOWN_PASSES = 16, 2
AUTOSCALE_SMALL_NODES, AUTOSCALE_SMALL_BACKLOG = 500, 32
# phase 16 (the node-lifecycle controller at its defaults: grace 40 s,
# the pods' 300 s default tolerations): zone A stops every heartbeat,
# OUTAGE_B_FRACTION of zone B and OUTAGE_C_NODES nodes of zone C stop;
# monitor passes at OUTAGE_PASSES seconds (the first past the grace at
# OUTAGE_GRACE, evictions due from OUTAGE_GRACE + 300 s), then
# OUTAGE_DENSITY density pods drained and the heartbeats resumed. Cut
# for the script's time from 13 passes (every 100 s to the due time,
# then every 25 s): a pass walks 5.3 s of host time at 5 000 nodes once
# evictions are queued (PERF.md section 5), so the passes between the
# taint and the due time, which change nothing, are left out; for phase
# 23 the last pass (542 s) and half the density pods (512) are cut too
OUTAGE_B_FRACTION, OUTAGE_C_NODES, OUTAGE_DENSITY = 0.6, 20, 256
OUTAGE_GRACE = 41.0
OUTAGE_PASSES = (0.0, 41.0, 342.0, 442.0)
# phase 17 (the device-fault ladder): (b) and (d) drain FAULT_PODS density
# pods (halved, to no fewer than FAULT_MIN_PODS, when the phase projects
# past FAULT_BUDGET_S), (b) then FAULT_LATE more after the breaker's
# cooldown; (a)'s gang has FAULT_GANG members; (c) drains FAULT_WATCH
# pods under a deadline of FAULT_DEADLINE_X healthy dispatches; (d)'s
# NaN-spec pods (at these places of 2 048 pods, scaled to the pod count)
# and its crash-kind pod (inside the first wave, where the attribution
# replay reproduces the crash at once). FAULT_MIN_PODS (from 512) and
# FAULT_BUDGET_S (from 45 s) are cut to make room for phase 22, and
# FAULT_BUDGET_S (from 25 s) again for phase 24: a host that projects (b)
# and (d) past 15 s runs them at 256 pods
FAULT_PODS, FAULT_LATE, FAULT_MIN_PODS, FAULT_BUDGET_S = 2048, 512, 256, 15.0
FAULT_GANG, FAULT_WATCH, FAULT_DEADLINE_X = 16, 256, 3.0
FAULT_NAN, FAULT_CRASH = (100, 700, 1300, 1900), 40


def nan_pods(n_pods):
    """The names of phase 17 (d)'s NaN-spec pods among n_pods."""
    return [f"pod-{i * n_pods // 2048}" for i in FAULT_NAN]
# the scheduler series phase 14 holds card == CPU: those every drain
# observes and those the recorder, the decomposition, the shadow pass and
# the telemetry feed
TRACED_METRICS = (
    "pod_scheduling_latency", "binding_latency", "pods_scheduled",
    "e2e_scheduling_latency", "waves_total", "schedule_attempts",
    "pods_failed", "unschedulable_reasons", "preemption_evaluation",
    "total_preemption_attempts", "pod_preemption_victims",
    "gang_schedule_attempts", "gang_wait_seconds", "scheduling_errors",
    "score_margin", "score_priority_points", "shadow_divergence",
    "shadow_scored_pods", "shadow_margin_delta", "cluster_requested",
    "cluster_allocatable", "cluster_free_largest", "cluster_fragmentation",
    "feasibility_headroom", "zone_utilization", "device_fetch_bytes")
# ledger keys that hold wall-clock times, and the backend name
LEDGER_TIMINGS = ("ts", "wall_s", "spans", "path")
# phase 5's volumes world: pods on bound zoned claims, on their own
# WaitForFirstConsumer claims against fewer free PVs in two zones of
# three, on shared inline disks, aimed at PD_NODES nodes with 3 PDs each
# past the 16-PD limit, and one on a claim with no PV
VOL_BOUND, VOL_WFFC, VOL_FREE_PVS, VOL_SHARED, PD_NODES = 120, 120, 100, 60, 4
GCE_PD, GCE_PD_LIMIT, GI = "GCEPersistentDisk", 16, 2 ** 30
# phase 5's policy world: a labelsPresence filter, a labelPreference and
# ResourceLimitsPriority host score, LeastRequestedPriority zeroed
POLICY = json.dumps({
    "predicates": [
        {"name": "PodFitsResources"}, {"name": "PodToleratesNodeTaints"},
        {"name": "MatchNodeSelector"}, {"name": "NoDiskConflict"},
        {"name": "GPUNodes", "argument": {"labelsPresence": {
            "labels": ["gpu"], "presence": True}}}],
    "priorities": [
        {"name": "LeastRequestedPriority", "weight": 0},
        {"name": "BalancedResourceAllocation", "weight": 1},
        {"name": "SelectorSpreadPriority", "weight": 1},
        {"name": "ResourceLimitsPriority", "weight": 2},
        {"name": "SSDNodes", "argument": {"labelPreference": {
            "label": "ssd", "presence": True}}, "weight": 5}]})
WAVE = 128
# the round's wave cap with inter-pod affinity (sched/scheduler.py)
IPA_MAX_WAVES = 64
ZONE = "failure-domain.beta.kubernetes.io/zone"
HOSTNAME = "kubernetes.io/hostname"
# H100 SXM HBM bandwidth (NVIDIA data sheet). The kernel's compares and
# logic are 32-bit integer work: an SM has 64 INT32 lanes a clock (the
# 128 FP32 lanes, and the 67 TFLOP/s that count an FMA as two, do not
# apply), so the integer rate is SMs x 64 x the SM clock, read from the
# card at run time
HBM_BYTES_PER_S = 3.35e12
INT32_LANES_PER_SM = 64
# the fields of the node and pod tensors that taint_ports_masks reads
# phase 18 (the memory plane and load shedding), cut for the script's
# time (PERF.md section 4): (a) the density world of MEM_OOM_PODS pods
# with device.oom once and its fault-free run, MEM_STRIKE_PODS pods with
# device.oom three times and the per-wave drain on the card, the preempt
# world's FULL_NODES nodes full of bound hogs and MEM_VIPS vips; (b)
# MEM_RESIDENT bound density pods and MEM_CYCLES cycles (cut from 12) of
# MEM_JOBS Jobs x MEM_JOB_PODS pods (cut from 32), the cadence MEM_COMPACT_S virtual
# seconds crossed every MEM_COMPACT_EVERY cycles; its 500-node copy with
# MEM_SMALL_RESIDENT bound pods and MEM_SMALL_JOB_PODS pods a Job; (c) a
# budget MEM_GOV_SLACK bytes above the footprint, a wave of pods with
# MEM_GOV_KEYS new label keys; (d) MEM_CORRUPT corrupted rows, a
# 500-node drain of MEM_SCRUB_PODS pods; (e) STORM_LOW priority-0 pods
# (cut from 20 000) in bursts of STORM_BURST a tick (5 waves) with a
# HIGH_PRIORITY_BAND pod after every STORM_EVERY (STORM_HIGH, cut from
# 1 000), the watermark STORM_WATERMARK (cut from 4 096 with the burst)
# and shed_age_s STORM_AGE_S on the virtual clock; after the burst one
# wave a tick (at most STORM_DRAIN_TICKS) until nothing is pending. Cut
# for phase 23: MEM_OOM_PODS (from 1 024), MEM_SMALL_RESIDENT (from
# 3 000), STORM_LOW (from 2 560) and STORM_HIGH (from 128) halved; for
# phase 24 MEM_CYCLES (from 6) to 4, one compaction and the two uploads
# after it, and MEM_OOM_PODS and MEM_STRIKE_PODS (from 512) to 256
MEM_OOM_PODS, MEM_STRIKE_PODS, MEM_VIPS = 256, 256, 256
MEM_RESIDENT, MEM_CYCLES, MEM_JOBS, MEM_JOB_PODS = 30000, 4, 32, 8
MEM_COMPACT_S, MEM_COMPACT_EVERY = 60.0, 3
MEM_SMALL_NODES, MEM_SMALL_RESIDENT, MEM_SMALL_JOB_PODS = 500, 1500, 2
MEM_GOV_SLACK, MEM_GOV_KEYS = 4096, 16
MEM_CORRUPT, MEM_SCRUB_PODS = 8, 512
STORM_LOW, STORM_HIGH, STORM_EVERY = 1280, 64, 20
STORM_BURST, STORM_WATERMARK, STORM_AGE_S = 5 * WAVE, 1024, 60.0
STORM_DRAIN_TICKS = 200
# phase 19 (the store plane): STORE_PODS density pods drained with the
# store up, then STORE_PODS more during a store outage, on a virtual clock
# with the store breaker's cooldown STORE_COOLDOWN_S (its jitter pinned);
# the journal capped at STORE_JOURNAL_BYTES, so that (b)'s replay of
# STORE_PODS intents (about 118 B each) crosses one rotation; (d) the
# spool watermark STORE_WATERMARK with shed_watermark STORM_WATERMARK,
# STORE_HELD low pods held past it and STORE_HIGH high pods spooled.
# STORE_PODS cut from 1 024 (the journal cap from 65 536 B with it) to
# make room for phase 21
STORE_PODS, STORE_COOLDOWN_S, STORE_JOURNAL_BYTES = 512, 2.0, 32768
STORE_WATERMARK, STORE_HELD, STORE_HIGH = 256, 128, 8
# phase 20 (HTTP extenders): the script's extender bans node-{i} with
# i % EXT_BAN_MOD == EXT_BAN_MOD - 1 and gives EXT_SCORE to the nodes of
# zone-{EXT_ZONE}, at weight EXT_WEIGHT, every call within EXT_TIMEOUT_S;
# (a) EXT_PODS density pods at FULL_NODES nodes (halved when the first
# wave, timed alone, projects the phase past EXT_BUDGET_S with
# EXT_REST_S for (b)-(d)), (b) the same backlog at SMALL_NODES nodes, (c)
# SMALL_NODES nodes full of hogs and EXT_VIPS vips (not 64: with an
# extender the drain preempts on the host per wave, where two vips a pass
# get a node, as in the JAX scheduler, so the filter, prioritize and
# preempt POSTs grow with the square of the vips; extender_vips.py times
# this world at other counts), (d) EXT_DOWN_PODS pods (one wave) with the
# extender down. EXT_PODS cut from 512 to 256 to make room for phase 21
# and to 128 (one wave) for phase 22, EXT_VIPS from 16 to 8 for phase 22
# and to 4 for phase 23 (the halving rule above still applies), EXT_PODS
# to 64 for phase 24
EXT_PODS, EXT_BAN_MOD, EXT_ZONE, EXT_SCORE, EXT_WEIGHT = 64, 7, 1, 10, 2
EXT_TIMEOUT_S, EXT_BUDGET_S, EXT_REST_S = 30.0, 90.0, 40.0
EXT_VIPS, EXT_DOWN_PODS = 4, 128
# phase 21 (the deployed kube-scheduler against the port's APIServer):
# (a) DEPLOY_PODS density pods at FULL_NODES nodes, created over REST;
# (c) FAILOVER_PODS pods drained by two --leader-elect schedulers with
# leases of FAILOVER_LEASE s (renew deadline FAILOVER_RENEW s, retry
# FAILOVER_RETRY s), each wait bounded by FAILOVER_WAIT_S; (d) card ==
# CPU at SMALL_NODES nodes and DEPLOY_SMALL_PODS pods. DEPLOY_PODS (cut
# from 2 048), FAILOVER_PODS (cut from 1 024) and DEPLOY_SMALL_PODS
# (cut from 512) are halved to make room for phase 22, DEPLOY_PODS again
# (from 1 024) for phase 23, and DEPLOY_PODS (from 512) again for phase
# 24 (FAILOVER_PODS stays: at 256 the leader bound every pod before its
# elector stopped, and the standby had none to bind)
DEPLOY_PODS, FAILOVER_PODS, DEPLOY_SMALL_PODS = 256, 512, 256
FAILOVER_LEASE, FAILOVER_RENEW, FAILOVER_RETRY = 1.5, 1.0, 0.2
FAILOVER_WAIT_S = 120.0
# the /metrics families phase 21 (d) leaves out of card == CPU: the
# histograms of wall-clock seconds (buckets and sums; their _count lines
# are compared), series that vary from run to run on one device (the
# class gauges, exported on a one-second cadence; the upload bytes, which
# depend on how many bind echoes reached the mirror before each wave),
# and the compile-cache series (their bucket label names the device, and
# a hit or a miss depends on what the process ran before)
DEPLOY_TIMED = ("binding_latency", "e2e_scheduling_latency",
                "gang_wait_seconds", "pod_scheduling_latency",
                "scheduling_algorithm_latency",
                "scheduling_algorithm_predicate_evaluation",
                "scheduling_algorithm_preemption_evaluation",
                "scheduling_algorithm_priority_evaluation",
                "snapshot_scrub_duration_seconds")
DEPLOY_UNTIMED = ("scheduler_queue_class_pods", "snapshot_upload_bytes_total",
                  "device_jit_cache_events_total",
                  "device_jit_compile_seconds")
# phase 23 (the chaos campaign and the kubemark hollow cluster): (a)
# run_campaign(seed=CHAOS_SEED) over CHAOS_SCHEDULES schedules (bench.py
# run_chaoscampaign_config samples 50 at seed 7; cut for the script's
# time, to 8 and then to 4 for phase 24) on the card and on the CPU; (b) the two broken builds of
# tests/test_campaign.py and tests/test_outage.py at seed CHAOS_SEED:
# (hook, schedule (point, mode, times), the invariants that may catch it,
# the minimal schedule); (c) a HollowCluster of FULL_NODES nodes (and of
# SMALL_NODES on the card and on the CPU) for HOLLOW_TICKS ticks (16, then
# 4 for phase 24) of the campaign's loop: the nodes whose index is the tick mod
# HOLLOW_HB_EVERY heartbeat, HOLLOW_ARRIVALS pods of the campaign's mix
# arrive, two run_once; a gang that fits (members, milli-CPU) at tick 2,
# one no 16-CPU node can hold at tick 3; HOLLOW_ARMED armed at tick 2;
# then at most HOLLOW_DRAIN_TICKS ticks until only the gang that cannot
# fit is pending. The SMALL_NODES copy runs HOLLOW_SMALL_TICKS ticks of
# arrivals (its CPU run is the slower half: a per-wave dispatch of WAVE
# rows walks every row in a loop of small ops)
CHAOS_SEED, CHAOS_SCHEDULES = 7, 4
CHAOS_BROKEN = (
    ("_gang_rollback_enabled", ("snapshot.write", "corrupt", 4),
     ("conservation", "gang_atomic"), "snapshot.write=corrupt::1"),
    ("_journal_replay_enabled", ("store.outage", "raise", 6),
     ("conservation",), "store.outage=raise::4"))
HOLLOW_TICKS, HOLLOW_ARRIVALS, HOLLOW_HB_EVERY = 4, 128, 10
HOLLOW_SMALL_TICKS = 4
HOLLOW_FIT, HOLLOW_BIG, HOLLOW_DRAIN_TICKS = (8, 4000), (3, 20000), 40
HOLLOW_ARMED = ("kernel.hang=latency:0.02:2,heartbeat.deliver=drop::3,"
                "watch.deliver=latency:0.005:3,bind.post=raise::2")
# phase 24 (kubeadm on the in-memory store): (b) a secure Cluster of
# FULL_NODES nodes, FULL_NODES - KUBEADM_JOINS hollow (their kubelets
# never run, a kubelet's sync lists every pod; they heartbeat from a
# thread of the script, KUBEADM_HB_SLICES slices a KUBEADM_HB_PERIOD)
# and KUBEADM_JOINS joined over CSR and mTLS (the TTL controller's
# 5 000-node bucket holds them all, so the joins re-annotate no node), a
# Deployment of KUBEADM_PODS pods of 100m and 64Mi, a live upgrade to
# KUBEADM_VERSION, then KUBEADM_SCALE replicas; (c) the same at
# SMALL_NODES with KUBEADM_SMALL_PODS, then KUBEADM_SMALL_SCALE, driven
# in the script's thread on the card and on the CPU. A wait that does not
# end within KUBEADM_WAIT_S fails the phase. (b)'s node-lifecycle
# controller runs with a monitor grace of KUBEADM_GRACE_S (the
# kube-controller-manager's --node-monitor-grace-period, 40 s by
# default), and the nodes beat once in KUBEADM_HB_PERIOD: this one
# process carries the API server, 28 controller loops, the scheduler and
# every kubelet's heartbeat, and each heartbeat goes through 27 informers
# and three watch streams. With a 40 s grace and a 20 s round (250
# writes a second) the scheduler's node stream fell about 28 000 events
# behind the store and a live node was tainted unreachable (an H100
# host running the whole script; PERF.md section 6)
KUBEADM_PODS, KUBEADM_SCALE, KUBEADM_JOINS = 1024, 1536, 2
KUBEADM_SMALL_PODS, KUBEADM_SMALL_SCALE = 256, 384
KUBEADM_VERSION, KUBEADM_WAIT_S = "v1.12-tpu.0", 120.0
KUBEADM_HB_SLICES, KUBEADM_HB_PERIOD, KUBEADM_GRACE_S = 80, 80.0, 120.0
# a pod uid as the store mints it, from a process-wide counter
POD_UID = re.compile(r"uid-\d+")
KERNEL_NODE_FIELDS = ("taint_key", "taint_val", "taint_effect", "ports")
KERNEL_POD_FIELDS = ("tol_key", "tol_val", "tol_op", "tol_effect", "ports")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


# --- worlds ------------------------------------------------------------------


def build_store(api, store_mod, n_nodes: int, n_pods: int, seed: int):
    """The deployment of the main path: kube-scheduler 1.11's 5 000-node
    scalability shape (bench.py build_cluster nodes: 3 zones, 16 CPU,
    32Gi, 110 pods), 1/4 of the nodes tainted dedicated=infra:NoSchedule
    and 1/20 maintenance:NoExecute, bound pods holding hostPort 8080 on
    1/10 of the nodes, and a backlog of bench.py's density pods
    (100m / 128Mi) of which 1/4 tolerate `dedicated`, 1/10 ask for
    hostPort 8080
    and 1/10 carry a zone nodeSelector."""
    import numpy as np

    rng = np.random.RandomState(seed)
    store = store_mod.ObjectStore()
    port_nodes = []
    for i in range(n_nodes):
        taints = []
        if rng.rand() < 0.25:
            taints.append(api.Taint(key="dedicated", value="infra",
                                    effect=api.NO_SCHEDULE))
        if rng.rand() < 0.05:
            taints.append(api.Taint(key="maintenance",
                                    effect=api.NO_EXECUTE))
        if rng.rand() < 0.10:
            port_nodes.append(f"node-{i}")
        store.create("nodes", api.Node(
            metadata=api.ObjectMeta(name=f"node-{i}", labels={
                ZONE: f"zone-{i % 3}", HOSTNAME: f"node-{i}"}),
            spec=api.NodeSpec(taints=taints),
            status=api.NodeStatus(
                allocatable=api.resource_list(cpu="16", memory="32Gi",
                                              pods=110,
                                              ephemeral_storage="200Gi"),
                conditions=[api.NodeCondition(api.NODE_READY,
                                              api.COND_TRUE)])))

    def pod(name, node_name="", port=False, tolerate=False, zone=None):
        ports = ([api.ContainerPort(container_port=8080, host_port=8080)]
                 if port else [])
        if tolerate == "all":  # the bound port holders, daemon-style
            tolerations = [api.Toleration(
                operator=api.TOLERATION_OP_EXISTS)]
        elif tolerate:
            tolerations = [api.Toleration(
                key="dedicated", operator=api.TOLERATION_OP_EQUAL,
                value="infra", effect=api.NO_SCHEDULE)]
        else:
            tolerations = []
        return api.Pod(
            metadata=api.ObjectMeta(
                name=name, labels={"type": "density"},
                owner_references=[api.OwnerReference(
                    kind="ReplicationController", name="density",
                    uid="rc-density", controller=True)]),
            spec=api.PodSpec(
                node_name=node_name,
                node_selector=({ZONE: zone} if zone else {}),
                tolerations=tolerations,
                containers=[api.Container(
                    resources=api.ResourceRequirements(
                        requests=api.resource_list(cpu="100m",
                                                   memory="128Mi")),
                    ports=ports)]))

    for j, node_name in enumerate(port_nodes):
        store.create("pods", pod(f"holder-{j}", node_name=node_name,
                                 port=True, tolerate="all"))
    for j in range(n_pods):
        store.create("pods", pod(
            f"pod-{j}", port=rng.rand() < 0.10,
            tolerate=rng.rand() < 0.25,
            zone=f"zone-{rng.randint(3)}" if rng.rand() < 0.10 else None))
    return store, len(port_nodes)


def add_plain_nodes(api, store, n_nodes: int, affinity_labels: int = 0,
                    extra_labels=None, annotations=None):
    """bench.py build_cluster: 3 zones, 16 CPU, 32Gi, 110 pods a node, and
    with affinity_labels one of K `aff-{i % K}=yes` labels a node;
    extra_labels(i) adds labels to node i; annotations are copied onto
    every node."""
    for i in range(n_nodes):
        labels = {ZONE: f"zone-{i % 3}", HOSTNAME: f"node-{i}"}
        if affinity_labels:
            labels[f"aff-{i % affinity_labels}"] = "yes"
        if extra_labels is not None:
            labels.update(extra_labels(i))
        store.create("nodes", api.Node(
            metadata=api.ObjectMeta(name=f"node-{i}", labels=labels,
                                    annotations=dict(annotations or {})),
            status=api.NodeStatus(
                allocatable=api.resource_list(cpu="16", memory="32Gi",
                                              pods=110,
                                              ephemeral_storage="200Gi"),
                conditions=[api.NodeCondition(api.NODE_READY,
                                              api.COND_TRUE)])))


def build_mixed(api, lbl, store_mod, n_nodes: int, n_pods: int):
    """bench.py's `mixed` workload (make_pods "mixed" over build_cluster
    with affinity_labels=10), rebuilt here without the JAX package: four
    quarters of 100m / 128Mi pods, created in this order — density;
    required node affinity `aff-{i % 10} In (yes)`; spreading over 10
    services `svc=s{i % 10}`; required anti-affinity on the hostname
    within 50 groups `anti-group=g{i % 50}` (the last quarter takes the
    remainder). Returns (store, 0 bound pods)."""
    store = store_mod.ObjectStore()
    add_plain_nodes(api, store, n_nodes, affinity_labels=10)
    for s in range(10):
        store.create("services", api.Service(
            metadata=api.ObjectMeta(name=f"svc-{s}"),
            spec=api.ServiceSpec(selector={"svc": f"s{s}"})))

    def pod(name, prefix, labels=None, affinity=None):
        return api.Pod(
            metadata=api.ObjectMeta(
                name=name, labels=labels or {"type": prefix},
                owner_references=[api.OwnerReference(
                    kind="ReplicationController", name=prefix,
                    uid=f"rc-{prefix}", controller=True)]),
            spec=api.PodSpec(affinity=affinity, containers=[api.Container(
                resources=api.ResourceRequirements(
                    requests=api.resource_list(cpu="100m",
                                               memory="128Mi")))]))

    quarter = n_pods // 4
    for wl in ("density", "affinity", "spreading", "antiaffinity"):
        prefix = f"{wl}-pod"
        for i in range(quarter if wl != "antiaffinity"
                       else n_pods - 3 * quarter):
            name = f"{prefix}-{i}"
            if wl == "density":
                p = pod(name, prefix)
            elif wl == "affinity":
                p = pod(name, prefix, affinity=api.Affinity(
                    node_affinity=api.NodeAffinity(
                        required=api.NodeSelector([api.NodeSelectorTerm(
                            match_expressions=[lbl.Requirement(
                                f"aff-{i % 10}", "In", ("yes",))])]))))
            elif wl == "spreading":
                p = pod(name, prefix, labels={"type": prefix,
                                              "svc": f"s{i % 10}"})
            else:
                group = i % 50
                p = pod(name, prefix,
                        labels={"type": prefix, "anti-group": f"g{group}"},
                        affinity=api.Affinity(
                            pod_anti_affinity=api.PodAntiAffinity(
                                required=[api.PodAffinityTerm(
                                    label_selector=lbl.LabelSelector(
                                        match_labels={
                                            "anti-group": f"g{group}"}),
                                    topology_key=HOSTNAME)])))
            store.create("pods", p)
    return store, 0


def build_spread(api, lbl, store_mod, n_nodes: int, n_pods: int,
                 n_apps: int):
    """Deployments spread evenly across zones as a hard rule and across
    nodes as a preference: n_apps Deployments `app=d{k}` whose ReplicaSets
    create their pods one Deployment after another, each pod 100m /
    128Mi with a zone spread (maxSkew 1, DoNotSchedule) and a hostname
    spread (maxSkew 1, ScheduleAnyway) on its own app. Nodes as
    bench.py build_cluster. Returns (store, 0 bound pods)."""
    store = store_mod.ObjectStore()
    add_plain_nodes(api, store, n_nodes)
    per_app = n_pods // n_apps
    for k in range(n_apps):
        app = f"d{k}"
        sel = lbl.LabelSelector(match_labels={"app": app})
        for i in range(per_app if k < n_apps - 1
                       else n_pods - per_app * (n_apps - 1)):
            store.create("pods", api.Pod(
                metadata=api.ObjectMeta(
                    name=f"{app}-{i}", labels={"app": app},
                    owner_references=[api.OwnerReference(
                        kind="ReplicaSet", name=f"{app}-rs", uid=f"rs-{app}",
                        controller=True)]),
                spec=api.PodSpec(
                    topology_spread_constraints=[
                        api.TopologySpreadConstraint(
                            max_skew=1, topology_key=ZONE,
                            when_unsatisfiable=api.DO_NOT_SCHEDULE,
                            label_selector=sel),
                        api.TopologySpreadConstraint(
                            max_skew=1, topology_key=HOSTNAME,
                            when_unsatisfiable=api.SCHEDULE_ANYWAY,
                            label_selector=sel)],
                    containers=[api.Container(
                        resources=api.ResourceRequirements(
                            requests=api.resource_list(
                                cpu="100m", memory="128Mi")))])))
    return store, 0


def batch_pod(api, name, prefix, cpu, priority, gang=None):
    """bench.py _base_pod (100m / 128Mi, controlled by an RC) with its
    CPU request set to `cpu` cores and a priority; gang: a PodGroup name,
    min-available GANG_SIZE."""
    p = api.Pod(
        metadata=api.ObjectMeta(
            name=name, labels={"type": prefix},
            owner_references=[api.OwnerReference(
                kind="ReplicationController", name=prefix,
                uid=f"rc-{prefix}", controller=True)]),
        spec=api.PodSpec(priority=priority, containers=[api.Container(
            resources=api.ResourceRequirements(
                requests=api.resource_list(cpu=str(cpu),
                                           memory="128Mi")))]))
    if gang is not None:
        p.metadata.annotations = {
            api.POD_GROUP_NAME_ANNOTATION: gang,
            api.POD_GROUP_MIN_AVAILABLE_ANNOTATION: str(GANG_SIZE)}
    return p


def add_gangs(api, store, n_gangs, cpu=4):
    """bench.py's gangstorm gangs: n_gangs PodGroups of GANG_SIZE members,
    `cpu` cores each at priority 1, min-available GANG_SIZE."""
    for g in range(n_gangs):
        for j in range(GANG_SIZE):
            store.create("pods", batch_pod(api, f"gang-{g}-m{j}", "storm-low",
                                           cpu, 1, gang=f"gang-{g}"))


def add_singles(api, store, prefix, n, cpu, priority):
    for i in range(n):
        store.create("pods", batch_pod(api, f"{prefix}-{i}", prefix, cpu,
                                       priority))


class VirtualClock:
    """A clock that moves only when told to: backoff deadlines then fall
    at the same points of a run on the card and on the CPU."""

    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def settle(sched, clock=None, limit=200):
    """schedule_pending until no pod is pending, stepping the virtual
    clock (or sleeping past PodBackoff(initial=0.001)) between passes;
    stops after `limit` passes in a row that place nothing. Returns pods
    placed."""
    placed = sched.schedule_pending()
    stalled = 0
    while sched.pending_count() and stalled < limit:
        if clock is not None:
            clock.t += 1.0
        else:
            time.sleep(0.002)
        n = sched.schedule_pending()
        placed += n
        stalled = stalled + 1 if n == 0 else 0
    return placed


def gang_counts(api, store):
    """gang name -> bound members, over the gang pods still in the store."""
    out = {}
    for p in store.list("pods"):
        g = api.pod_group_name(p)
        if g is not None:
            out[g] = out.get(g, 0) + bool(p.spec.node_name)
    return out


def small_world(api, store_mod, enc, bucket_size, Scheduler, PodBackoff,
                kind, device):
    """Phase 5's reduced preempt or gangstorm world on `device`, driven
    to the end on a virtual clock: (bindings, evictions)."""
    store = store_mod.ObjectStore()
    clock = VirtualClock()
    if kind == "preempt":
        nodes, arrivals = SMALL_PREEMPT_NODES, 2 * SMALL_PREEMPT_NODES + SMALL_VIPS
        caps = enc.Caps(M=bucket_size(2 * arrivals + 64), P=WAVE,
                        LV=bucket_size(nodes + 256, 64))
    else:
        nodes = SMALL_GANG_NODES
        arrivals = GANG_SIZE * SMALL_GANGS + SMALL_HIGH
        caps = enc.Caps(M=bucket_size(2 * arrivals + 64), P=GANG_P,
                        LV=bucket_size(nodes + 256, 64))
    sched = Scheduler(store, wave_size=WAVE, caps=caps, device=device,
                      clock=clock, backoff=PodBackoff(initial=0.001,
                                                      clock=clock))
    add_plain_nodes(api, store, nodes)
    if kind == "preempt":
        add_singles(api, store, "hog", 2 * nodes, 8, 1)
        settle(sched, clock)
        add_singles(api, store, "vip", SMALL_VIPS, 8, 100)
    else:
        add_gangs(api, store, SMALL_GANGS)
        settle(sched, clock)
        add_singles(api, store, "high", SMALL_HIGH, 4, 1000)
    settle(sched, clock)
    check_bindings(api, store)
    return bindings(store), evictions(sched)


def whatif_bound(torch, pre, w, int_rate):
    """(least ms, what bounds it, bytes, ops) of the what-if on these
    inputs: each input read once and the [5, P, N] output written once
    over HBM bandwidth, against the integer work this run's data needs
    over the card's integer rate — the victim-class sums, for each
    distinct threshold min(level, pod priority) of the chunk and each
    node, over the node's kept rows (live, or with a non-finite request:
    2 ops a resource column and 6 a row), and the fit test (4 a column
    and 3) of each level walked, up to the one taken, for each (pod,
    node) its static predicates pass."""
    cpu = pre.WhatIf(*[None if t is None else t.cpu() for t in w])
    _, level = pre.whatif_plain(cpu, with_level=True)
    P, N = cpu.static_ok.shape
    M, R = cpu.ep_req.shape
    L = cpu.levels.shape[0]
    walked = torch.where(level < L, level + 1, L).to(torch.int64)
    walked = walked * cpu.static_ok
    row_ptr, _, _ = pre.live_rows(cpu.ep_node, cpu.live, cpu.ep_req, N)
    _, _, n_slots = pre.threshold_slots(cpu.levels, cpu.pb_prio)
    ops = (int(n_slots) * int(row_ptr[-1]) * (2 * R + 6)
           + int(walked.sum()) * (4 * R + 3))
    in_bytes = (2 * 4 * N * R + 2 * 4 * N + 4 * M * R + 4 * M + M
                + (4 * M if cpu.gang_w is not None else 0)
                + 4 * (N + 1) + 4 * M + 4 * L + 4 * P * R + 4 * P + P * N)
    out_bytes = 5 * 4 * P * N
    t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = ops / int_rate * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            in_bytes + out_bytes, ops)


def time_whatif(torch, pre, w, int_rate, tag, what):
    """The what-if on `w` timed by CUDA events two ways — the whole
    preempt_whatif call (row lists, slots, both kernels, allocations) and
    the class-stats and pick kernels alone on a prebuilt row list and
    slot table — beside its bound; the host syncs of one call counted
    with torch.cuda.set_sync_debug_mode("warn"). Returns (call ms,
    kernels ms, bound ms, what bounds it)."""
    call_ms = cuda_ms(torch, lambda: pre.preempt_whatif(w), reps=10, runs=3)
    prep = pre.whatif_prepare(w)
    kernels_ms = cuda_ms(torch, lambda: pre.whatif_launch(prep))
    del prep
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            pre.preempt_whatif(w)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(c.message) for c in caught)
    bound, by, nbytes, ops = whatif_bound(torch, pre, w, int_rate)
    P, N = w.static_ok.shape
    log(f"[{tag}] what-if on {what} (P={P}, N={N}, "
        f"M={w.ep_node.shape[0]}): call {call_ms:.4f} ms, kernels alone "
        f"{kernels_ms:.4f} ms, bound {bound:.4f} ms ({by}: {nbytes} B, "
        f"{ops} ops); kernels at {bound / kernels_ms:.1%} of the bound, "
        f"the call at {bound / call_ms:.1%}; {syncs} host syncs in a call")
    return call_ms, kernels_ms, bound, by


def check_whatif(torch, pre, w, what):
    """The what-if kernel on `w` (on the card) against the plain version
    on a CPU copy of it: exact equality of the packed planes, launched
    once. Returns the largest |kernel - plain| over the planes."""
    before = pre.preempt_whatif.launches
    got = pre.preempt_whatif(w)
    torch.cuda.synchronize()
    if pre.preempt_whatif.launches != before + 1:
        fail(f"the what-if kernel did not launch once ({what})")
    want = pre.whatif_plain(pre.WhatIf(*[None if t is None else t.cpu()
                                         for t in w]))
    got = got.cpu()
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    if not torch.equal(got, want):
        bad = [i for i in range(5) if not torch.equal(got[i], want[i])]
        fail(f"what-if kernel != plain on the CPU (planes {bad}, {what})")
    return err


def scheduler_caps(enc, bucket_size, n_nodes, n_pods, n_bound, n_terms=0):
    """Pre-sized as bench.py run_config does, so no capacity grows (and
    no shape changes) mid-run: E holds one term row per anti-affinity
    pod."""
    return enc.Caps(M=bucket_size(n_pods + n_bound + 64), P=WAVE,
                    E=bucket_size(n_terms + 64) if n_terms else 8,
                    LV=bucket_size(n_nodes + 256, 64))


def check_bindings(api, store) -> int:
    """The invariants of a placement, read back from the store: taints,
    nodeSelector and required node affinity, host ports, resources and
    pod counts. Returns the number of bound pods."""
    nodes = {n.metadata.name: n for n in store.list("nodes")}
    used = {}
    bound = 0
    for p in store.list("pods"):
        name = p.spec.node_name
        if not name:
            continue
        bound += 1
        node = nodes.get(name)
        if node is None:
            fail(f"{p.metadata.name} bound to unknown node {name}")
        for taint in node.spec.taints:
            if taint.effect in (api.NO_SCHEDULE, api.NO_EXECUTE) and not \
                    api.tolerations_tolerate_taint(p.spec.tolerations, taint):
                fail(f"{p.metadata.name} on {name} does not tolerate "
                     f"{taint}")
        if not api.pod_matches_node_selector(p, node):
            fail(f"{p.metadata.name} on {name} misses its nodeSelector or "
                 "required node affinity")
        u = used.setdefault(name, {"cpu": 0, "memory": 0, "pods": 0,
                                   "ports": set()})
        req = api.get_resource_request(p)
        u["cpu"] += req.get("cpu", 0)
        u["memory"] += req.get("memory", 0)
        u["pods"] += 1
        for cp in api.get_container_ports(p):
            key = (cp.protocol, cp.host_port)
            if key in u["ports"]:
                fail(f"host port {key} used twice on {name}")
            u["ports"].add(key)
    for name, u in used.items():
        alloc = nodes[name].status.allocatable
        for res in ("cpu", "memory", "pods"):
            if u[res] > alloc.get(res, 0):
                fail(f"{name} over-committed on {res}: {u[res]} > "
                     f"{alloc.get(res, 0)}")
    return bound


def check_anti_affinity(store) -> int:
    """No bound pod shares a topology domain with a pod its required
    anti-affinity terms select (in the terms' namespaces). Returns the
    number of bound pods carrying such terms."""
    node_labels = {n.metadata.name: n.metadata.labels or {}
                   for n in store.list("nodes")}
    bound = [p for p in store.list("pods") if p.spec.node_name]
    by_domain = {}
    for p in bound:
        for key, value in node_labels[p.spec.node_name].items():
            by_domain.setdefault((key, value), []).append(p)
    checked = 0
    for p in bound:
        aff = p.spec.affinity
        if aff is None or aff.pod_anti_affinity is None:
            continue
        checked += 1
        for term in aff.pod_anti_affinity.required:
            value = node_labels[p.spec.node_name].get(term.topology_key)
            if value is None:
                continue
            namespaces = set(term.namespaces) or {p.namespace}
            for q in by_domain[(term.topology_key, value)]:
                if q is not p and q.namespace in namespaces and \
                        term.label_selector.matches(q.metadata.labels):
                    fail(f"{p.metadata.name} and {q.metadata.name} share "
                         f"{term.topology_key}={value} against "
                         f"{p.metadata.name}'s anti-affinity")
    return checked


def zone_counts(store) -> dict:
    """app -> {zone: bound pods of the app}."""
    zone_of = {n.metadata.name: n.metadata.labels[ZONE]
               for n in store.list("nodes")}
    zones = sorted(set(zone_of.values()))
    out = {}
    for p in store.list("pods"):
        if p.spec.node_name:
            c = out.setdefault(p.metadata.labels["app"],
                               dict.fromkeys(zones, 0))
            c[zone_of[p.spec.node_name]] += 1
    return out


def bindings(store) -> dict:
    return {p.metadata.name: p.spec.node_name for p in store.list("pods")}


def evictions(sched) -> int:
    """Pods the scheduler's preemptions evicted (its metrics)."""
    return int(sched.metrics.pod_preemption_victims.value)


def count_syncs(torch, fn):
    """fn() under torch.cuda.set_sync_debug_mode("warn"): (its result,
    {file:line -> implicit host syncs})."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    where = {}
    for w in caught:
        if "synchroniz" in str(w.message):
            key = f"{Path(w.filename).name}:{w.lineno}"
            where[key] = where.get(key, 0) + 1
    return out, where


class GcWatch:
    """Python's full (generation 2) garbage collections while it is
    installed: how many, and their seconds."""

    def __init__(self):
        self.count, self.seconds, self._t0 = 0, 0.0, None

    def _cb(self, phase, info):
        if info.get("generation") != 2:
            return
        if phase == "start":
            self._t0 = time.monotonic()
        elif self._t0 is not None:
            self.count += 1
            self.seconds += time.monotonic() - self._t0
            self._t0 = None

    def __enter__(self):
        gc.callbacks.append(self._cb)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._cb)


def spread_line(times) -> str:
    """The first, median and slowest of per-chunk drain seconds."""
    k = max(range(len(times)), key=times.__getitem__)
    return (f"chunk drains: first {times[0]:.3f} s, median "
            f"{statistics.median(times):.3f} s, slowest {times[k]:.3f} s "
            f"(chunk {k})")


def multikey_affinity(api, lbl):
    """Required pod affinity over two topology keys, which the round
    cannot encode (the exact host path): the zone of an `app=db` pod and
    the host of a `tier=cache` pod. In the 1.11 semantics both packages
    keep (predicates.go anyPodsMatchingTopologyTerms), one bound pod must
    match both terms and share both domains with the node."""
    return api.Affinity(pod_affinity=api.PodAffinity(required=[
        api.PodAffinityTerm(label_selector=lbl.LabelSelector(
            match_labels={"app": "db"}), topology_key=ZONE),
        api.PodAffinityTerm(label_selector=lbl.LabelSelector(
            match_labels={"tier": "cache"}), topology_key=HOSTNAME)]))


def add_anchors(api, store):
    """Bound pods (100m / 128Mi) on untainted nodes: `app=db, tier=cache`
    on four, the only pods that anchor both multi-key terms, and decoys
    matching one term each on eight more."""
    free = [n.metadata.name for n in store.list("nodes") if not n.spec.taints]
    for labels, nodes in (({"app": "db", "tier": "cache"}, free[0:4]),
                          ({"app": "db"}, free[4:8]),
                          ({"tier": "cache"}, free[8:12])):
        for node in nodes:
            p = batch_pod(api, "-".join(labels.values()) + f"-{node}",
                          "anchor", "100m", None)
            p.metadata.labels = dict(labels)
            p.spec.node_name = node
            store.create("pods", p)


def add_multikey(api, lbl, store):
    """MULTIKEY_PODS single pods and one gang of MULTIKEY_GANG (its
    min-available), 100m / 128Mi each, with multikey_affinity."""
    for i in range(MULTIKEY_PODS + MULTIKEY_GANG):
        p = batch_pod(api, f"multikey-{i}", "multikey", "100m", None)
        p.spec.affinity = multikey_affinity(api, lbl)
        if i >= MULTIKEY_PODS:
            p.metadata.annotations = {
                api.POD_GROUP_NAME_ANNOTATION: "multikey-gang",
                api.POD_GROUP_MIN_AVAILABLE_ANNOTATION: str(MULTIKEY_GANG)}
        store.create("pods", p)


def check_multikey(store) -> int:
    """Every pod with required pod affinity over two topology keys is
    bound, to a node that holds its terms, read back from the store: some
    bound pod matches every term's selector and shares every term's
    domain with the node. Returns the number of such pods."""
    labels = {n.metadata.name: n.metadata.labels for n in store.list("nodes")}
    pods = store.list("pods")
    bound = [p for p in pods if p.spec.node_name]
    checked = 0
    for p in pods:
        aff = p.spec.affinity
        if aff is None or aff.pod_affinity is None:
            continue
        terms = aff.pod_affinity.required
        if len({t.topology_key for t in terms}) < 2:
            continue
        checked += 1
        if not p.spec.node_name:
            fail(f"multikey: {p.metadata.name} is not bound")
        mine = labels[p.spec.node_name]
        if not any(q is not p and all(
                q.namespace == p.namespace
                and t.label_selector.matches(q.metadata.labels)
                and mine.get(t.topology_key) is not None
                and labels[q.spec.node_name].get(t.topology_key)
                == mine.get(t.topology_key) for t in terms)
                for q in bound):
            fail(f"multikey: {p.metadata.name} on {p.spec.node_name} does "
                 "not hold its two affinity terms")
    return checked


# --- kernel phase --------------------------------------------------------------


def int_ops_per_s(torch):
    """(integer ops per second, SMs, SM MHz): SMs x 64 INT32 lanes x the
    card's maximum SM clock."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi clocks.max.sm: {smi.stderr.strip()}")
    mhz = float(smi.stdout.split()[0])
    return sms * INT32_LANES_PER_SM * mhz * 1e6, sms, mhz


def kernel_bound(nt, pb, effects, int_rate):
    """(least ms, what bounds it, bytes, ops): the bytes the function
    must move (each input read once, each output written once) over HBM
    bandwidth, and the integer work these inputs need over the card's
    integer rate. Work: 8 ops per (relevant node taint, live pod
    toleration) pair, 2 per (live pod port, live node port) pair; a pad
    slot needs no compare."""
    N, T = nt.taint_key.shape
    PP = nt.ports.shape[1]
    P, TL = pb.tol_key.shape
    PQ = pb.ports.shape[1]
    in_bytes = 4 * (N * (3 * T + PP) + P * (4 * TL + PQ))
    out_bytes = 2 * P * N
    relevant = sum(int((nt.taint_effect == e).sum()) for e in effects)
    live_tol = int((pb.tol_op != -1).sum())
    node_ports = int((nt.ports > 0).sum())
    pod_ports = int((pb.ports > 0).sum())
    ops = 8 * relevant * live_tol + 2 * node_ports * pod_ports
    t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = ops / int_rate * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            in_bytes + out_bytes, ops)


def check_kernel(torch, tp, nt, pb, effects, what):
    """The kernel against its plain version on one world: exact equality
    of both masks, launched once. Returns the largest |kernel - plain|."""
    before = tp.taint_ports_masks.launches
    got = tp.taint_ports_masks(nt, pb, effects=effects)
    torch.cuda.synchronize()
    if tp.taint_ports_masks.launches != before + 1:
        fail(f"the kernel did not launch once ({what})")
    want = tp.taint_ports_plain(nt, pb, effects)
    err = 0
    for g, w, name in zip(got, want, ("taints", "ports")):
        err = max(err, int((g.to(torch.int32) - w.to(torch.int32))
                           .abs().max()))
        if not torch.equal(g, w):
            fail(f"kernel != plain ({name}, {what})")
    return err


def check_captured(torch, tp, name, captured):
    """The kernel against its plain version on the inputs each drain's
    rounds gave it, one of each row count: exact equality of both masks.
    Returns the largest |kernel - plain|."""
    err = 0
    for rows, (nt, pb) in captured.items():
        err = max(err, check_kernel(torch, tp, nt, pb, tp.DEFAULT_EFFECTS,
                                    f"{name} round inputs, P={rows}"))
        log(f"[{name}] kernel == plain on the round's inputs P={rows} "
            f"N={nt.taint_key.shape[0]}")
    return err


def capturing(launch, seen):
    """A taint/port launch site that keeps in `seen` a copy of the first
    inputs of each row count (the node tensors are updated in place
    later), for check_captured, then launches."""
    def capture(nt_, pb_, **kw):
        rows = pb_.tol_key.shape[0]
        if rows not in seen:
            seen[rows] = (
                nt_._replace(**{f: getattr(nt_, f).clone()
                                for f in KERNEL_NODE_FIELDS}),
                pb_._replace(**{f: getattr(pb_, f).clone()
                                for f in KERNEL_POD_FIELDS}))
        return launch(nt_, pb_, **kw)
    return capture


def cuda_ms(torch, fn, reps=25, warm=3, runs=5) -> float:
    """Device milliseconds of one call of fn: CUDA events around reps
    calls in a row, divided by reps (so the host's time to issue a call
    overlaps the device's work on the previous one); the median of runs
    such runs, after warm-up."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


class PhaseClock:
    """Host wall seconds per phase of the scheduler's rounds, taken by
    wrapping the callables the scheduler calls. The device round and the
    upload are closed with a device sync, so they include device time
    (the round syncs at its fetch right after anyway)."""

    def __init__(self):
        self.seconds = {}

    def wrap(self, name, fn, sync=None):
        def timed(*args, **kw):
            t0 = time.monotonic()
            out = fn(*args, **kw)
            if sync is not None:
                sync()
            self.seconds[name] = (self.seconds.get(name, 0.0)
                                  + time.monotonic() - t0)
            return out

        return timed


# --- drains ----------------------------------------------------------------------


def drain(torch, mods, name, store, caps, n_bound, statics=None,
          sync_probe=False):
    """One Scheduler(store, device="cuda").schedule_pending(), watched:
    the kernel's launch count is set to 0 just before and read just
    after; every round's live and launched kernel rows, waves, pods,
    has_ipa / has_ts and device_round seconds are recorded; the host
    seconds of each phase are summed. statics names the statics function
    of ops/kernel.py whose first call's arguments are kept for timing;
    sync_probe counts the implicit host syncs of the first ipa round
    (torch.cuda.set_sync_debug_mode("warn")); that round's seconds go to
    a phase of their own and into no per-pod or per-wave time, since the
    warnings it records cost time of their own. The bindings must hold
    every invariant of check_bindings, every round must launch the
    kernel on its live rows only, and the scheduler must report the
    card. Returns a dict of what was seen."""
    api, tp, pre, kernel_mod, sched_mod, Scheduler = mods[:6]
    sched = Scheduler(store, wave_size=WAVE, caps=caps, device="cuda")
    clock = PhaseClock()
    sync = torch.cuda.synchronize
    sched.featurizer.featurize = clock.wrap("featurize",
                                            sched.featurizer.featurize)
    sched.snapshot.stage_pending = clock.wrap("stage",
                                              sched.snapshot.stage_pending)
    sched.snapshot.to_device = clock.wrap("upload", sched.snapshot.to_device,
                                          sync)
    sched._commit = clock.wrap("commit", sched._commit)
    seen = {"rounds": [], "captured": {}, "statics_args": None,
            "syncs": None}
    kernel_launch = kernel_mod.taint_ports_masks
    round_fn = sched_mod.schedule_round
    statics_fn = getattr(kernel_mod, statics) if statics else None

    def capture(nt_, pb_, **kw):
        # a copy of the first inputs of each row count the rounds gave
        # the kernel (the node tensors are updated in place later)
        if pb_.tol_key.shape[0] not in seen["captured"]:
            seen["captured"][pb_.tol_key.shape[0]] = (
                nt_._replace(**{f: getattr(nt_, f).clone()
                                for f in KERNEL_NODE_FIELDS}),
                pb_._replace(**{f: getattr(pb_, f).clone()
                                for f in KERNEL_POD_FIELDS}))
        seen["rounds"][-1]["launched"] += pb_.tol_key.shape[0]
        return kernel_launch(nt_, pb_, **kw)

    def capture_statics(*args):
        if seen["statics_args"] is None:
            seen["statics_args"] = args
        return statics_fn(*args)

    def counted_round(nt_, pm_, tt_, pbs, *args, **kw):
        # the waves up to the last live one are the round's live rows
        active = pbs.valid.any(dim=1).tolist()
        n_live = max((i + 1 for i, a in enumerate(active) if a), default=0)
        rec = {"live": n_live * pbs.valid.shape[1], "launched": 0,
               "waves": n_live, "W": pbs.valid.shape[0],
               "pods": int(pbs.valid.sum()),
               "has_ipa": bool(kw.get("has_ipa")),
               "has_ts": bool(pbs.ts_valid.any()), "probed": False}
        seen["rounds"].append(rec)
        probe = sync_probe and rec["has_ipa"] and seen["syncs"] is None
        rec["probed"] = probe
        t0 = time.monotonic()
        if probe:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    out = round_fn(nt_, pm_, tt_, pbs, *args, **kw)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            # (file:line -> count) of the Python lines that synced
            seen["syncs"] = {}
            for w in caught:
                if "synchroniz" in str(w.message):
                    where = f"{Path(w.filename).name}:{w.lineno}"
                    seen["syncs"][where] = seen["syncs"].get(where, 0) + 1
        else:
            out = round_fn(nt_, pm_, tt_, pbs, *args, **kw)
        sync()
        rec["seconds"] = time.monotonic() - t0
        phase = "sync_probe_round" if probe else "device_round"
        clock.seconds[phase] = clock.seconds.get(phase, 0.0) + rec["seconds"]
        return out

    kernel_mod.taint_ports_masks = capture
    sched_mod.schedule_round = counted_round
    if statics:
        setattr(kernel_mod, statics, capture_statics)
    tp.taint_ports_masks.launches = 0
    pre.preempt_whatif.launches = 0
    try:
        t0 = time.monotonic()
        placed = sched.schedule_pending()
        sync()
        wall = time.monotonic() - t0
        launches = tp.taint_ports_masks.launches
        seen["whatif_launches"] = pre.preempt_whatif.launches
    finally:
        kernel_mod.taint_ports_masks = kernel_launch
        sched_mod.schedule_round = round_fn
        if statics:
            setattr(kernel_mod, statics, statics_fn)
    if launches < 1:
        fail(f"{name}: the rounds never launched the taint/port kernel")
    if sched.wave_path() != "cuda":
        fail(f"{name}: wave_path() is {sched.wave_path()!r}, expected "
             "'cuda'")
    bound = check_bindings(api, store)
    if bound != placed + n_bound:
        fail(f"{name}: store holds {bound} bound pods, expected "
             f"{placed + n_bound}")
    for i, r in enumerate(seen["rounds"]):
        log(f"[{name}] round {i}: pods {r['pods']}, waves {r['waves']} "
            f"(bucket {r['W']}), has_ipa {r['has_ipa']}, has_ts "
            f"{r['has_ts']}, device_round {r['seconds']:.3f} s = "
            f"{1e3 * r['seconds'] / max(r['pods'], 1):.3f} ms/pod"
            f"{' (sync probe, untimed)' if r['probed'] else ''}; live "
            f"rows {r['live']}, launched rows {r['launched']}")
        if r["launched"] != r["live"]:
            fail(f"{name}: round {i} launched the kernel on "
                 f"{r['launched']} rows, not on its {r['live']} live rows")
    phases = dict(clock.seconds)
    phases["other"] = wall - sum(phases.values())
    log(f"[{name}] placed {placed} in {wall:.3f} s = {placed / wall:.1f} "
        f"pods/s; kernel launches {launches}; invariants hold")
    log(f"[{name}] host seconds by phase: " + ", ".join(
        f"{k} {v:.3f}" for k, v in phases.items()))
    seen.update(placed=placed, wall=wall, launches=launches)
    return seen


def per_pod_ms(rounds, flag):
    """Device_round ms per pod over the rounds with and without `flag`,
    the sync-probed round left out (None where no round falls in a
    group)."""
    out = {}
    for want in (True, False):
        rs = [r for r in rounds if r[flag] == want and not r["probed"]]
        pods = sum(r["pods"] for r in rs)
        out[want] = (1e3 * sum(r["seconds"] for r in rs) / pods
                     if pods else None)
    return out


def time_statics(torch, name, fn, args, rounds, flag):
    """The statics function once on one full-width wave's inputs (CUDA
    events, the median of 3 runs of 5 calls), against the mean
    device_round time of a wave in the rounds with `flag`, the
    sync-probed round left out."""
    ms = cuda_ms(torch, lambda: fn(*args), reps=5, warm=1, runs=3)
    rs = [r for r in rounds if r[flag] and not r["probed"]]
    wave_ms = (1e3 * sum(r["seconds"] for r in rs)
               / sum(r["waves"] for r in rs))
    log(f"[{name}] {fn.__name__} on one wave (P={WAVE}, N="
        f"{args[0].valid.shape[0]}, M={args[1].valid.shape[0]}): {ms:.4f} ms"
        f", {ms / wave_ms:.1%} of a {flag} wave's {wave_ms:.3f} ms "
        "device_round")
    return ms


class Watch:
    """Phases 8 and 9: one Scheduler on the card whose host phases, gang
    dispatches and what-if chunks are timed and counted, and whose
    what-if inputs are captured (a copy of the first of each pod-row
    count) — by wrapping the callables the scheduler calls."""

    def __init__(self, torch, mods, store, caps):
        api, tp, pre, kernel_mod, sched_mod, Scheduler, PodBackoff = mods
        self.torch, self.tp, self.pre, self.sched_mod = torch, tp, pre, sched_mod
        self.sched = sched = Scheduler(store, wave_size=WAVE, caps=caps,
                                       device="cuda",
                                       backoff=PodBackoff(initial=0.001))
        self.clock = clock = PhaseClock()
        sync = torch.cuda.synchronize
        sched.featurizer.featurize = clock.wrap("featurize",
                                                sched.featurizer.featurize)
        sched.snapshot.stage_pending = clock.wrap(
            "stage", sched.snapshot.stage_pending)
        sched.snapshot.to_device = clock.wrap("upload",
                                              sched.snapshot.to_device, sync)
        sched._commit = clock.wrap("commit", sched._commit)
        sched._commit_gang = clock.wrap("commit", sched._commit_gang)
        sched._perform_preemption = self._count_preemptions(
            clock.wrap("evict", sched._perform_preemption))
        # the gang directory's scans of the cache (bound members, placed
        # gangs), each over every node's pods
        for name in ("bound_count", "placed_by_gang"):
            setattr(sched.gangs, name,
                    clock.wrap("gang_scan", getattr(sched.gangs, name)))
        # a preemption chunk's own host time — ranking the candidates of
        # each pod, skipping claimed nodes — is its time less that of the
        # phases above it ran
        chunk = sched._preempt_chunk

        def ranked_chunk(*a, **kw):
            before = sum(clock.seconds.values())
            t0 = time.monotonic()
            out = chunk(*a, **kw)
            sync()
            own = (time.monotonic() - t0
                   - (sum(clock.seconds.values()) - before))
            clock.seconds["rank"] = clock.seconds.get("rank", 0.0) + own
            return out

        sched._preempt_chunk = ranked_chunk
        self.preemptions = 0
        self.gang_dispatches = 0
        self.chunks = 0
        self.captured = {}
        self.saved = {name: getattr(sched_mod, name) for name in
                      ("schedule_round", "schedule_gang", "preemption_stats",
                       "select_victims_on_node")}
        self.saved_inputs = pre.whatif_inputs

        def gang(*a, **kw):
            self.gang_dispatches += 1
            return self.saved["schedule_gang"](*a, **kw)

        def whatif_chunk(*a, **kw):
            self.chunks += 1
            return self.saved["preemption_stats"](*a, **kw)

        def capture(*a, **kw):
            w = self.saved_inputs(*a, **kw)
            P = w.static_ok.shape[0]
            if P not in self.captured:
                self.captured[P] = pre.WhatIf(*[
                    None if t is None else t.clone() for t in w])
            return w

        sched_mod.schedule_round = clock.wrap(
            "device_round", self.saved["schedule_round"], sync)
        sched_mod.schedule_gang = clock.wrap("gang_dispatch", gang, sync)
        sched_mod.preemption_stats = clock.wrap("whatif", whatif_chunk, sync)
        sched_mod.select_victims_on_node = clock.wrap(
            "validate", self.saved["select_victims_on_node"])
        pre.whatif_inputs = capture

    def _count_preemptions(self, fn):
        def counted(*a, **kw):
            self.preemptions += 1
            return fn(*a, **kw)
        return counted

    def restore(self):
        for name, fn in self.saved.items():
            setattr(self.sched_mod, name, fn)
        self.pre.whatif_inputs = self.saved_inputs

    def stage(self, name, want):
        """Drain what is pending; returns (placed, wall seconds)."""
        t0 = time.monotonic()
        placed = settle(self.sched)
        self.torch.cuda.synchronize()
        wall = time.monotonic() - t0
        log(f"[{name}] placed {placed} in {wall:.3f} s = "
            f"{placed / wall:.1f} pods/s")
        if placed != want:
            fail(f"{name}: placed {placed}, expected {want}")
        return placed, wall

    def report(self, name, wall):
        phases = dict(self.clock.seconds)
        phases["other"] = wall - sum(phases.values())
        log(f"[{name}] host seconds by phase: " + ", ".join(
            f"{k} {v:.3f}" for k, v in phases.items()))


def gang_phase(torch, mods, enc, bucket_size):
    """Phase 8: the gangstorm drain at 5 000 nodes. Returns what it saw."""
    api, tp, pre = mods[0], mods[1], mods[2]
    store_mod = mods[-1]
    mods = mods[:-1]
    store = store_mod.ObjectStore()
    arrivals = GANGS * GANG_SIZE + GANG_HIGH
    caps = enc.Caps(M=bucket_size(2 * arrivals + 64), P=GANG_P,
                    LV=bucket_size(FULL_NODES + 256, 64))
    watch = Watch(torch, mods, store, caps)
    add_plain_nodes(api, store, FULL_NODES)
    add_gangs(api, store, GANGS, cpu=GANG_CPU)
    tp.taint_ports_masks.launches = 0
    pre.preempt_whatif.launches = 0
    try:
        t0 = time.monotonic()
        _, fill_wall = watch.stage("gang fill", GANGS * GANG_SIZE)
        fill_dispatches = watch.gang_dispatches
        gang_launches = tp.taint_ports_masks.launches
        created = {p.metadata.name for p in store.list("pods")}
        add_singles(api, store, "high", GANG_HIGH, 4, 1000)
        # the high pods place into the free slots or by evicting gangs:
        # placed counts them and the evicted gangs' re-placements (none)
        _, high_wall = watch.stage("gang high", GANG_HIGH)
        wall = time.monotonic() - t0
        launches = tp.taint_ports_masks.launches
        whatif_launches = pre.preempt_whatif.launches
    finally:
        watch.restore()
    sched = watch.sched
    check_bindings(api, store)
    pods = {p.metadata.name: p for p in store.list("pods")}
    highs = [p for n, p in pods.items() if n.startswith("high-")]
    if len(highs) != GANG_HIGH or not all(p.spec.node_name for p in highs):
        fail("gang: a high pod is not bound")
    counts = gang_counts(api, store)
    split = {g: n for g, n in counts.items() if n not in (0, GANG_SIZE)}
    if split:
        fail(f"gang: gangs partially bound: {list(split.items())[:5]}")
    evicted = created - set(pods)
    if len(evicted) != evictions(sched):
        fail(f"gang: {len(evicted)} pods gone, {evictions(sched)} counted "
             "as evicted")
    if any(not n.startswith("gang-") for n in evicted):
        fail("gang: a victim is not a priority-1 gang member")
    if len(evicted) % GANG_SIZE:
        fail(f"gang: {len(evicted)} evictions, not a multiple of "
             f"{GANG_SIZE}")
    if launches < 1 or whatif_launches < 1:
        fail(f"gang: kernel launches {launches}, what-if launches "
             f"{whatif_launches}")
    log(f"[gang] fill: {GANGS} gangs of {GANG_SIZE} {GANG_CPU}-core pods in "
        f"{fill_wall:.3f} s = "
        f"{GANGS * GANG_SIZE / fill_wall:.1f} pods/s, {fill_dispatches} gang "
        f"dispatches, {gang_launches} taint/port launches; high: "
        f"{GANG_HIGH} pods in {high_wall:.3f} s = "
        f"{GANG_HIGH / high_wall:.1f} pods/s, {watch.preemptions} "
        f"preemptions ({sched.pipeline_preemptions} by the pipeline), "
        f"{len(evicted)} evictions = {len(evicted) // GANG_SIZE} whole "
        f"gangs; {len(counts)} gangs left, all whole")
    log(f"[gang] kernel launches: taint/port {launches}, what-if "
        f"{whatif_launches} in {watch.chunks} chunks; invariants hold")
    watch.report("gang", wall)
    return dict(launches=launches, whatif_launches=whatif_launches,
                captured=watch.captured)


def preempt_phase(torch, mods, enc, bucket_size):
    """Phase 9: the preempt drain at 5 000 nodes. Returns what it saw."""
    api, tp, pre = mods[0], mods[1], mods[2]
    store_mod = mods[-1]
    mods = mods[:-1]
    store = store_mod.ObjectStore()
    hogs = 2 * FULL_NODES
    caps = enc.Caps(M=bucket_size(hogs + PREEMPT_VIPS + hogs + 64), P=WAVE,
                    LV=bucket_size(FULL_NODES + 256, 64))
    watch = Watch(torch, mods, store, caps)
    add_plain_nodes(api, store, FULL_NODES)
    add_singles(api, store, "hog", hogs, 8, 1)
    tp.taint_ports_masks.launches = 0
    pre.preempt_whatif.launches = 0
    try:
        t0 = time.monotonic()
        _, fill_wall = watch.stage("preempt fill", hogs)
        fill_clock = dict(watch.clock.seconds)
        watch.clock.seconds.clear()
        add_singles(api, store, "vip", PREEMPT_VIPS, 8, 100)
        _, vip_wall = watch.stage("preempt vips", PREEMPT_VIPS)
        wall = time.monotonic() - t0
        launches = tp.taint_ports_masks.launches
        whatif_launches = pre.preempt_whatif.launches
    finally:
        watch.restore()
    sched = watch.sched
    check_bindings(api, store)
    pods = {p.metadata.name: p for p in store.list("pods")}
    vips = [p for n, p in pods.items() if n.startswith("vip-")]
    if len(vips) != PREEMPT_VIPS or not all(p.spec.node_name for p in vips):
        fail("preempt: a vip is not bound")
    if evictions(sched) != PREEMPT_VIPS or len(pods) != hogs:
        fail(f"preempt: {evictions(sched)} evicted, {len(pods)} pods left; "
             f"expected {PREEMPT_VIPS} and {hogs}")
    if watch.preemptions != sched.pipeline_preemptions:
        fail(f"preempt: {watch.preemptions} preemptions, "
             f"{sched.pipeline_preemptions} by the pipeline")
    if launches < 1 or whatif_launches < 1:
        fail(f"preempt: kernel launches {launches}, what-if launches "
             f"{whatif_launches}")
    log(f"[preempt] fill: {hogs} hogs at {hogs / fill_wall:.1f} pods/s "
        f"(host seconds: " + ", ".join(
            f"{k} {v:.3f}" for k, v in fill_clock.items()) + ")")
    log(f"[preempt] vips: {PREEMPT_VIPS} in {vip_wall:.3f} s = "
        f"{PREEMPT_VIPS / vip_wall:.1f} pods/s; {evictions(sched)} "
        f"evicted, {sched.pipeline_preemptions} preemptions all by the "
        f"pipeline; what-if chunks {watch.chunks}, launches "
        f"{whatif_launches}; taint/port launches {launches}; host "
        f"validation {watch.clock.seconds.get('validate', 0.0):.3f} s")
    watch.report("preempt vips", vip_wall)
    return dict(launches=launches, whatif_launches=whatif_launches,
                captured=watch.captured)


def multikey_world(api, lbl, store_mod, enc, bucket_size, Scheduler, device):
    """Phase 5's multi-key world on `device`, on a virtual clock: the
    reduced density world with its anchors bound first is drained, then
    the multi-key pods and their gang arrive and are drained through the
    exact host path. Returns (bindings, host-path pods, their seconds,
    bound pods when they arrived)."""
    store, n_bound = build_store(api, store_mod, SMALL_NODES, SMALL_PODS, SEED)
    add_anchors(api, store)
    extra = MULTIKEY_PODS + MULTIKEY_GANG + 12
    clock = VirtualClock()
    caps = scheduler_caps(enc, bucket_size, SMALL_NODES, SMALL_PODS + extra,
                          n_bound + 12)
    sched = Scheduler(store, wave_size=WAVE, caps=caps, device=device,
                      clock=clock)
    settle(sched, clock)
    resident = sum(1 for p in store.list("pods") if p.spec.node_name)
    host = {"pods": 0, "seconds": 0.0}
    inner = sched._schedule_host_path

    def timed(pod, *a, **kw):
        t0 = time.monotonic()
        try:
            return inner(pod, *a, **kw)
        finally:
            host["pods"] += 1
            host["seconds"] += time.monotonic() - t0

    sched._schedule_host_path = timed
    add_multikey(api, lbl, store)
    settle(sched, clock)
    check_bindings(api, store)
    check_anti_affinity(store)
    if check_multikey(store) != MULTIKEY_PODS + MULTIKEY_GANG:
        fail("multikey: not every multi-key pod was checked")
    return bindings(store), host["pods"], host["seconds"], resident


def warm_up(api, store, sched, Metrics, n_pods, n_waves):
    """bench.py's warm-up: n_pods warm pods created, warm_pipeline over
    them (n_waves picks the bucket), deleted again, and a fresh Metrics."""
    warm = [batch_pod(api, f"warmup-{i}", "warmup", "100m", None)
            for i in range(n_pods)]
    for p in warm:
        store.create("pods", p)
    sched.warm_pipeline(warm, n_waves=n_waves)
    for p in warm:
        store.delete("pods", "default", p.metadata.name)
    sched.metrics = Metrics()


def warmed_scheduler(mods, enc, bucket_size, Metrics, n_nodes, extra_pods):
    """bench.py _warmed_scheduler on the card: caps sized for
    `extra_pods`, waves of WAVE, the nodes, and min(WAVE, 64) warm pods
    through warm_up (one wave). Returns (store, scheduler)."""
    api, Scheduler, store_mod = mods[0], mods[5], mods[-1]
    store = store_mod.ObjectStore()
    caps = enc.Caps(M=bucket_size(extra_pods + 64), P=WAVE,
                    LV=bucket_size(n_nodes + 256, 64))
    sched = Scheduler(store, wave_size=WAVE, caps=caps, device="cuda")
    add_plain_nodes(api, store, n_nodes)
    warm_up(api, store, sched, Metrics, min(WAVE, 64), 1)
    return store, sched


def add_chunk(api, store, prefix, first, n):
    for i in range(first, first + n):
        store.create("pods", batch_pod(api, f"{prefix}-{i}", prefix, "100m",
                                       None))


def trickle_phase(torch, mods, enc, bucket_size, Metrics):
    """Phase 10: bench.py trickle at 5 000 nodes. Returns what it saw."""
    api, tp, pre, sched_mod = mods[0], mods[1], mods[2], mods[4]
    t_phase = time.monotonic()
    store, sched = warmed_scheduler(mods, enc, bucket_size, Metrics,
                                    FULL_NODES, TRICKLE_PODS + TRICKLE_CHUNK)
    tp.taint_ports_masks.launches = 0
    pre.preempt_whatif.launches = 0
    # host seconds by phase of the chunks' rounds, the first chunk's apart
    clock = PhaseClock()
    sync = torch.cuda.synchronize
    sched.featurizer.featurize = clock.wrap("featurize",
                                            sched.featurizer.featurize)
    sched.snapshot.to_device = clock.wrap("upload", sched.snapshot.to_device,
                                          sync)
    sched._commit = clock.wrap("commit", sched._commit)
    round_fn = sched_mod.schedule_round
    sched_mod.schedule_round = clock.wrap("device_round", round_fn, sync)
    placed = made = 0
    chunk_s = []
    t0 = time.monotonic()
    try:
        with GcWatch() as gcw:
            while made < TRICKLE_PODS:
                n = min(TRICKLE_CHUNK, TRICKLE_PODS - made)
                add_chunk(api, store, "trickle-pod", made, n)
                made += n
                t_chunk = time.monotonic()
                placed += sched.schedule_pending()
                chunk_s.append(time.monotonic() - t_chunk)
                if len(chunk_s) == 1:
                    first = dict(clock.seconds)
            torch.cuda.synchronize()
    finally:
        sched_mod.schedule_round = round_fn
    wall = time.monotonic() - t0
    launches = tp.taint_ports_masks.launches
    whatif_launches = pre.preempt_whatif.launches
    if placed != TRICKLE_PODS:
        fail(f"trickle: placed {placed} of {TRICKLE_PODS}")
    m = sched.metrics
    p99, p99_round = (m.pod_scheduling_latency.quantile(0.99),
                      m.e2e_scheduling_latency.quantile(0.99))
    rounds = m.e2e_scheduling_latency.total
    # one more chunk, its round run under the sync probe (left out of
    # the numbers above)
    syncs = {}

    def probed(*a, **kw):
        out, where = count_syncs(torch, lambda: round_fn(*a, **kw))
        syncs.update(where)
        return out

    sched_mod.schedule_round = probed
    try:
        add_chunk(api, store, "trickle-probe", 0, TRICKLE_CHUNK)
        probe_placed = sched.schedule_pending()
    finally:
        sched_mod.schedule_round = round_fn
    if check_bindings(api, store) != TRICKLE_PODS + probe_placed:
        fail("trickle: the store's bindings do not match the placements")
    if launches < rounds or sched.wave_path() != "cuda":
        fail(f"trickle: {launches} kernel launches in {rounds} rounds, "
             f"wave_path {sched.wave_path()!r}")
    log(f"[trickle] {FULL_NODES} nodes (DRIVER_SUITE: 500), {TRICKLE_PODS} "
        f"pods in chunks of {TRICKLE_CHUNK}: placed {placed} in {wall:.3f} s "
        f"= {placed / wall:.1f} pods/s; p99 pod_scheduling_latency "
        f"{p99:.4f} s, p99 e2e_scheduling_latency (a round) "
        f"{p99_round:.4f} s; {rounds} rounds, taint/port launches "
        f"{launches}, what-if launches {whatif_launches}; implicit host "
        f"syncs in one round: {sum(syncs.values())} (" + ", ".join(
            f"{k} x{v}" for k, v in sorted(syncs.items())) + f"); probe "
        f"chunk placed {probe_placed}; {spread_line(chunk_s)}; {gcw.count} "
        f"full garbage collections, {gcw.seconds:.3f} s; phase "
        f"{time.monotonic() - t_phase:.1f} s")
    rest = {k: v - first.get(k, 0.0) for k, v in clock.seconds.items()}
    log("[trickle] host seconds by phase, first chunk: " + ", ".join(
        f"{k} {v:.3f}" for k, v in first.items()) + "; the other "
        f"{len(chunk_s) - 1} chunks: " + ", ".join(
        f"{k} {v:.3f}" for k, v in rest.items()))
    return dict(launches=launches, whatif_launches=whatif_launches)


def paced_phase(torch, mods, enc, bucket_size, Metrics):
    """Phase 11: bench.py paced (5 000 nodes, PACED_PODS pods offered at
    200 pods/s in chunks of 100, on the wall clock). Returns
    what it saw."""
    api, tp, pre = mods[0], mods[1], mods[2]
    t_phase = time.monotonic()
    store, sched = warmed_scheduler(mods, enc, bucket_size, Metrics,
                                    FULL_NODES, PACED_PODS)
    tp.taint_ports_masks.launches = 0
    pre.preempt_whatif.launches = 0
    interval = PACED_CHUNK / PACED_RATE
    made = placed = 0
    chunk_s = []
    t0 = time.monotonic()
    next_tick = t0
    with GcWatch() as gcw:
        while made < PACED_PODS:
            now = time.monotonic()
            if now < next_tick:
                time.sleep(next_tick - now)
            n = min(PACED_CHUNK, PACED_PODS - made)
            add_chunk(api, store, "paced-pod", made, n)
            made += n
            next_tick += interval
            t_chunk = time.monotonic()
            placed += sched.schedule_pending()
            chunk_s.append(time.monotonic() - t_chunk)
        stalled = 0
        while placed < PACED_PODS:
            time.sleep(0.002)
            n = sched.schedule_pending()
            placed += n
            # an unplaceable remainder makes no progress: fail, not spin
            stalled = stalled + 1 if n == 0 else 0
            if stalled > 2000:
                fail(f"paced: the drain stalled at {placed} of {PACED_PODS}")
        torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = tp.taint_ports_masks.launches
    whatif_launches = pre.preempt_whatif.launches
    if check_bindings(api, store) != PACED_PODS:
        fail("paced: the store's bindings do not match the placements")
    if launches < 1 or sched.wave_path() != "cuda":
        fail(f"paced: {launches} kernel launches, wave_path "
             f"{sched.wave_path()!r}")
    m = sched.metrics
    p99 = m.pod_scheduling_latency.quantile(0.99)
    log(f"[paced] {FULL_NODES} nodes, {PACED_PODS} pods offered at "
        f"{PACED_RATE:.0f} pods/s in chunks of {PACED_CHUNK}: placed "
        f"{placed} in {wall:.3f} s, achieved {PACED_PODS / wall:.1f} pods/s "
        f"offered; p99 pod_scheduling_latency {p99:.4f} s against the "
        f"{PACED_SLO_S:.0f} s SLO ({'met' if p99 <= PACED_SLO_S else 'MISSED'}"
        f"); p50 {m.pod_scheduling_latency.quantile(0.5):.4f} s, max "
        f"{m.pod_scheduling_latency.max:.4f} s; "
        f"{m.e2e_scheduling_latency.total} rounds, taint/port launches "
        f"{launches}, what-if launches {whatif_launches}; "
        f"{spread_line(chunk_s)}; {gcw.count} full garbage collections, "
        f"{gcw.seconds:.3f} s; phase {time.monotonic() - t_phase:.1f} s")
    return dict(launches=launches, whatif_launches=whatif_launches)


def preempt_host_world(mods, enc, bucket_size, Metrics, device):
    """Phase 12's run on `device`: bench.py run_preempt_config at its own
    size with device_preemption = False — 50 nodes, 100 hogs of 8 cores at
    priority 1, a warm-up, then 100 vips of 8 cores at priority 100, wave
    16, PodBackoff(initial=0.001), on a virtual clock stepped 2 ms between
    passes. Returns (bindings, evicted names, vip wall seconds, taint/port
    launches, what-if launches, scheduler) of the vips' drain."""
    api, tp, pre, Scheduler, PodBackoff = (mods[0], mods[1], mods[2],
                                           mods[5], mods[6])
    store_mod = mods[-1]
    clock = VirtualClock()
    nodes, vips, wave = (HOST_PREEMPT_NODES, HOST_PREEMPT_VIPS,
                         HOST_PREEMPT_WAVE)
    store = store_mod.ObjectStore()
    caps = enc.Caps(M=bucket_size(2 * nodes + vips + 64), P=wave,
                    LV=bucket_size(nodes + 256, 64))
    sched = Scheduler(store, wave_size=wave, caps=caps, device=device,
                      clock=clock, backoff=PodBackoff(initial=0.001,
                                                      clock=clock))
    sched.device_preemption = False
    add_plain_nodes(api, store, nodes)
    add_singles(api, store, "hog", 2 * nodes, 8, 1)
    if settle(sched, clock) != 2 * nodes:
        fail("preempt_host: the hogs did not all place")
    warm_up(api, store, sched, Metrics, wave, min(-(-vips // wave), 128))
    created = {p.metadata.name for p in store.list("pods")}
    add_singles(api, store, "vip", vips, 8, 100)
    tp.taint_ports_masks.launches = 0
    pre.preempt_whatif.launches = 0
    t0 = time.monotonic()
    done = sched.schedule_pending()
    stalled = 0
    while done < vips:
        clock.t += 0.002
        n = sched.schedule_pending()
        done += n
        stalled = stalled + 1 if n == 0 else 0
        if stalled > 2000:
            fail(f"preempt_host ({device}): stalled at {done} of {vips}")
    if device == "cuda":
        import torch

        torch.cuda.synchronize()
    wall = time.monotonic() - t0
    check_bindings(api, store)
    evicted = sorted(created - {p.metadata.name for p in store.list("pods")})
    return (bindings(store), evicted, wall, tp.taint_ports_masks.launches,
            pre.preempt_whatif.launches, sched)


def preempt_host_phase(torch, mods, enc, bucket_size, Metrics):
    """Phase 12: the preempt_host shape on the card, then on the CPU."""
    t_phase = time.monotonic()
    got, wall, launches, whatif_launches, sched = {}, 0.0, 0, 0, None
    for device in ("cuda", "cpu"):
        b, evicted, w, tl, wl, s = preempt_host_world(
            mods, enc, bucket_size, Metrics, device)
        got[device] = (b, evicted)
        if device == "cuda":
            wall, launches, whatif_launches, sched = w, tl, wl, s
    binds, evicted = got["cuda"]
    vips = [n for n in binds if n.startswith("vip-")]
    if len(vips) != HOST_PREEMPT_VIPS or not all(binds[n] for n in vips):
        fail("preempt_host: a vip is not bound")
    if len(evicted) != HOST_PREEMPT_VIPS or evictions(sched) != len(evicted):
        fail(f"preempt_host: {len(evicted)} pods gone, {evictions(sched)} "
             f"counted as evicted; expected {HOST_PREEMPT_VIPS}")
    if not all(n.startswith("hog-") for n in evicted):
        fail("preempt_host: a victim is not a priority-1 hog")
    if whatif_launches != 0 or launches < 1:
        fail(f"preempt_host: what-if launches {whatif_launches} (expected "
             f"0), taint/port launches {launches}")
    if got["cuda"] != got["cpu"]:
        a, b = got["cuda"][0], got["cpu"][0]
        diff = sorted(k for k in set(a) | set(b) if a.get(k) != b.get(k))
        fail(f"preempt_host: card and CPU differ (pods {diff[:5]})")
    log(f"[preempt_host] {HOST_PREEMPT_NODES} nodes, wave "
        f"{HOST_PREEMPT_WAVE}, device_preemption False: {HOST_PREEMPT_VIPS} "
        f"vips in {wall:.3f} s = {HOST_PREEMPT_VIPS / wall:.1f} pods/s; "
        f"{len(evicted)} evicted, all hogs; {sched.pipeline_preemptions} "
        f"pipeline preemptions; what-if launches {whatif_launches}, "
        f"taint/port launches {launches}; card == CPU bindings and victim "
        f"sets; phase {time.monotonic() - t_phase:.1f} s")
    return dict(launches=launches, whatif_launches=whatif_launches)


# --- volumes and profiles (phases 5 and 13) ------------------------------------


def zone_affinity(api, lbl, zone):
    """The node affinity of a zoned PV: the nodes of that zone."""
    return api.NodeSelector(node_selector_terms=[api.NodeSelectorTerm(
        match_expressions=[lbl.Requirement(ZONE, lbl.IN, (zone,))])])


def zoned_pv(api, lbl, name, zone, gi):
    """A GCE PD PV of StorageClass `zonal` in `zone`: its zone label and
    the node affinity of that zone."""
    return api.PersistentVolume(
        metadata=api.ObjectMeta(name=name, labels={ZONE: zone}),
        spec=api.PersistentVolumeSpec(
            source_kind=GCE_PD, source_id=f"pd-{name}",
            capacity={"storage": gi * GI}, storage_class_name="zonal",
            node_affinity=zone_affinity(api, lbl, zone)))


def claim(api, name, volume_name="", cls="zonal", gi=10):
    """A claim bound to `volume_name`, or unbound and bound by the
    scheduler at commit (WaitForFirstConsumer)."""
    return api.PersistentVolumeClaim(
        metadata=api.ObjectMeta(name=name),
        spec=api.PersistentVolumeClaimSpec(
            volume_name=volume_name, storage_class_name=cls,
            volume_binding_mode=("Immediate" if volume_name
                                 else "WaitForFirstConsumer"),
            requests={"storage": gi * GI}))


def disk_pod(api, name, claims=(), disks=(), owner=None, node=None,
             limits=False):
    """bench.py's density pod (100m / 128Mi) with a volume per claim name
    and a read-write inline GCE PD per disk name; owner: the StatefulSet
    that controls it (labelled app=<owner>), else the density RC; node:
    a hostname nodeSelector; limits: 1 CPU and 1Gi of limits."""
    p = batch_pod(api, name, "density", "100m", None)
    p.spec.volumes = (
        [api.Volume(name=c, pvc_name=c) for c in claims]
        + [api.Volume(name=f"disk-{i}", source_kind=GCE_PD, source_id=d)
           for i, d in enumerate(disks)])
    if owner is not None:
        p.metadata.labels = {"app": owner}
        p.metadata.owner_references = [api.OwnerReference(
            kind="StatefulSet", name=owner, uid=f"ss-{owner}",
            controller=True)]
    if node is not None:
        p.spec.node_selector = {HOSTNAME: node}
    if limits:
        p.spec.containers[0].resources.limits = api.resource_list(
            cpu="1", memory="1Gi")
    return p


def volume_checks(store, pd_limit=True) -> dict:
    """The volume invariants, read back from the store: every bound pod
    whose claim's PV carries a zone sits in that zone; no PV is bound to
    two claims; with pd_limit, no node holds more than GCE_PD_LIMIT GCE
    PDs (pods placed in one wave are checked against the wave's start,
    as in the reference, so a world that aims disks at a node may pass
    it). Returns claim -> PV."""
    nodes = {n.metadata.name: n for n in store.list("nodes")}
    pvs = {v.metadata.name: v for v in store.list("persistentvolumes")}
    claims = {c.metadata.name: c.spec.volume_name
              for c in store.list("persistentvolumeclaims")}
    taken = [v for v in claims.values() if v]
    if len(taken) != len(set(taken)):
        fail("a PV is bound to two claims")
    pds = {}
    for p in store.list("pods"):
        if not p.spec.node_name:
            continue
        zone = nodes[p.spec.node_name].metadata.labels.get(ZONE)
        for v in p.spec.volumes:
            pv = pvs.get(claims.get(v.pvc_name, "")) if v.pvc_name else None
            want = pv.metadata.labels.get(ZONE) if pv is not None else None
            if want is not None and want != zone:
                fail(f"{p.metadata.name} on {p.spec.node_name} ({zone}) "
                     f"uses a PV of {want}")
            pd = (pv.spec.source_id if pv is not None
                  and pv.spec.source_kind == GCE_PD else
                  v.source_id if v.source_kind == GCE_PD else None)
            if pd:
                pds.setdefault(p.spec.node_name, set()).add(pd)
    worst = max((len(v) for v in pds.values()), default=0)
    if pd_limit and worst > GCE_PD_LIMIT:
        fail(f"a node holds {worst} GCE PDs, over {GCE_PD_LIMIT}")
    return claims


def messages(store) -> dict:
    """pod name -> its PodScheduled condition (the FitError message)."""
    return {p.metadata.name: dict(p.status.conditions).get("PodScheduled")
            for p in store.list("pods")}


def volume_world(mods, enc, bucket_size, lbl, FeatureGates, device, ecache):
    """Phase 5's volumes world on `device`, on a virtual clock, the
    VolumeScheduling gate on and the equivalence cache as `ecache` says:
    SMALL_NODES plain nodes and SMALL_PODS pods in one backlog — VOL_BOUND
    on claims bound to zoned PVs; VOL_WFFC on their own unbound claims of
    5-10 Gi against VOL_FREE_PVS free PVs of 10, 20 and 50 Gi in two of
    the three zones (the pods contend and commits lose); VOL_SHARED with
    a read-write inline PD of one of 4 shared names (NoDiskConflict);
    PD_NODES nodes each aimed at by one pod of 3 PDs a wave, past the 16
    PDs (MaxGCEPDVolumeCount); one pod on a claim whose class has no PV
    (VolumeBindingNoMatch); density pods for the rest. Returns (bindings,
    claim -> PV, PodScheduled messages, ecache (hits, misses), host-mask
    seconds, pods placed)."""
    import numpy as np

    api, Scheduler, store_mod = mods[0], mods[5], mods[-1]
    rng = np.random.RandomState(SEED)
    clock = VirtualClock()
    store = store_mod.ObjectStore()
    caps = enc.Caps(M=bucket_size(SMALL_PODS + 64), P=WAVE,
                    LV=bucket_size(SMALL_NODES + 256, 64))
    gates = {"VolumeScheduling": True}
    if ecache:
        gates["EnableEquivalenceClassCache"] = True
    sched = Scheduler(store, wave_size=WAVE, caps=caps, device=device,
                      clock=clock, features=FeatureGates(gates))
    add_plain_nodes(api, store, SMALL_NODES)
    for k in range(VOL_FREE_PVS):
        store.create("persistentvolumes", zoned_pv(
            api, lbl, f"pv-free-{k}", f"zone-{k % 2}",
            (10, 20, 50)[rng.randint(3)]))
    pods = []
    for k in range(VOL_BOUND):
        name = f"pv-bound-{k}"
        store.create("persistentvolumes", zoned_pv(
            api, lbl, name, f"zone-{rng.randint(3)}", 20))
        store.create("persistentvolumeclaims",
                     claim(api, f"data-b{k}", volume_name=name))
        pods.append(disk_pod(api, f"bound-{k}", claims=[f"data-b{k}"],
                             owner="db"))
    for k in range(VOL_WFFC):
        store.create("persistentvolumeclaims", claim(
            api, f"data-u{k}", gi=int(rng.randint(5, 11))))
        pods.append(disk_pod(api, f"wffc-{k}", claims=[f"data-u{k}"],
                             owner="web"))
    for k in range(VOL_SHARED):
        pods.append(disk_pod(api, f"shared-{k}", disks=[f"shared-{k % 4}"]))
    store.create("persistentvolumeclaims",
                 claim(api, "orphan", cls="none"))
    pods.append(disk_pod(api, "orphan", claims=["orphan"]))
    while len(pods) < SMALL_PODS - PD_NODES * 6:
        pods.append(disk_pod(api, f"density-{len(pods)}"))
    rng.shuffle(pods)
    # the aimed pods, one a node in each of six waves: the sixth brings a
    # node to 18 PDs
    for w in range(6):
        for n in range(PD_NODES):
            pods.insert(w * WAVE + n, disk_pod(
                api, f"aimed-{n}-{w}", node=f"node-{n}",
                disks=[f"aimed-{n}-{w}-{d}" for d in range(3)]))
    for p in pods:
        store.create("pods", p)
    host = {"seconds": 0.0}
    mask = sched._host_plugin_mask

    def timed(*a, **kw):
        t0 = time.monotonic()
        try:
            return mask(*a, **kw)
        finally:
            host["seconds"] += time.monotonic() - t0

    sched._host_plugin_mask = timed
    placed = settle(sched, clock, limit=3)
    check_bindings(api, store)
    claims = volume_checks(store, pd_limit=False)
    ec = ((sched.ecache.hits, sched.ecache.misses)
          if sched.ecache is not None else None)
    return (bindings(store), claims, messages(store), ec, host["seconds"],
            placed)


def policy_world(mods, enc, bucket_size, Registry, device):
    """Phase 5's policy world on `device`, on a virtual clock: SMALL_NODES
    nodes, two in three labelled gpu=yes and one in four ssd=1, and
    SMALL_PODS density pods, one in three with limits, under POLICY (a
    labelsPresence filter; labelPreference and ResourceLimitsPriority as
    host scores through extra_scores; LeastRequestedPriority at weight
    0): every wave takes the per-wave path. Returns (bindings, pods
    placed, per-wave dispatches)."""
    api, Scheduler, store_mod = mods[0], mods[5], mods[-1]
    clock = VirtualClock()
    store = store_mod.ObjectStore()
    caps = enc.Caps(M=bucket_size(SMALL_PODS + 64), P=WAVE,
                    LV=bucket_size(SMALL_NODES + 256, 64))
    sched = Scheduler(store, wave_size=WAVE, caps=caps, device=device,
                      clock=clock,
                      profile=Registry().profile_from_policy(POLICY, store))
    add_plain_nodes(api, store, SMALL_NODES, extra_labels=lambda i: dict(
        ({"gpu": "yes"} if i % 3 else {}), **({"ssd": "1"} if i % 4 == 1
                                               else {})))
    for j in range(SMALL_PODS):
        store.create("pods", disk_pod(api, f"pod-{j}", limits=j % 3 == 0))
    waves = {"n": 0}
    run_wave = sched._run_wave

    def counted(pods):
        waves["n"] += 1
        return run_wave(pods)

    sched._run_wave = counted
    placed = settle(sched, clock, limit=3)
    check_bindings(api, store)
    labels = {n.metadata.name: n.metadata.labels for n in store.list("nodes")}
    if any(p.spec.node_name and "gpu" not in labels[p.spec.node_name]
           for p in store.list("pods")):
        fail("policy: a pod is bound to a node without the gpu label")
    return bindings(store), placed, waves["n"]


def statefulset_phase(torch, mods, enc, bucket_size, lbl, filters,
                      FeatureGates, wave_s):
    """Phase 13: StatefulSets with claims beside density pods at 5 000
    nodes, the VolumeScheduling gate on. wave_s: the seconds of one
    per-wave dispatch the cut rule projects with. Returns what it saw."""
    import numpy as np

    api, tp, pre, kernel_mod, sched_mod, Scheduler, PodBackoff, store_mod = mods
    t_phase = time.monotonic()
    rng = np.random.RandomState(SEED)
    store = store_mod.ObjectStore()
    n_ss = SS_SETS * SS_REPLICAS
    caps = enc.Caps(M=bucket_size(SS_DENSITY + n_ss + 64), P=WAVE,
                    LV=bucket_size(FULL_NODES + 256, 64))
    sched = Scheduler(store, wave_size=WAVE, caps=caps, device="cuda",
                      backoff=PodBackoff(initial=0.001),
                      features=FeatureGates({"VolumeScheduling": True}))
    add_plain_nodes(api, store, FULL_NODES)
    for k in range(SS_FREE_PVS):
        store.create("persistentvolumes", zoned_pv(
            api, lbl, f"pv-free-{k}", f"zone-{k % 3}",
            (10, 20, 50)[rng.randint(3)]))
    sets = [f"set-{s}" for s in range(SS_SETS)]
    # even replicas on a claim bound to a zoned PV, odd ones on an unbound
    # WaitForFirstConsumer claim of 5-10 Gi (every free PV holds it)
    for s in sets:
        for i in range(SS_REPLICAS):
            name = f"data-{s}-{i}"
            if i % 2 == 0:
                store.create("persistentvolumes", zoned_pv(
                    api, lbl, f"pv-{s}-{i}", f"zone-{rng.randint(3)}", 20))
                store.create("persistentvolumeclaims",
                             claim(api, name, volume_name=f"pv-{s}-{i}"))
            else:
                store.create("persistentvolumeclaims", claim(
                    api, name, gi=int(rng.randint(5, 11))))

    def ss_pod(s, i):
        return disk_pod(api, f"{s}-{i}", claims=[f"data-{s}-{i}"], owner=s)

    # the cut rule: the host mask of a few of the pods, per pod, times the
    # StatefulSet pods and the wave the pipeline's bail-out masks again;
    # one dispatch a wave; the seconds spent so far
    probe = [ss_pod(sets[0], i) for i in range(SS_PROBE_PODS)]
    t0 = time.monotonic()
    sched._host_plugin_mask(probe, len(probe))
    per_pod = (time.monotonic() - t0) / len(probe)

    def project(n):
        waves = -(-(SS_DENSITY + n) // WAVE)
        return (time.monotonic() - t_phase + per_pod * (n + WAVE)
                + wave_s * waves)

    replicas = SS_REPLICAS
    projected = project(n_ss)
    while (project(SS_SETS * replicas) > SS_PHASE_BUDGET_S
           and SS_SETS * replicas // 2 >= SS_MIN_PODS):
        replicas //= 2
    for s in sets:
        for i in range(replicas, SS_REPLICAS):
            store.delete("persistentvolumeclaims", "default",
                         f"data-{s}-{i}")
            if i % 2 == 0:
                store.delete("persistentvolumes", "default", f"pv-{s}-{i}")
    n_ss = SS_SETS * replicas
    log(f"[statefulset] host mask {1e3 * per_pod:.1f} ms a pod at "
        f"{FULL_NODES} nodes ({SS_PROBE_PODS} probed), a dispatch "
        f"{wave_s:.3f} s: the phase projects to {projected:.1f} s with "
        f"{SS_SETS * SS_REPLICAS} StatefulSet pods; {n_ss} run"
        + ("" if replicas == SS_REPLICAS else
           f" (cut from {SS_SETS * SS_REPLICAS})"))
    for s in sets:
        store.create("statefulsets", api.StatefulSet(
            metadata=api.ObjectMeta(name=s),
            selector=lbl.LabelSelector(match_labels={"app": s})))
    add_singles(api, store, "density", SS_DENSITY, "100m", None)
    for s in sets:
        for i in range(replicas):
            store.create("pods", ss_pod(s, i))
    # instruments: host phases, per-wave dispatches, rounds, bail-outs,
    # the kernel's inputs, the syncs of one volume wave and one density
    # wave
    clock = PhaseClock()
    sync = torch.cuda.synchronize
    sched.featurizer.featurize = clock.wrap("featurize",
                                            sched.featurizer.featurize)
    sched.snapshot.stage_pending = clock.wrap(
        "stage", sched.snapshot.stage_pending)
    sched.snapshot.to_device = clock.wrap("upload", sched.snapshot.to_device,
                                          sync)
    sched._commit = clock.wrap("commit", sched._commit)
    sched._host_plugin_mask = clock.wrap("host_mask", sched._host_plugin_mask)
    sched.volume_binder.bind_pod_volumes = clock.wrap(
        "volume_bind", sched.volume_binder.bind_pod_volumes)
    seen = {"dispatches": 0, "rounds": 0, "passes": 0, "bailouts": 0,
            "captured": {}, "syncs": {}}
    saved = {name: getattr(sched_mod, name)
             for name in ("schedule_wave", "schedule_round")}
    kernel_launch = filters.taint_ports_masks

    def wave(*a, **kw):
        seen["dispatches"] += 1
        return saved["schedule_wave"](*a, **kw)

    def round_(*a, **kw):
        seen["rounds"] += 1
        return saved["schedule_round"](*a, **kw)

    run_pipeline, run_wave = sched._run_pipeline, sched._run_wave

    def pipeline(pods, **kw):
        rounds = seen["rounds"]
        seen["passes"] += 1
        out = run_pipeline(pods, **kw)
        seen["bailouts"] += seen["rounds"] == rounds
        return out

    def per_wave(pods):
        kind = ("volume" if any(p.spec.volumes for p in pods)
                else "density")
        if kind in seen["syncs"]:
            return run_wave(pods)
        out, where = count_syncs(torch, lambda: run_wave(pods))
        seen["syncs"][kind] = where
        return out

    sched._run_pipeline, sched._run_wave = pipeline, per_wave
    sched_mod.schedule_wave = clock.wrap("wave_dispatch", wave, sync)
    sched_mod.schedule_round = clock.wrap("device_round", round_, sync)
    filters.taint_ports_masks = capturing(kernel_launch, seen["captured"])
    tp.taint_ports_masks.launches = 0
    pre.preempt_whatif.launches = 0
    bound_before = sum(1 for c in store.list("persistentvolumeclaims")
                       if c.spec.volume_name)
    try:
        t0 = time.monotonic()
        placed = settle(sched)
        sync()
        wall = time.monotonic() - t0
        launches = tp.taint_ports_masks.launches
        whatif_launches = pre.preempt_whatif.launches
    finally:
        for name, fn in saved.items():
            setattr(sched_mod, name, fn)
        filters.taint_ports_masks = kernel_launch
    want = SS_DENSITY + n_ss
    if placed != want:
        fail(f"statefulset: placed {placed} of {want} pods")
    if check_bindings(api, store) != want:
        fail("statefulset: the store does not hold every pod bound")
    claims = volume_checks(store)
    if not all(claims.values()):
        fail("statefulset: a claim is unbound")
    for s in sets:
        for i in range(0, replicas, 2):
            if claims[f"data-{s}-{i}"] != f"pv-{s}-{i}":
                fail(f"statefulset: data-{s}-{i} left its PV")
    if launches < 1 or sched.wave_path() != "cuda":
        fail(f"statefulset: taint/port launches {launches}, wave_path "
             f"{sched.wave_path()!r}")
    if seen["bailouts"] < 1 or seen["dispatches"] < 1:
        fail(f"statefulset: {seen['bailouts']} pipeline bail-outs, "
             f"{seen['dispatches']} per-wave dispatches")
    err = check_captured(torch, tp, "statefulset", seen["captured"])
    phases = dict(clock.seconds)
    # volume_bind runs inside commit
    phases["commit"] -= phases.get("volume_bind", 0.0)
    phases["other"] = wall - sum(phases.values())
    newly = sum(1 for v in claims.values() if v) - bound_before
    log(f"[statefulset] {FULL_NODES} nodes, {SS_DENSITY} density and {n_ss} "
        f"StatefulSet pods ({SS_SETS} sets), {SS_FREE_PVS} free PVs: placed "
        f"{placed} in {wall:.3f} s = {placed / wall:.1f} pods/s; pipeline "
        f"passes {seen['passes']}, bail-outs {seen['bailouts']}, rounds "
        f"{seen['rounds']}; per-wave dispatches {seen['dispatches']}; "
        f"taint/port launches {launches}, what-if launches "
        f"{whatif_launches}; claims bound at commit {newly}, "
        f"{sum(1 for v in claims.values() if v)} of {len(claims)} claims "
        "bound; invariants hold")
    log(f"[statefulset] host seconds by phase: " + ", ".join(
        f"{k} {v:.3f}" for k, v in phases.items()))
    log(f"[statefulset] host mask {phases.get('host_mask', 0.0) / n_ss:.4f} "
        f"s a StatefulSet pod over the drain")
    for kind, where in sorted(seen["syncs"].items()):
        log(f"[statefulset] implicit host syncs of one {kind} wave: "
            f"{sum(where.values())} (" + ", ".join(
                f"{k} x{v}" for k, v in sorted(where.items())) + ")")
    log(f"[statefulset] phase {time.monotonic() - t_phase:.1f} s")
    return dict(launches=launches, whatif_launches=whatif_launches,
                max_err=err)


# --- phase 14: the flight recorder and the decision observatory -----------------


def strip_uids(x):
    """x with every "uid" key dropped, recursively: the store mints pod
    UIDs from a process-wide counter, so two runs of one world differ in
    them."""
    if isinstance(x, dict):
        return {k: strip_uids(v) for k, v in x.items() if k != "uid"}
    if isinstance(x, list):
        return [strip_uids(v) for v in x]
    return x


def metric_values(metrics, names=TRACED_METRICS) -> dict:
    """The named series of one registry: a histogram's count, sum, bucket
    counts and max, a counter's or gauge's value, a labelled family's
    {series: value}."""
    out = {}
    for name in names:
        m = getattr(metrics, name)
        if hasattr(m, "counts"):
            out[name] = (m.total, m.sum, tuple(m.counts), m.max)
        elif hasattr(m, "children"):
            out[name] = {c.name: c.value for c in m.children()}
        else:
            out[name] = m.value
    return out


def dispatch_totals(metrics) -> dict:
    """Dispatches a program (device_jit_events, hits and misses)."""
    out = {}
    for (program, _bucket, _event), c in \
            metrics.device_jit_events._children.items():
        out[program] = out.get(program, 0) + int(c.value)
    return out


def profile_obj(api, name, table, role="candidate"):
    return api.WeightProfile(
        metadata=api.ObjectMeta(name=name),
        spec=api.WeightProfileSpec(weights=dict(table), role=role))


def default_table(weights_mod, stack, base):
    """The default weights as a WeightProfile table (the non-zero planes:
    unnamed planes are 0)."""
    vec = weights_mod.stack_weights(base)
    return {n: float(vec[s]) for s, n in enumerate(stack)
            if weights_mod.WEIGHT_FIELDS[n] is not None and vec[s]}


def telemetry_bound(nt, Z, packed_len):
    """(least ms, what bounds it, bytes, float ops) of one telemetry
    reduction: its inputs read once (valid, alloc, requested, zone_id,
    cond, pod_count, allowed_pods, the shape requests) and the packed
    vector written once, over HBM bandwidth; its f32 work (per node and
    resource: the masks, free, the three trees, the two trees and masks
    of each zone, the fraction and its bin; per shape and node and
    resource: the fit) over the 67 TFLOP/s float32 peak."""
    N, R = nt.alloc.shape
    C = nt.cond.shape[1]
    K = 4  # CANONICAL_SHAPES
    nbytes = (N * (1 + 8 * R + 4 + C + 8) + 4 * K * R + 4 * packed_len)
    ops = N * R * (6 + 4 * Z + 4) + K * N * R * 2
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / 67e12 * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes, ops)


def check_decisions(rec, sched, weights_mod, stack) -> int:
    """Every decision's chosen parts re-add, by the shadow pass's
    `_f32_totals` under its own weights, to its total; every `top` list
    runs by total, highest first, the lower node index first on ties.
    Returns the decisions checked."""
    import numpy as np

    index = sched.snapshot.node_index
    n = 0
    for uid, e in list(rec.decisions.items()):
        w = np.asarray(e["weights"], np.float32)
        parts = np.asarray([e["parts"][name]["chosen"] for name in stack],
                           np.float32)
        total = weights_mod._f32_totals(w, parts[:, None])[0]
        if round(float(total), 4) != e["total"]:
            fail(f"traced: {e['pod']}'s parts re-add to {float(total)}, "
                 f"not its total {e['total']}")
        top = [(t["total"], index[t["node"]]) for t in e["top"]]
        for (t0, i0), (t1, i1) in zip(top, top[1:]):
            if t1 > t0 or (t1 == t0 and i1 < i0):
                fail(f"traced: {e['pod']}'s top list is out of order: {top}")
        n += 1
    return n


def traced_world(mods, enc, bucket_size, Scheduler, PodBackoff, tracing,
                 tele, device):
    """Phase 14's card == CPU world on `device`, traced, on a virtual
    clock: SMALL_NODES nodes and SMALL_PODS density pods, a gang of
    GANG_SIZE, a priority-1000 pod that fits only by evicting the hog
    bound on node-0, a pod whose inline disk a pod bound on node-1 holds
    (the host filter sends the pass to the per-wave loop), a bin-packing
    candidate profile and shadow_exact_interval=1. The hog and the disk
    holder sit on the first two untainted nodes. Returns what is
    compared."""
    api, store_mod = mods[0], mods[-1]
    tracing.disable()
    rec = tracing.enable()
    try:
        store, n_bound = build_store(api, store_mod, SMALL_NODES, SMALL_PODS,
                                     SEED)
        free = [n.metadata.name for n in store.list("nodes")
                if not n.spec.taints][:2]
        hog = batch_pod(api, "hog", "hog", "15", 0)
        hog.spec.node_name = free[0]
        store.create("pods", hog)
        holder = disk_pod(api, "disk-holder", disks=["pd-shared"])
        holder.spec.node_name = free[1]
        store.create("pods", holder)
        store.create("weightprofiles", profile_obj(
            api, "packer", {"MostRequested": 1.0, "BalancedAllocation": 1.0}))
        clock = VirtualClock()
        caps = scheduler_caps(enc, bucket_size, SMALL_NODES,
                              SMALL_PODS + 2 * GANG_SIZE, n_bound + 2)
        sched = Scheduler(store, wave_size=WAVE, caps=caps, device=device,
                          clock=clock,
                          backoff=PodBackoff(initial=0.001, clock=clock),
                          shadow_exact_interval=1)
        settle(sched, clock)
        for j in range(GANG_SIZE):
            store.create("pods", batch_pod(api, f"gang-t-m{j}", "storm-low",
                                           "100m", None, gang="gang-t"))
        vip = batch_pod(api, "vip", "vip", "8", 1000)
        vip.spec.node_selector = {HOSTNAME: free[0]}
        store.create("pods", vip)
        store.create("pods", disk_pod(api, "disk-user", disks=["pd-shared"]))
        settle(sched, clock)
        check_bindings(api, store)
        nt = sched.snapshot.to_device(sched.device)[0]
        packed = tele.cluster_telemetry(
            nt, num_zones=sched.snapshot.caps.Z).cpu()
        rows = [strip_uids({k: v for k, v in r.items()
                            if k not in LEDGER_TIMINGS})
                for r in rec.ledger_rows()]
        decisions = {e["pod"]: strip_uids(e) for e in rec.decisions.values()}
        return {
            "bindings": bindings(store), "ledger": rows,
            "decisions": decisions,
            "report": strip_uids(sched.weightbook.report("packer")),
            "telemetry": packed.view(__import__("torch").int32).tolist(),
            "metrics": metric_values(sched.metrics),
            "dispatches": dispatch_totals(sched.metrics),
            "kinds": sorted({r["kind"] for r in rows}),
            "evicted": int(sched.metrics.pod_preemption_victims.value)}
    finally:
        tracing.disable()


def traced_phase(torch, mods, enc, bucket_size, filters, tele, tracing,
                 weights_mod, stack):
    """Phase 14: the density world (FULL_NODES nodes, TRACED_PODS pods, 16
    waves, one round) drained on fresh schedulers from one seed, A with
    tracing off and B traced with a ledger file, a `live` profile equal
    to the defaults, a bin-packing candidate and a spreading candidate
    (shadow_exact_interval=1); then B promotes the bin-packer and drains
    TRACED_EXTRA more pods, and rolls back (both live profiles deleted:
    the static table) and drains TRACED_EXTRA more. Then the reduced
    traced world on the card and on the CPU. Returns what it saw."""
    import tempfile

    import numpy as np

    api, tp, pre, kernel_mod, sched_mod, Scheduler, PodBackoff, store_mod = mods
    t_phase = time.monotonic()
    sync = torch.cuda.synchronize
    n_total = TRACED_PODS + 2 * TRACED_EXTRA
    seen = {"captured": {}, "rounds": {"A": [], "B": []}, "tag": "A"}
    saved_round = sched_mod.schedule_round
    round_launch = kernel_mod.taint_ports_masks
    wave_launch = filters.taint_ports_masks

    def timed_round(nt_, pm_, tt_, pbs, *a, **kw):
        t0 = time.monotonic()
        out = saved_round(nt_, pm_, tt_, pbs, *a, **kw)
        sync()
        seen["rounds"][seen["tag"]].append(
            (time.monotonic() - t0, int(pbs.valid.sum())))
        return out

    host = {"record_decisions": 0.0, "shadow_exact": 0.0, "telemetry": 0.0}

    def host_timed(name, fn):
        def timed(*a, **kw):
            t0 = time.monotonic()
            out = fn(*a, **kw)
            host[name] += time.monotonic() - t0
            return out
        return timed

    ledger_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_ledger_"))
    ledger = ledger_dir / "rounds.jsonl"
    store_a, n_bound = build_store(api, store_mod, FULL_NODES, TRACED_PODS,
                                   SEED)
    store_b, _ = build_store(api, store_mod, FULL_NODES, TRACED_PODS, SEED)
    caps = scheduler_caps(enc, bucket_size, FULL_NODES, n_total, n_bound)
    base = sched_mod.default_profile(store_b).weights()
    same = default_table(weights_mod, stack, base)
    packer = dict(same, MostRequested=2.0)
    packer.pop("LeastRequested")
    spreader = dict(same, BalancedAllocation=3.0)
    sched_mod.schedule_round = timed_round
    kernel_mod.taint_ports_masks = capturing(round_launch, seen["captured"])
    filters.taint_ports_masks = capturing(wave_launch, seen["captured"])
    tp.taint_ports_masks.launches = 0
    pre.preempt_whatif.launches = 0
    try:
        tracing.disable()
        sched_a = Scheduler(store_a, wave_size=WAVE, caps=caps,
                            device="cuda")
        t0 = time.monotonic()
        placed_a = sched_a.schedule_pending()
        sync()
        wall_a = time.monotonic() - t0
        rec = tracing.enable(ledger_path=str(ledger))
        seen["tag"] = "B"
        for name, table, role in (("same", same, "live"),
                                  ("packer", packer, "candidate"),
                                  ("spreader", spreader, "candidate")):
            store_b.create("weightprofiles",
                           profile_obj(api, name, table, role))
        sched_b = Scheduler(store_b, wave_size=WAVE, caps=caps,
                            device="cuda", shadow_exact_interval=1)
        for name, attr in (("record_decisions", "_record_decisions"),
                           ("shadow_exact", "_shadow_exact_sample"),
                           ("telemetry", "_emit_telemetry")):
            setattr(sched_b, attr, host_timed(name, getattr(sched_b, attr)))
        versions = [sched_b.weightbook.live_version()]
        t0 = time.monotonic()
        placed_b = sched_b.schedule_pending()
        sync()
        wall_b = time.monotonic() - t0
        # the ledger rows of each stage
        stages = [len(rec.ledger_rows())]
        if bindings(store_b) != bindings(store_a):
            a, b = bindings(store_a), bindings(store_b)
            diff = [k for k in a if a[k] != b.get(k)]
            fail(f"traced: traced bindings differ from untraced for "
                 f"{len(diff)} pods, e.g. {diff[:5]}")
        seen["tag"] = "B+"
        seen["rounds"]["B+"] = []
        wp = store_b.get("weightprofiles", "default", "packer")
        wp.spec.role = "live"
        store_b.update("weightprofiles", wp)
        versions.append(sched_b.weightbook.live_version())
        add_singles(api, store_b, "swap", TRACED_EXTRA, "100m", None)
        placed_b += sched_b.schedule_pending()
        stages.append(len(rec.ledger_rows()))
        for name in ("packer", "same"):
            store_b.delete("weightprofiles", "default", name)
        versions.append(sched_b.weightbook.live_version())
        add_singles(api, store_b, "rollback", TRACED_EXTRA, "100m", None)
        placed_b += sched_b.schedule_pending()
        stages.append(len(rec.ledger_rows()))
        sync()
        launches = tp.taint_ports_masks.launches
        whatif_launches = pre.preempt_whatif.launches
    finally:
        sched_mod.schedule_round = saved_round
        kernel_mod.taint_ports_masks = round_launch
        filters.taint_ports_masks = wave_launch
        tracing.disable()
    if placed_b != placed_a + 2 * TRACED_EXTRA or placed_a < TRACED_PODS // 2:
        fail(f"traced: placed {placed_a} untraced and {placed_b} traced of "
             f"{TRACED_PODS} and {n_total}")
    check_bindings(api, store_b)
    if launches < 1 or sched_b.wave_path() != "cuda":
        fail(f"traced: taint/port launches {launches}, wave_path "
             f"{sched_b.wave_path()!r}")
    if not (versions[0].startswith("same@")
            and versions[1].startswith("packer@")
            and versions[2] == "static"):
        fail(f"traced: weights_version went {versions}")
    # every line v2 with its stage's weights_version and telemetry; a
    # round that placed pods has scores, and a pipeline round an exact
    # shadow sample of the candidate loaded throughout
    lines = [json.loads(x) for x in ledger.read_text().splitlines()]
    want = [versions[k] for k in range(3)
            for _ in range(stages[k] - (stages[k - 1] if k else 0))]
    for r, ver in zip(lines, want):
        shape = (r["v"], r["weights_version"], "telemetry" in r,
                 "scores" in r or not r.get("placed"),
                 r["kind"] != "pipeline" or "exact" in (
                     r.get("shadow") or {}).get("spreader", {}))
        if shape != (2, ver, True, True, True):
            fail(f"traced: ledger line (v, weights_version, telemetry, "
                 f"scores, exact shadow) {shape}, expected version {ver}")
    if len(lines) != len(want) or not lines:
        fail(f"traced: {len(lines)} ledger lines for {len(want)} rounds")
    n_dec = check_decisions(rec, sched_b, weights_mod, stack)
    if n_dec != min(placed_b, tracing.MAX_DECISIONS):
        fail(f"traced: {n_dec} decisions recorded")
    tele_errors = sched_b.metrics.scheduling_errors.value(stage="telemetry")
    if tele_errors:
        fail(f"traced: {tele_errors} telemetry failures")
    # the telemetry vector from the card against the CPU on a copy
    Z = sched_b.snapshot.caps.Z
    R = sched_b.snapshot.caps.R
    nt = sched_b.snapshot.to_device(sched_b.device)[0]
    card = tele.cluster_telemetry(nt, num_zones=Z).cpu()
    nt_cpu = nt._replace(**{f: getattr(nt, f).cpu() for f in nt._fields})
    cpu = tele.cluster_telemetry(nt_cpu, num_zones=Z)
    if not torch.equal(card.view(torch.int32), cpu.view(torch.int32)):
        fail("traced: the telemetry vector differs between card and CPU")
    ct = tele.ClusterTelemetry(card.numpy(), R, Z)
    if ct.nodes_valid != FULL_NODES:
        fail(f"traced: telemetry counts {ct.nodes_valid} nodes")
    zone_sum = ct.zone_req.sum(axis=0, dtype=np.float64)
    if not np.allclose(zone_sum, ct.req_total, rtol=1e-6):
        fail(f"traced: zone sums {zone_sum} do not tie out to "
             f"{ct.req_total}")
    tele_ms = cuda_ms(torch, lambda: tele.cluster_telemetry(nt, num_zones=Z),
                      reps=10, warm=2, runs=3)
    t_bound, t_by, t_bytes, t_ops = telemetry_bound(
        nt, Z, tele.packed_len(R, Z))
    # the syncs of one untraced and one traced wave: 128 new density
    # pods on the drained cluster
    pods = [batch_pod(api, f"probe-{i}", "density", "100m", None)
            for i in range(WAVE)]
    dev = sched_b.device
    pb = sched_b.featurizer.featurize(pods)
    nt_, pm_, tt_ = sched_b.snapshot.to_device(dev)
    pbt = enc.to_torch(None, None, None, pb, dev)[3]
    gating, wvec, _ = sched_b._weights_kw()
    extra = torch.ones((WAVE, nt_.valid.shape[0]), dtype=torch.bool,
                       device=dev)
    rr = torch.zeros((), dtype=torch.int32, device=dev)
    wv = enc.weight_vec_to_torch(wvec, dev)
    syncs = {}
    for traced in (False, True):
        def one():
            res = kernel_mod.schedule_wave(
                nt_, pm_, tt_, pbt, extra, rr, weights=gating,
                num_zones=Z, num_label_values=sched_b.snapshot
                .num_label_values, has_ts=False, collect_scores=traced,
                weight_vec=wv)
            sync()
            return res
        one()  # warm
        _, syncs[traced] = count_syncs(torch, one)
    err = check_captured(torch, tp, "traced", seen["captured"])
    ms = {tag: 1e3 * sum(t for t, _ in rs) / max(sum(n for _, n in rs), 1)
          for tag, rs in seen["rounds"].items()}
    n_rounds = len(lines)
    log(f"[traced] {FULL_NODES} nodes, {TRACED_PODS} density pods: "
        f"untraced {placed_a} in {wall_a:.3f} s = {placed_a / wall_a:.1f} "
        f"pods/s, traced {TRACED_PODS} in {wall_b:.3f} s = "
        f"{TRACED_PODS / wall_b:.1f} pods/s, bindings equal; then "
        f"{TRACED_EXTRA} after the swap and {TRACED_EXTRA} after the "
        f"rollback; weights_version {' -> '.join(versions)}")
    log(f"[traced] device_round ms a pod: untraced {ms['A']:.4f}, traced "
        f"{ms['B']:.4f} ({ms['B'] / ms['A']:.3f}x); after the swap and "
        f"rollback {ms.get('B+', 0.0):.4f}")
    log(f"[traced] host seconds a round ({n_rounds} traced rounds): "
        + ", ".join(f"{k} {v / n_rounds:.4f}" for k, v in host.items()))
    log(f"[traced] implicit host syncs of one {WAVE}-pod wave: untraced "
        f"{sum(syncs[False].values())} (" + ", ".join(
            f"{k} x{v}" for k, v in sorted(syncs[False].items()))
        + f"), traced {sum(syncs[True].values())} (" + ", ".join(
            f"{k} x{v}" for k, v in sorted(syncs[True].items())) + ")")
    log(f"[traced] telemetry reduction (N={nt.valid.shape[0]}, R={R}, "
        f"Z={Z}): {tele_ms:.4f} ms a call, bound {t_bound:.6f} ms "
        f"({t_by}: {t_bytes} B, {t_ops} float ops); card == CPU bit for "
        f"bit, {ct.nodes_valid} nodes, zone sums tie out")
    log(f"[traced] ledger {ledger.stat().st_size / n_rounds:.0f} bytes a "
        f"round ({n_rounds} lines, v2, weights_version, scores, shadow with "
        f"exact, telemetry); {n_dec} decisions re-add to their totals and "
        "rank their top lists; 0 telemetry failures; taint/port launches "
        f"{launches}")
    # the ledger stays for phase 22's trainer, which removes it
    untraced = bindings(store_a)
    del store_a, store_b, sched_a, sched_b, nt, nt_, pm_, tt_, pbt
    torch.cuda.empty_cache()
    # card == CPU on the reduced traced world
    got = {}
    for device in ("cuda", "cpu"):
        t0 = time.monotonic()
        got[device] = traced_world(mods, enc, bucket_size, Scheduler,
                                   PodBackoff, tracing, tele, device)
        log(f"[traced] reduced world {device}: kinds {got[device]['kinds']}"
            f", {got[device]['evicted']} evicted, "
            f"{len(got[device]['decisions'])} decisions, world "
            f"{time.monotonic() - t0:.3f} s")
    for key in ("bindings", "ledger", "decisions", "report", "telemetry",
                "metrics", "dispatches"):
        if got["cuda"][key] != got["cpu"][key]:
            a, b = got["cuda"][key], got["cpu"][key]
            diff = (sorted(k for k in set(a) | set(b)
                           if a.get(k) != b.get(k))[:5]
                    if isinstance(a, dict) else "lists differ")
            fail(f"traced: reduced world, card and CPU {key} differ: {diff}")
    kinds = got["cuda"]["kinds"]
    if not {"pipeline", "wave", "gang"} <= set(kinds) or \
            not got["cuda"]["evicted"]:
        fail(f"traced: reduced world ran {kinds}, evicted "
             f"{got['cuda']['evicted']}")
    log(f"[traced] reduced world ({SMALL_NODES} nodes, {SMALL_PODS} pods, a "
        "gang, a preemption, a per-wave pass, a candidate): card == CPU "
        "ledger rows, decisions, shadow report, telemetry, metrics; phase "
        f"{time.monotonic() - t_phase:.1f} s")
    return dict(launches=launches, whatif_launches=whatif_launches,
                max_err=err, ledger=ledger, untraced=untraced,
                untraced_pods_s=placed_a / wall_a)


# --- main ----------------------------------------------------------------------


# --- phases 15 and 16: the cluster-lifecycle controllers ------------------------


def resident_pods(api, store, n_nodes, prefix="res", wait=None,
                  taint_keys=()):
    """AUTOSCALE_RESIDENTS replicated pods of AUTOSCALE_RESIDENT_CPU bound
    on each of the first n_nodes nodes (created bound, as phase 13
    creates its bound pods); wait=S adds the NoExecute not-ready and
    unreachable tolerations (taint_keys) of S seconds that the
    DefaultTolerationSeconds admission plugin stamps on every pod."""
    tolerations = []
    if wait is not None:
        tolerations = [api.Toleration(
            key=k, operator=api.TOLERATION_OP_EXISTS, effect=api.NO_EXECUTE,
            toleration_seconds=wait) for k in taint_keys]
    for i in range(n_nodes):
        for j in range(AUTOSCALE_RESIDENTS):
            p = batch_pod(api, f"{prefix}-{i}-{j}", "resident",
                          AUTOSCALE_RESIDENT_CPU, None)
            p.spec.node_name = f"node-{i}"
            p.spec.tolerations = list(tolerations)
            store.create("pods", p)


def backlog_pod(api, name, tolerate):
    """A batch-job pod of AUTOSCALE_POD_CPU, replicated; tolerate: it
    tolerates the himem group's dedicated=batch:NoSchedule taint."""
    p = batch_pod(api, name, "batch-job" if tolerate else "web",
                  AUTOSCALE_POD_CPU, None)
    if tolerate:
        p.spec.tolerations = [api.Toleration(
            key="dedicated", operator=api.TOLERATION_OP_EQUAL, value="batch",
            effect=api.NO_SCHEDULE)]
    return p


def group_template(api, name, cpu, tainted):
    """A node group's template: `cpu` cores, 8 GiB a core, 110 pods, no
    zone; himem's carries dedicated=batch:NoSchedule."""
    taints = ([api.Taint(key="dedicated", value="batch",
                         effect=api.NO_SCHEDULE)] if tainted else [])
    return api.Node(
        metadata=api.ObjectMeta(name=f"template-{name}"),
        spec=api.NodeSpec(taints=taints),
        status=api.NodeStatus(
            allocatable=api.resource_list(cpu=str(cpu), memory=f"{8 * cpu}Gi",
                                          pods=110,
                                          ephemeral_storage="200Gi"),
            conditions=[api.NodeCondition(api.NODE_READY, api.COND_TRUE)]))


def drain_placing(sched, clock):
    """schedule_pending while it places pods, stepping the virtual clock
    a second between passes (past PodBackoff(initial=0.001)). Returns
    pods placed."""
    placed = 0
    while True:
        n = sched.schedule_pending()
        placed += n
        if n == 0 or not sched.pending_count():
            return placed
        clock.t += 1.0


class Timed:
    """Seconds of the what-if steps of one autoscaler pass, taken by
    wrapping the port's simulate module and the scheduler's featurizer
    hook: shadow build, featurize, and the what-if with its device sync;
    `args` keeps the last what-if's arguments."""

    def __init__(self, simulate, sched, sync):
        self.simulate, self.sched, self.sync = simulate, sched, sync
        self.saved = {n: getattr(simulate, n) for n in (
            "shadow_snapshot", "simulate_placements", "simulate_refit")}
        self.reset()
        self.args = {}

    def reset(self):
        self.s = {"shadow": 0.0, "featurize": 0.0, "whatif": 0.0}
        self.shape = None
        self.calls = 0

    def _timed(self, key, fn, sync=False):
        def run(*a, **kw):
            t0 = time.monotonic()
            out = fn(*a, **kw)
            if sync:
                self.sync()
            self.s[key] += time.monotonic() - t0
            return out
        return run

    def __enter__(self):
        sim, saved = self.simulate, self.saved
        sim.shadow_snapshot = self._timed("shadow", saved["shadow_snapshot"])
        for name in ("simulate_placements", "simulate_refit"):
            def whatif(*a, _fn=self._timed("whatif", saved[name], True),
                       _name=name, **kw):
                self.calls += 1
                self.shape = (a[1].req.shape[0], a[0].caps.N)
                self.args[_name] = (a, kw)
                return _fn(*a, **kw)
            setattr(sim, name, whatif)
        hook = self.sched.shadow_featurizer

        def featurizer(snapshot):
            feat = hook(snapshot)
            feat.featurize = self._timed("featurize", feat.featurize)
            return feat

        self.sched.shadow_featurizer = featurizer
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.simulate, name, fn)
        del self.sched.shadow_featurizer


def autoscale_world(torch, mods, enc, bucket_size, ctl, device, n_nodes,
                    n_backlog, report=False):
    """Phase 15's world on `device`: n_nodes real nodes (no instance-type
    label: not autoscaled) each holding AUTOSCALE_RESIDENTS replicated pods
    of AUTOSCALE_RESIDENT_CPU, a FakeCloud with AUTOSCALE_GROUPS at the
    autoscaler's defaults, and n_backlog pending pods of AUTOSCALE_POD_CPU,
    half of them tolerating the himem taint. Scale-up passes (run_once,
    the clock past the cooldown, a drain) until nothing is pending or
    AUTOSCALE_UP_PASSES; then the batch job's tail ends (each himem node
    keeps one pod), and AUTOSCALE_DOWN_PASSES scale-down passes, each
    followed by re-creating the drained residents, as their controller
    would, and a drain. Checks every pod bound, no untolerating pod on
    himem, a node removed after a refit what-if, no pod pending and none
    on a removed node, no autoscaler error, and a launch of the
    taint/port kernel in every pass that ran a what-if on the card.
    Returns what the card == CPU comparison holds and what it saw."""
    api, tp, pre, kernel_mod, sched_mod, Scheduler, PodBackoff, store_mod = mods
    ClusterAutoscaler, FakeCloud, node_from_template, simulate = ctl
    tag = "[autoscale]" if report else f"[parity] autoscale {device}:"
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    t_world = time.monotonic()
    clock = VirtualClock()
    store = store_mod.ObjectStore()
    caps = enc.Caps(
        M=bucket_size(AUTOSCALE_RESIDENTS * n_nodes + 2 * n_backlog + 64),
        P=WAVE, LV=bucket_size(n_nodes + 256, 64))
    # preemption off, as bench.py run_autoscale_config runs it: elasticity,
    # not eviction, is the remedy; with one priority class no preemption
    # can place a pod, yet each failed pod's host attempt walks every node
    # (about 25 s a drain of the backlog at 5 000 nodes, PERF.md)
    sched = Scheduler(store, wave_size=WAVE, caps=caps, device=device,
                      clock=clock, backoff=PodBackoff(initial=0.001,
                                                      clock=clock),
                      disable_preemption=True)
    add_plain_nodes(api, store, n_nodes)
    resident_pods(api, store, n_nodes)
    cloud = FakeCloud()
    cloud.joiner = lambda g, name: store.create(
        "nodes", node_from_template(g, name))
    for name, cpu, price, tainted, max_size in AUTOSCALE_GROUPS:
        cloud.add_node_group(name, group_template(api, name, cpu, tainted),
                             max_size=max_size, price=price)
    ca = ClusterAutoscaler(store, cloud, sched, clock=clock)
    half = n_backlog // 2
    for i in range(n_backlog):
        store.create("pods", backlog_pod(api, f"job-{i}", i < half))
    t_world = time.monotonic() - t_world
    if drain_placing(sched, clock):
        fail(f"{tag} a backlog pod placed before any scale-up")
    if len(sched.pending_unschedulable()) != n_backlog:
        fail(f"{tag} {len(sched.pending_unschedulable())} of {n_backlog} "
             "backlog pods in the unschedulable map")
    passes, verdicts = [], []
    tp.taint_ports_masks.launches = 0
    t0 = time.monotonic()
    with Timed(simulate, sched, sync) as timed:
        for k in range(AUTOSCALE_UP_PASSES):
            if not sched.pending_count():
                break
            timed.reset()
            before = tp.taint_ports_masks.launches
            t = time.monotonic()
            r = ca.run_once()
            sync()
            wall = time.monotonic() - t
            launched = tp.taint_ports_masks.launches - before
            if timed.calls and cuda and not launched:
                fail(f"{tag} scale-up pass {k}: the what-if launched no "
                     "kernel")
            v = ca.last_verdict
            verdicts.append((v.chosen.copy(), v.feasible.copy(), v.n_real))
            up = ca.last_scale_up if r["scaled_up"] else None
            passes.append(("up", timed.shape, dict(timed.s), wall, up,
                           launched))
            clock.t += ca.scale_up_cooldown + 1.0
            drain_placing(sched, clock)
        n_up = len(passes)
        pending = [p.metadata.name for p in store.list("pods")
                   if not p.spec.node_name]
        if pending:
            fail(f"{tag} {len(pending)} pods still pending after {n_up} "
                 f"scale-up passes, e.g. {pending[:5]}")
        check_bindings(api, store)
        for p in store.list("pods"):
            if (p.metadata.name.startswith("job-")
                    and int(p.metadata.name[4:]) >= half
                    and not p.spec.node_name.startswith("std-32-")):
                fail(f"{tag} {p.metadata.name} (no toleration) on "
                     f"{p.spec.node_name}")
        # the batch job's tail ends: each himem node keeps one pod
        kept = set()
        for p in sorted(store.list("pods"), key=lambda p: p.metadata.name):
            node = p.spec.node_name
            if node.startswith("himem-64-"):
                if node in kept:
                    store.delete("pods", "default", p.metadata.name)
                kept.add(node)
        removed, refits = [], 0
        for k in range(AUTOSCALE_DOWN_PASSES):
            clock.t += ca.scale_down_cooldown + 1.0
            timed.reset()
            alive = {p.metadata.name: p for p in store.list("pods")}
            before = tp.taint_ports_masks.launches
            t = time.monotonic()
            r = ca.run_once()
            sync()
            wall = time.monotonic() - t
            launched = tp.taint_ports_masks.launches - before
            if timed.calls and cuda and not launched:
                fail(f"{tag} scale-down pass {k}: the what-if launched no "
                     "kernel")
            down = ca.last_scale_down if r["scaled_down"] else None
            if down is not None:
                removed.append(down)
                refits += bool(timed.calls)
            passes.append(("down", timed.shape, dict(timed.s), wall, down,
                           launched))
            # the drained residents' controller re-creates them
            gone = sorted(set(alive) - {p.metadata.name
                                        for p in store.list("pods")})
            for name in gone:
                p = copy.deepcopy(alive[name])
                p.metadata = api.ObjectMeta(
                    name=f"{name}-r{k}", labels=dict(p.metadata.labels),
                    owner_references=list(p.metadata.owner_references))
                p.spec.node_name = ""
                p.status = api.PodStatus()
                store.create("pods", p)
            clock.t += 1.0
            drain_placing(sched, clock)
            pending = [p.metadata.name for p in store.list("pods")
                       if not p.spec.node_name]
            if pending:
                fail(f"{tag} {pending[:5]} pending after scale-down pass {k}")
        on_removed = [p.metadata.name for p in store.list("pods")
                      if p.spec.node_name in removed]
    wall = time.monotonic() - t0
    launches = tp.taint_ports_masks.launches
    if refits == 0:
        fail(f"{tag} no node was removed after a refit what-if")
    if on_removed:
        fail(f"{tag} pods on removed nodes: {on_removed[:5]}")
    errors = sched.metrics.scheduling_errors.value(stage="autoscaler")
    if errors:
        fail(f"{tag} {errors} autoscaler errors")
    check_bindings(api, store)
    if report:
        for i, (d, shape, s, w, what, launched) in enumerate(passes):
            P, N = shape or (0, 0)
            log(f"{tag} pass {i} {d}: P={P} N={N} shadow "
                f"{s['shadow']:.3f} s, featurize {s['featurize']:.3f} s, "
                f"what-if {s['whatif']:.3f} s (with device sync), run_once "
                f"{w:.3f} s, kernel launches {launched}; "
                + (f"picked {what[0]} x{what[1]}" if d == "up" and what
                   else f"removed {what}" if what else "no change"))
    sizes = {g.name: g.target_size for g in cloud.groups()}
    out = {
        "verdicts": verdicts,
        "picked": [p[4] for p in passes],
        "sizes": sizes,
        "removed": removed,
        "events": [(e.metadata.name, e.involved_kind, e.involved_name,
                    e.reason, e.message, e.count)
                   for e in store.list("events")],
        "bindings": bindings(store),
    }
    seen = {"passes": passes, "n_up": n_up, "refits": refits, "wall": wall,
            "world": t_world, "launches": launches, "timed": timed,
            "errors": errors}
    return out, seen


def autoscale_phase(torch, mods, enc, bucket_size, ctl):
    """Phase 15: the autoscale world at FULL_NODES nodes and
    AUTOSCALE_BACKLOG pods on the card, then card == CPU on
    AUTOSCALE_SMALL_NODES nodes and AUTOSCALE_SMALL_BACKLOG pods."""
    t_phase = time.monotonic()
    _, seen = autoscale_world(torch, mods, enc, bucket_size, ctl, "cuda",
                              FULL_NODES, AUTOSCALE_BACKLOG, report=True)
    launches = seen["launches"]
    passes = seen["passes"]
    tot = {k: sum(p[2][k] for p in passes)
           for k in ("shadow", "featurize", "whatif")}
    ups = [p for p in passes if p[0] == "up" and p[1]]
    # the implicit host syncs of one scale-up what-if, on the last pass's
    # shadow and batch
    a, kw = seen["timed"].args["simulate_placements"]
    simulate = ctl[3]
    simulate.simulate_placements(*a, **kw)  # warm
    _, syncs = count_syncs(torch, lambda: simulate.simulate_placements(
        *a, **kw))
    up_whatif = [p[2]["whatif"] for p in ups]
    log(f"[autoscale] {FULL_NODES} nodes, {AUTOSCALE_BACKLOG} backlog pods: "
        f"world {seen['world']:.1f} s; {seen['n_up']} scale-up passes, "
        f"{len(passes) - seen['n_up']} scale-down passes, "
        f"{len([p for p in passes if p[0] == 'down' and p[4]])} nodes "
        f"removed ({seen['refits']} after a refit what-if) in "
        f"{seen['wall']:.1f} s; every backlog pod bound, none without the "
        "toleration on himem-64, no pod pending or on a removed node")
    log(f"[autoscale] seconds over all passes: shadow {tot['shadow']:.3f}, "
        f"featurize {tot['featurize']:.3f}, what-if {tot['whatif']:.3f}; a "
        f"scale-up what-if {statistics.median(up_whatif):.3f} s (median "
        f"of {len(up_whatif)}), P={ups[0][1][0]} N={ups[0][1][1]}")
    log(f"[autoscale] taint/port kernel launches in the phase: {launches}; "
        f"every pass with a what-if launched it; implicit host syncs of "
        f"one scale-up what-if: {sum(syncs.values())} (" + ", ".join(
            f"{k} x{v}" for k, v in sorted(syncs.items()))
        + f"); scheduling_errors{{stage=\"autoscaler\"}} {seen['errors']}")
    got = {}
    for device in ("cuda", "cpu"):
        t0 = time.monotonic()
        got[device], s = autoscale_world(
            torch, mods, enc, bucket_size, ctl, device,
            AUTOSCALE_SMALL_NODES, AUTOSCALE_SMALL_BACKLOG)
        log(f"[parity] autoscale {device}: {s['n_up']} scale-up passes, "
            f"removed {got[device]['removed']}, groups "
            f"{got[device]['sizes']}; world {time.monotonic() - t0:.1f} s")
    a, b = got["cuda"], got["cpu"]
    if len(a["verdicts"]) != len(b["verdicts"]):
        fail("autoscale: card and CPU ran different numbers of what-ifs")
    for i, (va, vb) in enumerate(zip(a["verdicts"], b["verdicts"])):
        if not ((va[0] == vb[0]).all() and (va[1] == vb[1]).all()
                and va[2] == vb[2] and va[1].shape == vb[1].shape):
            fail(f"autoscale: the scale-up verdict of pass {i} differs "
                 "between card and CPU")
    for key in ("picked", "sizes", "removed", "events", "bindings"):
        if a[key] != b[key]:
            fail(f"autoscale: card and CPU {key} differ")
    log(f"[parity] autoscale, {AUTOSCALE_SMALL_NODES} nodes, "
        f"{AUTOSCALE_SMALL_BACKLOG} backlog pods: card == CPU verdicts "
        "(chosen and feasible), groups picked and sizes, nodes removed, "
        f"events and bindings; phase {time.monotonic() - t_phase:.1f} s")
    return {"launches": launches, "whatif_launches": 0}


def bucket_allowance(burst, qps_of, times, due):
    """Evictions a zone's token bucket admits over monitor passes at
    `times` (seconds), with `due` pods due from the first pass on and
    qps_of(t) its rate: the bucket starts full, refills by elapsed *
    qps up to burst, and each eviction takes one token (utils/
    ratelimit.py's arithmetic, replayed independently)."""
    tokens, last, taken = float(burst), times[0], 0
    for t in times:
        qps = qps_of(t)
        if t > last and qps > 0:
            tokens = min(float(burst), tokens + (t - last) * qps)
        last = max(last, t)
        while qps > 0 and tokens >= 1.0 and taken < due:
            tokens -= 1.0
            taken += 1
    return taken


def zone_outage_world(torch, mods, enc, bucket_size, ctl, device, n_nodes,
                      report=False):
    """Phase 16's world on `device`: n_nodes nodes in 3 zones with
    heartbeats and AUTOSCALE_RESIDENTS pods each (with the 300 s default
    NoExecute tolerations), a NodeLifecycleController at its defaults
    on the scheduler's store (zone ids interned with the scheduler's
    vocabularies). Zone A stops every heartbeat, OUTAGE_B_FRACTION of
    zone B and OUTAGE_C_NODES nodes of zone C stop; monitor passes at
    OUTAGE_PASSES seconds; then OUTAGE_DENSITY density pods drained,
    then the heartbeats resume. Checks the zone states, the NoExecute
    taints, the evictions of each zone against its token bucket (none
    in zone A), no density pod on a tainted node, and all clear after
    recovery; the card's tally equals np.bincount on every pass.
    Returns what the card == CPU comparison holds and what it saw."""
    api, tp, pre, kernel_mod, sched_mod, Scheduler, PodBackoff, store_mod = mods
    nl, zonehealth = ctl
    tag = "[zone_outage]" if report else f"[parity] zone_outage {device}:"
    t_world = time.monotonic()
    clock = VirtualClock()
    store = store_mod.ObjectStore()
    caps = enc.Caps(
        M=bucket_size(AUTOSCALE_RESIDENTS * n_nodes + OUTAGE_DENSITY + 64),
        P=WAVE, LV=bucket_size(n_nodes + 256, 64))
    sched = Scheduler(store, wave_size=WAVE, caps=caps, device=device,
                      clock=clock, backoff=PodBackoff(initial=0.001,
                                                      clock=clock))
    add_plain_nodes(api, store, n_nodes, annotations={
        nl.HEARTBEAT_ANNOTATION: str(clock.t)})
    resident_pods(api, store, n_nodes, prefix="app", wait=300,
                  taint_keys=(nl.TAINT_NOT_READY, nl.TAINT_UNREACHABLE))
    ctrl = nl.NodeLifecycleController(store, clock=clock, device=device,
                                      vocabs=sched.snapshot.vocabs)
    zones = {z: [f"node-{i}" for i in range(n_nodes) if i % 3 == z]
             for z in range(3)}
    stopped = set(zones[0])
    stopped |= set(zones[1][:int(OUTAGE_B_FRACTION * len(zones[1]))])
    stopped |= set(zones[2][:OUTAGE_C_NODES])
    healthy = [n for z in range(3) for n in zones[z] if n not in stopped]
    t_world = time.monotonic() - t_world

    def heartbeat(names):
        for name in names:
            n = store.get("nodes", "default", name)
            n.metadata.annotations = dict(n.metadata.annotations)
            n.metadata.annotations[nl.HEARTBEAT_ANNOTATION] = str(clock.t)
            n.status.conditions = [
                c for c in n.status.conditions if c.type != api.NODE_READY
            ] + [api.NodeCondition(api.NODE_READY, api.COND_TRUE)]
            store.update("nodes", n)

    steps = PhaseClock()
    tally_check = {"calls": 0}
    tally = zonehealth.zone_tally

    def checked_tally(zone_id, bad, valid, num_zones, **kw):
        t = time.monotonic()
        out = tally(zone_id, bad, valid, num_zones, **kw)
        steps.seconds["tally"] = (steps.seconds.get("tally", 0.0)
                                  + time.monotonic() - t)
        want = zonehealth.zone_tally_host(zone_id, bad, valid, num_zones)
        if not all((a == b).all() for a, b in zip(out, want)):
            fail(f"{tag} the zone tally differs from np.bincount")
        tally_check["calls"] += 1
        tally_check["shape"] = (zone_id.shape[0], num_zones)
        return out

    ctrl._update_zone_states = steps.wrap("zone_states",
                                          ctrl._update_zone_states)
    ctrl._process_evictions = steps.wrap("evictions",
                                         ctrl._process_evictions)
    zonehealth.zone_tally = checked_tally
    zonehealth.reset_counts()
    states, alive0 = [], {p.metadata.name for p in store.list("pods")}
    t_start = clock.t
    monitor_s = []
    try:
        for at in OUTAGE_PASSES:
            clock.t = t_start + at
            heartbeat(healthy if at else ())
            t = time.monotonic()
            ctrl.monitor()
            monitor_s.append(time.monotonic() - t)
            states.append(dict(ctrl.zone_states))
        taints = {n.metadata.name: sorted((t.key, t.effect)
                                          for t in n.spec.taints)
                  for n in store.list("nodes")}
        evicted = sorted(alive0 - {p.metadata.name
                                   for p in store.list("pods")})
        for i in range(OUTAGE_DENSITY):
            store.create("pods", batch_pod(api, f"density-{i}", "density",
                                           "100m", None))
        tp.taint_ports_masks.launches = 0
        t = time.monotonic()
        placed = drain_placing(sched, clock)
        drain_s = time.monotonic() - t
        launches = tp.taint_ports_masks.launches
        bound = bindings(store)
        clock.t += 5.0
        heartbeat([n for z in range(3) for n in zones[z]])
        ctrl.monitor()
        recovered = dict(ctrl.zone_states)
    finally:
        zonehealth.zone_tally = tally
    counts = dict(zonehealth.TALLY_COUNTS)
    # the checks
    zkey = {z: api.get_zone_key(store.get("nodes", "default", zones[z][0]))
            for z in range(3)}
    want_state = {0: nl.ZONE_FULL, 1: nl.ZONE_PARTIAL, 2: nl.ZONE_NORMAL}
    for z, s in want_state.items():
        if states[-1].get(zkey[z]) != s:
            fail(f"{tag} zone-{z} is {states[-1].get(zkey[z])}, not {s}")
    for name, ts in taints.items():
        has = (nl.TAINT_UNREACHABLE, api.NO_EXECUTE) in ts
        if has != (name in stopped):
            fail(f"{tag} {name}: NoExecute unreachable taint {has}, "
                 f"stopped {name in stopped}")
    node_of = {f"app-{i}-{j}": f"node-{i}" for i in range(n_nodes)
               for j in range(AUTOSCALE_RESIDENTS)}
    by_zone = {z: sum(1 for p in evicted if node_of[p] in zones[z])
               for z in range(3)}
    due_at = [at for at in OUTAGE_PASSES if at >= OUTAGE_GRACE + 300.0]
    want_evicted = {
        0: 0,
        # a partially disrupted zone drains at the secondary rate when
        # it is large, and not at all when it is small
        1: bucket_allowance(ctrl.eviction_burst,
                            lambda t: ctrl.secondary_eviction_rate_qps
                            if len(zones[1]) > ctrl.large_cluster_threshold
                            else 0.0,
                            due_at, AUTOSCALE_RESIDENTS * len(
                                [n for n in zones[1] if n in stopped])),
        2: bucket_allowance(ctrl.eviction_burst,
                            lambda t: ctrl.eviction_rate_qps, due_at,
                            AUTOSCALE_RESIDENTS * OUTAGE_C_NODES),
    }
    if by_zone != want_evicted:
        fail(f"{tag} evictions by zone {by_zone}, the token buckets allow "
             f"{want_evicted}")
    if placed != OUTAGE_DENSITY:
        fail(f"{tag} placed {placed} of {OUTAGE_DENSITY} density pods")
    on_tainted = [p for p, n in bound.items()
                  if p.startswith("density-") and n in stopped]
    if on_tainted:
        fail(f"{tag} density pods on tainted nodes: {on_tainted[:5]}")
    check_bindings(api, store)
    if any(s != nl.ZONE_NORMAL for s in recovered.values()):
        fail(f"{tag} zones after recovery: {recovered}")
    left = [n.metadata.name for n in store.list("nodes")
            if any(t.effect == api.NO_EXECUTE for t in n.spec.taints)]
    if left:
        fail(f"{tag} NoExecute taints left after recovery: {left[:5]}")
    if counts["device_failures"] or counts["host"]:
        fail(f"{tag} tally paths {counts}: a tally left the device")
    if report:
        n_pass = len(OUTAGE_PASSES)
        zs = steps.seconds.get("zone_states", 0.0)
        tl = steps.seconds.get("tally", 0.0)
        ev = steps.seconds.get("evictions", 0.0)
        walk = sum(monitor_s) - zs - ev
        log(f"{tag} {n_nodes} nodes, {len(stopped)} stopped (zone A all, "
            f"{OUTAGE_B_FRACTION:.0%} of B, {OUTAGE_C_NODES} of C): world "
            f"{t_world:.1f} s; {n_pass} monitor passes at "
            f"{list(OUTAGE_PASSES)} s; zone states {want_state}; "
            f"evictions by zone {by_zone} = the buckets' allowance")
        log(f"{tag} host seconds a monitor pass: node walk "
            f"{walk / n_pass:.4f}, zone columns and states "
            f"{(zs - tl) / n_pass:.4f}, tally {tl / n_pass:.4f}, eviction "
            f"sweep {ev / n_pass:.4f}; whole pass {sum(monitor_s) / n_pass:.4f}"
            f" (slowest {max(monitor_s):.4f})")
        log(f"{tag} tally paths {counts}; the card's tally == np.bincount "
            f"on all {tally_check['calls']} passes (columns "
            f"{tally_check['shape'][0]}, zones {tally_check['shape'][1]})")
        log(f"{tag} {OUTAGE_DENSITY} density pods placed in {drain_s:.3f} s, "
            f"none on a tainted node; taint/port kernel launches {launches};"
            " after the heartbeats resume every zone is Normal and no "
            "NoExecute taint is left")
    out = {"states": states, "taints": taints, "evicted": evicted,
           "bindings": bound, "recovered": recovered}
    return out, {"launches": launches, "tally": tally_check,
                 "counts": counts}


def tally_bound(cap, num_zones):
    """(least ms, bound_by, bytes): the zone tally's three i32 columns
    read once and two i32 [Z] counts written once, over HBM bandwidth;
    its 2 * cap integer adds over the integer rate are far smaller."""
    nbytes = 3 * 4 * cap + 2 * 4 * num_zones
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes", nbytes


def zone_outage_phase(torch, mods, enc, bucket_size, ctl):
    """Phase 16: the zone outage at FULL_NODES nodes on the card, the
    tally timed at the 8 192-row bucket, then card == CPU at
    SMALL_NODES nodes."""
    import numpy as np

    t_phase = time.monotonic()
    _, seen = zone_outage_world(torch, mods, enc, bucket_size, ctl, "cuda",
                                FULL_NODES, report=True)
    zonehealth = ctl[1]
    cap, nz = seen["tally"]["shape"]
    rng = np.random.RandomState(SEED)
    zone_id = rng.randint(0, 3, size=cap).astype(np.int32)
    bad = rng.rand(cap) < 0.5
    valid = np.arange(cap) < FULL_NODES
    dev = torch.device("cuda")
    ms = cuda_ms(torch, lambda: zonehealth._tally_device(
        zone_id, bad, valid, nz, dev), reps=50)
    b_ms, b_by, nbytes = tally_bound(cap, nz)
    log(f"[zone_outage] tally a call (upload, two index_add_, fetch) N="
        f"{cap} Z={nz}: {ms:.4f} ms, byte bound {b_ms:.6f} ms ({nbytes} B)")
    got = {}
    for device in ("cuda", "cpu"):
        t0 = time.monotonic()
        got[device], _ = zone_outage_world(torch, mods, enc, bucket_size,
                                           ctl, device, SMALL_NODES)
        log(f"[parity] zone_outage {device}: {len(got[device]['evicted'])} "
            f"evicted; world {time.monotonic() - t0:.1f} s")
    for key in ("states", "taints", "evicted", "bindings", "recovered"):
        if got["cuda"][key] != got["cpu"][key]:
            fail(f"zone_outage: card and CPU {key} differ")
    log(f"[parity] zone_outage, {SMALL_NODES} nodes: card == CPU zone "
        "states, taint sets, evicted pods and bindings; phase "
        f"{time.monotonic() - t_phase:.1f} s")
    return {"launches": seen["launches"], "whatif_launches": 0,
            "tally_ms": ms, "tally_bound_ms": b_ms}


# --- phase 17: the device-fault ladder -----------------------------------------


class Ladder:
    """Every Scheduler a phase builds (it stands in for the class in the
    phases' `mods`), so that each healthy phase can be held to no use of
    the device-fault ladder, read from each scheduler's own state and
    metrics: breaker CLOSED, no trip, no device failure
    (scheduling_errors{stage="wave"}: every twin wave of a CLOSED breaker
    follows one), no watchdog abandonment, no quarantined pod, no
    conviction. waves_total{path="host"} is not read: it also counts the
    exact host path's one-pod passes, which healthy phases take for
    multi-key pods. check() drops the schedulers it held, so a phase's
    device memory is freed after it."""

    def __init__(self, Scheduler):
        self.cls = Scheduler
        self.made = []

    def __call__(self, *a, **kw):
        s = self.cls(*a, **kw)
        self.made.append(s)
        return s

    def check(self, phase: str, store: bool = True) -> None:
        """store: also hold each scheduler to no store-breaker trip and an
        empty spool (phase 19 trips it on purpose)."""
        for s in self.made:
            wd = s.watchdog
            used = {"breaker": s.breaker.state, "trips": s.breaker.trips,
                    "device_path_trips": int(s.metrics.device_path_trips.value),
                    "abandoned": wd.abandoned_total if wd is not None else 0,
                    "quarantined": s.queue.quarantine_count(),
                    "convictions": s.poison_convictions,
                    "device_failures": int(
                        s.metrics.scheduling_errors.value(stage="wave")),
                    **self.capacity(s)}
            if used != {"breaker": "closed", "trips": 0,
                        "device_path_trips": 0, "abandoned": 0,
                        "quarantined": 0, "convictions": 0,
                        "device_failures": 0, "capacity_faults": 0,
                        "oom_compactions": 0, "strikes": 0}:
                fail(f"{phase}: a healthy phase used the device-fault "
                     f"ladder or the capacity ladder: {used}")
        if store:
            self.check_store(phase, keep=True)
        log(f"[ladder] {phase}: {len(self.made)} schedulers, breaker "
            "CLOSED, no trip, no device failure, no watchdog abandonment, "
            "no quarantined pod, no capacity fault"
            + (", no store trip, no spooled bind" if store else ""))
        self.made = []

    def check_store(self, phase: str, keep: bool = False) -> None:
        """The schedulers of a phase that does not cut the store off: no
        store-breaker trip, nothing spooled."""
        for s in self.made:
            used = {"store_trips": s.storehealth.trips,
                    "store_trip_metric": int(
                        s.metrics.store_breaker_trips.value),
                    "spool": s.spool_count()}
            if any(used.values()):
                fail(f"{phase}: the store plane tripped or spooled: {used}")
        if not keep:
            log(f"[ladder] {phase}: {len(self.made)} schedulers, no store "
                "trip, no spooled bind")
            self.made = []

    @staticmethod
    def capacity(s) -> dict:
        """The capacity ladder of one scheduler: faults, compactions it
        ran for them, outstanding strikes."""
        return {"capacity_faults": int(s.metrics.capacity_faults.value),
                "oom_compactions": int(
                    s.metrics.snapshot_compactions_total.value(
                        trigger="oom")),
                "strikes": s._capacity_strikes}

    def check_capacity(self, phase: str) -> None:
        """The schedulers of a phase that injects device faults (17): none
        of them used the capacity ladder."""
        for s in self.made:
            used = self.capacity(s)
            if any(used.values()):
                fail(f"{phase}: the capacity ladder ran: {used}")
        log(f"[ladder] {phase}: {len(self.made)} schedulers, no capacity "
            "fault")


def same_planes(name, host, card, fields):
    """The twin's result and the card's, field by field: the same shape
    and every element equal (f32 planes compared bit for bit)."""
    import numpy as np

    for f in fields:
        a = np.asarray(getattr(host, f))
        b = getattr(card, f).cpu().numpy()
        if a.shape != b.shape:
            fail(f"faults: {name} {f}: twin shape {a.shape}, card {b.shape}")
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        if not np.array_equal(a, b):
            bad = np.argwhere(a != b)
            fail(f"faults: {name} {f}: twin and card differ at "
                 f"{len(bad)} entries, e.g. {bad[:3].tolist()}")


def twin_card(torch, mods, enc, bucket_size, lbl, hostwave):
    """Phase 17 (a): the port's twin (ops/hostwave.py) against the card's
    wave on seeded density, mixed (inter-pod affinity) and spread worlds
    at FULL_NODES nodes, one wave of WAVE pods; then the gang on
    FAULT_GANG density pods. Returns the ms a wave on each, by world."""
    import numpy as np

    api, tp, pre, kernel_mod, sched_mod, Scheduler, PodBackoff, store_mod = \
        mods
    planes = ("masks", "chosen", "score", "fail_counts", "feasible_count",
              "rr_end", "finite")
    worlds = {
        "density": lambda: build_store(api, store_mod, FULL_NODES, WAVE,
                                       SEED + 17),
        "mixed": lambda: build_mixed(api, lbl, store_mod, FULL_NODES,
                                     4 * WAVE),
        "spread": lambda: build_spread(api, lbl, store_mod, FULL_NODES,
                                       WAVE, 8),
    }
    out = {}
    for name, build in worlds.items():
        t_world = time.monotonic()
        store, n_bound = build()
        pending = [p for p in store.list("pods") if not p.spec.node_name]
        if name == "mixed":
            # a quarter of the wave from each of the four workloads
            q = len(pending) // 4
            pods = [p for k in range(4)
                    for p in pending[k * q:k * q + WAVE // 4]]
        else:
            pods = pending[:WAVE]
        caps = scheduler_caps(enc, bucket_size, FULL_NODES, len(pending),
                              n_bound, len(pending) if name == "mixed"
                              else 0)
        sched = Scheduler(store, wave_size=WAVE, caps=caps, device="cuda")
        world_s = time.monotonic() - t_world
        pb = sched.featurizer.featurize(pods)
        P, N = pb.req.shape[0], sched.snapshot.caps.N
        has_ipa = bool(sched.snapshot.has_affinity_terms or pb.ra_has.any()
                       or pb.rn_has.any() or (pb.pa_w != 0).any())
        gating, wvec, _ = sched._weights_kw()
        zl = dict(num_zones=sched.snapshot.caps.Z,
                  num_label_values=sched.snapshot.num_label_values)
        nt_h, pm_h, tt_h = sched.snapshot.host_tensors()
        t0 = time.monotonic()
        host, _ = hostwave.schedule_wave_host(
            nt_h, pm_h, tt_h, pb, np.ones((P, N), bool), 7, None,
            weights=gating, has_ipa=has_ipa, weight_vec=wvec, **zl)
        host_s = time.monotonic() - t0
        nt, pm, tt = sched.snapshot.to_device("cuda")
        pbt = enc.to_torch(None, None, None, pb, "cuda")[3]
        ext = torch.ones((P, N), dtype=torch.bool, device="cuda")
        wv = enc.weight_vec_to_torch(wvec, "cuda")
        rr = torch.tensor(7, dtype=torch.int32, device="cuda")

        def card():
            return kernel_mod.schedule_wave(nt, pm, tt, pbt, ext, rr, None,
                                            weights=gating, has_ipa=has_ipa,
                                            weight_vec=wv, **zl)

        res = card()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(3):
            res = card()
        torch.cuda.synchronize()
        card_s = (time.monotonic() - t0) / 3
        same_planes(f"{name} wave", host, res, planes)
        placed = int((np.asarray(host.chosen) >= 0).sum())
        if placed < len(pods) // 2:
            fail(f"faults: {name} wave placed only {placed} of {len(pods)}")
        log(f"[faults] (a) {name}: twin == card on every plane (masks, "
            f"chosen, score, fail_counts, feasible_count, rr_end, finite), "
            f"P={P} N={N} has_ipa {has_ipa} has_ts "
            f"{bool(pb.ts_valid.any())}, {placed} placed; a wave: twin "
            f"{1e3 * host_s:.1f} ms, card {1e3 * card_s:.1f} ms")
        out[name] = (host_s, card_s, world_s)
        if name == "density":
            gpods = pending[:FAULT_GANG]
            gb = sched.featurizer.featurize(gpods)
            G = gb.req.shape[0]
            gbt = enc.to_torch(None, None, None, gb, "cuda")[3]
            gext = torch.ones((G, N), dtype=torch.bool, device="cuda")
            for need in (FAULT_GANG, FAULT_GANG + 1):
                t0 = time.monotonic()
                hg = hostwave.schedule_gang_host(
                    nt_h, pm_h, tt_h, gb, np.ones((G, N), bool), 7, None,
                    need, weights=gating, weight_vec=wvec, **zl)
                hg_s = time.monotonic() - t0
                cg = sched_mod.schedule_gang(
                    nt, pm, tt, gbt, gext, rr, None,
                    torch.tensor(need, dtype=torch.int32, device="cuda"),
                    weights=gating, weight_vec=wv,
                    ts_valid_host=gb.ts_valid, **zl)
                same_planes(f"gang need {need}", hg, cg,
                            ("ok", "chosen", "placed", "rr_end", "finite",
                             "masks", "fail_counts"))
                if bool(hg.ok) != (need == FAULT_GANG):
                    fail(f"faults: the gang of {FAULT_GANG} with need "
                         f"{need} admitted {bool(hg.ok)}")
                log(f"[faults] (a) gang of {FAULT_GANG} ({G} rows), need "
                    f"{need}: twin == card (ok {bool(hg.ok)}, chosen, "
                    f"placed, rr_end, finite, masks, fail_counts); twin "
                    f"{1e3 * hg_s:.1f} ms")
        del sched, store, nt, pm, tt, res
        torch.cuda.empty_cache()
    return out


def drain_per_wave(sched) -> int:
    """Drain the active queue through the per-wave path
    (Scheduler.run_once, one wave_size dispatch at a time), the path a
    drain takes once a failed round hands it the backlog. Returns the
    pods placed."""
    placed = 0
    while sched.queue.active_count() > 0:
        placed += sched.run_once()
    return placed


def ladder_run(torch, mods, enc, bucket_size, faultpoints, n_pods, faulted):
    """Phase 17 (b): the density world of n_pods pods at FULL_NODES nodes
    on the card, on a virtual clock. faulted: kernel.round raises once
    and kernel.wave twice (three device failures, the breaker's
    threshold): the round hands the backlog to the per-wave path, the
    breaker opens and the backlog drains through the twin a wave at a
    time. Not faulted: the same world drains through the per-wave path
    on the card, so the two runs batch the pods alike. Then, past the
    cooldown, FAULT_LATE more pods: the half-open probe dispatches on
    the card and closes the breaker. Both kernels' counts are set to 0
    before each drive and read after. Returns the bindings and what was
    seen."""
    api, tp, pre, kernel_mod, sched_mod, Scheduler, PodBackoff, store_mod = \
        mods
    store, n_bound = build_store(api, store_mod, FULL_NODES, n_pods,
                                 SEED + 171)
    caps = scheduler_caps(enc, bucket_size, FULL_NODES, n_pods + FAULT_LATE,
                          n_bound)
    clock = VirtualClock()
    sched = Scheduler(store, wave_size=WAVE, caps=caps, device="cuda",
                      clock=clock,
                      backoff=PodBackoff(initial=0.001, clock=clock))
    marks = []
    hook = sched.breaker.on_state
    sched.breaker.on_state = lambda st: (marks.append(
        (st, time.monotonic())), hook(st))
    if faulted:
        faultpoints.activate("kernel.round", "raise", times=1)
        faultpoints.activate("kernel.wave", "raise", times=2)
    tp.taint_ports_masks.launches = 0
    t0 = time.monotonic()
    placed = (sched.schedule_pending() if faulted
              else drain_per_wave(sched))
    torch.cuda.synchronize()
    drain_s = time.monotonic() - t0
    launches = tp.taint_ports_masks.launches
    hits = (faultpoints.hits("kernel.round"), faultpoints.hits("kernel.wave"))
    seen = {"drain_s": drain_s, "placed": placed, "launches": launches,
            "port_pods": sum(1 for p in store.list("pods")
                             if not p.metadata.name.startswith("holder-")
                             and p.spec.containers[0].ports),
            "path": sched.wave_path(), "state": sched.breaker.state,
            "trips": sched.breaker.trips, "hits": hits,
            "twin_waves": int(sched.metrics.waves_total.value(path="host"))}
    if faulted:
        t_open = next((t for st, t in marks if st == "open"), None)
        if sched.breaker.state != "open" or sched.breaker.trips != 1:
            fail(f"faults: (b) breaker {sched.breaker.state} with "
                 f"{sched.breaker.trips} trips after three failures")
        if sched.wave_path() != "host" or hits != (1, 2):
            fail(f"faults: (b) wave_path {sched.wave_path()!r}, hits {hits}")
        seen["t_open"] = None if t_open is None else t_open - t0
    faultpoints.reset()
    clock.t += sched.breaker.cooldown + 1.0
    add_chunk(api, store, "late", 0, FAULT_LATE)
    marks.clear()
    tp.taint_ports_masks.launches = 0
    t1 = time.monotonic()
    placed_late = sched.schedule_pending()
    torch.cuda.synchronize()
    seen["late_s"] = time.monotonic() - t1
    seen["launches_late"] = tp.taint_ports_masks.launches
    seen["marks"] = [(st, t - t1) for st, t in marks]
    if placed + placed_late != n_pods + FAULT_LATE:
        fail(f"faults: (b) placed {placed} + {placed_late} of "
             f"{n_pods} + {FAULT_LATE}")
    if sched.breaker.state != "closed" or sched.wave_path() != "cuda":
        fail(f"faults: (b) after the probe: breaker {sched.breaker.state}, "
             f"wave_path {sched.wave_path()!r}")
    if seen["launches_late"] < 1:
        fail("faults: (b) the taint/port kernel did not launch after the "
             "breaker closed")
    check_bindings(api, store)
    return bindings(store), seen


def watchdog_run(torch, mods, enc, bucket_size, faultpoints, kernel_mod,
                 n_pods):
    """Phase 17 (c): a healthy scheduler drains the density world of
    n_pods pods and its round dispatch (the host's issue of the round,
    what the watchdog budgets) is timed; a second drains the same world
    through the per-wave path on the card; a third arms the watchdog at
    FAULT_DEADLINE_X times the timed dispatch, and a kernel.hang latency
    of two deadlines wedges its first dispatch: DispatchTimeout,
    record_hang (the breaker OPEN at once), the same round salvaged
    through the twin a wave at a time, equal to the per-wave run's
    bindings. Once the wedged worker returns and the cooldown has
    passed, the probe closes the breaker on the card. Returns what was
    seen."""
    api, tp, pre, _km, sched_mod, Scheduler, PodBackoff, store_mod = mods
    from kubernetes_tpu_torch.utils.watchdog import DispatchWatchdog

    inner = kernel_mod._schedule_round
    issue = []

    def timed(*a, **kw):
        t = time.monotonic()
        out = inner(*a, **kw)
        issue.append(time.monotonic() - t)
        return out

    got = {}
    kernel_mod._schedule_round = timed
    try:
        for mode in ("round", "waves", "armed"):
            armed = mode == "armed"
            store, n_bound = build_store(api, store_mod, FULL_NODES, n_pods,
                                         SEED + 172)
            caps = scheduler_caps(enc, bucket_size, FULL_NODES,
                                  n_pods + WAVE, n_bound)
            clock = VirtualClock()
            kw = {}
            if armed:
                deadline = max(FAULT_DEADLINE_X * max(issue), 0.25)
                kw = dict(wave_deadline_s=deadline)
            sched = Scheduler(store, wave_size=WAVE, caps=caps,
                              device="cuda", clock=clock,
                              backoff=PodBackoff(initial=0.001, clock=clock),
                              **kw)
            if armed:
                faultpoints.activate("kernel.hang", "latency",
                                     arg=2 * deadline, times=1)
            issue_before = len(issue)
            tp.taint_ports_masks.launches = 0
            t0 = time.monotonic()
            placed = (drain_per_wave(sched) if mode == "waves"
                      else sched.schedule_pending())
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            if placed != n_pods:
                fail(f"faults: (c) {mode}: placed {placed} of {n_pods}")
            got[mode] = bindings(store)
            if mode == "round":
                healthy = {"issue_s": max(issue), "wall": wall,
                           "launches": tp.taint_ports_masks.launches}
            if not armed:
                check_bindings(api, store)
                del sched, store
                continue
            wd = sched.watchdog
            if (wd.abandoned_total != 1 or sched.breaker.state != "open"
                    or sched.breaker.trips != 1
                    or sched.wave_path() != "host"):
                fail(f"faults: (c) abandoned {wd.abandoned_total}, breaker "
                     f"{sched.breaker.state} ({sched.breaker.trips} trips), "
                     f"wave_path {sched.wave_path()!r}")
            t_wedge = time.monotonic()
            if not wd.drain(60.0):
                fail("faults: (c) the wedged dispatch never returned")
            wedge_s = time.monotonic() - t_wedge
            clock.t += sched.breaker.cooldown + 1.0
            add_chunk(api, store, "probe", 0, WAVE)
            del issue[issue_before:]
            tp.taint_ports_masks.launches = 0
            t1 = time.monotonic()
            n = sched.schedule_pending()
            torch.cuda.synchronize()
            probe_s = time.monotonic() - t1
            if (n != WAVE or sched.breaker.state != "closed"
                    or sched.wave_path() != "cuda"
                    or tp.taint_ports_masks.launches < 1):
                fail(f"faults: (c) the probe placed {n}, breaker "
                     f"{sched.breaker.state}, wave_path "
                     f"{sched.wave_path()!r}")
            armed_seen = {
                "deadline": deadline, "salvage_s": wall, "wedge_s": wedge_s,
                "probe_s": probe_s, "probe_issue_s": max(issue[issue_before:]),
                "launches": tp.taint_ports_masks.launches,
                "overruns": sched.metrics.wave_deadline_overruns.value(
                    stage="dispatch")}
            check_bindings(api, store)
            del sched, store
    finally:
        kernel_mod._schedule_round = inner
        faultpoints.reset()
    salvaged = {k: v for k, v in got["armed"].items()
                if not k.startswith("probe-")}
    if salvaged != got["waves"]:
        diff = [k for k in got["waves"]
                if got["waves"][k] != salvaged.get(k)]
        fail(f"faults: (c) the salvaged round's bindings differ from the "
             f"per-wave run's for {len(diff)} pods, e.g. {diff[:5]}")
    # the round's own bindings, for the record: it checks host ports
    # against its start state, so it may place port pods otherwise
    healthy["round_differs"] = sum(
        1 for k in got["waves"] if got["waves"][k] != got["round"].get(k))
    # the watchdog's own cost: a guarded no-op dispatch
    wd = DispatchWatchdog(10.0)
    t0 = time.monotonic()
    for _ in range(200):
        wd.run(lambda: None)
    guard_us = (time.monotonic() - t0) / 200 * 1e6
    return healthy, armed_seen, guard_us


def poison_run(torch, mods, enc, bucket_size, faultpoints, featurize_mod,
               n_pods, poisoned):
    """Phase 17 (d): the density world of n_pods pods; poisoned: the
    pods of FAULT_NAN get a NaN cpu request and the pod FAULT_CRASH rides
    a wave.poison crash-kind fault; otherwise those five pods are left
    out. Returns the innocents' bindings, the names of the pods asking a
    host port, and what was seen."""
    api, tp, pre, kernel_mod, sched_mod, Scheduler, PodBackoff, store_mod = \
        mods
    store, n_bound = build_store(api, store_mod, FULL_NODES, n_pods,
                                 SEED + 173)
    nan_names = nan_pods(n_pods)
    crash_name = f"pod-{FAULT_CRASH}"
    for name in nan_names + [crash_name]:
        if not poisoned:
            store.delete("pods", "default", name)
        elif name != crash_name:
            store.get("pods", "default", name).spec.containers[0] \
                .resources.requests["cpu"] = float("nan")
    caps = scheduler_caps(enc, bucket_size, FULL_NODES, n_pods, n_bound)
    clock = VirtualClock()
    sched = Scheduler(store, wave_size=WAVE, caps=caps, device="cuda",
                      clock=clock,
                      backoff=PodBackoff(initial=0.001, clock=clock))
    if poisoned:
        uid = store.get("pods", "default", crash_name).uid
        faultpoints.activate("wave.poison", "corrupt",
                             fn=featurize_mod.poison_pod_fault(uid, "crash"))
    rounds = []
    round_fn = sched_mod.schedule_round

    def counted(*a, **kw):
        rounds.append(1)
        return round_fn(*a, **kw)

    sched_mod.schedule_round = counted
    tp.taint_ports_masks.launches = 0
    try:
        t0 = time.monotonic()
        placed = sched.schedule_pending()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    finally:
        sched_mod.schedule_round = round_fn
        faultpoints.reset()
    m = sched.metrics
    seen = {"placed": placed, "wall": wall, "rounds": len(rounds),
            "launches": tp.taint_ports_masks.launches,
            "poison_rounds": int(m.scheduling_errors.value(stage="poison")),
            "quarantined": sorted(p.metadata.name
                                  for p in sched.queue.quarantined_pods()),
            "reasons": {r: int(m.poison_pods.value(reason=r))
                        for r in ("featurize", "sentinel", "bisect")},
            "breaker": sched.breaker.state, "trips": sched.breaker.trips,
            "device_path_trips": int(m.device_path_trips.value)}
    check_bindings(api, store)
    out = {k: v for k, v in bindings(store).items()
           if k not in nan_names and k != crash_name}
    ports = {p.metadata.name for p in store.list("pods")
             if p.spec.containers[0].ports
             and not p.metadata.name.startswith("holder-")}
    return out, ports, seen


def open_breaker_autoscale(torch, mods, enc, bucket_size, ctl):
    """Phase 17 (e): phase 15's world at AUTOSCALE_SMALL_NODES nodes with
    the scheduler's breaker forced OPEN: the autoscaler's scale-up
    what-if runs on backend="host" (the twin; no kernel launch, nothing
    dispatched to the card) and its verdict (chosen, feasible) equals the
    device branch's on the same shadow and batch, as does a refit
    what-if. Returns what was seen."""
    import numpy as np

    api, tp, pre, kernel_mod, sched_mod, Scheduler, PodBackoff, store_mod = \
        mods
    ClusterAutoscaler, FakeCloud, node_from_template, simulate = ctl
    n_nodes, n_backlog = AUTOSCALE_SMALL_NODES, AUTOSCALE_SMALL_BACKLOG
    clock = VirtualClock()
    store = store_mod.ObjectStore()
    caps = enc.Caps(
        M=bucket_size(AUTOSCALE_RESIDENTS * n_nodes + 2 * n_backlog + 64),
        P=WAVE, LV=bucket_size(n_nodes + 256, 64))
    sched = Scheduler(store, wave_size=WAVE, caps=caps, device="cuda",
                      clock=clock, backoff=PodBackoff(initial=0.001,
                                                      clock=clock),
                      disable_preemption=True)
    add_plain_nodes(api, store, n_nodes)
    resident_pods(api, store, n_nodes)
    cloud = FakeCloud()
    cloud.joiner = lambda g, name: store.create(
        "nodes", node_from_template(g, name))
    for name, cpu, price, tainted, max_size in AUTOSCALE_GROUPS:
        cloud.add_node_group(name, group_template(api, name, cpu, tainted),
                             max_size=max_size, price=price)
    ca = ClusterAutoscaler(store, cloud, sched, clock=clock)
    for i in range(n_backlog):
        store.create("pods", backlog_pod(api, f"job-{i}", i < n_backlog // 2))
    if drain_placing(sched, clock):
        fail("faults: (e) a backlog pod placed before any scale-up")
    sched.breaker.record_hang()  # OPEN, as a wedged dispatch leaves it
    captured = {}
    saved = simulate.simulate_placements

    def spy(*a, **kw):
        captured["args"] = (a, kw)
        return saved(*a, **kw)

    simulate.simulate_placements = spy
    launches0 = tp.taint_ports_masks.launches
    try:
        t0 = time.monotonic()
        r = ca.run_once()
        host_s = time.monotonic() - t0
    finally:
        simulate.simulate_placements = saved
    if tp.taint_ports_masks.launches != launches0:
        fail("faults: (e) the OPEN-breaker pass launched a kernel")
    a, kw = captured["args"]
    if kw.get("backend") != "host":
        fail(f"faults: (e) the what-if ran on {kw.get('backend')!r}")
    v_host = ca.last_verdict
    dkw = dict(kw, backend="device", device="cuda")
    v_dev = simulate.simulate_placements(*a, **dkw)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    v_dev = simulate.simulate_placements(*a, **dkw)
    torch.cuda.synchronize()
    dev_s = time.monotonic() - t0
    for f in ("chosen", "feasible"):
        x, y = getattr(v_host, f), getattr(v_dev, f)
        if x.shape != y.shape or not np.array_equal(x, y):
            fail(f"faults: (e) the host and device verdicts' {f} differ")
    shadow, pb = a[0], a[1]
    rkw = {k: v for k, v in kw.items() if k not in ("backend", "device")}
    ok_h, ch_h = simulate.simulate_refit(shadow, pb, 1, backend="host", **rkw)
    ok_d, ch_d = simulate.simulate_refit(shadow, pb, 1, backend="device",
                                         device="cuda", **rkw)
    if ok_h != ok_d or not np.array_equal(ch_h, ch_d):
        fail("faults: (e) the host and device refit verdicts differ")
    if r["scaled_up"] < 1:
        fail("faults: (e) the OPEN-breaker pass bought no node")
    return {"scaled_up": r["scaled_up"], "host_s": host_s, "dev_s": dev_s,
            "P": pb.req.shape[0], "N": shadow.caps.N,
            "picked": ca.last_scale_up}


def faults_phase(torch, mods, enc, bucket_size, lbl, ctl, hostwave,
                 faultpoints, featurize_mod):
    """Phase 17: (a) twin == card, (b) the breaker ladder, (c) the
    watchdog, (d) poison, (e) the autoscaler with the breaker open. The
    pods of (b) and (d) halve (to no fewer than FAULT_MIN_PODS) when the
    phase projects past FAULT_BUDGET_S from (a)'s density wave times."""
    kernel_mod = mods[3]
    t_phase = time.monotonic()
    waves = twin_card(torch, mods, enc, bucket_size, lbl, hostwave)
    host_s, card_s, world_s = waves["density"]
    n = FAULT_PODS

    def projected(n):
        # (b): the twin drain with its attribution replays (at most four
        # waves for the round, one for each failed wave) and the card
        # drains of n + FAULT_LATE (fault-free) and FAULT_LATE pods;
        # (d): two card drains of n pods; four worlds built
        w = n / WAVE
        return ((w + min(w, 4) + 4) * host_s
                + (3 * n + 2 * FAULT_LATE) / WAVE * card_s + 4 * world_s)

    while n > FAULT_MIN_PODS and projected(n) > FAULT_BUDGET_S:
        n //= 2
    log(f"[faults] (b) and (d) at {n} pods: projected {projected(n):.1f} s "
        f"({FAULT_PODS} pods unless they project past "
        f"{FAULT_BUDGET_S:.0f} s; a density wave: twin {1e3 * host_s:.1f} "
        f"ms, card {1e3 * card_s:.1f} ms, world {world_s:.1f} s)")
    t0 = time.monotonic()
    clean, _ = ladder_run(torch, mods, enc, bucket_size, faultpoints, n,
                          False)
    torch.cuda.empty_cache()
    faulted, seen = ladder_run(torch, mods, enc, bucket_size, faultpoints,
                               n, True)
    torch.cuda.empty_cache()
    if faulted != clean:
        diff = [k for k in clean if clean[k] != faulted.get(k)]
        fail(f"faults: (b) the faulted run's bindings differ from the "
             f"fault-free run's for {len(diff)} pods, e.g. {diff[:5]}")
    marks = ", ".join(f"{st} at +{t:.3f} s" for st, t in seen["marks"])
    log(f"[faults] (b) {n} density pods, kernel.round raising once and "
        f"kernel.wave twice: the breaker OPEN at +{seen['t_open']:.3f} s "
        f"(trips {seen['trips']}, hits round {seen['hits'][0]} wave "
        f"{seen['hits'][1]}); the backlog drained through the twin: "
        f"{seen['placed']} pods in {seen['drain_s']:.3f} s = "
        f"{seen['placed'] / seen['drain_s']:.1f} pods/s, {seen['twin_waves']} "
        f"twin waves, wave_path 'host', {seen['launches']} kernel launches")
    log(f"[faults] (b) past the cooldown: {FAULT_LATE} pods in "
        f"{seen['late_s']:.3f} s on the card, probe {marks}; "
        f"{seen['launches_late']} kernel launches; bindings of all "
        f"{n + FAULT_LATE} pods ({seen['port_pods']} asking hostPort 8080) "
        f"== the fault-free per-wave run's on the card (twin == card end "
        f"to end); ladder {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    healthy, armed, guard_us = watchdog_run(
        torch, mods, enc, bucket_size, faultpoints, kernel_mod, FAULT_WATCH)
    torch.cuda.empty_cache()
    log(f"[faults] (c) {FAULT_WATCH} pods: a healthy round's dispatch "
        f"issue {healthy['issue_s']:.3f} s; deadline "
        f"{armed['deadline']:.3f} s, a kernel.hang of "
        f"{2 * armed['deadline']:.3f} s: DispatchTimeout, record_hang, the "
        f"breaker OPEN at once, the round salvaged through the twin in "
        f"{armed['salvage_s']:.3f} s (bindings == the healthy per-wave "
        f"run's; the healthy round placed {healthy['round_differs']} pods "
        f"otherwise); the "
        f"wedge drained {armed['wedge_s']:.3f} s later; the probe placed "
        f"{WAVE} pods on the card in {armed['probe_s']:.3f} s (dispatch "
        f"issue {armed['probe_issue_s']:.3f} s under the watchdog), breaker "
        f"CLOSED; overruns{{stage=dispatch}} {armed['overruns']}; a guarded "
        f"no-op dispatch costs {guard_us:.1f} us; "
        f"{time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    poisoned, ports, ps = poison_run(torch, mods, enc, bucket_size,
                                     faultpoints, featurize_mod, n, True)
    torch.cuda.empty_cache()
    clean_p, _, cs = poison_run(torch, mods, enc, bucket_size, faultpoints,
                                featurize_mod, n, False)
    torch.cuda.empty_cache()
    n_nan = len(FAULT_NAN)
    want_q = sorted(nan_pods(n) + [f"pod-{FAULT_CRASH}"])
    if (ps["placed"] != n - n_nan - 1 or ps["quarantined"] != want_q
            or ps["breaker"] != "closed" or ps["trips"]
            or ps["device_path_trips"]):
        fail(f"faults: (d) placed {ps['placed']}, quarantined "
             f"{ps['quarantined']}, breaker {ps['breaker']} "
             f"({ps['trips']} trips)")
    if ps["reasons"] != {"featurize": n_nan, "sentinel": 0, "bisect": 1}:
        fail(f"faults: (d) conviction reasons {ps['reasons']}")
    # the bisection splits the crash pod's round into smaller rounds, and
    # a round checks host ports against its start state: a pod asking
    # hostPort 8080 may see another feasible set than in the clean run's
    # one round and take another node (both runs passed check_bindings:
    # no port or resource is overcommitted). Every other innocent must
    # bind as in the clean run.
    if set(poisoned) != set(clean_p):
        fail("faults: (d) the poisoned and clean runs hold other pods")
    diff = [k for k in clean_p if clean_p[k] != poisoned[k]]
    moved = [k for k in diff if k in ports]
    if len(moved) != len(diff):
        bad = [k for k in diff if k not in ports]
        fail(f"faults: (d) the bindings of {len(bad)} innocents without a "
             f"host port differ from the clean run's, e.g. {bad[:5]}")
    log(f"[faults] (d) {n} pods, {n_nan} NaN-spec and one wave.poison "
        f"crash: {ps['placed']} placed, {len(ps['quarantined'])} "
        f"quarantined ({ps['reasons']}), {ps['poison_rounds']} input-fault "
        f"rounds, {ps['rounds']} device rounds in {ps['wall']:.3f} s "
        f"(clean run without them: {cs['rounds']} rounds in "
        f"{cs['wall']:.3f} s); breaker CLOSED, device_path_trips 0; the "
        f"innocents' bindings == the clean run's but for {len(moved)} of "
        f"the {len(ports & set(clean_p))} asking hostPort 8080 (the rest "
        f"equal); "
        f"{time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    auto = open_breaker_autoscale(torch, mods, enc, bucket_size, ctl)
    log(f"[faults] (e) autoscaler, {AUTOSCALE_SMALL_NODES} nodes, breaker "
        f"OPEN: the scale-up what-if on the twin (P={auto['P']} "
        f"N={auto['N']}, run_once {auto['host_s']:.3f} s, no kernel "
        f"launch) == the device branch ({auto['dev_s']:.3f} s) on chosen "
        f"and feasible, refit too; bought {auto['picked']}; "
        f"{time.monotonic() - t0:.1f} s")
    kernel_mod.set_watchdog(None)
    log(f"[faults] phase {time.monotonic() - t_phase:.1f} s")
    return {"launches": seen["launches"] + seen["launches_late"]
            + armed["launches"] + ps["launches"],
            "whatif_launches": 0}


# -- phase 18: the memory plane and load shedding ---------------------------------


def memory_caps(snap) -> dict:
    """The snapshot-owned caps a compaction may shrink (their names)."""
    return {d: getattr(snap.caps, d) for d in ("N", "M", "E", "K", "KP",
                                               "LV")}


def job_pod(api, name, job, uid, node_name=""):
    """A pod of a 1.11 Job: 100m / 128Mi, the `controller-uid` and
    `job-name` labels the Job controller stamps, owned by the Job."""
    return api.Pod(
        metadata=api.ObjectMeta(
            name=name, labels={"controller-uid": uid, "job-name": job},
            owner_references=[api.OwnerReference(
                kind="Job", name=job, uid=uid, controller=True)]),
        spec=api.PodSpec(node_name=node_name, containers=[api.Container(
            resources=api.ResourceRequirements(
                requests=api.resource_list(cpu="100m", memory="128Mi")))]))


def resident_world(mods, enc, bucket_size, n_nodes, n_resident, n_extra,
                   device, seed, **kw):
    """build_store's 5 000-node shape (no backlog) with n_resident density
    pods (tolerating every taint) bound round-robin over the nodes at
    creation (the scheduler
    adds them to its mirror at start), on a virtual clock; caps sized
    for n_extra more pods. Returns (store, scheduler, clock)."""
    api, Scheduler, PodBackoff, store_mod = mods[0], mods[5], mods[6], \
        mods[7]
    store, n_bound = build_store(api, store_mod, n_nodes, 0, seed)
    for j in range(n_resident):
        p = batch_pod(api, f"res-{j}", "density", "100m", None)
        p.spec.node_name = f"node-{j % n_nodes}"
        # daemon-style, as build_store's port holders: bound on tainted
        # nodes too
        p.spec.tolerations = [api.Toleration(
            operator=api.TOLERATION_OP_EXISTS)]
        store.create("pods", p)
    clock = VirtualClock()
    caps = scheduler_caps(enc, bucket_size, n_nodes, n_extra,
                          n_resident + n_bound)
    sched = Scheduler(store, wave_size=WAVE, caps=caps, device=device,
                      clock=clock,
                      backoff=PodBackoff(initial=0.001, clock=clock), **kw)
    return store, sched, clock


def capacity_state(sched) -> dict:
    m = sched.metrics
    return {"capacity_faults": int(m.capacity_faults.value),
            "oom_compactions": int(m.snapshot_compactions_total.value(
                trigger="oom")),
            "breaker": sched.breaker.state, "trips": sched.breaker.trips,
            "convictions": sched.poison_convictions,
            "quarantined": sched.queue.quarantine_count(),
            "strikes": sched._capacity_strikes, "wave_cap": sched._wave_cap}


def oom_run(torch, mods, enc, bucket_size, faultpoints, n_pods, times,
            per_wave=False):
    """Phase 18 (a): the density world of n_pods pods at FULL_NODES nodes
    on the card, device.oom raising `times` times in a row (0: a
    fault-free run). per_wave drains through the per-wave path (the
    reference of a twin salvage). Returns (bindings, what was seen)."""
    api, tp, store_mod = mods[0], mods[1], mods[7]
    Scheduler, PodBackoff = mods[5], mods[6]
    store, n_bound = build_store(api, store_mod, FULL_NODES, n_pods,
                                 SEED + 181)
    caps = scheduler_caps(enc, bucket_size, FULL_NODES, n_pods, n_bound)
    clock = VirtualClock()
    sched = Scheduler(store, wave_size=WAVE, caps=caps, device="cuda",
                      clock=clock,
                      backoff=PodBackoff(initial=0.001, clock=clock))
    seconds = []
    compact = sched.scrubber.compact

    def timed(*a, **kw):
        t0 = time.monotonic()
        try:
            return compact(*a, **kw)
        finally:
            seconds.append(time.monotonic() - t0)

    sched.scrubber.compact = timed
    if times:
        faultpoints.activate("device.oom", "raise", times=times)
    launches0 = tp.taint_ports_masks.launches
    t0 = time.monotonic()
    placed = drain_per_wave(sched) if per_wave else sched.schedule_pending()
    torch.cuda.synchronize()
    seen = capacity_state(sched)
    seen.update(wall=time.monotonic() - t0, placed=placed,
                launches=tp.taint_ports_masks.launches - launches0,
                hits=faultpoints.hits("device.oom"), compact_s=seconds,
                path=sched.wave_path(),
                twin_waves=int(sched.metrics.waves_total.value(path="host")))
    faultpoints.reset()
    if placed != n_pods:
        fail(f"memory: (a) placed {placed} of {n_pods} "
             f"(device.oom x{times})")
    check_bindings(api, store)
    return bindings(store), seen


def whatif_oom_run(torch, mods, enc, bucket_size, faultpoints):
    """Phase 18 (a), the what-if: FULL_NODES nodes each full with two
    8-core priority-1 hogs bound at creation, then MEM_VIPS 8-core
    priority-1000 pods on a virtual clock; device.oom raises once at the
    first preemption chunk's what-if dispatch (armed by a wrapper just
    before the call). The chunk must be salvaged on the twin and the
    drain complete. Returns what was seen."""
    api, tp, pre, sched_mod, Scheduler, PodBackoff, store_mod = (
        mods[0], mods[1], mods[2], mods[4], mods[5], mods[6], mods[7])
    store = store_mod.ObjectStore()
    add_plain_nodes(api, store, FULL_NODES)
    for i in range(FULL_NODES):
        for k in range(2):
            p = batch_pod(api, f"hog-{i}-{k}", "hog", "8", 1)
            p.spec.node_name = f"node-{i}"
            store.create("pods", p)
    add_singles(api, store, "vip", MEM_VIPS, "8", 1000)
    clock = VirtualClock()
    caps = scheduler_caps(enc, bucket_size, FULL_NODES, MEM_VIPS,
                          2 * FULL_NODES)
    sched = Scheduler(store, wave_size=WAVE, caps=caps, device="cuda",
                      clock=clock,
                      backoff=PodBackoff(initial=0.001, clock=clock))
    stats = sched_mod.preemption_stats
    calls = []

    def arming(*a, **kw):
        if not calls:
            faultpoints.activate("device.oom", "raise", times=1)
        calls.append(1)
        return stats(*a, **kw)

    sched_mod.preemption_stats = arming
    launches0 = pre.preempt_whatif.launches
    try:
        t0 = time.monotonic()
        placed = settle(sched, clock)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    finally:
        sched_mod.preemption_stats = stats
    seen = capacity_state(sched)
    seen.update(wall=wall, placed=placed, chunks=len(calls),
                whatif_launches=pre.preempt_whatif.launches - launches0,
                hits=faultpoints.hits("device.oom"),
                device_failures=int(sched.metrics.scheduling_errors.value(
                    stage="wave")),
                evicted=evictions(sched))
    faultpoints.reset()
    vips = [p for p in store.list("pods")
            if p.metadata.name.startswith("vip-")]
    if placed != MEM_VIPS or not all(p.spec.node_name for p in vips):
        fail(f"memory: (a) the what-if drain placed {placed} of "
             f"{MEM_VIPS} vips")
    if (seen["hits"], seen["device_failures"], seen["capacity_faults"],
            seen["breaker"], seen["trips"]) != (1, 1, 0, "closed", 0):
        fail(f"memory: (a) the what-if's device.oom: {seen}")
    if seen["whatif_launches"] < 1:
        fail("memory: (a) no what-if chunk launched the kernel")
    check_bindings(api, store)
    return seen


def churn_run(torch, mods, enc, bucket_size, n_nodes, n_resident,
              job_pods, device, compact, log_cycles):
    """Phase 18 (b): n_resident density pods bound at start; MEM_CYCLES
    cycles of MEM_JOBS Jobs x job_pods pods, each Job with its own
    controller-uid and job-name values, bound (one drain) and deleted;
    with `compact`, the compaction cadence (a virtual-clock
    compact_interval, crossed every MEM_COMPACT_EVERY cycles) runs from
    housekeeping. Returns (the cycles' bindings, what was seen, store,
    scheduler)."""
    api = mods[0]
    store, sched, clock = resident_world(
        mods, enc, bucket_size, n_nodes, n_resident, MEM_JOBS * job_pods,
        device, SEED + 183,
        compact_interval=MEM_COMPACT_S if compact else None)
    snap = sched.snapshot
    ups = []
    to_device = snap.to_device

    def counted(*a, **kw):
        before = snap.upload_bytes_total
        out = to_device(*a, **kw)
        ups.append(snap.upload_bytes_total - before)
        return out

    snap.to_device = counted
    comp_s = []
    compact_fn = sched.scrubber.compact

    def timed(*a, **kw):
        t0 = time.monotonic()
        try:
            return compact_fn(*a, **kw)
        finally:
            comp_s.append(time.monotonic() - t0)

    sched.scrubber.compact = timed
    cuda = device == "cuda"
    got, cycles = [], []
    for c in range(MEM_CYCLES):
        names = []
        for j in range(MEM_JOBS):
            job = f"job-{c}-{j}"
            uid = f"{SEED:x}-{c:04x}-{j:04x}"
            for k in range(job_pods):
                store.create("pods", job_pod(api, f"{job}-{k}", job, uid))
                names.append(f"{job}-{k}")
        n_up = len(ups)
        placed = sched.schedule_pending()
        if cuda:
            torch.cuda.synchronize()
        if placed != len(names):
            fail(f"memory: (b) cycle {c} placed {placed} of {len(names)}")
        b = bindings(store)
        got.append({n: b[n] for n in names})
        for n in names:
            store.delete("pods", "default", n)
        row = {"cycle": c, "uploads": ups[n_up:],
               "vocabs": dict(snap.vocabs.sizes()),
               "caps": memory_caps(snap),
               "projected": snap.projected_hbm_bytes()}
        if cuda:
            row["allocated"] = torch.cuda.memory_allocated()
        n_comp = len(comp_s)
        if compact and (c + 1) % MEM_COMPACT_EVERY == 0:
            clock.t += MEM_COMPACT_S
            sched._housekeep()
            if len(comp_s) != n_comp + 1:
                fail(f"memory: (b) the cadence did not compact after "
                     f"cycle {c}")
            row["compact_s"] = comp_s[-1]
            row["after"] = dict(snap.vocabs.sizes())
            row["caps_after"] = memory_caps(snap)
            row["projected_after"] = snap.projected_hbm_bytes()
            if cuda:
                row["allocated_after"] = torch.cuda.memory_allocated()
        cycles.append(row)
        if log_cycles:
            extra = ""
            if "compact_s" in row:
                extra = (f"; compacted in {row['compact_s']:.3f} s: "
                         f"label_values {row['after']['label_values']}, "
                         f"caps {row['caps_after']}, projected "
                         f"{row['projected_after']} B, "
                         f"memory_allocated {row.get('allocated_after')}")
            log(f"[memory] (b) cycle {c}: {placed} Job pods bound and "
                f"deleted; uploads {row['uploads']} B; label_values "
                f"{row['vocabs']['label_values']}, pod_label_keys "
                f"{row['vocabs']['pod_label_keys']}; caps {row['caps']}; "
                f"projected {row['projected']} B; memory_allocated "
                f"{row.get('allocated')}" + extra)
    # the upload after the last cycle (a full one, past a compaction)
    n_up = len(ups)
    snap.to_device(device)
    cycles.append({"cycle": MEM_CYCLES, "uploads": ups[n_up:]})
    snap.to_device = to_device
    sched.scrubber.compact = compact_fn
    return got, cycles, store, sched


def churn_checks(cycles, full_bytes):
    """Row deltas engage again after every compaction (the first upload
    after it is a full one, the next a delta) and the label-value
    vocabulary plateaus (every compaction leaves the same size)."""
    after = [r["after"]["label_values"] for r in cycles if "after" in r]
    if not after or len(set(after)) != 1:
        fail(f"memory: (b) label_values after the compactions: {after}")
    for i, r in enumerate(cycles[:-1]):
        if "after" not in r:
            continue
        first = cycles[i + 1]["uploads"]
        if not first or first[0] < full_bytes:
            fail(f"memory: (b) the upload after cycle {i}'s compaction "
                 f"moved {first} B, not a full {full_bytes} B")
        if i + 2 < len(cycles) and cycles[i + 2]["uploads"] and \
                cycles[i + 2]["uploads"][0] * 4 >= full_bytes:
            fail(f"memory: (b) the second upload after cycle {i}'s "
                 f"compaction moved {cycles[i + 2]['uploads'][0]} B: no "
                 "row delta")
    return after[0]


def governor_run(torch, mods, store, sched):
    """Phase 18 (c) on (b)'s settled scheduler: a budget just above the
    footprint, then one wave whose pods carry MEM_GOV_KEYS new label
    keys and values: the pod-label-key bucket grows past the budget, a
    compaction is demanded and the next housekeeping pass runs it; the
    breaker untouched. Returns what was seen."""
    api = mods[0]
    snap = sched.snapshot
    snap.hbm_budget_bytes = snap.projected_hbm_bytes() + MEM_GOV_SLACK
    caps0 = memory_caps(snap)
    for k in range(WAVE):
        p = batch_pod(api, f"gov-{k}", "gov", "100m", None)
        p.metadata.labels.update({f"gov-key-{i}": f"gov-{k}-{i}"
                                  for i in range(MEM_GOV_KEYS)})
        store.create("pods", p)
    placed = sched.schedule_pending()
    torch.cuda.synchronize()
    seen = {"placed": placed, "caps_before": caps0,
            "caps_grown": memory_caps(snap),
            "requested": snap.compaction_requested,
            "headroom_before": snap.hbm_headroom_bytes(),
            "budget": snap.hbm_budget_bytes}
    t0 = time.monotonic()
    sched._housekeep()
    seen.update(housekeep_s=time.monotonic() - t0,
                governor=int(sched.metrics.snapshot_compactions_total.value(
                    trigger="governor")),
                headroom_after=snap.hbm_headroom_bytes(),
                caps_after=memory_caps(snap),
                gauge=sched.metrics.hbm_headroom_bytes.value,
                breaker=sched.breaker.state,
                failures=sched.breaker.failures,
                requested_after=snap.compaction_requested,
                last=sched.scrubber.last_compaction)
    if placed != WAVE or not seen["requested"] or seen["governor"] != 1 \
            or seen["requested_after"]:
        fail(f"memory: (c) the governor: {seen}")
    if (seen["breaker"], seen["failures"]) != ("closed", 0):
        fail(f"memory: (c) the governor touched the breaker: {seen}")
    for k in range(WAVE):
        store.delete("pods", "default", f"gov-{k}")
    snap.hbm_budget_bytes = 0
    return seen


def corrupt_rows(sched, faultpoints, names):
    """snapshot.write in its default corrupt mode (4 phantom cores of
    allocatable CPU), bounded to len(names) fires, while the resource
    rows of those nodes are refreshed."""
    faultpoints.activate("snapshot.write", "corrupt", times=len(names))
    for name in names:
        sched.snapshot.refresh_node_resources(sched.cache.node_infos[name])
    hits = faultpoints.hits("snapshot.write")
    faultpoints.reset()
    return hits


def scrub_run(torch, sched, faultpoints, device, n_nodes):
    """Phase 18 (d): MEM_CORRUPT node rows corrupted, then one scrub: it
    must report exactly those rows (alloc) and repair them, and the next
    upload must be row deltas. Returns what was seen."""
    snap = sched.snapshot
    snap.to_device(device)
    full = snap.hbm_bytes()
    names = [f"node-{i}" for i in range(0, n_nodes, n_nodes // MEM_CORRUPT)
             ][:MEM_CORRUPT]
    hits = corrupt_rows(sched, faultpoints, names)
    t0 = time.monotonic()
    rep = sched.scrubber.scrub()
    scrub_s = time.monotonic() - t0
    got = sorted((d.node, tuple(d.fields), d.repaired)
                 for d in rep.divergences)
    want = sorted((n, ("alloc",), True) for n in names)
    if hits != MEM_CORRUPT or got != want:
        fail(f"memory: (d) {hits} corruptions, the scrub reported "
             f"{got[:10]}")
    if not sched.scrubber.scrub().clean:
        fail("memory: (d) a second scrub is not clean")
    before = snap.upload_bytes_total
    snap.to_device(device)
    moved = snap.upload_bytes_total - before
    if not 0 < moved * 4 < full:
        fail(f"memory: (d) the upload after the repair moved {moved} B of "
             f"{full} B: no row delta")
    return {"scrub_s": scrub_s, "nodes": rep.nodes_checked,
            "pods": rep.pods_checked, "delta": moved, "full": full}


def scrub_parity(torch, mods, enc, bucket_size, faultpoints):
    """Phase 18 (d) on two 500-node copies on the card: one corrupted
    (MEM_CORRUPT rows) and scrubbed, one clean; the next drain of
    MEM_SCRUB_PODS density pods binds alike in both."""
    api = mods[0]
    got = {}
    for corrupted in (True, False):
        store, sched, clock = resident_world(
            mods, enc, bucket_size, MEM_SMALL_NODES, MEM_SMALL_RESIDENT,
            MEM_SCRUB_PODS, "cuda", SEED + 185)
        sched.snapshot.to_device("cuda")
        if corrupted:
            seen = scrub_run(torch, sched, faultpoints, "cuda",
                             MEM_SMALL_NODES)
        add_chunk(api, store, "after", 0, MEM_SCRUB_PODS)
        n = sched.schedule_pending()
        torch.cuda.synchronize()
        if n != MEM_SCRUB_PODS:
            fail(f"memory: (d) the drain after the scrub placed {n}")
        check_bindings(api, store)
        got[corrupted] = bindings(store)
    if got[True] != got[False]:
        diff = [k for k in got[False] if got[False][k] != got[True].get(k)]
        fail(f"memory: (d) the drain after the repair differs from a clean "
             f"run's for {len(diff)} pods, e.g. {diff[:5]}")
    return seen


def storm_run(torch, mods, enc, bucket_size, watermark):
    """Phase 18 (e): tests/test_storm.py's burst at FULL_NODES nodes on a
    virtual clock: each tick STORM_BURST priority-0 pods with one pod at
    HIGH_PRIORITY_BAND after every STORM_EVERY of them, then one wave
    (run_once); after STORM_LOW low pods, one wave a tick until nothing
    is pending. The bind order and times are read from the store's
    events. Returns what was seen."""
    api, store_mod, Scheduler = mods[0], mods[7], mods[5]
    from kubernetes_tpu_torch.sched.queue import HIGH_PRIORITY_BAND

    store, n_bound = build_store(api, store_mod, FULL_NODES, 0, SEED + 187)
    clock = VirtualClock()
    caps = scheduler_caps(enc, bucket_size, FULL_NODES,
                          STORM_LOW + STORM_HIGH, n_bound)
    sched = Scheduler(store, wave_size=WAVE, caps=caps, device="cuda",
                      clock=clock, shed_watermark=watermark,
                      shed_age_s=STORM_AGE_S)
    arrived, order, shed_order = {}, [], []

    def watch(ev):
        p = ev.obj
        if p.spec.node_name and p.metadata.name in arrived and \
                p.metadata.name not in bound_at:
            bound_at[p.metadata.name] = clock.t
            order.append(p.metadata.name)

    bound_at = {}
    store.watch("pods", watch)
    shed_seen = set()
    low = high = 0
    t0 = time.monotonic()
    ticks = 0
    while low < STORM_LOW:
        clock.t += 1.0
        ticks += 1
        for _ in range(STORM_BURST):
            if low >= STORM_LOW:
                break
            name = f"low-{low}"
            store.create("pods", batch_pod(api, name, "storm", "100m", 0))
            arrived[name] = clock.t
            low += 1
            if low % STORM_EVERY == 0 and high < STORM_HIGH:
                name = f"high-{high}"
                store.create("pods", batch_pod(api, name, "storm", "100m",
                                               HIGH_PRIORITY_BAND))
                arrived[name] = clock.t
                high += 1
        sched.run_once()
        for p in sched.queue.shed_pods():
            if p.metadata.name not in shed_seen:
                shed_seen.add(p.metadata.name)
                shed_order.append(p.metadata.name)
    storm_s = time.monotonic() - t0
    # the storm is over: one wave a tick until the backlog is gone
    t1 = time.monotonic()
    placed = drain_ticks = 0
    while sched.pending_count() and drain_ticks < STORM_DRAIN_TICKS:
        clock.t += 1.0
        drain_ticks += 1
        placed += sched.run_once()
    torch.cuda.synchronize()
    drain_s = time.monotonic() - t1
    if len(bound_at) != len(arrived):
        fail(f"memory: (e) {len(arrived) - len(bound_at)} of "
             f"{len(arrived)} storm pods never bound (watermark "
             f"{watermark})")
    lat = {"high": [], "low": []}
    for name, t in arrived.items():
        lat[name.split("-")[0]].append(bound_at[name] - t)
    m = sched.metrics
    seen = {"ticks": ticks, "storm_s": storm_s, "drain_s": drain_s,
            "drain_ticks": drain_ticks,
            "placed": placed, "shed": shed_order,
            "shed_total": {c.name: c.value for c in m.shed_total.children()},
            "p99": {k: p99(v) for k, v in lat.items()},
            "p99_hist": m.pod_scheduling_latency.quantile(0.99)}
    if shed_order:
        pos = {n: i for i, n in enumerate(order)}
        first_shed = min(pos[n] for n in shed_order)
        last_high = max(pos[n] for n in order if n.startswith("high-"))
        if last_high > first_shed:
            fail(f"memory: (e) a high pod bound after a shed pod "
                 f"(positions {last_high} > {first_shed})")
        if sorted(shed_order, key=pos.get) != shed_order:
            fail("memory: (e) the shed area did not drain oldest first")
        if m.shed_total.value(**{"class": "high"}):
            fail("memory: (e) a high pod was shed")
    check_bindings(api, store)
    return seen


def p99(values):
    v = sorted(values)
    return v[min(len(v) - 1, int(0.99 * len(v)))] if v else 0.0


def memory_phase(torch, mods, enc, bucket_size, faultpoints):
    """Phase 18: (a) the capacity-fault ladder, (b) churn and compaction,
    (c) the budget governor, (d) the scrubber, (e) the storm."""
    tp, pre = mods[1], mods[2]
    t_phase = time.monotonic()
    # both kernels' counts from 0 over the whole phase (the what-if OOM
    # run wraps the scheduler's what-if entry; the wrapper counts alone)
    tp.taint_ports_masks.launches = 0
    pre.preempt_whatif.launches = 0
    # (a) the OOM ladder
    t0 = time.monotonic()
    clean, cs = oom_run(torch, mods, enc, bucket_size, faultpoints,
                        MEM_OOM_PODS, 0)
    faulted, fs = oom_run(torch, mods, enc, bucket_size, faultpoints,
                          MEM_OOM_PODS, 1)
    torch.cuda.empty_cache()
    want = {"capacity_faults": 1, "oom_compactions": 1,
            "breaker": "closed", "trips": 0, "convictions": 0,
            "quarantined": 0, "strikes": 0, "wave_cap": WAVE}
    if {k: fs[k] for k in want} != want or fs["path"] != "cuda":
        fail(f"memory: (a) one device.oom: {fs}")
    if faulted != clean:
        diff = [k for k in clean if clean[k] != faulted.get(k)]
        fail(f"memory: (a) one device.oom: bindings differ from the "
             f"fault-free run's for {len(diff)} pods, e.g. {diff[:5]}")
    log(f"[memory] (a) {MEM_OOM_PODS} density pods, device.oom once in the "
        f"first round: strike 1 compacted in {fs['compact_s'][0]:.3f} s and "
        f"retried, {fs['placed']} placed in {fs['wall']:.3f} s (fault-free "
        f"{cs['wall']:.3f} s); capacity_faults 1, breaker CLOSED, no "
        "conviction; bindings == the fault-free run's")
    t1 = time.monotonic()
    salvaged, ss = oom_run(torch, mods, enc, bucket_size, faultpoints,
                           MEM_STRIKE_PODS, 3)
    per_wave, ws = oom_run(torch, mods, enc, bucket_size, faultpoints,
                           MEM_STRIKE_PODS, 0, per_wave=True)
    torch.cuda.empty_cache()
    want = {"capacity_faults": 3, "oom_compactions": 3,
            "breaker": "closed", "trips": 0, "convictions": 0,
            "quarantined": 0, "strikes": 3, "wave_cap": WAVE // 4}
    if {k: ss[k] for k in want} != want or ss["path"] != "host":
        fail(f"memory: (a) three device.oom: {ss}")
    if salvaged != per_wave:
        diff = [k for k in per_wave if per_wave[k] != salvaged.get(k)]
        fail(f"memory: (a) the strike-3 salvage differs from the per-wave "
             f"drain on the card for {len(diff)} pods, e.g. {diff[:5]}")
    log(f"[memory] (a) {MEM_STRIKE_PODS} density pods, device.oom three "
        f"times: strikes 1-3 compacted ({', '.join(f'{s:.3f}' for s in ss['compact_s'])} s), "
        f"strikes 2 and 3 halved the wave cap (to {ss['wave_cap']}), "
        f"strike 3 salvaged the round through the twin ({ss['twin_waves']} twin "
        f"waves) in {ss['wall']:.3f} s; bindings == the per-wave drain on "
        f"the card ({ws['wall']:.3f} s); breaker CLOSED, "
        f"{time.monotonic() - t1:.1f} s")
    t1 = time.monotonic()
    wi = whatif_oom_run(torch, mods, enc, bucket_size, faultpoints)
    torch.cuda.empty_cache()
    log(f"[memory] (a) the preempt world ({FULL_NODES} nodes full of hogs, "
        f"{MEM_VIPS} vips): device.oom at the first what-if chunk: charged "
        f"to the breaker once (scheduling_errors{{stage=wave}} "
        f"{wi['device_failures']}, breaker {wi['breaker']}), the chunk "
        f"salvaged on the twin; {wi['chunks']} chunks, "
        f"{wi['whatif_launches']} what-if launches, {wi['evicted']} "
        f"evictions, all {wi['placed']} vips bound in {wi['wall']:.3f} s; "
        f"{time.monotonic() - t1:.1f} s")
    log(f"[memory] (a) {time.monotonic() - t0:.1f} s")
    # (b) churn and compaction at full size
    t0 = time.monotonic()
    got_full, cycles, store, sched = churn_run(
        torch, mods, enc, bucket_size, FULL_NODES, MEM_RESIDENT,
        MEM_JOB_PODS, "cuda", True, True)
    full_bytes = sched.snapshot.hbm_bytes()
    lv = churn_checks(cycles, full_bytes)
    comp = [r["compact_s"] for r in cycles if "compact_s" in r]
    freed = [r["allocated"] - r["allocated_after"] for r in cycles
             if "allocated_after" in r]
    if not freed or min(freed) <= 0:
        fail(f"memory: (b) a compaction freed no device memory: {freed}")
    log(f"[memory] (b) {FULL_NODES} nodes, {MEM_RESIDENT} resident pods, "
        f"{MEM_CYCLES} cycles of {MEM_JOBS} Jobs x {MEM_JOB_PODS} pods: "
        f"{len(comp)} compactions ({', '.join(f'{s:.3f}' for s in comp)} "
        f"s), label_values {lv} after each; device memory freed by each "
        f"{freed} B; full upload {full_bytes} B, the last re-upload "
        f"{cycles[-1]['uploads']} B; {time.monotonic() - t0:.1f} s")
    # (c) the governor on the settled scheduler
    t1 = time.monotonic()
    gov = governor_run(torch, mods, store, sched)
    log(f"[memory] (c) budget {gov['budget']} B (the footprint + "
        f"{MEM_GOV_SLACK} B); a wave of {WAVE} pods with {MEM_GOV_KEYS} new "
        f"label keys grew caps {gov['caps_before']} -> {gov['caps_grown']}, "
        f"headroom {gov['headroom_before']} B, compaction demanded; "
        f"housekeeping ran it (trigger governor, {gov['housekeep_s']:.3f} "
        f"s, shrunk {gov['last']['shrunk']}): caps {gov['caps_after']}, "
        f"headroom {gov['headroom_after']} B (gauge {gov['gauge']}); "
        f"breaker {gov['breaker']}, failures {gov['failures']}; "
        f"{time.monotonic() - t1:.1f} s")
    # (d) the scrubber at full size, then card drains at 500 nodes
    t1 = time.monotonic()
    sd = scrub_run(torch, sched, faultpoints, "cuda", FULL_NODES)
    log(f"[memory] (d) {MEM_CORRUPT} node rows corrupted by snapshot.write "
        f"(corrupt): the scrub of {sd['nodes']} nodes and {sd['pods']} "
        f"bound pods took {sd['scrub_s']:.3f} s, reported exactly those "
        f"rows (alloc) and repaired them; the next upload {sd['delta']} B "
        f"of {sd['full']} B (row deltas)")
    del store, sched
    torch.cuda.empty_cache()
    scrub_parity(torch, mods, enc, bucket_size, faultpoints)
    log(f"[memory] (d) {MEM_SMALL_NODES} nodes: the drain of "
        f"{MEM_SCRUB_PODS} pods after the repair == a clean run's on the "
        f"card; {time.monotonic() - t1:.1f} s")
    # (b) card == CPU and compaction on == off at 500 nodes
    t1 = time.monotonic()
    small = {}
    for device in ("cuda", "cpu"):
        for on in (True, False):
            small[device, on], cyc, _, _ = churn_run(
                torch, mods, enc, bucket_size, MEM_SMALL_NODES,
                MEM_SMALL_RESIDENT, MEM_SMALL_JOB_PODS, device, on, False)
            if device == "cuda" and not on:
                grown = [r["vocabs"]["label_values"] for r in cyc[:-1]]
    if len({repr(v) for v in small.values()}) != 1:
        fail("memory: (b) the 500-node cycles bind differently across "
             "card/CPU and compaction on/off")
    log(f"[memory] (b) {MEM_SMALL_NODES} nodes, {MEM_SMALL_RESIDENT} "
        f"resident pods, {MEM_CYCLES} cycles of {MEM_JOBS} Jobs x "
        f"{MEM_SMALL_JOB_PODS} pods: card == CPU and compaction on == off "
        f"(bindings of every cycle); without compaction label_values grew "
        f"{grown[0]} -> {grown[-1]}; {time.monotonic() - t1:.1f} s")
    torch.cuda.empty_cache()
    # (e) the storm, shedding on and off
    t0 = time.monotonic()
    storms = {}
    for wm in (STORM_WATERMARK, 0):
        storms[wm] = storm_run(torch, mods, enc, bucket_size, wm)
        s = storms[wm]
        log(f"[memory] (e) shed_watermark {wm}: {STORM_LOW} low and "
            f"{STORM_HIGH} high pods over {s['ticks']} ticks of one wave "
            f"({s['storm_s']:.3f} s), then {s['drain_ticks']} ticks placing "
            f"{s['placed']} ({s['drain_s']:.3f} s); shed {len(s['shed'])} "
            f"({s['shed_total']}), every pod bound; p99 latency on the "
            f"virtual clock: high {s['p99']['high']:.1f} s, low "
            f"{s['p99']['low']:.1f} s (pod_scheduling_latency p99 "
            f"{s['p99_hist']:.1f} s)")
        torch.cuda.empty_cache()
    if not storms[STORM_WATERMARK]["shed"] or storms[0]["shed"]:
        fail("memory: (e) shedding did not engage with the watermark, or "
             "did without it")
    log(f"[memory] (e) every high pod bound before any shed pod, the shed "
        f"area drained oldest first; {time.monotonic() - t0:.1f} s")
    launches = tp.taint_ports_masks.launches
    whatif_launches = pre.preempt_whatif.launches
    if launches < 1:
        fail("memory: the taint/port kernel never launched")
    log(f"[memory] taint/port launches {launches}, what-if launches "
        f"{whatif_launches}; phase {time.monotonic() - t_phase:.1f} s")
    return {"launches": launches, "whatif_launches": whatif_launches}


# -- phase 19: the store plane ------------------------------------------------------


class OutageWorld:
    """Phase 19's density world, built once: build_store's FULL_NODES
    nodes with their bound port holders and 2 x STORE_PODS pending density
    pods, in two batches. Each run gets a store of deep copies of it (a
    store stamps the objects it holds), so every run starts alike."""

    def __init__(self, api, store_mod, enc, bucket_size, seed):
        tmpl, self.n_bound = build_store(api, store_mod, FULL_NODES,
                                         2 * STORE_PODS, seed)
        self.store_mod = store_mod
        self.nodes = tmpl.list("nodes")
        pods = tmpl.list("pods")
        self.holders = [p for p in pods if p.spec.node_name]
        pending = [p for p in pods if not p.spec.node_name]
        self.batches = (pending[:STORE_PODS], pending[STORE_PODS:])
        self.caps = scheduler_caps(enc, bucket_size, FULL_NODES,
                                   2 * STORE_PODS, self.n_bound)

    def store(self):
        store = self.store_mod.ObjectStore()
        for node in self.nodes:
            store.create("nodes", copy.deepcopy(node))
        for p in self.holders:
            store.create("pods", copy.deepcopy(p))
        return store

    def add(self, store, batch):
        for p in self.batches[batch]:
            store.create("pods", copy.deepcopy(p))


def store_sched(mods, world, store, clock, **kw):
    """A card Scheduler of phase 19: the store breaker's cooldown
    STORE_COOLDOWN_S, its jitter and the reconciler's pinned at 0.5 (the
    probe exactly trip + cooldown; the reconciler's real sleeps 0.05 s
    and 0.1 s)."""
    sched = mods[5](store, wave_size=WAVE, caps=world.caps, device="cuda",
                    clock=clock, store_breaker_cooldown=STORE_COOLDOWN_S,
                    **kw)
    sched.storehealth.jitter = lambda: 0.5
    sched.reconciler.jitter = lambda: 0.5
    return sched


def bind_counter(store_mod, store):
    """Counts each pod's binds (MODIFIED events that set nodeName)."""
    binds = {}

    def on_pod(ev):
        if ev.type == store_mod.MODIFIED and ev.obj.spec.node_name and not (
                ev.old is not None and ev.old.spec.node_name):
            binds[ev.obj.metadata.name] = binds.get(ev.obj.metadata.name,
                                                    0) + 1

    store.watch("pods", on_pod)
    return binds


class Timer:
    """Wall seconds spent in a wrapped callable."""

    def __init__(self, fn):
        self.fn, self.s, self.calls = fn, 0.0, 0

    def __call__(self, *a, **kw):
        t = time.perf_counter()
        try:
            return self.fn(*a, **kw)
        finally:
            self.s += time.perf_counter() - t
            self.calls += 1


def journal_bytes(journal) -> int:
    return sum(Path(p).stat().st_size for p in journal._segments())


def clean_run(torch, mods, world):
    """The fault-free run: the first batch drained, then the second.
    Returns (bindings, seen)."""
    store = world.store()
    sched = store_sched(mods, world, store, VirtualClock())
    seen = {}
    for k in (0, 1):
        world.add(store, k)
        t0 = time.monotonic()
        seen[f"placed{k}"] = sched.schedule_pending()
        torch.cuda.synchronize()
        seen[f"s{k}"] = time.monotonic() - t0
    if sched.storehealth.trips or sched.spool_count():
        fail("store: the fault-free run tripped the store breaker")
    check_bindings(mods[0], store)
    return bindings(store), seen


def outage_run(torch, mods, world, faultpoints, path, crash):
    """Phase 19 (a), and (b)'s first process: the first batch drained with
    the store up; store.outage armed (raise, unbounded) and the second
    batch drained: every bind spools, its intent journaled at `path`.
    crash: the scheduler is abandoned there, spool and all (its watches
    dropped, no close, no drain), and the store stays dark. Otherwise
    disarmed, the clock moved past the probe deadline and one run_once
    drains the spool. Returns (store, the bind counts, the scheduler,
    what was seen)."""
    store_mod = mods[7]
    store = world.store()
    binds = bind_counter(store_mod, store)
    clock = VirtualClock()
    n_watch = len(store._watchers)
    sched = store_sched(mods, world, store, clock, bind_journal_path=path,
                        bind_journal_max_bytes=STORE_JOURNAL_BYTES)
    watches = store._watchers[n_watch:]
    states = [("start", sched.storehealth.state)]
    world.add(store, 0)
    t0 = time.monotonic()
    placed0 = sched.schedule_pending()
    torch.cuda.synchronize()
    seen = {"s0": time.monotonic() - t0, "placed0": placed0}
    states.append(("first batch", sched.storehealth.state))
    spool = sched._spool_bind = Timer(sched._spool_bind)
    append = sched.journal.append_intent = Timer(sched.journal.append_intent)
    reconcile = sched.reconciler.reconcile = Timer(sched.reconciler.reconcile)
    hits0 = faultpoints.hits("store.outage")
    faultpoints.activate("store.outage", "raise", times=10 ** 9)
    world.add(store, 1)
    t0 = time.monotonic()
    seen["placed1"] = sched.schedule_pending()
    torch.cuda.synchronize()
    seen["s1"] = time.monotonic() - t0
    states.append(("outage", sched.storehealth.state))
    seen.update(spool_s=spool.s, append_s=append.s, appends=append.calls,
                reconcile_s=reconcile.s, reconciles=reconcile.calls,
                spooled=sched.spool_count(),
                journal_bytes=journal_bytes(sched.journal),
                rotations=sched.journal.rotations,
                hits=faultpoints.hits("store.outage") - hits0,
                binds_spooled=int(sched.metrics.binds_spooled.value),
                retry_in=sched.storehealth.retry_at - clock.t)
    if (seen["spooled"] != STORE_PODS or seen["placed1"] != STORE_PODS
            or sched.storehealth.state != "disconnected"
            or seen["binds_spooled"] != STORE_PODS
            or sched.storehealth.trips != 1):
        fail(f"store: the outage did not spool every bind: {seen}, breaker "
             f"{sched.storehealth.state} with {sched.storehealth.trips} trips")
    # the first bind: three POSTs and its truth GET; then none
    if seen["hits"] != 4:
        fail(f"store: store.outage hit {seen['hits']} times, not 3 + 1")
    if any(n != 1 for n in binds.values()) or len(binds) != STORE_PODS:
        fail(f"store: {len(binds)} pods bound before the outage's drain")
    seen["states"] = states
    if crash:
        for _, fn in watches:
            store.unwatch(fn)
        return store, binds, sched, seen
    faultpoints.deactivate("store.outage")
    clock.t += STORE_COOLDOWN_S + 1.0
    resolve = sched.journal.resolve = Timer(sched.journal.resolve)
    t0 = time.monotonic()
    sched.run_once()
    torch.cuda.synchronize()
    seen.update(drain_s=time.monotonic() - t0, resolve_s=resolve.s,
                resolves=resolve.calls)
    states.append(("healed", sched.storehealth.state))
    if (sched.spool_count() or sched.journal.unresolved()
            or sched.cache.assumed_pods()
            or sched.storehealth.state != "connected"):
        fail(f"store: (a) after the heal: spool {sched.spool_count()}, "
             f"{len(sched.journal.unresolved())} unresolved, "
             f"{len(sched.cache.assumed_pods())} assumed, breaker "
             f"{sched.storehealth.state}")
    return store, binds, sched, seen


def replay_run(torch, mods, world, faultpoints, path, clean):
    """Phase 19 (b): outage_run's process abandoned with its spool; a
    fresh Scheduler over the same store and journal, the store still
    dark: its construction replays every intent (timed alone), each
    re-spooled under its seq; healed, one run_once drains them."""
    sched_mod = mods[4]
    store, binds, old, seen = outage_run(torch, mods, world, faultpoints,
                                         path, crash=True)
    seqs = [e[4] for e in old._spool]
    if old.journal.rotations != 1:
        fail(f"store: (b) the journal rotated {old.journal.rotations} times "
             f"over {STORE_PODS} intents, not once")
    replay = Timer(sched_mod.Scheduler.recover_from_journal)
    sched_mod.Scheduler.recover_from_journal = (
        lambda self: replay(self))
    clock = VirtualClock()
    t0 = time.monotonic()
    try:
        fresh = store_sched(mods, world, store, clock, bind_journal_path=path,
                            bind_journal_max_bytes=STORE_JOURNAL_BYTES)
    finally:
        sched_mod.Scheduler.recover_from_journal = replay.fn
    seen.update(construct_s=time.monotonic() - t0, replay_s=replay.s,
                respooled=fresh.spool_count(),
                state_replayed=fresh.storehealth.state)
    if [e[4] for e in fresh._spool] != seqs or fresh.queue.pending_count():
        fail(f"store: (b) the replay re-spooled {fresh.spool_count()} of "
             f"{len(seqs)} intents (seqs kept: "
             f"{[e[4] for e in fresh._spool] == seqs}), "
             f"{fresh.queue.pending_count()} pods left pending")
    faultpoints.deactivate("store.outage")
    clock.t += STORE_COOLDOWN_S + 1.0
    resolve = fresh.journal.resolve = Timer(fresh.journal.resolve)
    t0 = time.monotonic()
    fresh.run_once()
    torch.cuda.synchronize()
    seen.update(drain_s=time.monotonic() - t0, resolve_s=resolve.s,
                resolves=resolve.calls)
    if (fresh.spool_count() or fresh.journal.unresolved()
            or fresh.cache.assumed_pods()
            or fresh.storehealth.state != "connected"):
        fail(f"store: (b) after the heal: spool {fresh.spool_count()}, "
             f"{len(fresh.journal.unresolved())} unresolved, "
             f"{len(fresh.cache.assumed_pods())} assumed, breaker "
             f"{fresh.storehealth.state}")
    twice = sorted(k for k, n in binds.items() if n != 1)
    if twice or len(binds) != 2 * STORE_PODS:
        fail(f"store: (b) {len(binds)} pods bound, {len(twice)} of them "
             f"more than once, e.g. {twice[:5]}")
    got = bindings(store)
    if got != clean:
        diff = [k for k in clean if clean[k] != got.get(k)]
        fail(f"store: (b) bindings differ from the fault-free run's for "
             f"{len(diff)} pods, e.g. {diff[:5]}")
    check_bindings(mods[0], store)
    return seen


def dormant_run(torch, mods, world, clean):
    """Phase 19 (c): the first batch drained, enter_dormant, the second
    batch created: run_once and schedule_pending place nothing;
    recover_leadership (its full scrubber.rebuild at FULL_NODES nodes
    timed), then the second batch drains to the fault-free run's
    bindings."""
    store = world.store()
    sched = store_sched(mods, world, store, VirtualClock())
    world.add(store, 0)
    sched.schedule_pending()
    sched.enter_dormant()
    world.add(store, 1)
    idle = (sched.run_once(), sched.schedule_pending())
    if idle != (0, 0) or sched.queue.active_count() != STORE_PODS:
        fail(f"store: (c) placed {idle} while dormant, "
             f"{sched.queue.active_count()} active")
    t0 = time.monotonic()
    stats = sched.recover_leadership()
    torch.cuda.synchronize()
    seen = {"recover_s": time.monotonic() - t0, "stats": stats}
    t0 = time.monotonic()
    seen["placed"] = sched.schedule_pending()
    torch.cuda.synchronize()
    seen["s1"] = time.monotonic() - t0
    got = bindings(store)
    if got != clean or sched.dormant:
        diff = [k for k in clean if clean[k] != got.get(k)]
        fail(f"store: (c) bindings after the dormant spell differ from the "
             f"fault-free run's for {len(diff)} pods, e.g. {diff[:5]}")
    return seen


def hold_run(torch, mods, world, faultpoints, path):
    """Phase 19 (d): spool_watermark STORE_WATERMARK with shed_watermark
    STORM_WATERMARK and the store dark: STORE_WATERMARK priority-0 pods
    spool; STORE_HELD more are held in the shed area; STORE_HIGH pods at
    HIGH_PRIORITY_BAND still schedule and spool; healed, one wave a tick
    until nothing is pending or spooled: every pod bound."""
    api = mods[0]
    from kubernetes_tpu_torch.sched.queue import HIGH_PRIORITY_BAND

    store = world.store()
    clock = VirtualClock()
    sched = store_sched(mods, world, store, clock, bind_journal_path=path,
                        spool_watermark=STORE_WATERMARK,
                        shed_watermark=STORM_WATERMARK,
                        shed_age_s=STORM_AGE_S)
    faultpoints.activate("store.outage", "raise", times=10 ** 9)
    add_singles(api, store, "low", STORE_WATERMARK, "100m", 0)
    sched.schedule_pending()
    seen = {"spool": sched.spool_count(), "held_on": sched._admissions_held()}
    add_singles(api, store, "late", STORE_HELD, "100m", 0)
    seen["shed"] = sched.queue.shed_count()
    add_singles(api, store, "high", STORE_HIGH, "100m", HIGH_PRIORITY_BAND)
    seen["high_placed"] = sched.schedule_pending()
    seen["spool_high"] = sched.spool_count()
    seen["shed_high"] = sched.queue.shed_count()
    want = {"spool": STORE_WATERMARK, "held_on": True, "shed": STORE_HELD,
            "high_placed": STORE_HIGH,
            "spool_high": STORE_WATERMARK + STORE_HIGH,
            "shed_high": STORE_HELD}
    if seen != want:
        fail(f"store: (d) the admission hold: {seen}, want {want}")
    faultpoints.deactivate("store.outage")
    clock.t += STORE_COOLDOWN_S + 1.0
    t0 = time.monotonic()
    ticks = 0
    while (sched.pending_count() or sched.spool_count()) and ticks < 20:
        sched.run_once()
        clock.t += 1.0
        ticks += 1
    torch.cuda.synchronize()
    seen.update(heal_s=time.monotonic() - t0, ticks=ticks)
    n = STORE_WATERMARK + STORE_HELD + STORE_HIGH
    if (sched.pending_count() or sched.spool_count()
            or sched.queue.shed_count() or sched.journal.unresolved()
            or check_bindings(api, store) != n + world.n_bound):
        fail(f"store: (d) after the heal: {sched.pending_count()} pending, "
             f"{sched.spool_count()} spooled, {sched.queue.shed_count()} "
             f"shed, {len(sched.journal.unresolved())} unresolved")
    return seen


def store_phase(torch, mods, enc, bucket_size, faultpoints):
    """Phase 19: the store plane at FULL_NODES nodes: (a) an outage against
    a fault-free run, (b) a crash and a restart that replays the journal,
    (c) a dormant spell, (d) the admission hold."""
    import tempfile

    tp, pre = mods[1], mods[2]
    t_phase = time.monotonic()
    tp.taint_ports_masks.launches = 0
    pre.preempt_whatif.launches = 0
    faultpoints.reset()
    world = OutageWorld(mods[0], mods[7], enc, bucket_size, SEED + 191)
    log(f"[store] the world: {FULL_NODES} nodes, {world.n_bound} bound port "
        f"holders, 2 x {STORE_PODS} density pods; "
        f"{time.monotonic() - t_phase:.1f} s")
    clean, cs = clean_run(torch, mods, world)
    tmp = tempfile.mkdtemp(prefix="store-phase-")
    try:
        t0 = time.monotonic()
        store, binds, sched, a = outage_run(
            torch, mods, world, faultpoints, f"{tmp}/a.journal", crash=False)
        got = bindings(store)
        if got != clean:
            diff = [k for k in clean if clean[k] != got.get(k)]
            fail(f"store: (a) bindings differ from the fault-free run's "
                 f"for {len(diff)} pods, e.g. {diff[:5]}")
        if any(n != 1 for n in binds.values()):
            fail("store: (a) a pod was bound twice")
        check_bindings(mods[0], store)
        del store, sched
        rest = a["spool_s"] - a["append_s"]
        log(f"[store] (a) {STORE_PODS} pods with the store up "
            f"({STORE_PODS / a['s0']:.1f} pods/s; fault-free "
            f"{STORE_PODS / cs['s0']:.1f}), then {STORE_PODS} with "
            f"store.outage armed: {STORE_PODS / a['s1']:.1f} pods/s "
            f"(fault-free {STORE_PODS / cs['s1']:.1f}), every bind spooled; "
            f"host seconds spooling {a['spool_s']:.4f} = journal append with "
            f"fsync {a['append_s']:.4f} ({a['appends']} appends, "
            f"{1e3 * a['append_s'] / max(a['appends'], 1):.4f} ms each) + "
            f"the rest {rest:.4f}; the reconciler {a['reconcile_s']:.4f} s "
            f"({a['reconciles']} call: the tripping bind, its real sleeps "
            f"included); journal {a['journal_bytes']} B "
            f"({a['rotations']} rotation); store.outage hits {a['hits']} "
            f"(3 POSTs and the truth GET of the first bind, then none); "
            f"the heal's drain of the spool {a['drain_s']:.4f} s, of it "
            f"{a['resolve_s']:.4f} s in {a['resolves']} fsync'd resolved "
            f"records; breaker "
            + ", ".join(f"{k} {v}" for k, v in a["states"])
            + "; bindings == the fault-free run's, no pod bound twice; "
            f"{time.monotonic() - t0:.1f} s")
        t0 = time.monotonic()
        b = replay_run(torch, mods, world, faultpoints, f"{tmp}/b.journal",
                       clean)
        log(f"[store] (b) the process abandoned with {b['spooled']} spooled "
            f"intents ({b['journal_bytes']} B of journal, {b['rotations']} "
            f"rotation); a fresh Scheduler over the same store and journal, "
            f"the store still dark: constructed in {b['construct_s']:.3f} s, "
            f"the replay of {b['respooled']} intents {b['replay_s']:.4f} s "
            f"(breaker {b['state_replayed']}), every intent re-spooled "
            f"under its seq; healed, the drain {b['drain_s']:.4f} s (of it "
            f"{b['resolve_s']:.4f} s in {b['resolves']} resolved records); "
            f"bindings == the fault-free run's, every pod bound once, "
            f"nothing assumed or unresolved; {time.monotonic() - t0:.1f} s")
    finally:
        faultpoints.reset()
        for p in Path(tmp).iterdir():
            p.unlink()
        Path(tmp).rmdir()
    t0 = time.monotonic()
    c = dormant_run(torch, mods, world, clean)
    log(f"[store] (c) dormant after the first batch: run_once and "
        f"schedule_pending placed 0; recover_leadership {c['recover_s']:.3f} "
        f"s ({c['stats']}, the full rebuild at {FULL_NODES} nodes); the "
        f"second batch {STORE_PODS / c['s1']:.1f} pods/s; bindings == the "
        f"fault-free run's; {time.monotonic() - t0:.1f} s")
    tmp = tempfile.mkdtemp(prefix="store-phase-")
    t0 = time.monotonic()
    try:
        d = hold_run(torch, mods, world, faultpoints, f"{tmp}/d.journal")
    finally:
        faultpoints.reset()
        for p in Path(tmp).iterdir():
            p.unlink()
        Path(tmp).rmdir()
    log(f"[store] (d) spool_watermark {STORE_WATERMARK}, shed_watermark "
        f"{STORM_WATERMARK}, the store dark: {d['spool']} pods spooled, "
        f"{d['shed']} arrivals held in the shed area, {d['high_placed']} "
        f"high pods scheduled and spooled past the hold; healed, "
        f"{d['ticks']} ticks of one wave in {d['heal_s']:.3f} s bound "
        f"everything; {time.monotonic() - t0:.1f} s")
    launches = tp.taint_ports_masks.launches
    whatif_launches = pre.preempt_whatif.launches
    if launches < 1:
        fail("store: the taint/port kernel never launched")
    log(f"[store] taint/port launches {launches}, what-if launches "
        f"{whatif_launches}; phase {time.monotonic() - t_phase:.1f} s")
    return {"launches": launches, "whatif_launches": whatif_launches}


# --- phase 20: HTTP extenders -------------------------------------------------


class ScriptExtender:
    """Phase 20's extender: a ThreadingHTTPServer on 127.0.0.1 (port 0) in
    this process, standard library only, logging every request as (verb,
    body bytes). Its filter drops the nodes node-{i} with i % EXT_BAN_MOD
    == EXT_BAN_MOD - 1 (a seventh, by name); its prioritize gives
    EXT_SCORE to zone-{EXT_ZONE}'s nodes (node-{i} lies in zone-{i % 3});
    its bind records (pod, node); its preempt verb drops the first
    candidate node and keeps the rest untouched, recording (pod, dropped,
    kept)."""

    def __init__(self):
        import threading
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self.reset()
        ext = self

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                raw = self.rfile.read(int(self.headers["Content-Length"]))
                verb = self.path.rsplit("/", 1)[-1]
                with ext.lock:
                    ext.log.append((verb, raw))
                    out = ext.answer(verb, json.loads(raw))
                body = json.dumps(out).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        self.lock = threading.Lock()
        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.server.daemon_threads = True
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.server.server_port}"

    def reset(self):
        self.log, self.bound, self.preempts = [], [], []

    @staticmethod
    def banned(name: str) -> bool:
        return int(name.rsplit("-", 1)[1]) % EXT_BAN_MOD == EXT_BAN_MOD - 1

    def answer(self, verb, args):
        if verb == "filter":
            names = args["nodenames"]
            return {"nodenames": [n for n in names if not self.banned(n)],
                    "failedNodes": {n: "banned by the extender"
                                    for n in names if self.banned(n)}}
        if verb == "prioritize":
            return [{"host": n, "score": EXT_SCORE
                     if int(n.rsplit("-", 1)[1]) % 3 == EXT_ZONE else 0}
                    for n in args["nodenames"]]
        if verb == "bind":
            self.bound.append((args["podName"], args["node"]))
            return {}
        if verb == "preempt":
            victims = args["nodeNameToVictims"]
            nodes = list(victims)
            self.preempts.append((args["pod"]["name"], nodes[0], nodes[1:]))
            return {"nodeNameToVictims": {n: victims[n] for n in nodes[1:]}}
        return {"error": f"unknown verb {verb}"}

    def verbs(self) -> dict:
        out = {}
        for v, _ in self.log:
            out[v] = out.get(v, 0) + 1
        return out

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)


def ext_profile(Registry, store, url, ignorable=False, every_verb=True):
    """The Policy of phase 20: the default predicates and priorities and
    one extender, nodeCacheCapable false (a filter POST carries every
    node with its labels), weight EXT_WEIGHT, with every verb (or with
    filter and prioritize only: a bind is never ignorable)."""
    cfg = {"urlPrefix": url, "filterVerb": "filter",
           "prioritizeVerb": "prioritize", "weight": EXT_WEIGHT,
           "nodeCacheCapable": False, "ignorable": ignorable,
           "httpTimeout": EXT_TIMEOUT_S}
    if every_verb:
        cfg.update(bindVerb="bind", preemptVerb="preempt")
    return Registry().profile_from_policy(
        json.dumps({"extenders": [cfg]}), store)


def ext_sched(mods, Registry, store, caps, device, url, clock=None,
              ignorable=False, extender=True, every_verb=True):
    """A Scheduler of phase 20 on `device` under ext_profile (or, with
    extender False, the same Policy without its extender)."""
    if extender:
        prof = ext_profile(Registry, store, url, ignorable, every_verb)
    else:
        prof = Registry().profile_from_policy("{}", store)
    kw = {} if clock is None else dict(
        clock=clock, backoff=mods[6](initial=0.001, clock=clock))
    return mods[5](store, wave_size=WAVE, caps=caps, device=device,
                   profile=prof, **kw)


def ext_density_checks(ext, store, what):
    """No pod the scheduler bound is on a banned node; the extender's bind
    log is the store's bindings, one entry a pod. Returns the pods
    bound."""
    bound = {p.metadata.name: p.spec.node_name for p in store.list("pods")
             if p.spec.node_name and not p.metadata.name.startswith(
                 "holder-")}
    on_banned = [n for n, node in bound.items() if ext.banned(node)]
    if on_banned:
        fail(f"extender: {what}: pods on banned nodes, e.g. "
             f"{on_banned[:5]}")
    names = [p for p, _ in ext.bound]
    if len(names) != len(set(names)):
        fail(f"extender: {what}: a pod was bound twice by the extender")
    if dict(ext.bound) != bound:
        fail(f"extender: {what}: the extender's binds ({len(ext.bound)}) "
             f"differ from the store's bindings ({len(bound)})")
    return len(bound)


def extender_drain_a(torch, mods, enc, bucket_size, Registry, ext, t_phase):
    """Phase 20 (a): EXT_PODS density pods at FULL_NODES nodes through the
    extender, a first wave timed alone; when it projects the phase past
    EXT_BUDGET_S the backlog is halved (its second half deleted before it
    is popped). Returns what was seen."""
    api, tp, store_mod = mods[0], mods[1], mods[7]
    store, n_bound = build_store(api, store_mod, FULL_NODES, EXT_PODS,
                                 SEED + 201)
    caps = scheduler_caps(enc, bucket_size, FULL_NODES, EXT_PODS, n_bound)
    sched = ext_sched(mods, Registry, store, caps, "cuda", ext.url)
    http = sched.profile.extenders[0]
    http._send = Timer(http._send)
    mask = Timer(sched._host_plugin_mask)
    sched._host_plugin_mask = mask
    scores = Timer(sched._host_score_matrix)
    sched._host_score_matrix = scores
    ext.reset()
    tp.taint_ports_masks.launches = 0
    t0 = time.monotonic()
    placed = sched.run_once()
    torch.cuda.synchronize()
    first_s = time.monotonic() - t0
    n_pods = EXT_PODS
    projected = (time.monotonic() - t_phase
                 + first_s * (EXT_PODS / WAVE - 1) + EXT_REST_S)
    if projected > EXT_BUDGET_S:
        n_pods = EXT_PODS // 2
        for j in range(n_pods, EXT_PODS):
            store.delete("pods", "default", f"pod-{j}")
    placed += sched.schedule_pending()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = tp.taint_ports_masks.launches
    check_bindings(api, store)
    bound = ext_density_checks(ext, store, "(a)")
    if bound != placed or sched.pending_count():
        fail(f"extender: (a) placed {placed}, {bound} bound, "
             f"{sched.pending_count()} pending of {n_pods}")
    if launches < 1:
        fail("extender: (a) the taint/port kernel never launched")
    if sched.storehealth.trips or sched.breaker.trips:
        fail("extender: (a) a breaker tripped")
    filters = [raw for v, raw in ext.log if v == "filter"]
    seen = dict(pods=n_pods, placed=placed, wall=wall, first_s=first_s,
                projected=projected, launches=launches, verbs=ext.verbs(),
                filter_bytes=len(filters[0]), http_s=http._send.s,
                http_calls=http._send.calls, mask_s=mask.s,
                scores_s=scores.s, bound=bound,
                zone_share=sum(1 for p in store.list("pods")
                               if p.spec.node_name
                               and p.metadata.name.startswith("pod-")
                               and int(p.spec.node_name.rsplit("-", 1)[1])
                               % 3 == EXT_ZONE) / max(bound, 1))
    del sched, store
    return seen


def store_copy(store_mod, template):
    """A store holding deep copies of `template`'s nodes and pods, their
    uids kept (a request body carries the pod's uid), so that two runs
    over copies start alike."""
    store = store_mod.ObjectStore()
    for kind in ("nodes", "pods"):
        for obj in template.list(kind):
            store.create(kind, copy.deepcopy(obj))
    return store


def extender_parity(torch, mods, enc, bucket_size, Registry, ext, what,
                    build):
    """One world of phase 20 (b) or (c) on the card and on the CPU, each
    over a copy of it, on a virtual clock: the same bindings and the same
    request log, byte for byte. build() -> (store, caps). Returns device
    -> (bindings, log, extender binds, preempt records, evicted pods,
    seconds)."""
    template, caps = build()
    got = {}
    for device in ("cuda", "cpu"):
        store = store_copy(mods[7], template)
        created = {p.metadata.name for p in store.list("pods")}
        clock = VirtualClock()
        sched = ext_sched(mods, Registry, store, caps, device, ext.url, clock)
        ext.reset()
        t0 = time.monotonic()
        settle(sched, clock)
        if device == "cuda":
            torch.cuda.synchronize()
        s = time.monotonic() - t0
        check_bindings(mods[0], store)
        alive = bindings(store)
        got[device] = (alive, list(ext.log), list(ext.bound),
                       list(ext.preempts), sorted(created - set(alive)), s)
        if sched.breaker.trips or sched.storehealth.trips:
            fail(f"extender: {what} {device}: a breaker tripped")
        del sched, store
    for i, name in enumerate(("bindings", "request logs", "extender binds",
                              "preempt records", "evicted pods")):
        if got["cuda"][i] != got["cpu"][i]:
            fail(f"extender: {what}: card and CPU {name} differ")
    return got


def ext_hog_world(api, store_mod, enc, bucket_size, n_vips):
    """Phase 20 (c)'s world: SMALL_NODES nodes, each full with two bound
    8-core priority-1 hogs, and n_vips pending 8-core priority-100 vips.
    Returns (store, caps)."""
    store = store_mod.ObjectStore()
    add_plain_nodes(api, store, SMALL_NODES)
    for i in range(SMALL_NODES):
        for k in range(2):
            p = batch_pod(api, f"hog-{i}-{k}", "hog", "8", 1)
            p.spec.node_name = f"node-{i}"
            store.create("pods", p)
    add_singles(api, store, "vip", n_vips, "8", 100)
    return store, scheduler_caps(enc, bucket_size, SMALL_NODES, n_vips,
                                 2 * SMALL_NODES)


def extender_phase(torch, mods, enc, bucket_size, Registry):
    """Phase 20: HTTP extenders (sched/extender.py) on every path of the
    drain: (a) the density world at FULL_NODES nodes, (b) its SMALL_NODES
    copy card == CPU, (c) preemption through the preempt verb card ==
    CPU, (d) an unreachable extender, required and ignorable."""
    import socket

    api, tp, pre, store_mod = mods[0], mods[1], mods[2], mods[7]
    t_phase = time.monotonic()
    tp.taint_ports_masks.launches = 0
    pre.preempt_whatif.launches = 0
    ext = ScriptExtender()
    try:
        a = extender_drain_a(torch, mods, enc, bucket_size, Registry, ext,
                             t_phase)
        cut = (f"; halved: the first wave projected {a['projected']:.1f} s"
               if a["pods"] < EXT_PODS else "")
        log(f"[extender] (a) {FULL_NODES} nodes, {a['pods']} density pods "
            f"in waves of {WAVE} through a Policy with one extender "
            f"(nodeCacheCapable false, every verb, weight {EXT_WEIGHT}): "
            f"placed {a['placed']} in {a['wall']:.3f} s = "
            f"{a['placed'] / a['wall']:.1f} pods/s (first wave "
            f"{a['first_s']:.3f} s{cut}); POSTs " + ", ".join(
                f"{k} {v}" for k, v in sorted(a["verbs"].items()))
            + f"; one filter request {a['filter_bytes']} B; extender calls "
            f"{a['http_s']:.3f} s = {a['http_s'] / a['wall']:.1%} of the "
            f"drain ({a['http_calls']} calls, "
            f"{1e3 * a['http_s'] / max(a['http_calls'], 1):.3f} ms each); "
            f"host mask {a['mask_s']:.3f} s, host scores "
            f"{a['scores_s']:.3f} s (both with their calls); "
            f"{a['zone_share']:.1%} of the pods in zone-{EXT_ZONE}; no pod "
            f"on a banned node, {a['bound']} extender binds == the store's "
            f"bindings; taint/port launches {a['launches']}")
        t0 = time.monotonic()

        def small():
            store, n_bound = build_store(api, store_mod, SMALL_NODES,
                                         EXT_PODS, SEED + 201)
            return store, scheduler_caps(enc, bucket_size, SMALL_NODES,
                                         EXT_PODS, n_bound)

        b = extender_parity(torch, mods, enc, bucket_size, Registry, ext,
                            "(b)", small)
        store_b = {k: v for k, v in b["cuda"][0].items()
                   if k.startswith("pod-")}
        if sum(1 for v in store_b.values() if v) != EXT_PODS:
            fail("extender: (b) not every pod was bound")
        log(f"[extender] (b) {SMALL_NODES} nodes, {EXT_PODS} pods: card "
            f"{b['cuda'][5]:.3f} s, CPU {b['cpu'][5]:.3f} s; card == CPU "
            f"bindings and {len(b['cuda'][1])} request bodies byte for "
            f"byte; {time.monotonic() - t0:.1f} s")
        t0 = time.monotonic()

        c = extender_parity(torch, mods, enc, bucket_size, Registry, ext,
                            "(c)", lambda: ext_hog_world(
                                api, store_mod, enc, bucket_size, EXT_VIPS))
        alive, _log, _bound, preempts, evicted, _s = c["cuda"]
        vips = {k: v for k, v in alive.items() if k.startswith("vip-")}
        if len(vips) != EXT_VIPS or not all(vips.values()):
            fail(f"extender: (c) {sum(map(bool, vips.values()))} of "
                 f"{EXT_VIPS} vips bound")
        if any(ext.banned(v) for v in vips.values()):
            fail("extender: (c) a vip on a banned node")
        kept = {n for _p, _d, k in preempts for n in k}
        dropped = {d for _p, d, _k in preempts} - kept
        from_nodes = {"node-" + h.split("-")[1] for h in evicted}
        if not evicted or not preempts:
            fail("extender: (c) nothing was preempted through the verb")
        if not from_nodes <= kept or from_nodes & dropped:
            fail("extender: (c) a victim came from a node the extender "
                 "dropped")
        log(f"[extender] (c) {SMALL_NODES} nodes full of priority-1 hogs, "
            f"{EXT_VIPS} priority-100 vips: {len(evicted)} evicted, "
            f"{len(preempts)} preempt requests (the first candidate "
            f"dropped each time), no victim from a dropped node; card "
            f"{c['cuda'][5]:.3f} s, CPU {c['cpu'][5]:.3f} s; card == CPU "
            f"bindings, victims and request logs; "
            f"{time.monotonic() - t0:.1f} s")
    finally:
        ext.close()
    t0 = time.monotonic()
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    down = f"http://127.0.0.1:{sock.getsockname()[1]}"
    sock.close()
    d = {}
    for mode in ("required", "ignorable", "none"):
        store, n_bound = build_store(api, store_mod, SMALL_NODES,
                                     EXT_DOWN_PODS, SEED + 202)
        caps = scheduler_caps(enc, bucket_size, SMALL_NODES, EXT_DOWN_PODS,
                              n_bound)
        sched = ext_sched(mods, Registry, store, caps, "cuda", down,
                          ignorable=mode == "ignorable",
                          extender=mode != "none", every_verb=False)
        if mode == "none":
            # the per-wave path the extender drains take
            placed = drain_per_wave(sched)
        else:
            placed = sched.schedule_pending()
        torch.cuda.synchronize()
        errors = sched.metrics.scheduling_errors.value(stage="extender")
        if sched.breaker.trips or sched.storehealth.trips:
            fail(f"extender: (d) {mode}: a breaker tripped")
        d[mode] = (placed, errors, sched.pending_count(), bindings(store))
        del sched, store
    if d["required"][:3] != (0, 1.0, EXT_DOWN_PODS):
        fail(f"extender: (d) the required extender down: placed, "
             f"scheduling_errors{{stage=extender}}, pending = "
             f"{d['required'][:3]}")
    if d["ignorable"][3] != d["none"][3] or d["ignorable"][1]:
        fail("extender: (d) the ignorable extender down: bindings differ "
             "from a drain with no extender")
    log(f"[extender] (d) {EXT_DOWN_PODS} pods, the extender on a closed "
        f"port: required: all {d['required'][2]} parked, "
        f"scheduling_errors{{stage=\"extender\"}} {d['required'][1]:.0f}, "
        f"no breaker tripped; ignorable: {d['ignorable'][0]} placed, "
        f"bindings == the same drain with no extender; "
        f"{time.monotonic() - t0:.1f} s")
    launches = tp.taint_ports_masks.launches
    whatif_launches = pre.preempt_whatif.launches
    log(f"[extender] taint/port launches {launches}, what-if launches "
        f"{whatif_launches}; phase {time.monotonic() - t_phase:.1f} s")
    return {"launches": launches, "whatif_launches": whatif_launches}


class CliPatch:
    """Instruments the port's kube-scheduler module (cli/kube_scheduler.py)
    for one phase-21 run, by its module attributes, restored by undo():
    its HealthServer is probed once just before it stops (the run's end:
    its scheduler closed and still queryable), each scheduler
    build_scheduler builds is recorded with its build times and held by
    the Ladder, its first wave's implicit host syncs counted and its
    host phases timed, its LeaderElector can be made to fail its
    renewals and acquisitions (`flap`; a second elector starts so), and
    each RemoteStore it makes is recorded."""

    def __init__(self, torch, ks, ladder, probe=None):
        self.torch, self.ks, self.ladder = torch, ks, ladder
        self.saved = {name: getattr(ks, name) for name in
                      ("HealthServer", "build_scheduler", "LeaderElector",
                       "RemoteStore")}
        self.built = []  # (scheduler, t_build_start, t_build_end)
        self.electors = []
        self.stores = []
        self.clock = PhaseClock()
        self.syncs = []  # (label and thread, {file:line -> syncs})
        self.placed = {}  # label -> pods its waves placed
        self.recoveries = []  # (scheduler, seconds, stats)
        patch = self

        class Probing(self.saved["HealthServer"]):
            def stop(self):
                if probe is not None:
                    probe(self)
                super().stop()

        def build(*a, **kw):
            t0 = time.monotonic()
            sched = patch.saved["build_scheduler"](*a, **kw)
            patch.instrument(sched)
            patch.built.append((sched, t0, time.monotonic()))
            ladder.made.append(sched)
            return sched

        class Elector(self.saved["LeaderElector"]):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                # every elector but the first starts held off the lease
                self.flap = bool(patch.electors)
                patch.electors.append(self)

            def _try_acquire_or_renew(self):
                if self.flap:
                    return False  # the renewal round trip failed
                return super()._try_acquire_or_renew()

        class Store(self.saved["RemoteStore"]):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                patch.stores.append(self)

        ks.HealthServer = Probing
        ks.build_scheduler = build
        ks.LeaderElector = Elector
        ks.RemoteStore = Store

    def instrument(self, sched):
        torch, clock = self.torch, self.clock
        sync = torch.cuda.synchronize if sched.device.type == "cuda" else None
        sched.featurizer.featurize = clock.wrap("featurize",
                                                sched.featurizer.featurize)
        sched.snapshot.to_device = clock.wrap("upload",
                                              sched.snapshot.to_device, sync)
        sched._commit = clock.wrap("commit", sched._commit)
        sched._bind_and_finish = clock.wrap("bind (pool threads)",
                                            sched._bind_and_finish)
        run_wave = sched._run_wave
        first = []

        label = f"S{len(self.built) + 1}"

        def wave(pods):
            if first or sched.device.type != "cuda":
                out = run_wave(pods)
            else:
                first.append(1)
                out, where = count_syncs(torch, lambda: run_wave(pods))
                self.syncs.append(
                    (f"{label} on {threading.current_thread().name}", where))
            self.placed[label] = self.placed.get(label, 0) + out
            return out

        sched._run_wave = clock.wrap("wave (featurize to commit)", wave,
                                     sync)
        recover = sched.recover_leadership

        def recover_timed():
            t0 = time.monotonic()
            stats = recover()
            if sync is not None:
                sync()
            self.recoveries.append((sched, time.monotonic() - t0, stats))
            return stats

        sched.recover_leadership = recover_timed

    def undo(self):
        for name, value in self.saved.items():
            setattr(self.ks, name, value)


def deploy_world(api, store_mod, n_nodes, n_pods, seed):
    """build_store's world with no host port on a pending pod: two pods
    of one wave asking port 8080 may pick one node (a per-wave dispatch
    checks ports against its wave's start state), and the second, failing
    the exact recheck, would wait out a backoff that a --once run does
    not wait for (the JAX CLI's batch mode exits when the active queue is
    empty). The bound holders keep theirs."""
    template, n_bound = build_store(api, store_mod, n_nodes, n_pods, seed)
    for p in template.list("pods"):
        if not p.spec.node_name:
            for c in p.spec.containers:
                c.ports = []
    return template, n_bound


def deploy_server(api, store_mod, template, post=True):
    """The port's APIServer on 127.0.0.1 (port 0) over a store of deep
    copies of `template`'s nodes and bound pods; its pending pods created
    over REST (post) or in the store. Returns (server, the times of each
    pod's binds as the server took them, the first POST's time, the
    pending pods' names)."""
    from kubernetes_tpu_torch.client.rest import RESTClient
    from kubernetes_tpu_torch.server import APIServer

    store = store_mod.ObjectStore()
    for node in template.list("nodes"):
        store.create("nodes", copy.deepcopy(node))
    pending = []
    for p in template.list("pods"):
        if p.spec.node_name:
            store.create("pods", copy.deepcopy(p))
        else:
            pending.append(p)
    binds = {}
    real_bind = store.bind

    def bind(pod, node_name):
        out = real_bind(pod, node_name)
        binds.setdefault(pod.metadata.name, []).append(time.monotonic())
        return out

    store.bind = bind
    srv = APIServer(store).start()
    t_post = time.monotonic()
    if post:
        client = RESTClient(srv.url)
        for p in pending:
            client.create("pods", copy.deepcopy(p))
    else:
        for p in pending:
            store.create("pods", copy.deepcopy(p))
    return srv, binds, t_post, [p.metadata.name for p in pending]


def stop_server(srv):
    """Ends every watch stream at once (the reflectors then exit), then
    stops the server."""
    for w in list(srv.broadcaster._watchers):
        w.stop()
    srv.stop()


def rest_view(srv):
    """The server's nodes and pods read back over REST, as a store-like
    object check_bindings and bindings() read."""
    from kubernetes_tpu_torch.client.rest import RESTClient

    client = RESTClient(srv.url)
    objs = {"nodes": client.list("nodes")[0], "pods": client.list("pods")[0]}

    class View:
        def list(self, kind):
            return objs[kind]

    return View()


def http_get(port, path):
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=60) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def untimed_metrics(text):
    """The /metrics lines less DEPLOY_TIMED's buckets and sums and
    DEPLOY_UNTIMED's families."""
    out = []
    for ln in text.splitlines():
        name = ln.split()[2] if ln.startswith("# TYPE") else ln
        family = name.partition("{")[0].split()[0]
        if family.startswith(DEPLOY_UNTIMED):
            continue
        if any(family in (f"{h}_bucket", f"{h}_sum") for h in DEPLOY_TIMED):
            continue
        out.append(ln)
    return out


def metric_value(lines, name):
    for ln in lines:
        if ln.startswith(name + " "):
            return float(ln.split()[1])
    fail(f"deployed: /metrics has no {name}")


def deployed_drain_a(torch, mods, ks, tracing, filters, ladder):
    """Phase 21 (a) and (b): DEPLOY_PODS density pods at FULL_NODES nodes,
    created over REST, one `main([--server, --config, --once,
    --tracing])` on the card; every endpoint of its HealthServer GET just
    before it stops."""
    import tempfile

    api, tp, store_mod = mods[0], mods[1], mods[7]
    template, n_bound = deploy_world(api, store_mod, FULL_NODES,
                                     DEPLOY_PODS, SEED + 211)
    srv, binds, t_post, pending = deploy_server(api, store_mod, template)
    post_s = time.monotonic() - t_post
    got = {}

    def probe(hs):
        sched = hs.scheduler_ref()
        got["sched"] = sched
        for path in ("/healthz", "/metrics", "/debug/trace",
                     "/debug/trace?format=text", "/debug/trace?format=ledger",
                     "/debug/score", "/debug/shadow", "/debug/store",
                     "/debug/autopilot", "/debug/profile", "/nope"):
            got[path] = http_get(hs.port, path)
        code, idx = got["/debug/score"]
        if code == 200 and json.loads(idx):
            uid = json.loads(idx)[0]["uid"]
            got["uid"] = uid
            got["/debug/score?uid="] = http_get(hs.port,
                                                f"/debug/score?uid={uid}")
            got["/debug/score?uid=&format=text"] = http_get(
                hs.port, f"/debug/score?uid={uid}&format=text")

    patch = CliPatch(torch, ks, ladder, probe)
    captured = {}
    kernel_launch = filters.taint_ports_masks

    events = {}
    from kubernetes_tpu_torch.client import reflector as refl_mod

    real_on_event = refl_mod.RemoteStore._on_event

    def on_event(self, ev):
        key = f"{ev.kind} {ev.type}"
        events[key] = events.get(key, 0) + 1
        return real_on_event(self, ev)

    tmp = tempfile.mkdtemp(prefix="deployed-")
    cfg_path = f"{tmp}/cfg.json"
    with open(cfg_path, "w") as f:
        json.dump({"waveSize": WAVE, "healthzPort": 0}, f)
    filters.taint_ports_masks = capturing(kernel_launch, captured)
    refl_mod.RemoteStore._on_event = on_event
    tp.taint_ports_masks.launches = 0
    try:
        t0 = time.monotonic()
        rc = ks.main(["--server", srv.url, "--config", cfg_path, "--once",
                      "--tracing"])
        torch.cuda.synchronize()
        t_end = time.monotonic()
        launches = tp.taint_ports_masks.launches
    finally:
        filters.taint_ports_masks = kernel_launch
        refl_mod.RemoteStore._on_event = real_on_event
        patch.undo()
        if tracing.active() is not None:
            fail("deployed: (a) the run left its recorder enabled")
    requests = dict(srv.request_count)
    view = rest_view(srv)
    stop_server(srv)
    if rc != 0:
        fail(f"deployed: (a) main() returned {rc}")
    sched, t_build0, t_build1 = patch.built[0]
    if sched.wave_path() != "cuda":
        fail(f"deployed: (a) wave_path() {sched.wave_path()!r}")
    bound = check_bindings(api, view)
    placed_binds = [binds[n] for n in pending if n in binds]
    if bound != DEPLOY_PODS + n_bound or len(placed_binds) != DEPLOY_PODS:
        fail(f"deployed: (a) {len(placed_binds)} of {DEPLOY_PODS} pods "
             f"bound over REST ({bound} bound in all)")
    if any(len(b) != 1 for b in placed_binds):
        fail("deployed: (a) a pod was bound twice")
    t_last = max(b[0] for b in placed_binds)
    waves = -(-DEPLOY_PODS // WAVE)
    if launches < waves:
        fail(f"deployed: (a) {launches} taint/port launches for {waves} "
             "per-wave dispatches")
    if sched.storehealth.trips or sched.breaker.trips:
        fail("deployed: (a) a breaker tripped")
    phases = dict(patch.clock.seconds)
    wall = t_last - t_post
    log(f"[deployed] (a) {FULL_NODES} nodes ({n_bound} bound port holders "
        f"in the server's store), {DEPLOY_PODS} density pods POSTed in "
        f"{post_s:.3f} s; main(--once --tracing) on the card: placed "
        f"{DEPLOY_PODS} in {wall:.3f} s from the first POST to the last "
        f"bind = {DEPLOY_PODS / wall:.1f} pods/s; from main() to the last "
        f"bind {t_last - t0:.3f} s = {DEPLOY_PODS / (t_last - t0):.1f} "
        f"pods/s; main() returned after {t_end - t0:.3f} s")
    log(f"[deployed] (a) host seconds: reflectors' LIST and sync "
        f"{t_build0 - t0:.3f}, build_scheduler {t_build1 - t_build0:.3f}, "
        f"first wave to the last bind {t_last - t_build1:.3f}; by phase: "
        + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()))
    log("[deployed] (a) REST requests by verb: " + ", ".join(
        f"{k} {v}" for k, v in sorted(requests.items())))
    log("[deployed] (a) reflector events: " + ", ".join(
        f"{k} {v}" for k, v in sorted(events.items())))
    if not patch.syncs:
        fail("deployed: (a) no wave ran on the card")
    thread, syncs = patch.syncs[0]
    log(f"[deployed] (a) taint/port launches {launches} ({waves} per-wave "
        f"dispatches); binds in flight on the pool (submitted, not done) "
        f"at most "
        f"{sched.bind_overlap_hwm}; implicit host syncs of the first wave "
        f"({thread}): {sum(syncs.values())} ("
        + ", ".join(f"{k} x{v}" for k, v in sorted(syncs.items()))
        + "); every pod bound once, invariants hold; no breaker trip")
    max_err = check_captured(torch, tp, "deployed", captured)
    # (b) the endpoints, their counts against the drain
    want = {"/healthz": 200, "/metrics": 200, "/debug/trace": 200,
            "/debug/trace?format=text": 200,
            "/debug/trace?format=ledger": 200, "/debug/score": 200,
            "/debug/score?uid=": 200, "/debug/score?uid=&format=text": 200,
            "/debug/shadow": 200, "/debug/store": 200,
            "/debug/autopilot": 404, "/debug/profile": 200, "/nope": 404}
    codes = {p: got.get(p, (None,))[0] for p in want}
    if codes != want:
        fail(f"deployed: (b) endpoint status codes {codes}")
    if got["/healthz"][1] != "ok":
        fail("deployed: (b) /healthz did not answer ok")
    lines = got["/metrics"][1].splitlines()
    scheduled = metric_value(lines, "pods_scheduled_total")
    relists = metric_value(lines, "reflector_relists_total")
    if scheduled != DEPLOY_PODS:
        fail(f"deployed: (b) /metrics pods_scheduled_total {scheduled}")
    if relists != len(sched.store._reflectors):
        fail(f"deployed: (b) /metrics reflector_relists_total {relists} "
             f"for {len(sched.store._reflectors)} reflectors")
    trace = json.loads(got["/debug/trace"][1])
    if not trace.get("traceEvents"):
        fail("deployed: (b) /debug/trace has no events")
    rows = [json.loads(r) for r in
            got["/debug/trace?format=ledger"][1].splitlines() if r]
    if len(rows) != waves or any(r.get("path") != "cuda" for r in rows):
        fail(f"deployed: (b) {len(rows)} ledger rows for {waves} waves")
    entry = json.loads(got["/debug/score?uid="][1])
    pod_name = entry["pod"].split("/", 1)[1]
    node_of = bindings(view)
    if entry["node"] != node_of.get(pod_name):
        fail(f"deployed: (b) /debug/score names {entry['node']} for "
             f"{pod_name}, bound to {node_of.get(pod_name)}")
    shadow = json.loads(got["/debug/shadow"][1])
    store_dbg = json.loads(got["/debug/store"][1])
    if store_dbg["state"] != "connected" or any(
            store_dbg["errors"].values()) or store_dbg["spool"]["depth"]:
        fail(f"deployed: (b) /debug/store {store_dbg}")
    if got["/debug/autopilot"][1] != "no autopilot controller attached\n":
        fail("deployed: (b) /debug/autopilot did not say no autopilot")
    log(f"[deployed] (b) every endpoint well formed: /metrics "
        f"pods_scheduled_total {scheduled:.0f}, reflector_relists_total "
        f"{relists:.0f} ({len(lines)} lines); /debug/trace "
        f"{len(trace['traceEvents'])} events; {len(rows)} ledger rows, one "
        f"a wave, path cuda; /debug/score "
        f"{len(json.loads(got['/debug/score'][1]))} recent decisions, "
        f"{pod_name} -> {entry['node']} as bound; /debug/shadow "
        f"weights_version {shadow['weights_version']}; /debug/store "
        f"connected, no error, empty spool; /debug/autopilot 404")
    return {"launches": launches, "max_err": max_err, "wall": wall,
            "syncs": sum(syncs.values())}


def failover_run(torch, mods, ks, ladder):
    """Phase 21 (c): two `run(--leader-elect)` schedulers on the card
    against one server, leases of FAILOVER_LEASE s, FAILOVER_PODS pods in
    the server's store before S1 starts (its first LIST carries them all,
    so its waves are full ones). S1 leads and drains; S2 runs as the
    standby, its lease attempts failing (`flap`) from its start until S1
    is dormant and S2's mirror shows every bind S1 made (in one process
    the two electors share the interpreter with the drain: a 1.5 s lease
    whose renewals starve would otherwise hand S2 the lease while S1
    binds). Once S1's waves have placed half the pods its elector is
    stopped: S1 goes dormant for good (its binds settled), S2
    takes the lease, builds its scheduler (the CLI builds it at a first
    leadership) and drains on. From S2's first bind its renewals fail
    until it goes dormant (a flap: nobody else is a candidate), then
    succeed: S2 takes its lease back, runs recover_leadership and drains
    the rest. The hold keeps S2 from building while S1's binds are in
    flight: a standby that queues pods the old leader then binds raises
    on its next wave, in both packages (ROADMAP queue 3)."""
    api, tp, store_mod = mods[0], mods[1], mods[7]
    from kubernetes_tpu_torch.sched.config import KubeSchedulerConfiguration

    template, _ = deploy_world(api, store_mod, FULL_NODES, FAILOVER_PODS,
                               SEED + 212)
    srv, binds, _, names = deploy_server(api, store_mod, template,
                                         post=False)
    patch = CliPatch(torch, ks, ladder)
    cfg = KubeSchedulerConfiguration(wave_size=WAVE, healthz_port=-1)
    le = cfg.leader_election
    le.leader_elect = True
    le.lease_duration = FAILOVER_LEASE
    le.renew_deadline = FAILOVER_RENEW
    le.retry_period = FAILOVER_RETRY
    stops = [threading.Event(), threading.Event()]
    errors = []

    def runner(i):
        try:
            if ks.run(cfg, srv.url, stop=stops[i], device="cuda") != 0:
                errors.append(f"S{i + 1} returned non-zero")
        except Exception as e:  # reported below, and the phase fails
            errors.append(f"S{i + 1}: {type(e).__name__}: {e}")

    def wait(cond, what):
        deadline = time.monotonic() + FAILOVER_WAIT_S
        while not cond():
            if errors or time.monotonic() > deadline:
                fail(f"deployed: (c) waiting for {what}: "
                     f"{errors or 'timed out'}")
            time.sleep(0.005)
        return time.monotonic()

    def n_bound_now():
        return sum(1 for n in names if n in binds)

    def mirrored(store):
        """Every pod the server has bound shows bound in store's mirror."""
        for n in [n for n in names if n in binds]:
            pod = store.get("pods", "default", n)
            if pod is None or not pod.spec.node_name:
                return False
        return True

    threads = [threading.Thread(target=runner, args=(i,), daemon=True)
               for i in range(2)]
    tp.taint_ports_masks.launches = 0
    t0 = time.monotonic()
    try:
        threads[0].start()
        wait(lambda: patch.built and patch.electors[0].is_leader,
             "S1 to lead and build its scheduler")
        s1 = patch.built[0][0]
        threads[1].start()
        wait(lambda: len(patch.electors) == 2, "S2's elector")
        s1_elector, s2_elector = patch.electors
        s2_store = patch.stores[1]
        # S1's waves outrun its binds: stop it once it has placed half
        wait(lambda: patch.placed.get("S1", 0) >= FAILOVER_PODS // 2,
             "S1 to place half the pods")
        s1_elector.stop()
        t_stop = time.monotonic()
        # dormant is set before enter_dormant drains the binds in flight
        t_s1_dormant = wait(lambda: s1.dormant and not s1._inflight,
                            "S1 to go dormant with its binds settled")
        n_s1 = n_bound_now()
        wait(lambda: mirrored(s2_store), "S2's mirror of S1's binds")
        s2_elector.flap = False
        t_release = time.monotonic()
        wait(lambda: len(patch.built) == 2, "S2 to build its scheduler")
        s2, t_s2_build0, t_s2_build1 = patch.built[1]
        t_s2_first = wait(lambda: n_bound_now() > n_s1, "S2's first bind")
        s2_elector.flap = True
        t_flap = time.monotonic()
        wait(lambda: s2.dormant, "S2 to go dormant")
        t_dormant = time.monotonic()
        n_flap = n_bound_now()
        s2_elector.flap = False
        wait(lambda: patch.recoveries, "S2 to recover its leadership")
        wait(lambda: n_bound_now() == FAILOVER_PODS, "every pod bound")
        t_all = time.monotonic()
        torch.cuda.synchronize()
        launches = tp.taint_ports_masks.launches
    finally:
        for ev in stops:
            ev.set()
        for t in threads:
            t.join(timeout=60)
        patch.undo()
    if any(t.is_alive() for t in threads):
        fail("deployed: (c) a scheduler's run() did not return")
    if errors:
        fail(f"deployed: (c) {errors}")
    view = rest_view(srv)
    stop_server(srv)
    check_bindings(api, view)
    if any(len(binds[n]) != 1 for n in names):
        fail("deployed: (c) a pod was bound twice")
    sched, rec_s, stats = patch.recoveries[0]
    if sched is not s2 or not s1.dormant or launches < 2:
        fail(f"deployed: (c) the recovery ran on the wrong scheduler, S1 "
             f"is not dormant, or the kernel launched {launches} times")
    for s in (s1, s2):
        if s.storehealth.trips or s.breaker.trips or s.spool_count():
            fail("deployed: (c) a breaker tripped or a bind spooled")
    syncs = {label: sum(w.values()) for label, w in patch.syncs}
    log(f"[deployed] (c) {FULL_NODES} nodes, leases of {FAILOVER_LEASE} s "
        f"(renew deadline {FAILOVER_RENEW} s, retry {FAILOVER_RETRY} s), "
        f"{FAILOVER_PODS} pods in the server's store: S1 bound {n_s1}, its "
        f"elector stopped {t_stop - t0:.3f} s after S1 started, S1 dormant "
        f"(its binds settled) {t_s1_dormant - t_stop:.3f} s later; S2, held "
        f"off the lease until then and until its mirror showed S1's binds "
        f"(released {t_release - t_stop:.3f} s after the stop), built its "
        f"scheduler in {t_s2_build1 - t_s2_build0:.3f} s; S2's first bind "
        f"{t_s2_first - t_stop:.3f} s after the stop "
        f"({t_s2_first - t_release:.3f} s after the release); from then "
        f"S2's renewals failed and it went dormant "
        f"{t_dormant - t_flap:.3f} s later with {n_flap} bound; it took "
        f"its lease back and its recover_leadership took {rec_s:.3f} s "
        f"({stats}); every pod bound once, invariants hold, "
        f"{t_all - t0:.3f} s from S1's start to the last bind; taint/port "
        f"launches {launches}; implicit host syncs of each scheduler's "
        f"first wave: {syncs}; {time.monotonic() - t0:.1f} s")
    return {"launches": launches}


def deployed_parity(torch, mods, ks, ladder):
    """Phase 21 (d): DEPLOY_SMALL_PODS density pods at SMALL_NODES nodes,
    one `main(--once)` on the card and one on the CPU, each against its
    own server over copies of one world: the same bindings over REST and
    the same /metrics less the wall-clock readings."""
    import tempfile

    api, tp, store_mod = mods[0], mods[1], mods[7]
    template, _ = deploy_world(api, store_mod, SMALL_NODES,
                               DEPLOY_SMALL_PODS, SEED + 213)
    tmp = tempfile.mkdtemp(prefix="deployed-")
    cfg_path = f"{tmp}/cfg.json"
    with open(cfg_path, "w") as f:
        json.dump({"waveSize": WAVE, "healthzPort": 0}, f)
    got = {}
    tp.taint_ports_masks.launches = 0
    for device in ("cuda", "cpu"):
        srv, binds, _, _ = deploy_server(api, store_mod, template, post=False)
        seen = {}

        def probe(hs, seen=seen):
            seen["metrics"] = http_get(hs.port, "/metrics")[1]

        patch = CliPatch(torch, ks, ladder, probe)
        t0 = time.monotonic()
        try:
            rc = ks.main(["--server", srv.url, "--config", cfg_path,
                          "--once"], device=device)
        finally:
            patch.undo()
        s = time.monotonic() - t0
        view = rest_view(srv)
        stop_server(srv)
        if rc != 0:
            fail(f"deployed: (d) main() on {device} returned {rc}")
        check_bindings(api, view)
        got[device] = (bindings(view), untimed_metrics(seen["metrics"]), s)
        if device == "cuda":
            syncs = sum(patch.syncs[0][1].values()) if patch.syncs else None
    launches = tp.taint_ports_masks.launches
    if got["cuda"][0] != got["cpu"][0]:
        a, b = got["cuda"][0], got["cpu"][0]
        diff = sorted(k for k in a if a[k] != b.get(k))
        fail(f"deployed: (d) card and CPU bindings differ, e.g. {diff[:5]}")
    if got["cuda"][1] != got["cpu"][1]:
        diff = [ln for ln in got["cuda"][1] if ln not in got["cpu"][1]]
        fail(f"deployed: (d) card and CPU /metrics differ: {diff[:5]}")
    if launches < 1:
        fail("deployed: (d) the card's run never launched the kernel")
    log(f"[deployed] (d) {SMALL_NODES} nodes, {DEPLOY_SMALL_PODS} pods: card "
        f"{got['cuda'][2]:.3f} s, CPU {got['cpu'][2]:.3f} s; card == CPU "
        f"bindings ({sum(1 for v in got['cuda'][0].values() if v)} bound) "
        f"and /metrics ({len(got['cuda'][1])} lines, less the wall-clock "
        f"readings); taint/port launches {launches}; implicit host syncs "
        f"of the card's first wave (untraced, on the main thread): "
        f"{syncs}")
    return {"launches": launches}


def deployed_phase(torch, mods, filters, tracing, ladder):
    """Phase 21: the deployed kube-scheduler (cli/kube_scheduler.py) on
    the card against the port's APIServer (server/apiserver.py) in this
    process: (a) the drain and (b) the endpoints, (c) a leader failover,
    (d) card == CPU."""
    from kubernetes_tpu_torch.cli import kube_scheduler as ks

    pre = mods[2]
    t_phase = time.monotonic()
    pre.preempt_whatif.launches = 0
    a = deployed_drain_a(torch, mods, ks, tracing, filters, ladder)
    ladder.check("deployed (a)")
    c = failover_run(torch, mods, ks, ladder)
    ladder.check("deployed (c)")
    d = deployed_parity(torch, mods, ks, ladder)
    ladder.check("deployed (d)")
    launches = a["launches"] + c["launches"] + d["launches"]
    whatif_launches = pre.preempt_whatif.launches
    log(f"[deployed] taint/port launches {launches} ((a) {a['launches']}, "
        f"(c) {c['launches']}, (d) {d['launches']}), what-if launches "
        f"{whatif_launches}; phase {time.monotonic() - t_phase:.1f} s")
    return {"launches": launches, "whatif_launches": whatif_launches,
            "max_err": a["max_err"]}


# --- phase 22: the autopilot and the invariant checker ------------------------


def round_keys(kernel_mod):
    """The shape buckets the round program has dispatched at in this
    process (ops/kernel.py `_COMPILED` keys of program "round"): the
    port's counterpart of JAX's `_schedule_round._cache_size()`."""
    return frozenset(k for k in kernel_mod._COMPILED if k[0] == "round")


def skewed_world(api, store_mod, Scheduler, device):
    """tests/test_autopilot.py's skewed world on `device`: three 8-core
    nodes at 6, 3 and 0 cores used, so the score planes tell the nodes
    apart (margins of about 4 score units; on the density world the
    integer scores tie across thousands of identical nodes and every
    margin is 0), and a live profile `good`."""
    store = store_mod.ObjectStore()
    sched = Scheduler(store, wave_size=8, device=device)
    for i in range(3):
        store.create("nodes", api.Node(
            metadata=api.ObjectMeta(name=f"sk-{i}",
                                    labels={HOSTNAME: f"sk-{i}"}),
            status=api.NodeStatus(
                allocatable=api.resource_list(cpu="8", memory="32Gi",
                                              pods=110),
                conditions=[api.NodeCondition(api.NODE_READY,
                                              api.COND_TRUE)])))
    for node, n in (("sk-0", 6), ("sk-1", 3)):
        for i in range(n):
            p = batch_pod(api, f"{node}-pre-{i}", "skew", 1, None)
            p.spec.node_name = node
            store.create("pods", p)
    store.create("weightprofiles", profile_obj(
        api, "good", {"LeastRequested": 2.0, "PreferAvoid": 10000.0},
        role="live"))
    return store, sched


def forced_regression(api, store_mod, ap, Scheduler, device):
    """A candidate forced past the gates on the skewed world: near-zero
    weights collapse the margins under the watch floor, the first
    watched round breaches and the observer restores the live profile in
    memory; a later step() reconciles the store's role. Returns what is
    compared and printed."""
    store, sched = skewed_world(api, store_mod, Scheduler, device)
    prior = sched.weightbook.live_version()
    ctl = ap.AutopilotController(sched, store=store, config=ap
                                 .AutopilotConfig(min_shadow_pods=3,
                                                  watch_rounds=2,
                                                  watch_margin_floor=1.0))
    ap.emit_candidate(store, "tiny", {"LeastRequested": 0.001})
    states = [ctl.start("tiny", force=True), ctl.step()]
    promoted = sched.weightbook.live_version()
    store.create("pods", batch_pod(api, "breach", "skew", "100m", None))
    t0 = time.monotonic()
    placed = sched.schedule_pending()
    restore_s = time.monotonic() - t0
    restored = sched.weightbook.live_version()
    role = [store.get("weightprofiles", "default", "tiny").spec.role]
    states += [ctl.state, ctl.step()]
    role.append(store.get("weightprofiles", "default", "tiny").spec.role)
    m = sched.metrics.autopilot_promotions
    out = {"states": states, "prior": prior, "promoted": promoted,
           "restored": restored, "roles": role, "placed": placed,
           "reason": ctl.history[-1].get("reason"),
           "promotions": {o: m.value(outcome=o) for o in ap.OUTCOMES
                          if m.value(outcome=o)},
           "bindings": bindings(store)}
    if (states != ["shadowing", "watching", "rolled_back", "rolled_back"]
            or not promoted.startswith("tiny@") or restored != prior
            or role != ["live", "candidate"] or placed != 1
            or out["promotions"] != {"promoted": 1.0, "rolled_back": 1.0}
            or "margin" not in (out["reason"] or "")):
        fail(f"autopilot: the forced regression on {device} went {out}")
    return out, restore_s


def ap_ledger(mods, enc, bucket_size, tracing, weights_mod, stack, device,
              path):
    """Phase 14's traced drain in miniature on `device`, for part (c)'s
    trainer: SMALL_NODES density nodes and AP_SMALL_PODS pods under a
    live profile equal to the defaults with a bin-packing and a
    spreading candidate, then the bin-packer promoted and AP_SMALL_EXTRA
    more pods, then the rollback and AP_SMALL_EXTRA more. The recorder's
    clock is a virtual one, so every record's wall_s (a term of the
    round quality the trainer fits) is the same on the card and the
    CPU. Returns the ledger's scored rounds."""
    api, Scheduler, store_mod = mods[0], mods[5], mods[-1]
    tracing.disable()
    rec = tracing.enable(ledger_path=str(path), clock=VirtualClock())
    try:
        store, n_bound = build_store(api, store_mod, SMALL_NODES,
                                     AP_SMALL_PODS, SEED)
        caps = scheduler_caps(enc, bucket_size, SMALL_NODES,
                              AP_SMALL_PODS + 2 * AP_SMALL_EXTRA, n_bound)
        base = mods[4].default_profile(store).weights()
        same = default_table(weights_mod, stack, base)
        packer = dict(same, MostRequested=2.0)
        packer.pop("LeastRequested")
        for name, table, role in (
                ("same", same, "live"), ("packer", packer, "candidate"),
                ("spreader", dict(same, BalancedAllocation=3.0),
                 "candidate")):
            store.create("weightprofiles",
                         profile_obj(api, name, table, role))
        sched = Scheduler(store, wave_size=WAVE, caps=caps, device=device)
        sched.schedule_pending()
        wp = store.get("weightprofiles", "default", "packer")
        wp.spec.role = "live"
        store.update("weightprofiles", wp)
        add_singles(api, store, "swap", AP_SMALL_EXTRA, "100m", None)
        sched.schedule_pending()
        for name in ("packer", "same"):
            store.delete("weightprofiles", "default", name)
        add_singles(api, store, "rollback", AP_SMALL_EXTRA, "100m", None)
        sched.schedule_pending()
        return sum(1 for r in rec.ledger_rows() if "scores" in r)
    finally:
        tracing.disable()


def pilot_run(mods, enc, bucket_size, kernel_mod, tp, ap, ladder, device,
              n_nodes, table, slo_scale, probe=None):
    """The promotion pipeline on `device` under the active recorder: a
    live scheduler on the density world (n_nodes nodes, waves of WAVE),
    the trained `table` emitted as a candidate, start(), a shadow window
    of AP_SHADOW_ROUNDS rounds of WAVE density pods, step() (the shadow
    gate, then the replay CI: two replays at n_nodes nodes and waves of
    WAVE on the live scheduler's device), the promotion, and a watch of
    AP_WATCH_ROUNDS rounds to `completed`. probe(sched, ctl), where
    given, runs on the live scheduler at the end. Returns what is
    compared and printed."""
    api, Scheduler, store_mod = mods[0], mods[5], mods[-1]
    store, n_bound = build_store(api, store_mod, n_nodes, 0, SEED)
    caps = scheduler_caps(enc, bucket_size, n_nodes,
                          (AP_SHADOW_ROUNDS + AP_WATCH_ROUNDS) * WAVE,
                          n_bound)
    sched = Scheduler(store, wave_size=WAVE, caps=caps, device=device)
    ctl = ap.AutopilotController(sched, store=store, config=ap
                                 .AutopilotConfig(
                                     min_shadow_pods=AP_SHADOW_ROUNDS * WAVE,
                                     watch_rounds=AP_WATCH_ROUNDS,
                                     replay_nodes=n_nodes, replay_wave=WAVE,
                                     replay_slo_scale=slo_scale))
    ap.emit_candidate(store, "trained", table)
    made = len(ladder.made)
    t_start = time.monotonic()
    states = [ctl.start("trained")]
    for k in range(AP_SHADOW_ROUNDS):
        add_singles(api, store, f"shadow{k}", WAVE, "100m", None)
        if sched.schedule_pending() != WAVE:
            fail(f"autopilot: a shadow round on {device} placed too few")
    keys = (round_keys(kernel_mod), len(kernel_mod._COMPILED))
    launches = tp.taint_ports_masks.launches
    t0 = time.monotonic()
    if device == "cuda":
        import torch

        state, syncs = count_syncs(torch, ctl.step)
    else:
        state, syncs = ctl.step(), {}
    step_s = time.monotonic() - t0
    promote_s = time.monotonic() - t_start
    ci_launches = tp.taint_ports_masks.launches - launches
    states.append(state)
    replays = [s for s in ladder.made[made:] if s is not sched]
    waves = sum(int(s.metrics.waves_total.value(path="device"))
                for s in replays)
    paths = sorted({(s.device.type, s.wave_path()) for s in replays})
    versions = [sched.weightbook.live_version()]
    for k in range(AP_WATCH_ROUNDS):
        add_singles(api, store, f"watch{k}", WAVE, "100m", None)
        if sched.schedule_pending() != WAVE:
            fail(f"autopilot: a watch round on {device} placed too few")
    states.append(ctl.state)
    versions.append(sched.weightbook.live_version())
    new_keys = (round_keys(kernel_mod) - keys[0],
                len(kernel_mod._COMPILED) - keys[1])
    rep = ctl.reports.get("replay", {})
    m = sched.metrics.autopilot_promotions
    out = {"states": states, "outcome": ctl.outcome, "versions": versions,
           "shadow": ctl.reports.get("shadow"),
           "replays": [{k: r[k] for k in ("name", "version", "placed",
                                          "total", "util", "frag",
                                          "margin_rel", "objective",
                                          "passed")}
                       for r in (rep.get("baseline"), rep.get("candidate"))
                       if r],
           "promotions": {o: m.value(outcome=o) for o in ap.OUTCOMES
                          if m.value(outcome=o)},
           "bindings": bindings(store)}
    seen = {"out": out, "step_s": step_s, "promote_s": promote_s,
            "syncs": syncs, "waves": waves, "paths": paths,
            "ci_launches": ci_launches, "new_keys": new_keys,
            "replay_wall": [(r["name"], r["wall_s"])
                            for r in (rep.get("baseline"),
                                      rep.get("candidate")) if r]}
    if states != ["shadowing", "watching", "completed"] or \
            ctl.outcome != "promoted" or not versions[0].startswith(
                "trained@") or versions[1] != versions[0]:
        fail(f"autopilot: the pipeline on {device} went {states}, outcome "
             f"{ctl.outcome}, versions {versions}, reports {ctl.reports}")
    if len(out["replays"]) != 2 or paths != [(
            device, "cuda" if device == "cuda" else "torch-cpu")]:
        fail(f"autopilot: the replay CI on {device} ran {out['replays']} on "
             f"{paths}")
    if probe is not None:
        seen["probe"] = probe(sched, ctl)
    return seen


def checked_drain(mods, enc, bucket_size, device, n_nodes, n_pods,
                  n_total):
    """The density world of n_nodes nodes and n_pods pods (phase 14's
    untraced world at FULL_NODES) drained on Scheduler(...,
    invariants=True): a strict checker after every round, each check
    timed. Returns (scheduler, store, placed, wall seconds, check
    seconds)."""
    api, Scheduler, store_mod = mods[0], mods[5], mods[-1]
    store, n_bound = build_store(api, store_mod, n_nodes, n_pods, SEED)
    caps = scheduler_caps(enc, bucket_size, n_nodes, n_total, n_bound)
    sched = Scheduler(store, wave_size=WAVE, caps=caps, device=device,
                      invariants=True)
    chk = sched.invariants
    times = []
    check = chk.check

    def timed(s):
        t0 = time.monotonic()
        try:
            return check(s)
        finally:
            times.append(time.monotonic() - t0)
    chk.check = timed
    t0 = time.monotonic()
    placed = sched.schedule_pending()
    if device == "cuda":
        import torch

        torch.cuda.synchronize()
    wall = time.monotonic() - t0
    if chk.violations or not chk.strict:
        fail(f"autopilot: the checked drain on {device} found "
             f"{[v.invariant for v in chk.violations]}")
    return sched, store, placed, wall, times


def plant_faults(api, sched, store, InvariantChecker):
    """Two seeded bugs on a drained scheduler, each under a collecting
    checker of its own: a pending pod dropped from every queue area
    (conservation, at the second check: its hysteresis), then one host
    row of the snapshot's usage plane corrupted (snapshot_usage at once;
    a host-only write, read back by the checker from the host plane).
    Returns the findings [(check, invariant, detail)]."""
    found = []
    chk = InvariantChecker(metrics=sched.metrics, strict=False)
    lost = batch_pod(api, "planted-lost", "density", "100m", None)
    store.create("pods", lost)
    sched.queue.delete(lost)
    for k in (1, 2):
        with sched._mu:
            found += [(k, v.invariant, v.detail, v.digest)
                      for v in chk.check(sched)]
    store.delete("pods", "default", "planted-lost")
    chk = InvariantChecker(metrics=sched.metrics, strict=False)
    row = sched.snapshot.node_index["node-1"]
    sched.snapshot.requested[row, 0] += 4000.0
    with sched._mu:
        found += [(3, v.invariant, v.detail, v.digest)
                  for v in chk.check(sched)]
    sched.snapshot.requested[row, 0] -= 4000.0
    got = [(k, inv) for k, inv, _, _ in found]
    if got != [(2, "conservation"), (3, "snapshot_usage")] or \
            len(found[0][3]["lost"]) != 1 or \
            found[1][3]["diverged_rows"] != [str(row)]:
        fail(f"autopilot: the planted faults found {found}")
    return found


def autopilot_phase(torch, mods, enc, bucket_size, filters, tracing,
                    weights_mod, stack, ladder, traced):
    """Phase 22: (a) the promotion pipeline at FULL_NODES on the card,
    trained on phase 14's ledger, and a forced regression rolled back;
    (b) phase 14's untraced density drain on a checked scheduler, then
    two planted faults; (c) the pipeline, the forced regression and a
    checked drain at SMALL_NODES on the card and on the CPU, equal.
    Every scheduler of the phase, the replays' too, is built through the
    ladder. Returns what it saw."""
    import tempfile

    from kubernetes_tpu_torch import autopilot as ap
    from kubernetes_tpu_torch.autopilot.dataset import load_dataset
    from kubernetes_tpu_torch.chaos import InvariantChecker
    from kubernetes_tpu_torch.cli.kube_scheduler import HealthServer

    api, tp, pre, kernel_mod, sched_mod, Scheduler, PodBackoff, store_mod = mods
    t_phase = time.monotonic()
    seen = {}
    saved = (sched_mod.Scheduler, kernel_mod.taint_ports_masks,
             filters.taint_ports_masks)
    # the replay CI builds its scheduler from sched/scheduler.py: through
    # the ladder, so that each replay is held like the phase's others
    sched_mod.Scheduler = Scheduler
    kernel_mod.taint_ports_masks = capturing(saved[1], seen)
    filters.taint_ports_masks = capturing(saved[2], seen)
    tp.taint_ports_masks.launches = 0
    pre.preempt_whatif.launches = 0
    base = sched_mod.default_profile(None).weights()
    try:
        # (a) the promotion pipeline at full width
        t0 = time.monotonic()
        ds = load_dataset(str(traced["ledger"]))
        table = ap.RidgeTrainer(base).fit(ds)
        train_s = time.monotonic() - t0
        log(f"[autopilot] (a) trained on phase 14's ledger ({len(ds)} scored "
            f"rounds, {ds.skipped} skipped, versions "
            f"{sorted(set(ds.versions))}) in {train_s:.4f} s: {table}")
        tracing.disable()
        rec = tracing.enable()
        status = {}

        def debug(sched, ctl):
            hs = HealthServer(lambda: sched)
            try:
                code, body = http_get(hs.port, "/debug/autopilot")
            finally:
                hs.stop()
            status.update(code=code, body=json.loads(body),
                          want=json.loads(json.dumps(ctl.status())))
        a = pilot_run(mods, enc, bucket_size, kernel_mod, tp, ap, ladder,
                      "cuda", FULL_NODES, table, 1.0, probe=debug)
        forced, restore_s = forced_regression(api, store_mod, ap, Scheduler,
                                              "cuda")
        trail = [r["state"] for r in rec.ledger_rows()
                 if r.get("kind") == "autopilot"]
        tracing.disable()
        want = ["shadowing", "replaying", "promoted", "watching",
                "completed", "shadowing", "promoted", "watching",
                "rolled_back"]
        if trail != want:
            fail(f"autopilot: the ledger's transition trail is {trail}")
        if status.get("code") != 200 or status["body"] != status["want"]:
            fail(f"autopilot: /debug/autopilot answered {status}")
        if a["new_keys"][0] or a["ci_launches"] < 1:
            fail(f"autopilot: new round buckets {a['new_keys'][0]}, replay "
                 f"CI launches {a['ci_launches']}")
        out = a["out"]
        sh = out["shadow"]
        log(f"[autopilot] (a) {FULL_NODES} nodes: shadow window "
            f"{AP_SHADOW_ROUNDS} rounds of {WAVE}: {sh['pods']} pods, flip "
            f"rate {sh['flip_rate']}, margin delta {sh['margin_delta_mean']}")
        for r, (name, wall) in zip(out["replays"], a["replay_wall"]):
            log(f"[autopilot] (a) replay {name} ({r['version']}) at "
                f"{FULL_NODES} nodes, waves of {WAVE}: {wall:.3f} s, placed "
                f"{r['placed']}/{r['total']}, objective {r['objective']}, "
                f"util {r['util']}, frag {r['frag']}, passed {r['passed']}")
        n_sync = sum(a["syncs"].values())
        log(f"[autopilot] (a) step() {a['step_s']:.3f} s (the two replays "
            f"on {a['paths']}, {a['waves']} per-wave dispatches, "
            f"{a['ci_launches']} taint/port launches); start to promoted "
            f"{a['promote_s']:.3f} s; implicit host syncs of the step "
            f"{n_sync} = {n_sync / max(a['waves'], 1):.1f} a replay wave ("
            + ", ".join(f"{k} x{v}" for k, v in
                        sorted(a["syncs"].items())[:6]) + ")")
        log(f"[autopilot] (a) {' -> '.join(out['states'])}, live "
            f"{out['versions'][0]}, promotions {out['promotions']}; new "
            f"round buckets across step, promotion and watch: "
            f"{len(a['new_keys'][0])} (all programs: {a['new_keys'][1]}, the "
            "replays' own shape); /debug/autopilot 200 == status()")
        log(f"[autopilot] (a) forced regression (skewed 3-node world): "
            f"{' -> '.join(forced['states'])}, {forced['promoted']} -> "
            f"{forced['restored']} {restore_s:.4f} s from the breaching "
            f"round's start ({forced['reason']}); store role "
            f"{forced['roles'][0]} until step(), then {forced['roles'][1]}; "
            f"promotions {forced['promotions']}; trail {' -> '.join(trail)}")
        Path(traced["ledger"]).unlink()
        Path(traced["ledger"]).parent.rmdir()

        # (b) phase 14's untraced drain, checked
        n_total = TRACED_PODS + 2 * TRACED_EXTRA
        sched, store, placed, wall, times = checked_drain(
            mods, enc, bucket_size, "cuda", FULL_NODES, TRACED_PODS, n_total)
        if bindings(store) != traced["untraced"]:
            a_, b_ = traced["untraced"], bindings(store)
            diff = [k for k in a_ if a_[k] != b_.get(k)]
            fail(f"autopilot: the checked drain's bindings differ from phase "
                 f"14's untraced run for {len(diff)} pods, e.g. {diff[:5]}")
        bound = sum(1 for p in store.list("pods") if p.spec.node_name)
        log(f"[autopilot] (b) checked drain, {FULL_NODES} nodes, "
            f"{TRACED_PODS} pods: placed {placed} in {wall:.3f} s = "
            f"{placed / wall:.1f} pods/s (phase 14 unchecked "
            f"{traced['untraced_pods_s']:.1f}), bindings equal phase 14's; "
            f"{sched.invariants.checks} checks, 0 violations, a check "
            f"{1e3 * statistics.mean(times):.1f} ms mean, "
            f"{1e3 * max(times):.1f} ms max at {bound} bound pods")
        # the syncs of one wave with the checker on and off: WAVE new
        # density pods a wave, after one warm wave
        syncs = {}
        chk = sched.invariants
        for k, checked in enumerate((True, True, False)):
            add_singles(api, store, f"probe{k}", WAVE, "100m", None)
            sched.invariants = chk if checked else None
            if k == 0:
                n = sched.run_once()
            else:
                n, syncs[checked] = count_syncs(torch, sched.run_once)
            if n != WAVE:
                fail(f"autopilot: a probe wave placed {n}")
        sched.invariants = chk
        sc, su = (sum(syncs[f].values()) for f in (True, False))
        log(f"[autopilot] (b) implicit host syncs of one {WAVE}-pod wave: "
            f"checked {sc}, unchecked {su}")
        if sc > su:
            fail(f"autopilot: a checked wave synced {sc} times, an unchecked "
                 f"one {su}")
        found = plant_faults(api, sched, store, InvariantChecker)
        for k, inv, detail, _ in found:
            log(f"[autopilot] (b) planted fault, check {k}: {inv}: {detail}")
        del sched, store
        torch.cuda.empty_cache()
        t_ab = time.monotonic() - t_phase

        # (c) card == CPU at SMALL_NODES
        got = {}
        ldir = Path(tempfile.mkdtemp(prefix="chip_smoke_ap_"))
        for device in ("cuda", "cpu"):
            t0 = time.monotonic()
            path = ldir / f"{device}.jsonl"
            scored = ap_ledger(mods, enc, bucket_size, tracing, weights_mod,
                               stack, device, path)
            ctable = ap.RidgeTrainer(base).fit(load_dataset(str(path)))
            tracing.enable(clock=VirtualClock())
            try:
                c = pilot_run(mods, enc, bucket_size, kernel_mod, tp, ap,
                              ladder, device, SMALL_NODES, ctable, 4.0)
                cforced, _ = forced_regression(api, store_mod, ap, Scheduler,
                                               device)
                ctrail = [strip_uids({k: v for k, v in r.items() if k != "ts"})
                          for r in tracing.active().ledger_rows()
                          if r.get("kind") == "autopilot"]
            finally:
                tracing.disable()
            csched, cstore, cplaced, _, _ = checked_drain(
                mods, enc, bucket_size, device, SMALL_NODES, SMALL_PODS,
                SMALL_PODS)
            got[device] = {
                "table": sorted((k, float(v).hex()) for k, v in
                                ctable.items()),
                "scored": scored, "pipeline": c["out"], "forced": cforced,
                "trail": ctrail, "checked": bindings(cstore),
                "checks": csched.invariants.checks}
            log(f"[autopilot] (c) {device}: {scored} scored rounds, pipeline "
                f"{' -> '.join(c['out']['states'])}, replays "
                + ", ".join(f"{r['name']} {r['objective']}"
                            for r in c["out"]["replays"])
                + f", checked drain placed {cplaced} in "
                f"{csched.invariants.checks} checks; "
                f"{time.monotonic() - t0:.3f} s")
            del csched, cstore
        for path in ldir.iterdir():
            path.unlink()
        ldir.rmdir()
        for key in got["cpu"]:
            if got["cuda"][key] != got["cpu"][key]:
                fail(f"autopilot: (c) card and CPU {key} differ: "
                     f"{got['cuda'][key]} / {got['cpu'][key]}")
        log(f"[autopilot] (c) {SMALL_NODES} nodes: card == CPU trained "
            "table (bit for bit), transition trail, replays (placed, total, "
            "util, frag, margin_rel, objective), forced regression, checked "
            "drain's bindings and checks")
        launches = tp.taint_ports_masks.launches
        whatif_launches = pre.preempt_whatif.launches
    finally:
        sched_mod.Scheduler = saved[0]
        kernel_mod.taint_ports_masks = saved[1]
        filters.taint_ports_masks = saved[2]
        tracing.disable()
    err = check_captured(torch, tp, "autopilot", seen)
    log(f"[autopilot] taint/port launches {launches}, what-if "
        f"{whatif_launches}; (a)+(b) {t_ab:.1f} s, phase "
        f"{time.monotonic() - t_phase:.1f} s")
    return dict(launches=launches, whatif_launches=whatif_launches,
                max_err=err)


def outcome_view(o) -> dict:
    """A ReplayOutcome less its pod uids (a process-wide counter: the
    card's run and the CPU's mint different ones)."""
    def strip(x):
        if isinstance(x, str):
            return POD_UID.sub("uid-*", x)
        if isinstance(x, dict):
            return {strip(k): strip(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [strip(v) for v in x]
        return x
    return {"violation": o.violation, "detail": strip(o.detail),
            "digest": strip(o.digest), "injected": dict(o.injected),
            "placed": o.placed, "checks": o.checks}


def recorded_replays(campaign, run):
    """run() with the campaign's replay (which run_campaign and shrink
    call by its module name) recorded: (run()'s result, [(outcome view,
    seconds)] in call order)."""
    real = campaign.replay
    seen = []

    def replay(*a, **kw):
        t0 = time.monotonic()
        out = real(*a, **kw)
        seen.append((outcome_view(out), time.monotonic() - t0))
        return out
    campaign.replay = replay
    try:
        return run(), seen
    finally:
        campaign.replay = real


def campaign_run(campaign, device):
    """(a) run_campaign(CHAOS_SEED, CHAOS_SCHEDULES) on `device`: the
    schedules' env strings, each replay's outcome and seconds, the
    result."""
    lines = []
    res, seen = recorded_replays(campaign, lambda: campaign.run_campaign(
        CHAOS_SEED, CHAOS_SCHEDULES, device=device, log=lines.append))
    envs = [ln.split("] ", 1)[1].rsplit(" -> ", 1)[0] for ln in lines
            if ln.startswith("[")]
    if not res.ok or res.schedules != CHAOS_SCHEDULES or \
            not res.injected_total or len(seen) != CHAOS_SCHEDULES:
        fail(f"chaos: (a) the campaign on {device}: {res.schedules} "
             f"schedules, {res.injected_total} hits, findings "
             f"{[(f.env, f.outcome.violation) for f in res.findings]}")
    return {"envs": envs, "outcomes": [o for o, _ in seen],
            "seconds": [s for _, s in seen],
            "totals": (res.checks_total, res.injected_total)}


def broken_run(campaign, device, hook, spec, names, minimal):
    """(b) one broken build on `device`: its schedule caught, shrunk and
    re-triggered from the env string; the healthy build tolerates the
    same schedule."""
    point, mode, times = spec
    schedule = [campaign.FaultSpec(point, mode, times=times)]

    def configure(sched):
        setattr(sched, hook, False)

    def run():
        broken = campaign.replay(schedule, CHAOS_SEED, configure=configure,
                                 device=device)
        small, _ = campaign.shrink(schedule, CHAOS_SEED, configure=configure,
                                   device=device)
        env = campaign.env_string(small)
        again = campaign.replay((), CHAOS_SEED, env_spec=env,
                                configure=configure, device=device)
        healthy = campaign.replay(schedule, CHAOS_SEED, device=device)
        return broken, env, again, healthy

    (broken, env, again, healthy), seen = recorded_replays(campaign, run)
    if broken.violation not in names or not broken.digest or \
            env != minimal or not again.violated or healthy.violated or \
            not healthy.injected.get(point) or (
                hook == "_journal_replay_enabled"
                and "outlived the outage" not in broken.detail):
        fail(f"chaos: (b) {hook} off on {device}: caught "
             f"{broken.violation} ({broken.detail}), shrunk to {env!r}, "
             f"re-triggered {again.violation}, healthy {healthy.violation}")
    return {"outcomes": [o for o, _ in seen], "minimal": env,
            "seconds": sum(s for _, s in seen), "replays": len(seen)}


def hollow_run(torch, mods, enc, bucket_size, faultpoints, device, n_nodes,
               ticks, probe=False):
    """(c) the campaign's loop on a HollowCluster of n_nodes nodes on
    `device`, `ticks` ticks of arrivals, with HOLLOW_ARMED armed at tick
    2 (see HOLLOW_TICKS). Every
    placement is checked (check_bindings), the fitting gang whole, the
    other unbound, every armed point hit, no violation, breaker or store
    trip. probe: time the registration, the heartbeat ticks, the checks,
    the drain and its host phases, and count the syncs of one checked
    wave and the gang dispatches. Returns what is compared and
    printed."""
    import random

    from kubernetes_tpu_torch.chaos import InvariantChecker, campaign
    from kubernetes_tpu_torch.chaos import InvariantViolation
    from kubernetes_tpu_torch.kubemark import HollowCluster

    api, tp, sched_mod, Scheduler, store_mod = (mods[0], mods[1], mods[4],
                                                mods[5], mods[-1])
    rng = random.Random(SEED)
    arrivals = {t: [campaign._mk_pod(f"load-{t}-{i}",
                                     cpu=rng.choice((100, 250)),
                                     priority=rng.choice((0, 1500)))
                    for i in range(HOLLOW_ARRIVALS)]
                for t in range(ticks)}
    for t, name, (members, cpu) in ((2, "gfit", HOLLOW_FIT),
                                    (3, "gbig", HOLLOW_BIG)):
        arrivals[t] += [campaign._mk_pod(f"{name}-{i}", cpu=cpu, gang=name,
                                         min_member=members)
                        for i in range(members)]
    n_pods = sum(len(v) for v in arrivals.values())
    faultpoints.reset()
    store = store_mod.ObjectStore()
    vclock = VirtualClock()
    sched = Scheduler(store, wave_size=WAVE, device=device, clock=vclock,
                      caps=enc.Caps(M=bucket_size(2 * n_pods + 64), P=WAVE,
                                    LV=bucket_size(n_nodes + 256, 64)))
    chk = InvariantChecker(metrics=sched.metrics, strict=True)
    sched.invariants = chk
    check_s = []
    check = chk.check

    def timed(s):
        t0 = time.monotonic()
        try:
            return check(s)
        finally:
            check_s.append(time.monotonic() - t0)
    chk.check = timed
    seen = {}
    clock = PhaseClock()
    saved = {name: getattr(sched_mod, name)
             for name in ("schedule_wave", "schedule_gang", "preempt")}
    gangs = [0]
    if probe:
        sync = torch.cuda.synchronize if device == "cuda" else None

        def gang(*a, **kw):
            gangs[0] += 1
            return saved["schedule_gang"](*a, **kw)
        sched_mod.schedule_wave = clock.wrap(
            "wave_dispatch", saved["schedule_wave"], sync)
        sched_mod.schedule_gang = clock.wrap("gang_dispatch", gang, sync)
        # the per-wave path's host preemption of a failed pod or gang
        # (sched/preemption.py preempt over the numpy what-if)
        sched_mod.preempt = clock.wrap("host_preempt", saved["preempt"])
        sched.featurizer.featurize = clock.wrap("featurize",
                                                sched.featurizer.featurize)
        sched.snapshot.to_device = clock.wrap("upload",
                                              sched.snapshot.to_device, sync)
        sched._commit = clock.wrap("commit", sched._commit)
        sched._commit_gang = clock.wrap("commit", sched._commit_gang)
        store.create = clock.wrap("arrivals", store.create)
    t0 = time.monotonic()
    hc = HollowCluster(store, n_nodes, zones=3, racks=8, generations=3,
                       clock=vclock)
    seen["build_s"] = time.monotonic() - t0
    t0 = time.monotonic()
    for node in hc.nodes:
        node.kubelet.register_node()
    seen["register_s"] = time.monotonic() - t0
    beat_s, uploads, placed, last_bind = [], [], 0, None
    waves0 = int(sched.metrics.waves_total.value(path="device"))
    launches0 = tp.taint_ports_masks.launches
    clock.seconds.clear()
    t_first = time.monotonic()
    run_once = clock.wrap("run_once", sched.run_once)

    def wave():
        nonlocal placed, last_bind
        n = run_once(timeout=0)
        placed += n
        if n:
            last_bind = time.monotonic()
        return n

    try:
        for t in range(ticks + HOLLOW_DRAIN_TICKS):
            if t == 2:
                faultpoints.activate_spec(HOLLOW_ARMED)
            vclock.t += 1.0
            t0 = time.monotonic()
            for node in hc.nodes[t % HOLLOW_HB_EVERY::HOLLOW_HB_EVERY]:
                node.kubelet.heartbeat()
            beat_s.append(time.monotonic() - t0)
            for pod in arrivals.get(t, ()):
                store.create("pods", pod)
            up = sched.snapshot.upload_bytes_total
            if probe and device == "cuda" and t == 1:
                _, seen["syncs"] = count_syncs(torch, wave)
            else:
                wave()
            uploads.append(sched.snapshot.upload_bytes_total - up)
            wave()
            if t >= ticks and sorted(
                    p.metadata.name for p in store.list("pods")
                    if not p.spec.node_name) == \
                    [f"gbig-{i}" for i in range(HOLLOW_BIG[0])]:
                break
    except InvariantViolation as v:
        fail(f"chaos: (c) {n_nodes} nodes on {device}: {v.invariant}: "
             f"{v.detail}")
    finally:
        hits = {name: faultpoints.hits(name)
                for name, *_ in faultpoints.parse(HOLLOW_ARMED)}
        faultpoints.reset()
        hc.stop()
        for name, fn in saved.items():
            setattr(sched_mod, name, fn)
    sched.wait_for_binds()
    b = bindings(store)
    pending = sorted(k for k, v in b.items() if not v)
    check_bindings(api, store)
    if pending != [f"gbig-{i}" for i in range(HOLLOW_BIG[0])] or \
            not all(b[f"gfit-{i}"] for i in range(HOLLOW_FIT[0])) or \
            not all(hits.values()) or chk.violations or \
            sched.breaker.trips or sched.storehealth.trips:
        fail(f"chaos: (c) {n_nodes} nodes on {device}: pending {pending[:8]}"
             f" ({len(pending)}), hits {hits}, violations "
             f"{[v.invariant for v in chk.violations]}, breaker trips "
             f"{sched.breaker.trips}, store trips {sched.storehealth.trips}")
    seen.update(
        bindings=b, hits=hits, checks=chk.checks, placed=placed,
        ticks=t + 1, n_pods=n_pods, beat_s=beat_s, uploads=uploads,
        check_s=check_s, waves=int(sched.metrics.waves_total.value(
            path="device")) - waves0, gangs=gangs[0],
        launches=tp.taint_ports_masks.launches - launches0,
        phases=dict(clock.seconds), checks_s=sum(check_s),
        drain_s=(last_bind or t_first) - t_first, path=sched.wave_path())
    sched.close()
    return seen


def chaos_phase(torch, mods, enc, bucket_size, filters, faultpoints):
    """Phase 23: (a) the seeded campaign and (b) the two broken builds on
    the card, each held to the CPU's run, replay by replay; (c) a
    fault-armed HollowCluster at FULL_NODES on the card, and the same
    loop at SMALL_NODES on the card and on the CPU, equal. Returns what
    it saw."""
    from kubernetes_tpu_torch.chaos import campaign

    api, tp, pre, kernel_mod = mods[:4]
    t_phase = time.monotonic()
    seen = {}
    saved = (kernel_mod.taint_ports_masks, filters.taint_ports_masks)
    kernel_mod.taint_ports_masks = capturing(saved[0], seen)
    filters.taint_ports_masks = capturing(saved[1], seen)
    tp.taint_ports_masks.launches = 0
    pre.preempt_whatif.launches = 0
    try:
        # (a) the campaign
        got = {d: campaign_run(campaign, d) for d in ("cuda", "cpu")}
        for k, (env, a, b) in enumerate(zip(got["cuda"]["envs"],
                                            got["cuda"]["outcomes"],
                                            got["cpu"]["outcomes"])):
            if a != b or env != got["cpu"]["envs"][k]:
                fail(f"chaos: (a) schedule {k} {env}: card {a}, CPU {b}")
            log(f"[chaos] (a) {k + 1}/{CHAOS_SCHEDULES} {env}: "
                f"{a['violation'] or 'clean'}, placed {a['placed']}, "
                f"{a['checks']} checks, hits {a['injected']}; card "
                f"{got['cuda']['seconds'][k]:.3f} s, CPU "
                f"{got['cpu']['seconds'][k]:.3f} s: card == CPU")
        sec = {d: got[d]["seconds"] for d in got}
        log(f"[chaos] (a) run_campaign(seed={CHAOS_SEED}, schedules="
            f"{CHAOS_SCHEDULES}): no finding, checks and hits "
            f"{got['cuda']['totals']}; a replay on the card "
            f"{statistics.mean(sec['cuda']):.3f} s mean "
            f"({sum(sec['cuda']):.3f} s), on the CPU "
            f"{statistics.mean(sec['cpu']):.3f} s mean "
            f"({sum(sec['cpu']):.3f} s)")
        t_a = time.monotonic() - t_phase

        # (b) the broken builds
        t0 = time.monotonic()
        for hook, spec, names, minimal in CHAOS_BROKEN:
            got = {d: broken_run(campaign, d, hook, spec, names, minimal)
                   for d in ("cuda", "cpu")}
            if got["cuda"]["outcomes"] != got["cpu"]["outcomes"]:
                fail(f"chaos: (b) {hook} off: card {got['cuda']} / CPU "
                     f"{got['cpu']}")
            first = got["cuda"]["outcomes"][0]
            log(f"[chaos] (b) {hook} = False, {spec[0]}={spec[1]}::"
                f"{spec[2]}: caught as {first['violation']} "
                f"({first['detail'][:80]}), shrunk to "
                f"{got['cuda']['minimal']!r} and re-triggered from it; the "
                f"healthy build clean; {got['cuda']['replays']} replays, "
                f"card {got['cuda']['seconds']:.3f} s, CPU "
                f"{got['cpu']['seconds']:.3f} s: card == CPU, replay by "
                "replay")
        t_b = time.monotonic() - t0

        # (c) the hollow cluster with faults armed
        t0 = time.monotonic()
        h = hollow_run(torch, mods, enc, bucket_size, faultpoints, "cuda",
                       FULL_NODES, HOLLOW_TICKS, probe=True)
        cs = h["check_s"]
        ph = h["phases"]
        inner = sum(v for k, v in ph.items()
                    if k not in ("run_once", "arrivals"))
        ph["other (queue, host mask, failed gangs, binds)"] = (
            ph.get("run_once", 0.0) - inner - h["checks_s"])
        ph["checks"] = h["checks_s"]
        ph["heartbeats"] = sum(h["beat_s"])
        beats = h["beat_s"][1:HOLLOW_TICKS]
        n_sync = sum(h["syncs"].values())
        log(f"[chaos] (c) HollowCluster of {FULL_NODES} nodes: built and "
            f"registered in {h['build_s']:.3f} s (every kubelet's "
            f"register_node() again: {h['register_s']:.3f} s); a tick's "
            f"{FULL_NODES // HOLLOW_HB_EVERY} heartbeats "
            f"{statistics.mean(beats):.3f} s mean, {max(beats):.3f} s max; "
            f"the uploads after them {sorted(set(h['uploads'][1:]))} B "
            f"(the first, full: {h['uploads'][0]} B)")
        log(f"[chaos] (c) {h['placed']} of {h['n_pods']} pods placed in "
            f"{h['ticks']} ticks, {h['drain_s']:.3f} s from the first "
            f"arrival to the last bind = {h['placed'] / h['drain_s']:.1f} "
            f"pods/s; {h['waves']} per-wave dispatches on {h['path']}, "
            f"{h['gangs']} gang dispatches, {h['launches']} taint/port "
            f"launches; {h['checks']} checks, "
            f"{1e3 * statistics.mean(cs):.1f} ms mean, "
            f"{1e3 * max(cs):.1f} ms max; hits {h['hits']}; the gang of "
            f"{HOLLOW_FIT[0]} whole, the gang of {HOLLOW_BIG[0]} x "
            f"{HOLLOW_BIG[1]}m pending; no violation, breaker or store "
            f"trip; implicit host syncs of one checked wave {n_sync} ("
            + ", ".join(f"{k} x{v}" for k, v in
                        sorted(h["syncs"].items())[:6]) + ")")
        log("[chaos] (c) host seconds of the drain: " + ", ".join(
            f"{k} {v:.3f}" for k, v in sorted(ph.items(),
                                               key=lambda kv: -kv[1])))
        del h
        torch.cuda.empty_cache()
        t_c = time.monotonic() - t0
        got = {}
        for device in ("cuda", "cpu"):
            t0 = time.monotonic()
            h = hollow_run(torch, mods, enc, bucket_size, faultpoints,
                           device, SMALL_NODES, HOLLOW_SMALL_TICKS)
            got[device] = {k: h[k] for k in ("bindings", "hits", "checks",
                                             "placed")}
            log(f"[chaos] (c) {SMALL_NODES} nodes on {device}: placed "
                f"{h['placed']} in {h['ticks']} ticks, {h['checks']} "
                f"checks, hits {h['hits']}; {time.monotonic() - t0:.3f} s")
        if got["cuda"] != got["cpu"]:
            a, b = got["cuda"], got["cpu"]
            diff = [k for k in a["bindings"]
                    if a["bindings"][k] != b["bindings"].get(k)]
            fail(f"chaos: (c) card and CPU differ at {SMALL_NODES} nodes: "
                 f"hits {a['hits']} / {b['hits']}, checks {a['checks']} / "
                 f"{b['checks']}, bindings of {diff[:5]}")
        log(f"[chaos] (c) {SMALL_NODES} nodes, {HOLLOW_SMALL_TICKS} ticks of "
            "arrivals: card == CPU bindings, hits and checks")
        launches = tp.taint_ports_masks.launches
        whatif_launches = pre.preempt_whatif.launches
    finally:
        kernel_mod.taint_ports_masks = saved[0]
        filters.taint_ports_masks = saved[1]
        faultpoints.reset()
    err = check_captured(torch, tp, "chaos", seen)
    log(f"[chaos] taint/port launches {launches}, what-if "
        f"{whatif_launches}; (a) {t_a:.1f} s, (b) {t_b:.1f} s, (c) at "
        f"{FULL_NODES} nodes {t_c:.1f} s, phase "
        f"{time.monotonic() - t_phase:.1f} s")
    return dict(launches=launches, whatif_launches=whatif_launches,
                max_err=err)


# --- phase 24: kubeadm ------------------------------------------------------------


class BindClock:
    """A watcher on a store that keeps the names of the bound web pods
    and the time of the last bind. The store calls it under its lock on
    the writing thread, so it only records."""

    def __init__(self, MODIFIED):
        self.MODIFIED = MODIFIED
        self.bound = set()
        self.last = None

    def __call__(self, ev):
        pod = ev.obj
        if ev.type == self.MODIFIED and pod.spec.node_name and \
                (pod.metadata.labels or {}).get("app") == "web" and \
                pod.metadata.name not in self.bound:
            self.bound.add(pod.metadata.name)
            self.last = time.monotonic()


def web_deployment(api, lbl, replicas):
    """The kubeadm phase's Deployment: `replicas` pods of 100m and 64Mi."""
    return api.Deployment(
        metadata=api.ObjectMeta(name="web"),
        spec=api.DeploymentSpec(
            replicas=replicas,
            selector=lbl.LabelSelector(match_labels={"app": "web"}),
            template=api.PodTemplateSpec(
                metadata=api.ObjectMeta(labels={"app": "web"}),
                spec=api.PodSpec(containers=[api.Container(
                    name="c", resources=api.ResourceRequirements(
                        requests=api.resource_list(cpu="100m",
                                                   memory="64Mi")))]))))


def web_pods(store):
    """The web pods in the store's order, which is their creation order."""
    return [p for p in store.list("pods")
            if (p.metadata.labels or {}).get("app") == "web"]


def end_watches(srv):
    """Ends the server's watch streams, as the exit of its process would:
    APIServer.stop() leaves them open until their timeout (10 s). After a
    restart the old server's are ended once the new one serves, so that
    the reflectors relist at once and find it up (ended before, each
    relist would fail against the restart and trip the store breaker)."""
    for w in list(srv.broadcaster._watchers):
        w.stop()


def stop_cluster(cluster):
    """Stops the scheduler's reflectors, then ends the server's watch
    streams (they exit instead of relisting against a server about to
    stop, which would trip the store breaker), then the Cluster."""
    cluster._sched_store.stop()
    end_watches(cluster.apiserver)
    cluster.stop()


def kubeadm_wait(cond, what, state=None):
    """Polls cond() until it holds; fails past KUBEADM_WAIT_S, with what
    state() reports."""
    deadline = time.monotonic() + KUBEADM_WAIT_S
    while not cond():
        if time.monotonic() > deadline:
            fail(f"kubeadm: {what} not reached within {KUBEADM_WAIT_S} s"
                 + (f"; {state()}" if state is not None else ""))
        time.sleep(0.02)


def drive_state(cluster, binds):
    """What a stalled drive of (b) looks like: the web pods bound, in
    the store and in the scheduler's mirror, its queue, its streams."""
    remote = cluster._sched_store
    pods = web_pods(cluster.store)
    mirrored = [p for p in remote._mirrors.get("pods", {}).values()
                if (p.metadata.labels or {}).get("app") == "web"]
    return (f"{len(binds.bound)} bound of {len(pods)} web pods in the "
            f"store, {len(mirrored)} in the scheduler's mirror; queue "
            f"{cluster.scheduler.queue.pending_count()}; store breaker "
            f"{cluster.scheduler.storehealth.state}; streams " + ", ".join(
                f"{k} {r.relists}/{r.last_sync_rv}"
                for k, r in remote._reflectors.items())
            + f" (store at {cluster.store._rv}); scheduler thread alive "
            f"{cluster._sched_thread.is_alive()}")


class Heartbeats:
    """The script's heartbeat loop for hollow kubelets that do not run:
    on a thread of its own, KUBEADM_HB_SLICES slices a KUBEADM_HB_PERIOD,
    back to back while it is behind, so that every node beats once a
    period when the process can carry it. Keeps the seconds of each
    slice."""

    def __init__(self, hc):
        self.hc = hc
        self.seconds = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="heartbeats")

    def _run(self):
        k, due = 0, time.monotonic()
        while not self._stop.is_set():
            t0 = time.monotonic()
            for node in self.hc.nodes[k % KUBEADM_HB_SLICES::
                                      KUBEADM_HB_SLICES]:
                node.kubelet.heartbeat()
            self.seconds.append(time.monotonic() - t0)
            k += 1
            due += KUBEADM_HB_PERIOD / KUBEADM_HB_SLICES
            self._stop.wait(max(0.0, due - time.monotonic()))

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=KUBEADM_WAIT_S)


def kubeadm_settled(cluster, n_nodes):
    """A condition: the TTL controller has annotated all n_nodes nodes and
    the scheduler's node mirror has seen every write the store held when
    they were."""
    ttl = cluster.manager["ttl"]
    key = "node.alpha.kubernetes.io/ttl"
    mark = []

    def settled():
        if not mark:
            nodes = cluster.store.list("nodes")
            if len(nodes) < n_nodes or len(ttl.queue) or any(
                    key not in n.metadata.annotations for n in nodes):
                return False
            mark.append(cluster.store._rv)
        return cluster._sched_store._reflectors["nodes"].last_sync_rv >= \
            mark[0]
    return settled


def kubeadm_cli(kubeadm):
    """(a) `main(["init", "--once", "--secure"])` in this process, on the
    card: the torch preflight, the control plane up, ready, stopped.
    Returns the seconds from the Cluster's construction to ready and the
    printed ready line."""
    seen = {}
    real = kubeadm.Cluster

    class Timed(real):
        def __init__(self, *a, **kw):
            seen["t0"] = time.monotonic()
            super().__init__(*a, **kw)
            seen["device"] = str(self.device)

        def wait_ready(self, timeout=10.0):
            ok = real.wait_ready(self, timeout)
            seen["ready_s"] = time.monotonic() - seen["t0"]
            return ok

    preflight = kubeadm.phase_preflight()
    if preflight:
        fail(f"kubeadm: (a) preflight on the card: {preflight}")
    buf = io.StringIO()
    t0 = time.monotonic()
    kubeadm.Cluster = Timed
    try:
        with contextlib.redirect_stdout(buf):
            rc = kubeadm.main(["init", "--once", "--secure"])
    finally:
        kubeadm.Cluster = real
    out = buf.getvalue()
    ready = [ln for ln in out.splitlines() if "control plane ready" in ln]
    if rc != 0 or not ready or "https://" not in ready[0] or \
            seen.get("device") != "cuda":
        fail(f"kubeadm: (a) init --once --secure: rc {rc}, device "
             f"{seen.get('device')}, output {out[:300]!r}")
    seen["seconds"] = time.monotonic() - t0
    seen["line"] = ready[0]
    return seen


def kubeadm_secure_b(torch, mods, lbl, kubeadm, filters):
    """(b) a secure Cluster on the card at FULL_NODES nodes: two joins
    over mTLS, a Deployment of KUBEADM_PODS POSTed with the admin token
    and placed by the Cluster's scheduler thread over REST binds, a live
    upgrade_cluster, then the Deployment scaled to KUBEADM_SCALE. Logs
    each step as it ends; returns what is checked after."""
    from kubernetes_tpu_torch.client.reflector import RemoteStore
    from kubernetes_tpu_torch.client.rest import RESTClient
    from kubernetes_tpu_torch.kubemark import HollowCluster, HollowNode
    from kubernetes_tpu_torch.ops import zonehealth

    api, tp, kernel_mod, store_mod = mods[0], mods[1], mods[3], mods[-1]
    seen, out = {}, {}
    saved = (kernel_mod.taint_ports_masks, filters.taint_ports_masks)
    t0 = time.monotonic()
    cluster = kubeadm.Cluster(secure=True, hollow_nodes=0)
    cluster.manager["nodelifecycle"].grace_period = KUBEADM_GRACE_S
    kubeadm.ensure_bootstrap_objects(cluster.store)
    kubeadm.phase_upload_config(cluster.store)
    hc = HollowCluster(cluster.store, FULL_NODES - KUBEADM_JOINS, zones=3)
    build_s = time.monotonic() - t0
    binds = BindClock(store_mod.MODIFIED)
    cluster.store.watch("pods", binds)
    joined, remotes = [], []
    beats = Heartbeats(hc)
    try:
        with beats:
            t0 = time.monotonic()
            cluster.start()
            if not cluster.wait_ready(timeout=KUBEADM_WAIT_S):
                fail("kubeadm: (b) the control plane never became ready")
            ready_s = time.monotonic() - t0
            t0 = time.monotonic()
            kubeadm_wait(kubeadm_settled(cluster,
                                         FULL_NODES - KUBEADM_JOINS),
                         "the TTL annotations and the scheduler's mirror")
            log(f"[kubeadm] (b) secure Cluster: {FULL_NODES - KUBEADM_JOINS}"
                f" hollow nodes in 3 zones built and registered in "
                f"{build_s:.3f} s, ready in {ready_s:.3f} s, settled (TTL "
                "annotations, the scheduler's mirror) in "
                f"{time.monotonic() - t0:.3f} s")
            sched = cluster.scheduler
            nlc = cluster.manager["nodelifecycle"]
            if str(sched.device) != "cuda" or str(nlc.device) != "cuda":
                fail(f"kubeadm: (b) scheduler on {sched.device}, node "
                     f"lifecycle on {nlc.device}, not the card")
            ca_pem = cluster.ca.ca_cert_pem
            join_s = []
            for i in range(KUBEADM_JOINS):
                name = f"joined-{i}"
                t0 = time.monotonic()
                key, cert, got_ca = kubeadm.join_with_csr(
                    cluster.url, name, cluster.bootstrap_token,
                    timeout=KUBEADM_WAIT_S)
                if got_ca != ca_pem:
                    fail(f"kubeadm: (b) {name} discovered another CA")
                remote = RemoteStore(RESTClient(
                    cluster.url, client_cert_pem=cert, client_key_pem=key,
                    ca_cert_pem=got_ca))
                remotes.append(remote)
                for kind in ("pods", "nodes"):
                    remote.mirror(kind)
                remote.wait_for_sync(timeout=KUBEADM_WAIT_S)
                joined.append(HollowNode(remote, name).run(period=1.0))
                kubeadm_wait(lambda: any(n.metadata.name == name for n in
                                         cluster.store.list("nodes")),
                             f"{name} registered")
                join_s.append(time.monotonic() - t0)
            t0 = time.monotonic()
            kubeadm_wait(kubeadm_settled(cluster, FULL_NODES),
                         "the joined nodes' TTL annotations")
            csrs = cluster.store.list("certificatesigningrequests")
            if len(csrs) != KUBEADM_JOINS or not all(
                    c.approved and c.status.certificate for c in csrs):
                fail(f"kubeadm: (b) CSRs not all approved and signed: "
                     f"{[(c.metadata.name, c.approved) for c in csrs]}")
            log(f"[kubeadm] (b) {KUBEADM_JOINS} joins over CSR and mTLS, "
                "each CSR approved and signed by the certificates "
                "controllers: " + ", ".join(f"{s:.3f}" for s in join_s)
                + f" s; settled again in {time.monotonic() - t0:.3f} s")
            admin = RESTClient(cluster.url, token=cluster.admin_token,
                               ca_cert_pem=ca_pem)
            kernel_mod.taint_ports_masks = capturing(saved[0], seen)
            filters.taint_ports_masks = capturing(saved[1], seen)
            tp.taint_ports_masks.launches = 0
            waves0 = int(sched.metrics.waves_total.value(path="device"))
            tally0 = dict(zonehealth.TALLY_COUNTS)
            t_post = time.monotonic()
            admin.create("deployments",
                         web_deployment(api, lbl, KUBEADM_PODS))
            kubeadm_wait(lambda: len(binds.bound) >= KUBEADM_PODS,
                         f"{KUBEADM_PODS} web pods bound",
                         lambda: drive_state(cluster, binds))
            drain_s = binds.last - t_post
            log(f"[kubeadm] (b) {KUBEADM_PODS} pods from the POST to the "
                f"last bind in {drain_s:.3f} s = "
                f"{KUBEADM_PODS / drain_s:.1f} pods/s, "
                f"{int(sched.metrics.waves_total.value(path='device')) - waves0}"
                " per-wave dispatches so far")
            before = {p.metadata.name: p.spec.node_name
                      for p in web_pods(cluster.store)}
            nodes_refl = cluster._sched_store._reflectors["nodes"]
            old = cluster.apiserver
            t0 = time.monotonic()
            kubeadm.upgrade_cluster(cluster, KUBEADM_VERSION)
            restart_s = time.monotonic() - t0
            # the scheduler's streams re-open on the new server (a watch
            # from the last version seen, or a relist where that is out
            # of its window); heartbeats keep writing nodes, so its node
            # mirror passing the store's version now shows they did
            t0 = time.monotonic()
            mark = cluster.store._rv
            end_watches(old)
            kubeadm_wait(lambda: nodes_refl.last_sync_rv > mark,
                         "the scheduler's streams on the new server")
            relist_s = time.monotonic() - t0
            served = {p.metadata.name: p.spec.node_name
                      for p in admin.list("pods", "default")[0]
                      if (p.metadata.labels or {}).get("app") == "web"}
            cm = admin.get("configmaps", "kube-system",
                           kubeadm.CLUSTER_CONFIG_NAME)
            if served != before or \
                    admin.get("deployments", "default",
                              "web").spec.replicas != KUBEADM_PODS or \
                    len(admin.list("nodes")[0]) != FULL_NODES or \
                    cm.data["clusterVersion"] != KUBEADM_VERSION:
                fail(f"kubeadm: (b) the new API server serves other "
                     f"objects: {len(served)} of {len(before)} web pods as "
                     f"before, version {cm.data}")
            log(f"[kubeadm] (b) upgrade to {KUBEADM_VERSION}: restart "
                f"{restart_s:.3f} s, the scheduler's streams back "
                f"{relist_s:.3f} s after; the new API server serves the {len(before)} web pods "
                f"where they were bound, the Deployment, {FULL_NODES} "
                "nodes and the new version")
            t_scale = time.monotonic()
            admin.update_scale("deployments", "default", "web",
                               KUBEADM_SCALE)
            kubeadm_wait(lambda: len(binds.bound) >= KUBEADM_SCALE,
                         f"{KUBEADM_SCALE} web pods bound",
                         lambda: drive_state(cluster, binds))
            scale_s = binds.last - t_scale
            out["launches"] = tp.taint_ports_masks.launches
            out["waves"] = int(sched.metrics.waves_total.value(
                path="device")) - waves0
            out["tally"] = {k: v - tally0[k]
                            for k, v in zonehealth.TALLY_COUNTS.items()}
            out["path"] = sched.wave_path()
            out["store_trips"] = sched.storehealth.trips
            log(f"[kubeadm] (b) scaled to {KUBEADM_SCALE}: "
                f"{KUBEADM_SCALE - KUBEADM_PODS} pods from the scale to the "
                f"last bind in {scale_s:.3f} s = "
                f"{(KUBEADM_SCALE - KUBEADM_PODS) / scale_s:.1f} pods/s")
            out["bound"] = check_bindings(api, cluster.store)
            pods = web_pods(cluster.store)
            if len(pods) != KUBEADM_SCALE or not all(p.spec.node_name
                                                     for p in pods):
                fail(f"kubeadm: (b) {len(pods)} web pods, "
                     f"{sum(1 for p in pods if not p.spec.node_name)} "
                     "unbound")
            zone_of = {n.metadata.name:
                       (n.metadata.labels or {}).get(ZONE, "")
                       for n in cluster.store.list("nodes")}
            zones = {}
            for p in pods:
                z = zone_of[p.spec.node_name]
                zones[z] = zones.get(z, 0) + 1
            out["zones"] = sorted(zones.items())
    finally:
        kernel_mod.taint_ports_masks = saved[0]
        filters.taint_ports_masks = saved[1]
        cluster.store.unwatch(binds)
        for node in joined:
            node.stop()
        for remote in remotes:
            remote.stop()
        stop_cluster(cluster)
        hc.stop()
    out["beats"] = beats.seconds
    out["captured"] = seen
    if not out["launches"] or out["store_trips"] or \
            out["tally"]["device_failures"] or not out["tally"]["device"]:
        fail(f"kubeadm: (b) launches {out['launches']}, store trips "
             f"{out['store_trips']}, zone tallies {out['tally']}")
    return out


def kubeadm_sync_run(mods, lbl, kubeadm, device):
    """(c) the Cluster of (b) at SMALL_NODES nodes on `device`, driven in
    this thread: its API server serves, and in turn the controller
    manager's sync_all and, once the scheduler's mirror holds what the
    store holds, one run_once and its binds; KUBEADM_SMALL_PODS web pods,
    a live upgrade, then KUBEADM_SMALL_SCALE. Returns the node of each web
    pod in creation order (the ReplicaSet names pods from a process-wide
    counter)."""
    from kubernetes_tpu_torch.client.rest import RESTClient
    from kubernetes_tpu_torch.kubemark import HollowCluster

    api = mods[0]
    cluster = kubeadm.Cluster(secure=True, hollow_nodes=0, device=device)
    kubeadm.ensure_bootstrap_objects(cluster.store)
    kubeadm.phase_upload_config(cluster.store)
    hc = HollowCluster(cluster.store, SMALL_NODES, zones=3)
    remote = cluster._sched_store

    def caught_up():
        for kind in ("pods", "nodes"):
            mine = {k: o.metadata.resource_version
                    for k, o in remote._mirrors.get(kind, {}).items()}
            theirs = {f"{o.metadata.namespace}/{o.metadata.name}":
                      o.metadata.resource_version
                      for o in cluster.store.list(kind)}
            if mine != theirs:
                return False
        return True

    def settle(want):
        sched = cluster.scheduler
        for _ in range(4 * want // WAVE + 16):
            cluster.manager.sync_all(rounds=1)
            kubeadm_wait(caught_up, f"(c) {device}: the mirror")
            if sum(1 for p in web_pods(cluster.store)
                   if p.spec.node_name) >= want:
                return
            sched.run_once(timeout=0)
            sched.wait_for_binds()
            kubeadm_wait(caught_up, f"(c) {device}: the mirror")
        fail(f"kubeadm: (c) {device}: {want} web pods never bound")

    try:
        cluster.apiserver.start()
        admin = RESTClient(cluster.url, token=cluster.admin_token,
                           ca_cert_pem=cluster.ca.ca_cert_pem)
        admin.create("deployments",
                     web_deployment(api, lbl, KUBEADM_SMALL_PODS))
        settle(KUBEADM_SMALL_PODS)
        old = cluster.apiserver
        kubeadm.upgrade_cluster(cluster, KUBEADM_VERSION)
        end_watches(old)
        admin.update_scale("deployments", "default", "web",
                           KUBEADM_SMALL_SCALE)
        settle(KUBEADM_SMALL_SCALE)
        check_bindings(api, cluster.store)
        return [p.spec.node_name for p in web_pods(cluster.store)]
    finally:
        stop_cluster(cluster)
        hc.stop()


def kubeadm_phase(torch, mods, lbl, filters, ladder):
    """Phase 24: kubeadm (cli/kubeadm.py) on the in-memory store, its
    scheduler and controllers on the card: (a) the CLI, (b) a secure
    cluster at FULL_NODES hollow nodes with two joins and a live upgrade,
    (c) card == CPU at SMALL_NODES, driven synchronously."""
    from kubernetes_tpu_torch.cli import kubeadm

    tp, pre = mods[1], mods[2]
    t_phase = time.monotonic()
    pre.preempt_whatif.launches = 0
    real = kubeadm.Scheduler
    kubeadm.Scheduler = ladder
    # every stop and restart of an API server fails the open list+watch
    # cycles of its reflectors, each logged with its traceback; they
    # relist, and (b) times that
    quiet = logging.getLogger("kubernetes_tpu_torch.client.reflector")
    level = quiet.level
    quiet.setLevel(logging.CRITICAL)
    # the phases before leave their objects on the heap, and every full
    # collection walks them: phase 24 ran 2.5x slower after them than
    # alone on a like H100 host (PERF.md section 6). Frozen, they are
    # left out of every collection until the phase ends.
    t0 = time.monotonic()
    gc.collect()
    gc.freeze()
    log(f"[kubeadm] {gc.get_freeze_count()} objects frozen in "
        f"{time.monotonic() - t0:.3f} s; {threading.active_count()} threads "
        "alive")
    try:
        a = kubeadm_cli(kubeadm)
        ladder.check("kubeadm (a)")
        log(f"[kubeadm] (a) init --once --secure on {a['device']}: torch "
            f"preflight passed; {a['ready_s']:.3f} s from the Cluster's "
            f"construction to ready, {a['seconds']:.3f} s in all; "
            f"{a['line'].strip()!r}")
        t0 = time.monotonic()
        with GcWatch() as gcw:
            b = kubeadm_secure_b(torch, mods, lbl, kubeadm, filters)
        ladder.check("kubeadm (b)")
        t_b = time.monotonic() - t0
        beats = b["beats"]
        log(f"[kubeadm] (b) {b['bound']} pods bound within their nodes, "
            f"web pods by zone {b['zones']}; {b['waves']} per-wave "
            f"dispatches on {b['path']}, {b['launches']} taint/port "
            f"launches; zone tallies {b['tally']}; no store trip; "
            f"{len(beats)} heartbeat slices of about "
            f"{FULL_NODES // KUBEADM_HB_SLICES} nodes, "
            f"{statistics.mean(beats):.3f} s mean, {max(beats):.3f} s max "
            f"(every node once in {KUBEADM_HB_PERIOD:.0f} s when they keep "
            f"up; monitor grace {KUBEADM_GRACE_S:.0f} s); {gcw.count} full "
            f"collections, {gcw.seconds:.3f} s; phase (b) {t_b:.1f} s")
        err = check_captured(torch, tp, "kubeadm", b.pop("captured"))
        got = {}
        for device in ("cuda", "cpu"):
            t0 = time.monotonic()
            got[device] = kubeadm_sync_run(mods, lbl, kubeadm, device)
            log(f"[kubeadm] (c) {SMALL_NODES} nodes on {device}: "
                f"{len(got[device])} web pods bound in "
                f"{time.monotonic() - t0:.3f} s")
        ladder.check("kubeadm (c)")
        if got["cuda"] != got["cpu"]:
            diff = [i for i, (x, y) in enumerate(zip(got["cuda"],
                                                    got["cpu"])) if x != y]
            fail(f"kubeadm: (c) card and CPU bind {len(diff)} pods apart, "
                 f"e.g. creation index {diff[:5]}")
        log(f"[kubeadm] (c) {KUBEADM_SMALL_PODS} + "
            f"{KUBEADM_SMALL_SCALE - KUBEADM_SMALL_PODS} web pods, a live "
            "upgrade between: card == CPU pod by pod in creation order")
    finally:
        kubeadm.Scheduler = real
        quiet.setLevel(level)
        gc.unfreeze()
    launches = b["launches"]
    whatif_launches = pre.preempt_whatif.launches
    log(f"[kubeadm] taint/port launches {launches}, what-if "
        f"{whatif_launches}; phase {time.monotonic() - t_phase:.1f} s")
    return dict(launches=launches, whatif_launches=whatif_launches,
                max_err=err)


def main() -> None:
    if not (REPO / "kubernetes_tpu_torch" / "__init__.py").is_file():
        fail("the kubernetes_tpu_torch package is not beside chip_smoke.py")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA card")
    sys.path.insert(0, str(REPO))
    from kubernetes_tpu_torch.api import labels as lbl
    from kubernetes_tpu_torch.api import types as api
    from kubernetes_tpu_torch.cloud.provider import (FakeCloud,
                                                     node_from_template)
    from kubernetes_tpu_torch.controllers import ClusterAutoscaler
    from kubernetes_tpu_torch.controllers import nodelifecycle as nl_mod
    from kubernetes_tpu_torch.ops import affinity
    from kubernetes_tpu_torch.ops import encoding as enc
    from kubernetes_tpu_torch.ops import filters
    from kubernetes_tpu_torch.ops import hostwave
    from kubernetes_tpu_torch.ops import kernel as kernel_mod
    from kubernetes_tpu_torch.ops import preempt as pre
    from kubernetes_tpu_torch.ops import simulate
    from kubernetes_tpu_torch.ops import taint_ports as tp
    from kubernetes_tpu_torch.ops import telemetry as tele
    from kubernetes_tpu_torch.ops import topology
    from kubernetes_tpu_torch.ops import zonehealth
    from kubernetes_tpu_torch.ops.scores import SCORE_STACK
    from kubernetes_tpu_torch.plugins.registry import Registry
    from kubernetes_tpu_torch.runtime import store as store_mod
    from kubernetes_tpu_torch.sched import scheduler as sched_mod
    from kubernetes_tpu_torch.sched import weights as weights_mod
    from kubernetes_tpu_torch.sched.scheduler import Scheduler
    from kubernetes_tpu_torch.state import featurize as featurize_mod
    from kubernetes_tpu_torch.state.vocab import bucket_size
    from kubernetes_tpu_torch.utils.backoff import PodBackoff
    from kubernetes_tpu_torch.utils.feature_gates import FeatureGates
    from kubernetes_tpu_torch.utils import faultpoints, tracing
    from kubernetes_tpu_torch.utils.metrics import Metrics

    # every Scheduler the phases build, held to no use of the fault
    # ladder after each healthy phase (4-16), and to no store trip and an
    # empty spool after each of phases 4-18
    ladder = Ladder(Scheduler)
    Scheduler = ladder
    mods = (api, tp, pre, kernel_mod, sched_mod, Scheduler)
    phase_mods = mods + (PodBackoff, store_mod)
    t_start = time.monotonic()
    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {kind} x{torch.cuda.device_count()}")

    # 2. build: one nvcc for each source, started together
    import threading

    errors = []

    def build(mod):
        try:
            mod.build()
        except Exception as e:  # reported below, and the run fails
            errors.append(f"{mod.SOURCE.name}: {e}")

    t_build = time.monotonic()
    threads = [threading.Thread(target=build, args=(m,)) for m in (tp, pre)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        fail("kernel build failed: " + "; ".join(errors))
    log(f"[build] both kernels in {time.monotonic() - t_build:.2f} s")
    for mod in (tp, pre):
        log(f"[build] {mod.build_info['library']} in "
            f"{mod.build_info['seconds']:.2f} s")
        for line in mod.build_info["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build]   {line.strip()}")

    # 3. kernel against its plain version at the main path's shapes and
    # at its edges
    int_rate, sms, mhz = int_ops_per_s(torch)
    log(f"[kernel] integer rate {int_rate / 1e12:.3f} T ops/s = {sms} SMs x "
        f"{INT32_LANES_PER_SM} INT32 lanes x {mhz:.0f} MHz (clocks.max.sm)")
    n_bucket = bucket_size(FULL_NODES)
    round_rows = WAVE * 128  # PIPELINE_MAX_WAVES waves of WAVE pods
    effects_all = {"noschedule+noexecute": tp.DEFAULT_EFFECTS,
                   "noexecute": (enc.EFFECT_NO_EXECUTE,)}
    max_err = 0
    cases = [(WAVE, FULL_NODES, {}), (GANG_P, n_bucket, {}),
             (round_rows, FULL_NODES, {}),
             (round_rows - 37, FULL_NODES + 3, {}), (round_rows, n_bucket, {}),
             (1000, FULL_NODES, dict(tolerations="none")),
             (1000, FULL_NODES, dict(tolerations="all", TL=8, PQ=8,
                                     port_rate=0.9)),
             (1000, FULL_NODES, dict(port_rate=0.0))]
    cases += [(P, N, kw) for P, N, kw in tp.EDGE_TABLES]
    for k, (P, N, kw) in enumerate(cases):
        nt, pb = tp.random_tables(P, N, SEED + k, **kw)
        for ename, eff in effects_all.items():
            max_err = max(max_err, check_kernel(
                torch, tp, nt, pb, eff, f"P={P}, N={N}, {kw}, {ename}"))
        plan = tp.launch_plan(nt, pb)
        log(f"[kernel] P={P} N={N} {kw or ''}: kernel == plain (both effect "
            f"sets; grid {plan['grid']}, block {plan['block']})")
    # the round's shape three ways: dense tolerations and ports (the most
    # compare work), no toleration and no port (the store path alone),
    # and a plain fill of the same two outputs (the card's write rate)
    for name, kw in (("dense", {}),
                     ("store-only", dict(tolerations="none", port_rate=0.0))):
        nt, pb = tp.random_tables(round_rows, n_bucket, SEED, **kw)
        ms = cuda_ms(torch, lambda: tp.taint_ports_masks(nt, pb))
        b_ms, b_by, nbytes, nops = kernel_bound(nt, pb, tp.DEFAULT_EFFECTS,
                                                int_rate)
        log(f"[kernel] {name} random world P={round_rows} N={n_bucket}: "
            f"kernel {ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: {nbytes} B, "
            f"{nops} ops)")
    outs = [torch.empty((round_rows, n_bucket), dtype=torch.bool,
                        device="cuda") for _ in range(2)]
    fill_ms = cuda_ms(torch, lambda: [o.fill_(True) for o in outs])
    log(f"[kernel] fill of the two [{round_rows}, {n_bucket}] outputs: "
        f"{fill_ms:.4f} ms = {2 * round_rows * n_bucket / fill_ms / 1e9:.3f} "
        "TB/s")
    del nt, pb, outs
    # the what-if kernel against its plain version on a CPU copy, at its
    # edges and at the drains' widths
    whatif_err = 0
    for P, N, M, kw in pre.EDGE_WORLDS + (
            (WAVE, n_bucket, 32768, dict(large=True)),
            (GANG_P, n_bucket, 65536, {})):
        w = pre.random_whatif(P, N, M, seed=SEED + P + N, **kw)
        whatif_err = max(whatif_err, check_whatif(
            torch, pre, w, f"P={P}, N={N}, M={M}, {kw}"))
        log(f"[kernel] what-if P={P} N={N} M={M} {kw or ''}: kernel == "
            "plain on the CPU")
    P, N, M, kw = next(e for e in pre.EDGE_WORLDS if e[3].get("dense"))
    w = pre.random_whatif(P, N, M, seed=SEED + P + N, **kw)
    time_whatif(torch, pre, w, int_rate, "kernel", "the dense edge world")
    del w

    # 4. the density drain at full size
    store, n_bound = build_store(api, store_mod, FULL_NODES, DENSITY_PODS,
                                 SEED)
    caps = scheduler_caps(enc, bucket_size, FULL_NODES, DENSITY_PODS, n_bound)
    dens = drain(torch, mods, "density", store, caps, n_bound)
    if dens["placed"] < DENSITY_PODS // 2:
        fail(f"density: only {dens['placed']} of {DENSITY_PODS} pods placed")
    ladder.check("density")
    del store

    # the kernel and its plain version on the inputs the rounds gave it;
    # the first round's (the full round) are timed
    captured = dens.pop("captured")
    max_err = max(max_err, check_captured(torch, tp, "density", captured))
    nt, pb = next(iter(captured.values()))
    k_ms = cuda_ms(torch, lambda: tp.taint_ports_masks(nt, pb))
    p_ms = cuda_ms(torch, lambda: tp.taint_ports_plain(nt, pb), reps=3,
                   runs=3)
    k_ms2 = cuda_ms(torch, lambda: tp.taint_ports_masks(nt, pb))
    bound_ms, bound_by, nbytes, nops = kernel_bound(nt, pb,
                                                     tp.DEFAULT_EFFECTS,
                                                     int_rate)
    P, N = pb.tol_key.shape[0], nt.taint_key.shape[0]
    dims = (nt.taint_key.shape[1], pb.tol_key.shape[1], nt.ports.shape[1],
            pb.ports.shape[1])
    plan = tp.launch_plan(nt, pb)
    log(f"[kernel] round inputs (T, TL, PP, PQ) = {dims}: grid "
        f"{plan['grid']} blocks of {plan['block']} threads, "
        f"{plan['shared_bytes']} B of shared memory a block, "
        f"{plan['blocks_per_sm']} blocks an SM")
    log(f"[kernel] round inputs P={P} N={N}: kernel == plain; kernel "
        f"{k_ms:.4f} / {k_ms2:.4f} ms, plain {p_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}: {nbytes} B, {nops} ops), "
        f"{bound_ms / k_ms:.1%} of bound; no single PyTorch call computes "
        "this function, so no library time")
    del nt, pb, captured
    torch.cuda.empty_cache()

    # 5. card against CPU on reduced worlds of the three shapes
    worlds = {  # name -> (store maker, anti-affinity pods)
        "density": (lambda: build_store(api, store_mod, SMALL_NODES,
                                        SMALL_PODS, SEED), 0),
        "mixed": (lambda: build_mixed(api, lbl, store_mod, SMALL_NODES,
                                      SMALL_PODS),
                  SMALL_PODS - 3 * (SMALL_PODS // 4)),
        "spread": (lambda: build_spread(api, lbl, store_mod, SMALL_NODES,
                                        SMALL_PODS, SPREAD_APPS), 0),
    }
    for wname, (build, n_terms) in worlds.items():
        got = {}
        for device in ("cuda", "cpu"):
            store, n_bound = build()
            caps = scheduler_caps(enc, bucket_size, SMALL_NODES, SMALL_PODS,
                                  n_bound, n_terms)
            s = Scheduler(store, wave_size=WAVE, caps=caps, device=device)
            t0 = time.monotonic()
            n = s.schedule_pending()
            check_bindings(api, store)
            check_anti_affinity(store)
            got[device] = bindings(store)
            log(f"[parity] {wname} {device}: placed {n} in "
                f"{time.monotonic() - t0:.3f} s")
        if got["cuda"] != got["cpu"]:
            diff = [k for k in got["cpu"] if got["cpu"][k] != got["cuda"][k]]
            fail(f"{wname}: card and CPU bindings differ for {len(diff)} "
                 f"pods, e.g. {diff[:5]}")
        log(f"[parity] {wname}, {SMALL_NODES} nodes, {SMALL_PODS} pods: "
            "card == CPU bindings")
    for wname in ("preempt", "gangstorm"):
        got = {}
        for device in ("cuda", "cpu"):
            t0 = time.monotonic()
            got[device] = small_world(api, store_mod, enc, bucket_size,
                                      Scheduler, PodBackoff, wname, device)
            log(f"[parity] {wname} {device}: "
                f"{sum(1 for v in got[device][0].values() if v)} bound, "
                f"{got[device][1]} evicted in "
                f"{time.monotonic() - t0:.3f} s")
        if got["cuda"] != got["cpu"]:
            a, b = got["cuda"][0], got["cpu"][0]
            diff = sorted(k for k in set(a) | set(b) if a.get(k) != b.get(k))
            fail(f"{wname}: card and CPU differ (evicted {got['cuda'][1]} / "
                 f"{got['cpu'][1]}; pods {diff[:5]})")
        if not got["cuda"][1]:
            fail(f"{wname}: nothing was evicted")
        log(f"[parity] {wname}: card == CPU bindings and victim sets")
    t_new = time.monotonic()
    got = {}
    for device in ("cuda", "cpu"):
        t0 = time.monotonic()
        got[device] = multikey_world(api, lbl, store_mod, enc, bucket_size,
                                     Scheduler, device)
        _, n_host, host_s, resident = got[device]
        log(f"[parity] multikey {device}: {n_host} host-path passes in "
            f"{host_s:.3f} s = {host_s / max(n_host, 1):.3f} s a pass, "
            f"{resident} bound pods on {SMALL_NODES} nodes; world "
            f"{time.monotonic() - t0:.3f} s")
    if got["cuda"][0] != got["cpu"][0]:
        a, b = got["cuda"][0], got["cpu"][0]
        diff = sorted(k for k in set(a) | set(b) if a.get(k) != b.get(k))
        fail(f"multikey: card and CPU bindings differ, e.g. {diff[:5]}")
    log(f"[parity] multikey, {SMALL_NODES} nodes, {SMALL_PODS} density pods "
        f"then {MULTIKEY_PODS} pods and a gang of {MULTIKEY_GANG} with "
        "required pod affinity over zone and host: card == CPU bindings, "
        "every multi-key pod bound where both terms hold")
    t_new = time.monotonic() - t_new
    t_vol = time.monotonic()
    for ecache in (False, True):
        got = {}
        for device in ("cuda", "cpu"):
            t0 = time.monotonic()
            got[device] = volume_world(phase_mods, enc, bucket_size, lbl,
                                       FeatureGates, device, ecache)
            b, claims, msgs, ec, mask_s, n = got[device]
            log(f"[parity] volumes {device}, equivalence cache "
                f"{'on' if ecache else 'off'}: placed {n}, "
                f"{sum(1 for v in claims.values() if v)} claims bound, "
                f"host mask {mask_s:.3f} s, ecache (hits, misses) {ec}; "
                f"world {time.monotonic() - t0:.3f} s")
        for i, what in enumerate(("bindings", "claims", "PodScheduled "
                                  "messages", "ecache counts")):
            if got["cuda"][i] != got["cpu"][i]:
                a, b = got["cuda"][i], got["cpu"][i]
                diff = (sorted(k for k in set(a) | set(b)
                               if a.get(k) != b.get(k))
                        if isinstance(a, dict) else (a, b))
                fail(f"volumes: card and CPU {what} differ, e.g. "
                     f"{diff[:5]}")
        msgs = got["cuda"][2].values()
        for reason in ("exceed max volume count",
                       "didn't find available persistent volumes"):
            if not any(m and reason in m for m in msgs):
                fail(f"volumes: no FitError says {reason!r}")
        if not ecache:
            vol_off = got["cuda"][:3]
        elif got["cuda"][:3] != vol_off:
            fail("volumes: the equivalence cache changed the result")
    log(f"[parity] volumes, {SMALL_NODES} nodes, {SMALL_PODS} pods, "
        "equivalence cache off and on: card == CPU bindings, claim "
        "bindings and PodScheduled messages, and the cache changes none")
    got = {}
    for device in ("cuda", "cpu"):
        t0 = time.monotonic()
        got[device] = policy_world(phase_mods, enc, bucket_size, Registry,
                                   device)
        log(f"[parity] policy {device}: placed {got[device][1]} in "
            f"{got[device][2]} per-wave dispatches; world "
            f"{time.monotonic() - t0:.3f} s")
    if got["cuda"] != got["cpu"]:
        a, b = got["cuda"][0], got["cpu"][0]
        diff = sorted(k for k in set(a) | set(b) if a.get(k) != b.get(k))
        fail(f"policy: card and CPU bindings differ, e.g. {diff[:5]}")
    log(f"[parity] policy, {SMALL_NODES} nodes, {SMALL_PODS} pods: card == "
        "CPU bindings")
    t_vol = time.monotonic() - t_vol
    ladder.check("parity")

    # 6. the mixed5k drain at full width
    store, n_bound = build_mixed(api, lbl, store_mod, FULL_NODES, FULL_PODS)
    caps = scheduler_caps(enc, bucket_size, FULL_NODES, FULL_PODS, n_bound,
                          FULL_PODS - 3 * (FULL_PODS // 4))
    mixed = drain(torch, mods, "mixed", store, caps, n_bound,
                  statics="incoming_statics", sync_probe=True)
    ladder.check("mixed")
    if mixed["placed"] != FULL_PODS:
        fail(f"mixed: placed {mixed['placed']} of {FULL_PODS} pods")
    n_anti = check_anti_affinity(store)
    log(f"[mixed] {n_anti} anti-affinity pods: no two of one group share "
        "a node")
    rounds = mixed["rounds"]
    if not any(r["has_ipa"] for r in rounds):
        fail("mixed: no round ran with inter-pod affinity")
    if max(r["W"] for r in rounds) > IPA_MAX_WAVES:
        fail(f"mixed: a round ran more than {IPA_MAX_WAVES} waves")
    ms = per_pod_ms(rounds, "has_ipa")
    syncs = mixed["syncs"]
    log(f"[mixed] device_round ms per pod: with ipa {ms[True]:.3f}, without "
        f"{ms[False]:.3f}; implicit host syncs in the first ipa round: "
        f"{sum(syncs.values())} (" + ", ".join(
            f"{k} x{v}" for k, v in sorted(syncs.items())) + ")")
    time_statics(torch, "mixed", affinity.incoming_statics,
                 mixed.pop("statics_args"), rounds, "has_ipa")
    max_err = max(max_err, check_captured(torch, tp, "mixed",
                                          mixed.pop("captured")))
    del store
    torch.cuda.empty_cache()

    # 7. the spread drain
    store, n_bound = build_spread(api, lbl, store_mod, FULL_NODES,
                                  SPREAD_PODS, SPREAD_APPS)
    caps = scheduler_caps(enc, bucket_size, FULL_NODES, SPREAD_PODS,
                          n_bound)
    spread = drain(torch, mods, "spread", store, caps, n_bound,
                   statics="topo_statics")
    ladder.check("spread")
    if spread["placed"] != SPREAD_PODS:
        fail(f"spread: placed {spread['placed']} of {SPREAD_PODS} pods")
    counts = zone_counts(store)
    worst = max(max(c.values()) - min(c.values()) for c in counts.values())
    if worst > 1 or len(counts) != SPREAD_APPS:
        fail(f"spread: a Deployment's zone counts differ by {worst}")
    log(f"[spread] {len(counts)} Deployments: zone counts differ by at most "
        f"{worst}")
    if not all(r["has_ts"] for r in spread["rounds"]):
        fail("spread: a round ran without topology spread")
    ms = per_pod_ms(spread["rounds"], "has_ts")
    log(f"[spread] device_round ms per pod with ts {ms[True]:.3f}")
    time_statics(torch, "spread", topology.topo_statics,
                 spread.pop("statics_args"), spread["rounds"], "has_ts")
    max_err = max(max_err, check_captured(torch, tp, "spread",
                                          spread.pop("captured")))
    del store
    torch.cuda.empty_cache()

    # 8. the gangstorm drain
    gang = gang_phase(torch, phase_mods, enc, bucket_size)
    ladder.check("gang")
    captured = gang.pop("captured")
    for P, w in sorted(captured.items()):
        whatif_err = max(whatif_err, check_whatif(
            torch, pre, w, f"gang drain input, P={P}"))
        log(f"[gang] what-if kernel == plain on the drain's input P={P} "
            f"N={w.static_ok.shape[1]} M={w.ep_node.shape[0]}")
    time_whatif(torch, pre, captured[max(captured)], int_rate, "gang",
                "the drain's chunk")
    del captured
    torch.cuda.empty_cache()

    # 9. the preempt drain
    prem = preempt_phase(torch, phase_mods, enc, bucket_size)
    ladder.check("preempt")
    captured = prem.pop("captured")
    for P, w in sorted(captured.items()):
        whatif_err = max(whatif_err, check_whatif(
            torch, pre, w, f"preempt drain input, P={P}"))
        log(f"[preempt] what-if kernel == plain on the drain's input P={P}")
    w = captured[max(captured)]
    w_ms, w_kernels_ms, w_bound, w_by = time_whatif(
        torch, pre, w, int_rate, "preempt", "the drain's chunk")
    cpu_w = pre.WhatIf(*[None if t is None else t.cpu() for t in w])
    t0 = time.monotonic()
    pre.whatif_plain(cpu_w)
    w_plain_ms = 1e3 * (time.monotonic() - t0)
    log(f"[preempt] what-if plain version on the CPU {w_plain_ms:.1f} ms; "
        "no single PyTorch call computes this function, so no library "
        "time")
    del w, cpu_w, captured
    torch.cuda.empty_cache()

    # 10-12. the rest of bench.py's DRIVER_SUITE
    t0 = time.monotonic()
    trickle = trickle_phase(torch, phase_mods, enc, bucket_size, Metrics)
    ladder.check("trickle")
    paced = paced_phase(torch, phase_mods, enc, bucket_size, Metrics)
    ladder.check("paced")
    phost = preempt_host_phase(torch, phase_mods, enc, bucket_size, Metrics)
    ladder.check("preempt_host")
    t_new += time.monotonic() - t0

    # 13. StatefulSets with claims beside density pods
    t0 = time.monotonic()
    ss = statefulset_phase(torch, phase_mods, enc, bucket_size, lbl, filters,
                           FeatureGates,
                           WAVE * per_pod_ms(dens["rounds"], "has_ipa")[False]
                           / 1e3)
    max_err = max(max_err, ss.pop("max_err"))
    ladder.check("statefulset")
    t_vol += time.monotonic() - t0

    # 14. the flight recorder and the decision observatory
    t0 = time.monotonic()
    traced = traced_phase(torch, phase_mods, enc, bucket_size, filters, tele,
                          tracing, weights_mod, SCORE_STACK)
    max_err = max(max_err, traced.pop("max_err"))
    ledgered = {k: traced.pop(k)
                for k in ("ledger", "untraced", "untraced_pods_s")}
    ladder.check("traced")
    t_traced = time.monotonic() - t0

    # 15-16. the cluster-lifecycle controllers
    t0 = time.monotonic()
    ctl = (ClusterAutoscaler, FakeCloud, node_from_template, simulate)
    auto = autoscale_phase(torch, phase_mods, enc, bucket_size, ctl)
    ladder.check("autoscale")
    outage = zone_outage_phase(torch, phase_mods, enc, bucket_size,
                               (nl_mod, zonehealth))
    ladder.check("zone_outage")
    t_ctl = time.monotonic() - t0

    # 17. the device-fault ladder
    t0 = time.monotonic()
    faults = faults_phase(torch, phase_mods, enc, bucket_size, lbl, ctl,
                          hostwave, faultpoints, featurize_mod)
    ladder.check_capacity("faults")
    ladder.check_store("faults")
    t_faults = time.monotonic() - t0

    # 18. the memory plane and load shedding
    t0 = time.monotonic()
    memory = memory_phase(torch, phase_mods, enc, bucket_size, faultpoints)
    ladder.check_store("memory")
    t_memory = time.monotonic() - t0

    # 19. the store plane
    t0 = time.monotonic()
    store_out = store_phase(torch, phase_mods, enc, bucket_size, faultpoints)
    ladder.check("store_outage", store=False)
    t_store = time.monotonic() - t0

    # 20. HTTP extenders
    t0 = time.monotonic()
    extender = extender_phase(torch, phase_mods, enc, bucket_size, Registry)
    ladder.check("extender")
    t_ext = time.monotonic() - t0

    # 21. the deployed kube-scheduler
    t0 = time.monotonic()
    deployed = deployed_phase(torch, phase_mods, filters, tracing, ladder)
    max_err = max(max_err, deployed.pop("max_err"))
    t_deployed = time.monotonic() - t0

    # 22. the autopilot and the invariant checker
    t0 = time.monotonic()
    autopilot = autopilot_phase(torch, phase_mods, enc, bucket_size, filters,
                                tracing, weights_mod, SCORE_STACK, ladder,
                                ledgered)
    max_err = max(max_err, autopilot.pop("max_err"))
    ladder.check("autopilot")
    t_autopilot = time.monotonic() - t0

    # 23. the chaos campaign and the kubemark hollow cluster
    t0 = time.monotonic()
    chaos = chaos_phase(torch, phase_mods, enc, bucket_size, filters,
                        faultpoints)
    max_err = max(max_err, chaos.pop("max_err"))
    ladder.check("chaos")
    t_chaos = time.monotonic() - t0

    # 24. kubeadm on the in-memory store
    t0 = time.monotonic()
    kubeadm_out = kubeadm_phase(torch, phase_mods, lbl, filters, ladder)
    max_err = max(max_err, kubeadm_out.pop("max_err"))
    t_kubeadm = time.monotonic() - t0
    drains = {"density": dens, "mixed": mixed, "spread": spread,
              "gang": gang, "preempt": prem, "trickle": trickle,
              "paced": paced, "preempt_host": phost, "statefulset": ss,
              "traced": traced, "autoscale": auto, "zone_outage": outage,
              "faults": faults, "memory": memory,
              "store_outage": store_out, "extender": extender,
              "deployed": deployed, "autopilot": autopilot, "chaos": chaos,
              "kubeadm": kubeadm_out}
    launches = sum(d["launches"] for d in drains.values())
    whatif_launches = sum(d["whatif_launches"] for d in drains.values())
    log("[smoke] taint/port kernel launches: " + ", ".join(
        f"{k} {d['launches']}" for k, d in drains.items())
        + "; what-if kernel launches: " + ", ".join(
        f"{k} {d['whatif_launches']}" for k, d in drains.items())
        + f"; phases multikey, trickle, paced and preempt_host "
        f"{t_new:.1f} s; volumes, policy and statefulset {t_vol:.1f} s; "
        f"traced {t_traced:.1f} s; autoscale and zone_outage {t_ctl:.1f} s; "
        f"faults {t_faults:.1f} s; memory {t_memory:.1f} s; store_outage "
        f"{t_store:.1f} s; extender {t_ext:.1f} s; deployed "
        f"{t_deployed:.1f} s; autopilot {t_autopilot:.1f} s; chaos "
        f"{t_chaos:.1f} s; kubeadm {t_kubeadm:.1f} s; total "
        f"{time.monotonic() - t_start:.1f} s")

    print(json.dumps({"kernels": [{
        "name": "taint_ports_masks",
        "route": "cuda",
        "source": "kubernetes_tpu_torch/csrc/taint_ports.cu",
        "replaces": "kubernetes_tpu/ops/pallas_kernels.py:41",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }, {
        "name": "preempt_whatif",
        "route": "cuda",
        "source": "kubernetes_tpu_torch/csrc/preempt_whatif.cu",
        "replaces": "kubernetes_tpu/ops/preempt.py:85",
        "launches": whatif_launches,
        "max_abs_err": whatif_err,
        "ms": w_ms,
        "kernels_ms": w_kernels_ms,
        "plain_ms": w_plain_ms,
        "bound_ms": w_bound,
        "bound_by": w_by,
        "library_ms": None,
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
