"""The stream-chaos soak of ``benchmarks/stream_chaos_bench.py`` on the
PyTorch port, with no JAX: ``tests/test_torch_streaming.py`` holds it to
the JAX package's soak on the CPU, ``tests/test_torch_cuda.py`` holds the
card's run to the CPU's.

3 tenants at weights 1:3:4 kept backlogged, ``micro_batch = 8 x 64``, a
carry of 64 rows a rank, 34 steps then a drain, the four-fault schedule
(``lose_batch@4``, ``lose_device@10``, ``kill_slave@16``,
``rejoin_slave@24``, seed 7), and a Sector deployment (4 slaves,
replication 2) with a ``FailureDetector`` and a ``ReplicationDaemon`` on a
virtual clock of 1.0 a step.
"""

import collections
import tempfile

import numpy as np
import torch

from repro_torch.comm import Ranks
from repro_torch.core.mapreduce import default_hash, reduce_by_key_sum
from repro_torch.core.retry import RetryPolicy
from repro_torch.launch.train import make_sector
from repro_torch.sector.master import FailureDetector, ReplicationDaemon
from repro_torch.sphere.chaos import ChaosSchedule, FaultPlan
from repro_torch.sphere.dataflow import Dataflow, SPMDExecutor
from repro_torch.sphere.streaming import QueueFull, StreamExecutor, TenantQueue

NB = 8
VOCAB = 64
WEIGHTS = {"free": 1.0, "pro": 3.0, "enterprise": 4.0}
DEPTH_TARGET = 12
STEPS = 34


def stream_wordcount(algo=None):
    """map -> shuffle(default_hash, 8 buckets) -> reduce_by_key_sum (its
    sort pinned to ``algo``; None lets the autotuner choose)."""
    def emit(rec):
        return {"key": rec["word"].to(torch.int32),
                "value": torch.ones_like(rec["word"], dtype=torch.int32)}

    def count(rec, valid):
        k, v, dropped = reduce_by_key_sum(rec["key"], rec["value"], valid,
                                          algo=algo)
        return {"key": k, "value": v}, k >= 0, dropped

    return (Dataflow.stream_source().map(emit)
            .shuffle(by=lambda r: default_hash(r["key"], NB),
                     num_buckets=NB)
            .reduce(count))


def pairs(rec):
    return sorted([int(k), int(v)] for k, v in zip(rec["key"], rec["value"]))


def port_soak(chaos: bool, device="cpu", algo=None):
    """One soak on ``Ranks(8, device=device)``, the reduce's sort pinned to
    ``algo``; returns its counters, the events log and the final snapshot
    as sorted (word, count) pairs."""
    micro_batch = 64 * 8
    cost = micro_batch // 8
    queue = TenantQueue(
        quantum=float(cost), capacity=DEPTH_TARGET, max_requeues=5,
        retry_policy=RetryPolicy(base=0.25, cap=2.0, jitter=0.1, seed=3))
    for name, w in WEIGHTS.items():
        queue.register(name, weight=w)
    vclock = {"now": 0.0}
    schedule = ChaosSchedule([
        FaultPlan(kind="lose_batch", at_batch=4),
        FaultPlan(kind="lose_device", at_batch=10),
        FaultPlan(kind="kill_slave", at_batch=16),
        FaultPlan(kind="rejoin_slave", at_batch=24),
    ], seed=7) if chaos else None
    ex = StreamExecutor(
        SPMDExecutor(Ranks(8, device=device)), stream_wordcount(algo),
        micro_batch=micro_batch, carry_capacity=VOCAB, queue=queue,
        clock=lambda: vclock["now"], chaos=schedule)
    with tempfile.TemporaryDirectory() as root:
        master, client, _ = make_sector(root, num_slaves=4, replication=2)
        det = FailureDetector(master, suspect_after=0.5, down_after=1.5,
                              clock=lambda: vclock["now"])
        daemon = ReplicationDaemon(master, clock=lambda: vclock["now"],
                                   detector=det)
        ex.attach_sector(master, client, daemon=daemon, detector=det,
                         retain=8)
        rng = np.random.default_rng(0)
        delivered = collections.Counter()
        dropped = 0

        def top_up():
            for name in WEIGHTS:
                for _ in range(DEPTH_TARGET + 2):
                    try:
                        ex.submit({"word": rng.integers(
                            0, VOCAB, size=cost).astype(np.uint8)},
                            tenant=name)
                    except QueueFull:
                        break

        def record(batch):
            nonlocal dropped
            if batch is not None:
                dropped += batch.dropped
                for tk in batch.delivered:
                    delivered[tk.req_id] += 1

        for step in range(STEPS):
            vclock["now"] = float(step)
            top_up()
            record(ex.step())
        while queue.pending():
            vclock["now"] += 1.0
            record(ex.step())
        st = ex.stats()
        return {
            "steps": st["steps"], "records_in": st["records_in"],
            "batch_failures": st["batch_failures"],
            "recoveries": st["recoveries"], "cache": st["cache"],
            "faults_fired": schedule.fired_count if schedule else 0,
            "events": list(schedule.events) if schedule else [],
            "detector": dict(det.stats), "master": dict(master.stats),
            "requeues": sum(t["requeues"] for t in st["tenants"].values()),
            "failed": sum(t["failed"] for t in st["tenants"].values()),
            "max_deliveries_per_request": max(delivered.values()),
            "delivered_requests": len(delivered), "dropped": dropped,
            "end_devices": ex.inner.axis_size,
            "counts": pairs(ex.carry_state())}
