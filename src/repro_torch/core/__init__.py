"""SchalaDB core, ported: the column store, txn log, work queue, steering
engine, supervisor, replication (wire, transport), the sharding router,
provenance and the centralized baseline, copied from the reference package
so that repro_torch imports nothing of it. Only the device paths (a
queue's claim through the ``wq_claim`` kernel, ``device_view``,
``SteeringEngine.device_monitor``) load torch, so a replica process,
which holds stores and never a tensor, runs without it."""
from repro_torch.core.schema import Status, wq_schema  # noqa: F401
from repro_torch.core.store import ColumnStore  # noqa: F401
from repro_torch.core.workqueue import WorkQueue  # noqa: F401
from repro_torch.core.supervisor import SecondarySupervisor, Supervisor  # noqa: F401
from repro_torch.core.steering import SteeringEngine  # noqa: F401
from repro_torch.core.replication import (DeltaReplicator,  # noqa: F401
                                          ReplicaGroup, ReplicaSet,
                                          ReplicationFabric,
                                          ShippedDeltaReplicator)
from repro_torch.core.sharding_router import Shard, ShardRouter  # noqa: F401
