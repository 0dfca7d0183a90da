"""SchalaDB core, ported: the column store, txn log, work queue and
steering engine, copied from the reference package so that repro_torch
imports nothing of it. Replication, wire, transport, sharding router and
supervisor come with later slices of the port."""
from repro_torch.core.schema import Status, wq_schema  # noqa: F401
from repro_torch.core.store import ColumnStore  # noqa: F401
from repro_torch.core.workqueue import WorkQueue  # noqa: F401
from repro_torch.core.steering import SteeringEngine  # noqa: F401
