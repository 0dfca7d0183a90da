"""W3C PROV-style provenance capture over the shared store.

The store already holds the provenance *relation* (task rows with
parent_task edges, domain inputs/outputs, timings, agents=workers); this
module materializes PROV-DM terms from it: Entity (data values / artifacts),
Activity (task executions), Agent (workers), and the used / wasGeneratedBy /
wasAssociatedWith / wasDerivedFrom relations. Matches the paper's claim that
WQ data *is* provenance data — written once, queried at runtime.

Document construction is column-oriented: the occupied/finished/derived row
sets come from vectorized masks, per-agent association counts from ONE
bincount segment reduction over worker ids (the same reduction shape as the
steering engine's Q1), and the per-row dictionaries are built from
pre-gathered arrays — no per-row column access, no per-worker re-masking.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Iterator, List

import numpy as np

from repro_torch.core.schema import Status
from repro_torch.core.workqueue import WorkQueue


def prov_document(wq: WorkQueue, workflow_name: str = "workflow"
                  ) -> Dict[str, Any]:
    store = wq.store
    st = store.col("status")
    doc: Dict[str, Any] = {
        "prefix": {"repro": "urn:repro:", "prov": "http://www.w3.org/ns/prov#"},
        "activity": {}, "entity": {}, "agent": {},
        "used": [], "wasGeneratedBy": [], "wasAssociatedWith": [],
        "wasDerivedFrom": [],
    }
    tid = store.col("task_id")
    act = store.col("activity_id")
    wid = store.col("worker_id")
    t0 = store.col("start_time")
    t1 = store.col("end_time")
    parent = store.col("parent_task")
    ins = np.stack([store.col(f"in{j}") for j in range(3)], axis=1)
    outs = np.stack([store.col(f"out{j}") for j in range(3)], axis=1)

    occ = np.nonzero(st != int(Status.EMPTY))[0]
    # agents + association counts in one segment reduction over worker ids
    # (Q1-style bincount: no per-worker pass, idle workers read count 0)
    rw = wid[occ]
    assoc = np.bincount(rw[rw >= 0].astype(np.int64),
                        minlength=wq.num_workers) if occ.size \
        else np.zeros(wq.num_workers, np.int64)
    for w, c in enumerate(assoc):
        doc["agent"][f"repro:worker_{w}"] = {
            "prov:type": "prov:SoftwareAgent",
            "repro:tasksAssociated": int(c),
        }

    fin = st[occ] == int(Status.FINISHED)
    for i, a_name in zip(occ, (f"repro:task_{t}" for t in tid[occ])):
        doc["activity"][a_name] = {
            "prov:type": f"repro:activity_{act[i]}",
            "prov:startTime": None if np.isnan(t0[i]) else float(t0[i]),
            "prov:endTime": None if np.isnan(t1[i]) else float(t1[i]),
            "repro:status": Status(int(st[i])).name,
        }
        ein = f"repro:input_{tid[i]}"
        doc["entity"][ein] = {
            f"repro:in{j}": float(ins[i, j]) for j in range(3)
            if not np.isnan(ins[i, j])}
        doc["used"].append({"prov:activity": a_name, "prov:entity": ein})
        doc["wasAssociatedWith"].append(
            {"prov:activity": a_name, "prov:agent": f"repro:worker_{wid[i]}"})
    for i in occ[fin]:
        a_name = f"repro:task_{tid[i]}"
        eout = f"repro:output_{tid[i]}"
        doc["entity"][eout] = {
            f"repro:out{j}": float(outs[i, j]) for j in range(3)
            if not np.isnan(outs[i, j])}
        doc["wasGeneratedBy"].append(
            {"prov:entity": eout, "prov:activity": a_name})
        if parent[i] >= 0:
            doc["wasDerivedFrom"].append(
                {"prov:generatedEntity": eout,
                 "prov:usedEntity": f"repro:output_{parent[i]}"})
    return doc


def export_provenance(wq: WorkQueue, path: str,
                      workflow_name: str = "workflow") -> None:
    with open(path, "w") as f:
        json.dump(prov_document(wq, workflow_name), f, indent=1)


def derivation_path(wq: WorkQueue, task_id: int) -> List[int]:
    """Walk wasDerivedFrom edges back to the source activity."""
    store = wq.store
    parent = store.col("parent_task")
    id_to_row = store.id_index()          # cached task_id -> row gather table

    def row_of(t: int) -> int:
        return int(id_to_row[t]) if 0 <= t < id_to_row.shape[0] else -1

    path = [task_id]
    row = row_of(task_id)
    while row >= 0 and parent[row] >= 0:
        path.append(int(parent[row]))
        row = row_of(int(parent[row]))
    return path
