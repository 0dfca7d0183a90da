"""The MoE router's imbalance in the traced train window, from the port's
``moe.expert_load`` counters (one a layer and forward: the assignments by
expert): each record's largest expert load over its mean load, in %,
averaged over the records. 100 is a balanced router; the largest load
sets the grouped product's longest group."""

NAME = "moe.expert_load"


def read(obs):
    recs = [r for r in ((obs or {}).get("program") or {}).get("records", [])
            if r.name == NAME and getattr(r, "value", None)]
    got = [100.0 * max(r.value) * len(r.value) / sum(r.value)
           for r in recs if sum(r.value) > 0]
    return sum(got) / len(got) if got else None
