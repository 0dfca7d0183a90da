"""Fault-tolerance drill on the PyTorch / CUDA port: worker death,
supervisor failover, checkpoint resume, straggler cloning — the paper's
availability story end to end (the twin of
``examples/fault_tolerance_demo.py``).

    PYTHONPATH=src python examples/torch_fault_tolerance_demo.py
    PYTHONPATH=src python examples/torch_fault_tolerance_demo.py --device cpu
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import torch  # noqa: E402

from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig  # noqa: E402
from repro_torch.flags import device_claims  # noqa: E402
from repro_torch.runtime.executor import TrainExecutor  # noqa: E402
from repro_torch.runtime.fault import HeartbeatMonitor  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = smoke_config("qwen2-0.5b")
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d, async_write=False)
        with device_claims(args.device != "cpu"):
            ex = TrainExecutor(cfg, num_workers=3, checkpointer=ck,
                               checkpoint_every=6,
                               data_cfg=DataConfig(vocab_size=cfg.vocab_size,
                                                   seq_len=32, batch_size=4),
                               device=args.device)
        mon = HeartbeatMonitor(ex.wq, timeout_s=5.0, now=0.0)  # noqa: F841
        ex.submit_steps(18)
        print("18 tasks, 3 workers, checkpoint every 6 steps")

        for i in range(4):
            ex.tick()
        print(f"[t=4] progress: {ex.wq.counts()['FINISHED']} finished")

        n = ex.fail_worker(1)
        print(f"[t=4] WORKER 1 DIES -> {n} RUNNING tasks requeued+rehashed")
        ex.promote_secondary()
        print("[t=4] SUPERVISOR DIES -> secondary promoted "
              f"(generation {ex.supervisor.state.generation})")

        ex.run()
        ck.save(ex.step, ex.state, ex.wq)
        print(f"[done] finished={ex.wq.counts()['FINISHED']}; "
              f"fail_trials recorded: "
              f"{int(ex.wq.store.col('fail_trials').sum())}")

        # crash-restart: restore from the atomic checkpoint, into a template
        # of the state on the host (the reference's jax.device_get)
        template = {"params": ex.state["params"].to("cpu"),
                    "opt": torch.utils._pytree.tree_map(
                        lambda t: t.to("cpu"), ex.state["opt"])}
        step, state, wq = ck.restore(template)
        print(f"[restart] restored step {step}, store rows {wq.store.n_rows},"
              f" counts {wq.counts()}")
        assert wq.counts()["FINISHED"] == 18
        ex.close()


if __name__ == "__main__":
    main()
