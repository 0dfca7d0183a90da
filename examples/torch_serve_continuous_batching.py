"""Serving on the PyTorch / CUDA port: the work queue drives continuous
batching (the twin of ``examples/serve_continuous_batching.py``).

Requests are WQ rows (the paper's tasks); decode slots claim requests from
their partitions as slots free up, token-by-token progress and outputs are
committed back to the store, and the steering engine provides live SLO
analytics over the same data. On the card the prompts prefill through the
flash kernel and every token decodes through the decode-attention kernel.

    PYTHONPATH=src python examples/torch_serve_continuous_batching.py
    PYTHONPATH=src python examples/torch_serve_continuous_batching.py --device cpu
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np  # noqa: E402

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.runtime.executor import ServeExecutor  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = smoke_config("qwen2-0.5b")
    ex = ServeExecutor(cfg, slots=3, max_len=64, device=args.device)
    rng = np.random.default_rng(0)

    # three waves of requests with different generation budgets
    waves = [(6, 4), (4, 8), (5, 6)]
    t0 = time.time()
    all_ids = []
    for i, (n, max_new) in enumerate(waves):
        prompts = rng.integers(0, cfg.vocab_size, (n, 8)).astype(np.int32)
        ids = ex.submit(prompts, max_new=max_new)
        all_ids.extend(int(t) for t in ids)
        print(f"wave {i}: submitted {n} requests (max_new={max_new}); "
              f"queue depth: {ex.wq.counts()['READY']}")
        for _ in range(4):
            ex.step_decode()
    ex.drain()
    dt = time.time() - t0

    fin = ex.wq.counts()["FINISHED"]
    toks = sum(len(ex.wq.store.blobs[t].get("output", []))
               for t in all_ids)
    print(f"\nserved {fin} requests / {toks} tokens in {dt:.1f}s "
          f"({toks/dt:.1f} tok/s on {ex.device})")
    st = ex.wq.store
    lat = st.col("end_time")[:fin] - st.col("submit_time")[:fin]
    print(f"latency p50/p95: {np.percentile(lat,50):.2f}/"
          f"{np.percentile(lat,95):.2f}s  (from the store's exec columns)")


if __name__ == "__main__":
    main()
