"""Where one train step makes the host wait for the card: the CUDA
runtime's synchronising calls and copies in a profile of one step, counted
by the port's span that encloses them on their thread (else the innermost
open at their start, marked "by time"; ``repro_torch.trace``) and by the
ops that made them.

    python3 scripts/step_syncs.py --arch qwen2-0.5b   # one H100
    python3 scripts/step_syncs.py --config \
        bench/configs/granite-moe-3b-a800m.json --batch 16

Full width, ``--batch`` x ``--seq-len`` tokens (4 x 2048 by default), three
warm steps, then one profiled step and its loss read back. ``--config``
takes the configuration from a benchmark configuration file's ``model``
in place of the registry's ``--arch``.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import sys
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
from repro_torch import trace  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.data.pipeline import DataConfig, batch_for  # noqa: E402
from repro_torch.launch.steps import (init_train_state,  # noqa: E402
                                      make_train_step)


def _chain(e, depth: int = 4) -> str:
    out = []
    while e is not None and len(out) < depth:
        out.append(e.name)
        e = e.cpu_parent
    return " < ".join(out)


def config_of_file(path: str) -> base.ModelConfig:
    """The ``ModelConfig`` of a configuration file's ``model`` dict, its
    nested ``moe`` / ``ssm`` / ``rglru`` dicts as their dataclasses."""
    with open(path) as f:
        m = dict(json.load(f)["model"])
    nested = {"moe": base.MoEConfig, "ssm": base.SSMConfig,
              "rglru": base.RGLRUConfig}
    for key, cls in nested.items():
        if isinstance(m.get(key), dict):
            m[key] = cls(**m[key])
    if isinstance(m.get("rglru"), base.RGLRUConfig):
        m["rglru"] = dataclasses.replace(
            m["rglru"], pattern=tuple(m["rglru"].pattern))
    return base.ModelConfig(**m)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--arch", default="qwen2-0.5b")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--seq-len", type=int, default=2048)
    p.add_argument("--config", default=None,
                   help="a benchmark configuration file, in place of --arch")
    a = p.parse_args()
    cfg = config_of_file(a.config) if a.config else get_config(a.arch)
    state = init_train_state(cfg, torch.Generator(device="cuda").manual_seed(0))
    step = make_train_step(cfg)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=a.seq_len,
                    batch_size=a.batch)
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in batch_for(cfg, dc, 0).items()}
    for _ in range(3):
        state, m = step(state, batch, {"lr": 3e-4})
        float(m["loss"])
    torch.cuda.synchronize()
    trace.enable()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with trace.span("tick.step"):
            state, m = step(state, batch, {"lr": 3e-4})
        float(m["loss"])
    trace.enable(False)
    events = prof.events()
    spans = [e for e in events if e.name.startswith(trace.PREFIX)]

    def phase(e) -> str:
        """The port's span that encloses ``e`` on its own thread, else the
        innermost one open at its start on any thread."""
        p = e.cpu_parent
        while p is not None:
            if p.name.startswith(trace.PREFIX):
                return p.name[len(trace.PREFIX):]
            p = p.cpu_parent
        t = e.time_range.start
        inner = [s for s in spans
                 if s.time_range.start <= t <= s.time_range.end]
        return min(inner, key=lambda s: s.time_range.elapsed_us()).name[
            len(trace.PREFIX):] + " (by time)" if inner else "outside spans"

    found = collections.Counter(
        (phase(e), _chain(e)) for e in events
        if e.device_type == torch.autograd.DeviceType.CPU
        and ("Synchronize" in e.name or e.name.startswith("cudaMemcpy")))
    print(f"{cfg.name} {a.batch} x {a.seq_len}, "
          f"{torch.cuda.get_device_name(0)}")
    for (ph, chain), n in sorted(found.items()):
        print(f"{n:5d}  {ph:16s} {chain}")


if __name__ == "__main__":
    main()
