"""Weights drawn by the benchmark from ``--seed``, one set for the program
and the same again for the plain reference.

The normal draws come from one ``torch.randn`` of every such element on
the run's device (a generator on the card), cut into the leaves in the
order of the reference's parameter list and scaled; the other leaves are
constants. The same seed on the same device gives the same tensors, so the
reference's copy is drawn again after the program's state is freed rather
than kept.
"""
from __future__ import annotations

import math
from typing import Iterator, List, Tuple

import torch

Spec = List[Tuple[str, Tuple[int, ...], str]]


def _constant(shape, init: str, device) -> torch.Tensor:
    if init == "zeros":
        return torch.zeros(shape, dtype=torch.float32, device=device)
    if init == "ones":
        return torch.ones(shape, dtype=torch.float32, device=device)
    if init == "a_log":
        return torch.log(torch.linspace(1.0, 16.0, shape[0],
                                        dtype=torch.float32, device=device))
    raise ValueError(f"unknown init {init!r}")


def leaves(spec: Spec, seed: int, device) -> Iterator[Tuple[str,
                                                            torch.Tensor]]:
    """(name, fp32 tensor) of every leaf of ``spec``, drawn from ``seed``.
    The tensors of the normal leaves are views of one buffer."""
    normal = [(n, s, float(i.split(":")[1])) for n, s, i in spec
              if i.startswith("normal:")]
    total = sum(math.prod(s) for _, s, _ in normal)
    gen = torch.Generator(device=device).manual_seed(seed)
    buf = torch.randn(total, generator=gen, dtype=torch.float32,
                      device=device)
    views, off = {}, 0
    for name, shape, std in normal:
        k = math.prod(shape)
        views[name] = buf[off:off + k].view(shape).mul_(std)
        off += k
    for name, shape, init in spec:
        yield name, views[name] if name in views else \
            _constant(shape, init, device)


def load_into(module: torch.nn.Module, spec: Spec, seed: int) -> None:
    """Overwrite every parameter of ``module`` with the drawn weights; the
    module's parameter names and shapes must be those of ``spec``."""
    named = dict(module.named_parameters())
    want = {n: tuple(s) for n, s, _ in spec}
    got = {n: tuple(p.shape) for n, p in named.items()}
    if got != want:
        extra = sorted(set(got) - set(want))[:5]
        missing = sorted(set(want) - set(got))[:5]
        shapes = [n for n in want if n in got and got[n] != want[n]][:5]
        raise ValueError(f"the program's parameters differ from the "
                         f"reference's: extra {extra}, missing {missing}, "
                         f"other shapes {shapes}")
    dev = next(module.parameters()).device
    with torch.no_grad():
        for name, t in leaves(spec, seed, dev):
            named[name].copy_(t)
