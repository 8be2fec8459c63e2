"""One sweep over several devices of one process: the reference's 1-D
mesh (``parallel/mesh.py``) in torch's idiom.

The reference shards variant blocks over a ``shard_map`` mesh: plans,
tables and the digest set replicated, and device ``d`` of ``D`` sweeping
the cursor stripe that starts at block ``b0 + d * NB`` of each launch.
Here each stripe is a copy of the sweep's launch on one ``torch.device``
(its own CUDA stream and buffer sets); the sweep (``runtime/sweep.py``)
dispatches every stripe of a superstep, sums their ``[n_emitted,
n_hits]`` counters on the host at the consumed fetch and merges their
hits in ``(word, rank)`` order; candidates mode concatenates the
stripes' rows in stripe order, which is cursor order.  The stream and
the checkpoint cursor are those of one device, so a checkpoint taken at
one device count resumes at any other.

A pod's giant job (``SweepConfig.pod = (index, count)``) widens the
lattice: with ``count`` processes of ``D`` stripes each, global stripe
``index * D + d`` owns blocks ``b0 + (index * D + d) * NB`` of every
launch, and every stripe advances ``NB * D * count`` blocks a step.

Several stripes may share one device (``devices=[cuda:0, cuda:0]``, or
``--device cpu --devices N``: N stripes over the one CPU device); they
then share its copy of the arrays.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

__all__ = ["Stripes", "resolve_devices", "resolve_stripes"]


def resolve_devices(devices, device) -> List[torch.device]:
    """The stripes' devices: ``devices`` is a count (N stripes; the first
    N CUDA devices on ``cuda``, N stripes over the CPU on ``cpu``), None
    ("auto": every visible CUDA device, one CPU stripe) or an explicit
    sequence of devices.  More CUDA devices than are visible raise the
    reference's ``ValueError`` — never fewer stripes in silence."""
    base = torch.device(device)
    if devices is not None and not isinstance(devices, (int, str)):
        out = [torch.device(d) for d in devices]
        if not out:
            raise ValueError("SweepConfig.devices must name at least one "
                             "device")
        for d in out:
            if d.type != base.type:
                raise ValueError(f"device {d} is not a {base.type} device")
            if d.type == "cuda" and (d.index or 0) >= _cuda_count():
                raise ValueError(f"requested device {d}, have "
                                 f"{_cuda_count()} CUDA devices")
        return out
    if base.type == "cpu":
        n = 1 if devices is None else int(devices)
        if n < 1:
            raise ValueError(f"SweepConfig.devices must be >= 1, got {n}")
        return [base] * n
    have = _cuda_count()
    n = have if devices is None else int(devices)
    if n < 1:
        raise ValueError(f"SweepConfig.devices must be >= 1, got {n}")
    if n > have:
        raise ValueError(f"requested {n} devices, have {have}")
    if n == 1:
        return [base]
    return [torch.device("cuda", i) for i in range(n)]


def _cuda_count() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


@dataclass(frozen=True)
class Stripes:
    """This process's cursor stripes: one per entry of ``devices``; the
    first is global stripe ``offset`` of ``total`` (``total`` =
    ``len(devices)`` outside a pod)."""

    devices: Tuple[torch.device, ...]
    offset: int = 0
    total: int = 1

    @property
    def n(self) -> int:
        return len(self.devices)

    def owned(self, s: int) -> bool:
        """Whether global stripe ``s`` of a launch round is this
        process's."""
        return self.offset <= s < self.offset + self.n

    def streams(self) -> List[Optional["torch.cuda.Stream"]]:
        """One CUDA stream per stripe when several stripes run on CUDA;
        None (the current stream) otherwise."""
        if self.n == 1 or self.devices[0].type != "cuda":
            return [None] * self.n
        return [torch.cuda.Stream(device=d) for d in self.devices]

    def distinct(self) -> List[torch.device]:
        """The devices, each once, in stripe order."""
        out: List[torch.device] = []
        for d in self.devices:
            if d not in out:
                out.append(d)
        return out


def resolve_stripes(devices: Sequence[torch.device],
                    pod: "Optional[Tuple[int, int]]") -> Stripes:
    """The stripe layout of ``devices`` in a pod of ``pod = (index,
    count)`` processes (None: no pod)."""
    index, count = pod or (0, 1)
    n = len(devices)
    return Stripes(devices=tuple(devices), offset=index * n,
                   total=n * count)
