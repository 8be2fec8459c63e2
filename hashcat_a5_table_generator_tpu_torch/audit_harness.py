"""Concrete calls for the audited bodies: each ``fused_body`` entry of
:mod:`.audit` paired with one launch of a sweep (the counterpart of the
reference's ``tools/graftaudit/harness.py``).  ``tests/test_torch_audit.py``
runs them on the CPU, ``chip_smoke.py`` phase 13 on the card."""

from __future__ import annotations

from typing import Callable, Dict


def body_calls(sweep) -> Dict[str, Callable[[], dict]]:
    """``entry name -> call`` for every registered ``fused_body``: one
    call of the body on the first launch of ``sweep``'s whole region (its
    route, geometry, closure keywords and device arrays), every input
    already on the device, so a call runs the body alone.

    ``models.make_superstep_body``: one step from block 0 into a fresh
    hit buffer (present when the region takes the superstep drive).
    ``models.make_fused_body`` (``make_crack_step``): the per-launch step
    at K=1 on the first launch's blocks, cut on the host beforehand."""
    from .models.attack import (
        make_crack_step,
        make_superstep_body,
        superstep_buffers,
    )

    r = sweep._whole
    if r is None or r.route is None:
        raise ValueError("body_calls needs a sweep compiled whole, with "
                         "words on a device route")
    s = sweep._setup(r, "crack", (0, 0))
    spec, arrays, kw = sweep.spec, s["arrays"][0], s["kw"]
    calls: Dict[str, Callable[[], dict]] = {}
    if not s["per_launch"]:
        body = make_superstep_body(spec, step_advance=s["nb"], **kw)
        bufs = superstep_buffers(int(sweep.config.superstep_hit_cap),
                                 device=sweep.device)
        calls["models.make_superstep_body"] = (
            lambda: body(arrays, 0, 1, bufs))
    step = make_crack_step(spec, **dict(kw, pair_k=None))
    parts, _w, _rank = next(sweep._host_rounds(
        r.plan, s["lanes"], s["nb"], s["stride"], step.decode, (0, 0)))
    blocks = parts[0][2]
    calls["models.make_fused_body"] = lambda: step(arrays, *blocks)
    return calls
