"""Write ``csrc/kernel_budgets.json``, the port's kernel resource pins,
from the ptxas lines of a ``chip_smoke.py`` run.

``chip_smoke.py`` phase 2 prints one line per kernel instantiation of
every CUDA library it builds::

    ptxas [piece_hash_md5]: piece_tile_kernel<1,1,1,1,0>: 64 registers,
        0 B stack, spill 0/0 B, 0 B static smem

and phase 13 holds each instantiation to its pin: registers, stack bytes
and spill stores / loads no higher than pinned.  This script turns such a
log into the pin file (the counterpart of the reference's
``python -m tools.graftaudit --update-budgets``).  Usage::

    python3 scripts/torch_kernel_budgets.py SMOKE_LOG [--card "NAME, W"] \\
        > hashcat_a5_table_generator_tpu_torch/csrc/kernel_budgets.json
"""

import argparse
import json
import re
import sys

LINE = re.compile(
    r"ptxas \[(\w+)\]: (\S+): (\d+) registers, (\d+) B stack, "
    r"spill (\d+)/(\d+) B")
FIELDS = ("registers", "stack_bytes", "spill_stores", "spill_loads")


def pins(text: str) -> dict:
    """``library:kernel<...>`` -> ``[registers, stack, spill stores, spill
    loads]`` of every ptxas line in ``text`` (a later line of one
    instantiation replaces an earlier one)."""
    return {f"{m.group(1)}:{m.group(2)}": [int(m.group(i))
                                            for i in range(3, 7)]
            for m in LINE.finditer(text)}


def render(kernels: dict, card: str) -> str:
    """The pin file: one instantiation a line, sorted."""
    head = {
        "_comment": (
            "Kernel resource pins of the CUDA sources in csrc/: per "
            "instantiation, nvcc -Xptxas -v's registers, stack frame bytes "
            "and spill store / load bytes at the flags of "
            "ops/_native_build.NVCC_FLAGS. chip_smoke.py phase 13 fails "
            "when an instantiation goes above its pin or has none; "
            "tests/test_torch_audit.py holds the keys equal to "
            "ops/_native_build.KERNELS and to the sources' dispatch. "
            "Written by scripts/torch_kernel_budgets.py from a "
            "chip_smoke.py log."),
        "card": card,
        "fields": list(FIELDS),
    }
    lines = [json.dumps(head, indent=1)[:-2] + ",", ' "kernels": {']
    items = sorted(kernels.items())
    for i, (key, vals) in enumerate(items):
        sep = "," if i + 1 < len(items) else ""
        lines.append(f"  {json.dumps(key)}: {json.dumps(vals)}{sep}")
    lines += [" }", "}"]
    return "\n".join(lines) + "\n"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("log", help="a chip_smoke.py log (its standard output)")
    ap.add_argument("--card", default="",
                    help="the card's name and power limit, as nvidia-smi "
                         "--query-gpu=name,power.limit gives them")
    args = ap.parse_args()
    with open(args.log, encoding="utf-8", errors="replace") as fh:
        kernels = pins(fh.read())
    if not kernels:
        sys.exit(f"no ptxas lines in {args.log}")
    text = render(kernels, args.card)
    json.loads(text)
    sys.stdout.write(text)


if __name__ == "__main__":
    main()
