#!/usr/bin/env python3
"""Run a checkout's ``chip_smoke.py`` with the SHA-256 of every CLI run's
standard output logged, so that two trees' runs in one chip call can be
compared byte for byte (their runs come in the same order, from the same
seeds).

Usage, from the root of a checkout (``ROOT``: the checkout whose
``chip_smoke.py`` runs; default: the current directory)::

    python3 scripts/torch_smoke_digests.py [ROOT]

Each CLI run adds one line ``[stdout N] sha256 <hex> <bytes> B: <argv>``
(``N`` counts the runs; the argv's paths relative to ``ROOT``); the rest
of the output is ``chip_smoke.py``'s own, its exit code too.
"""

import hashlib
import os
import sys


def main() -> None:
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else ".")
    sys.path.insert(0, root)
    os.chdir(root)
    import chip_smoke

    run_cli, count = chip_smoke.run_cli, [0]

    def logged(argv):
        out, err, rc = run_cli(argv)
        count[0] += 1
        shown = " ".join(os.path.relpath(a, root) if os.path.isabs(str(a))
                         else str(a) for a in argv)
        print(f"[stdout {count[0]}] sha256 "
              f"{hashlib.sha256(out).hexdigest()} {len(out)} B: {shown}",
              flush=True)
        return out, err, rc

    chip_smoke.run_cli = logged
    sys.argv = [os.path.join(root, "chip_smoke.py")]
    chip_smoke.main()


if __name__ == "__main__":
    main()
