#!/usr/bin/env python3
"""Run a checkout's ``chip_smoke.py`` with the SHA-256 of every CLI run's
standard output logged, so that two trees' runs in one chip call can be
compared byte for byte (their runs come in the same order, from the same
seeds).

Usage, from the root of a checkout (``ROOT``: the checkout whose
``chip_smoke.py`` runs; default: the current directory)::

    python3 scripts/torch_smoke_digests.py [--through-phase-4] [ROOT]

``--through-phase-4`` stops the run where phase 5 would start (the
timing and oracle phases and later are skipped): two trees' phase-4
stdouts and drives compared in turns at a third of the call's time.

Each CLI run adds one line ``[stdout N] sha256 <hex> <bytes> B: <argv>``
(``N`` counts the runs; the argv's paths relative to ``ROOT``); the rest
of the output is ``chip_smoke.py``'s own, its exit code too.
"""

import hashlib
import os
import sys


def main() -> None:
    args = sys.argv[1:]
    through_phase_4 = "--through-phase-4" in args
    args = [a for a in args if a != "--through-phase-4"]
    root = os.path.abspath(args[0] if args else ".")
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
    if through_phase_4:
        def stop(*_a, **_k):
            chip_smoke.log("stopped after phase 4")
            sys.exit(0)

        chip_smoke.compression_floor = stop  # phase 5's first call
    sys.argv = [os.path.join(root, "chip_smoke.py")]
    chip_smoke.main()


if __name__ == "__main__":
    main()
