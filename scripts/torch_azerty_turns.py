#!/usr/bin/env python3
"""Time the azerty-s cell of ``chip_smoke.py`` through a checkout's own
CLI, its fallback words on the native oracle engine and under
``A5_NATIVE=0`` in turns, on one GPU: qwerty-azerty x MD5 ``-s``, 2.5e5
words of which 2000 are hazard lines (1000 go to the host oracle), 1M
digests with 1000 planted hits, as phase 4 builds it.

Usage, from the root of a checkout::

    python3 scripts/torch_azerty_turns.py [ROOT] [--rounds N]

``ROOT`` is the checkout whose package and ``chip_smoke.py`` run
(default: the current directory; a tree without the native engine runs
its Python oracle in both arms).  Each round runs the two arms, the
first arm alternating by round; each run prints its drive, CLI wall and
stdout's SHA-256, after the card's name and power limit.
"""

import argparse
import hashlib
import os
import shutil
import sys


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?", default=".")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    os.chdir(root)
    import numpy as np

    import chip_smoke as cs

    card = cs.nvidia_smi("name,power.limit")
    print(f"card: {card}; tree: {root}", flush=True)
    work = os.path.join(root, "build", "azerty_turns")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    words = list(dict.fromkeys(cs.synth_words(cs.N_WORDS_DEFAULT - 1000,
                                              seed=21)))
    words = words[: cs.N_WORDS_DEFAULT - 2000]
    rng = np.random.default_rng(22)
    for w in dict.fromkeys(cs.azerty_lines(2000, seed=23)):
        words.insert(int(rng.integers(0, len(words))), w)
    path = cs.MainPath("azerty-md5-s", work, words, "qwerty-azerty", "md5",
                       {"mode": "suball"}, seed=25,
                       quota={"device_closed": 120, "oracle_fallback": 60})
    arms = ("native", "A5_NATIVE=0")
    for r in range(args.rounds):
        for arm in arms if r % 2 == 0 else arms[::-1]:
            with cs.knobs(A5_NATIVE="0" if arm != "native" else None):
                run = path.run(f"{arm}, round {r}", ["-s"], card)
            print(f"[turns] round {r} {arm}: drive {run['drive']} s, CLI "
                  f"wall {run['wall']:.3f} s, stdout sha256 "
                  f"{hashlib.sha256(run['stdout']).hexdigest()}", flush=True)
    shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
