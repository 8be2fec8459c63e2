#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA package on one NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no ``ok`` line):

1. the card: ``nvidia-smi`` name and power limit, the torch device name,
   the SM clock the INT32 peak rests on;
2. build every CUDA library from ``csrc/`` (``nvcc``, sm_90a; the piece,
   byte-scan and buffer-hash kernels once per hash, all twelve compilers
   started together) and print the ``-Xptxas -v`` register / stack /
   spill / shared-memory lines; beside them the two native host libraries
   (``native/packer.cpp``, ``native/oracle.cpp``; g++), which must build:
   the numpy / Python fallback fails the smoke (the nvcc builds go on
   while phases 3 and 4 prepare their inputs);
3. every kernel entry point x hash against its plain PyTorch version on
   the card, at the main path's shapes (2^22 lanes, stride 128): over
   match plans the scalar K=1 and pair tiers, the digit decode (czech,
   qwerty-azerty, the pair tier on a three-option table), the windowed
   decode (``-x 2``) and the reverse-mode pair tier; over substitute-all
   plans (``-s``) the scalar, digit, cascade-closed (qwerty-azerty and
   azerty-qwerty, joint tables up to 12 rows), windowed (cb packing and
   digits, open and closed) and pair selectors; plus batches that need 2
   and 3 hash blocks (MD5, NTLM, SHA-1); the byte-scan kernels (TPU rows
   7-9) in every tier x hash, with 2- and 3-block batches, and both tiers
   on one german plan; emit masks equal and state equal on every emitted
   lane, tolerance 0 (integer arithmetic), the windowed tier's CTA edges
   too (blocks of count 0, 1 and the stride, a partial last CTA), the
   tile tiers' (the scalar and digit decodes at K=1 — match,
   substitute-all and cascade-closed over qwerty-azerty and azerty-qwerty
   — and the pair tier: the same, a CTA of count-0 blocks, a window cut
   -m 2 -x 9, blocks of 4096 lanes cut into chunks), the digit decode at
   the huge word's shape (15 keys of three options, its first launch cut
   on the host), and the byte-scan kernels' (every tier x hash at the
   CTA edges, the window cut and chunks on one tier of each row); the
   buffer hash (TPU row 10 and its siblings: ``buffer_hash`` x 4 hashes x
   1, 2, 3 and 5 blocks, each at an odd width (funnel-shifted loads) and a
   multiple of 4 (aligned loads), the main path's widths 376 and 432, at
   2^22 rows, and the edges of ``BUFFER_EDGES``: widths 0-3, partial CTAs,
   buffers that are not 4-byte aligned, rows of 2101 bytes) equal to its
   plain version on every row and, for MD5, to ``hashlib`` on a sample; the XLA
   route's torch expansion on the card equal to the same call on the CPU
   for one plan per splice kind; one XLA-route launch per splice kind (a
   pair plan, a substitute-all plan over long lines and the main path's
   plans among them), crack and candidates bodies, at the lanes the sweep
   picks, holding no more device memory than the stated budget
   (``torch.cuda.max_memory_allocated``), its bytes per row beside the
   sweep's estimate;
4. the main path through the CLI at full width, each run with 1M digests
   of its hash (1000 planted hits + decoys): the crack cell
   (qwerty-cyrillic x MD5 with the pair tier auto and off) and
   qwerty-azerty x MD5 ``-s`` (cascade-closed and oracle-fallback words)
   at 150k dictionary words, the other cells at 100k: czech x NTLM,
   greek words x greek-hebrew x SHA-1 (pair auto and off),
   qwerty-cyrillic x MD5 ``-x 2``, qwerty-cyrillic x MD5 ``-s`` (pair
   auto), qwerty-cyrillic x SHA-1
   ``-s -x 2``, czech x NTLM ``-s -r`` and qwerty-cyrillic x MD5 ``-r``
   (pair auto); every planted plaintext printed exactly once, every
   printed hit re-hashing to its digest, ``candidates hashed`` equal to
   the host keyspace (oracle-fallback candidates included), the word
   routing equal to the host plan's, the expected kernels' launch
   counters above 0 and the plain version never run; german x MD5 and
   german x NTLM ``-r`` (byte-scan row 7), qwerty-cyrillic x SHA-1 ``-s``,
   and four ``A5GEN_EMIT=bytescan`` twins whose stdout must equal the
   per-slot run's; an ``A5_NATIVE=0`` twin of azerty ``-s`` (the numpy
   packer, the Python oracle for its fallback words) whose stdout must
   equal the native run's, which must have taken every fallback word on
   the native engine; on the XLA expand + hash route: qwerty-cyrillic x MD5
   ``-x 2`` at 148.5k words plus 1000 lines of 65-200 bytes and 500 lines
   of 25-40 letters (cyrillic-x2-long), 5e4 words x a nine-option table
   with a 5-byte value, SHA-1 (leet9-sha1), four ``A5GEN_PALLAS=off``
   twins (czech-ntlm, greek-hebrew-sha1, german-md5, azerty-s) whose
   stdout must equal the kernel route's, an ``A5GEN_PAIR=off`` twin of
   the cyrillic crack run whose stdout must equal pair auto's (and which
   launches no pair tier), a ``--superstep off`` twin of it (the
   per-launch pipeline, K=1: stdout equal to pair auto's), one word of
   2^30 rows on the piece route (15 keys of three options: the per-launch
   pipeline, hits planted in its last launch, each printed once; its
   rows, launches and drive printed), and candidates mode on stdout
   (``--output`` given and not written, as in the reference;
   qwerty-cyrillic, 2e4 words: line count = the host keyspace, the first
   2000 words byte-identical to a ``--device cpu`` run, per word the
   oracle's multiset on 200 sampled words; qwerty-azerty ``-s`` with
   oracle-fallback words interleaved, and ``-s -r``); every run on the
   XLA route within the memory budget over the whole run.  Every cell
   runs the CLI's defaults, so a bucket of more than one auto chunk
   (65,536 words at width 16) streams: the 150k-word buckets in 3 chunks,
   the 100k-word ones in 2;
5. each entry point x hash timed with CUDA events at main-path shapes
   beside its bound, the compression floor this card measures (the
   buffer hash at width 0: one compression a row, nothing loaded) and
   its plain version's time, the windowed tier with its masked share and
   CTA geometry, the digit decode also at the huge word's shape; the
   buffer hash's main-path launches by row width;
   stage breakdowns of one launch (membership against the 1M-digest
   sets), a closed substitute-all
   launch among them, and the masked-row share of the czech run; the
   byte-scan kernels likewise, and the two tiers on one german plan; the
   buffer hash per hash x shape beside its bound, and one XLA-route
   launch's stages (block cut, expansion, hash, membership, the rest);
6. the oracle backend (the CLI's default, on the host's cores), each run
   a process of its own: the default command line over phase 4's
   candidates words (cyrillic, azerty ``-s`` and ``-s -r``), its sorted
   lines equal to the card's run's and its count to the host keyspace,
   ``--threads N`` (N = min(nproc, 16)) byte-identical to ``--threads 1``,
   ``A5_NATIVE=0`` byte-identical on the first 2000 words, lines/s of
   each; the oracle crack (``--threads N``) over the crack cell's first
   10,000 words and its 1M MD5 digests, its hits equal to the card's on
   those words; ``--emit-table`` for every layout and ``--list-layouts``.
   Host numbers name the CPU (``lscpu``, ``nproc``) beside the card.

7. robustness: the crack cell killed by SIGKILL at a superstep fetch
   (``A5GEN_FAULTS='superstep.fetch:kill,nth=4'``, ``--checkpoint
   --checkpoint-every 0``) in a process of its own, then resumed — as it
   was, and at ``--pair off`` from a copy of its checkpoint — to stdout
   byte-identical to phase 4's; the same under ``--superstep off``, on
   azerty ``-s`` (its checkpoint holding fallback words) and in
   candidates mode (the resumed stream = the uninterrupted one from the
   checkpoint's ``n_emitted``); ``--retries 2`` through an injected
   dispatch fault and an injected ``FetchTimeout``, stdout byte-identical;
   a real ``--fetch-timeout`` far below one superstep: typed timeouts,
   the retries, exit 1, no hang; ``--profile``'s trace; the drive cost of
   ``--checkpoint-every 0`` (crack, pair off, at the default superstep,
   beside phase 4's run; the cost of one write) and the drive's
   host-span summary (``--metrics-json``: host gap, ``dead_share``) for
   that run and crack pair auto at ``--superstep 1``;
8. layouts and streaming: the variable-offset block layout on the crack
   cell (``--block-layout packed``) and on the candidates cyrillic cell
   (``--lanes 1000000``, which the auto block count of 1024 does not
   divide), each stdout byte-identical to
   phase 4's, launching ``buffer_hash`` on the XLA route and no fused
   kernel, its drive beside the stride layout's; the crack cell (pair
   off) at ``--stream-chunk-words off`` and the default, and
   cyrillic-x2-long at ``off`` (its default: phase 9), byte-identical, each with
   its host s (CLI wall − drive), ``ttfc_s``, ``compile_overlap_s``,
   ``overlap_ratio``, ``peak_resident_plan_bytes`` and device peak; the
   default crack run killed by SIGKILL inside a chunk and resumed as it
   was and at ``--stream-chunk-words off``; and one
   ``A5GEN_FAULTS=chunk.compile:nth=2`` run, which must recover (one
   worker restart) with identical stdout.

9. the schema cache, the prefetcher, devices and the pod: the crack cell
   (pair auto) run twice with ``--schema-cache
   DIR`` (run 1: no hit, an entry a chunk written; run 2: hits = run 1's
   misses, no miss), and the crack cell once more at
   ``--schema-cache-max-mb 1`` (evictions), each stdout byte-identical to
   phase 4's, with host s, ``ttfc_s`` and the cache counters; azerty
   ``-s`` (phase 4's runs went through the fallback prefetcher) once more
   through an injected dispatch fault with ``--retries 1``: identical,
   no producer thread left alive; ``--devices auto`` on the crack cell
   and ``--devices 1`` on the warm-up run's 2000 words identical to
   their runs without it, ``--devices 2`` on this one card exiting
   non-zero with the device-count message; ``Sweep(devices=[cuda:0,
   cuda:0])`` (two cursor stripes on one card) on the crack cell and on
   candidates cyrillic, byte-identical; and the pod, two processes on this
   card over gloo (``--coordinator 127.0.0.1:<port>``): the crack cell
   gathered (process 0's stdout byte-identical to phase 4's) and
   ``--pod-hits local`` (the union of the stdouts), candidates cyrillic
   (the stdouts concatenated), ``--giant-job`` on the huge word (each
   hit once; each process's launches and wall), and one process
   SIGKILLed at a fetch under ``A5GEN_DCN_TIMEOUT=10`` (the survivor
   exits 3 with the ``PeerLossError`` text within 30 s; the pod
   relaunched on the same ``--checkpoint`` resumes to phase 4's stdout).
   The five pods before the relaunch run at once (ten processes).

10. the resident engine: one ``a5gen serve`` process on stdin (``--pack
   auto``) takes 10 small tenants — 6 distinct 20,000-word slices of the
   crack recipe x qwerty-cyrillic x MD5, 2 of czech x NTLM and 2 of the
   german recipe (ss and sss kept, words of more than 6 match slots left
   out) x german x MD5, whose plans have no piece schema (the byte-scan
   route, asserted before the session, with their packed keys equal),
   each with its own 100,000-digest list and about 100 planted hits — and
   phase 4's crack cell whole (it streams: per-job dispatch beside the
   groups); every tenant's ``hit`` events equal its solo
   ``Sweep.run_crack`` on the card and its ``done`` totals its solo
   run's, the crack cell's hits phase 4's stdout; the stats
   (``fused_groups``, ``packed_dispatches``, ``packed_fill``,
   ``programs_compiled``), the serve process's kernel launches (the fused
   groups' packed supersteps on ``piece_k1`` / ``piece_pair`` and, for
   the german group, ``bytescan_*/md5``, which must be there, at least
   once a packed dispatch; nothing on the XLA route), the german group's
   own fill (its occupied over total lanes), each job's wall and the
   process's; the same submission at ``--pack off`` (no packed
   dispatch, the same streams); churn: the 6 cyrillic tenants at 2^16
   lanes, one launch a superstep, 4 cancelled on their first hits, the
   survivors re-fused (``refused`` events), one paused and resumed with
   the ``resume`` op, one paused and its checkpoint submitted as a new
   job — each survivor's hits the solo run's; a unix-socket session
   (``--socket``): one tenant, ``stats``, ``metrics`` (Prometheus text
   that parses), ``shutdown`` -> ``bye``.

11. the fleet router: ``a5gen fleet --engines 2 --split on`` on stdin,
   both engines on this card (the router's spawned commands recorded:
   ``python -m hashcat_a5_table_generator_tpu_torch serve --device cuda``,
   each engine reporting its kernel launches at exit), over phase 10's
   tenants and solo runs: the 8 tenants and phase 4's crack cell routed
   by affinity (the cyrillic tenants and the crack cell on one engine,
   the czech tenants on the other), each stream its solo run's, the crack
   cell's phase 4's stdout; the crack cell with its words inline, split
   into two pod stripes on the two engines and merged back into phase
   4's stdout; the 6 cyrillic tenants at 2^18 lanes, one launch a
   superstep, their engine drained on the first hit (the jobs migrate,
   each stream its solo run's, the engine left routing none; the
   ``stats`` fleet section).  A second fleet (started beside the first)
   takes the 8 tenants at that geometry and loses the engine carrying
   the cyrillic ones to SIGKILL after its first hit event: its running
   jobs crash-replay onto the survivor, each stream its solo run's, no
   hit twice.  A third, elastic fleet (``--engines 1 --autoscale 1:2``,
   one routed job an engine, a tick every 0.5 s: ``ELASTIC_ARGS``)
   takes the crack cell and the 8 tenants (at 2^18 lanes, one launch a
   superstep) at once: the burst queues on
   the router, the autoscaler spawns a second engine, which attaches and
   takes placements (its kernel launches at exit), every stream equals
   its solo run's; the idle fleet then drains and reaps the spawned
   engine (its process gone): one scale-up and one scale-down in the
   ``stats`` op's ``fleet.autoscale``; the time from the submit to the
   second engine's attach and the session wall beside the routed
   fleet's.

12. the geometry tuner: ``a5gen tune --smoke --no-write --json`` on the
   card in a process of its own (the four arms agree on
   ``emitted_per_sweep``; its launches), beside it a process that reads
   the device's name and builds a ``Sweep`` with no lanes (no CUDA
   context after either, one after its run: ``CONTEXT_PROBE``); a bounded matrix through
   ``runtime.tune.run_autotune`` (2^20 and 2^22 lanes x pair auto / off
   at stride 128 and superstep 16, over ``TUNE_WORDS`` tune-contract
   words, ``TUNE_SECONDS`` an arm), each arm's rate beside its drive's
   share of the arm's wall, its winner written as this card's profile;
   then the crack cell through the CLI with no ``--lanes``: its progress
   geometry says ``profile`` with the winner's numbers and its stdout is
   phase 4's.  ``A5GEN_TUNE_PROFILE`` points at a directory of the
   script's own from its start, so no earlier run reads a profile.

A run still going 1180 s after its start fails, printing every
thread's stack.  The last ten lines of standard output: one
``{"tune": {...}}`` JSON object, one
``{"fleet": {...}}`` JSON object, one ``{"serve": {...}}`` JSON
object, one ``{"pod": {...}}`` JSON
object, one ``{"layouts_streaming": {...}}`` JSON object, one ``{"robustness": {...}}`` JSON object, one
``{"oracle": {...}}`` JSON object, the card's name and power limit, one
``{"kernels": [...]}`` JSON object, and the ``{"ok": true, ...}`` JSON
object.
"""

from __future__ import annotations

import contextlib
import io
import itertools
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
T0 = time.monotonic()
LANES = 1 << 22
STRIDE = 128
N_WORDS_DEFAULT = 150_000  # the crack cell's words (and azerty -s's)
N_WORDS_CELL = 100_000  # the other phase-4 cells', cut to keep time
N_DIGESTS = 1_000_000
N_PLANTED = 1000
CASE_WORDS = 60_000  # words per phase-3 workload
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
ALGOS = ("md5", "md4", "sha1", "ntlm")
#: INT32 instructions per compression on Hopper, counted from the
#: unrolled rounds of csrc/piece_hash.cu:
#: * MD5: 64 steps x (one LOP3 round function, two IADD3 for
#:   a + f + m + K, one SHF funnel rotate, one IADD for b + rot) = 320;
#: * MD4 (and NTLM): 16 steps x (LOP3, IADD3 a + f + m, SHF) + 32 steps x
#:   (LOP3, IADD3, IADD for + K, SHF) = 48 + 128 = 176;
#: * SHA-1: 16 byte swaps (PRMT) + 64 schedule words x (two LOP3 for the
#:   four-way XOR, one SHF) + 80 steps x (SHF rotl 5, LOP3 round function,
#:   two IADD3 for rotl(a) + f + e + K + w, SHF rotl 30) = 16 + 192 + 400
#:   = 608.
OPS_PER_BLOCK = {"md5": 320, "md4": 176, "ntlm": 176, "sha1": 608}
STATE_WORDS = {"md5": 4, "md4": 4, "ntlm": 4, "sha1": 5}
DIGEST_BYTES = {"md5": 16, "md4": 16, "ntlm": 16, "sha1": 20}
KERNEL_SOURCE = "hashcat_a5_table_generator_tpu_torch/csrc/piece_hash.cu"
BYTESCAN_SOURCE = ("hashcat_a5_table_generator_tpu_torch/csrc/"
                   "bytescan_hash.cu")
BUFFER_SOURCE = "hashcat_a5_table_generator_tpu_torch/csrc/buffer_hash.cu"
PALLAS = "hashcat_a5_table_generator_tpu/ops/pallas_expand.py"
PALLAS_MD5 = "hashcat_a5_table_generator_tpu/ops/pallas_md5.py"
#: Nine options on ``a`` (one of them 5 bytes): past the fused kernels'
#: 8 options per key and 4-byte values, so every bucket takes the XLA
#: route.  No value is a letter or one of the recipe's digits (1-3).
LEET9 = {b"a": [b"4", b"@", b"^", b"&", b"*", b"!", b"%", b"#", b"/-\\-/"],
         b"s": [b"$", b"5"], b"e": [b"9"]}
#: The branch of the TPU body (``_make_piece_kernel`` :1303) each entry
#: point replaces, and each hash's rounds.
BRANCHES = {
    "suball_k1": "kind=suball, scalar decode, selbit (:1384-1390, "
                 ":1553-1555)",
    "suball_pair": "kind=suball, pair=True, scalar decode (selbit "
                   ":1553-1555, cb | 1)",
    "suball_pair_digits": "kind=suball, pair=True, digit decode (selslot "
                          ":1482-1487, d0p :1430-1435)",
    "suball_digits": "kind=suball, general tier (selslot in col_variant "
                     ":1482-1487, clamp :1557-1564)",
    "suball_windowed": "kind=suball, windowed tier (bitpos cb packing "
                       ":1443-1446, or selslot)",
    "suball_closed": "kind=suball, cascade closure (joint index "
                     ":1462-1476, :1488-1491), digit decode",
    "suball_closed_windowed": "kind=suball, cascade closure (:1462-1476, "
                              ":1488-1491), windowed decode",
    "k1": "scalar-units full enumeration (:1415-1421), K=1",
    "pair": "pair=True, scalar decode (:1401-1456)",
    "pair_digits": "pair=True, digit decode (d0p :1430-1435, cc1 :1458, "
                   "idx1 :1571-1579)",
    "digits": "general tier (_decode_tile :773, col_variant :1478, clamp "
              ":1557-1564, merged columns :1565-1570)",
    "windowed": "windowed tier (_decode_tile_windowed :333, cb packing "
                ":1436-1446)",
}
ROUNDS = {"md5": "_md5_rounds", "md4": "_md4_rounds :1129",
          "sha1": "_sha1_rounds :1162",
          "ntlm": "_md4_rounds :1129 + split_pieces :1601-1629"}
LEET3 = {b"a": [b"4", b"@", b"^"], b"e": [b"3", b"&", b"EE"],
         b"s": [b"$", b"5", b"z"], b"o": [b"0", b"()", b"*"]}
#: One option per key: the substitute-all pair tier's table (words where
#: each word's lowest-sorted pattern occurs once, first: ``pair_words``).
SINGLE = {b"a": [b"@@"], b"o": [b"0"], b"s": [b"$"], b"e": [b"33"]}


def log(msg: str) -> None:
    print(f"[{time.monotonic() - T0:7.1f}s] {msg}", flush=True)


#: Every process the smoke starts (:func:`spawn`): a failure kills those
#: still running.
CHILDREN: list = []
#: Seconds after start at which a smoke still running fails, with every
#: thread's stack on stderr (a hang fails inside the 1200 s a caller
#: gives the script, and says where it hung).
DEADLINE_S = 1180


def stop_children() -> None:
    for proc in CHILDREN:
        if proc.poll() is None:
            try:
                if getattr(proc, "a5_session", False):
                    os.killpg(proc.pid, 9)
                else:
                    proc.kill()
            except OSError:
                pass


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    stop_children()
    sys.exit(1)


def spawn(args, **kw) -> "subprocess.Popen":
    """``subprocess.Popen(args, **kw)``, the process kept in
    :data:`CHILDREN`."""
    proc = subprocess.Popen(args, **kw)
    proc.a5_session = bool(kw.get("start_new_session"))
    CHILDREN.append(proc)
    return proc


def arm_deadline(seconds: float = DEADLINE_S) -> None:
    """A daemon thread that, ``seconds`` after start, prints every
    thread's stack, kills the children and exits 1."""
    import faulthandler

    def watch():
        time.sleep(max(0.0, seconds - (time.monotonic() - T0)))
        print(f"chip_smoke: FAIL: still running {seconds:.0f} s after "
              "start; the stacks:", file=sys.stderr, flush=True)
        faulthandler.dump_traceback(sys.stderr, all_threads=True)
        stop_children()
        os._exit(1)

    threading.Thread(target=watch, name="chip-smoke-deadline",
                     daemon=True).start()


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0].strip()


# ---------------------------------------------------------------------------
# Inputs (made from seeds)
# ---------------------------------------------------------------------------


def synth_words(n: int, seed: int = 0) -> list:
    """Rockyou-like words: lowercase stems of 6-10 letters, 0-2 trailing
    digits (the reference package's bench recipe)."""
    rng = np.random.default_rng(seed)
    stems = rng.integers(ord("a"), ord("z") + 1, size=(n, 10), dtype=np.uint8)
    lens = rng.integers(6, 11, size=n)
    digits = rng.integers(0, 3, size=n)
    words = []
    for i in range(n):
        w = bytes(stems[i, : lens[i]])
        if digits[i]:
            w = w[: -digits[i]] + b"123"[: digits[i]]
        words.append(w)
    return words


def long_words(n: int, lo: int, hi: int, letters: "tuple[int, int]",
               seed: int, filler: bytes = b"0123456789",
               alphabet: bytes = bytes(range(ord("a"), ord("z") + 1))
               ) -> list:
    """Long dictionary lines (rockyou carries some): runs of ``filler``
    bytes with a few letters of ``alphabet``, ``lo``..``hi`` bytes — in
    the 64-wide bucket their candidates need 2 or 3 hash blocks."""
    rng = np.random.default_rng(seed)
    fill = np.frombuffer(filler, np.uint8)
    abc = np.frombuffer(alphabet, np.uint8)
    out = []
    for _ in range(n):
        ln = int(rng.integers(lo, hi + 1))
        w = fill[rng.integers(0, len(fill), size=ln)].copy()
        k = int(rng.integers(letters[0], letters[1] + 1))
        pos = rng.choice(ln, size=k, replace=False)
        w[pos] = abc[rng.integers(0, len(abc), size=k)]
        out.append(bytes(w))
    return out


def wide_words(n: int, seed: int) -> list:
    """40-64-byte lines of 19 ``1``s, 3 letters and ``0``s: under
    :func:`wide_table` their candidates need 3 hash blocks at token width
    64 (22 slots)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        w = np.full(int(rng.integers(40, 65)), ord("0"), np.uint8)
        pos = rng.choice(len(w), size=22, replace=False)
        w[pos[:19]] = ord("1")
        w[pos[19:]] = rng.integers(ord("a"), ord("z") + 1, size=3,
                                   dtype=np.uint8)
        out.append(bytes(w))
    return out


#: Letters czech maps (the slots of a czech plan) and letters it does not.
CZECH_KEYS = b"acdeinorstuyz"
CZECH_FILLER = b"bfghjklmpqvwx"


def greek_words(words: list) -> list:
    """Words mapped letter by letter through ``qwerty-greek``: the
    greek-dictionary stand-in of the greek-hebrew configuration."""
    from hashcat_a5_table_generator_tpu_torch.tables.layouts import (
        get_layout,
    )

    qg = get_layout("qwerty-greek").to_substitution_map()
    lut = {c: qg.get(bytes([c]), [bytes([c])])[0] for c in range(256)}
    return [b"".join(lut[c] for c in w) for w in words]


def pair_words(n: int, seed: int) -> list:
    """Words whose lowest-sorted pattern (``a``) occurs once, first: slot
    0 drives column 0 only, as the substitute-all pair gate needs."""
    return [b"a" + w for w in long_words(n, 2, 8, (1, 2), seed,
                                         filler=b"bcdfgh", alphabet=b"eos")]


def azerty_lines(n: int, seed: int) -> list:
    """Short lines over ``aqzwAQZWm,;`` and letters: hazard words that
    qwerty-azerty's cascade closure takes, and (every other line carries
    ``m``, ``,`` and ``;``, mutually hazardous) words that overflow the
    closure caps and go to the oracle."""
    rng = np.random.default_rng(seed)
    pool = np.frombuffer(b"aqzwAQZWm,;bcdefghijk", np.uint8)
    out = []
    for i in range(n):
        w = list(pool[rng.integers(0, len(pool),
                                   size=int(rng.integers(2, 5)))])
        if i % 2:
            for ch in b"m,;":
                w.insert(int(rng.integers(0, len(w) + 1)), ch)
        out.append(bytes(w))
    return out


def wide_table(sub: dict) -> dict:
    """``sub`` plus ``1`` -> a 4-byte value: 19 of them take a 64-byte
    line's candidates past 2 MD5 blocks (3-block batches at token width
    64, which the reference's gate requires)."""
    return {**sub, b"1": [b"\xf0\x9f\x98\x80"]}


def german_words(n: int, seed: int) -> list:
    """The bench recipe's words (:func:`synth_words`: 6-10 lowercase
    letters, 0-2 trailing digits) with ``ss`` put in ~5% and ``sss`` in
    ~1% of them (German compounds: Schlosssee, Flussstrand, Messstation),
    at a seeded place."""
    rng = np.random.default_rng(seed + 1)
    out = []
    for w in synth_words(n, seed):
        u = rng.random()
        if u < 0.06:
            at = int(rng.integers(0, len(w)))
            w = w[:at] + (b"sss" if u < 0.01 else b"ss") + w[at:]
        out.append(w)
    return out


def overlap_rows(plan) -> np.ndarray:
    """Rows of a match plan where two active spans overlap (german's ``ss``
    in "sss"): their chosen vectors that pick both are clashes, which the
    kernel masks."""
    mp = getattr(plan, "match_pos", None)
    if mp is None:
        return np.zeros(0, np.int64)
    act = np.asarray(plan.match_radix) > 1
    pos, ln = np.asarray(mp), np.asarray(plan.match_len)
    rows = []
    for lo in range(0, pos.shape[0], 1 << 16):
        r = slice(lo, lo + (1 << 16))
        jj = np.arange(plan.tokens.shape[1])[None, None, :]
        inside = (act[r, :, None] & (jj >= pos[r, :, None])
                  & (jj < pos[r, :, None] + ln[r, :, None]))
        rows.append(lo + np.flatnonzero((inside.sum(axis=1) > 1).any(axis=1)))
    return np.concatenate(rows)


def exact_count(plan, row: int, lo: int, hi: int) -> int:
    """Candidates word ``row`` of a match plan emits: chosen sets of
    pairwise non-overlapping slots with a count in ``[lo, hi]``, weighted
    by their option counts — a DP over byte positions, right to left."""
    width = int(plan.tokens.shape[1])
    f = np.zeros((width + 2, int(plan.num_slots) + 2), np.int64)
    f[width, 0] = 1
    starts: dict = {}
    for s in range(int(plan.num_slots)):
        if plan.match_radix[row, s] > 1:
            starts.setdefault(int(plan.match_pos[row, s]), []).append(s)
    for j in range(width - 1, -1, -1):
        f[j] = f[j + 1]
        for s in starts.get(j, ()):
            nxt = j + int(plan.match_len[row, s])
            f[j, 1:] += (int(plan.match_radix[row, s]) - 1) * f[nxt, :-1]
    return int(f[0, lo:hi + 1].sum())


def brute_count(plan, row: int, lo: int, hi: int) -> int:
    """:func:`exact_count` by enumerating every digit vector."""
    slots = [s for s in range(int(plan.num_slots))
             if plan.match_radix[row, s] > 1]
    n = 0
    for chosen in itertools.product(*[range(int(plan.match_radix[row, s]))
                                      for s in slots]):
        spans = sorted((int(plan.match_pos[row, s]),
                        int(plan.match_len[row, s]))
                       for s, d in zip(slots, chosen) if d)
        if lo <= len(spans) <= hi and all(
                a[0] + a[1] <= b[0] for a, b in zip(spans, spans[1:])):
            n += 1
    return n


def check_overlap_counts(plan, spec, packed, sub, what) -> None:
    """Hold :func:`exact_count` against brute force on a sample of the
    plan's overlap words and against the port's oracle on a few."""
    from hashcat_a5_table_generator_tpu_torch.oracle.engines import (
        iter_candidates,
    )

    rows = overlap_rows(plan)
    lo, hi = spec.effective_min, spec.max_substitute
    for i, row in enumerate(rows[:200].tolist()):
        want = exact_count(plan, row, lo, hi)
        if brute_count(plan, row, lo, hi) != want:
            fail(f"{what}: the keyspace DP disagrees with brute force on "
                 f"{packed.word(row)!r}")
        if i < 20 and want != len(list(iter_candidates(
                packed.word(row), sub, lo, hi,
                reverse=spec.mode == "reverse", bug_compat=False))):
            fail(f"{what}: the keyspace DP disagrees with the oracle on "
                 f"{packed.word(row)!r}")
    log(f"{what}: {len(rows)} words with overlapping spans; keyspace DP = "
        f"brute force on {min(200, len(rows))}, = the oracle on "
        f"{min(20, len(rows))}")


def keyspace(plan, spec) -> int:
    """Candidates the device emits for the plan, counted on the host from
    its radices: per device word (oracle-fallback words excluded), the
    digit vectors whose chosen count lies in the window — the elementary
    symmetric sums of the slots' option counts — except, for a word whose
    match spans overlap, only the vectors of pairwise non-overlapping
    spans (:func:`exact_count`; the others are masked clashes)."""
    opts = (np.asarray(plan.pat_radix, np.int64) - 1).clip(min=0)
    lo, hi = spec.effective_min, spec.max_substitute
    e = np.zeros((opts.shape[0], opts.shape[1] + 1), np.int64)
    e[:, 0] = 1
    for s in range(opts.shape[1]):
        e[:, 1:] = e[:, 1:] + opts[:, s:s + 1] * e[:, :-1]
    e[np.asarray(plan.fallback, bool)] = 0
    per_word = e[:, lo:min(hi, opts.shape[1]) + 1].sum(axis=1)
    for row in overlap_rows(plan).tolist():
        per_word[row] = exact_count(plan, row, lo, hi)
    return int(per_word.sum())


# ---------------------------------------------------------------------------
# Phase 3 / 5 helpers
# ---------------------------------------------------------------------------

_PLANS: dict = {}


def plan_for(key, sub, words, spec, width=None):
    """(plan, ct, pieces) of a workload, built once for every hash (plans
    and schemas do not depend on the hash); ``width`` packs the words at
    a bucket's width."""
    from hashcat_a5_table_generator_tpu_torch.models.attack import build_plan
    from hashcat_a5_table_generator_tpu_torch.ops.packing import (
        pack_words, piece_schema_for,
    )
    from hashcat_a5_table_generator_tpu_torch.tables.compile import (
        compile_table,
    )

    if key not in _PLANS:
        ct = compile_table(sub)
        plan = build_plan(spec, ct, pack_words(words, width=width))
        _PLANS[key] = (plan, ct, piece_schema_for(plan, ct))
    return _PLANS[key]


class Case:
    """One kernel input at a given shape: blocks cut on the device from a
    real plan's index, with the plan's decode tier — or, for a plan with a
    word of 2^30 rows or more (no device index), the per-launch pipeline's
    first launch, its blocks cut on the host."""

    def __init__(self, name, workload, words, sub, *, algo="md5", mx=15,
                 pair=False, lanes=None, stride=STRIDE, width=None,
                 mode="default", mn=0, device):
        from hashcat_a5_table_generator_tpu_torch.models.attack import (
            AttackSpec, cut_blocks, device_arrays, host_blocks,
        )
        from hashcat_a5_table_generator_tpu_torch.ops import fused_expand
        from hashcat_a5_table_generator_tpu_torch.ops.blocks import (
            make_blocks, superstep_index,
        )
        from hashcat_a5_table_generator_tpu_torch.ops.membership import (
            build_digest_set,
        )

        self.name, self.algo, self.pair = name, algo, pair
        self.stride = stride
        self.spec = AttackSpec(mode=mode, algo=algo, min_substitute=mn,
                               max_substitute=mx)
        self.plan, self.ct, self.pieces = plan_for(
            (workload, mode, mn, mx), sub, words, self.spec, width)
        ct = self.ct
        if fused_expand.opts_for(self.spec, self.plan, ct) is None:
            fail(f"{name}: the plan takes the XLA route")
        why = (fused_expand.schema_refusal(self.plan, self.pieces)
               if self.pieces is not None else "no piece schema")
        if why:
            fail(f"{name}: the piece kernel refuses the plan: {why}")
        self.decode, pack_cb = fused_expand.decode_for(self.plan)
        self.key = fused_expand.launch_key(algo, self.pieces, self.decode,
                                           pair)
        rank_stride = stride * (2 if pair else 1)
        idx = superstep_index(self.plan, rank_stride)
        self.arrays = device_arrays(self.plan, self.pieces,
                                    build_digest_set([], algo), idx,
                                    device=device)
        nb = (lanes or LANES) // stride
        if idx is None:
            batch, _w, _r = make_blocks(self.plan, max_variants=nb * stride,
                                        max_blocks=nb,
                                        fixed_stride=rank_stride)
            self.blocks = host_blocks(
                batch, nb, self.decode,
                fused_expand.scalar_units_weight(self.plan), device=device)
        else:
            self.blocks = cut_blocks(self.arrays, 0, nb, rank_stride,
                                     self.decode)[:3]
        self.hash_blocks = fused_expand._hash_blocks_for(
            self.plan.out_width, 2 if algo == "ntlm" else 1)
        self.kw = dict(
            pieces=self.pieces, block_stride=stride,
            out_width=int(self.plan.out_width),
            min_substitute=self.spec.effective_min,
            max_substitute=self.spec.max_substitute, pair=pair, algo=algo,
            decode=self.decode, pack_cb=pack_cb,
            k_opts=fused_expand.k_vals_for(self.plan),
        )

    def kernel(self):
        from hashcat_a5_table_generator_tpu_torch.ops import fused_expand

        return fused_expand.fused_expand_md5(*self.blocks, self.arrays,
                                             **self.kw)

    def plain(self):
        from hashcat_a5_table_generator_tpu_torch.ops import fused_expand

        kw = dict(self.kw)
        kw.pop("out_width")
        return fused_expand.piece_md5_reference(
            *self.blocks, self.arrays, hash_blocks=self.hash_blocks, **kw
        )

    def lane_blocks(self) -> int:
        """Compressions the longest candidate of any word here needs: the
        word plus each slot's widest option (the kernel stops after each
        lane's own padding block, whatever its static block count); for
        substitute-all schemas, each device word's widest variant of every
        emission group, summed."""
        plan, ct, pieces = self.plan, self.ct, self.pieces
        scale = 2 if self.algo == "ntlm" else 1
        if pieces.kind == "suball":
            placed = sum(g.len_fixed or 0 for g in pieces.groups)
            if pieces.gl is not None:
                placed = placed + pieces.gl.astype(np.int64).max(
                    axis=2).sum(axis=1)
            placed = np.broadcast_to(placed, (plan.batch,))
            longest = int(placed[~np.asarray(plan.fallback)].max()) - 1
            return -(-(longest * scale + 9) // 64)
        opts = np.asarray(plan.match_radix) - 1
        grow = np.zeros(opts.shape, np.int64)
        for o in range(int(opts.max(initial=0))):
            row = np.clip(np.asarray(plan.match_val_start) + o, 0,
                          len(ct.val_len) - 1)
            grow = np.maximum(grow, np.where(
                opts > o, ct.val_len[row] - np.asarray(plan.match_len), 0))
        longest = int((np.asarray(plan.lengths) + grow.sum(axis=1)).max())
        return -(-(longest * scale + 9) // 64)

    def bound(self, emit, peak_ops: float) -> "tuple[float, str]":
        """Least time for this input: one compression per emitted
        candidate (every lane here needs exactly one) over the INT32 peak,
        against each input byte read once and each output byte written
        once over HBM bandwidth: an emit byte per row, and state words
        per row — on the windowed tier only per live row (rank < count),
        on the tile tiers (the scalar and digit decodes at K=1, the pair
        tier) only per emitted row, as their contract leaves the state of
        dead rows undefined."""
        import torch

        from hashcat_a5_table_generator_tpu_torch.ops import fused_expand

        if self.lane_blocks() != 1:
            fail(f"{self.name}: timed lanes need more than one compression")
        ops = float(int(emit.sum())) * OPS_PER_BLOCK[self.algo]
        words = torch.unique(self.blocks[0])
        used = ("pw", "pw16", "pl") + fused_expand._needed_tables(
            self.pieces, self.decode, self.kw["pack_cb"])
        row_bytes = sum(t[0].numel() * 4 for k, t in self.arrays.items()
                        if k in used)
        nb = int(self.blocks[0].shape[0])
        rows = int(emit.shape[0])
        state_rows = rows
        if self.decode == "windowed":
            state_rows = int(torch.clamp(self.blocks[1], 0,
                                         self.stride).sum())
        else:
            state_rows = int(emit.sum())
        nbytes = (8 * nb + self.blocks[2].numel() * 4
                  + int(words.numel()) * row_bytes
                  + self.arrays["desc"].numel() * 4
                  + rows + 4 * STATE_WORDS[self.algo] * state_rows)
        t_ops, t_bytes = ops / peak_ops, nbytes / HBM_BYTES_PER_S
        return (max(t_ops, t_bytes) * 1e3,
                "operations" if t_ops >= t_bytes else "bytes")


def win_geometry(case) -> "tuple[int, int, int]":
    """``(blocks per CTA, threads per CTA, dynamic shared bytes)`` of a
    windowed launch over ``case``'s tables, as ``csrc/piece_hash.cu``
    ``win_geometry`` sizes it."""
    from hashcat_a5_table_generator_tpu_torch.ops import fused_expand

    a, pieces = case.arrays, case.pieces
    m, k2 = int(a["radix"].shape[1]), int(a["win_v"].shape[2])
    suball, closed = pieces.kind == "suball", bool(pieces.closed)
    pack = case.kw["pack_cb"] and not closed
    ngw, ng16, ngd, vm, nw = fused_expand._table_dims(a)
    ncols = int(a["sel_bit" if pack else "sel_slot"].shape[1]) if suball \
        else 0
    close_s = int(a["close_next"].shape[2]) if closed else 0
    rec = max(1, m + (m + 1) * k2 + (m if suball and pack else 0)
              + ngw * vm * nw + ng16 * vm + ngd * vm + ncols
              + (m * close_s + m * (close_s + 1) if closed else 0))
    g = max(1, min(32, 24 * 1024 // 4 // rec))
    nt = 256 if case.hash_blocks == 1 else 128
    s_msg = (len(pieces.groups) * 16 + 6 * g + 2 + g * rec + 3) & ~3
    s_dig = s_msg + 16 * case.hash_blocks * nt
    return g, nt, 4 * (s_dig + (0 if pack else (m * nt + 3) // 4))


def windowed_edges(case):
    """``case`` cut to the windowed tier's CTA edges: five blocks fewer (a
    partial last CTA) and two blocks cut to counts 0 and 1, beside blocks
    of the full stride (the case's words must have some)."""
    import copy

    import torch

    edge = copy.copy(case)
    word, count, base = (t[:-5].clone() for t in case.blocks)
    count[3] = 0
    count[7] = torch.clamp(count[7], max=1)
    if not bool((count == case.stride).any()) or int(count[7]) != 1:
        fail(f"{case.name}: no blocks of the full stride to hold the edges")
    edge.blocks = (word, count, base)
    edge.name = f"{case.name}, CTA edges"
    return edge


def tile_edges(case):
    """``case`` cut to the scalar K=1 and pair tiers' CTA edges: five
    blocks fewer (a partial last CTA), blocks 3 and 7 cut to counts 0 and
    1, and blocks 32-63 (whole CTAs at any tile width the stride allows)
    cut to count 0, beside blocks of their full ranks."""
    import copy

    import torch

    edge = copy.copy(case)
    word, count, base = (t[:-5].clone() for t in case.blocks)
    count[3] = 0
    count[7] = torch.clamp(count[7], max=1)
    count[32:64] = 0
    ranks = case.stride * (2 if case.pair else 1)
    if not bool((count == ranks).any()) or int(count[7]) != 1:
        fail(f"{case.name}: no blocks of the full stride to hold the edges")
    edge.blocks = (word, count, base)
    edge.name = f"{case.name}, CTA edges"
    return edge


class BSCase:
    """One byte-scan kernel input at a given shape: blocks cut on the
    device from a real plan's index, with the byte-scan tier the
    reference's gate picks for the plan (``ops.bytescan.bytescan_tier``;
    the plan's piece schema, if any, is left unused, as under
    ``A5GEN_EMIT=bytescan``)."""

    def __init__(self, name, workload, words, sub, *, algo="md5", mx=15,
                 lanes=None, stride=STRIDE, width=None, mode="default",
                 mn=0, device):
        from hashcat_a5_table_generator_tpu_torch.models.attack import (
            AttackSpec, cut_blocks, device_arrays,
        )
        from hashcat_a5_table_generator_tpu_torch.ops import bytescan
        from hashcat_a5_table_generator_tpu_torch.ops import fused_expand
        from hashcat_a5_table_generator_tpu_torch.ops.blocks import (
            superstep_index,
        )
        from hashcat_a5_table_generator_tpu_torch.ops.membership import (
            build_digest_set,
        )

        self.name, self.algo, self.pair, self.stride = name, algo, False, stride
        self.spec = AttackSpec(mode=mode, algo=algo, min_substitute=mn,
                               max_substitute=mx)
        self.plan, self.ct, _pieces = plan_for(
            (workload, mode, mn, mx), sub, words, self.spec, width)
        if fused_expand.opts_for(self.spec, self.plan, self.ct) is None:
            fail(f"{name}: the plan takes the XLA route")
        self.tier = bytescan.bytescan_tier(self.plan)
        self.key = self.tier.launch_key(algo)
        self.decode = {"scalar": "scalar", "windowed": "windowed"}.get(
            self.tier.decode, "digits")
        idx = superstep_index(self.plan, stride)
        self.arrays = device_arrays(self.plan, None,
                                    build_digest_set([], algo), idx,
                                    device=device, ct=self.ct,
                                    bytescan=self.tier)
        nb = (lanes or LANES) // stride
        self.blocks = cut_blocks(self.arrays, 0, nb, stride, self.decode)[:3]
        self.hash_blocks = fused_expand._hash_blocks_for(
            self.plan.out_width, 2 if algo == "ntlm" else 1)
        self.kw = dict(tier=self.tier, block_stride=stride,
                       min_substitute=self.spec.effective_min,
                       max_substitute=self.spec.max_substitute, algo=algo)

    @property
    def variant(self) -> str:
        t = self.tier
        parts = [t.variant] if t.variant else []
        parts += ["closed"] if t.closed else []
        parts += [t.decode] if t.row != "scalar" or t.decode != "scalar" \
            else []
        return "+".join(parts)

    def kernel(self):
        from hashcat_a5_table_generator_tpu_torch.ops import bytescan

        return bytescan.bytescan_expand(
            *self.blocks, self.arrays, out_width=int(self.plan.out_width),
            **self.kw)

    def plain(self):
        from hashcat_a5_table_generator_tpu_torch.ops import bytescan

        return bytescan.bytescan_reference(
            *self.blocks, self.arrays, hash_blocks=self.hash_blocks,
            **self.kw)

    def bound(self, emit, peak_ops: float) -> "tuple[float, str]":
        """Least time for this input: one compression per emitted
        candidate over the INT32 peak, against each input byte read once
        (the block fields and the rows of the words the blocks touch) and
        each output byte written once over HBM bandwidth: an emit byte per
        row, state words per emitted row (dead rows get none)."""
        import torch

        from hashcat_a5_table_generator_tpu_torch.ops import bytescan

        ops = float(int(emit.sum())) * OPS_PER_BLOCK[self.algo]
        words = torch.unique(self.blocks[0])
        used = bytescan.needed_tables(self.tier)
        row_bytes = sum(t[0].numel() * t.element_size()
                        for k, t in self.arrays.items() if k in used)
        nb = int(self.blocks[0].shape[0])
        rows = int(emit.shape[0])
        nbytes = (8 * nb + self.blocks[2].numel() * 4
                  + int(words.numel()) * row_bytes
                  + rows + 4 * STATE_WORDS[self.algo] * int(emit.sum()))
        t_ops, t_bytes = ops / peak_ops, nbytes / HBM_BYTES_PER_S
        return (max(t_ops, t_bytes) * 1e3,
                "operations" if t_ops >= t_bytes else "bytes")


def compare(case) -> dict:
    """The case's kernel against its plain version on the card; the
    kernel call must move its launch counter and run no plain version."""
    import torch

    from hashcat_a5_table_generator_tpu_torch.ops import (
        bytescan, fused_expand,
    )

    mod = bytescan if case.key.startswith("bytescan") else fused_expand
    launches, plain = mod.LAUNCHES[case.key], mod.PLAIN_CALLS
    state_k, emit_k = case.kernel()
    if mod.LAUNCHES[case.key] != launches + 1 or mod.PLAIN_CALLS != plain:
        fail(f"{case.name}: the CUDA call did not launch {case.key} "
             "(or ran the plain version)")
    state_p, emit_p = case.plain()
    torch.cuda.synchronize()
    emit_mis = int((emit_k != emit_p).sum())
    both = emit_k & emit_p
    diff = (state_k.long() - state_p.long()).abs()[both]
    state_mis = int((diff != 0).any(dim=1).sum()) if diff.numel() else 0
    err = int(diff.max()) if diff.numel() else 0
    emitted = int(emit_p.sum())
    what = case.key + (f" {case.variant}" if hasattr(case, "tier") else "")
    log(f"kernel vs plain [{case.name}, {what}, {case.hash_blocks} "
        f"hash block(s)]: rows {emit_k.shape[0]}, emitted {emitted} "
        f"({100.0 * (1 - emitted / emit_k.shape[0]):.1f}% masked), emit "
        f"mismatches {emit_mis}, state mismatches {state_mis}, max abs "
        f"err {err} (tolerance 0)")
    if emit_mis or state_mis:
        fail(f"{case.name}: kernel disagrees with its plain version")
    if not emitted:
        fail(f"{case.name}: no emitted rows to compare")
    return {"mismatches": emit_mis + state_mis, "max_abs_err": err,
            "emit": emit_p}


def time_call(fn, reps: int) -> float:
    """Mean ms per call with CUDA events, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def stage_breakdown(case, digest_set, pair_k) -> None:
    """Where one main-path launch spends its device time: the superstep
    body's stages timed apart at the case's shapes against a 1M digest
    set of its hash."""
    import torch

    from hashcat_a5_table_generator_tpu_torch.models.attack import (
        cut_blocks, make_superstep_body, superstep_buffers,
    )
    from hashcat_a5_table_generator_tpu_torch.ops.membership import (
        digest_member,
    )

    dev = torch.device("cuda")
    arrays = dict(case.arrays)
    arrays["rows"] = torch.as_tensor(digest_set.rows.view(np.int32),
                                     device=dev)
    arrays["bitmap"] = torch.as_tensor(digest_set.bitmap.view(np.int32),
                                       device=dev)
    nb = int(case.blocks[0].shape[0])
    rank_stride = case.stride * (pair_k or 1)
    state, emit = case.kernel()
    tier = getattr(case, "tier", None)
    body = make_superstep_body(
        case.spec, num_lanes=nb * case.stride,
        out_width=int(case.plan.out_width), block_stride=case.stride,
        num_blocks=nb, pieces=None if tier else case.pieces, pair_k=pair_k,
        decode=case.decode, pack_cb=False if tier else case.kw["pack_cb"],
        k_opts=tier.k_opts if tier else case.kw["k_opts"], bytescan=tier,
    )
    bufs = superstep_buffers(4096, device=dev)
    t_cut = time_call(
        lambda: cut_blocks(arrays, 0, nb, rank_stride, case.decode), 10)
    t_kernel = time_call(case.kernel, 10)
    t_member = time_call(
        lambda: digest_member(state, arrays["rows"], arrays["bitmap"]), 3)
    t_step = time_call(lambda: body(arrays, 0, 1, bufs), 3)
    rest = t_step - t_cut - t_kernel - t_member
    log(f"stage breakdown [{case.name}, {case.key}], one launch "
        f"({emit.shape[0]} candidate rows, {int(emit.sum())} emitted, "
        f"{digest_set.size} {case.algo} digests), CUDA events: whole step "
        f"{t_step:.3f} ms = block cut {t_cut:.3f} ms + kernel "
        f"{t_kernel:.3f} ms + membership {t_member:.3f} ms + hit "
        f"compaction and the rest {rest:.3f} ms")


# ---------------------------------------------------------------------------
# Phase 4: the main path through the CLI
# ---------------------------------------------------------------------------


def reset_launches() -> tuple:
    """Every kernel wrapper's launch counters (and plain-version calls,
    and the buffer hash's launches by width) set to 0; the modules."""
    from hashcat_a5_table_generator_tpu_torch.ops import (
        buffer_hash, bytescan, fused_expand,
    )

    mods = (fused_expand, bytescan, buffer_hash)
    for mod in mods:
        for k in mod.LAUNCHES:
            mod.LAUNCHES[k] = 0
        mod.PLAIN_CALLS = 0
    buffer_hash.WIDTH_LAUNCHES.clear()
    return mods


def run_cli(argv) -> "tuple[bytes, str, int]":
    """``cli.main(argv)`` with stdout/stderr captured."""
    from hashcat_a5_table_generator_tpu_torch import cli

    out = io.BytesIO()
    real = sys.stdout
    sys.stdout = wrapper = io.TextIOWrapper(out, write_through=True)
    err = io.StringIO()
    try:
        with contextlib.redirect_stderr(err):
            try:
                rc = cli.main(list(argv))
            except SystemExit as e:  # a message exit: its text, then 1
                rc = e.code if isinstance(e.code, int) else 1
                if not isinstance(e.code, int):
                    print(e.code, file=sys.stderr)
    finally:
        wrapper.flush()
        wrapper.detach()
        sys.stdout = real
    return out.getvalue(), err.getvalue(), rc


@contextlib.contextmanager
def knobs(**env):
    """``A5GEN_*`` / ``A5_NATIVE`` variables set (or, given None, unset)
    for one block."""
    saved = {k: os.environ.pop(k, None) for k in env}
    try:
        for k, v in env.items():
            if v is not None:
                os.environ[k] = v
        yield
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


def unique_sources(cand: bytes, inverse: dict, words: set) -> int:
    """How many dictionary words can splice to ``cand``: every value
    character of the table stands for one of its keys (no dictionary word
    holds a value character), every other character for itself."""
    alts = [inverse.get(ch, [ch.encode()]) for ch in cand.decode("utf-8")]
    n = 0
    for combo in itertools.islice(itertools.product(*alts), 4096):
        n += b"".join(combo) in words
    return n


class SourceIndex:
    """Which dictionary words can produce a candidate, for tables whose
    keys and values are single characters: substitution only ever swaps a
    character for one of its connected component (keys linked to their
    values), so a source word has the candidate's component signature;
    the oracle of the run's mode then counts how often each such word
    emits the candidate."""

    def __init__(self, sub: dict, words: list, mode: str) -> None:
        chars = {}

        def find(c):
            while chars.setdefault(c, c) != c:
                c = chars[c]
            return c

        for key, vals in sub.items():
            for v in vals:
                k, u = key.decode("utf-8"), v.decode("utf-8")
                if len(k) != 1 or len(u) != 1:
                    fail(f"SourceIndex needs single-character keys and "
                         f"values, got {key!r} -> {v!r}")
                ra, rb = find(k), find(u)
                if ra != rb:
                    chars[ra] = rb
        self.lut = str.maketrans({c: find(c) for c in list(chars)})
        self.by_sig: dict = {}
        for i, w in enumerate(words):
            self.by_sig.setdefault(self.sig(w), []).append(i)
        self.words, self.sub, self.mode = words, sub, mode

    def sig(self, data: bytes) -> str:
        return data.decode("utf-8").translate(self.lut)

    def count(self, cand: bytes) -> int:
        """How many times the whole dictionary emits ``cand``."""
        from hashcat_a5_table_generator_tpu_torch.oracle.engines import (
            iter_candidates,
        )

        mode = self.mode
        n = 0
        for i in self.by_sig.get(self.sig(cand), []):
            n += sum(c == cand for c in iter_candidates(
                self.words[i], self.sub, 0, 15,
                substitute_all=mode.startswith("suball"),
                reverse=mode in ("reverse", "suball-reverse"),
                bug_compat=False))
        return n


class MainPath:
    """One configuration of the main path: a wordlist file and a digest
    file of its hash, 1000 planted hits decoded by the port's
    ``decode_variant`` (or, for oracle-fallback words, taken from the
    oracle) and hashed by ``HOST_DIGEST``, the host keyspace and the host
    plan's word routing.  ``quota`` plants at least that many hits in
    words of a route (``device_closed``, ``oracle_fallback``)."""

    def __init__(self, name, work, words, layout, algo, spec_kw, seed,
                 quota=None):
        from hashcat_a5_table_generator_tpu_torch.models.attack import (
            AttackSpec, build_plan, decode_variant,
        )
        from hashcat_a5_table_generator_tpu_torch.ops.membership import (
            build_digest_set,
        )
        from hashcat_a5_table_generator_tpu_torch.native import (
            read_packed_buckets,
        )
        from hashcat_a5_table_generator_tpu_torch.tables.compile import (
            compile_table,
        )
        from hashcat_a5_table_generator_tpu_torch.tables.layouts import (
            emit_table, get_layout,
        )
        from hashcat_a5_table_generator_tpu_torch.utils.digests import (
            HOST_DIGEST,
        )

        from hashcat_a5_table_generator_tpu_torch.oracle.engines import (
            iter_candidates,
        )

        self.name, self.algo = name, algo
        if isinstance(layout, dict):
            # A table of its own, written in $HEX[] notation.
            sub = layout
            self.table = os.path.join(work, f"{name}.table")
            with open(self.table, "wb") as fh:
                fh.write(b"".join(k + b"=$HEX[" + v.hex().encode() + b"]\n"
                                  for k, vs in sub.items() for v in vs))
            layout = name
        else:
            self.table = os.path.join(work, f"{layout}.table")
            emit_table(get_layout(layout), self.table)
            sub = get_layout(layout).to_substitution_map()
        self.wordlist = os.path.join(work, f"{name}.words.txt")
        with open(self.wordlist, "wb") as fh:
            fh.write(b"\n".join(words) + b"\n")
        spec = AttackSpec(algo=algo, **spec_kw)
        self.mode = spec.mode
        self.spec, self.sub = spec, sub
        ct = compile_table(sub)
        self.prep = {}
        t = time.monotonic()
        if spec.mode == "default" or layout == "german":
            # One option per key (german) or default mode: a candidate's
            # sources are the words its characters map back to.
            inverse: dict = {}
            for key, vals in sub.items():
                for v in vals:
                    inverse.setdefault(v.decode("utf-8"), []).append(key)
            word_set = set(words)

            def unique(cand):
                return unique_sources(cand, inverse, word_set) == 1
        else:
            index = SourceIndex(sub, words, spec.mode)

            def unique(cand):
                return index.count(cand) == 1
        self.prep["source index"] = time.monotonic() - t
        rng = np.random.default_rng(seed)
        quota = dict(quota or {})
        self.routing = {"device_clean": 0, "device_closed": 0,
                        "oracle_fallback": 0}
        self.planted_by_route: dict = {}
        t = time.monotonic()
        buckets = read_packed_buckets(self.wordlist)
        self.prep["read_packed_buckets"] = time.monotonic() - t
        self.planted, self.want_emitted = {}, 0
        #: planted digest -> the dictionary position of its one source word
        self.planted_word: dict = {}
        self.windowed = False
        for width, packed in buckets.items():
            t = time.monotonic()
            plan = build_plan(spec, ct, packed)
            self.prep["build_plan"] = self.prep.get("build_plan", 0.0) \
                + time.monotonic() - t
            self.windowed |= bool(plan.windowed)
            self.want_emitted += keyspace(plan, spec)
            if layout == "german":
                check_overlap_counts(plan, spec, packed, sub,
                                     f"main path [{name}] bucket {width}")
            fallback = np.asarray(plan.fallback, bool)
            closed = getattr(plan, "closed", None)
            closed = (np.zeros_like(fallback) if closed is None
                      else np.asarray(closed, bool))
            route = np.where(fallback, "oracle_fallback", np.where(
                closed, "device_closed", "device_clean"))
            for r in self.routing:
                self.routing[r] += int((route == r).sum())
            t = time.monotonic()
            oracle = {}
            for row in np.flatnonzero(fallback).tolist():
                oracle[row] = list(iter_candidates(
                    packed.word(row), sub, spec.min_substitute,
                    spec.max_substitute, substitute_all=True,
                    reverse=spec.mode == "suball-reverse"))
                self.want_emitted += len(oracle[row])
            self.prep["oracle (fallback words)"] = self.prep.get(
                "oracle (fallback words)", 0.0) + time.monotonic() - t
            share = packed.batch / len(words)
            want = {"all": max(1, round(N_PLANTED * share))}
            for r, n in quota.items():
                want[r] = max(1, round(n * share))
            for r, n in want.items():
                rows = rng.permutation(packed.batch)
                if r != "all":
                    rows = rows[route[rows] == r]
                got = 0
                for row in rows.tolist():
                    if got >= n:
                        break
                    # The middle candidate, else (a plaintext that another
                    # word or choice also emits) up to 7 more.
                    total = (len(oracle[row]) if row in oracle
                             else plan.n_variants[row])
                    for k in range(min(8, total - 1)):
                        at = (total // 2 + k * (total // 8 + 1)) % total
                        try:
                            cand = (oracle[row][at] if row in oracle else
                                    decode_variant(plan, ct, spec, row, at))
                        except ValueError:  # a rank the window masks
                            continue
                        dig = HOST_DIGEST[algo](cand).hex()
                        if dig not in self.planted and unique(cand):
                            break
                    else:
                        continue
                    self.planted[dig] = cand
                    self.planted_word[dig] = int(packed.index[row])
                    self.planted_by_route[str(route[row])] = \
                        self.planted_by_route.get(str(route[row]), 0) + 1
                    got += 1
        width = DIGEST_BYTES[algo]
        decoys = rng.integers(0, 256, size=(N_DIGESTS - len(self.planted),
                                            width), dtype=np.uint8)
        digest_rows = np.concatenate([
            np.frombuffer(b"".join(bytes.fromhex(d) for d in self.planted),
                          np.uint8).reshape(-1, width), decoys])
        t = time.monotonic()
        self.digest_set = build_digest_set(digest_rows, algo)
        self.digest_rows = digest_rows
        self.prep["build_digest_set (1M)"] = time.monotonic() - t
        self.digests = os.path.join(work, f"{name}.digests.txt")
        with open(self.digests, "w") as fh:
            fh.write("\n".join(list(self.planted) + [
                d.tobytes().hex() for d in decoys]) + "\n")
        self.buckets = {w: p.batch for w, p in buckets.items()}
        log(f"main path [{name}] inputs: {len(words)} words in buckets "
            f"{self.buckets}, {N_DIGESTS} {algo} digests ({len(self.planted)}"
            f" planted: {self.planted_by_route}), host keyspace "
            f"{self.want_emitted}, windowed {self.windowed}, routing "
            f"{self.routing}; host prep on this machine's CPU: "
            + ", ".join(f"{k} {v:.2f} s" for k, v in self.prep.items()))
        for r, n in quota.items():
            if self.planted_by_route.get(r, 0) < n:
                fail(f"main path [{name}]: {self.planted_by_route.get(r, 0)}"
                     f" plants in {r} words, want {n}")

    def run(self, arm, extra, card, emit_scheme=None, pallas=None,
            pair=None, native=None) -> dict:
        """One CLI run; ``emit_scheme`` sets ``A5GEN_EMIT`` for this run
        alone (``bytescan``: every plan on the byte-scan tiers), ``pallas``
        ``A5GEN_PALLAS`` (``off``: every bucket on the XLA route), ``pair``
        ``A5GEN_PAIR`` (``off``: K=1 everywhere), ``native`` ``A5_NATIVE``
        (``0``: the numpy packer and the Python oracle for fallback
        words; None leaves the variable as it is).  The run's ``native_words`` counts the fallback words the
        native oracle engine expanded.  A run
        with XLA-route buckets must stay within the route's memory budget
        over the whole run (its resident tables included)."""
        from hashcat_a5_table_generator_tpu_torch.native import (
            oracle_engine,
        )
        from hashcat_a5_table_generator_tpu_torch.ops import (
            buffer_hash, bytescan, fused_expand,
        )
        from hashcat_a5_table_generator_tpu_torch.runtime.sweep import (
            XLA_BUDGET_BYTES,
        )
        from hashcat_a5_table_generator_tpu_torch.utils.digests import (
            HOST_DIGEST,
        )

        mods = reset_launches()
        argv = [self.wordlist, "-t", self.table, "--backend", "device",
                "--algo", self.algo, "--digests", self.digests] + extra
        native_words = [0]
        iter_word = oracle_engine.NativeDefaultOracle.iter_word

        def counted(eng, *a, **kw):
            native_words[0] += 1
            return iter_word(eng, *a, **kw)

        oracle_engine.NativeDefaultOracle.iter_word = counted
        try:
            with knobs(A5GEN_EMIT=emit_scheme, A5GEN_PALLAS=pallas,
                       A5GEN_PAIR=pair, **({} if native is None
                                          else {"A5_NATIVE": native})):
                t = time.monotonic()
                res = []
                peak = launch_peak_bytes(lambda: res.append(run_cli(argv)))
                out, err, rc = res[0]
                wall = time.monotonic() - t
        finally:
            oracle_engine.NativeDefaultOracle.iter_word = iter_word
        launches = {k: v for mod in mods for k, v in mod.LAUNCHES.items()
                    if v}
        plain = sum(mod.PLAIN_CALLS for mod in mods)
        what = f"{self.name} ({arm})"
        if rc != 0:
            fail(f"main path {what} exited {rc}: {err}")
        lines = out.decode("utf-8", "surrogateescape").splitlines()
        hits = [ln.split(":", 1) for ln in lines]
        got = [bytes.fromhex(p[5:-1]) if p.startswith("$HEX[") else
               p.encode("utf-8", "surrogateescape") for _d, p in hits]
        for (d, _p), cand in zip(hits, got):
            if HOST_DIGEST[self.algo](cand).hex() != d:
                fail(f"{what}: printed hit does not re-hash: {d}")
        counts: dict = {}
        for cand in got:
            counts[cand] = counts.get(cand, 0) + 1
        missing = [c for c in self.planted.values() if counts.get(c, 0) != 1]
        if missing:
            fail(f"{what}: {len(missing)} planted hits not printed exactly "
                 f"once, e.g. {missing[:3]!r}")
        r = re.search(r"word routing: (\d+) device-clean, (\d+) "
                      r"device-closed, (\d+) oracle-fallback", err)
        got_routing = (dict(zip(self.routing, map(int, r.groups()))) if r
                       else {"device_clean": sum(self.routing.values()),
                             "device_closed": 0, "oracle_fallback": 0})
        if got_routing != self.routing:
            fail(f"{what}: word routing {got_routing}, host plan "
                 f"{self.routing}")
        m = re.search(r"(\d+) hits, (\d+) candidates hashed", err)
        s = re.search(r"([\d.]+) s wall, ([\d.]+) s (?:superstep|per-launch) "
                      r"drive, ([\d.e+]+) candidate-hashes/s", err)
        if not m or not s:
            fail(f"{what}: no summary on stderr: {err}")
        emitted = int(m.group(2))
        if emitted != self.want_emitted:
            fail(f"{what}: {emitted} candidates hashed, host keyspace "
                 f"{self.want_emitted}")
        if plain:
            fail(f"{what}: the plain version ran {plain} times on the main "
                 "path")
        # Rows: a kernel launch holds LANES lanes (x 2 on the pair tier);
        # the XLA route's launches, the rows the CLI prints for them.
        x = re.search(r"(\d+) lanes per XLA launch, (\d+) XLA candidate "
                      r"rows", err)
        xla_lanes, xla_rows = (int(x.group(1)), int(x.group(2))) if x \
            else (0, 0)
        rows = max(1, xla_rows + sum(
            v * LANES * (2 if "pair" in k else 1)
            for k, v in launches.items() if not k.startswith("buffer_")))
        routes = re.search(r"bucket routes: ([^\n]*)", err)
        budget = XLA_BUDGET_BYTES["cuda"]
        if xla_lanes and peak > budget:
            fail(f"{what}: the run held {peak} device bytes at its peak, "
                 f"over the XLA route's {budget} byte budget")
        log(f"main path {what}: {len(got)} hits ({len(self.planted)} "
            f"planted), {emitted} candidates hashed, launches {launches}, "
            f"{rows} candidate rows ({100.0 * (1 - emitted / rows):.1f}% "
            f"masked), bucket routes: "
            f"{routes.group(1) if routes else '?'}, device memory peak "
            f"{peak / 2**30:.3f} GiB above the run's start, CLI wall "
            f"{wall:.2f} s, "
            f"sweep {s.group(1)} s (drive {s.group(2)} s), {s.group(3)} "
            f"candidate-hashes/s on {card}"
            + (f"; {native_words[0]} of {self.routing['oracle_fallback']} "
               "fallback words on the native oracle engine"
               if self.routing["oracle_fallback"] else ""))
        return dict(hits=sorted(got), launches=launches, emitted=emitted,
                    widths=dict(buffer_hash.WIDTH_LAUNCHES),
                    wall=wall, sweep_wall=float(s.group(1)),
                    drive=float(s.group(2)), rate=float(s.group(3)),
                    stdout=out, xla_lanes=xla_lanes, peak_bytes=peak,
                    native_words=native_words[0], stderr=err)


def host_sorts(path: "MainPath") -> None:
    """The two host sorts every crack sweep runs per bucket over its
    digests, on one cell's 1M: the device set's unique rows
    (``membership._unique_rows``) and the host lookup's void rows
    (``membership._sorted_void_rows``), each timed beside the numpy call
    it stands for (``np.unique(axis=0)``, ``np.sort``) and equal to it."""
    from hashcat_a5_table_generator_tpu_torch.cli import _read_digests
    from hashcat_a5_table_generator_tpu_torch.ops import membership

    raw = _read_digests(path.digests, path.algo)
    rows = path.digest_set.rows[
        np.random.default_rng(0).permutation(path.digest_set.size)]
    t = {}
    for name, fn in (
            ("np.unique(axis=0)", lambda: np.unique(rows, axis=0)),
            ("_unique_rows", lambda: membership._unique_rows(rows)),
            ("np.sort(void)", lambda: np.sort(
                raw.view(f"V{raw.shape[1]}")[:, 0])),
            ("_sorted_void_rows", lambda: membership._sorted_void_rows(
                raw))):
        t0 = time.monotonic()
        t[name] = (fn(), time.monotonic() - t0)
    if not np.array_equal(t["np.unique(axis=0)"][0], t["_unique_rows"][0]) \
            or t["np.sort(void)"][0].tobytes() \
            != t["_sorted_void_rows"][0].tobytes():
        fail(f"host sorts [{path.name}]: differ from numpy's")
    secs = {k: v[1] for k, v in t.items()}
    log(f"host sorts [{path.name}, {rows.shape[0]} digests]: "
        + ", ".join(f"{k} {v:.3f} s" for k, v in secs.items())
        + " on this machine's CPU; each pair equal")


# ---------------------------------------------------------------------------
# The XLA expand + hash route (TPU kernel row 10 and its siblings)
# ---------------------------------------------------------------------------

BUFFER_BLOCKS = (1, 2, 3, 5)

#: XLA-route widths of the main path: 376 (cyrillic-x2-long's 200-byte
#: lines packed at their own width, as check_xla_memory and
#: xla_stage_breakdown launch them: 7 MD5 blocks), and 432 (the same lines
#: in the CLI's 256-byte bucket, what its sweeps launch most).
MAIN_XLA_WIDTH = 376
BUCKET_XLA_WIDTH = 432


def buffer_shapes(algo: str) -> list:
    """``(label, width)`` of every checked and timed buffer-hash shape: per
    block count the widest width it holds (NTLM doubles its width; odd:
    funnel-shifted loads) and three bytes less (a multiple of 4: aligned
    loads), and the main path's own XLA widths (:data:`MAIN_XLA_WIDTH`,
    :data:`BUCKET_XLA_WIDTH`)."""
    out = []
    for b in BUFFER_BLOCKS:
        width = (64 * b - 9) // (2 if algo == "ntlm" else 1)
        out.append((f"{b} block{'s' if b > 1 else ''}", width))
        out.append((f"{b} block{'s' if b > 1 else ''}, width % 4 == 0",
                    width - 3))
    out.append(("main path width", MAIN_XLA_WIDTH))
    out.append(("long-line bucket width", BUCKET_XLA_WIDTH))
    return out


def buffer_rows(width: int, seed: int, n: int = LANES):
    """``n`` seeded random rows of ``width`` bytes with lengths uniform in
    0..W, on the card."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    msg = torch.randint(0, 256, (n, width), dtype=torch.uint8,
                        device="cuda", generator=g)
    ln = torch.randint(0, width + 1, (n,), dtype=torch.int32,
                       device="cuda", generator=g)
    return msg, ln


#: Edge shapes held against the plain version (not timed): ``(label,
#: width, rows, byte offset of the buffer)``: widths of 0-3 bytes, 55/56
#: (funnel-shifted and aligned loads), 64, a row count that ends a CTA
#: part-way, buffers that are not 4-byte aligned (funnel-shifted loads at
#: every width; byte loads where an aligned word would leave the buffer),
#: and rows wider than the sweeps make.
BUFFER_EDGES = (
    ("width 0", 0, LANES, 0),
    ("width 1, partial CTA", 1, LANES - 5, 0),
    ("width 3, partial CTA", 3, LANES - 5, 0),
    ("width 55, partial CTA", 55, LANES - 5, 0),
    ("width 56, partial CTA", 56, LANES - 5, 0),
    ("width 64, partial CTA", 64, LANES - 5, 0),
    ("width 55, offset 1", 55, LANES, 1),
    ("width 376, offset 2", 376, LANES >> 2, 2),
    ("width 2101, offset 1", 2101, 1 << 16, 1),
)


def buffer_rows_at(width: int, n: int, offset: int, seed: int):
    """:func:`buffer_rows` whose buffer starts ``offset`` bytes into its
    allocation (a contiguous view that is not 16-byte aligned)."""
    import torch

    msg, ln = buffer_rows(width, seed=seed, n=n)
    if not offset or not width:
        return msg, ln
    raw = torch.empty(n * width + offset, dtype=torch.uint8, device="cuda")
    raw[offset:] = msg.reshape(-1)
    return raw[offset:].view(n, width), ln


def check_buffer_hash() -> dict:
    """``buffer_hash`` x hash x shape (:func:`buffer_shapes`: both load
    branches at 1, 2, 3 and 5 blocks, and the main path's width, at 2^22
    rows; and :data:`BUFFER_EDGES`) against its plain version on every row
    (tolerance 0), MD5 also against ``hashlib`` on 4096 rows; each CUDA
    call must move ``LAUNCHES`` and not ``PLAIN_CALLS``."""
    import hashlib

    import torch

    from hashcat_a5_table_generator_tpu_torch.ops import buffer_hash as bh

    out = {}
    for algo in ALGOS:
        shapes = [(label, width, LANES, 0)
                  for label, width in buffer_shapes(algo)] + list(BUFFER_EDGES)
        for label, width, n, offset in shapes:
            msg, ln = buffer_rows_at(width, n, offset, seed=width)
            key = f"buffer_hash/{algo}"
            launches, plain = bh.LAUNCHES[key], bh.PLAIN_CALLS
            got = bh.buffer_hash(msg, ln, algo)
            if bh.LAUNCHES[key] != launches + 1 or bh.PLAIN_CALLS != plain:
                fail(f"{key}: the CUDA call did not launch the kernel (or "
                     "ran the plain version)")
            want = bh.HASH_FNS[algo](msg, ln)
            torch.cuda.synchronize()
            diff = (got.long() - want.long()).abs()
            mis = int((diff != 0).any(dim=1).sum())
            err = int(diff.max())
            if algo == "md5":
                m, k = msg[:4096].cpu().numpy(), ln[:4096].cpu().numpy()
                st = got[:4096].cpu().numpy().view(np.uint32)
                mis += sum(st[i].astype("<u4").tobytes()
                           != hashlib.md5(m[i, :k[i]].tobytes()).digest()
                           for i in range(4096))
            loads = ("aligned" if width % 4 == 0 and not offset % 4
                     else "funnel-shifted")
            log(f"kernel vs plain [{key}, {label}, width {width}, {loads} "
                f"loads]: rows {n}, state mismatches "
                f"{mis}{' (hashlib on 4096 rows included)' if algo == 'md5' else ''}"
                f", max abs err {err} (tolerance 0)")
            if mis:
                fail(f"{key} [{label}, width {width}] disagrees with its "
                     "plain version")
            out[(algo, label)] = {"mismatches": mis, "max_abs_err": err}
            del msg, ln, got, want, diff
    return out


def compression_floor(peak_ops: float) -> dict:
    """ms per 2^22 compressions of each hash measured on this card: the
    buffer hash over 2^22 rows of width 0 (one compression each, nothing
    loaded; the lengths read and the states written, 84-101 MB, take
    under 0.03 ms of HBM) — what the rounds alone cost here, beside the
    INT32-peak figure the bounds use."""
    import torch

    from hashcat_a5_table_generator_tpu_torch.ops import buffer_hash as bh

    out = {}
    for algo in ALGOS:
        msg = torch.empty((LANES, 0), dtype=torch.uint8, device="cuda")
        ln = torch.zeros(LANES, dtype=torch.int32, device="cuda")
        out[algo] = time_call(lambda: bh.buffer_hash(msg, ln, algo), 20)
        peak_ms = LANES * OPS_PER_BLOCK[algo] / peak_ops * 1e3
        log(f"compression floor [{algo}]: {out[algo]:.4f} ms per {LANES} "
            f"compressions ({out[algo] / LANES * 1e9:.1f} ps each), "
            f"{out[algo] / peak_ms:.2f}x the INT32-peak figure "
            f"{peak_ms:.4f} ms ({OPS_PER_BLOCK[algo]} ops each)")
    return out


def time_buffer_hash(peak_ops: float, floor: dict) -> dict:
    """ms per call of ``buffer_hash`` and of its plain version at 2^22
    rows, per hash x shape, and the bound: the compressions these lengths
    need (each row its own ``ceil((len * scale + 9) / 64)``) over the
    INT32 peak, against the bytes the function must move over HBM — each
    row's first ``len`` bytes (all the kernel reads; NTLM widens them in
    registers), the lengths and the states, once each."""
    import torch

    from hashcat_a5_table_generator_tpu_torch.ops import buffer_hash as bh

    out = {}
    for algo in ALGOS:
        scale = 2 if algo == "ntlm" else 1
        for label, width in buffer_shapes(algo):
            msg, ln = buffer_rows(width, seed=width)
            ms = time_call(lambda: bh.buffer_hash(msg, ln, algo), 20)
            plain_ms = time_call(lambda: bh.HASH_FNS[algo](msg, ln), 1)
            comp = int(torch.div(ln.long() * scale + 72, 64,
                                 rounding_mode="floor").sum())
            ops = float(comp) * OPS_PER_BLOCK[algo]
            nbytes = int(ln.long().sum()) + 4 * ln.numel() \
                + 4 * STATE_WORDS[algo] * ln.numel()
            t_ops, t_bytes = ops / peak_ops, nbytes / HBM_BYTES_PER_S
            bound_ms = max(t_ops, t_bytes) * 1e3
            by = "operations" if t_ops >= t_bytes else "bytes"
            floor_ms = floor[algo] * comp / LANES
            out[(algo, label)] = dict(
                width=width, ms=ms, floor_ms=floor_ms,
                plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=by, compressions=comp, bytes=nbytes)
            log(f"buffer_hash/{algo} [{label}, width {width}, "
                f"{msg.shape[0]} rows, {comp} compressions, {nbytes} bytes]:"
                f" {ms:.4f} ms/launch; bound {bound_ms:.4f} ms ({by}; ops "
                f"{t_ops * 1e3:.4f} ms, bytes {t_bytes * 1e3:.4f} ms; "
                f"{100 * bound_ms / ms:.0f}% of it reached); compression "
                f"floor {floor_ms:.4f} ms ({100 * floor_ms / ms:.0f}% of it "
                f"reached); plain {plain_ms:.3f} ms")
            del msg, ln
    return out


def xla_launch(spec, sub, words, device, lanes, stride=STRIDE,
               digests=None, width=None):
    """One XLA-route launch's inputs on ``device``: the plan, its schema,
    the route's tables (``models.attack.xla_arrays``) and the first
    ``lanes // stride`` blocks."""
    from hashcat_a5_table_generator_tpu_torch.models.attack import (
        build_plan, cut_blocks, xla_arrays,
    )
    from hashcat_a5_table_generator_tpu_torch.ops.blocks import (
        superstep_index,
    )
    from hashcat_a5_table_generator_tpu_torch.ops.packing import (
        pack_words, piece_schema_for,
    )
    from hashcat_a5_table_generator_tpu_torch.tables.compile import (
        compile_table,
    )

    ct = compile_table(sub)
    plan = build_plan(spec, ct, pack_words(words, width=width))
    pieces = piece_schema_for(plan, ct)
    arrays = xla_arrays(plan, ct, pieces, digests,
                        superstep_index(plan, stride), device=device)
    windowed = bool(plan.windowed)
    word, count, base, rank0 = cut_blocks(
        arrays, 0, lanes // stride, stride,
        "windowed" if windowed else "digits")
    return plan, pieces, arrays, (word, count, base, rank0), windowed


def xla_kinds() -> dict:
    """One XLA-route plan per splice kind: ``kind -> (table, words,
    AttackSpec keywords, pair)``."""
    from hashcat_a5_table_generator_tpu_torch.tables.layouts import (
        get_layout,
    )

    cyr = get_layout("qwerty-cyrillic").to_substitution_map()
    german = get_layout("german").to_substitution_map()
    azerty = get_layout("qwerty-azerty").to_substitution_map()
    words = synth_words(4000, seed=61)
    gwords = [w for w in german_words(20000, seed=62) if b"ss" in w]
    longs = long_lines(200, seed=63) + letter_lines(100, seed=64)
    return {
        "match piece": (cyr, words, {}, False),
        "match pair": (cyr, words, {}, True),
        "match schema-less (german sss)": (
            german, [w for w in gwords if b"sss" in w], {}, False),
        "match windowed, long lines": (cyr, longs, {"max_substitute": 2},
                                       False),
        "match nine options": (LEET9, words, {}, False),
        "suball piece": (cyr, words, {"mode": "suball"}, False),
        "suball schema-less (A5GEN_EMIT=bytescan)": (
            cyr, words, {"mode": "suball"}, False),
        "suball closed": (azerty, azerty_lines(4000, seed=65),
                          {"mode": "suball"}, False),
    }


def check_xla_expansion() -> dict:
    """The XLA route's torch expansion (``models.attack._expand``) on the
    card against the same call on the CPU, for one plan per splice kind:
    every lane's length, word row, emit and ``cand[:len]`` equal."""
    import torch

    from hashcat_a5_table_generator_tpu_torch.models.attack import (
        AttackSpec, _expand, _xla_base,
    )

    kinds = xla_kinds()
    out = {}
    for kind, (sub, ws, kw, pair) in kinds.items():
        # 2^16 lanes; 2^14 for the long lines (376 bytes a row: the CPU's
        # expansion took ~20 s at 2^16).
        lanes = 1 << (14 if "long lines" in kind else 16)
        spec = AttackSpec(**kw)
        res = []
        for dev in (torch.device("cuda"), torch.device("cpu")):
            k = 2 if pair else 1
            with knobs(A5GEN_EMIT="bytescan" if "A5GEN_EMIT" in kind
                       else None):
                plan, pieces, arrays, (word, count, base, _), win = \
                    xla_launch(spec, sub, ws, dev, lanes * k,
                               stride=STRIDE * k)
            if pair and not (pieces is not None and pieces.pair_ok):
                fail(f"XLA expansion [{kind}]: the plan is not "
                     "pair-eligible")
            if "schema-less" in kind and pieces is not None:
                fail(f"XLA expansion [{kind}]: the plan has a schema")
            got = _expand(spec, arrays, word, count,
                          _xla_base(arrays, base, win), num_lanes=lanes,
                          out_width=int(plan.out_width), block_stride=STRIDE,
                          radix2=int(plan.pat_radix.max()) <= 2,
                          pieces=pieces, pair_k=2 if pair else None)
            res.append([t.cpu() for t in got])
        (gc, gl, gw, ge), (wc, wl, ww, we) = res
        o = torch.arange(wc.shape[1])[None, :]
        live = o < wl.clamp(min=0)[:, None]
        mis = int((gl != wl).sum() + (gw != ww).sum() + (ge != we).sum()
                  + ((gc != wc) & live).any(dim=1).sum())
        log(f"XLA expansion on the card vs the CPU [{kind}]: "
            f"{gl.shape[0]} rows, {int(we.sum())} emitted, out_width "
            f"{wc.shape[1]}, schema {'yes' if pieces is not None else 'no'}"
            f", mismatches {mis} (tolerance 0)")
        if mis or not int(we.sum()):
            fail(f"XLA expansion [{kind}]: the card disagrees with the CPU")
        out[kind] = mis
    return out


def launch_peak_bytes(fn) -> int:
    """Device bytes ``fn()`` allocates at its peak above what was allocated
    before it (``torch.cuda.max_memory_allocated``), its result included."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    return peak


def check_xla_memory(main_plans: dict) -> dict:
    """One XLA-route launch per splice kind (:func:`xla_kinds`, a
    substitute-all plan over long lines, and ``main_plans``: the main
    path's own) at the lanes the sweep picks (``runtime.sweep.xla_lanes``
    within ``XLA_BUDGET_BYTES["cuda"]``): the crack superstep body (one
    step: cut, expansion, buffer hash, membership, hit compaction) and,
    without the pair tier, the candidates body, each measured with
    :func:`launch_peak_bytes`.  Fails if a launch holds more than the
    budget, or more bytes per candidate row than the sweep's estimate
    (``xla_row_bytes``, which the budget rests on)."""
    import torch

    from hashcat_a5_table_generator_tpu_torch.models.attack import (
        AttackSpec, make_candidates_body, make_superstep_body,
        superstep_buffers,
    )
    from hashcat_a5_table_generator_tpu_torch.ops.fused_expand import (
        k_opts_for,
    )
    from hashcat_a5_table_generator_tpu_torch.ops.membership import (
        build_digest_set,
    )
    from hashcat_a5_table_generator_tpu_torch.runtime.sweep import (
        XLA_BUDGET_BYTES, xla_lanes, xla_row_bytes,
    )
    from hashcat_a5_table_generator_tpu_torch.tables.layouts import (
        get_layout,
    )

    budget = XLA_BUDGET_BYTES["cuda"]
    dev = torch.device("cuda")
    rng = np.random.default_rng(66)
    kinds = dict(xla_kinds())
    kinds["suball windowed, long lines"] = (
        get_layout("qwerty-cyrillic").to_substitution_map(),
        long_lines(200, seed=63), {"mode": "suball", "max_substitute": 2},
        False)
    kinds.update(main_plans)
    out = {}
    for kind, (sub, ws, kw, pair) in kinds.items():
        spec = AttackSpec(**kw)
        k = 2 if pair else 1
        digests = [rng.bytes(20 if spec.algo == "sha1" else 16)
                   for _ in range(100_000)]
        with knobs(A5GEN_EMIT="bytescan" if "A5GEN_EMIT" in kind
                   else None):
            plan, pieces, arrays, _blocks, win = xla_launch(
                spec, sub, ws, dev, STRIDE * k, stride=STRIDE * k,
                digests=build_digest_set(digests, spec.algo))
            _p, _s, cand_arrays, _b, _w = xla_launch(
                spec, sub, ws, dev, STRIDE, stride=STRIDE)
        lanes = xla_lanes(plan, LANES, STRIDE, k, budget)
        nb = lanes // STRIDE
        geom = dict(num_lanes=lanes, out_width=int(plan.out_width),
                    block_stride=STRIDE, num_blocks=nb, pieces=pieces,
                    windowed=win, radix2=k_opts_for(plan) == 1)
        body = make_superstep_body(spec, pair_k=2 if pair else None,
                                   xla=True, **geom)
        bufs = superstep_buffers(4096, device=dev)
        est = xla_row_bytes(plan)
        rows = lanes * k
        res = {"lanes": lanes, "rows": rows, "estimate_per_row": est,
               "crack_peak": launch_peak_bytes(
                   lambda: body(arrays, 0, 1, bufs))}
        if not pair:
            cbody = make_candidates_body(spec, **geom)
            res["candidates_peak"] = launch_peak_bytes(
                lambda: cbody(cand_arrays, 0))
        for what in ("crack", "candidates"):
            peak = res.get(f"{what}_peak")
            if peak is None:
                continue
            log(f"XLA-route memory [{kind}, {what}]: token width "
                f"{plan.tokens.shape[1]}, out_width {plan.out_width}, "
                f"{plan.num_slots} slots, "
                f"{int(getattr(plan, 'num_segments', 0) or 0)} segments, "
                f"{spec.algo}; {lanes} lanes, {rows} rows; peak "
                f"{peak} bytes ({peak / 2**30:.3f} GiB of the "
                f"{budget >> 30} GiB budget), {peak / rows:.1f} bytes per "
                f"row against the estimate's {est} "
                f"({peak / rows / est:.2f}x)")
            if peak > budget or peak > est * rows:
                fail(f"XLA-route memory [{kind}, {what}]: one launch held "
                     f"{peak} bytes, over the {budget} byte budget or the "
                     f"estimate's {est} bytes per row")
        out[kind] = res
        del arrays, cand_arrays, body, bufs
    return out


def xla_stage_breakdown(spec, sub, words, digest_set) -> None:
    """One XLA-route launch's device time by stage, CUDA events: block
    cut, expansion, buffer hash, membership against the run's 1M-digest
    set, and the rest (hit compaction)."""
    import torch

    from hashcat_a5_table_generator_tpu_torch.models.attack import (
        _expand, _xla_base, cut_blocks, make_superstep_body,
        superstep_buffers,
    )
    from hashcat_a5_table_generator_tpu_torch.ops.buffer_hash import (
        buffer_hash,
    )
    from hashcat_a5_table_generator_tpu_torch.ops.membership import (
        digest_member,
    )
    from hashcat_a5_table_generator_tpu_torch.runtime.sweep import (
        XLA_BUDGET_BYTES, xla_lanes,
    )

    dev = torch.device("cuda")
    plan, pieces, arrays, (word, count, base, _), win = xla_launch(
        spec, sub, words, dev, STRIDE, digests=digest_set)
    lanes = xla_lanes(plan, LANES, STRIDE, 1, XLA_BUDGET_BYTES["cuda"])
    nb = lanes // STRIDE
    decode = "windowed" if win else "digits"
    common = dict(num_lanes=lanes, out_width=int(plan.out_width),
                  block_stride=STRIDE, radix2=int(plan.pat_radix.max()) <= 2,
                  pieces=pieces)
    blocks = cut_blocks(arrays, 0, nb, STRIDE, decode)
    full_base = _xla_base(arrays, blocks[2], win)
    cand, clen, _, emit = _expand(spec, arrays, blocks[0], blocks[1],
                                  full_base, **common)
    state = buffer_hash(cand, clen, spec.algo)
    body = make_superstep_body(
        spec, num_lanes=lanes, out_width=int(plan.out_width),
        block_stride=STRIDE, num_blocks=nb, pieces=pieces, xla=True,
        windowed=win, radix2=common["radix2"])
    bufs = superstep_buffers(4096, device=dev)
    t_cut = time_call(lambda: cut_blocks(arrays, 0, nb, STRIDE, decode), 5)
    t_exp = time_call(lambda: _expand(spec, arrays, blocks[0], blocks[1],
                                      full_base, **common), 3)
    t_hash = time_call(lambda: buffer_hash(cand, clen, spec.algo), 5)
    t_member = time_call(
        lambda: digest_member(state, arrays["rows"], arrays["bitmap"]), 3)
    t_step = time_call(lambda: body(arrays, 0, 1, bufs), 3)
    rest = t_step - t_cut - t_exp - t_hash - t_member
    log(f"XLA-route stage breakdown [token width {plan.tokens.shape[1]}, "
        f"out_width {plan.out_width}, {plan.num_slots} slots, "
        f"{'windowed' if win else 'full'}, schema "
        f"{'yes' if pieces is not None else 'no'}, {spec.algo}], one launch "
        f"({lanes} lanes within the {XLA_BUDGET_BYTES['cuda'] >> 30} GiB "
        f"budget, {int(emit.sum())} emitted, {digest_set.size} digests), "
        f"CUDA events: whole step {t_step:.3f} ms = block cut {t_cut:.3f} "
        f"ms + expansion {t_exp:.3f} ms + buffer hash {t_hash:.3f} ms + "
        f"membership {t_member:.3f} ms + the rest {rest:.3f} ms")


def dictionary(n: int, seed: int, long_lines: bool = True) -> list:
    """Phase 4's word lists: ``n`` unique recipe words (qwerty-cyrillic
    and czech map letters one-to-one, so distinct words never share a
    candidate; greek-hebrew and qwerty-azerty do not, and
    :class:`MainPath` plants only plaintexts with one source), with 120
    long words at seeded places unless ``long_lines`` is false."""
    out = list(dict.fromkeys(synth_words(n + 1000, seed=seed)))
    out = out[: n - (120 if long_lines else 0)]
    if long_lines:
        rng = np.random.default_rng(4)
        for w in long_words(100, 33, 64, (4, 10), seed=5) + \
                long_words(20, 50, 64, (3, 8), seed=6):
            out.insert(int(rng.integers(0, len(out))), w)
    return out


def long_lines(n: int, seed: int) -> list:
    """Rockyou's long lines: lowercase words of 3-9 letters joined by
    spaces, 65-200 bytes (a token width over 64: the XLA route)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        want = int(rng.integers(65, 201))
        parts, size = [], -1
        while size < want:
            w = bytes(rng.integers(ord("a"), ord("z") + 1,
                                   size=int(rng.integers(3, 10)),
                                   dtype=np.uint8))
            parts.append(w)
            size += len(w) + 1
        out.append(b" ".join(parts)[:want])
    return out


def letter_lines(n: int, seed: int) -> list:
    """Lines of 25-40 letters within 64 bytes (the rest digits): more than
    24 substitution slots, the XLA route."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = int(rng.integers(25, 41))
        ln = int(rng.integers(k, 65))
        w = rng.integers(ord("0"), ord("9") + 1, size=ln, dtype=np.uint8)
        pos = rng.choice(ln, size=k, replace=False)
        w[pos] = rng.integers(ord("a"), ord("z") + 1, size=k, dtype=np.uint8)
        out.append(bytes(w))
    return out


def candidates_checks(work: str, dictionary, card: str) -> dict:
    """Candidates mode through the CLI on the card: qwerty-cyrillic over
    2e4 words (line count = the host keyspace; the first 2000 words
    byte-identical to a ``--device cpu`` run; per word the oracle's
    multiset on 200 sampled words), and qwerty-azerty ``-s`` with
    oracle-fallback words interleaved (byte-identical to the CPU run of
    the same list) and ``-s -r``.  Every run passes ``--output``: the
    stream stays on stdout and the file is not written, as in the
    reference.  Returns each cell's wordlist, table and stdout for the
    oracle backend's phase."""
    from hashcat_a5_table_generator_tpu_torch.models.attack import (
        AttackSpec, build_plan,
    )
    from hashcat_a5_table_generator_tpu_torch.ops import buffer_hash
    from hashcat_a5_table_generator_tpu_torch.ops.packing import pack_words
    from hashcat_a5_table_generator_tpu_torch.oracle.engines import (
        iter_candidates,
    )
    from hashcat_a5_table_generator_tpu_torch.tables.compile import (
        compile_table,
    )
    from hashcat_a5_table_generator_tpu_torch.tables.layouts import (
        emit_table, get_layout,
    )

    cells = {}

    def run(words, layout, name, extra, device="cuda"):
        wl = os.path.join(work, f"{name}.words.txt")
        with open(wl, "wb") as fh:
            fh.write(b"\n".join(words) + b"\n")
        table = os.path.join(work, f"{layout}.table")
        emit_table(get_layout(layout), table)
        out = os.path.join(work, f"{name}.out")
        t = time.monotonic()
        data, err, rc = run_cli([wl, "-t", table, "--backend", "device",
                                 "--output", out, "--device", device]
                                + extra)
        wall = time.monotonic() - t
        if rc != 0:
            fail(f"candidates [{name}] exited {rc}: {err}")
        if os.path.exists(out):
            fail(f"candidates [{name}]: --output {out} was written; it "
                 "names --emit-table's file only")
        n = int(re.search(r"(\d+) candidates written", err).group(1))
        s = re.search(r"([\d.]+) s wall, ([\d.]+) s launch loop, "
                      r"([\d.e+]+) candidates/s", err)
        log(f"candidates [{name}] on {device}: {n} candidates, "
            f"{len(data)} bytes on stdout, CLI wall {wall:.2f} s, sweep "
            f"{s.group(1)} s (launch loop {s.group(2)} s, {s.group(3)} "
            "candidates/s)" + (f" on {card}" if device == "cuda" else ""))
        cells[name] = dict(words=words, wordlist=wl, table=table,
                           flags=extra, stdout=data)
        return data, n

    for k in buffer_hash.LAUNCHES:
        buffer_hash.LAUNCHES[k] = 0
    cyr = get_layout("qwerty-cyrillic").to_substitution_map()
    words = dictionary(20000, seed=71, long_lines=False)
    data, n = run(words, "qwerty-cyrillic", "cand-cyrillic", [])
    if any(buffer_hash.LAUNCHES.values()):
        fail("candidates mode hashed")
    spec = AttackSpec()
    plan = build_plan(spec, compile_table(cyr), pack_words(words))
    opts = (np.asarray(plan.pat_radix, np.int64) - 1).clip(min=0)
    e = np.zeros((opts.shape[0], opts.shape[1] + 1), np.int64)
    e[:, 0] = 1
    for s_ in range(opts.shape[1]):
        e[:, 1:] = e[:, 1:] + opts[:, s_:s_ + 1] * e[:, :-1]
    per_word = e[:, spec.effective_min:spec.max_substitute + 1].sum(axis=1)
    lines = data.split(b"\n")[:-1]
    if n != len(lines) or len(lines) != int(per_word.sum()):
        fail(f"candidates [cand-cyrillic]: {len(lines)} lines, {n} written, "
             f"host keyspace {int(per_word.sum())}")
    head, _hn = run(words[:2000], "qwerty-cyrillic", "cand-cyrillic-cpu",
                    ["--lanes", "65536"], device="cpu")
    if data[:len(head)] != head:
        fail("candidates [cand-cyrillic]: the first 2000 words differ from "
             "the --device cpu run")
    at = np.concatenate([[0], np.cumsum(per_word)])
    rng = np.random.default_rng(72)
    for w in rng.choice(len(words), size=200, replace=False).tolist():
        got = sorted(lines[at[w]:at[w + 1]])
        if got != sorted(iter_candidates(words[w], cyr, 0, 15)):
            fail(f"candidates [cand-cyrillic]: word {words[w]!r} is not "
                 "the oracle's multiset")
    log(f"candidates [cand-cyrillic]: {len(lines)} lines = the host "
        f"keyspace; first 2000 words ({len(head)} bytes) byte-identical to "
        "the --device cpu run; 200 sampled words = the oracle's multisets")
    az_words = dictionary(4000, seed=73, long_lines=False)
    rng = np.random.default_rng(74)
    for w in dict.fromkeys(azerty_lines(400, seed=75)):
        az_words.insert(int(rng.integers(0, len(az_words))), w)
    gpu, n_gpu = run(az_words, "qwerty-azerty", "cand-azerty-s", ["-s"])
    cpu, n_cpu = run(az_words, "qwerty-azerty", "cand-azerty-s-cpu",
                     ["-s", "--lanes", "65536"], device="cpu")
    if gpu != cpu or n_gpu != n_cpu:
        fail("candidates [cand-azerty-s]: the card's stream differs from "
             "the --device cpu run")
    azerty = get_layout("qwerty-azerty").to_substitution_map()
    plan = build_plan(AttackSpec(mode="suball"), compile_table(azerty),
                      pack_words(az_words))
    fallback = np.flatnonzero(plan.fallback)
    if len(fallback) < 50:
        fail(f"candidates [cand-azerty-s]: {len(fallback)} oracle words")
    log(f"candidates [cand-azerty-s]: {n_gpu} candidates, "
        f"{len(fallback)} oracle-fallback words interleaved; byte-identical "
        "to the --device cpu run")
    run(az_words, "qwerty-azerty", "cand-azerty-s-r", ["-s", "-r"])
    return cells


# ---------------------------------------------------------------------------
# The oracle backend (the CLI's default): native C++ engines on the host
# ---------------------------------------------------------------------------

#: Words of the crack cell the oracle crack takes: its host lookup costs
#: ~8 us a candidate (a binary search over the 1M digests), so the whole
#: cell would take minutes on the host's cores (25,000 until phase 12
#: came: cut for the script's time).
ORACLE_CRACK_WORDS = 10_000


def host_cpu() -> "tuple[str, int]":
    """The host CPU's model name (``lscpu``, else ``/proc/cpuinfo``, else
    ``platform``) and ``nproc``; where none names it, what each said is
    logged."""
    import platform

    model, tried = "", []
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True,
                             timeout=30)
        model = next((ln.split(":", 1)[1].strip() for ln in
                      out.stdout.splitlines()
                      if ln.strip().startswith("Model name")), "")
        tried.append(f"lscpu exit {out.returncode}: {out.stdout[:300]!r} "
                     f"{out.stderr[:200]!r}")
    except (OSError, subprocess.SubprocessError) as e:
        tried.append(f"lscpu: {e}")
    if not model:
        try:
            with open("/proc/cpuinfo") as fh:
                info = fh.read()
            model = next((ln.split(":", 1)[1].strip() for ln in
                          info.splitlines() if ln.startswith(
                              ("model name", "Model name", "cpu model"))),
                         "")
            tried.append(f"/proc/cpuinfo: {info[:300]!r}")
        except OSError as e:
            tried.append(f"/proc/cpuinfo: {e}")
    if not model:
        model = platform.processor() or platform.machine()
        log(f"host CPU model not named by lscpu or /proc/cpuinfo "
            f"({'; '.join(tried)}); platform says {model!r}")
    nproc = int(subprocess.run(["nproc"], capture_output=True, text=True,
                               timeout=30, check=True).stdout)
    return model or "unknown", nproc


def oracle_cli(argv, native=True, timeout=300) -> "tuple[bytes, str, float]":
    """``python -m hashcat_a5_table_generator_tpu_torch ARGV`` in a process
    of its own (the CLI as a user starts it: ``--threads`` forks from a
    process that never touched CUDA), ``A5_NATIVE=0`` unless ``native``;
    (stdout, stderr, wall s).  A run past ``timeout`` is killed with its
    worker processes and fails the smoke."""
    env = {k: v for k, v in os.environ.items() if k != "A5_NATIVE"}
    if not native:
        env["A5_NATIVE"] = "0"
    t = time.monotonic()
    proc = spawn(
        [sys.executable, "-m", "hashcat_a5_table_generator_tpu_torch",
         *argv], cwd=HERE, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        proc.communicate()
        fail(f"oracle CLI {argv} ran past {timeout} s")
    wall = time.monotonic() - t
    err = err.decode("utf-8", "replace")
    if proc.returncode != 0:
        fail(f"oracle CLI {argv} exited {proc.returncode}: {err[-2000:]}")
    return out, err, wall


def oracle_phase(work: str, cells: dict, crack, crack_run: dict,
                 card: str) -> dict:
    """The oracle backend on this machine: the default command line (no
    ``--backend``) over the candidates cells' words, its sorted lines
    equal to the card's run's and its count to the host keyspace
    (``oracle.keyspace``), ``--threads N`` byte-identical to ``--threads
    1``, ``A5_NATIVE=0`` byte-identical on the first 2000 words; the
    oracle crack (``--threads N``) over the crack cell's first
    :data:`ORACLE_CRACK_WORDS` words and its 1M digests, its hits equal
    to the card's on those words; ``--emit-table`` for every layout and
    ``--list-layouts``.  Returns the phase's numbers."""
    from hashcat_a5_table_generator_tpu_torch.oracle.keyspace import (
        count_candidates,
    )
    from hashcat_a5_table_generator_tpu_torch.tables.layouts import (
        BUILTIN_LAYOUTS, DERIVED_LAYOUTS, get_layout,
    )

    t_phase = time.monotonic()
    model, nproc = host_cpu()
    threads = min(nproc, 16)
    host = f"host CPU {model}, nproc {nproc}; card {card}"
    _o, _e, startup = oracle_cli(["--list-layouts"])
    report = {"host_cpu": model, "nproc": nproc, "threads": threads,
              "card": card, "startup_s": startup, "candidates": {}}
    for name in ("cand-cyrillic", "cand-azerty-s", "cand-azerty-s-r"):
        cell = cells[name]
        flags, words = cell["flags"], cell["words"]
        argv = [cell["wordlist"], "-t", cell["table"], *flags]
        t1, _e, w1 = oracle_cli(argv + ["--threads", "1"])
        tn, _e, wn = oracle_cli(argv + ["--threads", str(threads)])
        if tn != t1:
            fail(f"oracle [{name}]: --threads {threads} differs from "
                 "--threads 1")
        head = os.path.join(work, f"{name}.head.txt")
        with open(head, "wb") as fh:
            fh.write(b"\n".join(words[:2000]) + b"\n")
        py, _e, wp = oracle_cli([head, "-t", cell["table"], *flags,
                                 "--threads", "1"], native=False)
        if not t1.startswith(py):
            fail(f"oracle [{name}]: A5_NATIVE=0 on the first 2000 words "
                 "differs from the native stream")
        sub = get_layout(os.path.basename(cell["table"])[:-6]
                         ).to_substitution_map()
        kw = dict(substitute_all="-s" in flags, reverse="-r" in flags)
        keyspace = sum(count_candidates(w, sub, 0, 15, **kw) for w in words)
        head_ks = sum(count_candidates(w, sub, 0, 15, **kw)
                      for w in words[:2000])
        lines = t1.split(b"\n")[:-1]
        py_lines = py.count(b"\n")
        if len(lines) != keyspace or py_lines != head_ks:
            fail(f"oracle [{name}]: {len(lines)} lines (A5_NATIVE=0 "
                 f"{py_lines}), host keyspace {keyspace} ({head_ks})")
        if sorted(lines) != sorted(cell["stdout"].split(b"\n")[:-1]):
            fail(f"oracle [{name}]: the sorted lines differ from the "
                 "card's candidates run")
        rates = {"native_t1": len(lines) / w1,
                 f"native_t{threads}": len(lines) / wn,
                 "python_t1": head_ks / wp}
        report["candidates"][name] = dict(
            words=len(words), lines=len(lines), wall_native_t1=w1,
            **{f"wall_native_t{threads}": wn}, python_words=2000,
            python_lines=head_ks, wall_python_t1=wp, lines_per_s=rates)
        log(f"oracle [{name}] {' '.join(flags) or 'default'}: {len(lines)} "
            f"lines = the host keyspace, sorted = the card's run; "
            f"--threads {threads} byte-identical to 1; A5_NATIVE=0 "
            f"identical on the first 2000 words ({head_ks} lines); process "
            f"walls native t1 {w1:.3f} s, t{threads} {wn:.3f} s, Python t1 "
            f"{wp:.3f} s (start-up {startup:.3f} s included): "
            + ", ".join(f"{k} {v:.6g} lines/s" for k, v in rates.items())
            + f"; {host}")
    # The crack cell's device hits, cut to the oracle's words: every
    # printed hit is a planted one, whose one source word is known.
    with open(crack.wordlist, "rb") as fh:
        all_words = fh.read().split(b"\n")[:-1]
    cut = os.path.join(work, "oracle-crack.words.txt")
    with open(cut, "wb") as fh:
        fh.write(b"\n".join(all_words[:ORACLE_CRACK_WORDS]) + b"\n")
    want = []
    for ln in crack_run["stdout"].split(b"\n")[:-1]:
        dig = ln.split(b":", 1)[0].decode()
        if dig not in crack.planted_word:
            fail(f"oracle crack: device hit {ln[:60]!r} is not planted; its "
                 "word is unknown, so the cut cannot be held to it")
        if crack.planted_word[dig] < ORACLE_CRACK_WORDS:
            want.append(ln)
    sub = get_layout("qwerty-cyrillic").to_substitution_map()
    n_cands = sum(count_candidates(w, sub, 0, 15)
                  for w in all_words[:ORACLE_CRACK_WORDS])
    out, err, wall = oracle_cli(
        [cut, "-t", crack.table, "--backend", "oracle", "--threads",
         str(threads), "--algo", crack.algo, "--digests", crack.digests])
    got = out.split(b"\n")[:-1]
    m = re.search(r"(\d+) hits", err)
    if sorted(got) != sorted(want) or not m or int(m.group(1)) != len(want):
        fail(f"oracle crack: {len(got)} hits ({m and m.group(1)} on "
             f"stderr), the card's run has {len(want)} on these words")
    if len(want) < 50:
        fail(f"oracle crack: only {len(want)} planted hits in the cut")
    report["crack"] = dict(words=ORACLE_CRACK_WORDS,
                           of_words=len(all_words), digests=N_DIGESTS,
                           candidates=n_cands, hits=len(got), wall_s=wall,
                           candidates_per_s=n_cands / wall)
    log(f"oracle crack [{crack.name}, cut to the first "
        f"{ORACLE_CRACK_WORDS} of {len(all_words)} words]: {len(got)} hits "
        f"= the card's hits on those words (sorted), {n_cands} candidates "
        f"hashed on the host, --threads {threads}, process wall {wall:.3f} "
        f"s ({n_cands / wall:.6g} candidates/s); {host}")
    layouts = sorted(BUILTIN_LAYOUTS) + sorted(DERIVED_LAYOUTS)
    for name in layouts:
        out, err, rc = run_cli(["--emit-table", name])
        if rc != 0 or not out:
            fail(f"--emit-table {name}: exit {rc}, {len(out)} bytes: {err}")
    out, err, rc = run_cli(["--list-layouts"])
    if rc != 0 or out.count(b"\n") != len(layouts):
        fail(f"--list-layouts: exit {rc}: {out[:200]!r} {err}")
    report["emit_table_layouts"] = len(layouts)
    report["phase_s"] = time.monotonic() - t_phase
    log(f"--emit-table for {len(layouts)} layouts and --list-layouts: exit "
        f"0, non-empty; oracle phase {report['phase_s']:.1f} s")
    return report


# ---------------------------------------------------------------------------
# Phase 7: robustness — kill and resume, retries, the watchdog, telemetry
# ---------------------------------------------------------------------------


def start_killed(name: str, argv, spec: str, work: str):
    """The port's CLI in a process of its own with ``A5GEN_FAULTS=spec``
    (a ``kill`` rule: it must die by SIGKILL at that seam); stdout is
    dropped, stderr goes to a file of ``work``."""
    err = open(os.path.join(work, f"{name}.killed.err"), "wb")
    proc = spawn(
        [sys.executable, "-m", "hashcat_a5_table_generator_tpu_torch",
         *argv], cwd=HERE, stdout=subprocess.DEVNULL, stderr=err,
        env=dict(os.environ, A5GEN_FAULTS=spec))
    err.close()
    return proc


def ckpt_docs(path: str) -> dict:
    """The checkpoint documents at ``path``: a bucket manifest's per-width
    files by width, or ``{"sweep": doc}``."""
    with open(path) as fh:
        doc = json.load(fh)
    if doc.get("kind") != "bucket-manifest":
        return {"sweep": doc}
    out = {}
    for width, entry in doc["buckets"].items():
        f = os.path.join(os.path.dirname(path), entry["file"])
        if os.path.exists(f):
            with open(f) as fh:
                out[width] = json.load(fh)
    return out


def copy_ckpt(src: str, dst: str) -> None:
    """A checkpoint and its per-bucket files under another name."""
    for name in os.listdir(os.path.dirname(src)):
        base = os.path.basename(src)
        if name == base or name.startswith(base + ".w"):
            shutil.copy(os.path.join(os.path.dirname(src), name),
                        dst + name[len(base):])


def span_totals(metrics_path: str) -> dict:
    """The drive's span summary of a ``--metrics-json`` file, summed over
    its buckets: spans, host gap, dead host time, their share."""
    with open(metrics_path) as fh:
        doc = json.load(fh)
    spans = [s for s in doc["spans"].values() if s]
    gap = sum(s["host_gap_s"] for s in spans)
    dead = sum(s["dead_host_s"] for s in spans)
    return {"spans": sum(s["spans"] for s in spans),
            "host_gap_s": gap, "dead_host_s": dead,
            "dead_share": dead / gap if gap > 0 else None,
            "max_inflight": max([s["max_inflight"] for s in spans] or [0]),
            "by_bucket": doc["spans"],
            "checkpoint_saves": doc["metrics"].get(
                "checkpoint.saves", {}).get("value", 0),
            "checkpoint_bytes": doc["metrics"].get(
                "checkpoint.bytes_written", {}).get("value", 0)}


def robustness_phase(work: str, paths: dict, runs: dict, cand_cells: dict,
                     small: str, card: str) -> dict:
    """Phase 7.  Kill and resume: the crack cell (``--fetch-chunk 1``,
    ``superstep.fetch:kill,nth=4``) resumed as it was and at ``--pair
    off`` from a copy of its checkpoint, ``--superstep off`` (the
    per-launch pipeline's drain seam), azerty ``-s`` with its fallback
    words, and candidates mode (``superstep.dispatch:kill,nth=4``) — each
    killed run a process of its own that must die by SIGKILL and leave
    its checkpoint; each resumed run's stdout byte-identical to phase
    4's (candidates: to the uninterrupted stream from the checkpoint's
    ``n_emitted``).  Retries: ``--retries 2`` with
    ``superstep.dispatch:nth=3`` and ``superstep.fetch:error=
    FetchTimeout``, stdout byte-identical; a real watchdog timeout far
    below one superstep (``--fetch-timeout 0.0005``, ``--retries 1``):
    typed FetchTimeouts, the drive's retries and the CLI's, then exit 1,
    not a hang.  ``--profile``: a trace with ``a5.superstep.consume``
    ranges.  Drive cost of ``--checkpoint --checkpoint-every 0`` (crack,
    pair off, at the default superstep, beside phase 4's run without a
    checkpoint; the cost of one write) and the drive's host-span dead
    share (``--metrics-json``'s ``dead_share``) for crack pair off and
    pair auto at ``--superstep 1``.  Returns the phase's numbers."""
    import torch

    t_phase = time.monotonic()
    cyr = paths["cyrillic-md5"]
    want = runs[("cyrillic-md5", "pair auto")]["stdout"]

    def crack_argv(path, extra=()):
        return [path.wordlist, "-t", path.table, "--backend", "device",
                "--algo", path.algo, "--digests", path.digests, *extra]

    def ck(name):
        return os.path.join(work, f"ck-{name}.json")

    def ck_flags(name):
        return ["--checkpoint", ck(name), "--checkpoint-every", "0"]

    cand = cand_cells["cand-cyrillic"]
    cand_argv = [cand["wordlist"], "-t", cand["table"], "--backend",
                 "device", "--lanes", str(1 << 19)]
    azerty = paths["azerty-md5-s"]
    kills = {
        "crack": (crack_argv(cyr, ["--fetch-chunk", "1"])
                  + ck_flags("crack"), "superstep.fetch:kill,nth=4"),
        "superstep-off": (crack_argv(cyr, ["--superstep", "off"])
                          + ck_flags("superstep-off"),
                          "superstep.fetch:kill,nth=4"),
        "azerty-s": (crack_argv(azerty, ["-s", "--fetch-chunk", "1"])
                     + ck_flags("azerty-s"), "superstep.fetch:kill,nth=3"),
        "candidates": (cand_argv + ck_flags("candidates"),
                       "superstep.dispatch:kill,nth=4"),
    }
    # The killed runs start together, as processes of their own; the
    # retry checks run meanwhile (they time nothing).
    procs = {name: start_killed(name, argv, spec, work)
             for name, (argv, spec) in kills.items()}
    report: dict = {"killed": {}, "resumed": {}}

    def retried(label, argv, spec, expect):
        with knobs(A5GEN_FAULTS=spec):
            t = time.monotonic()
            out, err, rc = run_cli(argv)
            wall = time.monotonic() - t
        if rc != 0 or out != expect:
            fail(f"retries [{label}]: exit {rc}, stdout "
                 f"{'equal' if out == expect else 'differs'}: {err}")
        n = err.count("transient device error in the sweep drive")
        if n < 1:
            fail(f"retries [{label}]: the fault did not fire: {err}")
        log(f"retries [{label}] ({spec}): {n} in-drive retries, stdout "
            f"byte-identical to phase 4's ({len(out)} bytes), CLI wall "
            f"{wall:.2f} s on {card}")
        return {"in_drive_retries": n, "wall_s": wall}

    # Superstep length 4: the first bucket's launches take three
    # supersteps, so the third dispatch falls inside it.
    retry_argv = crack_argv(cyr, ["--retries", "2", "--fetch-chunk", "4"])
    report["retries"] = {
        "dispatch": retried("dispatch", retry_argv,
                            "superstep.dispatch:nth=3", want),
        "fetch": retried("FetchTimeout", retry_argv,
                         "superstep.fetch:error=FetchTimeout", want),
    }
    # A real watchdog far below one superstep's time: every fetch times
    # out, so the drive retries twice, the CLI once, and the run exits 1.
    small_argv = [small, "-t", cyr.table, "--backend", "device",
                  "--algo", "md5", "--digests", cyr.digests]
    t = time.monotonic()
    out, err, rc = run_cli(small_argv + ["--fetch-timeout", "0.0005",
                                         "--retries", "1"]
                           + ck_flags("watchdog"))
    wall = time.monotonic() - t
    torch.cuda.synchronize()  # the abandoned supersteps drain
    timeouts = err.count("the sweep drive (FetchTimeout: device fetch "
                         "still pending")
    if rc != 1 or timeouts != 4 or "crack sweep attempt failed " \
            "(FetchTimeout" not in err or \
            "retry 1/1 from last checkpoint" not in err or wall > 180:
        fail(f"watchdog: exit {rc}, {timeouts} typed timeouts, wall "
             f"{wall:.1f} s: {err}")
    log(f"watchdog (--fetch-timeout 0.0005 s, --retries 1): {timeouts} "
        f"typed FetchTimeouts (2 in-drive retries per attempt, then the "
        f"CLI's retry from the last checkpoint), exit {rc} after "
        f"{wall:.2f} s, no hang, on {card}")
    report["watchdog"] = {"timeouts": timeouts, "exit": rc, "wall_s": wall}

    for name, proc in procs.items():
        rc = proc.wait(timeout=300)
        with open(os.path.join(work, f"{name}.killed.err"), "rb") as fh:
            err = fh.read().decode(errors="replace")
        if rc != -9:
            fail(f"killed run [{name}] exited {rc}, not by SIGKILL: {err}")
        docs = ckpt_docs(ck(name))
        cursors = {w: d["cursor"] for w, d in docs.items()}
        if not docs or not any(d["n_emitted"] for d in docs.values()):
            fail(f"killed run [{name}]: no progress in its checkpoint "
                 f"{ck(name)}: {cursors}")
        report["killed"][name] = {
            "cursors": cursors,
            "fallback_done": {w: d["fallback_done"]
                              for w, d in docs.items()},
            "n_emitted": {w: d["n_emitted"] for w, d in docs.items()}}
        log(f"killed run [{name}] ({kills[name][1]}): died by SIGKILL, "
            f"checkpoint cursors {cursors}, fallback words done "
            f"{report['killed'][name]['fallback_done']}")
    if not any(report["killed"]["azerty-s"]["fallback_done"].values()):
        fail("killed run [azerty-s]: its checkpoint holds no fallback word")

    def resumed(label, argv, expect, emitted):
        t = time.monotonic()
        out, err, rc = run_cli(argv)
        wall = time.monotonic() - t
        if rc != 0 or out != expect:
            fail(f"resumed [{label}]: exit {rc}, stdout "
                 f"{'equal' if out == expect else 'differs'}: {err}")
        m = re.search(r"(\d+) (?:candidates hashed|candidates written)",
                      err)
        if emitted is not None and (not m or int(m.group(1)) != emitted):
            fail(f"resumed [{label}]: {m and m.group(1)} candidates, want "
                 f"{emitted}")
        log(f"resumed [{label}]: stdout byte-identical ({len(out)} bytes), "
            f"CLI wall {wall:.2f} s on {card}")
        report["resumed"][label] = {"wall_s": wall, "bytes": len(out)}

    copy_ckpt(ck("crack"), ck("crack-pair-off"))
    resumed("crack", crack_argv(cyr) + ck_flags("crack"), want,
            cyr.want_emitted)
    resumed("crack at --pair off", crack_argv(cyr, ["--pair", "off"])
            + ck_flags("crack-pair-off"), want, cyr.want_emitted)
    resumed("--superstep off", crack_argv(cyr, ["--superstep", "off"])
            + ck_flags("superstep-off"), want, cyr.want_emitted)
    resumed("azerty -s", crack_argv(azerty, ["-s"]) + ck_flags("azerty-s"),
            runs[("azerty-md5-s", "-s")]["stdout"], azerty.want_emitted)
    k = report["killed"]["candidates"]["n_emitted"]["sweep"]
    lines = cand["stdout"].split(b"\n")
    resumed("candidates", cand_argv + ck_flags("candidates"),
            b"".join(ln + b"\n" for ln in lines[k:-1]), None)

    # --profile: a torch.profiler trace of the crack cell (pair off); its
    # CUDA kernel events, where the profiler records them, give the
    # device's busy time over the drive.
    prof = os.path.join(work, "profile")
    out, err, rc = run_cli(crack_argv(cyr, ["--pair", "off", "--profile",
                                            prof]))
    trace_path = os.path.join(prof, "trace.json")
    if rc != 0 or out != runs[("cyrillic-md5", "pair off")]["stdout"] or \
            not os.path.exists(trace_path):
        fail(f"--profile: exit {rc}, stdout or trace at {trace_path} "
             f"missing: {err}")
    with open(trace_path) as fh:
        events = json.load(fh).get("traceEvents", [])
    consume = sum(e.get("name") == "a5.superstep.consume" for e in events)
    if consume < 1:
        fail("--profile: the trace holds no a5.superstep.consume range")
    busy = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                  for e in events if e.get("cat") == "kernel")
    union, end = 0.0, None
    for a, b in busy:
        if end is None or a > end:
            union += b - a
            end = b
        elif b > end:
            union += b - end
            end = b
    window = (busy[-1][1] - busy[0][0]) if busy else 0.0
    idle = 1.0 - union / window if window > 0 else None
    log(f"--profile: {os.path.getsize(trace_path)} bytes of trace, "
        f"{consume} a5.superstep.consume ranges, {len(busy)} CUDA kernel "
        f"events; device busy {union / 1e3:.3f} ms of the "
        f"{window / 1e3:.3f} ms from the first kernel to the last: idle "
        f"share {idle} (under the profiler) on {card}")
    report["profile"] = {"consume_ranges": consume,
                         "kernel_events": len(busy),
                         "busy_ms": union / 1e3, "window_ms": window / 1e3,
                         "idle_share": idle,
                         "bytes": os.path.getsize(trace_path)}

    # Drive cost of --checkpoint-every 0 (crack, pair off, one turn) at
    # the default superstep (16 launches: few writes), with the cost of
    # one write; and the drive's host-span summaries.  Every run's stdout
    # = phase 4's.
    from hashcat_a5_table_generator_tpu_torch.runtime import telemetry

    cost = {}
    spans = {}

    def measured(label, name, arm, extra, twin):
        metrics = os.path.join(work, f"m-{len(spans)}.json")
        telemetry.REGISTRY.reset()  # the run's own counters
        run = paths[name].run(f"{arm}, {label}",
                              extra + ["--metrics-json", metrics], card)
        if run["stdout"] != runs[(name, twin)]["stdout"]:
            fail(f"{name} ({arm}, {label}): stdout differs from phase 4's")
        spans[f"{name} {arm}, {label}"] = dict(span_totals(metrics),
                                              drive_s=run["drive"])
        return run

    one = ["--superstep", "1"]
    # (No --superstep off arm: dropped for the script's time when phase 9
    # came; the second turn of none / every 0, when phase 10 came, and
    # then the none run itself: the arm without a checkpoint is phase 4's
    # pair off run, the same command line without --metrics-json.)
    base = runs[("cyrillic-md5", "pair off")]
    spans["cyrillic-md5 pair off, default superstep, checkpoint none "
          "(phase 4's run)"] = dict(span_totals(base["metrics"]),
                                    drive_s=base["drive"])
    for setting, flags in (("default superstep", []),):
        arms = cost[setting] = {"none": [base["drive"]], "every 0": [],
                                "saves": [], "bytes": []}
        extra = ["--pair", "off", *flags, "--checkpoint",
                 ck(f"cost-{setting}"), "--checkpoint-every", "0"]
        label = f"{setting}, checkpoint every 0"
        run = measured(label, "cyrillic-md5", "pair off", extra, "pair off")
        arms["every 0"].append(run["drive"])
        arms["saves"].append(spans[f"cyrillic-md5 pair off, "
                                   f"{label}"]["checkpoint_saves"])
        arms["bytes"].append(spans[f"cyrillic-md5 pair off, "
                                   f"{label}"]["checkpoint_bytes"])
        added = arms["every 0"][0] - arms["none"][0]
        arms["added_s"] = added
        arms["added_share"] = added / arms["none"][0]
        arms["per_write_ms"] = 1e3 * added / arms["saves"][0]
    measured("superstep 1", "cyrillic-md5", "pair auto", one, "pair auto")
    # (czech-ntlm's and cyrillic-x2-long's spans: dropped for the script's
    # time when phase 10 and phase 9 came.)
    for label, s in spans.items():
        log(f"drive spans [{label}]: {s['spans']} consumed fetches, host "
            f"gap {s['host_gap_s']:.4f} s, dead (nothing in flight) "
            f"{s['dead_host_s']:.4f} s, host-span dead_share "
            f"{s['dead_share']}, "
            f"max in flight {s['max_inflight']}, drive {s['drive_s']} s, "
            f"checkpoint saves {s['checkpoint_saves']} "
            f"({s['checkpoint_bytes']} bytes) on {card}")
    for setting, arms in cost.items():
        log(f"drive cost of --checkpoint --checkpoint-every 0 (crack, pair "
            f"off, {setting}, one turn): none (phase 4's run) "
            f"{arms['none']} s, every 0 "
            f"{arms['every 0']} s; {arms['saves']} writes of "
            f"{arms['bytes']} bytes; added {arms['added_s']:.4f} s "
            f"({100 * arms['added_share']:.2f}%), "
            f"{arms['per_write_ms']:.3f} ms a write on {card}")
    report["drive_cost_s"] = cost
    report["spans"] = spans
    report["phase_s"] = time.monotonic() - t_phase
    log(f"robustness phase {report['phase_s']:.1f} s")
    return report


def layouts_streaming_phase(work: str, paths: dict, runs: dict,
                            cand_cells: dict, card: str) -> dict:
    """Phase 8 (see the module docstring).  Returns the phase's
    numbers."""
    from hashcat_a5_table_generator_tpu_torch.runtime import (
        faults,
        telemetry,
    )

    t_phase = time.monotonic()
    cyr, long = paths["cyrillic-md5"], paths["cyrillic-x2-long"]
    crack_want = runs[("cyrillic-md5", "pair auto")]["stdout"]
    report: dict = {"packed": {}, "stream": {}, "resumed": {}}

    def crack_argv(path, extra=()):
        return [path.wordlist, "-t", path.table, "--backend", "device",
                "--algo", path.algo, "--digests", path.digests, *extra]

    # The default (streamed) crack run killed inside its first chunk: one
    # superstep a launch, so a 65,536-word chunk spans several fetches.
    ck = os.path.join(work, "ck-stream.json")
    ck_flags = ["--checkpoint", ck, "--checkpoint-every", "0"]
    proc = start_killed("stream", crack_argv(cyr, ["--fetch-chunk", "1"])
                        + ck_flags, "superstep.fetch:kill,nth=2", work)
    # chunk.compile fails once (the second chunk's compile, on the ring's
    # worker): one restart, the same stdout (meanwhile: it times nothing).
    restarts = telemetry.counter("faults.worker_restarts").value
    with knobs(A5GEN_FAULTS="chunk.compile:nth=2"):
        out, err, rc = run_cli(crack_argv(cyr))
    faults.clear()
    restarts = telemetry.counter("faults.worker_restarts").value - restarts
    if rc != 0 or out != crack_want or restarts != 1:
        fail(f"chunk.compile fault: exit {rc}, stdout "
             f"{'equal' if out == crack_want else 'differs'}, {restarts} "
             f"worker restarts: {err}")
    log(f"chunk.compile:nth=2: recovered after {restarts} worker restart, "
        f"stdout byte-identical to phase 4's ({len(out)} bytes)")
    report["chunk_compile_restarts"] = restarts
    rc = proc.wait(timeout=300)
    with open(os.path.join(work, "stream.killed.err"), "rb") as fh:
        err = fh.read().decode(errors="replace")
    docs = ckpt_docs(ck)
    cur = docs.get("16", {}).get("cursor", {})
    inside = bool(cur) and bool(cur["word"] % 65536 or int(cur["rank"]))
    if rc != -9 or not inside:
        fail(f"killed streamed run: exit {rc}, bucket 16 cursor {cur} "
             f"(want SIGKILL inside a chunk): {err}")
    report["killed_cursor"] = cur
    log(f"killed streamed run (superstep.fetch:kill,nth=2): died by "
        f"SIGKILL, bucket 16 cursor {cur} inside chunk "
        f"{cur['word'] // 65536}, stream marker "
        f"{docs['16'].get('stream')}")
    copy_ckpt(ck, os.path.join(work, "ck-stream-off.json"))
    for label, extra, path in (
            ("as it was", [], ck),
            ("at --stream-chunk-words off", ["--stream-chunk-words", "off"],
             os.path.join(work, "ck-stream-off.json"))):
        t = time.monotonic()
        out, err, rc = run_cli(crack_argv(cyr, extra) + [
            "--checkpoint", path, "--checkpoint-every", "0"])
        wall = time.monotonic() - t
        if rc != 0 or out != crack_want:
            fail(f"resumed streamed run [{label}]: exit {rc}, stdout "
                 f"{'equal' if out == crack_want else 'differs'}: {err}")
        report["resumed"][label] = {"wall_s": wall}
        log(f"resumed streamed run [{label}]: stdout byte-identical to "
            f"phase 4's ({len(out)} bytes), CLI wall {wall:.2f} s on {card}")

    # The variable-offset layout: the XLA route, per-launch pipeline.
    stride_run = runs[("cyrillic-md5", "pair auto")]
    # (No --lanes 4194000 arm: dropped for the script's time when phase 9
    # came; --lanes 1000000 below keeps a geometry the auto block count
    # does not divide.)
    for label, extra in (("--block-layout packed",
                          ["--block-layout", "packed"]),):
        run = cyr.run(f"packed, {label}", extra, card)
        fused = [k for k in run["launches"]
                 if k.startswith(("piece_", "bytescan_"))]
        if run["stdout"] != crack_want or fused:
            fail(f"packed layout [{label}]: stdout "
                 f"{'equal' if run['stdout'] == crack_want else 'differs'}"
                 f", fused launches {fused}")
        expect_launched(run, ["buffer_hash/md5"], f"packed [{label}]")
        report["packed"][label] = {
            "drive_s": run["drive"], "stride_drive_s": stride_run["drive"],
            "launches": run["launches"], "xla_lanes": run["xla_lanes"],
            "host_s": run["wall"] - run["drive"]}
        log(f"packed layout [{label}]: stdout byte-identical to phase 4's, "
            f"launches {run['launches']} ({run['xla_lanes']} lanes per XLA "
            f"launch), drive {run['drive']} s beside the stride layout's "
            f"{stride_run['drive']} s (piece kernel) on {card}")
    cand = cand_cells["cand-cyrillic"]
    t = time.monotonic()
    out, err, rc = run_cli([cand["wordlist"], "-t", cand["table"],
                            "--backend", "device", "--lanes", "1000000"])
    wall = time.monotonic() - t
    loop = re.search(r"([\d.]+) s launch loop", err)
    if rc != 0 or out != cand["stdout"] or not loop:
        fail(f"packed layout [candidates --lanes 1000000]: exit {rc}, "
             f"stdout {'equal' if out == cand['stdout'] else 'differs'}: "
             f"{err}")
    report["packed"]["candidates --lanes 1000000"] = {
        "drive_s": float(loop.group(1)), "wall_s": wall}
    log(f"packed layout [candidates cyrillic, --lanes 1000000]: stdout "
        f"byte-identical to phase 4's ({len(out)} bytes), launch loop "
        f"{loop.group(1)} s, CLI wall {wall:.2f} s on {card}")

    # Streaming on and off: byte-identical, with the host and stream
    # numbers of each run (--metrics-json gauges).
    for name, arm, twin, extra in (
            ("cyrillic-md5", "pair off", "pair off", ["--pair", "off"]),
            ("cyrillic-x2-long", "-x 2", "-x 2", ["-x", "2"])):
        # cyrillic-x2-long at the default chunking: phase 4's run (the
        # 4096-word crack arm and this one were dropped for the script's
        # time when phase 9 came).
        chunks = ("off", "auto") if name == "cyrillic-md5" else ("off",)
        for chunk in chunks:
            if chunk == "auto":
                # Phase 4's run, at the default chunking, with its
                # --metrics-json (a run of its own here before phase 10).
                run = runs[(name, twin)]
                metrics = run["metrics"]
            else:
                metrics = os.path.join(work, f"m-stream-{name}-{chunk}.json")
                telemetry.REGISTRY.reset()
                run = paths[name].run(
                    f"{arm}, --stream-chunk-words {chunk}",
                    extra + ["--stream-chunk-words", chunk, "--metrics-json",
                             metrics], card)
            if run["stdout"] != runs[(name, twin)]["stdout"]:
                fail(f"{name} ({arm}, --stream-chunk-words {chunk}): "
                     "stdout differs from phase 4's")
            with open(metrics) as fh:
                m = json.load(fh)["metrics"]

            def g(key):
                return m.get(key, {}).get("value")

            row = {"host_s": run["wall"] - run["drive"],
                   "drive_s": run["drive"], "wall_s": run["wall"],
                   "ttfc_s": g("sweep.ttfc_s"),
                   "chunks_swept": g("stream.chunks_swept"),
                   "compile_overlap_s": g("stream.compile_overlap_s"),
                   "overlap_ratio": g("stream.overlap_ratio"),
                   "peak_resident_plan_bytes": g(
                       "stream.peak_resident_plan_bytes"),
                   "device_peak_gib": run["peak_bytes"] / 2 ** 30}
            if (chunk == "off") != (row["chunks_swept"] is None):
                fail(f"{name} (--stream-chunk-words {chunk}): streamed "
                     f"{row['chunks_swept']} chunks")
            report["stream"][f"{name} {chunk}"] = row
            log(f"streaming [{name} {arm}, --stream-chunk-words {chunk}]: "
                f"stdout byte-identical to phase 4's; host "
                f"{row['host_s']:.3f} s, drive {row['drive_s']} s, ttfc "
                f"{row['ttfc_s']} s, chunks {row['chunks_swept']}, compile "
                f"overlap {row['compile_overlap_s']} s (ratio "
                f"{row['overlap_ratio']}), peak resident plan "
                f"{row['peak_resident_plan_bytes']} B, device peak "
                f"{row['device_peak_gib']:.3f} GiB on {card}")
    report["phase_s"] = time.monotonic() - t_phase
    log(f"layouts and streaming phase {report['phase_s']:.1f} s")
    return report


# ---------------------------------------------------------------------------
# Phase 9: the schema cache, the prefetcher, devices and the pod
# ---------------------------------------------------------------------------


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def pod_start(name: str, work: str, argv, extra=(), envs=None) -> dict:
    """``argv`` started in two processes of one pod on this card (the
    port's CLI, ``--coordinator 127.0.0.1:<free port>``, gloo); stdout and
    stderr to files of ``work``.  :func:`pod_wait` collects them."""
    port = free_port()
    procs, files = [], []
    t0 = time.monotonic()
    for p in range(2):
        out = open(os.path.join(work, f"pod-{name}.{p}.out"), "wb")
        err = open(os.path.join(work, f"pod-{name}.{p}.err"), "wb")
        files.append((out, err))
        procs.append(spawn(
            [sys.executable, "-m", "hashcat_a5_table_generator_tpu_torch",
             *argv, "--coordinator", f"127.0.0.1:{port}",
             "--num-processes", "2", "--process-id", str(p), *extra],
            cwd=HERE, stdout=out, stderr=err,
            env=(envs or {}).get(p, dict(os.environ))))
    return {"name": name, "procs": procs, "files": files, "t0": t0}


def pod_wait(pods: list, timeout: int = 180) -> list:
    """Each pod of ``pods`` (:func:`pod_start`) waited for: per pod,
    ``[(exit code, stdout, stderr, wall s, exit time)]`` in process
    order."""
    ended = {id(pod): [None, None] for pod in pods}
    while any(None in v for v in ended.values()):
        for pod in pods:
            for p, proc in enumerate(pod["procs"]):
                if ended[id(pod)][p] is None and proc.poll() is not None:
                    ended[id(pod)][p] = time.monotonic()
            if None in ended[id(pod)] and \
                    time.monotonic() - pod["t0"] > timeout:
                for proc in pod["procs"]:
                    proc.kill()
                fail(f"pod [{pod['name']}]: no exit within {timeout} s")
        time.sleep(0.05)
    out = []
    for pod in pods:
        res = []
        for p, (proc, (fo, fe)) in enumerate(zip(pod["procs"],
                                                 pod["files"])):
            fo.close()
            fe.close()
            with open(fo.name, "rb") as fh:
                data = fh.read()
            with open(fe.name, "rb") as fh:
                text = fh.read().decode(errors="replace")
            end = ended[id(pod)][p]
            res.append((proc.returncode, data, text, end - pod["t0"], end))
        out.append(res)
    return out


def stderr_launches(err: str) -> dict:
    """The ``kernels:`` line of a CLI run's stderr as ``{tier: n}``."""
    m = re.search(r"kernels: ([^\n]*)", err)
    return {k: int(n) for k, n in re.findall(r"(\S+) (\d+) launches",
                                             m.group(1))} if m else {}


def pod_phase(work: str, paths: dict, runs: dict, cand_cells: dict,
              card: str) -> dict:
    """Phase 9 (see the module docstring).  Returns the phase's
    numbers."""
    import torch

    from hashcat_a5_table_generator_tpu_torch.cli import _read_digests
    from hashcat_a5_table_generator_tpu_torch.models.attack import (
        AttackSpec,
    )
    from hashcat_a5_table_generator_tpu_torch.native import (
        read_packed, read_packed_buckets,
    )
    from hashcat_a5_table_generator_tpu_torch.ops import fused_expand
    from hashcat_a5_table_generator_tpu_torch.runtime import (
        faults,
        telemetry,
    )
    from hashcat_a5_table_generator_tpu_torch.runtime.bucketed import (
        BucketedSweep,
    )
    from hashcat_a5_table_generator_tpu_torch.runtime.sinks import (
        CandidateWriter, HitRecorder,
    )
    from hashcat_a5_table_generator_tpu_torch.runtime.sweep import (
        Sweep, SweepConfig,
    )
    from hashcat_a5_table_generator_tpu_torch.tables.parser import (
        load_tables,
    )

    t_phase = time.monotonic()
    cyr = paths["cyrillic-md5"]
    crack_want = runs[("cyrillic-md5", "pair auto")]["stdout"]
    report: dict = {"schema_cache": {}, "prefetch": {}, "devices": {},
                    "pod": {}}

    def crack_argv(path, extra=()):
        return [path.wordlist, "-t", path.table, "--backend", "device",
                "--algo", path.algo, "--digests", path.digests, *extra]

    # -- the schema cache: run 1 fills it, run 2 reads it only.
    def cached(label, path, arm, extra, twin, cache, max_mb=None):
        metrics = os.path.join(work, f"m-cache-{label}.json")
        flags = ["--schema-cache", cache, "--metrics-json", metrics] + (
            ["--schema-cache-max-mb", str(max_mb)] if max_mb else [])
        telemetry.REGISTRY.reset()
        run = path.run(f"{arm}, schema cache {label}", extra + flags, card)
        if run["stdout"] != runs[twin]["stdout"]:
            fail(f"schema cache [{label}]: stdout differs from phase 4's")
        with open(metrics) as fh:
            m = json.load(fh)["metrics"]

        def g(key):
            return m.get(key, {}).get("value", 0)

        row = {k: g(f"schema_cache.{k}") for k in (
            "hits", "misses", "bytes_read", "bytes_written", "evictions")}
        row.update(host_s=run["wall"] - run["drive"], drive_s=run["drive"],
                   wall_s=run["wall"], ttfc_s=g("sweep.ttfc_s"),
                   entries=len([n for n in os.listdir(cache)
                                if n.endswith(".npz")]),
                   dead_share=span_totals(metrics)["dead_share"])
        report["schema_cache"][label] = row
        log(f"schema cache [{label}]: stdout byte-identical to phase 4's; "
            f"{row['hits']} hits, {row['misses']} misses, "
            f"{row['bytes_read']} B read, {row['bytes_written']} B written, "
            f"{row['evictions']} evictions, {row['entries']} entries; host "
            f"{row['host_s']:.3f} s, drive {row['drive_s']} s, ttfc "
            f"{row['ttfc_s']:.3f} s, host-span dead_share "
            f"{row['dead_share']}, CLI wall {row['wall_s']:.2f} s on "
            f"{card}")
        return row

    # (cyrillic-x2-long's two cached runs were dropped for the script's
    # time when phase 10 came.)
    for name, arm, extra in (("cyrillic-md5", "pair auto", []),):
        cache = os.path.join(work, f"schema-{name}")
        one = cached(f"{name} run 1", paths[name], arm, extra, (name, arm),
                     cache)
        two = cached(f"{name} run 2", paths[name], arm, extra, (name, arm),
                     cache)
        if one["hits"] or not one["misses"] or two["misses"] or \
                two["hits"] != one["misses"]:
            fail(f"schema cache [{name}]: run 1 {one['hits']} hits / "
                 f"{one['misses']} misses, run 2 {two['hits']} / "
                 f"{two['misses']}")
    capped = cached("cyrillic-md5 --schema-cache-max-mb 1", cyr, "pair auto",
                    [], ("cyrillic-md5", "pair auto"),
                    os.path.join(work, "schema-capped"), max_mb=1)
    if not capped["evictions"]:
        fail("schema cache [--schema-cache-max-mb 1]: nothing evicted")

    # -- the prefetcher: phase 4's azerty -s runs went through it; one
    # injected dispatch fault (an in-drive retry restarts its producer).
    az = paths["azerty-md5-s"]
    report["prefetch"]["azerty-s"] = {
        arm: {"drive_s": runs[("azerty-md5-s", arm)]["drive"],
              "wall_s": runs[("azerty-md5-s", arm)]["wall"]}
        for arm in ("-s", "A5_NATIVE=0 -s")}
    with knobs(A5GEN_FAULTS="superstep.dispatch:nth=2"):
        t = time.monotonic()
        out, err, rc = run_cli(crack_argv(az, ["-s", "--retries", "1"]))
        wall = time.monotonic() - t
    faults.clear()
    left = [th.name for th in threading.enumerate()
            if th.name == "a5-fallback-oracle" and th.is_alive()]
    if rc != 0 or out != runs[("azerty-md5-s", "-s")]["stdout"] or left \
            or "transient device error in the sweep drive" not in err:
        fail(f"prefetcher [azerty-s, dispatch fault, --retries 1]: exit "
             f"{rc}, stdout "
             f"{'equal' if out == runs[('azerty-md5-s', '-s')]['stdout'] else 'differs'}"
             f", producer threads alive {left}: {err}")
    report["prefetch"]["retry_wall_s"] = wall
    log(f"prefetcher [azerty-s, superstep.dispatch:nth=2, --retries 1]: "
        f"stdout byte-identical to phase 4's, no producer thread left, CLI "
        f"wall {wall:.2f} s on {card}")

    # -- devices: auto and 1 on this card, 2 refused; two stripes on it.
    # (--devices 1 runs on the warm-up's 2000 words since phase 10 came.)
    run = cyr.run("--devices auto", ["--devices", "auto"], card)
    if run["stdout"] != crack_want:
        fail("--devices auto: stdout differs from phase 4's")
    expect_launched(run, ["piece_pair/md5"], "--devices auto")
    report["devices"]["auto"] = {"drive_s": run["drive"],
                                 "wall_s": run["wall"]}
    warm = runs[("small", "warm-up")]
    for k in fused_expand.LAUNCHES:
        fused_expand.LAUNCHES[k] = 0
    t = time.monotonic()
    out, err, rc = run_cli(warm["argv"] + ["--devices", "1"])
    wall = time.monotonic() - t
    launched = {k: v for k, v in fused_expand.LAUNCHES.items() if v}
    if rc != 0 or out != warm["stdout"] or \
            not launched.get("piece_pair/md5"):
        fail(f"--devices 1 [warm-up words]: exit {rc}, stdout "
             f"{'equal' if out == warm['stdout'] else 'differs'}, launches "
             f"{launched}: {err}")
    report["devices"]["1, warm-up words"] = {"wall_s": wall}
    log(f"--devices 1 [the warm-up run's 2000 words]: stdout byte-identical"
        f" to the warm-up run's, CLI wall {wall:.2f} s on {card}")
    out, err, rc = run_cli(crack_argv(cyr, ["--devices", "2"]))
    want_msg = f"requested 2 devices, have {torch.cuda.device_count()}"
    if rc == 0 or want_msg not in err or out:
        fail(f"--devices 2 on one card: exit {rc}: {err}")
    log(f"--devices 2 on one card: exit {rc}, {want_msg!r}")
    cuda0 = torch.device("cuda", 0)
    two = SweepConfig(devices=[cuda0, cuda0])
    for mod in (fused_expand,):
        for k in mod.LAUNCHES:
            mod.LAUNCHES[k] = 0
    plain = fused_expand.PLAIN_CALLS
    buf = io.BytesIO()
    t = time.monotonic()
    res = BucketedSweep(AttackSpec(), load_tables([cyr.table]),
                        read_packed_buckets(cyr.wordlist, buckets=(16, 32,
                                                                   64)),
                        _read_digests(cyr.digests, "md5"),
                        config=two).run_crack(HitRecorder(buf))
    wall = time.monotonic() - t
    launched = {k: v for k, v in fused_expand.LAUNCHES.items() if v}
    if buf.getvalue() != crack_want or fused_expand.PLAIN_CALLS != plain \
            or not launched.get("piece_pair/md5"):
        fail(f"two stripes on one card [crack]: hits "
             f"{'equal' if buf.getvalue() == crack_want else 'differ'}, "
             f"launches {launched}")
    report["devices"]["two stripes, crack"] = {
        "wall_s": wall, "drive_s": res.drive_s, "launches": launched,
        "supersteps": res.superstep.get("supersteps")}
    log(f"two stripes on one card [crack cell, Sweep(devices=[cuda:0, "
        f"cuda:0])]: hits byte-identical to phase 4's, launches "
        f"{launched}, drive {res.drive_s:.3f} s, wall {wall:.2f} s on "
        f"{card}")
    cand = cand_cells["cand-cyrillic"]
    buf = io.BytesIO()
    t = time.monotonic()
    with CandidateWriter(buf) as writer:
        res = Sweep(AttackSpec(), load_tables([cand["table"]]),
                    read_packed(cand["wordlist"]),
                    config=two).run_candidates(writer)
    wall = time.monotonic() - t
    if buf.getvalue() != cand["stdout"]:
        fail("two stripes on one card [candidates cyrillic]: the stream "
             "differs from phase 4's")
    report["devices"]["two stripes, candidates"] = {
        "wall_s": wall, "drive_s": res.drive_s}
    log(f"two stripes on one card [candidates cyrillic]: stream "
        f"byte-identical to phase 4's ({len(cand['stdout'])} bytes), "
        f"launch loop {res.drive_s:.3f} s, wall {wall:.2f} s on {card}")

    # -- the pod: two processes on this card, gloo.
    def pod_report(label, res):
        report["pod"][label] = [
            {"rc": rc, "wall_s": wall, "launches": stderr_launches(err)}
            for rc, _o, err, wall, _t in res]
        log(f"pod [{label}]: " + "; ".join(
            f"process {p}: exit {rc}, wall {wall:.2f} s, launches "
            f"{stderr_launches(err)}"
            for p, (rc, _o, err, wall, _t) in enumerate(res))
            + f" on {card}")

    def pod_ok(label, res):
        if any(r[0] != 0 for r in res):
            fail(f"pod [{label}]: exits {[r[0] for r in res]}: "
                 + " | ".join(r[2][-2000:] for r in res))

    # The crack, candidates, giant-job and peer-loss pods run at once (ten
    # processes on this card and host: each pod's walls are taken beside
    # the others'); the relaunch after the peer loss follows.
    huge = runs[("huge-word", "per-launch")]
    # One process SIGKILLed at its third fetch: the survivor leaves with
    # the PeerLossError text; the pod relaunched resumes from the
    # checkpoints to phase 4's stdout.
    ck = os.path.join(work, "ck-pod.json")
    argv = crack_argv(cyr, ["--fetch-chunk", "1", "--checkpoint", ck,
                            "--checkpoint-every", "0"])
    envs = {0: dict(os.environ, A5GEN_DCN_TIMEOUT="10"),
            1: dict(os.environ, A5GEN_DCN_TIMEOUT="10",
                    A5GEN_FAULTS="superstep.fetch:kill,nth=3")}
    gathered, local, cands, giant, lost = pod_wait([
        pod_start("gathered", work, crack_argv(cyr)),
        pod_start("local", work, crack_argv(cyr, ["--pod-hits", "local"])),
        pod_start("candidates", work, [cand["wordlist"], "-t",
                                       cand["table"], "--backend",
                                       "device"]),
        pod_start("giant", work, huge["argv"], extra=["--giant-job"]),
        pod_start("peer-loss", work, argv, envs=envs)])
    res = gathered
    pod_ok("gathered", res)
    if res[0][1] != crack_want or res[1][1]:
        fail("pod [crack, gathered]: process 0's stdout differs from "
             "phase 4's, or process 1 printed hits")
    pod_report("crack, gathered", res)
    res = local
    pod_ok("local", res)
    lines = res[0][1].splitlines() + res[1][1].splitlines()
    if sorted(lines) != sorted(crack_want.splitlines()) or \
            not (res[0][1] and res[1][1]):
        fail("pod [crack, local]: the union of the two stdouts differs "
             "from phase 4's")
    pod_report("crack, local", res)
    res = cands
    pod_ok("candidates", res)
    if res[0][1] + res[1][1] != cand["stdout"]:
        fail("pod [candidates cyrillic, gathered]: the two stdouts "
             "concatenated differ from phase 4's")
    pod_report("candidates cyrillic, gathered", res)
    res = giant
    pod_ok("giant", res)
    if res[0][1] != huge["stdout"] or res[1][1]:
        fail("pod [--giant-job, huge word]: process 0's stdout differs "
             "from phase 4's")
    pod_report("--giant-job, huge word", res)
    (rc0, out0, err0, wall0, end0), (rc1, _o1, err1, _w1, end1) = lost
    if rc1 != -9 or rc0 != 3 or "FATAL" not in err0 or \
            "died or stalled" not in err0 or end0 - end1 > 30:
        fail(f"pod [peer loss]: process 1 exit {rc1}, process 0 exit {rc0}"
             f" {end0 - end1:.1f} s after it: {err0[-3000:]}")
    report["pod"]["peer loss"] = {"survivor_exit": rc0,
                                  "survivor_after_s": end0 - end1}
    log(f"pod [peer loss]: process 1 SIGKILLed at its third fetch, "
        f"process 0 exited {rc0} with the PeerLossError text "
        f"{end0 - end1:.2f} s later")
    envs = {p: dict(os.environ, A5GEN_DCN_TIMEOUT="10") for p in range(2)}
    res, = pod_wait([pod_start("resume", work, argv, envs=envs)])
    pod_ok("resume", res)
    if res[0][1] != crack_want:
        fail("pod [relaunch after peer loss]: process 0's stdout differs "
             "from phase 4's")
    pod_report("relaunch after peer loss", res)
    report["phase_s"] = time.monotonic() - t_phase
    log(f"schema cache, prefetcher, devices and pod phase "
        f"{report['phase_s']:.1f} s")
    return report


def german_cell_words() -> list:
    """The german cells' dictionary: the bench recipe with ss (~5%) and
    sss (~1%), unique, plus 120 long lines (bucket 64, no "sss": the
    piece kernel)."""
    words = list(dict.fromkeys(german_words(N_WORDS_CELL + 1000, seed=41)))
    words = words[: N_WORDS_CELL - 120]
    rng = np.random.default_rng(4)
    for w in long_words(100, 33, 64, (4, 10), seed=5) + \
            long_words(20, 50, 64, (3, 8), seed=6):
        words.insert(int(rng.integers(0, len(words))), w)
    return words


def ptxas_kernels(report: str) -> list:
    """``(kernel, "R registers, S B stack, spill X/Y B, M B smem")`` per
    entry of an ``-Xptxas -v`` report; the kernel named by its template
    arguments after the hash (bytescan_kernel: ROW, VAR, DECODE, CLOSED,
    HB; piece_tile_kernel: KIND, DECODE, HB, PAIR, CLOSED;
    piece_windowed_kernel: KIND, HB, CLOSED, PACK; buffer_hash_kernel:
    MODE).  Static shared memory only: every kernel but the buffer hash's
    sizes its own at launch."""
    out, name, frame = [], None, ""
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            base = re.match(r"_Z\d+([A-Za-z_]+?)(I|v|$)", m.group(1))
            args = re.findall(r"L[ib](\d+)E", m.group(1))
            name = f"{base.group(1) if base else m.group(1)}" \
                f"<{','.join(args[1:])}>"
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            frame = (f"{m.group(1)} B stack, spill {m.group(2)}/"
                     f"{m.group(3)} B")
            continue
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and name:
            out.append((name, f"{m.group(1)} registers, {frame}, "
                              f"{m.group(2) or 0} B static smem"))
            name = None
    return out


#: The huge word: 15 letters, each a key of three options (radix 4):
#: 4^15 = 2^30 rows, a word the int32 block index cannot hold.
HUGE_KEYS = b"bcdfghjklmnpqrs"
HUGE_PLANTS = 10


def huge_table() -> dict:
    """The huge word's table: each of its 15 letters a key of three
    options (the capital, the capital twice, ``_`` and the letter)."""
    return {bytes([k]): [bytes([k - 32]), bytes([k - 32]) * 2,
                         b"_" + bytes([k])] for k in HUGE_KEYS}


def huge_word_run(work: str, card: str, min_rows: int = 1 << 30) -> dict:
    """One word of 2^30 rows on the piece route, through the CLI: the
    per-launch pipeline cuts its blocks on the host (Python-int cursors)
    and runs the digit decode; hits planted at ranks of its last launch
    (decoded by the port's ``decode_variant``) are each printed once, and
    ``candidates hashed`` is every row but rank 0 (no substitution: -m
    1).  Prints the rows, the launches and the drive seconds; returns the
    run's kernel launches (``launches``, ``widths``: none on the XLA
    route), as ``MainPath.run`` does, with its ``stdout`` and ``argv``."""
    from hashcat_a5_table_generator_tpu_torch.models.attack import (
        AttackSpec, build_plan, decode_variant,
    )
    from hashcat_a5_table_generator_tpu_torch.ops import fused_expand
    from hashcat_a5_table_generator_tpu_torch.ops.packing import (
        pack_words, piece_schema_for,
    )
    from hashcat_a5_table_generator_tpu_torch.tables.compile import (
        compile_table,
    )
    from hashcat_a5_table_generator_tpu_torch.utils.digests import (
        HOST_DIGEST,
    )

    sub = huge_table()
    table = os.path.join(work, "huge.table")
    with open(table, "wb") as fh:
        fh.write(b"".join(k + b"=" + v + b"\n" for k, vs in sub.items()
                          for v in vs))
    words = [bytes(HUGE_KEYS), b"password", b"zebra"]
    wordlist = os.path.join(work, "huge.words.txt")
    with open(wordlist, "wb") as fh:
        fh.write(b"\n".join(words) + b"\n")
    spec = AttackSpec()
    ct = compile_table(sub)
    plan = build_plan(spec, ct, pack_words([words[0]]))
    rows = int(plan.n_variants[0])
    if rows < min_rows or int(plan.num_slots) > 24:
        fail(f"huge word: {rows} rows over {plan.num_slots} slots")
    if fused_expand.opts_for(spec, plan, ct) is None or \
            piece_schema_for(plan, ct) is None:
        fail("huge word: the plan does not take the piece kernel")
    planted = {}
    for k in range(HUGE_PLANTS):
        cand = decode_variant(plan, ct, spec, 0, rows - 1 - 997 * k)
        planted[HOST_DIGEST["md5"](cand).hex()] = cand
    rng = np.random.default_rng(91)
    digests = os.path.join(work, "huge.digests.txt")
    with open(digests, "w") as fh:
        fh.write("\n".join(list(planted) + [
            rng.integers(0, 256, 16, dtype=np.uint8).tobytes().hex()
            for _ in range(990)]) + "\n")
    for k in fused_expand.LAUNCHES:
        fused_expand.LAUNCHES[k] = 0
    plain = fused_expand.PLAIN_CALLS
    t = time.monotonic()
    out, err, rc = run_cli([wordlist, "-t", table, "--backend", "device",
                            "--digests", digests])
    wall = time.monotonic() - t
    if rc != 0:
        fail(f"huge word: the CLI exited {rc}: {err}")
    launches = {k: v for k, v in fused_expand.LAUNCHES.items() if v}
    got = [ln.split(":", 1)[1].encode() for ln in
           out.decode().splitlines()]
    for cand in planted.values():
        if got.count(cand) != 1:
            fail(f"huge word: planted {cand!r} printed {got.count(cand)} "
                 "times")
    m = re.search(r"(\d+) candidates hashed", err)
    # Every row but the unsubstituted one, of each word (3 options a key).
    want = rows - 1 + sum(4 ** sum(bytes([c]) in sub for c in w) - 1
                          for w in words[1:])
    if not m or int(m.group(1)) != want:
        fail(f"huge word: candidates hashed {m and m.group(1)}, want {want}")
    p = re.search(r"per-launch pipeline: (\d+) launches", err)
    d = re.search(r"([\d.]+) s per-launch drive, ([\d.e+]+) "
                  r"candidate-hashes/s", err)
    if not p or not d or launches.get("piece_digits/md5", 0) <= 0 \
            or fused_expand.PLAIN_CALLS != plain:
        fail(f"huge word: no per-launch run of piece_digits/md5 ({err})")
    log(f"huge word [{bytes(HUGE_KEYS).decode()}, 15 slots of radix 4]: "
        f"{rows} rows on the piece route, per-launch pipeline: "
        f"{p.group(1)} launches {launches}, {len(got)} hits "
        f"({HUGE_PLANTS} planted in the last launch, each printed once), "
        f"drive {d.group(1)} s ({d.group(2)} candidate-hashes/s), CLI wall "
        f"{wall:.2f} s on {card}")
    return {"launches": launches, "widths": {}, "stdout": out,
            "argv": [wordlist, "-t", table, "--backend", "device",
                     "--digests", digests]}


# ---------------------------------------------------------------------------
# Phase 10: the resident engine (a5gen serve) on the card
# ---------------------------------------------------------------------------

#: Phase 10's small tenants: words and digests a tenant, planted hits.
SERVE_WORDS = 20_000
SERVE_DIGESTS = 100_000
SERVE_PLANTED = 100
#: Extra ``a5gen serve`` flags (a CPU rehearsal passes ``--device cpu``)
#: and the solo sweeps' device.
SERVE_ARGS: list = []
SERVE_DEVICE = "cuda"
#: The churn session's job geometry: small launches, one a superstep, so
#: every tenant spans hundreds of rounds and a cancel sent on its first
#: hit lands mid-sweep.
CHURN_CONFIG = {"lanes": 1 << 16, "superstep": 1}
#: ``a5gen serve`` through the CLI's entry point, its kernel launch
#: counts on stderr at exit (a fresh process: they start at 0), the part
#: of them that fused groups' packed supersteps made, and those groups'
#: occupied and total candidate lanes by launch tier.
SERVE_WRAPPER = (
    "import json, sys\n"
    "from hashcat_a5_table_generator_tpu_torch import cli\n"
    "from hashcat_a5_table_generator_tpu_torch.ops import buffer_hash, "
    "bytescan, fused_expand\n"
    "from hashcat_a5_table_generator_tpu_torch.runtime import fuse\n"
    "rc = cli.main(sys.argv[1:])\n"
    "print(json.dumps({'launches': {k: v for m in (fused_expand, bytescan, "
    "buffer_hash) for k, v in m.LAUNCHES.items() if v}, "
    "'group_launches': fuse.GROUP_LAUNCHES, "
    "'group_lanes': fuse.GROUP_LANES}), file=sys.stderr)\n"
    "sys.exit(rc)\n")
SETTLE = ("done", "paused", "cancelled", "failed")


class ServeProcess:
    """One ``a5gen serve`` process (the port's CLI, :data:`SERVE_WRAPPER`):
    JSONL requests on its stdin (or a unix socket), its events read on a
    thread into a list; :meth:`wait_for` polls it."""

    def __init__(self, work: str, name: str, args=(), env=None) -> None:
        self.name = name
        self.err_path = os.path.join(work, f"serve-{name}.err")
        self.err = open(self.err_path, "w")
        self.t0 = time.monotonic()
        self.proc = spawn(
            [sys.executable, "-c", SERVE_WRAPPER, "serve", *SERVE_ARGS,
             *args], stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=self.err, text=True, cwd=HERE,
            env={**os.environ, **(env or {})})
        self.events: list = []
        self.lock = threading.Lock()
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            if line.strip():
                with self.lock:
                    self.events.append(json.loads(line))

    def send(self, *docs) -> None:
        self.proc.stdin.write("".join(json.dumps(d) + "\n" for d in docs))
        self.proc.stdin.flush()

    def wait_for(self, pred, what: str, timeout: float = 180) -> list:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self.lock:
                evs = list(self.events)
            if pred(evs):
                return evs
            if self.proc.poll() is not None and not self.reader.is_alive():
                break
            time.sleep(0.002)
        fail(f"serve {self.name}: timed out waiting for {what}; last "
             f"events {self.events[-3:]}; stderr "
             f"{open(self.err_path).read()[-2000:]}")

    def close(self, timeout: float = 120) -> dict:
        """EOF on stdin; the process's exit code, wall and launches."""
        self.proc.stdin.close()
        rc = self.proc.wait(timeout)
        self.reader.join(30)
        wall = time.monotonic() - self.t0
        self.err.close()
        err = open(self.err_path).read()
        if rc != 0:
            fail(f"serve {self.name} exited {rc}: {err[-3000:]}")
        last = json.loads(err.strip().splitlines()[-1])
        return {"rc": rc, "wall_s": wall, "launches": last["launches"],
                "group_launches": last["group_launches"],
                "group_lanes": last["group_lanes"]}


def per_job(events: list) -> dict:
    out: dict = {}
    for e in events:
        if "id" in e and e.get("event") != "accepted":
            out.setdefault(e["id"], []).append(e)
    return out


def hit_tuples(evs: list) -> list:
    return [(e["word_index"], int(e["rank"]), e["plain_hex"], e["digest"])
            for e in evs if e["event"] == "hit"]


#: Phase 10's german tenants: word slices cut to plans of at most this
#: many match slots (the slot count is a trailing shape of the packed
#: tables, so two tenants fuse only at one count).
GERMAN_SERVE_SLOTS = 6


def german_serve_words(n: int) -> list:
    """``n`` slices of :data:`SERVE_WORDS` words each for the german
    tenants: the bench recipe with ss and sss (:func:`german_words`),
    words of more than :data:`GERMAN_SERVE_SLOTS` match slots left out, so
    every slice's plan has that slot count (checked by the tenants'
    packed keys); the "sss" words stay, and no plan has a piece schema."""
    from hashcat_a5_table_generator_tpu_torch.models.attack import (
        AttackSpec, build_plan,
    )
    from hashcat_a5_table_generator_tpu_torch.ops.packing import pack_words
    from hashcat_a5_table_generator_tpu_torch.tables.compile import (
        compile_table,
    )
    from hashcat_a5_table_generator_tpu_torch.tables.layouts import (
        get_layout,
    )

    pool = german_words((n + 1) * SERVE_WORDS, seed=51)
    plan = build_plan(AttackSpec(), compile_table(
        get_layout("german").to_substitution_map()), pack_words(pool))
    slots = (np.asarray(plan.match_radix) > 1).sum(axis=1)
    pool = [w for w, k in zip(pool, slots) if k <= GERMAN_SERVE_SLOTS]
    return [pool[i * SERVE_WORDS:(i + 1) * SERVE_WORDS] for i in range(n)]


def serve_tenants(work: str, paths: dict, german: bool = False) -> list:
    """Phase 10's small tenants: 6 distinct slices of the crack recipe x
    qwerty-cyrillic x MD5, 2 of czech x NTLM and, with ``german``, 2 of
    german x MD5 (:func:`german_serve_words`: the byte-scan route), each
    with its own :data:`SERVE_DIGESTS`-digest list of which about
    :data:`SERVE_PLANTED` are its candidates; written as files, with each
    tenant's solo ``Sweep.run_crack`` on the card and its route."""
    from hashcat_a5_table_generator_tpu_torch.cli import _read_digests
    from hashcat_a5_table_generator_tpu_torch.models.attack import (
        AttackSpec, build_plan,
    )
    from hashcat_a5_table_generator_tpu_torch.ops.packing import (
        pack_words, read_wordlist,
    )
    from hashcat_a5_table_generator_tpu_torch.runtime.sweep import (
        Sweep, SweepConfig,
    )
    from hashcat_a5_table_generator_tpu_torch.tables.compile import (
        compile_table,
    )
    from hashcat_a5_table_generator_tpu_torch.tables.layouts import (
        emit_table, get_layout,
    )
    from hashcat_a5_table_generator_tpu_torch.tables.parser import (
        load_tables,
    )
    from hashcat_a5_table_generator_tpu_torch.utils.digests import (
        HOST_DIGEST,
    )

    def recipe(path):
        # The recipe's 6-10 letter words (not phase 4's long lines).
        return [w for w in read_wordlist(path) if len(w) <= 10]

    def slices(pool, n):
        return [pool[i * SERVE_WORDS:(i + 1) * SERVE_WORDS]
                for i in range(n)]

    # (id prefix, algo, layout, table, word slices); the family's index
    # seeds its planted digests.
    pools = [("", "md5", "qwerty-cyrillic", paths["cyrillic-md5"].table,
              slices(recipe(paths["cyrillic-md5"].wordlist), 6)),
             ("", "ntlm", "czech", paths["czech-ntlm"].table,
              slices(recipe(paths["czech-ntlm"].wordlist), 2))]
    if german:
        table = os.path.join(work, "serve-german.table")
        emit_table(get_layout("german"), table)
        pools.append(("german-", "md5", "german", table,
                      german_serve_words(2)))
    tenants = []
    for fam, (prefix, algo, layout, table, word_sets) in enumerate(pools):
        sub = load_tables([table])
        ct = compile_table(sub)
        spec = AttackSpec(algo=algo)
        for i, words in enumerate(word_sets):
            plan = build_plan(spec, ct, pack_words(words))
            rng = np.random.default_rng(1000 + 10 * i + fam)
            rows = [r for r in rng.permutation(len(words))
                    if plan.n_variants[r] >= 2][:SERVE_PLANTED]
            # The first word hits too: every tenant's first hit comes in
            # its first superstep (the churn session cancels on it).
            rows = [next(r for r in range(len(words))
                         if plan.n_variants[r] >= 2)] + rows[1:]
            planted = [HOST_DIGEST[algo](planted_variant(
                plan, ct, spec, int(r), rng)) for r in rows]
            decoys = rng.integers(0, 256, size=(SERVE_DIGESTS - len(planted),
                                                len(planted[0])),
                                  dtype=np.uint8)
            name = f"{prefix}{algo}-{i}"
            wl = os.path.join(work, f"serve-{name}.words.txt")
            dg = os.path.join(work, f"serve-{name}.digests.txt")
            with open(wl, "wb") as fh:
                fh.write(b"\n".join(words) + b"\n")
            with open(dg, "w") as fh:
                fh.write("".join(d.hex() + "\n" for d in planted))
                fh.write("".join(bytes(d).hex() + "\n" for d in decoys))
            t = time.monotonic()
            sweep = Sweep(spec, sub, read_wordlist(wl),
                          _read_digests(dg, algo),
                          SweepConfig(device=SERVE_DEVICE))
            res = sweep.run_crack()
            tenants.append({
                "id": name, "algo": algo, "layout": layout, "table": table,
                "wordlist": wl, "digests": dg, "solo_s": time.monotonic() - t,
                "solo": [(h.word_index, h.variant_rank, h.candidate.hex(),
                          h.digest_hex) for h in res.hits],
                "solo_emitted": res.n_emitted, "route": sweep.route,
                "solo_kernels": res.kernels})
    return tenants


def planted_variant(plan, ct, spec, row: int, rng) -> bytes:
    """A random emitted candidate of plan row ``row`` (rank >= 1): ranks
    the device does not emit (an overlap clash of german's ``ss`` in
    "sss") are drawn again."""
    from hashcat_a5_table_generator_tpu_torch.models.attack import (
        decode_variant,
    )

    for _ in range(64):
        rank = 1 + int(rng.integers(0, plan.n_variants[row] - 1))
        try:
            return decode_variant(plan, ct, spec, row, rank)
        except ValueError:
            continue
    fail(f"serve: no emitted candidate found for plan row {row}")


def submit_doc(t: dict, jid=None, **extra) -> dict:
    return {"op": "submit", "id": jid or t["id"], "tables": [t["table"]],
            "dict": t["wordlist"], "digests": t["digests"],
            "algo": t["algo"], **extra}


def serve_session(work: str, name: str, tenants: list, crack: dict,
                  args) -> dict:
    """One ``a5gen serve`` session over every tenant and phase 4's crack
    cell; each job's events checked against its solo run; the stats,
    launches and walls."""
    sp = ServeProcess(work, name, args)
    sent = {}
    for t in tenants + [crack]:
        sent[t["id"]] = time.monotonic()
        sp.send(submit_doc(t))
    ids = [t["id"] for t in tenants + [crack]]
    # A stats reply while the tenants run: the fused groups dispatching.
    sp.wait_for(lambda e: any(x["event"] == "hit" for x in e), "a hit")
    sp.send({"op": "stats"})
    evs = sp.wait_for(lambda e: sum(x["event"] in SETTLE and x.get("id")
                                    in ids for x in e) >= len(ids),
                      f"{len(ids)} jobs", timeout=300)
    sp.send({"op": "stats"})
    evs = sp.wait_for(lambda e: sum(x["event"] == "stats" for x in e) >= 2,
                      "stats")
    mid, stats = [x for x in evs if x["event"] == "stats"]
    out = sp.close()
    jobs = per_job(evs)
    walls = {}
    for t in tenants:
        got = hit_tuples(jobs[t["id"]])
        done = jobs[t["id"]][-1]
        if done["event"] != "done":
            fail(f"serve {name}: {t['id']} settled {done}")
        if got != t["solo"]:
            fail(f"serve {name}: {t['id']}'s hit events differ from its solo "
                 f"run ({len(got)} vs {len(t['solo'])} hits)")
        if (done["n_hits"], done["n_emitted"]) != (len(t["solo"]),
                                                   t["solo_emitted"]):
            fail(f"serve {name}: {t['id']} done {done}, solo "
                 f"{len(t['solo'])} hits {t['solo_emitted']} hashed")
        walls[t["id"]] = done["wall_s"]
    cj = jobs[crack["id"]]
    done = cj[-1]
    got = hit_tuples(cj)
    if done["event"] != "done" or got != sorted(got):
        fail(f"serve {name}: the crack cell settled {done['event']} or its "
             "hits are not in (word, rank) order")
    lines = sorted(f"{d}:{bytes.fromhex(p).decode('utf-8', 'surrogateescape')}"
                   .encode("utf-8", "surrogateescape") for _w, _r, p, d in got)
    want = sorted(crack["stdout"].splitlines())
    if lines != want or done["n_emitted"] != crack["emitted"] \
            or done["n_hits"] != len(want):
        fail(f"serve {name}: the crack cell's {len(lines)} hit events / "
             f"{done['n_emitted']} hashed differ from phase 4's stdout "
             f"({len(want)} lines, {crack['emitted']} hashed)")
    walls[crack["id"]] = done["wall_s"]
    keys = ("fused_groups", "packed_dispatches", "packed_fill",
            "programs_compiled", "program_cache_hits", "jobs_done")
    report = {"stats": {k: stats[k] for k in keys},
              "fused_groups_running": mid["fused_groups"],
              "jobs_active_running": mid["jobs_active"],
              "launches": out["launches"],
              "group_launches": out["group_launches"],
              "group_lanes": out["group_lanes"], "job_wall_s": walls,
              "serve_wall_s": out["wall_s"]}
    log(f"serve {name}: {len(ids)} jobs, every stream identical to its solo "
        f"run (the crack cell's to phase 4's stdout: {len(want)} hits, "
        f"{done['n_emitted']} hashed); {mid['fused_groups']} fused groups "
        f"and {mid['jobs_active']} jobs active at the first hit; stats at "
        f"the end {report['stats']}; launches "
        f"{out['launches']}, of them in fused groups' packed supersteps "
        f"{out['group_launches']}; job walls {walls}; serve process wall "
        f"{out['wall_s']:.2f} s")
    return report


def churn_session(work: str, tenants: list) -> dict:
    """The 6 cyrillic tenants in one session (:data:`CHURN_CONFIG`): 4
    cancelled on their first hit; the survivors, re-fused, paused — one
    resumed with the ``resume`` op, one resubmitted from its ``paused``
    checkpoint as a migrating job — each ending with its solo hits."""
    cyr = [t for t in tenants if t["layout"] == "qwerty-cyrillic"]
    # Staging puts tenants 0-3 in one group of 4 and 4-5 in a group of 2:
    # cancelling 0, 1, 2 and 4 thins both (fill 1/4 and 1/2, below the
    # 0.6 threshold), so the survivors 3 and 5 re-fuse across groups.
    victims = [cyr[i]["id"] for i in (0, 1, 2, 4)]
    a, b = cyr[3], cyr[5]
    sp = ServeProcess(work, "churn", ["--pack", "auto"],
                      env={"A5GEN_REFUSE": "0.6"})
    sp.send(*[submit_doc(t, config=CHURN_CONFIG) for t in cyr])
    cancelled_at = {}
    pending = set(victims)
    while pending:
        evs = sp.wait_for(lambda e: any(x["event"] == "hit" and x["id"]
                                        in pending for x in e),
                          "a victim's first hit")
        for x in evs:
            if x["event"] == "hit" and x["id"] in pending:
                pending.discard(x["id"])
                sp.send({"op": "cancel", "id": x["id"]})
                cancelled_at[x["id"]] = time.monotonic()
    evs = sp.wait_for(lambda e: sum(x["event"] == "refused" and x["id"]
                                    in (a["id"], b["id"]) for x in e) >= 2,
                      "refused events for both survivors", timeout=120)
    refused = [x for x in evs if x["event"] == "refused"]
    # Survivor a: paused, then resumed on this engine.
    sp.send({"op": "pause", "id": a["id"]})
    sp.wait_for(lambda e: any(x["event"] in ("paused", "done") and
                              x["id"] == a["id"] for x in e), "a's pause")
    sp.send({"op": "resume", "id": a["id"]})
    # Survivor b: paused, its checkpoint submitted as a new job.
    sp.send({"op": "pause", "id": b["id"]})
    evs = sp.wait_for(lambda e: any(x["event"] in ("paused", "done") and
                                    x["id"] == b["id"] for x in e),
                      "b's pause")
    pb = next(x for x in evs if x["id"] == b["id"] and x["event"] in
              ("paused", "done"))
    moved = b["id"] + "-migrated"
    if pb["event"] == "paused":
        sp.send(submit_doc(b, moved, checkpoint=pb["checkpoint"],
                           config=CHURN_CONFIG))
    want_settled = [a["id"]] + ([moved] if pb["event"] == "paused" else [])
    evs = sp.wait_for(lambda e: all(
        any(x["event"] == "done" and x["id"] == j for x in e)
        for j in want_settled) and sum(x["event"] == "cancelled"
                                       for x in e) >= 4,
        "the survivors' done events")
    sp.send({"op": "stats"})
    evs = sp.wait_for(lambda e: any(x["event"] == "stats" for x in e),
                      "stats")
    stats = next(x for x in evs if x["event"] == "stats")
    out = sp.close()
    jobs = per_job(evs)
    for v in victims:
        if jobs[v][-1]["event"] != "cancelled":
            fail(f"churn: victim {v} settled {jobs[v][-1]['event']} (its "
                 "sweep ended before the cancel landed)")
    a_hits = set(hit_tuples(jobs[a["id"]]))
    b_hits = set(hit_tuples(jobs[b["id"]]) + hit_tuples(jobs.get(moved, [])))
    paused = {j: [x["event"] for x in jobs[j]].count("paused")
              for j in (a["id"], b["id"])}
    for t, got in ((a, a_hits), (b, b_hits)):
        if got != set(t["solo"]):
            fail(f"churn: survivor {t['id']}'s hits before and after the "
                 f"pause ({len(got)}) differ from its solo run "
                 f"({len(t['solo'])})")
        if not any(x["event"] == "refused" for x in jobs[t["id"]]):
            fail(f"churn: survivor {t['id']} got no refused event")
    report = {"cancelled": victims, "refused": refused,
              "paused": paused, "migrated": moved in jobs,
              "refuse_total": stats["refuse_total"],
              "refuse_cross": stats["refuse_cross"],
              "packed_fill_min": stats["packed_fill_min"],
              "serve_wall_s": out["wall_s"], "launches": out["launches"],
              "group_launches": out["group_launches"]}
    log(f"serve churn: {victims} cancelled on their first hits, survivors "
        f"refused ({refused}), paused ({paused}), one resumed, one "
        f"resubmitted from its checkpoint; union of each survivor's hits "
        f"= its solo run; refuse_total {stats['refuse_total']}, "
        f"refuse_cross {stats['refuse_cross']}; launches {out['launches']}, "
        f"of them in fused groups {out['group_launches']}; wall "
        f"{out['wall_s']:.2f} s")
    return report


def prometheus_ok(text: str) -> int:
    """The sample lines of a Prometheus text exposition, checked; their
    count."""
    sample = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? "
                        r"[-+]?([0-9.]+(e[-+]?[0-9]+)?|inf|nan)$")
    n = 0
    for line in text.splitlines():
        if line.startswith("# TYPE ") or not line:
            continue
        if not sample.match(line):
            fail(f"metrics: not a Prometheus sample line: {line!r}")
        n += 1
    return n


def socket_server(work: str) -> "tuple[ServeProcess, str]":
    """``a5gen serve --socket`` started; its process and the socket's
    path as the process sees it (relative to the checkout: a unix socket's
    path must stay under ~108 bytes, whatever the checkout's)."""
    path = os.path.relpath(os.path.join(work, "serve.sock"), HERE)
    sp = ServeProcess(work, "socket", ["--socket", path,
                                       "--client-timeout", "60"])
    return sp, path


def socket_session(t: dict, server) -> dict:
    """``a5gen serve --socket`` (:func:`socket_server`): one tenant,
    ``stats``, ``metrics``, ``shutdown`` → ``bye``; every read bounded."""
    import socket

    sp, rel = server
    path = os.path.join(HERE, rel)
    deadline = time.monotonic() + 120
    while not os.path.exists(path):
        if time.monotonic() > deadline or sp.proc.poll() is not None:
            fail("serve --socket: the socket never appeared")
        time.sleep(0.05)
    short = os.path.relpath(path)
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.settimeout(180)
        s.connect(short if len(short) < len(path) else path)
        fin, fout = s.makefile("r"), s.makefile("w")

        def ask(doc):
            fout.write(json.dumps(doc) + "\n")
            fout.flush()

        def reply():
            try:
                line = fin.readline()
            except OSError as e:  # the socket's timeout
                fail(f"serve --socket: no reply within 180 s ({e})")
            if not line:
                fail("serve --socket: the server closed the connection")
            return json.loads(line)

        ask(submit_doc(t))
        evs = []
        while not evs or evs[-1]["event"] not in SETTLE:
            evs.append(reply())
        ask({"op": "stats"})
        stats = reply()
        ask({"op": "metrics"})
        metrics = reply()
        ask({"op": "shutdown"})
        bye = reply()
    out = sp.close()
    if hit_tuples(evs) != t["solo"] or evs[-1]["event"] != "done":
        fail("serve --socket: the tenant's events differ from its solo run")
    if stats["event"] != "stats" or bye != {"event": "bye"}:
        fail(f"serve --socket: stats {stats.get('event')}, last {bye}")
    n = prometheus_ok(metrics["prometheus"])
    log(f"serve --socket: {len(evs)} events, stats, metrics ({n} "
        f"Prometheus samples, engine-labelled), shutdown -> bye; wall "
        f"{out['wall_s']:.2f} s")
    return {"events": len(evs), "prometheus_samples": n, "bye": True,
            "serve_wall_s": out["wall_s"]}


def serve_inputs(work: str, paths: dict, runs: dict,
                 german: bool = False) -> tuple:
    """Phase 10's inputs, which phase 11 reuses: its directory, the 8
    tenants (and, with ``german``, phase 10's 2 german ones) with their
    solo runs (:func:`serve_tenants`) and phase 4's crack cell (its
    files, stdout and candidates hashed)."""
    work = os.path.join(work, "serve")
    os.makedirs(work, exist_ok=True)
    tenants = serve_tenants(work, paths, german)
    log(f"serve: {len(tenants)} tenants, solo runs {[round(t['solo_s'], 2) for t in tenants]} s, "
        f"{[len(t['solo']) for t in tenants]} hits")
    crack = {"id": "crack-cell", "algo": "md5",
             "table": paths["cyrillic-md5"].table,
             "wordlist": paths["cyrillic-md5"].wordlist,
             "digests": paths["cyrillic-md5"].digests,
             "stdout": runs[("cyrillic-md5", "pair auto")]["stdout"],
             "emitted": runs[("cyrillic-md5", "pair auto")]["emitted"]}
    return work, tenants, crack


def serve_phase(work: str, paths: dict, runs: dict, card: str
                ) -> "tuple[dict, tuple]":
    """Phase 10 (see the module docstring).  Returns the phase's numbers
    and its inputs (:func:`serve_inputs`), which phase 11 reuses."""
    t_phase = time.monotonic()
    work, tenants, crack = serve_inputs(work, paths, runs, german=True)
    # Phase 11 takes the 8 tenants it always took.
    inputs = (work, [t for t in tenants if t["layout"] != "german"], crack)
    # Do the two czech tenants share a packed key?
    from hashcat_a5_table_generator_tpu_torch.ops.packing import (
        read_wordlist,
    )
    from hashcat_a5_table_generator_tpu_torch.models.attack import AttackSpec
    from hashcat_a5_table_generator_tpu_torch.runtime.fuse import (
        pack_candidate,
    )
    from hashcat_a5_table_generator_tpu_torch.runtime.sweep import (
        Sweep, SweepConfig,
    )
    from hashcat_a5_table_generator_tpu_torch.tables.parser import (
        load_tables,
    )

    def key_diff(layout: str, algo: str) -> str:
        keys = []
        for t in [t for t in tenants if t["layout"] == layout]:
            sw = Sweep(AttackSpec(algo=algo), load_tables([t["table"]]),
                       read_wordlist(t["wordlist"]), [bytes(16)],
                       SweepConfig(device=SERVE_DEVICE))
            c = pack_candidate(sw)
            keys.append(None if c is None else c["key"])
        names = ("route", "tier", "byte-scan tier", "spec", "lanes",
                 "blocks", "stride", "steps", "hit_cap", "out_width",
                 "windowed", "devices", "pipeline", "array shapes",
                 "group descriptors", "schema structure", "radix2", "pair",
                 "decode", "pack_cb", "k_vals", "retries", "fetch timeout")
        return ("equal" if keys[0] == keys[1] else "differ in " + ", ".join(
            n for n, x, y in zip(names, keys[0] or (), keys[1] or ())
            if x != y))

    czech_key = key_diff("czech", "ntlm")
    log(f"serve: the two czech x NTLM tenants' packed keys {czech_key}")
    # The german tenants: the byte-scan route (no piece schema) and one
    # packed key, so they fuse into one byte-scan group.
    german = [t for t in tenants if t["layout"] == "german"]
    german_key = key_diff("german", "md5")
    if any(t["route"] != "bytescan" for t in german) or \
            german_key != "equal":
        fail(f"serve: the german tenants' routes "
             f"{[t['route'] for t in german]} (byte-scan expected), packed "
             f"keys {german_key} (equal expected)")
    log(f"serve: the two german x MD5 tenants take the byte-scan route "
        f"({[t['solo_kernels'] for t in german]} solo) and their packed "
        f"keys are equal")
    report = {"czech_keys": czech_key}
    report["pack_auto"] = serve_session(work, "pack-auto", tenants, crack,
                                        ["--pack", "auto"])
    st = report["pack_auto"]
    # The fused groups' own launches: every packed dispatch launched the
    # piece kernel or the byte-scan kernel (one launch a step), and
    # nothing else; the german group launched the byte-scan kernel.
    grouped = st["group_launches"]
    scan = {k: v for k, v in grouped.items()
            if k.startswith("bytescan_") and k.endswith("/md5")}
    piece = sum(grouped.get(k, 0) for k in ("piece_k1/md5",
                                             "piece_pair/md5"))
    if st["stats"]["packed_dispatches"] <= 0 or not scan or \
            piece + sum(scan.values()) < st["stats"]["packed_dispatches"] \
            or set(grouped) - {"piece_k1/md5", "piece_pair/md5"} - set(scan):
        fail(f"serve --pack auto: the fused groups' packed supersteps "
             f"launched {grouped}: not piece_k1 / piece_pair / bytescan_* "
             f"at least once a packed dispatch, or no bytescan_*/md5 "
             f"({st['stats']})")
    if any(k.startswith("buffer_hash") for k in st["launches"]):
        fail(f"serve --pack auto: launches on the XLA route "
             f"{st['launches']}")
    lanes = {k: v for k, v in st["group_lanes"].items()
             if k.startswith("bytescan_")}
    report["german"] = {
        "group_launches": scan,
        "packed_fill": {k: occ / tot for k, (occ, tot) in lanes.items()},
        "job_wall_s": {t["id"]: st["job_wall_s"][t["id"]] for t in german},
        "solo_s": {t["id"]: t["solo_s"] for t in german}}
    log(f"serve --pack auto: the german tenants' byte-scan group launched "
        f"{scan}, packed_fill {report['german']['packed_fill']} "
        f"(occupied / total lanes {lanes}); their walls "
        f"{report['german']['job_wall_s']} s in the session, "
        f"{report['german']['solo_s']} s solo")
    report["pack_off"] = serve_session(work, "pack-off", tenants, crack,
                                       ["--pack", "off"])
    if report["pack_off"]["stats"]["packed_dispatches"] != 0 or \
            report["pack_off"]["group_launches"]:
        fail(f"serve --pack off: packed dispatches ran "
             f"({report['pack_off']['group_launches']})")
    # The socket server starts beside the churn session (it idles until
    # its client connects: only the two start-ups overlap).
    server = socket_server(work)
    report["churn"] = churn_session(work, tenants)
    report["socket"] = socket_session(tenants[0], server)
    report["phase_s"] = time.monotonic() - t_phase
    log(f"serve phase {report['phase_s']:.1f} s on {card}")
    return report, inputs


# ---------------------------------------------------------------------------
# Phase 11: the fleet router (a5gen fleet) over two engines on the card
# ---------------------------------------------------------------------------

#: Extra ``a5gen fleet`` flags (a CPU rehearsal passes ``--device cpu``).
FLEET_ARGS: list = []
#: The drain and kill sessions' job geometry: 16 launches of 2^18 lanes a
#: 20,000-word tenant, one launch a superstep, so a drain or a SIGKILL
#: sent on a first hit finds the jobs mid-sweep.
FLEET_CONFIG = {"lanes": 1 << 18, "superstep": 1}
#: ``a5gen fleet`` through the CLI's entry point.  Its spawned engines
#: (``python -m hashcat_a5_table_generator_tpu_torch serve ...``, the
#: command recorded) run the same ``serve`` through
#: :data:`SERVE_WRAPPER` (read from the file argv[2]), so each engine
#: prints its kernel launches at exit to a stderr file of its own; each
#: engine's pid goes to the log (argv[1]), one JSON line an engine.
FLEET_WRAPPER = (
    "import json, subprocess, sys\n"
    "from hashcat_a5_table_generator_tpu_torch import cli\n"
    "from hashcat_a5_table_generator_tpu_torch.runtime import fleet\n"
    "log, wrapper = sys.argv[1], open(sys.argv[2]).read()\n"
    "class Popen(subprocess.Popen):\n"
    "    def __init__(self, args, **kw):\n"
    "        args = list(args)\n"
    "        eid = args[args.index('--engine-id') + 1]\n"
    "        kw['stderr'] = open(f'{log}.{eid}.err', 'w')\n"
    "        super().__init__([args[0], '-c', wrapper] + args[3:], **kw)\n"
    "        with open(log, 'a') as fh:\n"
    "            fh.write(json.dumps({'engine': eid, 'pid': self.pid,\n"
    "                                 'cmd': args}) + '\\n')\n"
    "fleet.subprocess = type(sys)('subprocess')\n"
    "fleet.subprocess.__dict__.update(subprocess.__dict__, Popen=Popen)\n"
    "sys.exit(cli.main(sys.argv[3:]))\n")


class FleetProcess(ServeProcess):
    """One ``a5gen fleet --engines N`` process (:data:`FLEET_WRAPPER`;
    N = ``engines``, 2 by default), JSONL on its stdin, its events read
    on a thread; a session of its own, so a failure kills its engines
    with it."""

    def __init__(self, work: str, name: str, args=(),
                 engines: int = 2) -> None:
        self.name = name
        self.n_engines = engines
        self.err_path = os.path.join(work, f"fleet-{name}.err")
        self.err = open(self.err_path, "w")
        self.log = os.path.join(work, f"fleet-{name}.engines")
        wrapper = os.path.join(work, "serve_wrapper.py")
        with open(wrapper, "w") as fh:
            fh.write(SERVE_WRAPPER)
        # Unix socket paths stay short: relative to the checkout.
        eng_dir = os.path.relpath(os.path.join(work, f"eng-{name}"), HERE)
        self.t0 = time.monotonic()
        self.proc = spawn(
            [sys.executable, "-c", FLEET_WRAPPER, self.log, wrapper,
             "fleet", "--engines", str(engines), "--engine-dir", eng_dir,
             *FLEET_ARGS, *args], stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=self.err, text=True, cwd=HERE,
            start_new_session=True)
        self.events: list = []
        #: each event's arrival (monotonic s), beside :attr:`events`
        self.stamps: list = []
        self.lock = threading.Lock()
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            if line.strip():
                ev = json.loads(line)
                with self.lock:
                    self.events.append(ev)
                    self.stamps.append(time.monotonic())

    def engines(self) -> dict:
        """Engine id -> ``{"pid", "cmd"}`` as spawned."""
        if not os.path.exists(self.log):
            return {}
        with open(self.log) as fh:
            return {d["engine"]: d for d in map(json.loads, fh)}

    def wait_ready(self) -> float:
        """Seconds from start until the router serves (its stderr says so
        once its engines are attached)."""
        deadline = time.monotonic() + 180
        while time.monotonic() < deadline:
            if f"fleet of {self.n_engines} engine(s)" in \
                    open(self.err_path).read():
                return time.monotonic() - self.t0
            if self.proc.poll() is not None:
                break
            time.sleep(0.05)
        fail(f"fleet {self.name}: not serving; stderr "
             f"{open(self.err_path).read()[-2000:]}")

    def close(self, timeout: float = 120) -> dict:
        """``shutdown`` -> ``bye``; the router shuts its engines down.
        The exit code, the wall and each engine's kernel launches (a
        killed engine has none)."""
        self.send({"op": "shutdown"})
        self.wait_for(lambda e: any(x["event"] == "bye" for x in e), "bye")
        self.proc.stdin.close()
        rc = self.proc.wait(timeout)
        self.reader.join(30)
        wall = time.monotonic() - self.t0
        self.err.close()
        if rc != 0:
            fail(f"fleet {self.name} exited {rc}: "
                 f"{open(self.err_path).read()[-3000:]}")
        launches = {}
        for eid in self.engines():
            lines = open(f"{self.log}.{eid}.err").read().strip().splitlines()
            last = json.loads(lines[-1]) if lines and \
                lines[-1].startswith("{") else None
            launches[eid] = last["launches"] if last else "killed"
        return {"rc": rc, "wall_s": wall, "launches": launches}


def fleet_acks(evs: list) -> dict:
    return {e["id"]: e for e in evs if e["event"] == "accepted"}


def check_tenant(name: str, t: dict, evs: list) -> float:
    """A tenant's events through the fleet equal its solo run's: the hit
    events (each once), the ``done`` totals.  Its ``done`` wall."""
    got = hit_tuples(evs)
    done = evs[-1]
    if done["event"] != "done" or got != t["solo"] or \
            (done["n_hits"], done["n_emitted"]) != (len(t["solo"]),
                                                    t["solo_emitted"]):
        fail(f"fleet {name}: {t['id']} settled {done['event']} with "
             f"{len(got)} hits ({len(set(got))} distinct), solo "
             f"{len(t['solo'])}; done {done}")
    return done["wall_s"]


def check_crack(name: str, crack: dict, evs: list) -> None:
    """The crack cell's hit events through the fleet in (word, rank)
    order, each once, and equal as lines to phase 4's stdout."""
    got = hit_tuples(evs)
    done = evs[-1]
    lines = sorted(f"{d}:{bytes.fromhex(p).decode('utf-8', 'surrogateescape')}"
                   .encode("utf-8", "surrogateescape") for _w, _r, p, d in got)
    want = sorted(crack["stdout"].splitlines())
    if done["event"] != "done" or got != sorted(set(got)) or \
            lines != want or done["n_emitted"] != crack["emitted"] or \
            done["n_hits"] != len(want):
        fail(f"fleet {name}: the crack cell settled {done['event']}, "
             f"{len(got)} hit events ({len(set(got))} distinct), "
             f"{done.get('n_emitted')} hashed; phase 4: {len(want)} lines, "
             f"{crack['emitted']} hashed")


def fleet_routed(fp: FleetProcess, tenants: list, crack: dict) -> dict:
    """The 8 tenants and the crack cell (by path: never split) routed by
    affinity: the cyrillic tenants and the crack cell on one engine, the
    czech ones together on the other; each stream its solo run's."""
    t0 = time.monotonic()
    for t in tenants + [crack]:
        fp.send(submit_doc(t))
    ids = [t["id"] for t in tenants + [crack]]
    evs = fp.wait_for(lambda e: sum(x["event"] in SETTLE and x.get("id")
                                    in ids for x in e) >= len(ids),
                      f"{len(ids)} routed jobs", timeout=300)
    wall = time.monotonic() - t0
    acks, jobs = fleet_acks(evs), per_job(evs)
    place = {j: acks[j]["engine"] for j in ids}
    cyr = {place[t["id"]] for t in tenants if t["algo"] == "md5"}
    cz = {place[t["id"]] for t in tenants if t["algo"] == "ntlm"}
    if len(cyr) != 1 or len(cz) != 1 or cyr == cz or \
            place[crack["id"]] not in cyr:
        fail(f"fleet routed: placement {place}: the cyrillic tenants and "
             "the crack cell must share one engine, the czech tenants the "
             "other")
    walls = {t["id"]: check_tenant("routed", t, jobs[t["id"]])
             for t in tenants}
    check_crack("routed", crack, jobs[crack["id"]])
    walls[crack["id"]] = jobs[crack["id"]][-1]["wall_s"]
    log(f"fleet routed: placement {place}; every stream equal to its solo "
        f"run, the crack cell's to phase 4's stdout; job walls {walls}; "
        f"session {wall:.2f} s")
    return {"placement": place, "job_wall_s": walls, "wall_s": wall}


def fleet_split(fp: FleetProcess, crack: dict) -> dict:
    """The crack cell with its words inline under ``--split on``: scattered
    as two pod stripes, one an engine, merged back into phase 4's
    stdout."""
    from hashcat_a5_table_generator_tpu_torch.ops.packing import (
        read_wordlist,
    )

    words = [w.decode("ascii") for w in read_wordlist(crack["wordlist"])]
    jid = "crack-split"
    t0 = time.monotonic()
    fp.send({"op": "submit", "id": jid, "tables": [crack["table"]],
             "words": words, "digests": crack["digests"], "algo": "md5"})
    evs = fp.wait_for(lambda e: any(x["event"] in SETTLE and
                                    x.get("id") == jid for x in e),
                      "the split crack cell", timeout=300)
    wall = time.monotonic() - t0
    ack = fleet_acks(evs)[jid]
    jobs = per_job(evs)
    shard_done = [x for x in jobs[jid] if x["event"] == "shard_done"]
    if ack.get("shards") != 2 or len(shard_done) != 2 or \
            len({x["engine"] for x in shard_done}) != 2:
        fail(f"fleet split: ack {ack}, shard_done {shard_done}: not two "
             "stripes on two engines")
    check_crack("split", crack, [x for x in jobs[jid]
                                 if x["event"] != "shard_done"])
    with fp.lock:
        at = {id(x): t - t0 for x, t in zip(fp.events, fp.stamps)}
    stripes = [{"shard": x["shard"], "engine": x["engine"],
                "n_hits": x["n_hits"], "done_at_s": at[id(x)]}
               for x in shard_done]
    done = jobs[jid][-1]
    log(f"fleet split: the crack cell merged from {stripes}, equal to "
        f"phase 4's stdout; stripe wall (max) {done['wall_s']:.2f} s, "
        f"session {wall:.2f} s")
    return {"stripes": stripes, "stripe_wall_s": done["wall_s"],
            "wall_s": wall}


def fleet_drain(fp: FleetProcess, tenants: list) -> dict:
    """The 6 cyrillic tenants (:data:`FLEET_CONFIG`), all on one engine by
    affinity; on the first hit that engine drains: its jobs migrate to
    the other (pause -> checkpoint -> resubmit) and each ends with its
    solo stream; the drained engine holds no job."""
    cyr = [t for t in tenants if t["algo"] == "md5"]
    ids = {f"{t['id']}@drain": t for t in cyr}
    t0 = time.monotonic()
    fp.send(*[submit_doc(t, jid, config=FLEET_CONFIG)
              for jid, t in ids.items()])
    evs = fp.wait_for(lambda e: any(x["event"] == "hit" and x.get("id")
                                    in ids for x in e), "a first hit")
    src = {fleet_acks(evs)[j]["engine"] for j in ids}
    if len(src) != 1:
        fail(f"fleet drain: the cyrillic tenants on engines {src}")
    src = src.pop()
    n_before = len([x for x in evs if x["event"] == "draining"])
    fp.send({"op": "drain", "engine": src})
    evs = fp.wait_for(lambda e: len([x for x in e if x["event"] ==
                                     "draining"]) > n_before and
                      sum(x["event"] in SETTLE and x.get("id") in ids
                          for x in e) >= len(ids),
                      "the drained jobs", timeout=300)
    wall = time.monotonic() - t0
    drained = [x for x in evs if x["event"] == "draining"][-1]
    jobs = per_job(evs)
    walls = {j: check_tenant("drain", t, jobs[j]) for j, t in ids.items()}
    fp.send({"op": "stats"})
    evs = fp.wait_for(lambda e: any(x["event"] == "stats" for x in e),
                      "stats")
    stats = [x for x in evs if x["event"] == "stats"][-1]["fleet"]
    member = {m["engine"]: m for m in stats["engines"]}[src]
    if drained["jobs"] < 1 or member["jobs_routed"] != 0 or \
            not member["draining"] or stats["migrations"] < drained["jobs"]:
        fail(f"fleet drain: draining {drained}, engine {member}, "
             f"migrations {stats['migrations']}")
    log(f"fleet drain: {src} drained with {drained['jobs']} jobs running; "
        f"each migrated job's stream equal to its solo run; the engine "
        f"now routes {member['jobs_routed']}; session {wall:.2f} s")
    return {"engine": src, "jobs_migrated": drained["jobs"],
            "migrations": stats["migrations"], "job_wall_s": walls,
            "wall_s": wall, "engines": stats["engines"]}


def fleet_kill(fp: FleetProcess, tenants: list) -> dict:
    """The 8 tenants (:data:`FLEET_CONFIG`): the engine carrying the
    cyrillic ones is SIGKILLed after its first hit event; its jobs
    crash-replay onto the survivor, each stream its solo run's, no hit
    delivered twice."""
    import signal

    ids = {f"{t['id']}@kill": t for t in tenants}
    t0 = time.monotonic()
    fp.send(*[submit_doc(t, jid, config=FLEET_CONFIG)
              for jid, t in ids.items()])
    cyr = [j for j, t in ids.items() if t["algo"] == "md5"]
    evs = fp.wait_for(lambda e: all(j in fleet_acks(e) for j in ids) and
                      any(x["event"] == "hit" and x.get("id") in cyr
                          for x in e), "a cyrillic tenant's first hit")
    acks = fleet_acks(evs)
    victim = acks[cyr[0]]["engine"]
    on_victim = [j for j in ids if acks[j]["engine"] == victim]
    unsettled = [j for j in on_victim
                 if not any(x["event"] in SETTLE and x.get("id") == j
                            for x in evs)]
    pid = fp.engines()[victim]["pid"]
    os.kill(pid, signal.SIGKILL)
    t_kill = time.monotonic()
    evs = fp.wait_for(lambda e: sum(x["event"] in SETTLE and x.get("id")
                                    in ids for x in e) >= len(ids),
                      "the replayed jobs", timeout=300)
    after = time.monotonic() - t_kill
    jobs = per_job(evs)
    walls = {j: check_tenant("kill", t, jobs[j]) for j, t in ids.items()}
    fp.send({"op": "stats"})
    evs = fp.wait_for(lambda e: any(x["event"] == "stats" for x in e),
                      "stats")
    stats = [x for x in evs if x["event"] == "stats"][-1]["fleet"]
    if stats["engine_deaths"] != 1 or stats["engines_alive"] != 1 or \
            stats["jobs_replayed"] < len(unsettled) or not unsettled:
        fail(f"fleet kill: {victim} killed with {unsettled} running; "
             f"deaths {stats['engine_deaths']}, alive "
             f"{stats['engines_alive']}, replayed {stats['jobs_replayed']}")
    log(f"fleet kill: {victim} SIGKILLed with {len(unsettled)} of its "
        f"{len(on_victim)} jobs running; {stats['jobs_replayed']} replayed "
        f"onto the survivor, every stream equal to its solo run, no hit "
        f"twice; last done {after:.2f} s after the kill; session "
        f"{time.monotonic() - t0:.2f} s")
    return {"engine": victim, "jobs_on_engine": len(on_victim),
            "jobs_running_at_kill": len(unsettled),
            "jobs_replayed": stats["jobs_replayed"],
            "engine_deaths": stats["engine_deaths"],
            "after_kill_s": after, "job_wall_s": walls,
            "wall_s": time.monotonic() - t0}


#: The elastic fleet's flags: one engine to start, at most two; one
#: routed job an engine, so a burst queues on the router; one tick over
#: 1.5 queued-or-routed jobs an engine spawns, two ticks (the scale-down
#: window is twice the up window) under 0.25 drain the idlest engine; a
#: tick every 0.5 s, 1 s between actions.
ELASTIC_ARGS = ["--autoscale", "1:2", "--engine-capacity", "1",
                "--scale-up-at", "1.5", "--scale-down-at", "0.25",
                "--scale-window", "1", "--scale-cooldown", "1",
                "--poll", "0.5"]


def fleet_stats(fp: FleetProcess) -> dict:
    """One ``stats`` op's ``fleet`` section."""
    with fp.lock:
        n = sum(1 for x in fp.events if x["event"] == "stats")
    fp.send({"op": "stats"})
    evs = fp.wait_for(lambda e: sum(1 for x in e if x["event"] == "stats")
                      > n, "stats")
    return [x for x in evs if x["event"] == "stats"][-1]["fleet"]


def fleet_elastic(fp: FleetProcess, tenants: list, crack: dict,
                  routed_wall: float) -> dict:
    """The autoscaler (:data:`ELASTIC_ARGS`): the crack cell and the 8
    tenants (:data:`FLEET_CONFIG`) submitted together to a fleet of one
    engine queue on the router; the autoscaler spawns a second engine, which attaches and
    takes placements (its kernel launches at exit); every stream equals
    its solo run's (the crack cell's phase 4's stdout); once the burst
    is done the idlest engine, the spawned one, is drained and reaped
    and its process is gone: one scale-up and one scale-down in the
    ``stats`` op's ``fleet.autoscale``."""
    jobs = [crack] + tenants
    ids = [t["id"] for t in jobs]
    # The tenants at the drain and kill sessions' geometry (one launch a
    # superstep): the burst outlasts the spawned engine's start-up, so it
    # takes placements.
    docs = [submit_doc(crack)] + [submit_doc(t, config=FLEET_CONFIG)
                                  for t in tenants]
    attached: dict = {}
    stop = threading.Event()

    def watch():
        # The router's stderr says when the spawned engine attached.
        while not stop.is_set():
            if "scaled UP" in open(fp.err_path).read():
                attached["at"] = time.monotonic()
                return
            time.sleep(0.02)

    watcher = threading.Thread(target=watch, daemon=True)
    t0 = time.monotonic()
    watcher.start()
    fp.send(*docs)
    evs = fp.wait_for(lambda e: sum(x["event"] in SETTLE and x.get("id")
                                    in ids for x in e) >= len(ids),
                      f"{len(ids)} jobs through the elastic fleet",
                      timeout=300)
    wall = time.monotonic() - t0
    stop.set()
    watcher.join(5)
    jobs_ev = per_job(evs)
    walls = {t["id"]: check_tenant("elastic", t, jobs_ev[t["id"]])
             for t in tenants}
    check_crack("elastic", crack, jobs_ev[crack["id"]])
    walls[crack["id"]] = jobs_ev[crack["id"]][-1]["wall_s"]
    if "at" not in attached:
        fail(f"fleet elastic: no engine attached during the burst; router "
             f"stderr {open(fp.err_path).read()[-2000:]}")
    # The scale-down: the idle fleet drains and reaps back to one engine.
    t_idle = time.monotonic()
    deadline = t_idle + 60
    while True:
        stats = fleet_stats(fp)
        scale = stats["autoscale"]
        if scale["scale_downs"] >= 1 and len(stats["engines"]) == 1 and \
                not scale["reaping"]:
            break
        if time.monotonic() > deadline:
            fail(f"fleet elastic: no scale-down 60 s after the burst: "
                 f"{stats}")
        time.sleep(0.25)
    reaped_after = time.monotonic() - t_idle
    spawned = fp.engines()
    kept = [m["engine"] for m in stats["engines"]]
    if (scale["scale_ups"], scale["scale_downs"], scale["spawn_failures"]) \
            != (1, 1, 0) or sorted(spawned) != ["eng0", "eng1"] or \
            kept != ["eng0"] or stats["engines_detached"] != 1:
        fail(f"fleet elastic: autoscale {scale}, spawned {sorted(spawned)}, "
             f"engines left {kept}, detached {stats['engines_detached']}")
    try:
        os.kill(spawned["eng1"]["pid"], 0)
        fail(f"fleet elastic: the reaped engine eng1 (pid "
             f"{spawned['eng1']['pid']}) is still running")
    except ProcessLookupError:
        pass
    lines = open(f"{fp.log}.eng1.err").read().strip().splitlines()
    launched = json.loads(lines[-1])["launches"] if lines and \
        lines[-1].startswith("{") else {}
    if not any(k.startswith("piece_") for k in launched):
        fail(f"fleet elastic: the spawned engine took no placements "
             f"(launches {launched})")
    attach_s = attached["at"] - t0
    log(f"fleet elastic: 1 scale-up, the second engine attached "
        f"{attach_s:.2f} s after the submit and launched {launched}; every "
        f"stream equal to its solo run, the crack cell's to phase 4's "
        f"stdout; job walls {walls}; session {wall:.2f} s (the routed "
        f"fleet of two engines: {routed_wall:.2f} s); 1 scale-down: eng1 "
        f"drained, reaped and its process gone {reaped_after:.2f} s after "
        "the burst")
    return {"attach_s": attach_s, "wall_s": wall,
            "routed_wall_s": routed_wall, "job_wall_s": walls,
            "reaped_after_s": reaped_after, "autoscale": scale,
            "spawned_engine_launches": launched}


def fleet_phase(work: str, inputs: tuple, card: str) -> dict:
    """Phase 11 (see the module docstring).  Returns the phase's
    numbers."""
    t_phase = time.monotonic()
    _serve_work, tenants, crack = inputs
    work = os.path.join(work, "fleet")
    os.makedirs(work, exist_ok=True)
    # The kill session's fleet and the elastic one start first: their
    # engines come up while the first fleet works.
    fk = FleetProcess(work, "kill")
    fe = FleetProcess(work, "elastic", ELASTIC_ARGS, engines=1)
    fa = FleetProcess(work, "routed", ["--split", "on"])
    report = {"ready_s": fa.wait_ready()}
    device = (FLEET_ARGS[FLEET_ARGS.index("--device") + 1]
              if "--device" in FLEET_ARGS else "cuda")
    for eid, e in fa.engines().items():
        cmd = e["cmd"]
        if cmd[1:4] != ["-m", "hashcat_a5_table_generator_tpu_torch",
                        "serve"] or cmd[cmd.index("--device") + 1] != device:
            fail(f"fleet: engine {eid} spawned as {cmd}")
    report["engine_cmd"] = fa.engines()["eng0"]["cmd"][1:4]
    report["routed"] = fleet_routed(fa, tenants, crack)
    report["split"] = fleet_split(fa, crack)
    report["drain"] = fleet_drain(fa, tenants)
    out = fa.close()
    for eid, launched in out["launches"].items():
        if not launched or any(k.startswith("buffer_hash")
                               for k in launched):
            fail(f"fleet: engine {eid} launched {launched}")
    report["launches"] = out["launches"]
    report["routed_fleet_wall_s"] = out["wall_s"]
    fk.wait_ready()
    report["kill"] = fleet_kill(fk, tenants)
    out = fk.close()
    report["kill"]["launches"] = out["launches"]
    fe.wait_ready()
    report["elastic"] = fleet_elastic(fe, tenants, crack,
                                      report["routed"]["wall_s"])
    out_e = fe.close()
    report["elastic"]["launches"] = out_e["launches"]
    report["phase_s"] = time.monotonic() - t_phase
    log(f"fleet: engine launches {report['launches']} (kill session "
        f"{out['launches']}; elastic session {out_e['launches']}); phase "
        f"{report['phase_s']:.1f} s on {card}")
    return report


# ---------------------------------------------------------------------------
# Phase 12: the geometry tuner (a5gen tune) and a profile-resolved sweep
# ---------------------------------------------------------------------------

#: The tune contract's words in the bounded matrix (the reference's
#: default is 512: ~1 ms of drive on this card), each arm's timed wall and
#: the matrix's lane counts.
TUNE_WORDS = 20_000
TUNE_SECONDS = 1.0
TUNE_LANES = [1 << 20, 1 << 22]
#: Whether resolving a sweep's geometry creates a CUDA context: a process
#: of its own reads the device's name (``runtime.tune.current_device_kind``)
#: and builds a ``Sweep`` with its geometry left to the runtime (no
#: context may exist after either), then runs it (one exists after).
CONTEXT_PROBE = (
    "import json, torch\n"
    "from hashcat_a5_table_generator_tpu_torch.models.attack import "
    "AttackSpec\n"
    "from hashcat_a5_table_generator_tpu_torch.runtime.sweep import Sweep, "
    "SweepConfig\n"
    "from hashcat_a5_table_generator_tpu_torch.runtime.tune import "
    "current_device_kind\n"
    "ctx = lambda: bool(torch._C._cuda_hasPrimaryContext(0))\n"
    "kind = current_device_kind('cuda')\n"
    "named = ctx()\n"
    "s = Sweep(AttackSpec(), {b'a': [b'4']}, [b'password'], [bytes(16)], "
    "SweepConfig())\n"
    "built, lanes = ctx(), s.config.lanes\n"
    "source = s.config.geometry_source\n"
    "r = s.run_crack()\n"
    "print(json.dumps({'kind': kind, 'after_name': named, 'after_sweep': "
    "built, 'lanes': lanes, 'source': source, 'after_run': ctx(), "
    "'run_geometry': r.geometry}))\n")


def tune_phase(work: str, path: "MainPath", crack_run: dict, kind: str,
               card: str) -> dict:
    """Phase 12 (see the module docstring).  Returns the phase's
    numbers."""
    from hashcat_a5_table_generator_tpu_torch.runtime import sweep as sw
    from hashcat_a5_table_generator_tpu_torch.runtime import tune

    t_phase = time.monotonic()
    report: dict = {}
    # (a) a5gen tune --smoke on the card, a process of its own (its
    # launches counted from 0, printed at its exit); beside it, on the
    # card, the context probe (no profile exists yet: the smoke writes
    # none).
    on_card = SERVE_DEVICE == "cuda"
    probe = spawn([sys.executable, "-c", CONTEXT_PROBE],
                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                  text=True, cwd=HERE) if on_card else None
    err_path = os.path.join(work, "tune-smoke.err")
    with open(err_path, "w") as err:
        proc = spawn([sys.executable, "-c", SERVE_WRAPPER, "tune", "--smoke",
                      "--no-write", "--json", "--seconds", "0.25",
                      *([] if on_card else ["--device", SERVE_DEVICE])],
                     stdout=subprocess.PIPE, stderr=err, text=True, cwd=HERE)
        out, _ = proc.communicate(timeout=180)
    err = open(err_path).read()
    if probe is not None:
        said, _ = probe.communicate(timeout=180)
        try:
            ctx = json.loads(said.strip().splitlines()[-1])
        except (ValueError, IndexError):
            ctx = {}
        if probe.returncode != 0 or ctx.get("kind") != kind or \
                ctx.get("after_name") is not False or \
                ctx.get("after_sweep") is not False or \
                ctx.get("after_run") is not True or \
                (ctx.get("lanes"), ctx.get("source")) != (LANES, "default"):
            fail(f"context probe: exit {probe.returncode}: {said[-2000:]}")
        report["context_probe"] = ctx
        log(f"context probe: no CUDA context after the device's name is "
            f"read ({ctx['kind']}) or a Sweep with no lanes is built "
            f"({ctx['lanes']} lanes, source {ctx['source']}); one after its "
            f"run")
    if proc.returncode != 0:
        fail(f"a5gen tune --smoke exited {proc.returncode}: {err[-3000:]}")
    doc = json.loads(out)
    launched = json.loads(err.strip().splitlines()[-1])["launches"]
    counts = {a["emitted_per_sweep"] for a in doc["arms"]}
    if len(doc["arms"]) != 4 or len(counts) != 1 or \
            doc["device_kind"] != kind or doc["profile_path"] is not None \
            or not any(k.startswith("piece_") for k in launched):
        fail(f"a5gen tune --smoke: {len(doc['arms'])} arms, emitted per "
             f"sweep {sorted(counts)}, device {doc['device_kind']}, profile "
             f"{doc['profile_path']}, launches {launched}")
    report["smoke"] = {
        "arms": {a["arm"]: a["hashes_per_s"] for a in doc["arms"]},
        "emitted_per_sweep": counts.pop(), "launches": launched,
        "wall_s": time.monotonic() - t_phase}
    log(f"tune --smoke: 4 arms agree on {report['smoke']['emitted_per_sweep']}"
        f" candidates a sweep; hashes/s {report['smoke']['arms']}; launches "
        f"{launched}; process wall {report['smoke']['wall_s']:.2f} s")
    # (b) a bounded matrix through run_autotune, each sweep's drive and
    # wall recorded (the arm's first sweep is its untimed warm-up).
    matrix = tune.default_matrix(lanes=TUNE_LANES, strides=[STRIDE],
                                 supersteps=[16], pairs=["auto", "off"])
    calls: list = []
    per_arm: dict = {}
    run_crack = sw.Sweep.run_crack

    def timed(self, *a, **kw):
        t = time.monotonic()
        res = run_crack(self, *a, **kw)
        calls.append((time.monotonic() - t, res.drive_s))
        return res

    def on_arm(rec):
        timed_calls = calls[1:]
        calls.clear()
        drive = sum(d for _w, d in timed_calls)
        per_arm[rec["arm"]] = {
            "hashes_per_s": rec["hashes_per_s"], "sweeps": rec["sweeps"],
            "seconds": rec["seconds"],
            "emitted_per_sweep": rec["emitted_per_sweep"],
            "hits_per_sweep": rec["hits_per_sweep"],
            "drive_s": drive, "drive_share": drive / rec["seconds"],
            "drive_rate": (rec["emitted_per_sweep"] * rec["sweeps"] / drive
                           if drive > 0 else 0.0)}
        log(f"tune arm {rec['arm']}: {rec['hashes_per_s']:.4g} hashes/s "
            f"over {rec['sweeps']} sweeps of {rec['emitted_per_sweep']} "
            f"candidates ({rec['hits_per_sweep']} hits); drive "
            f"{drive:.3f} s of {rec['seconds']:.3f} s "
            f"({100 * drive / rec['seconds']:.1f}%, "
            f"{per_arm[rec['arm']]['drive_rate']:.4g} candidate-hashes/s "
            "over the drive)")

    mods = reset_launches()
    t = time.monotonic()
    sw.Sweep.run_crack = timed
    try:
        res = tune.run_autotune(words=TUNE_WORDS, seconds=TUNE_SECONDS,
                                matrix=matrix, on_arm=on_arm,
                                device=SERVE_DEVICE)
    finally:
        sw.Sweep.run_crack = run_crack
    launched = {k: v for mod in mods for k, v in mod.LAUNCHES.items() if v}
    if res["device_kind"] != kind or len(per_arm) != len(matrix) or \
            not res["profile_path"] or not any(k.startswith("piece_")
                                               for k in launched):
        fail(f"tune matrix: {res['device_kind']}, {len(per_arm)} arms, "
             f"profile {res['profile_path']}, launches {launched}")
    big = {a: r for a, r in per_arm.items()
           if a.startswith(f"lanes{max(TUNE_LANES)}-")}
    best_big = max(big, key=lambda a: big[a]["hashes_per_s"])
    report["matrix"] = {
        "words": TUNE_WORDS, "seconds_per_arm": TUNE_SECONDS,
        "arms": per_arm, "winner": res["winner"],
        "geometry": res["geometry"], "profile": res["profile_path"],
        "winner_at_most_lanes": best_big, "launches": launched,
        "wall_s": time.monotonic() - t}
    log(f"tune matrix ({len(matrix)} arms, {TUNE_WORDS} words, "
        f"{TUNE_SECONDS} s an arm): winner {res['winner']} at "
        f"{res['hashes_per_s']:.4g} hashes/s, at {max(TUNE_LANES)} lanes "
        f"{best_big}; "
        f"profile {os.path.relpath(res['profile_path'], HERE)}; launches "
        f"{launched}; {report['matrix']['wall_s']:.1f} s")
    # (c) the crack cell with no --lanes: the geometry is the profile's,
    # the stdout phase 4's.
    run = path.run("tune profile", ["--progress"], card)
    g = res["geometry"]
    lines = [json.loads(ln) for ln in run["stderr"].splitlines()
             if ln.startswith('{"progress"')]
    geom = lines[-1]["progress"].get("geometry", {}) if lines else {}
    said = (f"geometry: lanes={g['lanes']} blocks={g['num_blocks']} "
            f"superstep={g['superstep']}")
    if run["stdout"] != crack_run["stdout"] or \
            geom.get("source") != "profile" or \
            (geom.get("lanes"), geom.get("num_blocks")) != (
                g["lanes"], g["num_blocks"]) or \
            f"{said} pair=" not in run["stderr"] or \
            f"from autotune profile ({kind})" not in run["stderr"]:
        fail(f"crack cell from the profile: stdout equal "
             f"{run['stdout'] == crack_run['stdout']}, progress geometry "
             f"{geom}, profile {g}; stderr {run['stderr'][-1500:]}")
    report["crack"] = {"geometry": geom, "wall_s": run["wall"],
                       "drive_s": run["drive"], "launches": run["launches"],
                       "phase4_wall_s": crack_run["wall"],
                       "phase4_drive_s": crack_run["drive"]}
    log(f"crack cell from the profile: progress geometry {geom}; stdout "
        f"byte-identical to phase 4's; launches {run['launches']}; CLI wall "
        f"{run['wall']:.2f} s, drive {run['drive']} s (phase 4: "
        f"{crack_run['wall']:.2f} s, {crack_run['drive']} s) on {card}")
    report["phase_s"] = time.monotonic() - t_phase
    log(f"tune phase {report['phase_s']:.1f} s on {card}")
    return report


#: Phase 13 (the audit) must end within this many seconds, by its timer.
AUDIT_LIMIT_S = 30.0
KERNEL_BUDGETS = os.path.join(HERE, "hashcat_a5_table_generator_tpu_torch",
                              "csrc", "kernel_budgets.json")


def ptxas_resources(report: str) -> dict:
    """``kernel -> [registers, stack bytes, spill stores, spill loads]``
    of an ``-Xptxas -v`` report, the kernel named as
    :func:`ptxas_kernels` names it."""
    out = {}
    for kernel, info in ptxas_kernels(report):
        m = re.match(r"(\d+) registers, (\d+) B stack, spill (\d+)/(\d+) B",
                     info)
        out[kernel] = [int(g) for g in m.groups()]
    return out


def check_kernel_pins(reports: dict) -> dict:
    """Every instantiation in phase 2's ptxas reports (``library ->
    report``; no new build) held to its pin in ``csrc/kernel_budgets.json``:
    registers, stack bytes and spill stores / loads not above it.  An
    instantiation with no pin, a pin with no instantiation, or pins other
    than the registered ``budget_keys`` fail."""
    from hashcat_a5_table_generator_tpu_torch import audit
    from hashcat_a5_table_generator_tpu_torch.models import attack  # noqa

    with open(KERNEL_BUDGETS) as fh:
        pins = json.load(fh)["kernels"]
    got = {f"{lib}:{k}": v for lib, rep in reports.items()
           for k, v in ptxas_resources(rep).items()}
    registered = {k for e in audit.registered_entries().values()
                  for k in e.budget_keys}
    if set(pins) != registered:
        fail(f"phase 13: csrc/kernel_budgets.json names "
             f"{len(set(pins) ^ registered)} instantiations the registered "
             "budget_keys do not, or the other way round")
    unpinned = sorted(set(got) - set(pins))
    if unpinned:
        fail(f"phase 13: {len(unpinned)} kernel instantiations have no pin "
             f"in csrc/kernel_budgets.json: {unpinned[:8]}")
    unbuilt = sorted(set(pins) - set(got))
    if unbuilt:
        fail(f"phase 13: {len(unbuilt)} pinned instantiations are not in "
             f"the ptxas reports: {unbuilt[:8]}")
    over = {k: (v, pins[k]) for k, v in sorted(got.items())
            if any(a > b for a, b in zip(v, pins[k]))}
    for k, (v, pin) in over.items():
        print(f"  over its pin: {k}: {v} > {pin} (registers, stack, spill "
              "stores, spill loads)")
    if over:
        fail(f"phase 13: {len(over)} kernel instantiations went above their "
             "pins (registers, stack or spills)")
    below = sum(v != pins[k] for k, v in got.items())
    return {"instantiations": len(got), "above_pin": 0,
            "below_pin": below,
            "max_registers": max(v[0] for v in got.values()),
            "with_stack": sum(v[1] > 0 for v in got.values()),
            "with_spills": sum(v[2] + v[3] > 0 for v in got.values()),
            "measured": got}


def audit_bodies(cells: dict) -> list:
    """Each registered fused body called once on the card at full width
    (2^22 lanes) on the first bucket of each route a cell takes, under
    ``torch.cuda.set_sync_debug_mode("error")``: a body that synchronises
    with the host fails the run.  ``cells``: name -> MainPath.  Every
    input of a call is on the card before it; its counters are read
    after the mode is off."""
    import torch

    from hashcat_a5_table_generator_tpu_torch import audit
    from hashcat_a5_table_generator_tpu_torch.audit_harness import (
        body_calls,
    )
    from hashcat_a5_table_generator_tpu_torch.native import (
        read_packed_buckets,
    )
    from hashcat_a5_table_generator_tpu_torch.runtime.sweep import (
        Sweep, SweepConfig,
    )

    bodies = {n for n, e in audit.registered_entries().items()
              if e.kind == "fused_body"}
    out = []
    for cell, path in cells.items():
        seen = set()
        for width, packed in sorted(read_packed_buckets(
                path.wordlist).items()):
            t0 = time.monotonic()
            sweep = Sweep(path.spec, path.sub, packed, path.digest_rows,
                          SweepConfig(device="cuda", lanes=LANES,
                                      num_blocks=LANES // STRIDE,
                                      stream_chunk_words="off"))
            route = sweep._whole.route
            if route is None or route in seen:
                continue
            seen.add(route)
            calls = body_calls(sweep)
            built_s = time.monotonic() - t0
            for name, call in sorted(calls.items()):
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                t = time.monotonic()
                try:
                    res = call()
                except RuntimeError as e:
                    torch.cuda.set_sync_debug_mode(0)
                    fail(f"phase 13: {name} synchronised with the host "
                         f"inside the body ({cell} cell, bucket {width}, "
                         f"{route} route): {e}")
                torch.cuda.set_sync_debug_mode(0)
                dispatch_s = time.monotonic() - t
                torch.cuda.synchronize()
                ne, nh = (int(x) for x in res["counters"].tolist())
                row = {"cell": cell, "bucket": width, "route": route,
                       "body": name, "syncs": 0, "lanes": LANES,
                       "emitted": ne, "hits": nh,
                       "dispatch_ms": 1e3 * dispatch_s,
                       "set_up_s": built_s}
                out.append(row)
                log(f"phase 13: {name} on {cell} bucket {width} ({route} "
                    f"route, {LANES} lanes): no host sync inside, "
                    f"dispatched in {1e3 * dispatch_s:.2f} ms, {ne} emitted,"
                    f" {nh} hits (set-up {built_s:.1f} s)")
            if cell == "crack":
                break  # the crack cell: its first bucket
    missing = bodies - {r["body"] for r in out}
    if missing:
        fail(f"phase 13: fused bodies never called: {sorted(missing)}")
    return out


def audit_phase(reports: dict, paths: dict, card: str) -> dict:
    """Phase 13, the port's audit on the card (``audit.py``): the kernel
    pins (:func:`check_kernel_pins`) and the fused bodies without a host
    sync (:func:`audit_bodies`) on the crack and german cells; fails past
    :data:`AUDIT_LIMIT_S` seconds."""
    t0 = time.monotonic()
    pins = check_kernel_pins(reports)
    log(f"phase 13: {pins['instantiations']} kernel instantiations within "
        f"their pins ({pins['below_pin']} below; at most "
        f"{pins['max_registers']} registers, {pins['with_stack']} with a "
        f"stack frame, {pins['with_spills']} with spills)")
    bodies = audit_bodies({"crack": paths["cyrillic-md5"],
                           "german": paths["german-md5"]})
    wall = time.monotonic() - t0
    log(f"phase 13 (audit) {wall:.1f} s on {card}")
    if wall > AUDIT_LIMIT_S:
        fail(f"phase 13 took {wall:.1f} s, over its {AUDIT_LIMIT_S:.0f} s")
    return {"phase_s": wall, "pins": {k: v for k, v in pins.items()
                                      if k != "measured"},
            "bodies": bodies}


def expect_launched(run, keys, what) -> None:
    for key in keys:
        if run["launches"].get(key, 0) <= 0:
            fail(f"{what} never launched {key}")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs "
             "a CUDA device")
    arm_deadline()
    # Autotune profiles: a directory of the script's own, for it and every
    # process it starts; no run reads one from the home directory, and
    # every phase before 12 (which writes one) runs the built-in geometry.
    os.environ["A5GEN_TUNE_PROFILE"] = os.path.join(
        HERE, "build", "chip_smoke", "tune-profiles")
    sys.path.insert(0, HERE)
    try:
        from hashcat_a5_table_generator_tpu_torch.models.attack import (
            AttackSpec,
        )
        from hashcat_a5_table_generator_tpu_torch.ops import (
            _native_build, fused_expand,
        )
        from hashcat_a5_table_generator_tpu_torch.tables.layouts import (
            get_layout,
        )
    except ImportError as e:
        fail(f"the PyTorch/CUDA package is not importable here ({e})")

    # -- phase 1: the card --------------------------------------------------
    card = nvidia_smi("name,power.limit")
    kind = torch.cuda.get_device_name(0)
    props = torch.cuda.get_device_properties(0)
    # The INT32 peak (and so every bound_ms) rests on the clock read here;
    # a failed query fails the smoke rather than assume one.
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    peak_ops = props.multi_processor_count * 64 * clock_mhz * 1e6
    log(f"card: {card}; torch: {kind}; {props.multi_processor_count} SMs, "
        f"max SM clock {clock_mhz:.0f} MHz; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    log(f"INT32 peak assumed: SMs x 64 INT32 lanes/clock x max clock = "
        f"{peak_ops:.4g} ops/s (Hopper white paper: 64 INT32 units per "
        f"SM); INT32 instructions per compression: {OPS_PER_BLOCK}")

    # -- phase 2: build -----------------------------------------------------
    # The two host libraries (g++: the wordlist scanner/packer and the
    # oracle engines) build on a thread while the nvcc builds run; the
    # smoke needs them built, not the numpy / Python fallback.  The nvcc
    # builds run on a thread of their own until phase 3's first launch:
    # its inputs (host plans, device tables) and phase 4's are made
    # meanwhile.
    from hashcat_a5_table_generator_tpu_torch import native
    from hashcat_a5_table_generator_tpu_torch.native import oracle_engine

    host_libs = {}

    def build_host_libs():
        t0 = time.monotonic()
        host_libs["packer"] = native.available()
        host_libs["oracle"] = oracle_engine.available()
        host_libs["s"] = time.monotonic() - t0

    host_build = threading.Thread(target=build_host_libs)
    host_build.start()
    libs = [f"piece_hash_{a}" for a in ALGOS]
    bs_libs = [f"bytescan_hash_{a}" for a in ALGOS]
    bh_libs = [f"buffer_hash_{a}" for a in ALGOS]
    built: dict = {}

    def build_kernels():
        t0 = time.monotonic()
        try:
            built["reports"] = _native_build.build(libs + bs_libs + bh_libs)
        except Exception as e:  # reported where phase 3 waits for it
            built["error"] = e
        built["s"] = time.monotonic() - t0

    kernel_build = threading.Thread(target=build_kernels)
    kernel_build.start()
    host_build.join()
    if not (host_libs.get("packer") and host_libs.get("oracle")):
        fail(f"the native host libraries did not build with g++ "
             f"({host_libs}): native/packer.cpp, native/oracle.cpp")
    log(f"built the native host libraries (native/packer.cpp, "
        f"native/oracle.cpp; g++ -O3, into {native.BUILD_DIR}) in "
        f"{host_libs['s']:.1f} s beside the nvcc builds")

    def kernels_built() -> None:
        """Wait for the nvcc builds; their ptxas lines."""
        t_wait = time.monotonic()
        kernel_build.join()
        waited = time.monotonic() - t_wait
        if "error" in built:
            fail(f"the CUDA libraries did not build: {built['error']}")
        reports = built["reports"]
        log(f"built {len(libs + bs_libs + bh_libs)} libraries from "
            f"csrc/piece_hash.cu, csrc/bytescan_hash.cu and "
            f"csrc/buffer_hash.cu in {built['s']:.1f} s (nvcc "
            f"{' '.join(_native_build.NVCC_FLAGS)} -DPIECE_ALGO=n, all in "
            f"parallel, beside phases 3 and 4's input preparation, which "
            f"then waited {waited:.1f} s for them)")
        frames = []
        for lib in bh_libs + libs + bs_libs:
            for kernel, info in ptxas_kernels(reports[lib]):
                print(f"  ptxas [{lib}]: {kernel}: {info}")
                if not info.split(", ")[1].startswith("0 B stack"):
                    frames.append(f"{lib} {kernel}")
        log(f"instantiations with a stack frame: {len(frames)}"
            + (f" ({'; '.join(frames)})" if frames else ""))

    cyr = get_layout("qwerty-cyrillic").to_substitution_map()
    czech = get_layout("czech").to_substitution_map()
    azerty = get_layout("qwerty-azerty").to_substitution_map()
    gh = get_layout("greek-hebrew").to_substitution_map()
    dev = torch.device("cuda")

    # -- phase 3: kernels vs plain on the card ------------------------------
    head = synth_words(CASE_WORDS, seed=1)
    greek_head = greek_words(head)
    mid = synth_words(CASE_WORDS, seed=7)
    # Count-windowed at -x 2 (at least a 2x lane saving): 9-13 letters for
    # qwerty-cyrillic; 9-10 letters with 6 czech slots for czech, so NTLM
    # keeps one hash block.
    tail = [w + b"xyz" for w in synth_words(CASE_WORDS, seed=8)]
    czech_tail = long_words(CASE_WORDS, 9, 10, (6, 6), seed=9,
                            filler=CZECH_FILLER, alphabet=CZECH_KEYS)
    long64 = long_words(400, 33, 64, (4, 10), seed=2)
    # (entry, algo) -> (workload, words, table, max_substitute, pair[,
    # mode]).
    timed = {}
    for algo in ALGOS:
        timed[("k1", algo)] = ("cyr", head, cyr, 15, False)
        timed[("pair", algo)] = ("cyr", head, cyr, 15, True)
        timed[("digits", algo)] = ("czech", mid, czech, 15, False)
        timed[("pair_digits", algo)] = ("leet3", mid, LEET3, 15, True)
        timed[("windowed", algo)] = ("cyr-x2", tail, cyr, 2, False)
    # The configurations' own workloads where one hash has its own.
    timed[("digits", "md5")] = ("azerty", mid, azerty, 15, False)
    timed[("k1", "sha1")] = ("greek", greek_head, gh, 15, False)
    timed[("pair", "sha1")] = ("greek", greek_head, gh, 15, True)
    timed[("windowed", "ntlm")] = ("czech-x2", czech_tail, czech, 2, False)
    # Substitute-all: qwerty-azerty words holding a hazard pair (a/q, z/w
    # — closed) and ``AQq`` (a 12-row joint table; with another hazard
    # key the word goes to the oracle and takes no lanes).
    az_words = mid + [b"AQq" + w[:4] for w in mid[:4000]]
    az_x2 = [b"aq134567" + w[:3] for w in mid[:20000]]
    for algo in ALGOS:
        timed[("suball_k1", algo)] = ("cyr", head, cyr, 15, False, "suball")
        timed[("suball_pair", algo)] = (
            "single", pair_words(CASE_WORDS, 11), SINGLE, 15, True, "suball")
        timed[("suball_pair_digits", algo)] = (
            "leet3-pair", pair_words(CASE_WORDS, 12), LEET3, 15, True,
            "suball")
        timed[("suball_digits", algo)] = ("czech", mid, czech, 15, False,
                                          "suball")
        timed[("suball_closed", algo)] = ("azerty", az_words, azerty, 15,
                                          False, "suball")
        timed[("suball_windowed", algo)] = (
            ("czech-x2", czech_tail, czech, 2, False, "suball")
            if algo == "ntlm" else ("cyr-x2", tail, cyr, 2, False, "suball"))
        timed[("suball_closed_windowed", algo)] = (
            "azerty-x2", az_x2, azerty, 2, False, "suball")
    cases = {}
    for (entry, algo), (wl, words, sub, mx, pair, *mode) in timed.items():
        # czech packs at the main path's bucket width, 16: NTLM then runs
        # its 2-block instantiation there, as the czech x NTLM run does
        # (every lane still needs one compression).
        cases[(entry, algo)] = Case(
            f"{wl} x {algo}{' ' + mode[0] if mode else ''}", wl, words, sub,
            algo=algo, mx=mx, pair=pair, mode=mode[0] if mode else "default",
            width=16 if wl == "czech" and not mode else None, device=dev)
    multi = {
        ("k1-2", "md5"): ("long64", long64, cyr, 2),
        ("k1-3", "md5"): ("wide64", wide_words(200, seed=3), wide_table(cyr),
                          3),
        ("k1-2", "sha1"): ("long64", long64, cyr, 2),
        ("k1-3", "sha1"): ("wide64", wide_words(200, seed=3),
                           wide_table(cyr), 3),
        ("digits-2", "ntlm"): ("czech24", [w * 2 + w[:4] for w in mid[:8000]],
                               czech, 2),
        ("digits-3", "ntlm"): ("czech-long", long_words(
            4000, 50, 64, (12, 12), seed=4, filler=CZECH_FILLER,
            alphabet=CZECH_KEYS), czech, 3),
    }
    # Substitute-all batches of 2 and 3 hash blocks (``-s``).
    az_long = [b"aq" + w for w in long_words(
        4000, 50, 62, (4, 8), seed=14, filler=b"bcdefghijklnoprstuvxy",
        alphabet=b"aqzw")]
    multi.update({
        ("suball_k1-2", "md5"): ("long64", long64, cyr, 2),
        ("suball_k1-3", "md5"): ("wide64", wide_words(200, seed=3),
                                 wide_table(cyr), 3),
        ("suball_k1-2", "sha1"): ("long64", long64, cyr, 2),
        ("suball_k1-3", "sha1"): ("wide64", wide_words(200, seed=3),
                                  wide_table(cyr), 3),
        ("suball_closed-2", "ntlm"): (
            "azerty24", [b"aq" + w * 2 + w[:4] for w in mid[:8000]], azerty,
            2),
        ("suball_closed-3", "ntlm"): ("azerty-long", az_long, azerty, 3),
    })
    for (entry, algo), (wl, words, sub, hb) in multi.items():
        lanes = LANES >> (2 if hb == 2 else 3)
        mode = "suball" if entry.startswith("suball") else "default"
        cases[(entry, algo)] = Case(f"{wl} x {algo} {mode}", wl, words, sub,
                                    algo=algo, lanes=lanes, mode=mode,
                                    device=dev)
    # Compared at main-path shapes but not timed (the timed case of the
    # same entry point x hash runs another workload): the closure over
    # azerty-qwerty's 6-wide joint tables, the other windowed selector
    # (cb packing or digits) of each hash, and the reverse mode's pair
    # tier.
    azq = get_layout("azerty-qwerty").to_substitution_map()
    others = {}
    for algo in ALGOS:
        others[("suball_closed:azq", algo)] = (
            "azerty-qwerty", az_words, azq, 15, False, "suball", 1)
        others[("suball_windowed:other", algo)] = (
            ("cyr-x2", tail, cyr, 2, False, "suball", 2) if algo == "ntlm"
            else ("czech-x2", czech_tail, czech, 2, False, "suball", 1))
        others[("pair:reverse", algo)] = ("cyr", head, cyr, 15, True,
                                         "reverse", 1)
    # The digit decode at the huge word's own shape (15 keys of three
    # options: 2^30 rows, radix 4 a slot), the first launch of its
    # per-launch pipeline (blocks cut on the host); timed in phase 5.
    others[("digits:huge", "md5")] = ("huge", [bytes(HUGE_KEYS)],
                                      huge_table(), 15, False, "default", 1)
    want_hbs = {}
    for (label, algo), (wl, words, sub, mx, pair, mode, hb) in \
            others.items():
        cases[(label, algo)] = Case(
            f"{wl} x {algo} {mode}", wl, words, sub, algo=algo, mx=mx,
            pair=pair, mode=mode, device=dev)
        want_hbs[(label, algo)] = hb
    for (entry, algo), case in cases.items():
        want_key = f"piece_{entry.split('-')[0].split(':')[0]}/{algo}"
        want_hb = int(entry.split("-")[1]) if "-" in entry else (
            2 if (entry, algo) == ("digits", "ntlm")
            else want_hbs.get((entry, algo), 1))
        if case.key != want_key or case.hash_blocks != want_hb:
            fail(f"{case.name}: runs {case.key} with {case.hash_blocks} "
                 f"hash blocks, expected {want_key} with {want_hb}")
    # Phase 4's inputs (wordlists, digest files, host plans: no device
    # work) are made here too, while the nvcc builds run.
    work = os.path.join(HERE, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    # The crack cell (and azerty -s, whose killed runs need its fetches)
    # takes N_WORDS_DEFAULT (150k) words; every other cell N_WORDS_CELL
    # (100k): cut from 250k to keep the script inside its time limit.
    crack_words = dictionary(N_WORDS_DEFAULT, seed=0)
    cell_words = dictionary(N_WORDS_CELL, seed=0)
    czech_words = dictionary(N_WORDS_CELL, seed=11, long_lines=False)
    # cyrillic-x2-long: 148.5k recipe words, 1000 lines of 65-200 bytes
    # and 500 of 25-40 letters (both on the XLA route) at seeded places
    # (1M, then 247k recipe words before it was cut for time; 2000 and
    # 1000 such lines until phase 12 came).
    x2_long = dictionary(N_WORDS_DEFAULT - 1500, seed=0, long_lines=False)
    rng = np.random.default_rng(81)
    for w in long_lines(1000, seed=82) + letter_lines(500, seed=83):
        x2_long.insert(int(rng.integers(0, len(x2_long))), w)
    # qwerty-azerty -s: 150k words (1M, then 250k cost most of the
    # script's time in host prep), with the same 2000 seeded hazard lines.
    azerty_words = dictionary(N_WORDS_DEFAULT - 2000, seed=21,
                              long_lines=False)
    rng = np.random.default_rng(22)
    for w in dict.fromkeys(azerty_lines(2000, seed=23)):
        azerty_words.insert(int(rng.integers(0, len(azerty_words))), w)
    german_dict = german_cell_words()
    paths = {
        "cyrillic-md5": MainPath("cyrillic-md5", work, crack_words,
                                 "qwerty-cyrillic", "md5", {}, seed=10),
        "czech-ntlm": MainPath("czech-ntlm", work, czech_words, "czech",
                               "ntlm", {}, seed=12),
        "greek-hebrew-sha1": MainPath(
            "greek-hebrew-sha1", work, greek_words(dictionary(
                N_WORDS_CELL, seed=13, long_lines=False)),
            "greek-hebrew", "sha1", {}, seed=14),
        "cyrillic-md5-x2": MainPath("cyrillic-md5-x2", work, cell_words,
                                    "qwerty-cyrillic", "md5",
                                    {"max_substitute": 2}, seed=15),
        "cyrillic-md5-s": MainPath("cyrillic-md5-s", work, cell_words,
                                   "qwerty-cyrillic", "md5",
                                   {"mode": "suball"}, seed=24),
        "azerty-md5-s": MainPath(
            "azerty-md5-s", work, azerty_words, "qwerty-azerty", "md5",
            {"mode": "suball"}, seed=25,
            quota={"device_closed": 120, "oracle_fallback": 60}),
        "cyrillic-sha1-s-x2": MainPath(
            "cyrillic-sha1-s-x2", work, cell_words, "qwerty-cyrillic",
            "sha1", {"mode": "suball", "max_substitute": 2}, seed=26),
        "czech-ntlm-s-r": MainPath(
            "czech-ntlm-s-r", work, czech_words, "czech", "ntlm",
            {"mode": "suball-reverse"}, seed=27),
        "cyrillic-md5-r": MainPath("cyrillic-md5-r", work, cell_words,
                                   "qwerty-cyrillic", "md5",
                                   {"mode": "reverse"}, seed=28),
        "german-md5": MainPath("german-md5", work, german_dict, "german",
                               "md5", {}, seed=42),
        "german-r-ntlm": MainPath(
            "german-r-ntlm", work, german_dict, "german", "ntlm",
            {"mode": "reverse"}, seed=43),
        "cyrillic-sha1-s": MainPath("cyrillic-sha1-s", work, cell_words,
                                    "qwerty-cyrillic", "sha1",
                                    {"mode": "suball"}, seed=44),
        "cyrillic-x2-long": MainPath(
            "cyrillic-x2-long", work, x2_long, "qwerty-cyrillic", "md5",
            {"max_substitute": 2}, seed=84),
        "leet9-sha1": MainPath(
            "leet9-sha1", work, dictionary(50000, seed=85, long_lines=False),
            LEET9, "sha1", {}, seed=86),
    }
    az = paths["azerty-md5-s"].routing
    if az["device_closed"] < 100 or az["oracle_fallback"] < 100:
        fail(f"azerty-md5-s routing {az}: want closed words and at least "
             "100 oracle-fallback words")
    if not paths["cyrillic-sha1-s-x2"].windowed:
        fail("the -s -x 2 run's plans are not count-windowed")
    if not paths["cyrillic-md5-x2"].windowed:
        fail("the -x 2 run's plans are not count-windowed")
    kernels_built()
    checks = {key: compare(case) for key, case in cases.items()}
    # The windowed tier's CTA edges: lines of 16-20 bytes with 16 letters
    # (137 ranks at -x 2, so blocks of the full stride), a partial last
    # CTA and blocks of count 0 and 1 (windowed_edges).
    win16 = long_words(20000, 16, 20, (16, 16), seed=51)
    win_edges = {algo: compare(windowed_edges(Case(
        f"cyr-x2-16 x {algo}", "cyr-x2-16", win16, cyr, algo=algo, mx=2,
        lanes=LANES >> 2, device=dev))) for algo in ALGOS}
    # The scalar K=1 and pair tiers' CTA edges (tile_edges) on each timed
    # workload of theirs; a window cut (-m 2 -x 9: full enumeration, rows
    # below the counts dead too); blocks of 4096 lanes, wider than a CTA's
    # 2048, cut into chunks.
    tile_checks = {}
    for entry in ("k1", "pair", "pair_digits", "suball_k1"):
        for algo in ALGOS:
            tile_checks[f"cta-edges/{entry}/{algo}"] = compare(tile_edges(
                cases[(entry, algo)]))["mismatches"]
    for pair in (False, True):
        entry = "pair" if pair else "k1"
        for algo in ALGOS:
            tile_checks[f"window/{entry}/{algo}"] = compare(Case(
                f"cyr -m 2 -x 9 x {algo}", "cyr", head, cyr, algo=algo,
                mn=2, mx=9, pair=pair, device=dev))["mismatches"]
            tile_checks[f"chunks/{entry}/{algo}"] = compare(Case(
                f"cyr x {algo}, stride 4096", "cyr", head, cyr, algo=algo,
                pair=pair, stride=4096, device=dev))["mismatches"]
    # The digit decode at K=1 on the tile tier: the CTA edges of its
    # match and substitute-all workloads and of cascade-closed ones
    # (qwerty-azerty's joint tables of up to 12 rows, azerty-qwerty's 6:
    # "AQq" before each word, so words fill whole blocks), the window cut
    # -m 2 -x 9 and blocks of 4096 lanes cut into chunks.
    az_full = [b"AQq" + w for w in mid[:20000]]
    for algo in ALGOS:
        for entry in ("digits", "suball_digits"):
            tile_checks[f"cta-edges/{entry}/{algo}"] = compare(tile_edges(
                cases[(entry, algo)]))["mismatches"]
        for label, wl, sub in (("cta-edges", "azerty-full", azerty),
                               ("cta-edges-azq", "azq-full", azq)):
            case = Case(f"{wl} x {algo} suball", wl, az_full, sub,
                        algo=algo, mode="suball", device=dev)
            if case.key != f"piece_suball_closed/{algo}":
                fail(f"{case.name}: runs {case.key}")
            tile_checks[f"{label}/suball_closed/{algo}"] = compare(
                tile_edges(case))["mismatches"]
        for entry, wl, words, sub, mode, width in (
                ("digits", "czech", mid, czech, "default", 16),
                ("suball_closed", "azerty-full", az_full, azerty, "suball",
                 None)):
            window = Case(f"{wl} -m 2 -x 9 x {algo} {mode}", wl, words, sub,
                          algo=algo, mn=2, mx=9, mode=mode, width=width,
                          device=dev)
            chunks = Case(f"{wl} x {algo} {mode}, stride 4096", wl, words,
                          sub, algo=algo, mode=mode, stride=4096,
                          width=width, device=dev)
            for label, case in (("window", window), ("chunks", chunks)):
                if case.key != f"piece_{entry}/{algo}":
                    fail(f"{case.name}: runs {case.key}")
                tile_checks[f"{label}/{entry}/{algo}"] = compare(
                    case)["mismatches"]

    # Byte-scan kernels (TPU rows 7-9): every tier x hash at main-path
    # shapes, on plans whose piece schema (if any) is left unused, as
    # under A5GEN_EMIT=bytescan.  (tier label, hash) -> (workload, words,
    # table, max_substitute, mode, (row, decode, variant)).
    german = get_layout("german").to_substitution_map()
    collide = {b"s": [b"Z"], b"ss": ["\u00df".encode()]}
    gwords = german_words(CASE_WORDS, seed=31)
    # Count-windowed at -x 2: 14-15 bytes, 8-11 umlaut letters and "sss".
    gwin = [w[:4] + b"sss" + w[4:] for w in long_words(
        CASE_WORDS, 11, 12, (8, 11), seed=32, filler=b"bcdfghklm",
        alphabet=b"aou")]
    bs_timed = {}
    for algo in ALGOS:
        for label, spec in {
            "scalar-single": ("cyr", head, cyr, 15, "default"),
            "scalar-single-win": ("cyr-x2", tail, cyr, 2, "default"),
            "scalar-bitmask": ("german", gwords, german, 15, "default"),
            "scalar-bitmask-win": ("german-x2", gwin, german, 2, "default"),
            "scalar-suball": ("cyr", head, cyr, 15, "suball"),
            "scalar-suball-win": ("cyr-x2", tail, cyr, 2, "suball"),
            "match-radix2": ("collide", gwords, collide, 15, "default"),
            "match-digits": ("czech", mid, czech, 15, "default"),
            "match-win": ("czech-x2", czech_tail, czech, 2, "default"),
            "suball-digits": ("czech", mid, czech, 15, "suball"),
            "suball-win": ("czech-x2", czech_tail, czech, 2, "suball"),
            "suball-closed": ("azerty", az_words, azerty, 15, "suball"),
            "suball-closed-win": ("azerty-x2", az_x2, azerty, 2, "suball"),
        }.items():
            bs_timed[(label, algo)] = spec
    bs_tiers = {
        "scalar-single": ("scalar", "scalar", "single"),
        "scalar-single-win": ("scalar", "windowed", "single"),
        "scalar-bitmask": ("scalar", "scalar", "bitmask"),
        "scalar-bitmask-win": ("scalar", "windowed", "bitmask"),
        "scalar-suball": ("scalar", "scalar", "suball"),
        "scalar-suball-win": ("scalar", "windowed", "suball"),
        "match-radix2": ("match", "radix2", ""),
        "match-digits": ("match", "digits", ""),
        "match-win": ("match", "windowed", ""),
        "suball-digits": ("suball", "digits", ""),
        "suball-win": ("suball", "windowed", ""),
        "suball-closed": ("suball", "digits", ""),
        "suball-closed-win": ("suball", "windowed", ""),
    }
    bs_cases = {}
    for (label, algo), (wl, words, sub, mx, mode) in bs_timed.items():
        bs_cases[(label, algo)] = BSCase(
            f"{wl} x {algo} {mode}", wl, words, sub, algo=algo, mx=mx,
            mode=mode, width=16 if wl == "czech" and mode == "default"
            else None, device=dev)
    # 2 and 3 hash blocks: the piece cases' long workloads, and german's
    # "sss" among 4-byte values.
    wide_german = {**german, b"x": [b"\xf0\x9f\x98\x80"]}
    gl2 = [w[:6] + b"sss" + w[9:] for w in long_words(
        4000, 40, 48, (4, 4), seed=33, filler=b"bcdefghijklnpr",
        alphabet=b"x")]
    gl3 = [w[:6] + b"sss" + w[9:] for w in long_words(
        4000, 52, 60, (19, 19), seed=34, filler=b"bcdefghijklnpr",
        alphabet=b"x")]
    bs_multi = {
        ("scalar-bitmask-2", "md5"): ("german-long2", gl2, wide_german,
                                      "default", 2),
        ("scalar-bitmask-3", "sha1"): ("german-long3", gl3, wide_german,
                                       "default", 3),
        ("scalar-suball-2", "md5"): ("long64", long64, cyr, "suball", 2),
        ("scalar-suball-3", "sha1"): ("wide64", wide_words(200, seed=3),
                                      wide_table(cyr), "suball", 3),
        ("match-digits-2", "ntlm"): (
            "czech24", [w * 2 + w[:4] for w in mid[:8000]], czech,
            "default", 2),
        ("match-digits-3", "ntlm"): ("czech-long", long_words(
            4000, 50, 64, (12, 12), seed=4, filler=CZECH_FILLER,
            alphabet=CZECH_KEYS), czech, "default", 3),
        ("suball-closed-2", "ntlm"): (
            "azerty24", [b"aq" + w * 2 + w[:4] for w in mid[:8000]], azerty,
            "suball", 2),
        ("suball-closed-3", "ntlm"): ("azerty-long", az_long, azerty,
                                      "suball", 3),
    }
    for (label, algo), (wl, words, sub, mode, hb) in bs_multi.items():
        bs_cases[(label, algo)] = BSCase(
            f"{wl} x {algo} {mode}", wl, words, sub, algo=algo, mode=mode,
            lanes=LANES >> (2 if hb == 2 else 3), device=dev)
    def tier_of(label):
        """The tier label and hash-block count of a byte-scan case."""
        m = re.fullmatch(r"(.*)-([23])", label)
        return (m.group(1), int(m.group(2))) if m else (label, None)

    for (label, algo), case in bs_cases.items():
        want = bs_tiers[tier_of(label)[0]]
        got = (case.tier.row, case.tier.decode, case.tier.variant)
        want_hb = tier_of(label)[1]
        if got != want or (want_hb and case.hash_blocks != want_hb):
            fail(f"{case.name}: byte-scan tier {got} with "
                 f"{case.hash_blocks} hash blocks, expected {want}"
                 f"{f' with {want_hb}' if want_hb else ''}")
    bs_checks = {key: compare(case) for key, case in bs_cases.items()}
    # The byte-scan CTAs' edges (tile_edges: a partial last CTA, counts 0
    # and 1, 32 count-0 blocks) on every tier x hash; german's "sss" clash
    # lanes among them (scalar-bitmask); the window cut -m 2 -x 9 and
    # blocks of 4096 lanes cut into chunks on one tier of each row.
    bs_edge_checks = {}
    for (label, algo), (wl, words, sub, mx, mode) in bs_timed.items():
        # Blocks of 16 lanes: every workload has full ones, and a CTA
        # spans up to 32 blocks of several words.
        case = BSCase(f"{wl} x {algo} {mode}, stride 16", wl, words, sub,
                      algo=algo, mx=mx, mode=mode, stride=16,
                      width=16 if wl == "czech" and mode == "default"
                      else None, device=dev)
        bs_edge_checks[f"cta-edges/{label}/{algo}"] = compare(
            tile_edges(case))["mismatches"]
    for algo in ALGOS:
        for label, (wl, words, sub, mode, width) in {
            "scalar-bitmask": ("german", gwords, german, "default", None),
            "match-digits": ("czech", mid, czech, "default", 16),
            "suball-closed": ("azerty", az_words, azerty, "suball", None),
        }.items():
            for geom, kw in (("window", dict(mn=2, mx=9)),
                             ("chunks", dict(stride=4096))):
                case = BSCase(f"{wl} x {algo} {mode}, {geom}", wl, words,
                              sub, algo=algo, mode=mode, width=width,
                              device=dev, **kw)
                if (case.tier.row, case.tier.decode, case.tier.variant) \
                        != bs_tiers[label]:
                    fail(f"{case.name}: byte-scan tier {case.tier}")
                bs_edge_checks[f"{geom}/{label}/{algo}"] = compare(
                    case)["mismatches"]
    # One german plan, two tiers: words with "ss" but no "sss" have a
    # piece schema (the piece kernel by default) and take row 7 under
    # A5GEN_EMIT=bytescan; both kernels on the same blocks.
    g_no_sss = [w for w in gwords if b"sss" not in w]
    tier_pair = {algo: (
        Case(f"german-ss x {algo}", "german-ss", g_no_sss, german,
             algo=algo, device=dev),
        BSCase(f"german-ss x {algo}", "german-ss", g_no_sss, german,
               algo=algo, device=dev)) for algo in ("md5", "ntlm")}
    tier_emitted = {}
    for algo, (pc, bc) in tier_pair.items():
        if pc.key != f"piece_k1/{algo}" or bc.tier.variant != "bitmask":
            fail(f"german-ss x {algo}: runs {pc.key} / {bc.key} "
                 f"{bc.variant}, expected piece_k1 / bytescan bitmask")
        want = compare(pc)["emit"]
        if not bool((compare(bc)["emit"] == want).all()):
            fail(f"german-ss x {algo}: the tiers emit different rows")
        tier_emitted[algo] = int(want.sum())
    # The buffer hash (TPU row 10 and its siblings) and the XLA route's
    # torch expansion on the card.
    bh_checks = check_buffer_hash()
    check_xla_expansion()

    # -- phase 4: the main path at full width -------------------------------
    host_sorts(paths["cyrillic-md5"])
    small = os.path.join(work, "small.txt")
    with open(small, "wb") as fh:
        fh.write(b"\n".join(crack_words[:2000]) + b"\n")
    base = ["-t", paths["cyrillic-md5"].table, "--backend", "device",
            "--algo", "md5", "--digests", paths["cyrillic-md5"].digests]
    out, err, rc = run_cli([small] + base)
    if rc != 0:
        fail(f"warm-up run exited {rc}: {err}")

    # The warm-up run: the reference of phase 9's --devices 1 run.
    warm_up = {"argv": [small] + base, "stdout": out}
    runs = {}
    # The crack cell at pair off writes --metrics-json (its counters
    # alone): phase 7's arm without a checkpoint and phase 8's arm at the
    # default chunking read it.
    from hashcat_a5_table_generator_tpu_torch.runtime import telemetry

    crack_metrics = os.path.join(work, "m-crack-pair-off.json")
    for name, arm, extra in (
        ("cyrillic-md5", "pair auto", []),
        ("cyrillic-md5", "pair off", ["--pair", "off", "--metrics-json",
                                      crack_metrics]),
        ("czech-ntlm", "pair auto", []),
        ("greek-hebrew-sha1", "pair auto", []),
        ("greek-hebrew-sha1", "pair off", ["--pair", "off"]),
        ("cyrillic-md5-x2", "-x 2", ["-x", "2"]),
        ("cyrillic-md5-s", "-s, pair auto", ["-s"]),
        ("azerty-md5-s", "-s", ["-s"]),
        ("cyrillic-sha1-s-x2", "-s -x 2", ["-s", "-x", "2"]),
        ("czech-ntlm-s-r", "-s -r", ["-s", "-r"]),
        ("cyrillic-md5-r", "-r, pair auto", ["-r"]),
        ("german-md5", "german", []),
        ("german-r-ntlm", "-r", ["-r"]),
        ("cyrillic-sha1-s", "-s", ["-s"]),
        ("cyrillic-x2-long", "-x 2", ["-x", "2"]),
        ("leet9-sha1", "nine options", []),
    ):
        if "--metrics-json" in extra:
            telemetry.REGISTRY.reset()
        runs[(name, arm)] = paths[name].run(arm, extra, card)
    runs[("cyrillic-md5", "pair off")]["metrics"] = crack_metrics
    # A5GEN_EMIT=bytescan (this run alone): every plan on the byte-scan
    # tiers; stdout byte-identical to the per-slot run of the same input.
    for name, arm, extra, twin in (
        ("czech-ntlm", "bytescan", [], "pair auto"),
        ("cyrillic-md5-x2", "bytescan -x 2", ["-x", "2"], "-x 2"),
        ("azerty-md5-s", "bytescan -s", ["-s"], "-s"),
        ("cyrillic-sha1-s", "bytescan -s", ["-s"], "-s"),
    ):
        run = paths[name].run(arm, extra, card, emit_scheme="bytescan")
        runs[(name, arm)] = run
        if run["stdout"] != runs[(name, twin)]["stdout"]:
            fail(f"{name} ({arm}): stdout differs from the per-slot run")
        pieces = [k for k in run["launches"] if k.startswith("piece_")]
        if pieces:
            fail(f"{name} ({arm}): launched piece kernels {pieces}")
        log(f"main path {name} ({arm}): stdout byte-identical to the "
            f"per-slot run ({len(run['stdout'])} bytes)")
    # A5GEN_PALLAS=off (this run alone): every bucket on the XLA expand +
    # hash route; stdout byte-identical to the kernel route's run.
    for name, arm, extra, twin in (
        ("czech-ntlm", "A5GEN_PALLAS=off", [], "pair auto"),
        ("greek-hebrew-sha1", "A5GEN_PALLAS=off", [], "pair auto"),
        ("german-md5", "A5GEN_PALLAS=off", [], "german"),
        ("azerty-md5-s", "A5GEN_PALLAS=off -s", ["-s"], "-s"),
    ):
        run = paths[name].run(arm, extra, card, pallas="off")
        runs[(name, arm)] = run
        if run["stdout"] != runs[(name, twin)]["stdout"]:
            fail(f"{name} ({arm}): stdout differs from the kernel route's")
        fused = [k for k in run["launches"]
                 if k.startswith(("piece_", "bytescan_"))]
        if fused:
            fail(f"{name} ({arm}): launched fused kernels {fused}")
        log(f"main path {name} ({arm}): stdout byte-identical to the kernel "
            f"route's ({len(run['stdout'])} bytes)")
    # A5_NATIVE=0 (this run alone): the numpy packer, and the Python
    # oracle for the fallback words; stdout byte-identical to the native
    # run's, which took every fallback word on the native engine.  (The
    # native run's repeat after the twin, the two engines' drives in
    # turns, was dropped for the script's time when phase 10 came.)
    run = paths["azerty-md5-s"].run("A5_NATIVE=0 -s", ["-s"], card,
                                    native="0")
    runs[("azerty-md5-s", "A5_NATIVE=0 -s")] = run
    nat = runs[("azerty-md5-s", "-s")]
    if run["stdout"] != nat["stdout"]:
        fail("azerty-md5-s (A5_NATIVE=0): stdout differs from the native "
             "run's")
    if (nat["native_words"], run["native_words"]) \
            != (az["oracle_fallback"], 0):
        fail(f"azerty-md5-s: {nat['native_words']} / {run['native_words']} "
             f"fallback words on the native engine (native run / "
             f"A5_NATIVE=0), want {az['oracle_fallback']} / 0")
    log(f"main path azerty-md5-s (A5_NATIVE=0): stdout byte-identical to "
        f"the native run's ({len(run['stdout'])} bytes); drives native "
        f"{nat['drive']} s, A5_NATIVE=0 {run['drive']} s; CLI walls "
        f"{nat['wall']:.2f} / {run['wall']:.2f} s on {card}")
    # A5GEN_PAIR=off (this run alone): K=1 everywhere; stdout
    # byte-identical to the pair auto run's.
    run = paths["cyrillic-md5"].run("A5GEN_PAIR=off", [], card, pair="off")
    runs[("cyrillic-md5", "A5GEN_PAIR=off")] = run
    if run["stdout"] != runs[("cyrillic-md5", "pair auto")]["stdout"]:
        fail("cyrillic-md5 (A5GEN_PAIR=off): stdout differs from pair auto")
    if any("pair" in k for k in run["launches"]):
        fail(f"cyrillic-md5 (A5GEN_PAIR=off): launched {run['launches']}")
    log(f"main path cyrillic-md5 (A5GEN_PAIR=off): stdout byte-identical to "
        f"pair auto's ({len(run['stdout'])} bytes)")
    # --superstep off (this run alone): the per-launch pipeline, blocks
    # cut on the host, K=1; stdout byte-identical to the superstep run's.
    run = paths["cyrillic-md5"].run("superstep off", ["--superstep", "off"],
                                    card)
    runs[("cyrillic-md5", "superstep off")] = run
    if run["stdout"] != runs[("cyrillic-md5", "pair auto")]["stdout"]:
        fail("cyrillic-md5 (--superstep off): stdout differs from the "
             "superstep run's")
    if any("pair" in k for k in run["launches"]):
        fail(f"cyrillic-md5 (--superstep off): launched {run['launches']}")
    log(f"main path cyrillic-md5 (--superstep off): stdout byte-identical "
        f"to the superstep run's ({len(run['stdout'])} bytes)")
    runs[("huge-word", "per-launch")] = huge_word_run(work, card)
    for name in ("cyrillic-md5", "greek-hebrew-sha1"):
        if runs[(name, "pair auto")]["hits"] != runs[(name, "pair off")][
                "hits"]:
            fail(f"{name}: --pair off printed different hits")
    expect_launched(runs[("cyrillic-md5", "pair auto")],
                    ["piece_pair/md5", "piece_k1/md5"],
                    "cyrillic-md5 (pair auto; long-word buckets: k1)")
    expect_launched(runs[("cyrillic-md5", "pair off")], ["piece_k1/md5"],
                    "cyrillic-md5 (pair off)")
    expect_launched(runs[("cyrillic-md5", "A5GEN_PAIR=off")],
                    ["piece_k1/md5"], "cyrillic-md5 (A5GEN_PAIR=off)")
    expect_launched(runs[("cyrillic-md5", "superstep off")],
                    ["piece_k1/md5"], "cyrillic-md5 (--superstep off)")
    expect_launched(runs[("czech-ntlm", "pair auto")], ["piece_digits/ntlm"],
                    "czech-ntlm")
    expect_launched(runs[("greek-hebrew-sha1", "pair auto")],
                    ["piece_pair/sha1"], "greek-hebrew-sha1 (pair auto)")
    expect_launched(runs[("greek-hebrew-sha1", "pair off")],
                    ["piece_k1/sha1"], "greek-hebrew-sha1 (pair off)")
    expect_launched(runs[("cyrillic-md5-x2", "-x 2")],
                    ["piece_windowed/md5"], "cyrillic-md5-x2")
    expect_launched(runs[("cyrillic-md5-s", "-s, pair auto")],
                    ["piece_suball_k1/md5"], "cyrillic-md5-s")
    expect_launched(runs[("azerty-md5-s", "-s")],
                    ["piece_suball_closed/md5"], "azerty-md5-s")
    expect_launched(runs[("cyrillic-sha1-s-x2", "-s -x 2")],
                    ["piece_suball_windowed/sha1"], "cyrillic-sha1-s-x2")
    expect_launched(runs[("czech-ntlm-s-r", "-s -r")],
                    ["piece_suball_k1/ntlm"], "czech-ntlm-s-r")
    expect_launched(runs[("cyrillic-md5-r", "-r, pair auto")],
                    ["piece_pair/md5"], "cyrillic-md5-r")
    expect_launched(runs[("german-md5", "german")],
                    ["bytescan_scalar/md5", "piece_k1/md5"],
                    "german-md5 (bucket 16: row 7; bucket 64: piece)")
    expect_launched(runs[("german-r-ntlm", "-r")], ["bytescan_scalar/ntlm"],
                    "german-r-ntlm")
    expect_launched(runs[("cyrillic-sha1-s", "-s")],
                    ["piece_suball_k1/sha1"], "cyrillic-sha1-s")
    expect_launched(runs[("czech-ntlm", "bytescan")],
                    ["bytescan_match/ntlm"], "bytescan-czech-ntlm")
    expect_launched(runs[("cyrillic-md5-x2", "bytescan -x 2")],
                    ["bytescan_scalar/md5"], "bytescan-cyrillic-x2")
    expect_launched(runs[("azerty-md5-s", "bytescan -s")],
                    ["bytescan_suball/md5"], "bytescan-azerty-s")
    expect_launched(runs[("cyrillic-sha1-s", "bytescan -s")],
                    ["bytescan_scalar/sha1"], "bytescan-cyrillic-s-sha1")
    expect_launched(runs[("cyrillic-x2-long", "-x 2")],
                    ["buffer_hash/md5", "piece_windowed/md5"],
                    "cyrillic-x2-long (long buckets: the XLA route)")
    expect_launched(runs[("leet9-sha1", "nine options")],
                    ["buffer_hash/sha1"], "leet9-sha1")
    if any(k.startswith(("piece_", "bytescan_"))
           for k in runs[("leet9-sha1", "nine options")]["launches"]):
        fail("leet9-sha1: a bucket took a fused kernel")
    for name, arm, algo in (
        ("czech-ntlm", "A5GEN_PALLAS=off", "ntlm"),
        ("greek-hebrew-sha1", "A5GEN_PALLAS=off", "sha1"),
        ("german-md5", "A5GEN_PALLAS=off", "md5"),
        ("azerty-md5-s", "A5GEN_PALLAS=off -s", "md5"),
    ):
        expect_launched(runs[(name, arm)], [f"buffer_hash/{algo}"],
                        f"{name} ({arm})")
    main_launches: dict = {}
    width_launches: dict = {}
    for run in runs.values():
        for k, v in run["launches"].items():
            main_launches[k] = main_launches.get(k, 0) + v
        for k, v in run["widths"].items():
            width_launches[k] = width_launches.get(k, 0) + v
    log("buffer_hash launches on the main path by (kernel, row width): "
        + ", ".join(f"{k} width {w}: {n}"
                    for (k, w), n in sorted(width_launches.items())))
    czech = runs[("czech-ntlm", "pair auto")]
    czech_rows = max(1, sum(czech["launches"].values()) * LANES)
    log(f"czech-ntlm main path: {czech['emitted']} candidates on "
        f"{czech_rows} rows: {100.0 * (1 - czech['emitted'] / czech_rows):.1f}"
        f"% of the rows masked")
    # Candidates mode (no --digests): the XLA expansion alone.
    cand_cells = candidates_checks(work, dictionary, card)

    # -- phase 5: timing ----------------------------------------------------
    floor = compression_floor(peak_ops)
    kernels = []
    for (entry, algo), case in cases.items():
        if (entry, algo) in multi or (entry, algo) in others:
            continue
        ms = time_call(case.kernel, 20)
        plain_ms = time_call(case.plain, 1)
        emit = checks[(entry, algo)]["emit"]
        bound_ms, bound_by = case.bound(emit, peak_ops)
        rows = int(emit.shape[0])
        # The same entry point x hash on the multi-block and other
        # workloads of phase 3.
        more_checks = {f"{e}/{a}": checks[(e, a)]["mismatches"]
                       for (e, a) in list(multi) + list(others) if a == algo
                       and e.split("-")[0].split(":")[0] == entry}
        if entry == "windowed":
            more_checks[f"cta-edges/{algo}"] = win_edges[algo]["mismatches"]
        more_checks.update({k: v for k, v in tile_checks.items()
                            if k.split("/")[1] == entry
                            and k.endswith(f"/{algo}")})
        masked = 1 - int(emit.sum()) / rows
        floor_ms = floor[algo] * int(emit.sum()) / LANES
        geom = ""
        if case.decode == "windowed":
            g, nt, smem = win_geometry(case)
            geom = (f"; CTA: {g} blocks, {nt} threads, {smem} B dynamic "
                    "smem")
        log(f"{case.key} [{case.name}, {case.hash_blocks} hash block(s) "
            f"compiled]: {ms:.4f} ms/launch over {rows} "
            f"candidate rows ({rows / ms * 1e3:.4g} candidates/s, "
            f"{int(emit.sum()) / ms * 1e3:.4g} emitted/s, "
            f"{100 * masked:.1f}% masked); bound {bound_ms:.4f} ms ({bound_by}, "
            f"{100 * bound_ms / ms:.0f}% of it reached); compression floor "
            f"{floor_ms:.4f} ms ({100 * floor_ms / ms:.0f}% of it reached); "
            f"plain {plain_ms:.3f} ms{geom}")
        variants = {}
        if (entry, algo) == ("digits", "md5"):
            # The huge word's own shape, where this entry's main-path
            # launches come from.
            huge = cases[("digits:huge", "md5")]
            h_emit = checks[("digits:huge", "md5")]["emit"]
            h_ms = time_call(huge.kernel, 20)
            h_plain = time_call(huge.plain, 1)
            h_bound, h_by = huge.bound(h_emit, peak_ops)
            h_masked = 1 - int(h_emit.sum()) / int(h_emit.shape[0])
            log(f"{huge.key} [{huge.name}, its per-launch pipeline's first "
                f"launch, {int(h_emit.shape[0])} rows]: {h_ms:.4f} "
                f"ms/launch ({100 * h_masked:.1f}% masked); bound "
                f"{h_bound:.4f} ms ({h_by}, {100 * h_bound / h_ms:.0f}% of "
                f"it reached); plain {h_plain:.3f} ms")
            variants["huge word"] = dict(
                workload=huge.name, ms=h_ms, plain_ms=h_plain,
                bound_ms=h_bound, bound_by=h_by, masked_share=h_masked,
                mismatches=checks[("digits:huge", "md5")]["mismatches"])
        kernels.append({
            "name": case.key,
            "route": "cuda",
            "source": KERNEL_SOURCE,
            "replaces": f"{PALLAS}:1303",
            "branch": f"{BRANCHES[entry]}; {ROUNDS[algo]}",
            "wrapper": (f"{PALLAS}:2373 fused_expand_suball_md5"
                        if entry.startswith("suball")
                        else f"{PALLAS}:2019 fused_expand_md5"),
            "workload": case.name,
            "hash_blocks": case.hash_blocks,
            "launches": main_launches.get(case.key, 0),
            "main_path": case.key in main_launches,
            "mismatches": checks[(entry, algo)]["mismatches"],
            "other_cases_mismatches": more_checks,
            "max_abs_err": checks[(entry, algo)]["max_abs_err"],
            "ms": ms,
            "floor_ms": floor_ms,
            "masked_share": masked,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,
            **({"variants": variants} if variants else {}),
        })
    stage_breakdown(cases[("pair", "md5")], paths["cyrillic-md5"].digest_set,
                    2)
    stage_breakdown(cases[("digits", "ntlm")],
                    paths["czech-ntlm"].digest_set, None)
    stage_breakdown(cases[("pair", "sha1")],
                    paths["greek-hebrew-sha1"].digest_set, 2)
    stage_breakdown(cases[("suball_closed", "md5")],
                    paths["azerty-md5-s"].digest_set, None)
    # The byte-scan kernels: every tier x hash timed; the kernels line
    # lists one entry per kernel x hash (bytescan_<row>/<algo>, the
    # LAUNCHES key) with the main path's workload as its representative
    # and every other tier of that kernel under "variants".
    bs_times = {}
    for (label, algo), case in bs_cases.items():
        if (label, algo) in bs_multi:
            continue
        ms = time_call(case.kernel, 20)
        plain_ms = time_call(case.plain, 1)
        emit = bs_checks[(label, algo)]["emit"]
        bound_ms, bound_by = case.bound(emit, peak_ops)
        rows = int(emit.shape[0])
        bs_times[(label, algo)] = dict(
            workload=case.name, variant=case.variant,
            hash_blocks=case.hash_blocks, ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by,
            mismatches=bs_checks[(label, algo)]["mismatches"],
            max_abs_err=bs_checks[(label, algo)]["max_abs_err"])
        log(f"{case.key} {case.variant} [{case.name}, {case.hash_blocks} "
            f"hash block(s) compiled]: {ms:.4f} ms/launch over {rows} "
            f"candidate rows ({int(emit.sum()) / ms * 1e3:.4g} emitted/s); "
            f"bound {bound_ms:.4f} ms ({bound_by}, "
            f"{100 * bound_ms / ms:.0f}% of it reached); plain "
            f"{plain_ms:.3f} ms")
    representative = {"scalar": "scalar-bitmask", "match": "match-digits",
                      "suball": "suball-closed"}
    bs_replaces = {"scalar": f"{PALLAS}:619 _make_scalar_kernel",
                   "match": f"{PALLAS}:1758 _make_kernel",
                   "suball": f"{PALLAS}:2214 _make_suball_kernel"}
    for algo in ALGOS:
        for row, label in representative.items():
            t = bs_times[(label, algo)]
            key = f"bytescan_{row}/{algo}"
            kernels.append({
                "name": key,
                "route": "cuda",
                "source": BYTESCAN_SOURCE,
                "replaces": bs_replaces[row],
                "wrapper": (f"{PALLAS}:2502-2603 fused_expand_suball_md5"
                            if row == "suball" or label.startswith(
                                "scalar-suball")
                            else f"{PALLAS}:2117-2211 fused_expand_md5"),
                "workload": t["workload"],
                "variant": t["variant"],
                "hash_blocks": t["hash_blocks"],
                "launches": main_launches.get(key, 0),
                "main_path": key in main_launches,
                "mismatches": t["mismatches"],
                "variants": {lb: {k: v for k, v in tv.items()}
                             for (lb, a), tv in bs_times.items()
                             if a == algo and lb != label
                             and bs_tiers[lb][0] == row},
                "other_cases_mismatches": {
                    **{f"{lb}/{a}": bs_checks[(lb, a)]["mismatches"]
                       for (lb, a) in bs_multi
                       if a == algo and bs_tiers[tier_of(lb)[0]][0] == row},
                    **{k: v for k, v in bs_edge_checks.items()
                       if k.endswith(f"/{algo}")
                       and bs_tiers[k.split("/")[1]][0] == row}},
                "max_abs_err": t["max_abs_err"],
                "ms": t["ms"],
                "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"],
                "library_ms": None,
            })
    stage_breakdown(bs_cases[("scalar-bitmask", "md5")],
                    paths["german-md5"].digest_set, None)
    for algo, (pc, bc) in tier_pair.items():
        # In turns (piece, row 7, row 7, piece) within this call.
        t = [time_call(c.kernel, 20) for c in (pc, bc, bc, pc)]
        log(f"german-ss x {algo}, one plan on both tiers "
            f"({tier_emitted[algo]} emitted of {LANES} rows): {pc.key} "
            f"{t[0]:.4f} / {t[3]:.4f} "
            f"ms, {bc.key} bitmask {t[1]:.4f} / {t[2]:.4f} ms per launch "
            f"(row 7 / piece: {(t[1] + t[2]) / (t[0] + t[3]):.2f}x)")
    # The buffer hash, per hash x block count; the kernels line lists one
    # entry per hash (buffer_hash/<algo>, the LAUNCHES key) at one block
    # (TPU row 10's shape), the other block counts under "variants".
    bh_times = time_buffer_hash(peak_ops, floor)
    for algo in ALGOS:
        t = bh_times[(algo, "1 block")]
        key = f"buffer_hash/{algo}"
        kernels.append({
            "name": key,
            "route": "cuda",
            "source": BUFFER_SOURCE,
            "replaces": f"{PALLAS_MD5}:47 _md5_kernel",
            "wrapper": (f"{PALLAS_MD5}:87 md5_pallas" if algo == "md5" else
                        "hashcat_a5_table_generator_tpu/ops/hashes.py:257-295 "
                        f"HASH_FNS['{algo}'] (the XLA hash row 10 stands "
                        "in for under A5GEN_PALLAS=1)"),
            "workload": f"random rows, width {t['width']}, lengths 0..W",
            "hash_blocks": 1,
            "launches": main_launches.get(key, 0),
            "main_path": key in main_launches,
            "mismatches": bh_checks[(algo, "1 block")]["mismatches"],
            "variants": {label: dict(bh_times[(algo, label)], **bh_checks[
                (algo, label)]) for label, _w in buffer_shapes(algo)
                if label != "1 block"},
            "max_abs_err": bh_checks[(algo, "1 block")]["max_abs_err"],
            "ms": t["ms"],
            "floor_ms": t["floor_ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": None,
            "launches_by_width": {str(w): n for (k, w), n in
                                  sorted(width_launches.items())
                                  if k == key},
            "edge_mismatches": {label: bh_checks[(algo, label)]["mismatches"]
                                for label, *_ in BUFFER_EDGES},
        })
    cyr_long = [w for w in x2_long if len(w) > 64]
    leet9_words = dictionary(50000, seed=85, long_lines=False)
    check_xla_memory({
        "main path cyrillic-x2-long, lines over 64 bytes": (
            cyr, cyr_long, {"max_substitute": 2}, False),
        "main path leet9-sha1": (LEET9, leet9_words, {"algo": "sha1"},
                                 False),
    })
    xla_stage_breakdown(AttackSpec(max_substitute=2), cyr, cyr_long,
                        paths["cyrillic-x2-long"].digest_set)
    xla_stage_breakdown(AttackSpec(algo="sha1"), LEET9, leet9_words,
                        paths["leet9-sha1"].digest_set)

    # -- phase 6: the oracle backend ------------------------------------------
    oracle = oracle_phase(work, cand_cells, paths["cyrillic-md5"],
                          runs[("cyrillic-md5", "pair auto")], card)
    oracle["azerty_s_drive_s"] = {
        "native": runs[("azerty-md5-s", "-s")]["drive"],
        "A5_NATIVE=0": runs[("azerty-md5-s", "A5_NATIVE=0 -s")]["drive"]}
    # -- phase 7: robustness -----------------------------------------------
    robustness = robustness_phase(work, paths, runs, cand_cells, small,
                                  card)
    # -- phase 8: layouts and streaming ---------------------------------------
    layouts = layouts_streaming_phase(work, paths, runs, cand_cells, card)
    # -- phase 9: the schema cache, the prefetcher, devices and the pod -----
    runs[("small", "warm-up")] = warm_up
    pod = pod_phase(work, paths, runs, cand_cells, card)
    # -- phase 10: the resident engine (a5gen serve) ------------------------
    serve, serve_inputs = serve_phase(work, paths, runs, card)
    # -- phase 11: the fleet router (a5gen fleet) ------------------------
    fleet = fleet_phase(work, serve_inputs, card)
    # -- phase 12: the geometry tuner (a5gen tune) ------------------------
    tuned = tune_phase(work, paths["cyrillic-md5"],
                       runs[("cyrillic-md5", "pair auto")], kind, card)
    # -- phase 13: the audit (kernel pins, host syncs in the bodies) -------
    audited = audit_phase(built["reports"], paths, card)
    shutil.rmtree(work, ignore_errors=True)
    elapsed = time.monotonic() - T0
    log(f"done in {elapsed:.1f} s")
    print(json.dumps({"audit": audited}))
    print(json.dumps({"tune": tuned}))
    print(json.dumps({"fleet": fleet}))
    print(json.dumps({"serve": serve}))
    print(json.dumps({"pod": pod}))
    print(json.dumps({"layouts_streaming": layouts}))
    print(json.dumps({"robustness": robustness}))
    print(json.dumps({"oracle": oracle}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
