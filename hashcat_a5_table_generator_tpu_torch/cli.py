"""The command-line surface of the PyTorch/CUDA package: the oracle
backend (the default) and the device backend's crack and candidates
modes.

Same flags and output as the reference CLI for what this package runs::

  a5gen DICT_FILE -t TABLE [-t TABLE ...] [-m MIN] [-x MAX] [-s] [-r]
        [--threads N] [--bug-compat]
        [--backend oracle|device] [--algo md5|md4|sha1|ntlm --digests FILE]
        [--hex-unsafe] [--device cuda|cpu] [--devices N|auto]
        [--checkpoint FILE [--checkpoint-every S] [--no-resume]]
        [--retries N] [--fetch-timeout S] [--fetch-chunk N]
        [--block-layout auto|packed|stride] [--stream-chunk-words N|auto|off]
        [--schema-cache DIR [--schema-cache-max-mb MB]]
        [--coordinator HOST:PORT --num-processes N --process-id I
         [--pod-hits gathered|local] [--giant-job]]
        [--progress] [--profile DIR] [--metrics-json FILE]
  a5gen --emit-table LAYOUT [--output FILE]
  a5gen --list-layouts
  a5gen serve [--socket PATH] [--device cuda|cpu] [--pack auto|on|off]
        [--lanes N] [--blocks N] [...]
  a5gen fleet --engines N|SOCK,... [--device cuda|cpu] [--socket PATH]
        [--place affinity|round-robin] [--split auto|on|off]
        [--autoscale MIN:MAX [--scale-up-at F] [--scale-down-at F]
         [--scale-window N] [--scale-cooldown S]] [...]
  a5gen tune [--device cuda|cpu] [--words N] [--seconds S] [--smoke]
        [--state FILE] [--profile-dir DIR] [--no-write] [--json]

``--backend oracle`` (the default) streams the byte-exact CPU engines in
the reference's ``--threads 1`` order (word order, DFS order within a
word), through the native C++ engines (``native.oracle_engine``) where
``default_engine_eligible`` admits the run, else the Python generators;
``--threads N`` runs N worker processes with an in-order merge
(``oracle.parallel``), so the stream stays byte-identical at any N.
Crack mode (``--digests``) hashes every candidate on the host and prints
``digest:plain`` hits, then ``N hits`` on stderr.  The oracle never
touches CUDA; ``--device`` has no meaning there.  ``--bug-compat``
reproduces the reference's reverse-mode offset bug (Q3) in the oracle;
on the device backend ``-r`` without ``-s`` reroutes to the oracle.

``--backend device``: default, reverse (``-r``), substitute-all (``-s``)
and substitute-all reverse (``-s -r``) mode, one GPU, the wordlist read
through the native scanner/packer (``native.read_packed_buckets``).
Crack mode: every hash, each bucket on the route the reference's gate
picks — the piece kernel, the byte-scan kernels (plans without a piece
schema, or ``A5GEN_EMIT=bytescan``) or the XLA expand + hash route (plans
the fused kernels refuse, or ``A5GEN_PALLAS=off``); hits print to stdout
as ``digest:plain`` potfile lines, bucket-major in the order found.
Candidates mode (no ``--digests``): every candidate, one line each, in
word order (one global width unless ``--buckets`` is given), to stdout,
``--hex-unsafe`` wrapping line-corrupting candidates in ``$HEX[]``.  The
summary (word routing, kernel tiers, bucket routes) goes to stderr.
``--device`` defaults to ``cuda`` and never falls back to the CPU on its
own.  ``--checkpoint FILE`` makes both modes resumable (the reference's
documents: a checkpoint written by either package resumes in the other;
bucketed runs keep a manifest at FILE and one ``FILE.w{width}`` per
bucket); ``--retries N`` reruns a failed sweep from its last checkpoint;
``--block-layout`` picks the fixed-stride or the variable-offset block
layout (``auto``: variable-offset when ``--blocks`` does not divide
``--lanes``); ``--stream-chunk-words`` streams the dictionary in word
chunks (``auto``, the default, past one ~64 MB-of-plan chunk;
``A5GEN_STREAM=off`` or ``off`` compiles it whole);
``--fetch-timeout`` sets the fetch watchdog; ``--progress``,
``--metrics-json`` and ``--profile`` report the sweep's telemetry.
``--schema-cache DIR`` keeps the compiled piece schemas on disk (the
reference's entries: one directory serves both packages;
``--schema-cache-max-mb`` caps it).  ``--devices N`` sweeps N cursor
stripes (the first N GPUs; with ``--device cpu``, N stripes over the
CPU); more GPUs than the machine has is an error, never fewer stripes.
``--coordinator`` / ``--num-processes`` / ``--process-id`` run a pod of
processes over ``torch.distributed`` (gloo; ``parallel.multihost``): each
sweeps a stripe of the dictionary, or with ``--giant-job`` every process
sweeps it whole and owns its stripes of every launch; ``--pod-hits
gathered`` (the default) prints the combined hits on process 0,
``local`` each process's own, with no collective.  Each process
checkpoints at ``FILE.p<id>``; a peer that dies makes a process waiting
for it exit 3 with the recovery text.
``--output`` names ``--emit-table``'s file only, as in the reference:
both backends' candidate and hit streams go to stdout.

``a5gen serve`` runs the resident engine (``runtime/engine.py``): jobs
arrive as JSONL (the wire of ``runtime/protocol.py``, ``PROTOCOL.json``)
on stdin or a unix socket (``--socket``), events stream back as JSONL;
compatible crack jobs fuse into packed dispatches (``--pack``).  It runs
on the GPU unless ``--device cpu`` is given, and without a GPU it exits
non-zero instead of serving on the CPU.  Its launch geometry defaults
resolve at startup as the sweep's do: an explicit flag, else the
device's autotune profile, else 2^22 lanes on cuda, 2^17 on cpu (blocks
lanes/128).
``a5gen fleet`` (``runtime/fleet.py``) routes the same JSONL wire over a
pool of engines: ``--engines N`` spawns N ``a5gen serve`` processes of
this package (on the GPU unless ``--device cpu`` is given, which is
forwarded to them), ``--engines SOCK,...`` attaches to running engines of
either package; it places jobs by affinity under admission control,
drains, migrates, crash-replays and splits giant jobs, and itself
touches no device; with ``--autoscale MIN:MAX`` (spawn mode) it spawns
engines on sustained backlog and drains and reaps idle or quarantined
ones (``runtime/autoscale.py``).  ``a5gen tune`` (``runtime/tune.py``)
times a matrix of launch geometries over a synthetic crack contract on
the GPU (``--device cpu``: the CPU), checks that every arm emits the
same stream, and writes the winner as the device's profile
(``~/.cache/a5gen/tune/<device>.json``; ``A5GEN_TUNE_PROFILE``
overrides the directory or, ``off``, disables loading): sweeps and
``serve`` without ``--lanes`` then take their geometry from it.  Under
``--backend oracle`` the device backend's flags do what the reference's
do there: the stateless ones warn that they have no effect, the rest are
ignored.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional, Sequence

PROG = "a5gen"
DIGEST_BYTES = {"md5": 16, "md4": 16, "ntlm": 16, "sha1": 20}

def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog=PROG,
        description=(
            "Table-lookup candidate engine (hashcat -a 5 style), PyTorch/"
            "CUDA device backend: apply substitution tables to a "
            "dictionary and stream every variant, or hash every variant "
            "on the GPU against a digest list."
        ),
    )
    ap.add_argument("dict_file", nargs="?",
                    help="dictionary file, one word per line")
    ap.add_argument("-t", "--table-files", action="append", default=[],
                    metavar="FILE",
                    help="substitution table (repeatable; later tables "
                         "append alternative substitutions per key)")
    ap.add_argument("-m", "--table-min", type=int, default=0,
                    help="minimum substitutions per candidate (default 0)")
    ap.add_argument("-x", "--table-max", type=int, default=15,
                    help="maximum substitutions per candidate (default 15)")
    ap.add_argument("-s", "--substitute-all", action="store_true",
                    help="substitute-all mode: replace every occurrence of "
                         "each chosen pattern (transliteration)")
    ap.add_argument("-r", "--reverse-sub", action="store_true",
                    help="reverse mode: first option per key only "
                         "(with -s: substitute-all reverse)")
    ap.add_argument("--threads", type=int, default=-1,
                    help="oracle backend: expand words across N worker "
                         "processes; the stream stays byte-identical to "
                         "--threads 1 (in-order merge). <=1 or unset = "
                         "sequential. The device backend ignores it")
    ap.add_argument("--backend", choices=("oracle", "device"),
                    default="oracle",
                    help="oracle (default): byte-exact CPU engines in "
                         "deterministic DFS order; device: the GPU sweep "
                         "(per-word multiset parity)")
    ap.add_argument("--algo", choices=sorted(DIGEST_BYTES), default="md5",
                    help="hash algorithm for --digests mode (default md5)")
    ap.add_argument("--digests", metavar="FILE",
                    help="hex digest list (one per line); crack mode: "
                         "print digest:plain hits instead of candidates")
    ap.add_argument("--hex-unsafe", action="store_true",
                    help="wrap line-corrupting candidates in $HEX[...]")
    ap.add_argument("--bug-compat", action="store_true",
                    help="reproduce the reference's reverse-mode offset bug "
                         "(Q3) in the oracle backend")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the device backend's sweep runs (default "
                         "cuda; cpu runs the plain PyTorch version of the "
                         "kernels); no meaning under --backend oracle, "
                         "which never touches CUDA")
    ap.add_argument("--lanes", type=int, default=None,
                    help="hash lanes per launch (default 2^22 on cuda, "
                         "2^17 on cpu)")
    ap.add_argument("--blocks", type=int, default=None,
                    help="blocks per launch (default lanes/128, or 1024 "
                         "when 128 does not divide --lanes)")
    ap.add_argument("--superstep", type=_superstep_arg, default=None,
                    metavar="N|auto|off",
                    help="launches per device superstep (default 16); "
                         "'off' runs the per-launch pipeline (blocks cut "
                         "on the host for each launch; also "
                         "A5GEN_SUPERSTEP=off); the stream is the same")
    ap.add_argument("--pair", choices=("auto", "on", "off"),
                    default="auto",
                    help="pair-lane tier: 2 candidates per hash lane where "
                         "the substitution geometry allows (default auto)")
    ap.add_argument("--buckets", type=_buckets_arg, default="auto",
                    metavar="W1,W2,...",
                    help="length-bucket boundaries (default 16,32,64 in "
                         "crack mode; none in candidates mode, so the "
                         "stream keeps dictionary order; 'none' = one "
                         "global width)")
    ap.add_argument("--max-word-bytes", type=int, default=64 * 1024,
                    help="reject dictionary lines longer than this instead "
                         "of silently truncating input (reference Q8)")
    ap.add_argument("--checkpoint", metavar="FILE",
                    help="checkpoint path for resumable sweeps "
                         "(device backend)")
    ap.add_argument("--checkpoint-every", type=float, default=30.0,
                    metavar="SECONDS", help="checkpoint interval")
    ap.add_argument("--no-resume", action="store_true",
                    help="ignore an existing checkpoint and start over")
    ap.add_argument("--retries", type=int, default=0, metavar="N",
                    help="re-run a failed device sweep up to N times, "
                         "resuming from the last checkpoint. Crack mode is "
                         "exactly-once: hits dedupe across attempts. "
                         "Candidates mode requires --checkpoint and is "
                         "at-least-once: candidates emitted since the last "
                         "checkpoint repeat after a retry (bound the window "
                         "with --checkpoint-every; a notice marks each "
                         "retry on stderr). A real CUDA fault (illegal "
                         "address, Xid, ECC) leaves this process's device "
                         "context unusable: it is survived by a fresh "
                         "process resuming the checkpoint, not by these "
                         "in-process retries")
    ap.add_argument("--fetch-timeout", type=float, default=None,
                    metavar="SECONDS",
                    help="device backend: watchdog on each consumed "
                         "device fetch — a fetch still pending after "
                         "SECONDS raises a typed FetchTimeout, which the "
                         "drive's transient-retry supervisor re-dispatches "
                         "from the last fetched boundary. Default off: "
                         "CPU sweeps and cold builds legitimately stall "
                         "longer than any sane timeout")
    ap.add_argument("--fetch-chunk", type=_positive_int, default=None,
                    metavar="N",
                    help="crack mode: launches per superstep when "
                         "--superstep is unset, and the most launches "
                         "whose counts the per-launch pipeline fetches "
                         "together (chunks grow adaptively 1..N; default "
                         "16)")
    ap.add_argument("--block-layout", choices=("auto", "packed", "stride"),
                    default="auto",
                    help="stride: every block owns lanes/blocks lanes "
                         "(the fused kernels and the superstep drive); "
                         "packed: variable-size blocks packed back to "
                         "back, each lane searching for its block (the "
                         "XLA expand + hash route and the per-launch "
                         "pipeline, as in the reference); auto (default): "
                         "stride when --blocks divides --lanes, else "
                         "packed. The streams are the same either way")
    ap.add_argument("--stream-chunk-words", type=_stream_chunk_arg,
                    default="auto", metavar="N|auto|off",
                    help="device backend: compile the dictionary's plan "
                         "in word chunks on a host worker thread while "
                         "the device sweeps the previous chunk, freeing "
                         "consumed chunks. 'auto' (default) streams a "
                         "dictionary of more than one ~64 MB-of-plan "
                         "chunk (65536 words at width 16); 'off' "
                         "compiles it whole (also A5GEN_STREAM=off); N "
                         "chunks at N words. The candidate/hit streams "
                         "and checkpoints are the same either way")
    ap.add_argument("--progress", action="store_true",
                    help="periodic JSON progress lines on stderr")
    ap.add_argument("--profile", metavar="DIR",
                    help="write a torch.profiler trace of the device sweep "
                         "to DIR/trace.json (Chrome trace format; inspect "
                         "with Perfetto); each consumed superstep is an "
                         "a5.superstep.consume range")
    ap.add_argument("--profile-dir", metavar="DIR", dest="profile",
                    help="alias of --profile")
    ap.add_argument("--metrics-json", metavar="FILE",
                    help="after the sweep, write the final telemetry "
                         "snapshot (metrics registry + per-sweep span "
                         "summary) as JSON to FILE; A5GEN_TELEMETRY=off "
                         "disables the instrumentation")
    ap.add_argument("--schema-cache", metavar="DIR",
                    help="on-disk PieceSchema cache directory: repeat "
                         "sweeps of the same inputs skip schema "
                         "compilation (A5GEN_SCHEMA_CACHE is the env "
                         "equivalent); one directory serves this package "
                         "and the reference")
    ap.add_argument("--schema-cache-max-mb", type=float, default=None,
                    metavar="MB",
                    help="LRU size cap on the --schema-cache directory: "
                         "after each write, oldest-atime entries are "
                         "evicted until the cache fits "
                         "(A5GEN_SCHEMA_CACHE_MAX_MB is the env "
                         "equivalent; default unbounded)")
    ap.add_argument("--devices", type=_devices_arg, default=1, metavar="N",
                    help="sweep over N cursor stripes: the first N CUDA "
                         "devices (or, with --device cpu, N stripes over "
                         "the CPU); 'auto' = every visible CUDA device; "
                         "default 1.  More devices than the machine has "
                         "is an error")
    ap.add_argument("--coordinator", metavar="HOST:PORT",
                    help="pod sweep: the rendezvous address (process 0 "
                         "hosts it; run the same command in every process "
                         "with its own --process-id); each process sweeps "
                         "a contiguous stripe of the dictionary on its "
                         "devices, and hit records are all-gathered over "
                         "torch.distributed (gloo)")
    ap.add_argument("--num-processes", type=int, default=None, metavar="N",
                    help="pod sweep: total participating processes")
    ap.add_argument("--process-id", type=int, default=None, metavar="I",
                    help="pod sweep: this process's rank in [0, N)")
    ap.add_argument("--giant-job", action="store_true",
                    help="pod giant-job mode (crack only): instead of "
                         "striping the DICTIONARY across processes, every "
                         "process sweeps the SAME full wordlist and each "
                         "launch's blocks are striped across all the "
                         "pod's devices — one job whose (word, rank) "
                         "cursor is interchangeable with a single-device "
                         "sweep's; needs --coordinator; combine with "
                         "--pod-hits local for the elastic variant")
    ap.add_argument("--pod-hits", choices=("gathered", "local"),
                    default="gathered",
                    help="pod hit reporting: 'gathered' (default) "
                         "all-gathers hit records and process 0 prints "
                         "them in the single-process order; 'local' "
                         "prints each process's own stripe's hits on its "
                         "own stdout with NO collectives — a dead peer "
                         "cannot block the others (relaunch only its "
                         "stripe)")
    ap.add_argument("--emit-table", metavar="LAYOUT",
                    help="write a built-in layout as a .table file to stdout "
                         "(or --output) and exit")
    ap.add_argument("--output", metavar="FILE",
                    help="output path for --emit-table")
    ap.add_argument("--list-layouts", action="store_true",
                    help="list built-in and derived layouts and exit")
    return ap


def _stream_chunk_arg(value: str):
    """--stream-chunk-words: 'auto', 'off', or a positive word count."""
    if value in ("auto", "off"):
        return value
    try:
        n = int(value)
        if n < 1:
            raise ValueError
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"must be a positive integer, 'auto', or 'off', got {value!r}"
        )
    return n


def _buckets_arg(value: str):
    """--buckets: comma-separated ascending widths, 'none', or 'auto'."""
    if value == "auto":
        return "auto"
    if value == "none":
        return None
    try:
        widths = tuple(int(v) for v in value.split(","))
        if not widths or any(w < 4 for w in widths) or any(
            a >= b for a, b in zip(widths, widths[1:])
        ):
            raise ValueError
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"must be ascending widths >= 4 (e.g. 16,32,64) or 'none', "
            f"got {value!r}"
        )
    return widths


def _positive_int(value: str) -> int:
    try:
        n = int(value)
        if n < 1:
            raise ValueError
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"must be a positive integer, got {value!r}"
        )
    return n


def _devices_arg(value: str):
    """--devices: a positive int, or 'auto' (None) = every visible CUDA
    device."""
    if value == "auto":
        return None
    try:
        n = int(value)
        if n < 1:
            raise ValueError
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"must be a positive integer or 'auto', got {value!r}"
        )
    return n


def _superstep_arg(value: str):
    """--superstep: 'auto' (None), 'off' (0: the per-launch pipeline) or
    a positive launch count."""
    if value == "auto":
        return None
    if value == "off":
        return 0
    try:
        n = int(value)
        if n < 1:
            raise ValueError
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"must be a positive integer, 'auto', or 'off', got {value!r}"
        )
    return n


_HEX_LUT = None


def _parse_digest_blob(data: bytes, want: int, path: str) -> "list | None":
    """Vectorized left-list parse: the whole file as one numpy pass.
    Returns None — the caller falls back to the exact per-line loop — on
    inputs the vector path doesn't model (leading whitespace) AND on any
    malformed line, so error messages always come from the loop."""
    import numpy as np

    global _HEX_LUT
    if _HEX_LUT is None:
        lut = np.full(256, 255, dtype=np.uint8)
        for i in range(10):
            lut[ord("0") + i] = i
        for i in range(6):
            lut[ord("a") + i] = 10 + i
            lut[ord("A") + i] = 10 + i
        _HEX_LUT = lut

    if not data:
        return []
    if not data.endswith(b"\n"):
        data += b"\n"
    arr = np.frombuffer(data, dtype=np.uint8)
    nl = np.flatnonzero(arr == 10)
    starts = np.concatenate(([0], nl[:-1] + 1)).astype(np.int64)
    ends = nl
    lens = ends - starts
    has_cr = (lens > 0) & (arr[np.maximum(ends - 1, 0)] == 13)
    lens = lens - has_cr
    first = arr[np.minimum(starts, arr.shape[0] - 1)]
    nonblank = lens > 0
    if bool((nonblank & ((first == 32) | (first == 9))).any()):
        return None
    keep = nonblank & (first != ord("#"))
    ks, kl = starts[keep], lens[keep]
    if ks.shape[0] == 0:
        return []
    # The digest is the first field: exactly 2*want hex chars, then end
    # of line or ':'.
    sep_pos = np.minimum(ks + 2 * want, arr.shape[0] - 1)
    bad = (kl < 2 * want) | ((kl > 2 * want) & (arr[sep_pos] != ord(":")))
    if int(ks[-1]) + 2 * want > arr.shape[0]:
        return None
    off_t = np.int32 if arr.shape[0] < (1 << 31) else np.int64
    if bool(bad.any()):
        return None
    n = ks.shape[0]
    mat = np.empty((n, want), dtype=np.uint8)
    chunk = 1 << 20
    rng = np.arange(2 * want, dtype=off_t)
    for lo in range(0, n, chunk):
        sub = ks[lo:lo + chunk].astype(off_t)[:, None] + rng
        nib = _HEX_LUT[arr[sub]]
        if bool((nib == 255).any()):
            return None
        mat[lo:lo + chunk] = (nib[:, 0::2] << 4) | nib[:, 1::2]
    return mat


def _read_digests(path: str, algo: str):
    """Load a digest left-list: an ``[N, digest_bytes] uint8`` matrix
    (vectorized fast path) or a ``List[bytes]`` (exact per-line loop)."""
    want = DIGEST_BYTES[algo]
    with open(path, "rb") as fh:
        data = fh.read()
    fast = _parse_digest_blob(data, want, path)
    if fast is not None:
        return fast
    out: List[bytes] = []
    for ln, raw in enumerate(data.split(b"\n"), 1):
        line = raw.strip()
        if not line or line.startswith(b"#"):
            continue
        field = line.split(b":", 1)[0]
        try:
            dig = bytes.fromhex(field.decode("ascii"))
        except (UnicodeDecodeError, ValueError) as e:
            raise SystemExit(
                f"{path}:{ln}: not a hex digest: {field[:40]!r} ({e})"
            )
        if len(dig) != want:
            raise SystemExit(
                f"{path}:{ln}: {len(dig)}-byte digest, {algo} needs {want}"
            )
        out.append(dig)
    return out


def _run_emit_table(args) -> int:
    from .tables.layouts import emit_table, get_layout

    layout = get_layout(args.emit_table)
    if args.output:
        emit_table(layout, args.output)
    else:
        sys.stdout.buffer.write(layout.to_table_bytes())
    return 0


def _run_list_layouts() -> int:
    from .tables.layouts import BUILTIN_LAYOUTS, DERIVED_LAYOUTS

    for name in sorted(BUILTIN_LAYOUTS):
        print(f"{name}\t(built-in)\t{BUILTIN_LAYOUTS[name].description}")
    for name in sorted(DERIVED_LAYOUTS):
        print(f"{name}\t(derived)\t{DERIVED_LAYOUTS[name].description}")
    return 0


def native_default_eligible(sub_map, mode: str, crack: bool,
                            hex_unsafe: bool,
                            max_substitute: int = 15) -> bool:
    """Whether the C++ oracle engines can serve this run: a thin shim over
    the ONE shared predicate, ``native.oracle_engine
    .default_engine_eligible``, which the --threads workers and the
    device sweep's fallback words use too."""
    from .native.oracle_engine import default_engine_eligible

    return default_engine_eligible(
        sub_map,
        substitute_all=mode.startswith("suball"),
        reverse=mode in ("reverse", "suball-reverse"),
        crack=crack,
        hex_unsafe=hex_unsafe,
        max_substitute=max_substitute,
    )


def _native_default_engine(args, sub_map, mode: str, crack: bool,
                           hex_unsafe: "bool | None" = None):
    """A ready NativeDefaultOracle, or None (ineligible, no toolchain or
    ``A5_NATIVE=0``: the Python engines run).  ``hex_unsafe`` overrides
    the flag for callers whose output never wraps (crack's potfile
    lines)."""
    hu = args.hex_unsafe if hex_unsafe is None else hex_unsafe
    if not native_default_eligible(sub_map, mode, crack, hu,
                                   args.table_max):
        return None
    from .native.oracle_engine import NativeDefaultOracle, available

    if not available():
        return None
    return NativeDefaultOracle(sub_map)


def _run_oracle(args, sub_map, words) -> int:
    """Reference semantics, reference order (--threads 1): word order,
    DFS order within each word (Q9).  Nothing here initializes CUDA or
    runs a torch op, so ``--threads N`` forks a clean process."""
    from .oracle.engines import iter_candidates
    from .runtime.sinks import CandidateWriter, potfile_line

    mode = _mode(args)
    crack = args.digests is not None
    iter_kw = dict(
        min_substitute=args.table_min,
        max_substitute=args.table_max,
        substitute_all=mode.startswith("suball"),
        reverse=mode in ("reverse", "suball-reverse"),
        bug_compat=args.bug_compat,
    )
    if args.threads and args.threads > 1:
        # Multi-process oracle (oracle.parallel): the same byte stream on
        # N cores; the in-order merge keeps --threads 1 order at any N.
        from .oracle.parallel import (
            run_candidates_parallel,
            run_crack_parallel,
        )

        with CandidateWriter(hex_unsafe=args.hex_unsafe) as writer:
            if crack:
                def on_hit(dig_hex: str, cand: bytes) -> None:
                    writer.write_block(potfile_line(dig_hex, cand), 1)
                    writer.flush()

                n_hits = run_crack_parallel(
                    words, sub_map,
                    _read_digests(args.digests, args.algo), args.algo,
                    on_hit, n_workers=args.threads, **iter_kw,
                )
            else:
                run_candidates_parallel(
                    words, sub_map, writer, n_workers=args.threads,
                    hex_unsafe=args.hex_unsafe, **iter_kw,
                )
        if crack:
            print(f"{n_hits} hits", file=sys.stderr)
        return 0
    native_eng = _native_default_engine(args, sub_map, mode, crack)
    if native_eng is not None:
        # Engines A, C and D (default / substitute-all / suball-reverse)
        # stream from the C++ oracle: the same byte stream, an order of
        # magnitude more lines/s than the Python engines (PERF.md §6).
        stream = {
            "suball": native_eng.stream_word_suball,
            "suball-reverse": native_eng.stream_word_suball_reverse,
        }.get(mode, native_eng.stream_word)
        with CandidateWriter(hex_unsafe=args.hex_unsafe) as writer:
            for word in words:
                stream(
                    word, args.table_min, args.table_max,
                    lambda b: writer.write_block(b, b.count(b"\n")),
                )
        return 0
    if crack:
        from .ops.membership import HostDigestLookup
        from .utils.digests import HOST_DIGEST

        digest_set = HostDigestLookup(_read_digests(args.digests, args.algo))
        host_digest = HOST_DIGEST[args.algo]
    # Crack mode iterates candidates (hash + membership per candidate);
    # generation dominates that loop, so the native engines feed it too
    # when the mode fits (output identical; only the iterator changes).
    crack_native = (
        _native_default_engine(args, sub_map, mode, crack=False,
                               hex_unsafe=False)
        if crack and mode in ("default", "suball", "suball-reverse")
        else None
    )

    def word_iter(word):
        if crack_native is not None:
            return crack_native.iter_word(
                word, args.table_min, args.table_max,
                substitute_all=mode.startswith("suball"),
                reverse=mode == "suball-reverse",
            )
        return iter_candidates(word, sub_map, **iter_kw)

    n_hits = 0
    with CandidateWriter(hex_unsafe=args.hex_unsafe) as writer:
        for word in words:
            for cand in word_iter(word):
                if crack:
                    dig = host_digest(cand)
                    if dig in digest_set:
                        n_hits += 1
                        writer.write_block(
                            potfile_line(dig.hex(), cand), 1
                        )
                        # Each hit lands at once (HitRecorder's per-hit
                        # flush).
                        writer.flush()
                else:
                    writer.emit(cand)
    if crack:
        print(f"{n_hits} hits", file=sys.stderr)
    return 0


class _DedupRecorder:
    """Hit recorder wrapper that drops (word, rank) duplicates.

    Used by the --retries loop: after an attempt dies mid-sweep, the next
    attempt's resume replays every checkpointed hit into its recorder —
    correct for a fresh process, duplicate output within one retrying
    process.  The wrapper spans attempts, so each hit prints once per
    process while a genuinely fresh resume still prints the full list."""

    def __init__(self, inner) -> None:
        self.inner = inner
        self._seen: set = set()

    def emit(self, record) -> None:
        key = (record.word_index, record.variant_rank)
        if key in self._seen:
            return
        self._seen.add(key)
        self.inner.emit(record)

    @property
    def hits(self):
        return self.inner.hits


def _print_superstep(res) -> None:
    """Superstep summary (stderr): supersteps run, launches per fetch,
    overflow re-runs, pair tier; and the per-launch pipeline's
    launches."""
    s = res.superstep
    if s.get("per_launch"):
        print(f"{PROG}: per-launch pipeline: {s['per_launch']} launches "
              "(blocks cut on the host)", file=sys.stderr)
    if not s.get("supersteps"):
        return
    pair = f", pair K={s['pair']}" if s.get("pair") else ""
    print(
        f"{PROG}: superstep: {s['supersteps']} supersteps x "
        f"{s.get('launches_per_fetch', 0)} launches/fetch "
        f"({s.get('replays', 0)} overflow replays{pair})",
        file=sys.stderr,
    )


def _mode(args) -> str:
    if args.substitute_all:
        return "suball-reverse" if args.reverse_sub else "suball"
    return "reverse" if args.reverse_sub else "default"


def _print_routing(res) -> None:
    """Word-routing summary (stderr): device-clean / cascade-closed /
    oracle-fallback counts; silent when every word is device-clean."""
    r = res.routing
    if not (r.get("device_closed") or r.get("oracle_fallback")):
        return
    print(
        f"{PROG}: word routing: {r.get('device_clean', 0)} device-clean, "
        f"{r.get('device_closed', 0)} device-closed, "
        f"{r.get('oracle_fallback', 0)} oracle-fallback",
        file=sys.stderr,
    )


_ROUTE_NAMES = {"piece": "the piece kernel",
                "bytescan": "the byte-scan kernels",
                "xla": "the XLA expand + hash route"}


def _print_routes(res) -> None:
    """Bucket-route summary (stderr): sweeps (buckets) on each route, and
    the XLA route's lanes per launch and memory budget."""
    if not res.routes:
        return
    parts = [f"{res.routes[k]} on {name}" for k, name in _ROUTE_NAMES.items()
             if res.routes.get(k)]
    line = f"{PROG}: bucket routes: " + ", ".join(parts)
    if res.xla:
        line += (f" ({res.xla['lanes']} lanes per XLA launch, "
                 f"{res.xla['rows']} XLA candidate rows, "
                 f"{res.xla['budget_bytes'] / (1 << 30):g} GiB budget)")
    print(line, file=sys.stderr)


def _print_geometry(res) -> None:
    """The resolved geometry's provenance on stderr, as the reference
    prints it: when the sweep filled the geometry (an autotune profile or
    the built-in defaults); silent for explicit flags."""
    src = getattr(res, "geometry_source", "explicit")
    g = getattr(res, "geometry", None) or {}
    if src == "explicit" or not g:
        return
    origin = (f"autotune profile ({g.get('device_kind')})"
              if src == "profile" else "built-in defaults")
    print(f"{PROG}: geometry: lanes={g.get('lanes')} "
          f"blocks={g.get('num_blocks')} superstep={g.get('superstep')} "
          f"pair={g.get('pair')} — from {origin}", file=sys.stderr)


def _print_stream(res) -> None:
    """Streaming summary (stderr): chunks swept, compile overlap, peak
    resident plan bytes, time to the first fetch; silent on the whole
    path."""
    s = res.stream
    if not s.get("chunks_swept"):
        return
    print(
        f"{PROG}: stream: {s['chunks_swept']}/{s.get('chunks', 0)} chunks "
        f"x {s.get('chunk_words', 0)} words, "
        f"{100.0 * s.get('overlap_ratio', 0.0):.0f}% compile overlapped, "
        f"peak plan {s.get('peak_resident_plan_bytes', 0) / 1e6:.1f} MB "
        f"(ttfc {s.get('ttfc_s', 0.0):.2f}s)",
        file=sys.stderr,
    )


def _print_kernels(res) -> None:
    """Kernel-tier summary (stderr): launches per tier, e.g. ``piece_k1``
    or the byte-scan tiers ``bytescan_scalar`` / ``bytescan_match`` /
    ``bytescan_suball`` (TPU kernel rows 7-9)."""
    if not res.kernels:
        return
    print(f"{PROG}: kernels: " + ", ".join(
        f"{k} {v} launches" for k, v in sorted(res.kernels.items())),
        file=sys.stderr)


def _run_with_retries(make_attempt, retries: int, *, default_resume: bool,
                      label: str, retry_notice: str = ""):
    """Recovery from a lost sweep: candidate generation is pure and
    cursors are durable, so a transient error is survived by rebuilding
    the sweep (fresh device buffers) and resuming from the last
    checkpoint.  A real CUDA fault poisons this process's context, so
    every attempt fails the same way; a fresh process resumes it.
    ``make_attempt(resume)`` runs one attempt; the first honours
    ``default_resume`` (--no-resume), later ones always resume."""
    import time

    attempt = 0
    resume = default_resume
    while True:
        try:
            return make_attempt(resume)
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception as e:  # noqa: BLE001 — a device loss is not typed
            attempt += 1
            if attempt > retries:
                raise
            print(
                f"{PROG}: {label} attempt failed "
                f"({type(e).__name__}: {e}); retry {attempt}/{retries} "
                f"from last checkpoint{retry_notice}",
                file=sys.stderr,
            )
            resume = True  # later attempts always resume
            time.sleep(min(2.0 * attempt, 10.0))


def _maybe_exit_pod_local(args, nprocs: int) -> None:
    """``--pod-hits local`` promises that a dead peer never blocks a
    survivor, so no closing barrier runs: ``multihost.pod_local_done_exit``
    (process 0 stays as the store's host until every peer is done or
    dead) leaves through ``os._exit``."""
    if nprocs > 1 and args.pod_hits == "local" and not args.profile:
        from .parallel.multihost import pod_local_done_exit

        pod_local_done_exit()


def _die_peer_loss(e) -> None:
    """A peer died while this process waited in a collective: say so and
    how to recover, then leave through ``os._exit(3)`` (the stuck
    collective's thread cannot be joined).  This process's stripe
    checkpoint is on disk already."""
    import os

    print(f"{PROG}: FATAL: {e}", file=sys.stderr)
    print(f"{PROG}: recovery: relaunch the pod (same command on every "
          "host); each host resumes its own stripe from --checkpoint and "
          "already-reported hits are deduped", file=sys.stderr)
    sys.stderr.flush()
    sys.stdout.flush()
    os._exit(3)


def _write_metrics_json(path, sweeps, res, *, pod_gather: bool = False
                        ) -> None:
    """``--metrics-json``: the process-wide telemetry registry snapshot
    and each built sweep's span summary (a bucketed sweep reports one per
    width), written after the sweep through the atomic writer — the
    reference's document ``{"metrics", "spans"}``.  The run's time to
    the first fetch and a streamed run's stream stats are gauges of the
    registry (``sweep.ttfc_s``, ``stream.<stat>``).  ``pod_gather``: a
    gathered pod all-gathers every process's snapshot through
    ``telemetry.merge`` and marks the document ``pod_merged`` (every
    process takes part; the pod builds its sweeps inside, so ``spans``
    is empty)."""
    if not path:
        return
    import json

    from .runtime import telemetry
    from .runtime.checkpoint import atomic_write_text

    if telemetry.enabled():
        telemetry.gauge("sweep.ttfc_s").set(res.ttfc_s)
        for k in ("ttfc_s", "compile_overlap_s", "overlap_ratio",
                  "steady_overlap_ratio", "first_chunk_compile_s",
                  "peak_resident_plan_bytes", "chunk_bytes_max",
                  "chunks_swept"):
            if k in res.stream:
                telemetry.gauge(f"stream.{k}").set(res.stream[k])

    spans = {}
    for obj in sweeps:
        inner = getattr(obj, "sweeps", None)
        if inner is not None:  # BucketedSweep: per-width timelines
            for width, s in inner.items():
                spans[f"w{width}"] = s.timeline.summary()
        else:
            spans["sweep"] = obj.timeline.summary()
    if pod_gather:
        from .parallel.multihost import allgather_metrics

        doc = {"metrics": allgather_metrics(), "spans": spans,
               "pod_merged": True}
    else:
        doc = {"metrics": telemetry.snapshot(), "spans": spans}
    atomic_write_text(path, json.dumps(doc, indent=2) + "\n")


def _run_device(args, sub_map, packed) -> int:
    """``packed`` is a PackedWords batch or a ``{width: PackedWords}``
    bucket dict."""
    from .models.attack import AttackSpec

    spec = AttackSpec(mode=_mode(args), algo=args.algo,
                      min_substitute=args.table_min,
                      max_substitute=args.table_max)
    # The pod comes up first: the rendezvous before any device work.
    pid, nprocs = 0, 1
    if (args.coordinator is not None or args.num_processes is not None
            or args.process_id is not None):
        from .parallel import multihost

        pid, nprocs = multihost.initialize(
            args.coordinator, args.num_processes, args.process_id)
        print(f"{PROG}: distributed process {pid}/{nprocs}",
              file=sys.stderr)
        if nprocs > 1 and args.retries:
            # A lone retrying process would desync the pod's
            # collectives; the pod's recovery is a relaunch.
            print(f"{PROG}: warning: --retries is single-process only; "
                  "ignored under --coordinator (relaunch the pod to "
                  "resume)", file=sys.stderr)
            args.retries = 0
    if nprocs == 1:
        return _sweep_device(args, sub_map, packed, spec, pid, nprocs)
    # A pod that ends normally leaves it (F8): process 0 waits for its
    # peers' done marks, then every process stops its heartbeat and
    # destroys its process group; a run that failed does not wait.
    from .parallel.multihost import shutdown

    ended = False
    try:
        rc = _sweep_device(args, sub_map, packed, spec, pid, nprocs)
        ended = True
        return rc
    finally:
        shutdown(wait_peers=ended)


def _sweep_device(args, sub_map, packed, spec, pid: int, nprocs: int
                  ) -> int:
    """The device backend's sweep, this process's part of a pod when
    ``nprocs > 1``."""
    from .runtime.bucketed import BucketedSweep
    from .runtime.progress import ProgressReporter
    from .runtime.sinks import CandidateWriter, HitRecorder
    from .runtime.sweep import Sweep, SweepConfig
    from .runtime.telemetry import profiler_trace

    bucketed = isinstance(packed, dict)
    if nprocs > 1 and not args.giant_job:
        from .parallel.multihost import stripe_n_words

        n_words = stripe_n_words(packed, nprocs, pid)
    else:
        n_words = (sum(p.batch for p in packed.values()) if bucketed
                   else packed.batch)
    cfg_kw = {}
    if args.fetch_chunk is not None:
        cfg_kw["fetch_chunk"] = args.fetch_chunk
    cfg = SweepConfig(
        device=args.device, lanes=args.lanes, num_blocks=args.blocks,
        devices=args.devices, superstep=args.superstep,
        pair={"auto": None, "on": "on", "off": 0}[args.pair],
        packed_blocks={"auto": None, "packed": True, "stride": False}[
            args.block_layout],
        stream_chunk_words=args.stream_chunk_words,
        schema_cache=args.schema_cache,
        schema_cache_max_mb=args.schema_cache_max_mb,
        fetch_timeout_s=args.fetch_timeout,
        checkpoint_path=args.checkpoint,
        checkpoint_every_s=args.checkpoint_every,
        progress=ProgressReporter(n_words) if args.progress else None,
        **cfg_kw,
    )
    crack = args.digests is not None
    digests = _read_digests(args.digests, args.algo) if crack else ()
    gather = args.pod_hits == "gathered"
    built: list = []

    def make_sweep():
        sweep = (BucketedSweep if bucketed else Sweep)(
            spec, sub_map, packed, digests, config=cfg)
        built.append(sweep)
        return sweep

    with profiler_trace(args.profile):
        if crack:
            if nprocs > 1:
                from .parallel.multihost import (
                    PeerLossError,
                    run_crack_giant,
                    run_crack_multihost,
                )

                # Gathered: process 0 prints the combined stream; local:
                # every process prints its own stripe's hits.
                recorder = (HitRecorder(sys.stdout.buffer)
                            if pid == 0 or not gather else None)
                runner = (run_crack_giant if args.giant_job
                          else run_crack_multihost)
                try:
                    res = runner(spec, sub_map, packed, digests, cfg,
                                 recorder=recorder,
                                 resume=not args.no_resume, gather=gather)
                except PeerLossError as e:
                    _die_peer_loss(e)
            else:
                recorder = _DedupRecorder(HitRecorder(sys.stdout.buffer))
                res = _run_with_retries(
                    lambda resume: make_sweep().run_crack(recorder,
                                                          resume=resume),
                    args.retries, default_resume=not args.no_resume,
                    label="crack sweep",
                )
            if nprocs > 1 and not gather:
                print(f"{PROG}: process {pid}/{nprocs} stripe: "
                      f"{res.n_hits} hits, {res.n_emitted} candidates "
                      "hashed", file=sys.stderr)
            elif pid == 0:
                print(f"{res.n_hits} hits, {res.n_emitted} candidates "
                      "hashed", file=sys.stderr)
            what = ("superstep drive" if res.superstep.get("supersteps")
                    or not res.superstep.get("per_launch")
                    else "per-launch drive")
            unit = "candidate-hashes/s"
        else:
            with CandidateWriter(hex_unsafe=args.hex_unsafe) as writer:
                if nprocs > 1:
                    from .parallel.multihost import (
                        PeerLossError,
                        run_candidates_multihost,
                    )

                    # Each process writes its own stripe: concatenated in
                    # process order, the single-process stream.
                    try:
                        res = run_candidates_multihost(
                            spec, sub_map, packed, writer, cfg,
                            resume=not args.no_resume, gather=gather)
                    except PeerLossError as e:
                        _die_peer_loss(e)
                else:
                    res = _run_with_retries(
                        lambda resume: make_sweep().run_candidates(
                            writer, resume=resume),
                        args.retries, default_resume=not args.no_resume,
                        label="candidates sweep",
                        retry_notice=("; candidates since that checkpoint "
                                      "repeat (at-least-once stream)"),
                    )
            print(f"{res.n_emitted} candidates written", file=sys.stderr)
            what = "launch loop"
            unit = "candidates/s"
    _print_routing(res)
    if crack:
        _print_geometry(res)
    _print_routes(res)
    _print_kernels(res)
    _print_superstep(res)
    _print_stream(res)
    rate = res.n_emitted / res.drive_s if res.drive_s > 0 else 0.0
    print(f"{PROG}: sweep: {res.wall_s:.3f} s wall, {res.drive_s:.3f} s "
          f"{what}, {rate:.6g} {unit} (device {args.device})",
          file=sys.stderr)
    _write_metrics_json(args.metrics_json, built, res,
                        pod_gather=nprocs > 1 and gather)
    _maybe_exit_pod_local(args, nprocs)
    return 0


#: Flags of the device backend that the reference's oracle backend takes
#: and warns about: (dest, flag).
_ORACLE_NO_EFFECT = (
    ("checkpoint", "--checkpoint"), ("no_resume", "--no-resume"),
    ("progress", "--progress"), ("devices", "--devices"),
    ("profile", "--profile"), ("coordinator", "--coordinator"),
    ("num_processes", "--num-processes"), ("process_id", "--process-id"),
    ("giant_job", "--giant-job"), ("retries", "--retries"),
)


def _warn_oracle_flags(args) -> None:
    """The reference's oracle backend warns about its stateless flags and
    runs on; the rest it ignores."""
    for dest, name in _ORACLE_NO_EFFECT:
        value = getattr(args, dest)
        if dest == "devices":
            value = value != 1
        elif dest in ("coordinator", "num_processes", "process_id"):
            value = value is not None
        if value:
            print(f"{PROG}: warning: {name} has no effect with "
                  "--backend oracle (the oracle streams statelessly)",
                  file=sys.stderr)


def _build_serve_parser() -> argparse.ArgumentParser:
    """``a5gen serve``'s flags: the reference's, and ``--device``."""
    ap = argparse.ArgumentParser(
        prog=f"{PROG} serve",
        description=(
            "Resident engine service mode: serve many sweeps from one "
            "process. Jobs arrive as JSONL on stdin (or a unix socket), "
            "interleave at superstep boundaries on one device, and share "
            "step closures and the schema cache; events (hit/done/"
            "paused/...) stream back as JSONL on stdout."
        ),
    )
    ap.add_argument("--socket", metavar="PATH",
                    help="listen on a unix socket instead of stdin "
                         "(one JSONL session per connection, all "
                         "sharing the engine)")
    ap.add_argument("--engine-id", metavar="ID", default=None,
                    help="identity label on this engine's telemetry "
                         "series; default pid@host")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the jobs' sweeps run (default cuda; cpu "
                         "runs the plain PyTorch version of the kernels)")
    ap.add_argument("--lanes", type=int, default=None,
                    help="default hash lanes per launch for jobs that "
                         "don't override it (default: the device's "
                         "autotune profile, else the sweep CLI's: 2^22 "
                         "on cuda, 2^17 on cpu)")
    ap.add_argument("--blocks", type=int, default=None,
                    help="default blocks per launch (default: the "
                         "profile's, else lanes/128, or 1024 when 128 "
                         "does not divide the lanes)")
    ap.add_argument("--devices", type=_devices_arg, default=1, metavar="N",
                    help="default device count per job")
    ap.add_argument("--superstep", type=_superstep_arg, default=None,
                    metavar="N|auto|off", help="default superstep knob")
    ap.add_argument("--pair", choices=("auto", "on", "off"),
                    default="auto", help="default pair-lane knob")
    ap.add_argument("--stream-chunk-words", type=_stream_chunk_arg,
                    default="auto", metavar="N|auto|off",
                    help="default streaming-ingestion knob")
    ap.add_argument("--schema-cache", metavar="DIR",
                    help="on-disk PieceSchema cache shared by every job")
    ap.add_argument("--schema-cache-max-mb", type=float, default=None,
                    metavar="MB",
                    help="size cap on the schema cache (default "
                         "unbounded)")
    ap.add_argument("--max-word-bytes", type=int, default=64 * 1024,
                    help="reject job dictionary lines longer than this")
    ap.add_argument("--client-timeout", type=float, default=None,
                    metavar="SECONDS",
                    help="--socket only: close a connection whose client "
                         "has sent nothing for SECONDS while no events "
                         "flowed out either; its jobs keep running and a "
                         "reconnecting session can pause/cancel/resume "
                         "them by id. Default off")
    ap.add_argument("--pack", choices=("auto", "on", "off"),
                    default="auto",
                    help="cross-job packed superstep dispatch: fuse "
                         "compatible tenants' block ranges into one "
                         "dispatch. auto = on unless A5GEN_PACK=off; "
                         "off = per-job dispatch")
    ap.add_argument("--admission-worker", choices=("on", "off"),
                    default="on",
                    help="build admitted jobs' plans on a worker thread "
                         "instead of the serve round; off = synchronous "
                         "admission")
    return ap


def _run_serve(argv: Sequence[str]) -> int:
    """``a5gen serve``: one resident engine, jobs over JSONL."""
    args = _build_serve_parser().parse_args(argv)
    from .runtime import telemetry
    from .runtime.engine import Engine, serve_socket, serve_stdio
    from .runtime.sweep import SweepConfig, resolve_device

    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"{PROG}: error: {e}", file=sys.stderr)
        return 2
    # Serve mode always runs labeled: a merged scrape of several engines
    # must tell them apart, and a lone engine's label is harmless.
    telemetry.set_engine_id(args.engine_id or telemetry.default_engine_id())
    # The engine's defaults are concrete (affinity tokens and the stats'
    # config_defaults hash them), so serve resolves the geometry at
    # startup: explicit flag > the device's autotune profile > built-ins
    # (the lanes / blocks knobs only; per-job superstep / pair stay with
    # the job docs).
    if args.lanes is None or args.blocks is None:
        from .runtime.tune import current_device_kind, resolve_config

        kind = current_device_kind(dev)
        # lanes=None engages the resolution even when --lanes was given;
        # the per-knob merge keeps any explicit flag.
        resolved, source = resolve_config(
            SweepConfig(device=args.device, lanes=None,
                        num_blocks=args.blocks), kind)
        # With --lanes given and no profile, --blocks stays to the auto
        # rule below, as before profiles existed.
        if args.blocks is None and (args.lanes is None
                                    or source == "profile"):
            args.blocks = resolved.num_blocks
        if args.lanes is None:
            args.lanes = resolved.lanes
        if source == "profile":
            print(f"{PROG}: geometry defaults from autotune profile "
                  f"({kind}): lanes={args.lanes} blocks={args.blocks}",
                  file=sys.stderr)
    # Blocks left to the auto rule (a GPU without a profile): the
    # sweep's lanes/128, or 1024 when 128 does not divide the lanes.
    lanes, blocks, _ = SweepConfig(device=args.device, lanes=args.lanes,
                                   num_blocks=args.blocks).resolve(dev)
    defaults = SweepConfig(
        device=args.device,
        lanes=lanes,
        num_blocks=blocks,
        devices=args.devices,
        superstep=args.superstep,
        pair={"auto": None, "on": "on", "off": 0}[args.pair],
        stream_chunk_words=args.stream_chunk_words,
        schema_cache=args.schema_cache,
        schema_cache_max_mb=args.schema_cache_max_mb,
    )
    engine = Engine(
        defaults,
        pack={"auto": None, "on": True, "off": False}[args.pack],
        admission_worker=args.admission_worker == "on",
    )
    print(f"{PROG}: serving on "
          f"{args.socket or 'stdin'} (JSONL; op=shutdown or EOF ends)",
          file=sys.stderr)
    try:
        if args.socket:
            serve_socket(engine, args.socket,
                         max_word_bytes=args.max_word_bytes,
                         client_timeout=args.client_timeout)
        else:
            serve_stdio(engine, sys.stdin, sys.stdout,
                        max_word_bytes=args.max_word_bytes)
    finally:
        engine.close()
        # The jobs are settled; their event pumps write the last hits and
        # the settling events before the process exits.
        import threading

        for th in threading.enumerate():
            if th.name.startswith("a5-serve-pump-"):
                th.join(30)
    return 0


def _build_fleet_parser() -> argparse.ArgumentParser:
    """``a5gen fleet``'s flags: the reference's, and ``--device``."""
    ap = argparse.ArgumentParser(
        prog=f"{PROG} fleet",
        description=(
            "Fleet mode: a front-end router over a pool of engine "
            "processes.  Speaks the same JSONL serve protocol upstream "
            "(submit/pause/resume/cancel/stats/metrics/shutdown pass "
            "through; drain/migrate/split added), places jobs by "
            "static-config affinity to maximize fuse/compile reuse, "
            "rebalances via pause→checkpoint→resubmit, and survives "
            "engine death by crash-replaying routed jobs from their last "
            "router-held checkpoints with exactly-once hit redelivery."
        ),
    )
    ap.add_argument("--engines", required=True, metavar="N|SOCK,...",
                    help="an integer spawns N local engine processes "
                         "(sharing this command's geometry flags, "
                         "--device and one schema cache); a "
                         "comma-separated list of unix-socket paths "
                         "attaches to engines already running")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="spawn mode: where the spawned engines run "
                         "(default cuda; cpu runs the plain PyTorch "
                         "version of the kernels); the router itself "
                         "touches no device")
    ap.add_argument("--socket", metavar="PATH",
                    help="listen for clients on a unix socket instead "
                         "of stdin")
    ap.add_argument("--place", choices=("affinity", "round-robin"),
                    default="affinity",
                    help="job placement: static-config affinity "
                         "(default; co-locate compatible jobs for "
                         "fuse/compile reuse) or round-robin (the "
                         "control arm)")
    ap.add_argument("--poll", type=float, default=2.0, metavar="S",
                    help="engine health-scrape cadence (stats op + "
                         "liveness; 0 disables)")
    ap.add_argument("--replay-budget", type=int, default=1, metavar="N",
                    help="checkpoint-bearing engine failures "
                         "(quarantine) are resubmitted to another "
                         "engine up to N times per job")
    ap.add_argument("--split", choices=("auto", "on", "off"),
                    default=None,
                    help="giant-job striping: scatter one oversized "
                         "crack job across every free engine as "
                         "disjoint rank-stride shard ranges and merge "
                         "the hit streams back into one (word,rank)-"
                         "ordered client stream (auto: only jobs with "
                         "at least --split-threshold words; on: any "
                         "crack job when 2+ engines are free; off: "
                         "never; default: $A5GEN_SPLIT or auto)")
    ap.add_argument("--split-threshold", type=int, default=4096,
                    metavar="N",
                    help="auto split mode: minimum wordlist size (in "
                         "words) before a submit is scattered")
    ap.add_argument("--autoscale", metavar="MIN:MAX", default=None,
                    help="enable the autoscaler (spawn mode only): "
                         "keep between MIN and MAX engines, spawning "
                         "on sustained backlog and draining+reaping "
                         "idle or quarantined ones (--engines N is "
                         "the initial size, clamped into [MIN,MAX])")
    ap.add_argument("--scale-up-at", type=float, default=2.0,
                    metavar="F",
                    help="autoscale: backlog per engine (routed + "
                         "queued + building + router-pending) that, "
                         "sustained over the hysteresis window, "
                         "spawns an engine")
    ap.add_argument("--scale-down-at", type=float, default=0.25,
                    metavar="F",
                    help="autoscale: backlog per engine below which "
                         "(sustained) the idlest engine drains and "
                         "reaps")
    ap.add_argument("--scale-window", type=int, default=2, metavar="N",
                    help="autoscale hysteresis: consecutive "
                         "observations over/under threshold before "
                         "acting (scale-down uses 2N)")
    ap.add_argument("--scale-cooldown", type=float, default=10.0,
                    metavar="S",
                    help="autoscale: seconds between scale actions "
                         "(failed spawns retry after this too)")
    ap.add_argument("--engine-capacity", type=int, default=32,
                    metavar="N",
                    help="admission control: routed jobs one engine "
                         "accepts before new submits queue on the "
                         "router (0 = unbounded)")
    ap.add_argument("--max-pending", type=int, default=256, metavar="N",
                    help="admission control: the BOUNDED router-side "
                         "pending queue; past it, submits are "
                         "rejected typed ({\"error\": \"overloaded\", "
                         "\"retry_after_s\": ...}) per --shed-policy")
    ap.add_argument("--per-tenant", type=int, default=0, metavar="N",
                    help="admission control: max unsettled jobs per "
                         "submit-doc 'tenant' (0 = off; docs without "
                         "a tenant are exempt)")
    ap.add_argument("--shed-policy",
                    choices=("reject", "queue", "oldest"),
                    default="reject",
                    help="what a full pending queue does to a new "
                         "submit: reject it typed (default), shed the "
                         "oldest pending job (deadline-carrying jobs "
                         "first) to admit it, or queue unboundedly")
    ap.add_argument("--engine-dir", metavar="DIR", default=None,
                    help="spawn mode: directory for engine sockets "
                         "(default: a temp dir)")
    # Spawn-mode engine flags (as `a5gen serve` takes them); they also
    # seed the router's affinity-token defaults in both modes.
    ap.add_argument("--lanes", type=int, default=None)
    ap.add_argument("--blocks", type=int, default=None)
    ap.add_argument("--superstep", type=_superstep_arg, default=None,
                    metavar="N|auto|off")
    ap.add_argument("--pair", choices=("auto", "on", "off"),
                    default="auto")
    ap.add_argument("--schema-cache", metavar="DIR", default=None,
                    help="one on-disk PieceSchema cache directory shared "
                         "by every spawned engine, so each plan x table "
                         "compiles once fleet-wide (spawn mode default: "
                         "a shared temp dir)")
    ap.add_argument("--schema-cache-max-mb", type=float, default=None,
                    metavar="MB")
    return ap


def _run_fleet(argv: Sequence[str]) -> int:
    """``a5gen fleet``: router + engine pool, serve protocol upstream.
    The router process imports no torch: it is JSON, sockets and
    tables."""
    import os
    import tempfile
    from types import SimpleNamespace

    ap = _build_fleet_parser()
    args = ap.parse_args(argv)
    scale_cfg = None
    if args.autoscale is not None:
        if not args.engines.isdigit():
            raise SystemExit(
                f"{PROG}: --autoscale needs spawn mode (--engines N); "
                "attached engines' lifetimes belong to their owners")
        lo, _, hi = args.autoscale.partition(":")
        try:
            bounds = (int(lo), int(hi))
        except ValueError:
            raise SystemExit(
                f"{PROG}: --autoscale wants MIN:MAX integers, got "
                f"{args.autoscale!r}") from None
        from .runtime.autoscale import AutoscaleConfig

        # The whole elastic config is validated before any engine
        # spawns: a bad bound or threshold pair fails the command
        # cleanly.
        try:
            scale_cfg = AutoscaleConfig(
                min_engines=bounds[0],
                max_engines=bounds[1],
                scale_up_at=args.scale_up_at,
                scale_down_at=args.scale_down_at,
                up_window=args.scale_window,
                down_window=2 * args.scale_window,
                cooldown_s=args.scale_cooldown,
                interval_s=max(args.poll, 0.5) if args.poll > 0 else 1.0,
            )
        except ValueError as exc:
            raise SystemExit(f"{PROG}: --autoscale: {exc}") from None
    from .runtime.fleet import (
        FleetError,
        FleetRouter,
        serve_fleet_socket,
        serve_fleet_stdio,
        spawn_engines,
    )

    # The engines' static config as far as this command knows it (the
    # fields of SweepConfig the affinity token reads); scraped engine
    # defaults take precedence in the router.
    pair = {"auto": None, "on": "on", "off": 0}[args.pair]
    defaults = SimpleNamespace(lanes=args.lanes, num_blocks=args.blocks,
                               superstep=args.superstep, devices=1,
                               pair=pair)
    router = FleetRouter(place=args.place, poll_s=args.poll,
                         replay_budget=args.replay_budget,
                         defaults=defaults,
                         engine_capacity=args.engine_capacity,
                         max_pending=args.max_pending,
                         per_tenant=args.per_tenant,
                         shed_policy=args.shed_policy,
                         split=args.split,
                         split_threshold=args.split_threshold)
    spawned = False
    try:
        try:
            if args.engines.isdigit():
                spawned = True
                eng_dir = args.engine_dir or tempfile.mkdtemp(
                    prefix="a5-fleet-")
                cache = args.schema_cache or os.path.join(
                    eng_dir, "schema-cache")
                eng_args = ["--device", args.device, "--schema-cache",
                            cache]
                if args.lanes is not None:
                    eng_args += ["--lanes", str(args.lanes)]
                if args.blocks is not None:
                    eng_args += ["--blocks", str(args.blocks)]
                if args.superstep is not None:
                    eng_args += ["--superstep",
                                 "off" if args.superstep == 0
                                 else str(args.superstep)]
                if args.pair != "auto":
                    eng_args += ["--pair", args.pair]
                if args.schema_cache_max_mb is not None:
                    eng_args += ["--schema-cache-max-mb",
                                 str(args.schema_cache_max_mb)]
                n0 = int(args.engines)
                if scale_cfg is not None:
                    n0 = max(scale_cfg.min_engines,
                             min(n0, scale_cfg.max_engines))
                specs = spawn_engines(n0, eng_dir, engine_args=eng_args)
                for sock_path, eid, proc in specs:
                    router.attach(sock_path, eid, proc=proc)
                if scale_cfg is not None:
                    import itertools

                    from .runtime.autoscale import Autoscaler

                    counter = itertools.count(n0)

                    def spawn_one():
                        (spec,) = spawn_engines(
                            1, eng_dir, engine_args=eng_args,
                            start_index=next(counter))
                        return spec

                    # Binds itself as router.autoscaler; the router's
                    # close() stops it.
                    Autoscaler(router, spawn_one, scale_cfg)
            else:
                for ep in args.engines.split(","):
                    ep = ep.strip()
                    if ep:
                        router.attach(ep)
        except FleetError as e:
            print(f"{PROG}: error: {e}", file=sys.stderr)
            return 2
        elastic = (f", elastic {scale_cfg.min_engines}:"
                   f"{scale_cfg.max_engines}" if scale_cfg is not None
                   else "")
        print(f"{PROG}: fleet of {len(router.engines())} engine(s)"
              f"{elastic}, routing on {args.socket or 'stdin'} (JSONL; "
              "op=shutdown ends)", file=sys.stderr)
        if args.socket:
            serve_fleet_socket(router, args.socket)
        else:
            serve_fleet_stdio(router, sys.stdin, sys.stdout)
    finally:
        # Spawn mode owns its engines' lifetimes; attach mode leaves
        # them serving for their other clients.
        router.close(shutdown_engines=spawned)
    return 0


def _build_tune_parser() -> argparse.ArgumentParser:
    """``a5gen tune``'s flags: the reference's, and ``--device``."""
    ap = argparse.ArgumentParser(
        prog=f"{PROG} tune",
        description=(
            "Geometry autotuner: sweep lanes x stride (block batch) x "
            "superstep depth x pair x emit arm over a synthetic crack "
            "contract on the device, assert per-arm stream parity, and "
            "write the winner as this device kind's profile "
            "(~/.cache/a5gen/tune/<device_kind>.json; A5GEN_TUNE_PROFILE "
            "overrides the directory or disables loading). Sweeps and "
            "serve with no explicit --lanes then load the profile by "
            "default."
        ),
    )
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the arms run (default cuda; without a GPU "
                         "the command fails instead of tuning the CPU; "
                         "cpu tunes the plain PyTorch version)")
    ap.add_argument("--words", type=int, default=512, metavar="N",
                    help="synthetic tune-contract dictionary size "
                         "(deterministic; default 512)")
    ap.add_argument("--seconds", type=float, default=1.0, metavar="S",
                    help="timed wall per arm after the warm-up sweep "
                         "(default 1.0)")
    ap.add_argument("--smoke", action="store_true",
                    help="the 2x2 matrix (lanes x stride only): seconds "
                         "on the CPU")
    ap.add_argument("--state", metavar="FILE",
                    help="partial-matrix resume state: each completed "
                         "arm's record is written atomically, and a rerun "
                         "skips past completed arms")
    ap.add_argument("--profile-dir", metavar="DIR", default=None,
                    help="write the profile under DIR instead of the "
                         "A5GEN_TUNE_PROFILE / ~/.cache default")
    ap.add_argument("--no-write", action="store_true",
                    help="measure and report only; do not persist a "
                         "profile")
    ap.add_argument("--json", action="store_true",
                    help="print the full result document as JSON on "
                         "stdout (arm records included) instead of the "
                         "summary")
    return ap


def _run_tune(argv: Sequence[str]) -> int:
    """``a5gen tune``: run the autotune matrix and persist the winner."""
    import json

    args = _build_tune_parser().parse_args(argv)
    from .runtime.tune import TuneProfileCorrupt, run_autotune

    def on_arm(rec) -> None:
        note = " (resumed)" if rec.get("resumed") else ""
        print(f"{PROG}: tune: {rec['arm']}: "
              f"{rec['hashes_per_s']:.3e} hashes/s "
              f"({rec['sweeps']} sweeps x {rec['emitted_per_sweep']} "
              f"candidates){note}", file=sys.stderr)

    try:
        result = run_autotune(
            words=args.words,
            seconds=args.seconds,
            smoke=args.smoke,
            state_path=args.state,
            on_arm=on_arm,
            write=not args.no_write,
            directory=args.profile_dir,
            device=args.device,
        )
    except (TuneProfileCorrupt, RuntimeError, ValueError) as exc:
        print(f"{PROG}: tune failed: {exc}", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(result, indent=2, sort_keys=True))
    else:
        g = result["geometry"]
        print(f"{PROG}: tune winner on {result['device_kind']}: "
              f"{result['winner']} — lanes={g['lanes']} "
              f"blocks={g['num_blocks']} stride={g.get('stride')} "
              f"superstep={g.get('superstep')} pair={g.get('pair')} "
              f"at {result['hashes_per_s']:.3e} hashes/s", file=sys.stderr)
        if result.get("profile_path"):
            print(f"{PROG}: profile written: {result['profile_path']} "
                  "(loaded by default for sweeps with no explicit "
                  "--lanes; A5GEN_TUNE_PROFILE=off disables)",
                  file=sys.stderr)
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "serve":
        return _run_serve(argv[1:])
    if argv and argv[0] == "fleet":
        return _run_fleet(argv[1:])
    if argv and argv[0] == "tune":
        return _run_tune(argv[1:])
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.list_layouts:
        return _run_list_layouts()
    if args.emit_table:
        try:
            return _run_emit_table(args)
        except KeyError as e:
            ap.error(str(e.args[0]) if e.args else str(e))
    if not args.dict_file:
        ap.error("dict_file is required (or use --emit-table)")
    if not args.table_files:
        ap.error("at least one -t/--table-files is required")
    if args.table_min > args.table_max:
        ap.error(
            f"--table-min {args.table_min} > --table-max {args.table_max}"
        )
    if (
        args.retries
        and args.backend == "device"
        and args.digests is None
        and not args.checkpoint
    ):
        ap.error(
            "--retries in candidates mode requires --checkpoint (a retry "
            "without one would re-emit the whole candidate stream)"
        )
    if args.giant_job and args.digests is None:
        ap.error("--giant-job is crack mode only (requires --digests)")
    if args.backend == "device" and args.bug_compat:
        # The Q3 reverse-offset bug is reproduced only by the oracle
        # engines; the device plans emit corrected bytes.
        if args.reverse_sub and not args.substitute_all:
            print(
                f"{PROG}: warning: --bug-compat requires the oracle "
                "reverse engine (the device plan emits corrected offsets); "
                "routing this sweep through --backend oracle",
                file=sys.stderr,
            )
            args.backend = "oracle"
        else:
            print(
                f"{PROG}: warning: --bug-compat only affects reverse mode "
                "(-r without -s); it has no effect on this sweep",
                file=sys.stderr,
            )
    if args.backend == "oracle":
        _warn_oracle_flags(args)
    from .tables.parser import load_tables

    try:
        sub_map = load_tables(args.table_files)
    except OSError as e:
        raise SystemExit(f"{PROG}: cannot read table: {e}")
    if args.backend == "oracle":
        from .ops.packing import read_wordlist

        try:
            words = read_wordlist(
                args.dict_file, max_word_bytes=args.max_word_bytes
            )
            return _run_oracle(args, sub_map, words)
        except ValueError as e:
            raise SystemExit(f"{PROG}: {e}")
        except OSError as e:
            raise SystemExit(f"{PROG}: cannot read {args.dict_file}: {e}")
    # Device backend: the native scanner/packer reads the wordlist (its
    # numpy version when the library is unavailable or A5_NATIVE=0).
    from . import native
    from .runtime.checkpoint import CheckpointCorrupt

    try:
        if args.buckets == "auto":
            # Crack mode buckets by width (one launch geometry per
            # bucket); candidates mode keeps one global width, so the
            # stream keeps dictionary order, as in the reference.
            args.buckets = (16, 32, 64) if args.digests is not None else None
        if args.buckets is None:
            packed = native.read_packed(
                args.dict_file, max_word_bytes=args.max_word_bytes
            )
        else:
            packed = native.read_packed_buckets(
                args.dict_file, buckets=args.buckets,
                max_word_bytes=args.max_word_bytes,
            )
            if args.digests is None and sum(
                    1 for p in packed.values() if p.batch) > 1:
                print(f"{PROG}: notice: --buckets reorders a mixed-length "
                      "candidate stream bucket-major (per-word multisets "
                      "unchanged); pass --buckets none for strict "
                      "dictionary order", file=sys.stderr)
        return _run_device(args, sub_map, packed)
    except NotImplementedError as e:
        print(f"{PROG}: not ported: {e}", file=sys.stderr)
        return 2
    except CheckpointCorrupt as e:
        # The typed corrupt/truncated-checkpoint error: name the file and
        # the failure, and say what to do about it.
        raise SystemExit(
            f"{PROG}: {e}\n"
            f"{PROG}: remediation: delete (or restore from backup) the "
            "named checkpoint file, or rerun with --no-resume to start "
            "the sweep over"
        )
    except (ValueError, RuntimeError) as e:
        raise SystemExit(f"{PROG}: {e}")
    except OSError as e:
        raise SystemExit(f"{PROG}: cannot read {args.dict_file}: {e}")
