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

The service layer (``serve``, ``fleet``: ROADMAP.md port-queue item 8)
and tuning (``tune``: item 9) exit 2 with a message naming their item —
they never run a different path.  Under ``--backend oracle`` the device
backend's flags do what the reference's do there: the stateless ones
warn that they have no effect, the rest are ignored.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional, Sequence

PROG = "a5gen"
DIGEST_BYTES = {"md5": 16, "md4": 16, "ntlm": 16, "sha1": 20}

#: ROADMAP.md port-queue items for the surfaces this package does not run.
_ITEMS = {
    8: "the service layer",
    9: "tuning",
}

_SUBCOMMANDS = {"serve": 8, "fleet": 8, "tune": 9}


def _not_ported(what: str, item: int) -> str:
    return (f"{what} is not ported to the PyTorch/CUDA package yet "
            f"(ROADMAP.md port queue item {item}: {_ITEMS[item]})")


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
    from .runtime.bucketed import BucketedSweep
    from .runtime.progress import ProgressReporter
    from .runtime.sinks import CandidateWriter, HitRecorder
    from .runtime.sweep import Sweep, SweepConfig
    from .runtime.telemetry import profiler_trace

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


def main(argv: Optional[Sequence[str]] = None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    ap = build_parser()
    if argv and argv[0] in _SUBCOMMANDS:
        ap.error(_not_ported(f"'{argv[0]}'", _SUBCOMMANDS[argv[0]]))
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
