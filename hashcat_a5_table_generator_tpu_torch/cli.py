"""The command-line surface of the PyTorch/CUDA package: the device
backend's crack and candidates modes.

Same flags and output as the reference CLI for what this package runs::

  a5gen DICT_FILE -t TABLE [-t TABLE ...] [-m MIN] [-x MAX] [-s] [-r]
        --backend device [--algo md5|md4|sha1|ntlm --digests FILE]
        [--output FILE] [--hex-unsafe] [--device cuda|cpu]

Default, reverse (``-r``), substitute-all (``-s``) and substitute-all
reverse (``-s -r``) mode, one GPU.  Crack mode (``--digests``): every
hash, each bucket on the route the reference's gate picks — the piece
kernel, the byte-scan kernels (plans without a piece schema, or
``A5GEN_EMIT=bytescan``) or the XLA expand + hash route (plans the fused
kernels refuse, or ``A5GEN_PALLAS=off``); hits print to stdout as
``digest:plain`` potfile lines, bucket-major in the order found.
Candidates mode (no ``--digests``): every candidate, one line each, in
word order (one global width unless ``--buckets`` is given), to stdout or
``--output FILE`` (in the reference ``--output`` names ``--emit-table``'s
file, and candidates always go to stdout), ``--hex-unsafe`` wrapping
line-corrupting candidates in ``$HEX[]``.  The summary (word routing,
kernel tiers, bucket routes) goes to stderr.  ``--device`` defaults to
``cuda`` and never falls back to the CPU on its own.

Every other surface of the reference CLI is recognized and refused with
exit status 2 and a message naming the ROADMAP.md port-queue item that
carries it — it never runs a different path.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
from typing import List, Optional, Sequence

PROG = "a5gen"
DIGEST_BYTES = {"md5": 16, "md4": 16, "ntlm": 16, "sha1": 20}

#: ROADMAP.md port-queue items for the surfaces this package does not run.
_ITEMS = {
    5: "the oracle backend, --emit-table, --list-layouts and --bug-compat",
    6: "checkpoints, streaming and robustness",
    7: "multi-GPU",
    8: "the service layer",
    9: "tuning",
}

#: Refused flags: (flags, argparse kwargs, queue item).
_REFUSED = (
    (("--bug-compat",), dict(action="store_true"), 5),
    (("--emit-table",), dict(metavar="LAYOUT"), 5),
    (("--list-layouts",), dict(action="store_true"), 5),
    (("--checkpoint",), dict(metavar="FILE"), 6),
    (("--checkpoint-every",), dict(type=float, metavar="SECONDS"), 6),
    (("--retries",), dict(type=int, metavar="N"), 6),
    (("--fetch-timeout",), dict(type=float, metavar="SECONDS"), 6),
    (("--fetch-chunk",), dict(type=int, metavar="N"), 6),
    (("--stream-chunk-words",), dict(metavar="N|auto|off"), 6),
    (("--schema-cache",), dict(metavar="DIR"), 6),
    (("--schema-cache-max-mb",), dict(type=float, metavar="MB"), 6),
    (("--block-layout",), dict(choices=("auto", "packed", "stride")), 6),
    (("--progress",), dict(action="store_true"), 6),
    (("--profile", "--profile-dir"), dict(metavar="DIR"), 6),
    (("--metrics-json",), dict(metavar="FILE"), 6),
    (("--devices",), dict(metavar="N"), 7),
    (("--coordinator",), dict(metavar="HOST:PORT"), 7),
    (("--num-processes",), dict(type=int, metavar="N"), 7),
    (("--process-id",), dict(type=int, metavar="I"), 7),
    (("--giant-job",), dict(action="store_true"), 7),
    (("--pod-hits",), dict(choices=("gathered", "local")), 7),
)

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
                    help="oracle-backend parallelism; the device backend "
                         "ignores it")
    ap.add_argument("--backend", choices=("oracle", "device"),
                    default="oracle",
                    help="'device' runs the GPU sweep (the oracle backend "
                         "is not ported)")
    ap.add_argument("--algo", choices=sorted(DIGEST_BYTES), default="md5",
                    help="hash algorithm for --digests mode (default md5)")
    ap.add_argument("--digests", metavar="FILE",
                    help="hex digest list (one per line); crack mode: "
                         "print digest:plain hits instead of candidates")
    ap.add_argument("--output", metavar="FILE",
                    help="candidates mode: write the candidate stream to "
                         "FILE instead of stdout")
    ap.add_argument("--hex-unsafe", action="store_true",
                    help="wrap line-corrupting candidates in $HEX[...]")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the sweep runs (default cuda; cpu runs "
                         "the plain PyTorch version of the kernels)")
    ap.add_argument("--lanes", type=int, default=None,
                    help="hash lanes per launch (default 2^22 on cuda, "
                         "2^17 on cpu)")
    ap.add_argument("--blocks", type=int, default=None,
                    help="blocks per launch (default lanes/128)")
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
    ap.add_argument("--no-resume", action="store_true",
                    help="accepted for compatibility; this package keeps "
                         "no checkpoints")
    for flags, kw, _item in _REFUSED:
        ap.add_argument(*flags, default=None if "action" not in kw
                        else False, help=argparse.SUPPRESS, **kw)
    return ap


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


class _DedupRecorder:
    """Hit recorder wrapper that drops (word, rank) duplicates, so each
    hit prints once per process."""

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


def _print_kernels(res) -> None:
    """Kernel-tier summary (stderr): launches per tier, e.g. ``piece_k1``
    or the byte-scan tiers ``bytescan_scalar`` / ``bytescan_match`` /
    ``bytescan_suball`` (TPU kernel rows 7-9)."""
    if not res.kernels:
        return
    print(f"{PROG}: kernels: " + ", ".join(
        f"{k} {v} launches" for k, v in sorted(res.kernels.items())),
        file=sys.stderr)


def _run_device(args, sub_map, packed) -> int:
    """``packed`` is a PackedWords batch or a ``{width: PackedWords}``
    bucket dict."""
    from .models.attack import AttackSpec
    from .runtime.bucketed import BucketedSweep
    from .runtime.sinks import CandidateWriter, HitRecorder
    from .runtime.sweep import Sweep, SweepConfig

    spec = AttackSpec(mode=_mode(args), algo=args.algo,
                      min_substitute=args.table_min,
                      max_substitute=args.table_max)
    cfg = SweepConfig(
        device=args.device, lanes=args.lanes, num_blocks=args.blocks,
        superstep=args.superstep,
        pair={"auto": None, "on": "on", "off": 0}[args.pair],
    )
    crack = args.digests is not None
    digests = _read_digests(args.digests, args.algo) if crack else ()
    sweep = (BucketedSweep if isinstance(packed, dict) else Sweep)(
        spec, sub_map, packed, digests, config=cfg
    )
    if crack:
        res = sweep.run_crack(_DedupRecorder(HitRecorder(sys.stdout.buffer)))
        print(f"{res.n_hits} hits, {res.n_emitted} candidates hashed",
              file=sys.stderr)
        what = ("superstep drive" if res.superstep.get("supersteps")
                or not res.superstep.get("per_launch")
                else "per-launch drive")
        unit = "candidate-hashes/s"
    else:
        with contextlib.ExitStack() as stack:
            stream = (stack.enter_context(open(args.output, "wb"))
                      if args.output else None)
            writer = stack.enter_context(
                CandidateWriter(stream, hex_unsafe=args.hex_unsafe))
            res = sweep.run_candidates(writer)
        print(f"{res.n_emitted} candidates written", file=sys.stderr)
        what = "launch loop"
        unit = "candidates/s"
    _print_routing(res)
    _print_routes(res)
    _print_kernels(res)
    _print_superstep(res)
    rate = res.n_emitted / res.drive_s if res.drive_s > 0 else 0.0
    print(f"{PROG}: sweep: {res.wall_s:.3f} s wall, {res.drive_s:.3f} s "
          f"{what}, {rate:.6g} {unit} (device {args.device})",
          file=sys.stderr)
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    ap = build_parser()
    if argv and argv[0] in _SUBCOMMANDS:
        ap.error(_not_ported(f"'{argv[0]}'", _SUBCOMMANDS[argv[0]]))
    args = ap.parse_args(argv)
    for flags, _kw, item in _REFUSED:
        dest = flags[-1].lstrip("-").replace("-", "_")
        if flags == ("--profile", "--profile-dir"):
            dest = "profile"
        if dest == "devices" and args.devices == "1":
            continue  # one GPU is this package's configuration
        if getattr(args, dest) not in (None, False):
            ap.error(_not_ported(flags[-1], item))
    if not args.dict_file:
        ap.error("dict_file is required")
    if not args.table_files:
        ap.error("at least one -t/--table-files is required")
    if args.table_min > args.table_max:
        ap.error(
            f"--table-min {args.table_min} > --table-max {args.table_max}"
        )
    if args.backend != "device":
        ap.error(_not_ported("--backend oracle", 5))
    if args.output and args.digests is not None:
        ap.error("--output names the candidate stream's file; crack mode "
                 "prints its hits to stdout")
    from .ops.packing import (
        aligned_width,
        pack_rows,
        read_packed_buckets,
        read_wordlist_lines,
    )
    from .tables.parser import load_tables

    try:
        sub_map = load_tables(args.table_files)
    except OSError as e:
        raise SystemExit(f"{PROG}: cannot read table: {e}")
    try:
        if args.buckets == "auto":
            # Crack mode buckets by width (one launch geometry per
            # bucket); candidates mode keeps one global width, so the
            # stream keeps dictionary order, as in the reference.
            args.buckets = (16, 32, 64) if args.digests is not None else None
        if args.buckets is None:
            with open(args.dict_file, "rb") as fh:
                buf, offsets, lengths = read_wordlist_lines(
                    fh.read(), max_word_bytes=args.max_word_bytes
                )
            packed = pack_rows(
                buf, offsets, lengths, None,
                aligned_width(int(lengths.max()) if len(lengths) else 0),
            )
        else:
            packed = read_packed_buckets(
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
    except (ValueError, RuntimeError) as e:
        raise SystemExit(f"{PROG}: {e}")
    except OSError as e:
        raise SystemExit(f"{PROG}: cannot read {args.dict_file}: {e}")
