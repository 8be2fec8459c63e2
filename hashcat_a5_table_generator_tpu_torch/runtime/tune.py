"""Autotuned launch geometry: per-device-kind profiles and the arm
matrix's run (the reference package's ``runtime/tune.py``, on torch
devices).

* ``a5gen tune`` sweeps a bounded matrix of lanes × stride (→ block
  batch) × superstep depth × pair × emit arm over a synthetic crack
  contract (:func:`run_autotune`), times each arm on the sweep's device,
  asserts per-arm stream parity (geometry never changes WHAT is
  emitted), and writes the winner as a profile.
* The profile lives at ``~/.cache/a5gen/tune/<device_kind>.json``
  (schema-versioned; written through ``checkpoint.atomic_write_text``).
  ``A5GEN_TUNE_PROFILE=off`` disables loading; any other non-empty value
  overrides the directory.  The device kind is
  ``torch.cuda.get_device_name`` of the sweep's own device, or ``cpu``.
* ``Sweep`` resolves geometry **explicit flag > loaded profile >
  built-in defaults** (:func:`resolve_config`): the CLI leaves
  ``SweepConfig.lanes=None`` when the user gave no flag, and the sweep
  fills the gaps once, before its first reader.  Explicit constructions
  (``lanes=`` set) never consult a profile.
* Corrupt or unknown-major profiles warn once and fall back to the
  built-in defaults (:class:`TuneProfileCorrupt`): a torn cache file
  never changes results or crashes a sweep.

The documents (profile, ``--state`` file) are the reference's: a profile
or a tune state written by either package is read by the other.  Top
level imports no torch: it is imported inside the measurement helpers.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import replace
from typing import (
    TYPE_CHECKING,
    Any,
    Callable,
    Dict,
    List,
    Optional,
    Sequence,
    Tuple,
)

if TYPE_CHECKING:
    from ..models.attack import AttackSpec
    from ..ops.packing import PackedWords
    from .sweep import SweepConfig

from .checkpoint import atomic_write_text
from .env import tune_profile_setting

#: Profile document schema version.  Major bumps are breaking (readers
#: reject via :class:`TuneProfileCorrupt`); minors are additive and
#: ignored by older readers.
TUNE_SCHEMA_VERSION = "1.0"

_TUNE_MAJOR = int(TUNE_SCHEMA_VERSION.split(".", 1)[0])

#: SweepConfig fields a profile may fill (explicit values always win).
#: ``emit`` is recorded in profiles but applied only via ``A5GEN_EMIT``
#: (a process-wide kernel-selection knob, not a per-sweep field).
PROFILE_KNOBS = ("lanes", "num_blocks", "superstep", "pair", "packed_blocks")

#: (path, reason) pairs already warned about: profile loading runs per
#: sweep construction, and one bad cache file must produce one
#: diagnostic, not one per job.
_WARNED: set = set()


class TuneProfileCorrupt(RuntimeError):
    """A tune profile exists but cannot be used (torn write, hand edit,
    or an unknown schema major).  Carries the path and the reason; the
    loader warns once and falls back to built-in defaults."""


# ----------------------------------------------------------------------
# Profile location + IO
# ----------------------------------------------------------------------


def profile_dir() -> Optional[str]:
    """Directory profiles live in, or None when loading is disabled."""
    setting = tune_profile_setting()
    if setting is None:
        return None
    return setting or os.path.join(
        os.path.expanduser("~"), ".cache", "a5gen", "tune"
    )


def device_slug(device_kind: str) -> str:
    """Filesystem-safe name for a device kind (``"NVIDIA H100 80GB
    HBM3"`` → ``"nvidia-h100-80gb-hbm3"``)."""
    slug = "".join(
        c if c.isalnum() else "-" for c in device_kind.strip().lower()
    ).strip("-")
    while "--" in slug:
        slug = slug.replace("--", "-")
    return slug or "unknown"


def profile_path(device_kind: str, directory: Optional[str] = None
                 ) -> Optional[str]:
    """Profile path for a device kind, or None when loading is off."""
    d = directory if directory is not None else profile_dir()
    if d is None:
        return None
    return os.path.join(d, f"{device_slug(device_kind)}.json")


def current_device_kind(device: Any = "cuda") -> str:
    """The device kind of ``device``: ``torch.cuda.get_device_name`` of
    that CUDA device (a device without a GPU raises), ``"cpu"`` for the
    CPU.  Reads the device's properties; allocates nothing on it."""
    import torch

    from .sweep import resolve_device

    dev = resolve_device(device)
    if dev.type == "cpu":
        return "cpu"
    return str(torch.cuda.get_device_name(dev))


def read_profile(path: str) -> Dict[str, Any]:
    """Parse + validate one profile document.  Raises
    :class:`TuneProfileCorrupt` on unparseable JSON, a non-object
    payload, a missing/unknown-major version, or malformed geometry."""
    try:
        with open(path, "r", encoding="utf-8") as fh:
            doc = json.load(fh)
    except FileNotFoundError:
        raise
    except (OSError, ValueError) as exc:
        raise TuneProfileCorrupt(f"{path}: unreadable profile: {exc}")
    if not isinstance(doc, dict):
        raise TuneProfileCorrupt(f"{path}: profile is not a JSON object")
    version = doc.get("version")
    try:
        major = int(str(version).split(".", 1)[0])
    except (TypeError, ValueError):
        raise TuneProfileCorrupt(
            f"{path}: missing/malformed profile version {version!r}"
        )
    if major != _TUNE_MAJOR:
        raise TuneProfileCorrupt(
            f"{path}: profile schema major {major} != supported "
            f"{_TUNE_MAJOR} (re-run `a5gen tune`)"
        )
    geom = doc.get("geometry")
    if not isinstance(geom, dict):
        raise TuneProfileCorrupt(f"{path}: profile has no geometry object")
    for knob in ("lanes", "num_blocks", "superstep"):
        v = geom.get(knob)
        if v is not None and (not isinstance(v, int) or v < 0):
            raise TuneProfileCorrupt(
                f"{path}: geometry.{knob}={v!r} is not a non-negative int"
            )
    if geom.get("lanes") in (0,):
        raise TuneProfileCorrupt(f"{path}: geometry.lanes must be positive")
    return doc


def load_profile(device_kind: str, directory: Optional[str] = None
                 ) -> Optional[Dict[str, Any]]:
    """The forgiving read the runtime uses: None when loading is
    disabled, no profile exists for this device kind, or the file is
    corrupt/unknown-major (warned once per path+reason; the built-in
    defaults carry on)."""
    path = profile_path(device_kind, directory)
    if path is None:
        return None
    try:
        return read_profile(path)
    except FileNotFoundError:
        return None
    except TuneProfileCorrupt as exc:
        key = (path, str(exc))
        if key not in _WARNED:
            _WARNED.add(key)
            import sys

            print(
                f"a5gen: warning: ignoring tune profile ({exc}); "
                "using built-in geometry defaults",
                file=sys.stderr,
            )
        return None


def write_profile(
    device_kind: str,
    geometry: Dict[str, Any],
    *,
    bench: Optional[Dict[str, Any]] = None,
    directory: Optional[str] = None,
) -> str:
    """Persist a profile atomically; returns the path written.  The
    directory default honors ``A5GEN_TUNE_PROFILE`` like the loader; an
    explicit ``directory`` always wins (``a5gen tune --profile-dir``)."""
    d = directory if directory is not None else profile_dir()
    if d is None:
        raise ValueError(
            "profile writing is disabled (A5GEN_TUNE_PROFILE=off); pass "
            "an explicit directory to write anyway"
        )
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"{device_slug(device_kind)}.json")
    doc = {
        "version": TUNE_SCHEMA_VERSION,
        "device_kind": device_kind,
        "written_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "geometry": {k: geometry.get(k) for k in PROFILE_KNOBS + ("emit",)},
        "bench": dict(bench or {}),
    }
    atomic_write_text(path, json.dumps(doc, indent=2, sort_keys=True) + "\n")
    return path


# ----------------------------------------------------------------------
# Geometry resolution: explicit flag > profile > built-in defaults
# ----------------------------------------------------------------------


def builtin_geometry(device_kind: str) -> Dict[str, Any]:
    """The sweep's built-in geometry: 2^22 lanes on a GPU, 2^17 on the
    CPU; the GPU's block count stays None (the sweep's auto rule:
    lanes/128, or 1024 when 128 does not divide the lanes), the CPU's is
    1024 (= 2^17/128, the auto rule's value at those lanes)."""
    on_cpu = device_kind.strip().lower() == "cpu"
    return {
        "lanes": (1 << 17) if on_cpu else (1 << 22),
        "num_blocks": 1024 if on_cpu else None,
    }


def resolve_config(
    cfg: "SweepConfig", device_kind: str, *,
    directory: Optional[str] = None,
) -> "Tuple[SweepConfig, str]":
    """Resolve a ``SweepConfig`` whose geometry was left to the runtime
    (``lanes=None``: the CLI's spelling for "no explicit flag").

    Returns ``(resolved_cfg, source)`` where ``source`` is ``explicit``
    (lanes was set: the config is untouched and no profile is
    consulted), ``profile`` (at least one knob came from a loaded
    profile), or ``default`` (built-in defaults filled the gaps).  Per
    knob, an explicit (non-None) value wins over the profile, and the
    profile over the built-ins."""
    if cfg.lanes is not None:
        return cfg, "explicit"
    prof = load_profile(device_kind, directory)
    geom = prof.get("geometry", {}) if prof else {}
    builtin = builtin_geometry(device_kind)
    updates: Dict[str, Any] = {}
    from_profile = False
    for knob in PROFILE_KNOBS:
        if getattr(cfg, knob) is not None:
            continue  # explicit per-knob value (or pinned off) wins
        if geom.get(knob) is not None:
            updates[knob] = geom[knob]
            from_profile = True
        elif builtin.get(knob) is not None:
            updates[knob] = builtin[knob]
    resolved = replace(cfg, **updates) if updates else cfg
    return resolved, ("profile" if from_profile else "default")


# ----------------------------------------------------------------------
# The autotune arm matrix (a5gen tune)
# ----------------------------------------------------------------------

#: The built-in tune contract: a deterministic synthetic wordlist +
#: substitution table shaped like a crack contract (hazard-free words, a
#: few planted digests so the hit path runs).
_TUNE_SUB_MAP = {
    b"a": [b"4", b"@"],
    b"e": [b"3"],
    b"i": [b"1", b"!"],
    b"o": [b"0"],
    b"s": [b"$", b"5"],
}


def tune_wordlist(n_words: int) -> List[bytes]:
    """Deterministic synthetic dictionary (no RNG: arms and repeat runs
    sweep the identical keyspace)."""
    stems = [b"password", b"dragons", b"sesame", b"oatmeal", b"passions",
             b"mistrals", b"isotope", b"leopards"]
    return [
        stems[i % len(stems)] + (b"%03d" % (i % 1000))
        for i in range(n_words)
    ]


def default_matrix(
    *,
    lanes: Optional[List[int]] = None,
    strides: Optional[List[int]] = None,
    supersteps: Optional[List[int]] = None,
    pairs: Optional[List[str]] = None,
    emits: Optional[List[str]] = None,
    smoke: bool = False,
) -> List[Dict[str, Any]]:
    """The bounded arm matrix: lanes × stride (block batch =
    lanes/stride) × superstep depth × pair × emit arm.  ``smoke`` is the
    2×2 (lanes × stride only) that finishes in seconds on the CPU; the
    full default is the reference's 36 arms."""
    if smoke:
        lanes = lanes or [1 << 10, 1 << 12]
        strides = strides or [64, 128]
        supersteps = supersteps or [None]
        pairs = pairs or ["auto"]
        emits = emits or [None]
    else:
        lanes = lanes or [1 << 17, 1 << 20, 1 << 22]
        strides = strides or [128, 256, 512]
        supersteps = supersteps or [8, 16]
        pairs = pairs or ["auto", "off"]
        emits = emits or [None]
    arms = []
    for ln in lanes:
        for st in strides:
            if ln % st:
                continue
            for ss in supersteps:
                for pr in pairs:
                    for em in emits:
                        name = f"lanes{ln}-stride{st}"
                        if ss is not None:
                            name += f"-ss{ss}"
                        if pr != "auto":
                            name += f"-pair_{pr}"
                        if em:
                            name += f"-{em}"
                        arms.append({
                            "name": name,
                            "lanes": ln,
                            "num_blocks": ln // st,
                            "stride": st,
                            "superstep": ss,
                            "pair": pr,
                            "emit": em,
                        })
    return arms


def _arm_config(
    arm: Dict[str, Any], base_kw: Dict[str, Any]
) -> "SweepConfig":
    from .sweep import SweepConfig

    return SweepConfig(
        lanes=int(arm["lanes"]),
        num_blocks=int(arm["num_blocks"]),
        superstep=arm.get("superstep"),
        pair={"auto": None, "on": "on", "off": 0}.get(
            arm.get("pair", "auto"), None
        ),
        **base_kw,
    )


def measure_arm(
    spec: "AttackSpec",
    sub_map: Dict[bytes, List[bytes]],
    packed: "PackedWords",
    digests: Sequence[bytes],
    arm: Dict[str, Any],
    *,
    seconds: float = 1.0,
    base_kw: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Time one arm on the sweep's device (``base_kw["device"]``): one
    untimed warm-up sweep (kernel loads, step closures), then whole
    sweeps until ``seconds`` of timed wall accumulates.  Returns the arm
    record; ``emitted_per_sweep`` is the per-arm parity check: every arm
    of a matrix must agree on it."""
    from .sweep import Sweep

    cfg = _arm_config(arm, dict(base_kw or {}))
    emit = arm.get("emit")
    # Save/restore, not a config read: the arm flips the process-wide
    # emit knob and must put back exactly what was there (unset too).
    old_emit = os.environ.get("A5GEN_EMIT")
    if emit:
        # The step cache keys on A5GEN_EMIT, so flipping it between arms
        # is safe within one process.
        os.environ["A5GEN_EMIT"] = emit
    try:
        res = Sweep(spec, sub_map, packed, digests, config=cfg).run_crack()
        emitted = int(res.n_emitted)
        n_hits = int(res.n_hits)
        sweeps = 0
        t0 = time.monotonic()
        deadline = t0 + max(0.0, float(seconds))
        while True:
            r = Sweep(
                spec, sub_map, packed, digests, config=cfg
            ).run_crack()
            sweeps += 1
            if int(r.n_emitted) != emitted:
                raise RuntimeError(
                    f"autotune arm {arm['name']}: emitted drifted between "
                    f"sweeps ({r.n_emitted} != {emitted})"
                )
            if time.monotonic() >= deadline:
                break
        wall = time.monotonic() - t0
    finally:
        if emit:
            if old_emit is None:
                os.environ.pop("A5GEN_EMIT", None)
            else:
                os.environ["A5GEN_EMIT"] = old_emit
    rate = emitted * sweeps / wall if wall > 0 else 0.0
    return {
        "arm": arm["name"],
        "geometry": {
            "lanes": int(arm["lanes"]),
            "num_blocks": int(arm["num_blocks"]),
            "stride": int(arm["stride"]),
            "superstep": arm.get("superstep"),
            "pair": arm.get("pair", "auto"),
            "emit": arm.get("emit"),
        },
        "emitted_per_sweep": emitted,
        "hits_per_sweep": n_hits,
        "sweeps": sweeps,
        "seconds": wall,
        "hashes_per_s": rate,
    }


def _read_tune_state(path: Optional[str]) -> Dict[str, Any]:
    if not path or not os.path.exists(path):
        return {"completed": {}}
    try:
        with open(path, "r", encoding="utf-8") as fh:
            doc = json.load(fh)
        if not isinstance(doc, dict) or not isinstance(
            doc.get("completed"), dict
        ):
            raise ValueError("not a tune-state object")
        return doc
    except (OSError, ValueError) as exc:
        raise TuneProfileCorrupt(f"{path}: unreadable tune state: {exc}")


def run_autotune(
    *,
    words: int = 512,
    seconds: float = 0.5,
    matrix: Optional[List[Dict[str, Any]]] = None,
    smoke: bool = False,
    state_path: Optional[str] = None,
    on_arm: Optional[Callable[[Dict[str, Any]], None]] = None,
    write: bool = True,
    directory: Optional[str] = None,
    device_kind: Optional[str] = None,
    spec: "Optional[AttackSpec]" = None,
    base_kw: Optional[Dict[str, Any]] = None,
    device: str = "cuda",
) -> Dict[str, Any]:
    """Sweep the arm matrix over the tune contract on ``device`` (the
    GPU unless ``"cpu"`` is given; ``base_kw["device"]`` wins) and
    optionally persist the winner as this device kind's profile.

    Partial-matrix resume: with ``state_path``, each completed arm's
    record is written atomically, and a rerun skips past the completed
    arms to the first unfinished one.

    Per-arm parity: every arm must emit the identical per-sweep
    candidate count; a mismatch raises instead of crowning a
    wrong-stream winner."""
    from ..models.attack import AttackSpec
    from ..ops.packing import pack_words

    base_kw = {"device": device, **(base_kw or {})}
    if spec is None:
        spec = AttackSpec(mode="default", algo="md5")
    arms = matrix if matrix is not None else default_matrix(smoke=smoke)
    if not arms:
        raise ValueError("autotune needs a non-empty arm matrix")
    wl = tune_wordlist(int(words))
    packed = pack_words(wl)
    # Plant a few real digests so the hit path (and host re-verification)
    # is part of what every arm pays for.
    import hashlib as _hashlib

    from ..oracle.engines import iter_candidates

    planted = []
    for w in wl[:: max(1, len(wl) // 3)][:3]:
        cand = next(
            iter(iter_candidates(w, _TUNE_SUB_MAP, spec.min_substitute,
                                 spec.max_substitute))
        )
        planted.append(_hashlib.md5(cand).digest())
    state = _read_tune_state(state_path)
    completed: Dict[str, Any] = dict(state.get("completed", {}))
    kind = device_kind or current_device_kind(base_kw["device"])
    records: List[Dict[str, Any]] = []
    for arm in arms:
        prior = completed.get(arm["name"])
        if prior is not None:
            rec = {**prior, "resumed": True}
            records.append(rec)
            if on_arm is not None:
                on_arm(rec)
            continue
        rec = measure_arm(
            spec, _TUNE_SUB_MAP, packed, planted, arm,
            seconds=seconds, base_kw=base_kw,
        )
        rec["device_kind"] = kind
        records.append(rec)
        completed[arm["name"]] = rec
        if state_path:
            atomic_write_text(
                state_path,
                json.dumps({"completed": completed}, sort_keys=True) + "\n",
            )
        if on_arm is not None:
            on_arm(rec)
    counts = {r["emitted_per_sweep"] for r in records}
    if len(counts) != 1:
        raise RuntimeError(
            "autotune parity failure: arms disagree on emitted-per-sweep "
            f"({sorted(counts)}); geometry must never change the stream"
        )
    winner = max(records, key=lambda r: r["hashes_per_s"])
    result: Dict[str, Any] = {
        "device_kind": kind,
        "arms": records,
        "winner": winner["arm"],
        "geometry": dict(winner["geometry"]),
        "emitted_per_sweep": winner["emitted_per_sweep"],
        "hashes_per_s": winner["hashes_per_s"],
        "profile_path": None,
    }
    if write:
        geometry = dict(winner["geometry"])
        # "auto" knobs stay unset in the profile (None = let the sweep
        # decide), so a tune never pins choices it did not measure.
        if geometry.get("pair") == "auto":
            geometry["pair"] = None
        result["profile_path"] = write_profile(
            kind, geometry,
            bench={
                "winner": winner["arm"],
                "hashes_per_s": winner["hashes_per_s"],
                "emitted_per_sweep": winner["emitted_per_sweep"],
                "seconds_per_arm": seconds,
                "words": int(words),
                "arms": len(records),
            },
            directory=directory,
        )
    return result
