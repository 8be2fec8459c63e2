"""The port's declared configuration-knob registry.

The reference's ``runtime/knobs.py``, declaring this package as it is:
every env var, CLI flag, :class:`~.sweep.SweepConfig` field, serve JSONL
``config`` sub-field and tune-profile knob the port reads, with the
correctness roles binding each one to the cache key that must know
about it (the reference's roles, unchanged).  A pure literal that
imports nothing: ``ast.literal_eval`` and ``json`` round-trip it, and
the fleet router's process may import it without torch.

``tests/test_torch_knobs.py`` holds it equal to the reference's registry
except for the departures it names one by one (the port's own
``device`` knob, the Pallas-only knobs it has no counterpart for, the
port's key tokens and ``None`` defaults, the kind of its trace key); runs
``tools.graftknob``'s GK001, GK003, GK004 and GK005 over the port's tree
with this registry; and checks the ``trace`` role by behaviour.

Registry shape (the reference's):

``layers``
    Which of the five layers surface the knob, each with its spelling
    there and (env/cli/config) its declared default.

``roles``
    The knob's correctness classes:

    * ``trace`` — changes the step closure a sweep builds
      (``models/attack.make_superstep_body`` & co.); its ``keys`` token
      is spelled in the step-cache key: the key's name
      (``Sweep._step``'s first argument), ``spec``, a keyword the
      closure takes (``Sweep._geometry``'s ``kw``), or an env knob of
      ``_STEP_ENV_KNOBS`` (``runtime/sweep._get_step``).  The port keys
      its closures on those statics, not on the reference's ``skey``
      tuples, so the role is held by a behavioural test: two sweeps
      differing only in the knob record different keys.
    * ``fuse-compat`` — jobs disagreeing on it must not fuse; its token
      appears in ``runtime/fuse.pack_candidate``'s compatibility key (or
      gates an early ``return None`` there).
    * ``affinity`` — scheduler-visible: its token reaches
      ``affinity_token``'s ``static_affinity_token`` call.
    * ``fingerprint`` — changes the semantic candidate stream; its token
      is a ``runtime/checkpoint.sweep_fingerprint`` parameter.
    * ``stream-semantics`` — changes WHAT is emitted but reaches the
      fingerprint through a parsed input (``sub_map``/``words``/
      ``digests``); declaration-only, the note says how.
    * ``host-only`` — observability, paths, scheduling, recovery
      budgets: never changes results or step closures.

``keys``
    role -> the token that witnesses the knob at its key site.  Defaults
    to the knob name when omitted.

``precedence``
    Human-readable resolution order across the declared layers.

``scope``
    ``"runtime"`` (default; the surface must be read in the package) or
    ``"tests"`` (documented knobs only a test suite reads).
"""

from __future__ import annotations

__all__ = ["KNOBS_VERSION", "LAYERS", "ROLES", "KNOBS"]

#: Registry version (MAJOR.MINOR): knob/role/surface ADDITIONS bump the
#: minor, removals/renames the major, metadata (defaults, precedence,
#: notes) any re-pin.  ``--update-knobs`` refuses violations.
KNOBS_VERSION = "1.1"

#: The five places a knob can surface.
LAYERS = ("env", "cli", "config", "serve-doc", "tune-profile")

#: The six correctness classes (see module docstring).
ROLES = ("trace", "fuse-compat", "affinity", "fingerprint",
         "stream-semantics", "host-only")

KNOBS: dict[str, dict[str, object]] = {
    # ------------------------------------------------------------------
    # Launch geometry + executor shape (SweepConfig-centric)
    # ------------------------------------------------------------------
    "device": {
        "layers": {
            "config": {"surface": "device", "default": "cuda"},
            "cli": {"surface": "--device", "default": "cuda"},
        },
        "roles": ["fuse-compat"],
        "keys": {"fuse-compat": "devices"},
        "precedence": "explicit > builtin (cuda; never chosen "
                      "implicitly: without a GPU cuda raises)",
        "note": "where the sweep runs (cuda, or cpu: the kernels' plain "
                "PyTorch versions); the step closures are device-"
                "agnostic, a fused group runs on one device",
    },
    "lanes": {
        "layers": {
            "config": {"surface": "lanes", "default": None},
            "cli": {"surface": "--lanes", "default": None},
            "serve-doc": {"surface": "lanes"},
            "tune-profile": {"surface": "lanes"},
        },
        "roles": ["trace", "fuse-compat", "affinity"],
        "keys": {"trace": "num_lanes", "fuse-compat": "lanes",
                 "affinity": "lanes"},
        "precedence": "explicit > profile > builtin",
        "note": "hash lanes per launch; baked into every traced body",
    },
    "num_blocks": {
        "layers": {
            "config": {"surface": "num_blocks", "default": None},
            "cli": {"surface": "--blocks", "default": None},
            "serve-doc": {"surface": "blocks"},
            "tune-profile": {"surface": "num_blocks"},
        },
        "roles": ["trace", "fuse-compat", "affinity"],
        "keys": {"trace": "num_blocks", "fuse-compat": "nb",
                 "affinity": "num_blocks"},
        "precedence": "explicit > profile > builtin",
        "note": "block batch per superstep dispatch",
    },
    "packed_blocks": {
        "layers": {
            "config": {"surface": "packed_blocks", "default": None},
            "cli": {"surface": "--block-layout", "default": "auto"},
            "tune-profile": {"surface": "packed_blocks"},
        },
        "roles": ["trace", "fuse-compat"],
        "keys": {"trace": "block_stride", "fuse-compat": "stride"},
        "precedence": "explicit > profile > builtin (auto resolves "
                      "per plan)",
        "note": "packed vs fixed-stride block layout; reaches the keys "
                "as the resolved block stride",
    },
    "superstep": {
        "layers": {
            "config": {"surface": "superstep", "default": None},
            "cli": {"surface": "--superstep", "default": None},
            "serve-doc": {"surface": "superstep"},
            "tune-profile": {"surface": "superstep"},
        },
        "roles": ["trace", "fuse-compat", "affinity"],
        "keys": {"trace": "superstep", "fuse-compat": "steps",
                 "affinity": "superstep"},
        "precedence": "explicit > profile > builtin (auto); "
                      "A5GEN_SUPERSTEP=off vetoes",
        "note": "device-resident steps per dispatch; off pins the "
                "per-launch pipeline",
    },
    "superstep_hit_cap": {
        "layers": {
            "config": {"surface": "superstep_hit_cap",
                       "default": 4096},
        },
        "roles": ["fuse-compat"],
        "keys": {"fuse-compat": "superstep_hit_cap"},
        "precedence": "config only",
        "note": "on-device hit-buffer rows per superstep (overflow "
                "falls back per block)",
    },
    "fetch_chunk": {
        "layers": {
            "config": {"surface": "fetch_chunk", "default": 16},
            "cli": {"surface": "--fetch-chunk", "default": None},
            "serve-doc": {"surface": "fetch_chunk"},
        },
        "roles": ["fuse-compat"],
        "keys": {"fuse-compat": "steps"},
        "precedence": "explicit > builtin",
        "note": "dispatches per counters fetch; sets the superstep "
                "step count when --superstep is auto",
    },
    "devices": {
        "layers": {
            "config": {"surface": "devices", "default": 1},
            "cli": {"surface": "--devices", "default": 1},
            "serve-doc": {"surface": "devices"},
        },
        "roles": ["trace", "fuse-compat", "affinity"],
        "keys": {"trace": "advance", "fuse-compat": "devices",
                 "affinity": "devices"},
        "precedence": "explicit > builtin (auto = all local)",
        "note": "cursor stripes of one sweep (a stripe's step "
                "advances past every stripe's blocks)",
    },
    "pair": {
        "layers": {
            "config": {"surface": "pair", "default": None},
            "cli": {"surface": "--pair", "default": "auto"},
            "serve-doc": {"surface": "pair"},
            "tune-profile": {"surface": "pair"},
        },
        "roles": ["trace", "fuse-compat", "affinity"],
        "keys": {"trace": "pair_k", "fuse-compat": "pair_k",
                 "affinity": "pair"},
        "precedence": "explicit > profile > builtin (auto); "
                      "A5GEN_PAIR=off vetoes",
        "note": "pair-lane tier (K=2 candidates per hash lane) for "
                "eligible schemas",
    },
    "pipeline": {
        "layers": {
            "config": {"surface": "pipeline", "default": None},
        },
        "roles": ["fuse-compat"],
        "keys": {"fuse-compat": "_pipeline_depth"},
        "precedence": "config > A5GEN_PIPELINE gate > builtin",
        "note": "superstep double-buffer depth; a fused group runs ONE "
                "depth for every member",
    },
    "max_in_flight": {
        "layers": {
            "config": {"surface": "max_in_flight", "default": 2},
        },
        "roles": ["fuse-compat"],
        "keys": {"fuse-compat": "_pipeline_depth"},
        "precedence": "config only",
        "note": "in-flight launch bound of the non-superstep drive "
                "(and the pipeline-depth fallback)",
    },
    "pod": {
        "layers": {
            "config": {"surface": "pod", "default": None},
            "cli": {"surface": "--giant-job", "default": False},
            "serve-doc": {"surface": "pod"},
        },
        "roles": ["trace", "fuse-compat"],
        "keys": {"trace": "advance", "fuse-compat": "pod"},
        "precedence": "config (CLI --giant-job derives it from the "
                      "pod runtime; the fleet router's split scatter "
                      "drives it per shard through the serve doc)",
        "note": "giant-job block striping (stripe, n_stripes); "
                "pod-striped jobs refuse packed dispatch",
    },
    "stream_chunk_words": {
        "layers": {
            "config": {"surface": "stream_chunk_words",
                       "default": None},
            "cli": {"surface": "--stream-chunk-words",
                    "default": "auto"},
            "serve-doc": {"surface": "stream_chunk_words"},
        },
        "roles": ["fuse-compat"],
        "keys": {"fuse-compat": "_stream"},
        "precedence": "explicit > builtin (auto engages past one "
                      "~64 MB plan chunk); A5GEN_STREAM=off vetoes",
        "note": "streaming plan pipeline chunk size; streaming sweeps "
                "keep per-job dispatch",
    },
    # ------------------------------------------------------------------
    # Robustness + persistence (SweepConfig-centric)
    # ------------------------------------------------------------------
    "retry_attempts": {
        "layers": {
            "config": {"surface": "retry_attempts", "default": None},
            "serve-doc": {"surface": "retry_attempts"},
        },
        "roles": ["fuse-compat"],
        "keys": {"fuse-compat": "retry_policy"},
        "precedence": "config only",
        "note": "transient-error retries of the drive supervisor; one "
                "policy per fused group",
    },
    "retry_backoff_s": {
        "layers": {
            "config": {"surface": "retry_backoff_s",
                       "default": None},
            "serve-doc": {"surface": "retry_backoff_s"},
        },
        "roles": ["fuse-compat"],
        "keys": {"fuse-compat": "retry_policy"},
        "precedence": "config only",
        "note": "backoff between transient retries",
    },
    "fetch_timeout_s": {
        "layers": {
            "config": {"surface": "fetch_timeout_s", "default": None},
            "cli": {"surface": "--fetch-timeout", "default": None},
            "serve-doc": {"surface": "fetch_timeout_s"},
        },
        "roles": ["fuse-compat"],
        "keys": {"fuse-compat": "fetch_timeout_s"},
        "precedence": "explicit > builtin (off)",
        "note": "per-fetch watchdog; one watchdog per fused group",
    },
    "checkpoint_path": {
        "layers": {
            "config": {"surface": "checkpoint_path", "default": None},
            "cli": {"surface": "--checkpoint", "default": None},
            "serve-doc": {"surface": "checkpoint_path"},
        },
        "roles": ["host-only"],
        "precedence": "explicit > builtin (off)",
        "note": "on-disk checkpoint file (power-loss-safe writes)",
    },
    "checkpoint_every_s": {
        "layers": {
            "config": {"surface": "checkpoint_every_s",
                       "default": 30.0},
            "cli": {"surface": "--checkpoint-every", "default": 30.0},
            "serve-doc": {"surface": "checkpoint_every_s"},
        },
        "roles": ["host-only"],
        "precedence": "explicit > builtin",
        "note": "checkpoint write cadence",
    },
    "faults": {
        "layers": {
            "config": {"surface": "faults", "default": None},
            "env": {"surface": "A5GEN_FAULTS", "default": None},
        },
        "roles": ["host-only"],
        "precedence": "config > env > unset (no faults armed)",
        "note": "deterministic fault-injection plan (recovery paths "
                "change, declared results never do)",
    },
    "progress": {
        "layers": {
            "config": {"surface": "progress", "default": None},
            "cli": {"surface": "--progress", "default": False},
        },
        "roles": ["host-only"],
        "precedence": "explicit > builtin (off)",
        "note": "stderr progress meter",
    },
    "schema_cache": {
        "layers": {
            "config": {"surface": "schema_cache", "default": None},
            "cli": {"surface": "--schema-cache", "default": None},
            "serve-doc": {"surface": "schema_cache"},
            "env": {"surface": "A5GEN_SCHEMA_CACHE", "default": None},
        },
        "roles": ["host-only"],
        "precedence": "config/cli > env > unset (no persistent cache)",
        "note": "on-disk piece-schema cache directory",
    },
    "schema_cache_max_mb": {
        "layers": {
            "config": {"surface": "schema_cache_max_mb",
                       "default": None},
            "cli": {"surface": "--schema-cache-max-mb",
                    "default": None},
            "serve-doc": {"surface": "schema_cache_max_mb"},
            "env": {"surface": "A5GEN_SCHEMA_CACHE_MAX_MB",
                    "default": None},
        },
        "roles": ["host-only"],
        "precedence": "config/cli > env > unset (unbounded)",
        "note": "LRU size cap on the schema cache",
    },
    "geometry_source": {
        "layers": {
            "config": {"surface": "geometry_source",
                       "default": "explicit"},
        },
        "roles": ["host-only"],
        "precedence": "set by the resolution seam, not by users",
        "note": "provenance marker of the resolved geometry "
                "(explicit/profile/builtin) for stats surfaces",
    },
    # ------------------------------------------------------------------
    # Attack-spec inputs (fingerprint material)
    # ------------------------------------------------------------------
    "mode": {
        "layers": {
            "cli": {"surface": ["-s", "--substitute-all", "-r",
                                "--reverse-sub"], "default": False},
        },
        "roles": ["trace", "fuse-compat", "affinity", "fingerprint",
                  "stream-semantics"],
        "keys": {"trace": "spec", "fuse-compat": "spec",
                 "affinity": "mode", "fingerprint": "mode"},
        "precedence": "cli flags compose the mode; serve jobs pass "
                      "the submit doc's mode field (WIRE_OPS)",
        "note": "attack mode (default/reverse/suball/suball-reverse); "
                "baked into every traced body",
    },
    "algo": {
        "layers": {
            "cli": {"surface": "--algo", "default": "md5"},
        },
        "roles": ["trace", "fuse-compat", "affinity", "fingerprint",
                  "stream-semantics"],
        "keys": {"trace": "spec", "fuse-compat": "spec",
                 "affinity": "algo", "fingerprint": "algo"},
        "precedence": "cli; serve jobs pass the submit doc's algo "
                      "field (WIRE_OPS)",
        "note": "digest algorithm (md5/md4/sha1/ntlm)",
    },
    "table_min": {
        "layers": {
            "cli": {"surface": ["-m", "--table-min"], "default": 0},
        },
        "roles": ["trace", "fuse-compat", "affinity", "fingerprint",
                  "stream-semantics"],
        "keys": {"trace": "spec", "fuse-compat": "spec",
                 "affinity": "table_min",
                 "fingerprint": "min_substitute"},
        "precedence": "cli; serve jobs pass the submit doc's "
                      "table_min field (WIRE_OPS)",
        "note": "minimum substitutions per candidate",
    },
    "table_max": {
        "layers": {
            "cli": {"surface": ["-x", "--table-max"], "default": 15},
        },
        "roles": ["trace", "fuse-compat", "affinity", "fingerprint",
                  "stream-semantics"],
        "keys": {"trace": "spec", "fuse-compat": "spec",
                 "affinity": "table_max",
                 "fingerprint": "max_substitute"},
        "precedence": "cli; serve jobs pass the submit doc's "
                      "table_max field (WIRE_OPS)",
        "note": "maximum substitutions per candidate",
    },
    "dict_file": {
        "layers": {
            "cli": {"surface": "dict_file", "default": None},
        },
        "roles": ["fingerprint", "stream-semantics"],
        "keys": {"fingerprint": "words"},
        "precedence": "cli positional; serve jobs pass dict/words "
                      "doc fields (WIRE_OPS)",
        "note": "the wordlist input",
    },
    "table_files": {
        "layers": {
            "cli": {"surface": ["-t", "--table-files"],
                    "default": []},
        },
        "roles": ["fingerprint", "stream-semantics"],
        "keys": {"fingerprint": "sub_map"},
        "precedence": "cli (repeatable, merged); serve jobs pass "
                      "tables/table_map doc fields (WIRE_OPS)",
        "note": "substitution tables (merged per key)",
    },
    "digests": {
        "layers": {
            "cli": {"surface": "--digests", "default": None},
        },
        "roles": ["fingerprint", "stream-semantics"],
        "keys": {"fingerprint": "digests"},
        "precedence": "cli; serve jobs pass digests/digest_list doc "
                      "fields (WIRE_OPS)",
        "note": "target digest set (crack mode; absent = candidates "
                "mode)",
    },
    # ------------------------------------------------------------------
    # Env-only escape hatches + process-wide gates
    # ------------------------------------------------------------------
    "A5GEN_PALLAS": {
        "layers": {
            "env": {"surface": "A5GEN_PALLAS", "default": None},
        },
        "roles": ["trace"],
        "keys": {"trace": "A5GEN_PALLAS"},
        "precedence": "env only (process-wide kernel selection)",
        "note": "fused CUDA kernel opt-out (off/0/xla/none) or "
                "MD5-compression-only opt-in (1); rides the step-cache "
                "env suffix",
    },
    "A5GEN_EMIT": {
        "layers": {
            "env": {"surface": "A5GEN_EMIT", "default": None},
        },
        "roles": ["trace", "fuse-compat"],
        "keys": {"trace": "pieces", "fuse-compat": "pieces"},
        "precedence": "env only (process-wide compile knob; profiles "
                      "record it but never apply it)",
        "note": "perslot piece emission vs legacy bytescan; reaches "
                "the keys through the piece schema",
    },
    "A5GEN_CASCADE_CLOSE": {
        "layers": {
            "env": {"surface": "A5GEN_CASCADE_CLOSE",
                    "default": None},
        },
        "roles": ["trace"],
        "keys": {"trace": "pieces"},
        "precedence": "env only",
        "note": "suball cascade-closure opt-out; changes the plan/"
                "piece structure the keys carry",
    },
    "A5GEN_SUPERSTEP": {
        "layers": {
            "env": {"surface": "A5GEN_SUPERSTEP", "default": None},
        },
        "roles": ["trace", "fuse-compat"],
        "keys": {"trace": "superstep", "fuse-compat": "steps"},
        "precedence": "env veto over the superstep knob",
        "note": "superstep executor opt-out; selects a differently-"
                "tagged step program and disables packing",
    },
    "A5GEN_PIPELINE": {
        "layers": {
            "env": {"surface": "A5GEN_PIPELINE", "default": None},
        },
        "roles": ["fuse-compat"],
        "keys": {"fuse-compat": "_pipeline_depth"},
        "precedence": "env veto over the pipeline knob",
        "note": "double-buffered superstep pipeline opt-out",
    },
    "A5GEN_STREAM": {
        "layers": {
            "env": {"surface": "A5GEN_STREAM", "default": None},
        },
        "roles": ["fuse-compat"],
        "keys": {"fuse-compat": "_stream"},
        "precedence": "env veto over stream_chunk_words",
        "note": "streaming plan pipeline opt-out",
    },
    "A5GEN_PAIR": {
        "layers": {
            "env": {"surface": "A5GEN_PAIR", "default": None},
        },
        "roles": ["trace", "fuse-compat"],
        "keys": {"trace": "pair_k", "fuse-compat": "pair_k"},
        "precedence": "env veto over the pair knob",
        "note": "pair-lane (K=2) tier opt-out",
    },
    "pack": {
        "layers": {
            "env": {"surface": "A5GEN_PACK", "default": None},
            "cli": {"surface": "--pack", "default": "auto"},
        },
        "roles": ["host-only"],
        "precedence": "cli > env > builtin (on); Engine(pack=) "
                      "overrides per engine",
        "note": "cross-job packed dispatch gate (streams identical "
                "either way; fill/dispatch count differ)",
    },
    "A5GEN_TELEMETRY": {
        "layers": {
            "env": {"surface": "A5GEN_TELEMETRY", "default": None},
        },
        "roles": ["host-only"],
        "precedence": "env only",
        "note": "hot-path telemetry opt-out (result-backing counters "
                "always record)",
    },
    "A5GEN_REFUSE": {
        "layers": {
            "env": {"surface": "A5GEN_REFUSE", "default": None},
        },
        "roles": ["host-only"],
        "precedence": "Engine(refuse_below=) > env > builtin (0.5)",
        "note": "packed-group re-fuse fill threshold; off disables "
                "re-fuse; within[:ratio] keeps re-fuse on but pins "
                "the within-group-only merge scope (the cross-group "
                "control arm)",
    },
    "tune_profile": {
        "layers": {
            "env": {"surface": "A5GEN_TUNE_PROFILE", "default": None},
            "cli": {"surface": ["--profile", "--profile-dir"],
                    "default": None},
        },
        "roles": ["host-only"],
        "precedence": "cli dir > env dir > ~/.cache/a5gen/tune; "
                      "env off disables loading AND writing",
        "note": "autotune profile directory / kill switch (resolved "
                "geometry knobs carry the correctness roles)",
    },
    "A5GEN_DCN_TIMEOUT": {
        "layers": {
            "env": {"surface": "A5GEN_DCN_TIMEOUT", "default": None},
        },
        "roles": ["host-only"],
        "precedence": "env > builtin (600 s)",
        "note": "pod peer-loss watchdog for cross-host collectives",
    },
    "A5_NATIVE": {
        "layers": {
            "env": {"surface": "A5_NATIVE", "default": None},
        },
        "roles": ["host-only"],
        "precedence": "env > builtin (on when the toolchain allows)",
        "note": "C++ oracle fast path opt-out (grandfathered pre-"
                "A5GEN_ name; byte-identical streams)",
    },
    "A5GEN_REFERENCE_BIN": {
        "layers": {
            "env": {"surface": "A5GEN_REFERENCE_BIN",
                    "default": None},
        },
        "roles": ["host-only"],
        "scope": "tests",
        "precedence": "env only",
        "note": "path to a compiled upstream binary (enables the "
                "byte-diff harness in tests)",
    },
    "A5GEN_FORBID_SLOW": {
        "layers": {
            "env": {"surface": "A5GEN_FORBID_SLOW", "default": None},
        },
        "roles": ["host-only"],
        "scope": "tests",
        "precedence": "env only (CI sets 1)",
        "note": "hard-fail collection when a slow-marked test enters "
                "the default tier",
    },
    # ------------------------------------------------------------------
    # CLI-only front-end knobs (host side)
    # ------------------------------------------------------------------
    "threads": {
        "layers": {"cli": {"surface": "--threads", "default": -1}},
        "roles": ["host-only"],
        "precedence": "cli > builtin (-1 = auto)",
        "note": "oracle-backend worker processes (stream byte-"
                "identical at any N)",
    },
    "backend": {
        "layers": {"cli": {"surface": "--backend",
                           "default": "oracle"}},
        "roles": ["host-only"],
        "precedence": "cli only",
        "note": "oracle (CPU reference) vs device (the CUDA "
                "sweep); byte-exact parity is the repo contract",
    },
    "retries": {
        "layers": {"cli": {"surface": "--retries", "default": 0}},
        "roles": ["host-only"],
        "precedence": "cli only",
        "note": "whole-sweep rebuild+resume attempts after chip/"
                "backend loss (outer loop; distinct from "
                "retry_attempts)",
    },
    "no_resume": {
        "layers": {"cli": {"surface": "--no-resume",
                           "default": False}},
        "roles": ["host-only"],
        "precedence": "cli only",
        "note": "ignore an existing checkpoint file",
    },
    "output": {
        "layers": {"cli": {"surface": "--output", "default": None}},
        "roles": ["host-only"],
        "precedence": "cli; serve candidates jobs pass the output "
                      "doc field (WIRE_OPS)",
        "note": "candidate stream destination (default stdout)",
    },
    "metrics_json": {
        "layers": {"cli": {"surface": "--metrics-json",
                           "default": None}},
        "roles": ["host-only"],
        "precedence": "cli only",
        "note": "write run metrics JSON",
    },
    "emit_table": {
        "layers": {"cli": {"surface": "--emit-table",
                           "default": None}},
        "roles": ["stream-semantics"],
        "precedence": "cli only",
        "note": "emit a device table layout instead of sweeping "
                "(different output document entirely)",
    },
    "list_layouts": {
        "layers": {"cli": {"surface": "--list-layouts",
                           "default": False}},
        "roles": ["host-only"],
        "precedence": "cli only",
        "note": "print available emit-table layouts and exit",
    },
    "hex_unsafe": {
        "layers": {"cli": {"surface": "--hex-unsafe",
                           "default": False}},
        "roles": ["stream-semantics"],
        "precedence": "cli only",
        "note": "hashcat --hex-charset compat for digest parsing; "
                "reaches the fingerprint through the parsed digests",
    },
    "bug_compat": {
        "layers": {"cli": {"surface": "--bug-compat",
                           "default": False}},
        "roles": ["stream-semantics"],
        "precedence": "cli only",
        "note": "reproduce upstream parser quirks; reaches the "
                "fingerprint through the parsed sub_map",
    },
    "max_word_bytes": {
        "layers": {"cli": {"surface": "--max-word-bytes",
                           "default": 65536}},
        "roles": ["host-only"],
        "precedence": "cli > builtin",
        "note": "per-word input size guard (oversized words fail "
                "loudly, never truncate)",
    },
    "buckets": {
        "layers": {"cli": {"surface": "--buckets",
                           "default": "auto"}},
        "roles": ["host-only"],
        "precedence": "cli > builtin (auto)",
        "note": "packed-wordlist length buckets (throughput only; "
                "--buckets none pins input order)",
    },
    # Pod bring-up (the striping itself is the `pod` knob above).
    "coordinator": {
        "layers": {"cli": {"surface": "--coordinator",
                           "default": None}},
        "roles": ["host-only"],
        "precedence": "cli only",
        "note": "multi-process pod coordinator HOST:PORT",
    },
    "num_processes": {
        "layers": {"cli": {"surface": "--num-processes",
                           "default": None}},
        "roles": ["host-only"],
        "precedence": "cli only",
        "note": "pod process count",
    },
    "process_id": {
        "layers": {"cli": {"surface": "--process-id",
                           "default": None}},
        "roles": ["host-only"],
        "precedence": "cli only",
        "note": "this host's pod process index",
    },
    "pod_hits": {
        "layers": {"cli": {"surface": "--pod-hits",
                           "default": "gathered"}},
        "roles": ["host-only"],
        "precedence": "cli > builtin (gathered)",
        "note": "gather pod hits to process 0 vs per-process local "
                "files",
    },
    # ------------------------------------------------------------------
    # Serve/fleet operational knobs (host side)
    # ------------------------------------------------------------------
    "socket": {
        "layers": {"cli": {"surface": "--socket", "default": None}},
        "roles": ["host-only"],
        "precedence": "cli > builtin (stdio)",
        "note": "serve/fleet unix socket path",
    },
    "engine_id": {
        "layers": {"cli": {"surface": "--engine-id",
                           "default": None}},
        "roles": ["host-only"],
        "precedence": "cli > generated",
        "note": "stable engine identity for fleet stats/placement",
    },
    "client_timeout": {
        "layers": {"cli": {"surface": "--client-timeout",
                           "default": None}},
        "roles": ["host-only"],
        "precedence": "cli > builtin (off)",
        "note": "idle-session watchdog (both directions quiet)",
    },
    "admission_worker": {
        "layers": {"cli": {"surface": "--admission-worker",
                           "default": "on"}},
        "roles": ["host-only"],
        "precedence": "cli > builtin (on)",
        "note": "build fuse admissions off the serve thread",
    },
    "engines": {
        "layers": {"cli": {"surface": "--engines", "default": None}},
        "roles": ["host-only"],
        "precedence": "cli (required)",
        "note": "fleet pool size or engine socket list",
    },
    "place": {
        "layers": {"cli": {"surface": "--place",
                           "default": "affinity"}},
        "roles": ["host-only"],
        "precedence": "cli > builtin (affinity)",
        "note": "router placement policy (affinity-token vs round-"
                "robin)",
    },
    "poll": {
        "layers": {"cli": {"surface": "--poll", "default": 2.0}},
        "roles": ["host-only"],
        "precedence": "cli > builtin",
        "note": "router health/stats scrape cadence",
    },
    "split": {
        "layers": {
            "env": {"surface": "A5GEN_SPLIT", "default": None},
            "cli": {"surface": "--split", "default": None},
        },
        "roles": ["host-only"],
        "precedence": "cli > env > builtin (auto)",
        "note": "fleet giant-job splitting (auto|on|off): scatter one "
                "oversized crack job across engines as disjoint pod "
                "stripes; host-side routing only — the merged stream "
                "is byte-identical to solo",
    },
    "split_threshold": {
        "layers": {
            "cli": {"surface": "--split-threshold",
                    "default": 4096},
        },
        "roles": ["host-only"],
        "precedence": "cli > builtin",
        "note": "word count at which split=auto scatters a crack job "
                "(split=on ignores it; split=off never scatters)",
    },
    "replay_budget": {
        "layers": {"cli": {"surface": "--replay-budget",
                           "default": 1}},
        "roles": ["host-only"],
        "precedence": "cli > builtin",
        "note": "crash-replay attempts per job before quarantine",
    },
    "autoscale": {
        "layers": {"cli": {"surface": "--autoscale",
                           "default": None}},
        "roles": ["host-only"],
        "precedence": "cli > builtin (off)",
        "note": "MIN:MAX engine autoscaling bounds",
    },
    "scale_up_at": {
        "layers": {"cli": {"surface": "--scale-up-at",
                           "default": 2.0}},
        "roles": ["host-only"],
        "precedence": "cli > builtin",
        "note": "backlog-per-engine threshold to scale up",
    },
    "scale_down_at": {
        "layers": {"cli": {"surface": "--scale-down-at",
                           "default": 0.25}},
        "roles": ["host-only"],
        "precedence": "cli > builtin",
        "note": "load threshold to scale down",
    },
    "scale_window": {
        "layers": {"cli": {"surface": "--scale-window",
                           "default": 2}},
        "roles": ["host-only"],
        "precedence": "cli > builtin",
        "note": "consecutive scrapes over threshold before scaling "
                "(hysteresis)",
    },
    "scale_cooldown": {
        "layers": {"cli": {"surface": "--scale-cooldown",
                           "default": 10.0}},
        "roles": ["host-only"],
        "precedence": "cli > builtin",
        "note": "seconds between scaling actions",
    },
    "engine_capacity": {
        "layers": {"cli": {"surface": "--engine-capacity",
                           "default": 32}},
        "roles": ["host-only"],
        "precedence": "cli > builtin",
        "note": "jobs per engine before admission queues",
    },
    "max_pending": {
        "layers": {"cli": {"surface": "--max-pending",
                           "default": 256}},
        "roles": ["host-only"],
        "precedence": "cli > builtin",
        "note": "router pending-queue bound (typed overload rejection "
                "past it)",
    },
    "per_tenant": {
        "layers": {"cli": {"surface": "--per-tenant", "default": 0}},
        "roles": ["host-only"],
        "precedence": "cli > builtin (0 = unlimited)",
        "note": "per-tenant admission cap",
    },
    "shed_policy": {
        "layers": {"cli": {"surface": "--shed-policy",
                           "default": "reject"}},
        "roles": ["host-only"],
        "precedence": "cli > builtin (reject)",
        "note": "overload shedding policy (reject/oldest/queue)",
    },
    "engine_dir": {
        "layers": {"cli": {"surface": "--engine-dir",
                           "default": None}},
        "roles": ["host-only"],
        "precedence": "cli > tmpdir",
        "note": "directory for spawned engines' sockets/logs",
    },
    # ------------------------------------------------------------------
    # Tune subcommand knobs (host side)
    # ------------------------------------------------------------------
    "tune_words": {
        "layers": {"cli": {"surface": "--words", "default": 512}},
        "roles": ["host-only"],
        "precedence": "cli > builtin",
        "note": "words per autotune arm measurement",
    },
    "tune_seconds": {
        "layers": {"cli": {"surface": "--seconds", "default": 1.0}},
        "roles": ["host-only"],
        "precedence": "cli > builtin",
        "note": "target seconds per autotune arm",
    },
    "tune_smoke": {
        "layers": {"cli": {"surface": "--smoke", "default": False}},
        "roles": ["host-only"],
        "precedence": "cli only",
        "note": "the CI 2x2 autotune matrix",
    },
    "tune_state": {
        "layers": {"cli": {"surface": "--state", "default": None}},
        "roles": ["host-only"],
        "precedence": "cli only",
        "note": "partial-matrix resume file for the autotuner",
    },
    "tune_no_write": {
        "layers": {"cli": {"surface": "--no-write",
                           "default": False}},
        "roles": ["host-only"],
        "precedence": "cli only",
        "note": "measure without persisting a profile",
    },
    "tune_json": {
        "layers": {"cli": {"surface": "--json", "default": False}},
        "roles": ["host-only"],
        "precedence": "cli only",
        "note": "machine-readable autotune result",
    },
}
