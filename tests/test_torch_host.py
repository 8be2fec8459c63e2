"""The PyTorch/CUDA package's host layer against the JAX reference.

The port runs without JAX and imports nothing of the reference package;
its host arrays (plans, piece schemas, block indexes, digest sets, packed
wordlists) are array-equal to the reference's on the same inputs, for
every built-in and derived layout.
"""

import ast
import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import hashcat_a5_table_generator_tpu.models.attack as j_attack
import hashcat_a5_table_generator_tpu.ops.blocks as j_blocks
import hashcat_a5_table_generator_tpu.ops.membership as j_member
import hashcat_a5_table_generator_tpu.ops.packing as j_packing
import hashcat_a5_table_generator_tpu.ops.pallas_expand as j_pe
import hashcat_a5_table_generator_tpu.tables.compile as j_compile
import hashcat_a5_table_generator_tpu_torch.models.attack as t_attack
import hashcat_a5_table_generator_tpu_torch.native as t_native
import hashcat_a5_table_generator_tpu_torch.ops.blocks as t_blocks
import hashcat_a5_table_generator_tpu_torch.ops.fused_expand as t_fe
import hashcat_a5_table_generator_tpu_torch.ops.membership as t_member
import hashcat_a5_table_generator_tpu_torch.ops.packing as t_packing
import hashcat_a5_table_generator_tpu_torch.tables.compile as t_compile
from hashcat_a5_table_generator_tpu.native import read_packed_buckets
from hashcat_a5_table_generator_tpu_torch.tables.layouts import (
    BUILTIN_LAYOUTS,
    DERIVED_LAYOUTS,
    get_layout,
)

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "hashcat_a5_table_generator_tpu_torch"
LAYOUTS = sorted(BUILTIN_LAYOUTS) + sorted(DERIVED_LAYOUTS)


def synth_words(sub_map, n=60, seed=0):
    """Seeded words mixing the layout's keys with filler letters and
    digits, 1-30 bytes (buckets 16 and 32)."""
    rng = np.random.default_rng(seed)
    keys = sorted(sub_map)
    filler = [bytes([c]) for c in b"abcdefxyz0123456789"]
    words = []
    for _ in range(n):
        parts = []
        while sum(map(len, parts)) < int(rng.integers(1, 31)):
            pool = keys if rng.random() < 0.5 else filler
            parts.append(pool[int(rng.integers(len(pool)))])
        words.append(b"".join(parts)[:30])
    return words


def spec_pair():
    return j_attack.AttackSpec(), t_attack.AttackSpec()


def assert_plans_equal(jp, tp):
    for f in dataclasses.fields(jp):
        a, b = getattr(jp, f.name), getattr(tp, f.name)
        if isinstance(a, np.ndarray) or a is None:
            assert (a is None) == (b is None), f.name
            if a is not None:
                assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        else:
            assert a == b, f.name


def assert_schemas_equal(js, ts):
    assert (js is None) == (ts is None)
    if js is None:
        return
    for f in dataclasses.fields(js):
        a, b = getattr(js, f.name), getattr(ts, f.name)
        if f.name == "groups":
            assert [dataclasses.astuple(g) for g in a] == [
                dataclasses.astuple(g) for g in b
            ]
        elif isinstance(a, np.ndarray) or a is None:
            assert (a is None) == (b is None), f.name
            if a is not None:
                assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        else:
            assert a == b, f.name


def test_port_imports_with_jax_blocked():
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in PORT.rglob("*.py") if p.name != "__main__.py"
    )
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['hashcat_a5_table_generator_tpu'] = None\n"
        + "".join(f"import {m}\n" for m in modules)
        + "print('ok')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def _imported_modules(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(REPO)) for p in PORT.rglob("*.py"))
    + ["chip_smoke.py"],
)
def test_no_jax_or_reference_imports(path):
    for mod in _imported_modules(REPO / path):
        top = mod.split(".")[0]
        assert top != "jax", f"{path} imports {mod}"
        assert top != "hashcat_a5_table_generator_tpu", (
            f"{path} imports the reference package ({mod})"
        )
        assert top != "tools", f"{path} imports the repo's tools ({mod})"


def test_import_scans_cover_the_xla_route():
    """The scans above take every module of the package: the XLA expand +
    hash route's modules (the buffer hash and the expansions' device
    halves) among them."""
    scanned = {str(p.relative_to(REPO)) for p in PORT.rglob("*.py")}
    for mod in ("ops/buffer_hash.py", "ops/hashes.py",
                "ops/expand_matches.py", "ops/expand_suball.py",
                "models/attack.py", "runtime/sinks.py"):
        assert f"hashcat_a5_table_generator_tpu_torch/{mod}" in scanned
    src = (PORT / "ops" / "buffer_hash.py").read_text()
    assert "import jax" not in src and "hashcat_a5_table_generator_tpu." \
        not in src


def test_library_exports_equal_reference():
    """The package exports the reference's library surface (the table
    parser's five names, the engines' six), and ``iter_candidates``
    streams as the reference's does."""
    import hashcat_a5_table_generator_tpu as j_pkg
    import hashcat_a5_table_generator_tpu_torch as t_pkg

    names = {n for n in vars(j_pkg) if not n.startswith("_")
             and callable(getattr(j_pkg, n))}
    assert len(names) == 11
    assert names <= set(vars(t_pkg))
    sub = get_layout("german").to_substitution_map()
    for kw in ({}, {"substitute_all": True}):
        assert list(t_pkg.iter_candidates(b"strasse", sub, 0, 15, **kw)) \
            == list(j_pkg.iter_candidates(b"strasse", sub, 0, 15, **kw))


def test_import_scans_cover_the_oracle_backend():
    """The scans above take the oracle backend's modules too (the native
    bindings, the keyspace, the ``--threads`` merge), and the port keeps
    its own copies of the native C++ sources: no module of the port
    reaches the reference package's ``native/``."""
    scanned = {str(p.relative_to(REPO)) for p in PORT.rglob("*.py")}
    for mod in ("native/__init__.py", "native/oracle_engine.py",
                "oracle/keyspace.py", "oracle/parallel.py", "cli.py"):
        assert f"hashcat_a5_table_generator_tpu_torch/{mod}" in scanned
    for src in ("packer.cpp", "oracle.cpp"):
        assert (PORT / "native" / src).is_file()
    for path in PORT.rglob("*.py"):
        assert "hashcat_a5_table_generator_tpu/native" not in \
            path.read_text(), path


@pytest.mark.parametrize("layout", LAYOUTS)
def test_plans_schemas_and_indexes_equal(layout):
    sub = get_layout(layout).to_substitution_map()
    words = synth_words(sub, seed=LAYOUTS.index(layout))
    jspec, tspec = spec_pair()
    jct, tct = j_compile.compile_table(sub), t_compile.compile_table(sub)
    for jb, tb in zip(j_packing.bucket_words(words).values(),
                      t_packing.bucket_words(words).values()):
        jplan = j_attack.build_plan(jspec, jct, jb)
        tplan = t_attack.build_plan(tspec, tct, tb)
        assert_plans_equal(jplan, tplan)
        js = j_packing.piece_schema_for(jplan, jct)
        ts = t_packing.piece_schema_for(tplan, tct)
        assert_schemas_equal(js, ts)
        assert t_fe.k_opts_for(tplan) == j_pe.k_opts_for(jplan)
        assert t_fe.scalar_units_for(tplan) == j_pe.scalar_units_for(jplan)
        if j_pe.scalar_units_for(jplan):
            weight = j_pe.scalar_units_fields(jplan, jct)["weight"]
            assert np.array_equal(t_fe.scalar_units_weight(tplan), weight)
        for stride in (4, 128):
            assert t_fe.pair_for_config(
                tspec, tplan, ts, block_stride=stride
            ) == j_pe.pair_for_config(jspec, jplan, js, block_stride=stride)
            ji = j_blocks.superstep_index(jplan, stride)
            ti = t_blocks.superstep_index(tplan, stride)
            assert np.array_equal(ji[0], ti[0])
            assert np.array_equal(ji[1], ti[1]) and ji[2] == ti[2]
            for b in (0, ji[2] // 2, max(ji[2] - 1, 0), ji[2]):
                assert t_blocks.block_cursor(tplan, stride, ti[0], b) == \
                    j_blocks.block_cursor(jplan, stride, ji[0], b)
        host = t_attack.piece_host_tables(ts)
        jhost = j_attack.piece_host_tables(js)
        assert set(host) <= set(jhost)
        for k, v in host.items():
            assert np.array_equal(v, jhost[k])


def test_device_arrays_same_from_either_package():
    """``device_arrays`` fed the reference's host objects gives the same
    tensors as fed the port's."""
    sub = get_layout("qwerty-cyrillic").to_substitution_map()
    words = synth_words(sub, seed=3)
    digests = [bytes(range(i, i + 16)) for i in range(5)]
    jspec, tspec = spec_pair()
    jct, tct = j_compile.compile_table(sub), t_compile.compile_table(sub)
    jplan = j_attack.build_plan(jspec, jct, j_packing.pack_words(words))
    tplan = t_attack.build_plan(tspec, tct, t_packing.pack_words(words))
    out = []
    for plan, ct, pk, bl, mem in (
        (jplan, jct, j_packing, j_blocks, j_member),
        (tplan, tct, t_packing, t_blocks, t_member),
    ):
        out.append(t_attack.device_arrays(
            plan, pk.piece_schema_for(plan, ct),
            mem.build_digest_set(digests, "md5"),
            bl.superstep_index(plan, 8), device="cpu",
        ))
    assert out[0].keys() == out[1].keys()
    for k in out[0]:
        if isinstance(out[0][k], torch.Tensor):
            assert torch.equal(out[0][k], out[1][k]), k
        else:
            assert out[0][k] == out[1][k], k


def test_digest_sets_equal():
    rng = np.random.default_rng(5)
    raw = rng.integers(0, 256, size=(300, 16), dtype=np.uint8)
    raw[:50, 3] |= 0x80  # words with the top bit set
    as_list = [r.tobytes() for r in raw] + [raw[0].tobytes()]  # duplicate
    for digests in (as_list, raw, [d.hex() for d in as_list[:40]]):
        j = j_member.build_digest_set(digests, "md5")
        t = t_member.build_digest_set(digests, "md5")
        assert np.array_equal(j.rows, t.rows) and j.rows.dtype == t.rows.dtype
        assert np.array_equal(j.bitmap, t.bitmap)
        assert j.bitmap_bits == t.bitmap_bits
    lookup = t_member.HostDigestLookup(raw)
    assert raw[7].tobytes() in lookup and bytes(16) not in lookup
    assert t_member.auto_bitmap_bits(10**6) == j_member.auto_bitmap_bits(10**6)


def test_read_packed_buckets_matches_reference(tmp_path):
    path = tmp_path / "words.txt"
    path.write_bytes(
        b"password\r\nsesame\n\n" + b"x" * 40 + b"\n" + b"y" * 70
        + b"\nzz\nlast-line-no-newline"
    )
    want = read_packed_buckets(str(path))
    for engine in ("1", "0"):  # the native packer, then its numpy version
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("A5_NATIVE", engine)
            got = t_native.read_packed_buckets(str(path))
            assert list(want) == list(got)
            for w in want:
                assert np.array_equal(want[w].tokens, got[w].tokens)
                assert np.array_equal(want[w].lengths, got[w].lengths)
                assert np.array_equal(want[w].index, got[w].index)
            with pytest.raises(ValueError):
                t_native.read_packed_buckets(str(path), max_word_bytes=50)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_kernel_gates_equal_reference(layout):
    """The kernel gates on every layout x hash x window: the option
    count, the pair tier, the decode tier, and whether the plan takes a
    kernel at all (the reference runs one of its Pallas kernels iff its
    gate passes at a TPU-legal geometry: the piece kernel when the plan
    has a piece schema, a byte-scan kernel otherwise)."""
    sub = get_layout(layout).to_substitution_map()
    words = synth_words(sub, seed=40 + LAYOUTS.index(layout))
    jct, tct = j_compile.compile_table(sub), t_compile.compile_table(sub)
    jb = next(iter(j_packing.bucket_words(words).values()))
    tb = next(iter(t_packing.bucket_words(words).values()))
    for algo in ("md5", "md4", "sha1", "ntlm"):
        for mx in (15, 2):
            jspec = j_attack.AttackSpec(algo=algo, max_substitute=mx)
            tspec = t_attack.AttackSpec(algo=algo, max_substitute=mx)
            jplan = j_attack.build_plan(jspec, jct, jb)
            tplan = t_attack.build_plan(tspec, tct, tb)
            js = j_packing.piece_schema_for(jplan, jct)
            ts = t_packing.piece_schema_for(tplan, tct)
            jk = j_pe.opts_for_config(jspec, jplan, jct, block_stride=128,
                                      num_blocks=8, require_tpu=False)
            assert t_fe.opts_for_config(tspec, tplan, tct) == jk
            assert t_fe.k_vals_for(tplan) == j_pe.k_vals_for(jplan)
            assert t_fe.pair_for_config(tspec, tplan, ts, block_stride=128) \
                == j_pe.pair_for_config(jspec, jplan, js, block_stride=128)
            scalar = bool(j_pe.scalar_units_for(jplan)) and jk == 1
            want = ("windowed", scalar) if jplan.windowed else (
                "scalar" if scalar else "digits", False)
            assert t_fe.decode_for(tplan) == want
            took = t_fe.opts_for(tspec, tplan, tct) is not None and (
                ts is None or t_fe.schema_refusal(tplan, ts) is None)
            assert took == (jk is not None)
            assert (ts is None) == (js is None)


@pytest.mark.parametrize("kw", [
    {}, dict(algo="sha1"), dict(algo="ntlm", out_width=91),
    dict(algo="ntlm", out_width=92), dict(out_width=183),
    dict(out_width=184), dict(windowed=True, win_k2=2),
    dict(windowed=True, win_k2=10), dict(windowed=True, win_k2=11),
    dict(windowed=True), dict(num_slots=25), dict(token_width=64),
    dict(token_width=65), dict(max_val_len=5), dict(max_options=12),
    dict(max_options=13), dict(mode="suball"), dict(algo="sha256"),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()) or "base")
def test_eligible_equals_reference(kw):
    args = dict(mode="default", algo="md5", windowed=False, out_width=32,
                num_slots=8, token_width=16, max_val_len=2, max_options=1)
    args.update(kw)
    assert t_fe.eligible(**args) == j_pe.eligible(
        block_stride=128, num_blocks=8, **args)


def test_unrank_windowed_equals_reference():
    import hashcat_a5_table_generator_tpu.ops.expand_matches as j_em
    import hashcat_a5_table_generator_tpu_torch.ops.expand_matches as t_em

    sub = get_layout("czech").to_substitution_map()
    words = [w for w in synth_words(sub, n=80, seed=9) if len(w) > 12]
    tct = t_compile.compile_table(sub)
    plan = t_attack.build_plan(t_attack.AttackSpec(max_substitute=3), tct,
                               t_packing.pack_words(words))
    assert plan.windowed
    rng = np.random.default_rng(9)
    for w in range(plan.batch):
        radices = [int(r) for r in plan.pat_radix[w]]
        total = plan.n_variants[w]
        for rank in set(rng.integers(0, max(total, 1), size=6).tolist()) | {
                0, total - 1}:
            if rank < 0:
                continue
            got = t_em.unrank_windowed(plan.win_v[w], radices, rank)
            assert got == j_em.unrank_windowed(plan.win_v[w], radices, rank)
            assert 1 <= sum(d > 0 for d in got) <= 3
        with pytest.raises(ValueError):
            t_em.unrank_windowed(plan.win_v[w], radices, total)


@pytest.mark.parametrize("algo", ["md5", "md4", "sha1", "ntlm"])
def test_plain_compressions_equal_reference_hashes(algo):
    """``hash_words`` on padded message words equals the reference's
    ``HASH_FNS`` on the bytes (NTLM: MD4 over the byte-wise UTF-16LE
    expansion), at lengths around every block boundary."""
    import struct

    import jax.numpy as jnp

    from hashcat_a5_table_generator_tpu.ops.hashes import HASH_FNS
    from hashcat_a5_table_generator_tpu_torch.ops.hashes import (
        hash_words,
        utf16_code_units,
    )

    rng = np.random.default_rng(7)
    lengths = [0, 1, 27, 28, 55, 56, 63, 64, 91, 119, 120, 150]
    raw = rng.integers(0, 256, size=(len(lengths), 160), dtype=np.uint8)
    raw[:, 0] |= 0x80  # top bits set in the first message word
    want = np.asarray(HASH_FNS[algo](
        jnp.asarray(raw), jnp.asarray(np.array(lengths, np.int32))))
    for i, n in enumerate(lengths):
        data = raw[i, :n].tobytes()
        if algo == "ntlm":
            data = bytes(b for c in data for b in (c, 0))
        nblk = -(-(len(data) + 9) // 64)
        buf = bytearray(data + b"\x80" + bytes(nblk * 64 - len(data) - 1))
        buf[-8:] = struct.pack(">Q" if algo == "sha1" else "<Q",
                               8 * len(data))
        words = torch.from_numpy(np.frombuffer(bytes(buf), "<i4").copy())
        got = hash_words(words[None], torch.tensor([len(data)],
                                                   dtype=torch.int32), algo)
        assert np.array_equal(got[0].numpy().view(np.uint32), want[i]), n
    lo, hi = utf16_code_units(torch.tensor([-0x3BCCDDEF],  # 0xC4332211
                                           dtype=torch.int32))
    assert (int(lo) & 0xFFFFFFFF, int(hi) & 0xFFFFFFFF) == \
        (0x00220011, 0x00C40033)


def test_import_scans_cover_the_registries():
    """The scans above take the knob registry (``runtime/knobs.py``) and
    the audit registry (``audit.py``), and both are stdlib-only: they
    import with torch, jax, the reference package and ``tools/`` all
    blocked, and the audited modules populate the registry with jax and
    the reference blocked."""
    scanned = {str(p.relative_to(REPO)) for p in PORT.rglob("*.py")}
    for mod in ("runtime/knobs.py", "audit.py", "audit_harness.py"):
        assert f"hashcat_a5_table_generator_tpu_torch/{mod}" in scanned
    blocked = ("torch", "numpy", "jax", "hashcat_a5_table_generator_tpu",
               "tools")
    code = ("import sys\n"
            + "".join(f"sys.modules[{m!r}] = None\n" for m in blocked)
            + "from hashcat_a5_table_generator_tpu_torch.runtime import "
            "knobs\n"
            "from hashcat_a5_table_generator_tpu_torch import audit\n"
            "assert 'device' in knobs.KNOBS and not audit.AUDIT_REGISTRY\n"
            "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr
    code = ("import sys\n"
            + "".join(f"sys.modules[{m!r}] = None\n" for m in blocked[2:])
            + "import hashcat_a5_table_generator_tpu_torch.models.attack\n"
            "from hashcat_a5_table_generator_tpu_torch import audit\n"
            "print(len(audit.registered_entries()))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "11", r.stderr


def test_import_scans_cover_the_pod():
    """The scans above take the multi-device and pod modules and the
    schema cache's: they import with jax absent and import nothing of the
    reference package (its ``parallel/`` included); the pod's collectives
    ride torch.distributed, imported only when a pod starts."""
    scanned = {str(p.relative_to(REPO)) for p in PORT.rglob("*.py")}
    for mod in ("parallel/__init__.py", "parallel/devices.py",
                "parallel/multihost.py", "runtime/env.py",
                "ops/packing.py"):
        assert f"hashcat_a5_table_generator_tpu_torch/{mod}" in scanned
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['hashcat_a5_table_generator_tpu'] = None\n"
            "import hashcat_a5_table_generator_tpu_torch.parallel."
            "multihost as m\n"
            "import hashcat_a5_table_generator_tpu_torch.parallel."
            "devices as d\n"
            "import torch.distributed as dist\n"
            "assert not dist.is_initialized()\n"
            "assert m.initialize(num_processes=1) == (0, 1)\n"
            "assert len(d.resolve_devices(2, 'cpu')) == 2\n"
            "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_import_scans_cover_the_engine():
    """The scans above take the service layer's modules (the engine, the
    fuse layer, the wire protocol, the fleet router): with jax and the
    reference package blocked they import, an engine on the CPU serves a
    JSONL job with a packed pair end to end, and the router spawns this
    package's engines."""
    scanned = {str(p.relative_to(REPO)) for p in PORT.rglob("*.py")}
    for mod in ("runtime/engine.py", "runtime/fuse.py",
                "runtime/protocol.py", "runtime/telemetry.py",
                "runtime/fleet.py"):
        assert f"hashcat_a5_table_generator_tpu_torch/{mod}" in scanned
    code = (
        "import io, json, sys, time\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['hashcat_a5_table_generator_tpu'] = None\n"
        "from hashcat_a5_table_generator_tpu_torch.runtime import "
        "engine, fleet, fuse, protocol\n"
        "assert fleet._PACKAGE == 'hashcat_a5_table_generator_tpu_torch'\n"
        "fleet.FleetRouter(poll_s=0).close(shutdown_engines=False)\n"
        "from hashcat_a5_table_generator_tpu_torch.runtime.sweep import "
        "SweepConfig\n"
        "eng = engine.Engine(SweepConfig(device='cpu', lanes=64, "
        "num_blocks=16, superstep=1))\n"
        "doc = {'op': 'submit', 'table_map': {'a': ['4', '@']}, "
        "'digest_list': ['d41d8cd98f00b204e9800998ecf8427e']}\n"
        "lines = [json.dumps(dict(doc, id=f'j{i}', words=['banana', "
        "'papaya'][i:] + ['banana', 'papaya'][:i])) for i in range(2)]\n"
        "out = io.StringIO()\n"
        "engine.serve_stdio(eng, io.StringIO('\\n'.join(lines) + '\\n'), "
        "out)\n"
        "eng.close()\n"
        "time.sleep(0.5)\n"
        "events = [json.loads(x) for x in out.getvalue().splitlines()]\n"
        "assert sum(e['event'] == 'done' for e in events) == 2, events\n"
        "assert eng.stats()['packed_dispatches'] > 0\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr
