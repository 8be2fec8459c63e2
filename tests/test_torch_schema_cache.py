"""The on-disk PieceSchema cache (``--schema-cache``,
``--schema-cache-max-mb``, ``A5GEN_SCHEMA_CACHE``) against the
reference's, on the CPU.

One cache directory serves both packages: the keys are equal for match,
substitute-all, cascade-closed plans and a plan whose geometry refuses
piece emission (a cached ``None``); a directory written by either
package is read by the other as hits only, the schemas equal array for
array; a version mismatch or a corrupt entry is a miss; the size cap
evicts the oldest-atime entries; CLI stdout with the cache equals the
reference CLI's in four modes, streamed in chunks of 7 words and whole;
and ``SweepResult.schema_cache`` reports the reference's deltas.
"""

import os

import numpy as np
import pytest
from test_torch_host import assert_schemas_equal
from test_torch_resume_cli import _disarm, run, write_inputs  # noqa: F401

import hashcat_a5_table_generator_tpu.ops.packing as j_packing
from hashcat_a5_table_generator_tpu.models import attack as j_attack
from hashcat_a5_table_generator_tpu.runtime import Sweep as JSweep
from hashcat_a5_table_generator_tpu.runtime import SweepConfig as JConfig
from hashcat_a5_table_generator_tpu.tables.compile import (
    compile_table as j_compile,
)
from hashcat_a5_table_generator_tpu_torch.models import attack as t_attack
from hashcat_a5_table_generator_tpu_torch.ops import packing as t_packing
from hashcat_a5_table_generator_tpu_torch.runtime import env as t_env
from hashcat_a5_table_generator_tpu_torch.runtime.sweep import (
    Sweep,
    SweepConfig,
)
from hashcat_a5_table_generator_tpu_torch.tables.compile import (
    compile_table as t_compile,
)
from hashcat_a5_table_generator_tpu_torch.tables.layouts import get_layout

#: name -> (layout, mode, words): a match plan, a substitute-all plan, a
#: cascade-closed one (qwerty-azerty -s) and german's "sss" words, whose
#: geometry refuses piece emission (a cached None).
PLANS = {
    "match": ("qwerty-cyrillic", "default",
              [b"password", b"qwerty", b"zx", b"hello19"]),
    "suball": ("qwerty-cyrillic", "suball",
               [b"banana", b"mississippi", b"zz", b"test"]),
    "closed": ("qwerty-azerty", "suball",
               [b"aqua", b"zwzw", b"qazwsx", b"mama"]),
    "refused": ("german", "default", [b"strasssse", b"sss", b"masse"]),
}


def plan_pair(name):
    layout, mode, words = PLANS[name]
    sub = get_layout(layout).to_substitution_map()
    jp = j_attack.build_plan(j_attack.AttackSpec(mode=mode),
                             j_compile(sub), j_packing.pack_words(words))
    tp = t_attack.build_plan(t_attack.AttackSpec(mode=mode),
                             t_compile(sub), t_packing.pack_words(words))
    return (jp, j_compile(sub)), (tp, t_compile(sub))


def entries(d):
    return sorted(n for n in os.listdir(d) if n.endswith(".npz"))


@pytest.mark.parametrize("name", sorted(PLANS))
def test_cache_keys_equal_reference(name, tmp_path):
    """Each package writes its entry under the other's key."""
    (jp, jct), (tp, tct) = plan_pair(name)
    js = j_packing.piece_schema_for(jp, jct, cache_dir=str(tmp_path / "j"))
    ts = t_packing.piece_schema_for(tp, tct, cache_dir=str(tmp_path / "t"))
    assert (ts is None) == (name == "refused")
    assert_schemas_equal(js, ts)
    assert entries(tmp_path / "t") == entries(tmp_path / "j")
    assert len(entries(tmp_path / "t")) == 1


@pytest.mark.parametrize("writer", ["j", "t"])
@pytest.mark.parametrize("name", sorted(PLANS))
def test_a_cache_written_by_one_package_is_read_by_the_other(name, writer,
                                                             tmp_path):
    (jp, jct), (tp, tct) = plan_pair(name)
    cache = str(tmp_path / "cache")
    if writer == "j":
        want = j_packing.piece_schema_for(jp, jct, cache_dir=cache)
        before = t_packing.schema_cache_stats()
        got = t_packing.piece_schema_for(tp, tct, cache_dir=cache)
        after = t_packing.schema_cache_stats()
    else:
        want = t_packing.piece_schema_for(tp, tct, cache_dir=cache)
        before = j_packing.schema_cache_stats()
        got = j_packing.piece_schema_for(jp, jct, cache_dir=cache)
        after = j_packing.schema_cache_stats()
    assert after["hits"] - before["hits"] == 1
    assert after["misses"] == before["misses"]
    assert after["bytes_read"] > before["bytes_read"]
    assert_schemas_equal(want, got)
    # A loaded schema equals a freshly built one, array for array.
    (_jp2, _), (tp2, tct2) = plan_pair(name)
    assert_schemas_equal(t_packing.piece_schema_for(tp2, tct2), got)


def test_version_mismatch_and_corrupt_entries_are_misses(tmp_path,
                                                         monkeypatch):
    (_j, _jct), (tp, tct) = plan_pair("closed")
    cache = str(tmp_path / "cache")
    t_packing.piece_schema_for(tp, tct, cache_dir=cache)
    (name,) = entries(cache)
    key, path = name[:-4], os.path.join(cache, name)
    whole = open(path, "rb").read()
    s0 = t_packing.schema_cache_stats()
    monkeypatch.setattr(t_packing, "SCHEMA_CACHE_VERSION", 3)
    assert t_packing.load_piece_schema(cache, key) == (False, None)
    monkeypatch.undo()
    hit, schema = t_packing.load_piece_schema(cache, key)
    assert hit and schema is not None
    # A header that is not JSON: a miss in both packages.
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    arrays["header"] = np.frombuffer(b"{not json", np.uint8)
    np.savez(path, **arrays)
    assert t_packing.load_piece_schema(cache, key) == (False, None)
    assert j_packing.load_piece_schema(cache, key) == (False, None)
    # A truncated file: a miss here (the reference's reader raises
    # zipfile.BadZipFile on it).
    open(path, "wb").write(whole[: len(whole) // 2])
    assert t_packing.load_piece_schema(cache, key) == (False, None)
    s1 = t_packing.schema_cache_stats()
    assert s1["misses"] - s0["misses"] == 3
    assert s1["hits"] - s0["hits"] == 1
    # A rebuild overwrites the entry with a whole one, which the
    # reference reads.
    (_j, _jct), (tp2, tct2) = plan_pair("closed")
    t_packing.piece_schema_for(tp2, tct2, cache_dir=cache)
    assert j_packing.load_piece_schema(cache, key)[0]


def test_the_cap_evicts_the_oldest_atime_first(tmp_path):
    """Both packages evict the same entries of one directory."""
    for pkg in ("t", "j"):
        d = tmp_path / pkg
        d.mkdir()
        for i in range(4):
            (d / f"e{i}.npz").write_bytes(b"x" * (300 << 10))
            # atime order: e2, e0, e3, e1 (oldest first)
            at = {2: 1000, 0: 2000, 3: 3000, 1: 4000}[i]
            os.utime(d / f"e{i}.npz", (at, at))
        (d / "other.txt").write_bytes(b"y" * (2 << 20))  # not an entry
    mod = {"t": t_packing, "j": j_packing}
    got = {pkg: mod[pkg].enforce_schema_cache_cap(str(tmp_path / pkg), 0.7)
           for pkg in ("t", "j")}
    assert got == {"t": 2, "j": 2}
    assert entries(tmp_path / "t") == entries(tmp_path / "j") == [
        "e1.npz", "e3.npz"]
    assert t_packing.enforce_schema_cache_cap(str(tmp_path / "t"), 1) == 0


def test_env_knobs_match_reference(monkeypatch, capsys):
    import hashcat_a5_table_generator_tpu.runtime.env as j_env

    for val, want in (("", None), ("12.5", 12.5), ("-3", None),
                      ("lots", None)):
        monkeypatch.setenv("A5GEN_SCHEMA_CACHE_MAX_MB", val)
        assert t_env.schema_cache_max_mb() == j_env.schema_cache_max_mb() \
            == want
    err = capsys.readouterr().err
    assert "unrecognized A5GEN_SCHEMA_CACHE_MAX_MB='lots'" in err
    monkeypatch.setenv("A5GEN_SCHEMA_CACHE", "/some/dir")
    assert t_env.schema_cache_dir() == j_env.schema_cache_dir() == \
        "/some/dir"


@pytest.mark.parametrize("chunk", ["7", "off"])
@pytest.mark.parametrize("mode", ["default", "reverse", "suball",
                                  "suball-reverse"])
def test_cli_stdout_with_the_cache_equals_reference(mode, chunk, tmp_path,
                                                    capsysbinary):
    """The reference CLI fills a cache; the port's CLI runs on it (hits
    only) and on a cache of its own, and prints the reference's stdout
    each time."""
    argv = write_inputs(tmp_path, mode) + [
        "--digests", str(tmp_path / "d.txt"), "--lanes", "256",
        "--blocks", "16", "--stream-chunk-words", chunk]
    jc, tc = str(tmp_path / "jc"), str(tmp_path / "tc")
    rc, want, err = run("j", argv + ["--schema-cache", jc], capsysbinary)
    assert rc == 0, err
    s0 = t_packing.schema_cache_stats()
    rc, got, err = run("t", argv + ["--schema-cache", jc], capsysbinary)
    s1 = t_packing.schema_cache_stats()
    assert rc == 0 and got == want, err
    assert s1["misses"] == s0["misses"] and s1["hits"] > s0["hits"]
    rc, got, err = run("t", argv + ["--schema-cache", tc,
                                    "--schema-cache-max-mb", "64"],
                       capsysbinary)
    assert rc == 0 and got == want, err
    assert entries(tc) == entries(jc)


def test_sweep_result_deltas_equal_reference(tmp_path):
    layout, mode, words = PLANS["closed"]
    sub = get_layout(layout).to_substitution_map()
    rng = np.random.default_rng(3)
    words = words + [bytes(rng.integers(97, 123, size=6, dtype=np.uint8))
                     for _ in range(30)]
    got = {}
    for pkg, sweep_cls, cfg_cls, spec_cls in (
            ("t", Sweep, SweepConfig, t_attack.AttackSpec),
            ("j", JSweep, JConfig, j_attack.AttackSpec)):
        kw = dict(lanes=256, num_blocks=16, stream_chunk_words=8,
                  schema_cache=str(tmp_path / pkg))
        if pkg == "t":
            kw["device"] = "cpu"
        runs = []
        for _ in range(2):
            res = sweep_cls(spec_cls(mode=mode), sub, words, [b"\0" * 16],
                            config=cfg_cls(**kw)).run_crack()
            runs.append(res.schema_cache)
        got[pkg] = runs
    assert got["t"] == got["j"]
    first, second = got["t"]
    assert first["misses"] == second["hits"] >= 4
    assert "hits" not in first and "misses" not in second
    # Without a cache the field stays empty, as in the reference.
    res = Sweep(t_attack.AttackSpec(mode=mode), sub, words, [b"\0" * 16],
                config=SweepConfig(device="cpu", lanes=256,
                                   num_blocks=16)).run_crack()
    assert res.schema_cache == {}
