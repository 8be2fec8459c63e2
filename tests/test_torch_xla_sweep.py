"""Crack sweeps on the XLA expand + hash route of the PyTorch/CUDA package
against the JAX reference, on the CPU: buckets the fused kernels refuse (a
70-byte line, a 30-letter line, nine options per key, a 5-byte value) in
default, ``-r``, ``-s`` and ``-s -r`` mode give byte-identical CLI stdout
and equal hit streams; ``A5GEN_PALLAS`` routes as the reference's does,
and ``A5GEN_PALLAS=off`` leaves stdout unchanged; runs that exited 2
before the route existed now crack every plant once."""

import numpy as np
import pytest

import hashcat_a5_table_generator_tpu.cli as j_cli
import hashcat_a5_table_generator_tpu.ops.pallas_expand as j_pe
import hashcat_a5_table_generator_tpu.runtime.env as j_env
from hashcat_a5_table_generator_tpu.models.attack import AttackSpec as JSpec
from hashcat_a5_table_generator_tpu.models.attack import build_plan as j_plan
from hashcat_a5_table_generator_tpu.models.attack import (
    decode_variant as j_decode,
)
from hashcat_a5_table_generator_tpu.ops.packing import pack_words as j_pack
from hashcat_a5_table_generator_tpu.oracle.engines import (
    iter_candidates as j_oracle,
)
from hashcat_a5_table_generator_tpu.tables.compile import compile_table
from hashcat_a5_table_generator_tpu_torch import cli as t_cli
from hashcat_a5_table_generator_tpu_torch.models.attack import AttackSpec
from hashcat_a5_table_generator_tpu_torch.ops import buffer_hash as bh
from hashcat_a5_table_generator_tpu_torch.ops import expand_matches as t_em
from hashcat_a5_table_generator_tpu_torch.ops import fused_expand as fe
from hashcat_a5_table_generator_tpu_torch.runtime import env as t_env
from hashcat_a5_table_generator_tpu_torch.runtime.sinks import potfile_line
from hashcat_a5_table_generator_tpu_torch.runtime.sweep import (
    Sweep,
    SweepConfig,
)
from hashcat_a5_table_generator_tpu_torch.tables.layouts import (
    emit_table,
    get_layout,
)
from hashcat_a5_table_generator_tpu_torch.tables.parser import load_tables
from hashcat_a5_table_generator_tpu_torch.utils.digests import HOST_DIGEST

CYR = get_layout("qwerty-cyrillic").to_substitution_map()
GEOMETRY = dict(lanes=256, num_blocks=16)
GEOMETRY_ARGV = ["--lanes", "256", "--blocks", "16"]
#: Nine options on ``a`` (one of them 5 bytes): past the fused kernels'
#: 8 options per key and 4-byte values.
LEET9 = {b"a": [bytes([c]) for c in b"4@^&*123"] + [b"/-\\-"],
         b"s": [b"$"], b"e": [b"3"]}
LONG_LINE = b"0123456789" * 6 + b"passwords!"  # 70 bytes
THIRTY = b"qwertyuiopasdfghjklzxcvbnmqwer"  # 30 letters: 30 slots


def recipe_words(n=30, seed=21):
    """Seeded 4-9 letter words, some with trailing digits."""
    rng = np.random.default_rng(seed)
    words = []
    for _ in range(n):
        w = bytes(rng.integers(ord("a"), ord("z") + 1,
                               size=int(rng.integers(4, 10)),
                               dtype=np.uint8))
        words.append(w + b"19" * int(rng.integers(0, 2)))
    return words


WORDS = recipe_words() + [LONG_LINE, THIRTY, b"sassafras", b"seesaw"]


def plant(words, sub, flags, algo, every=3, seed=22):
    """Every ``every``-th word's middle candidate (and the last four
    words'), plus decoys: ``(planted candidates, digests)``.  Candidates
    come from the reference's own plan through its ``decode_variant`` (the
    oracle's DFS for its fallback words), so a plant is a candidate the
    reference's device route emits."""
    mx = int(flags[flags.index("-x") + 1]) if "-x" in flags else 15
    mn = int(flags[flags.index("-m") + 1]) if "-m" in flags else 0
    mode = ("suball" if "-s" in flags else "default") + (
        "-reverse" if "-s" in flags and "-r" in flags else "")
    if mode == "default" and "-r" in flags:
        mode = "reverse"
    spec = JSpec(mode=mode, algo=algo, min_substitute=mn, max_substitute=mx)
    ct = compile_table(sub)
    picked = words[::every] + words[-4:]
    plan = j_plan(spec, ct, j_pack(picked))
    planted = []
    for w in range(plan.batch):
        if plan.fallback[w]:
            cands = list(j_oracle(picked[w], sub, mn, mx,
                                  substitute_all=True,
                                  reverse=mode == "suball-reverse"))
            planted += cands[len(cands) // 2:][:1]
            continue
        total = plan.n_variants[w]
        for r in list(range(total // 2, total)) + list(range(total // 2)):
            try:
                planted.append(j_decode(plan, ct, spec, w, r))
                break
            except ValueError:
                continue
    rng = np.random.default_rng(seed)
    n = 20 if algo == "sha1" else 16
    decoys = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
              for _ in range(30)]
    return planted, [HOST_DIGEST[algo](c) for c in planted] + decoys


def write_inputs(tmp_path, words, digests, tables):
    (tmp_path / "words.txt").write_bytes(b"\n".join(words) + b"\n")
    (tmp_path / "left.txt").write_text("".join(d.hex() + "\n"
                                               for d in digests))
    paths = []
    for name, table in tables.items():
        path = tmp_path / f"{name}.table"
        if isinstance(table, str):
            emit_table(get_layout(table), str(path))
        else:
            path.write_bytes(b"".join(k + b"=" + v + b"\n"
                                      for k, vs in table.items()
                                      for v in vs))
        paths += ["-t", str(path)]
    return [str(tmp_path / "words.txt"), *paths, "--backend", "device",
            "--digests", str(tmp_path / "left.txt")]


#: (flags, algo) per mode; the merged cyrillic + leet9 table gives ``a``
#: ten options, so the buckets take the XLA route (but in reverse modes,
#: where ``a`` keeps one option and short buckets may take the piece
#: kernel); ``-x 2`` keeps the 30-letter line's keyspace small.
MODES = {
    "default": (["-x", "2"], "md5"),
    "reverse": (["-r", "-x", "2"], "ntlm"),
    "suball": (["-s", "-x", "2"], "sha1"),
    "suball-reverse": (["-s", "-r", "-x", "2"], "md4"),
}
TABLES = {"cyr": "qwerty-cyrillic", "leet9": LEET9}


def expected_lines(planted, algo):
    return sorted({potfile_line(HOST_DIGEST[algo](c).hex(), c)
                   for c in planted})


def contract(tmp_path, flags, algo, words=WORDS, tables=TABLES):
    """CLI arguments over seeded inputs with planted digests:
    ``(argv, merged table, planted candidates, digests)``."""
    argv = write_inputs(tmp_path, words, [], tables)
    sub = load_tables(argv[1:1 + 2 * len(tables)][1::2])
    planted, digests = plant(words, sub, flags, algo)
    argv = write_inputs(tmp_path, words, digests, tables) + [
        "--algo", algo, *flags, *GEOMETRY_ARGV]
    return argv, sub, planted, digests


@pytest.mark.parametrize("mode", ["default", "suball"])
def test_xla_route_cli_stdout_equals_reference(mode, tmp_path,
                                               capsysbinary):
    """Every bucket on the XLA route (ten options on ``a``): the port's
    CLI prints the reference CLI's stdout byte for byte, every plant
    once, through the buffer hash of the mode's hash."""
    flags, algo = MODES[mode]
    argv, _sub, planted, _digests = contract(tmp_path, flags, algo)
    assert j_cli.main(argv) == 0
    want = capsysbinary.readouterr().out
    plain = bh.PLAIN_CALLS
    assert t_cli.main(argv + ["--device", "cpu"]) == 0
    got = capsysbinary.readouterr()
    assert got.out == want
    lines = [ln + b"\n" for ln in got.out.splitlines()]
    assert sorted(set(lines)) == expected_lines(planted, algo)
    assert b"3 on the XLA expand + hash route" in got.err
    assert f"buffer_hash/{algo}".encode() in got.err
    assert bh.PLAIN_CALLS > plain


def reference_hits(words, sub, spec, digests):
    """The reference's hit stream over one plan of ``words``, from its own
    host functions: every rank its ``decode_variant`` accepts (the ranks
    its device route emits) whose digest is listed, and every oracle
    candidate of a fallback word (rank = DFS index), in word order."""
    ct = compile_table(sub)
    plan = j_plan(spec, ct, j_pack(words))
    want = set(digests)
    hits = []
    for w in range(plan.batch):
        if plan.fallback[w]:
            cands = enumerate(j_oracle(
                words[w], sub, spec.min_substitute, spec.max_substitute,
                substitute_all=spec.mode.startswith("suball"),
                reverse=spec.mode.endswith("reverse")))
        else:
            cands = []
            for r in range(plan.n_variants[w]):
                try:
                    cands.append((r, j_decode(plan, ct, spec, w, r)))
                except ValueError:
                    continue
        hits += [(int(plan.index[w]), r, c) for r, c in cands
                 if HOST_DIGEST[spec.algo](c) in want]
    return hits


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("table", ["cyr-leet9", "leet9"])
def test_xla_route_sweep_hits_equal_reference(mode, table, tmp_path):
    """One plan over every word (token width 72, 30 slots), on the XLA
    route: the port's hit stream ``(word, rank, candidate)`` equals the
    reference's, rank for rank; leet9 alone runs the full window (no
    ``-x``), with the pair tier where its schema allows."""
    flags, algo = MODES[mode]
    tables = TABLES if table == "cyr-leet9" else {"leet9": LEET9}
    words = WORDS if table == "cyr-leet9" else [
        w for w in WORDS if w != THIRTY]
    if table == "leet9":
        flags = [f for f in flags if f not in ("-x", "2")]
    _argv, sub, planted, digests = contract(tmp_path, flags, algo, words,
                                            tables)
    mx = 2 if "-x" in flags else 15
    spec = AttackSpec(mode=mode, algo=algo, max_substitute=mx)
    sweep = Sweep(spec, sub, words, digests,
                  SweepConfig(device="cpu", **GEOMETRY))
    assert sweep.route == "xla"
    got = sweep.run_crack()
    want = reference_hits(words, sub, JSpec(mode=mode, algo=algo,
                                            max_substitute=mx), digests)
    assert [(h.word_index, h.variant_rank, h.candidate)
            for h in got.hits] == want
    assert {h.candidate for h in got.hits} == set(planted)
    assert got.kernels == {f"buffer_hash/{algo}": got.superstep["launches"]}
    assert got.routes == {"xla": 1}


@pytest.mark.parametrize("value", [None, "", "expand", "off", "0", "xla",
                                   "none", "1", "Off", "pallas"])
def test_pallas_env_equals_reference(value, monkeypatch, capsys):
    """``A5GEN_PALLAS``: the port's route gate and its warning follow the
    reference's ``enabled_by_env`` / ``opts_for`` for every spelling (a
    fused kernel exactly where the reference's gate, its TPU probe aside,
    takes the plan; one warning for an unknown value, then the
    default)."""
    if value is None:
        monkeypatch.delenv("A5GEN_PALLAS", raising=False)
    else:
        monkeypatch.setenv("A5GEN_PALLAS", value)
    monkeypatch.setattr(j_env, "_WARNED", set())
    monkeypatch.setattr(t_env, "_WARNED", set())
    jct, tct = compile_table(CYR), compile_table(CYR)
    words = [b"password", b"qwerty"]
    for _ in range(2):
        want_on = j_pe.enabled_by_env()
        want_err = capsys.readouterr().err
        assert fe.enabled_by_env() == want_on
        got_err = capsys.readouterr().err
        assert ("unrecognized A5GEN_PALLAS" in got_err) == \
            ("unrecognized A5GEN_PALLAS" in want_err)
    assert want_err == "" and got_err == ""  # once per spelling
    for words_ in (words, words + [LONG_LINE]):
        jplan = j_plan(JSpec(), jct, j_pack(words_))
        tplan = j_plan(JSpec(), tct, j_pack(words_))
        k = j_pe.opts_for_config(JSpec(), jplan, jct, block_stride=128,
                                 num_blocks=8, require_tpu=False)
        want = k if want_on else None
        assert fe.opts_for(AttackSpec(), tplan, tct) == want
        sweep = Sweep(AttackSpec(), CYR, words_, [bytes(16)],
                      SweepConfig(device="cpu", **GEOMETRY))
        assert (sweep.route == "xla") == (want is None)


#: Kernel-route runs and their ``A5GEN_PALLAS=off`` twins: (table, flags,
#: algo, kernel tier the default run takes).
TWINS = {
    "cyrillic-pair": ("qwerty-cyrillic", [], "md5", "piece_pair"),
    "czech-ntlm-digits": ("czech", [], "ntlm", "piece_digits"),
    "cyrillic-windowed-sha1": ("qwerty-cyrillic", ["-x", "2"], "sha1",
                               "piece_windowed"),
    "azerty-s-closed": ("qwerty-azerty", ["-s"], "md5",
                        "piece_suball_closed"),
    "german-bytescan": ("german", [], "md4", "bytescan_scalar"),
}
TWIN_WORDS = [b"password", b"sesame", b"strasse", b"schlosssee", b"aqzwm",
              b"maqa", b"qaqa,", b"cesky", b"zluty", b"kun", b"aerial"]


@pytest.mark.parametrize("case", sorted(TWINS))
def test_pallas_off_stdout_equals_kernel_route(case, tmp_path, capsysbinary,
                                               monkeypatch):
    """Every shipped tier's run and its ``A5GEN_PALLAS=off`` twin on the
    XLA route print the same stdout."""
    layout, flags, algo, tier = TWINS[case]
    argv, _sub, planted, _d = contract(tmp_path, flags, algo, TWIN_WORDS,
                                       {"t": layout})
    monkeypatch.delenv("A5GEN_PALLAS", raising=False)
    assert t_cli.main(argv + ["--device", "cpu"]) == 0
    want = capsysbinary.readouterr()
    assert tier.encode() in want.err
    assert planted
    monkeypatch.setenv("A5GEN_PALLAS", "off")
    assert t_cli.main(argv + ["--device", "cpu"]) == 0
    got = capsysbinary.readouterr()
    assert got.out == want.out
    assert f"buffer_hash/{algo}".encode() in got.err
    assert tier.encode() not in got.err
    lines = [ln + b"\n" for ln in got.out.splitlines()]
    assert sorted(set(lines)) == expected_lines(planted, algo)


#: Runs that exited 2 before the XLA route (the fused kernels refuse a
#: bucket): (words, extra tables, flags).
NOW_RUN = {
    "long-line": ([LONG_LINE, b"pass", b"1" * 65 + b"ab"], {}, []),
    "25-letter-line": ([b"qwertyuiop" * 2 + b"asdfg", b"sesame"], {},
                       ["-x", "2"]),
    "many-slots-40": ([b"qwertyuiop" * 4, b"sesame"], {}, ["-x", "2"]),
    "nine-options": ([b"password", b"sesame"], {"leet9": LEET9}, []),
    "nine-options-s": ([b"banana", b"sesame"], {"leet9": LEET9}, ["-s"]),
    "4-hash-blocks": ([b"1" * 3 + b"0" * 180, b"pass"],
                      {"wide": {b"1": [b"\xf0\x9f\x98\x80"]}},
                      ["--buckets", "16,32,64,128"]),
    "win-k2-11": ([b"qwertyuiopas", b"abc"], {}, ["-m", "9", "-x", "9"]),
}


@pytest.mark.parametrize("case", sorted(NOW_RUN))
def test_runs_refused_before_the_xla_route_now_crack(case, tmp_path,
                                                     capsysbinary,
                                                     monkeypatch):
    """A run with a bucket the fused kernels refuse (a line over 64 bytes,
    more than 24 slots, nine options per key, four hash blocks, eleven DP
    columns) exits 0 and prints every plant once."""
    words, extra, flags = NOW_RUN[case]
    if case == "win-k2-11":
        monkeypatch.setattr(t_em, "WINDOWED_MAX_SUBST", 9)
    tables = {"cyr": "qwerty-cyrillic", **extra}
    argv, _sub, planted, _d = contract(tmp_path, flags, "md5", words,
                                       tables)
    assert t_cli.main(argv + ["--device", "cpu"]) == 0
    got = capsysbinary.readouterr()
    lines = [ln + b"\n" for ln in got.out.splitlines()]
    assert len(lines) == len(set(lines))
    assert sorted(lines) == expected_lines(planted, "md5")
    assert b"on the XLA expand + hash route" in got.err
