"""The CLI of the PyTorch/CUDA package in reverse (``-r``), substitute-all
(``-s``) and substitute-all reverse (``-s -r``) mode against the JAX
reference CLI, on the CPU: stdout byte-identical (hits in the reference's
order, oracle-fallback hits included), the same summary and word-routing
lines on stderr, for every table and hash of the slice and ``-m 0`` in
each mode."""

import pytest
from test_torch_suball_sweep import make_words, planted

import hashcat_a5_table_generator_tpu.cli as j_cli
import hashcat_a5_table_generator_tpu_torch.cli as t_cli
from hashcat_a5_table_generator_tpu_torch.ops import fused_expand as fe
from hashcat_a5_table_generator_tpu_torch.tables.layouts import (
    emit_table,
    get_layout,
)

GEOMETRY_ARGV = ["--lanes", "256", "--blocks", "16"]
MODE_ARGV = {"default": [], "reverse": ["-r"], "suball": ["-s"],
             "suball-reverse": ["-s", "-r"]}


#: CLI cases: (layout, mode, algo, extra argv).  ``-m 0`` is explicit in
#: every mode (default mode bumps it to 1; the others emit the word).
CLI_CASES = {
    "cyrillic-s": ("qwerty-cyrillic", "suball", "md5", ["-m", "0"]),
    "azerty-s": ("qwerty-azerty", "suball", "md5", ["-m", "0"]),
    "azerty-qwerty-s": ("azerty-qwerty", "suball", "md5", []),
    "czech-s-r-ntlm": ("czech", "suball-reverse", "ntlm", ["-m", "0"]),
    "cyrillic-s-x2-sha1": ("qwerty-cyrillic", "suball", "sha1",
                           ["-x", "2"]),
    "cyrillic-r-pair-on": ("qwerty-cyrillic", "reverse", "md5",
                           ["-m", "0", "--pair", "on"]),
    "cyrillic-r-pair-off": ("qwerty-cyrillic", "reverse", "md5",
                            ["-m", "0", "--pair", "off"]),
    "czech-default-m0": ("czech", "default", "md4", ["-m", "0"]),
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_cli_stdout_matches_reference_cli(case, tmp_path, capsysbinary):
    layout, mode, algo, extra = CLI_CASES[case]
    sub = get_layout(layout).to_substitution_map()
    # One length bucket (one reference compile) but in the bucketed case.
    words = make_words(seed=30 + sorted(CLI_CASES).index(case),
                       long_line=case == "cyrillic-s")
    mx = 2 if "-x" in extra else 15
    mn = 1 if mode == "default" else 0
    digests = planted(words, sub, mode, algo, mn=mn, mx=mx)
    (tmp_path / "words.txt").write_bytes(b"\n".join(words) + b"\n")
    (tmp_path / "left.txt").write_text("".join(d.hex() + "\n"
                                               for d in digests))
    emit_table(get_layout(layout), str(tmp_path / "t.table"))
    argv = [str(tmp_path / "words.txt"), "-t", str(tmp_path / "t.table"),
            "--backend", "device", "--algo", algo, "--digests",
            str(tmp_path / "left.txt"), *GEOMETRY_ARGV, *MODE_ARGV[mode],
            *extra]
    assert j_cli.main(argv) == 0
    want = capsysbinary.readouterr()
    before = {k: v for k, v in fe.LAUNCHES.items()}
    assert t_cli.main(argv + ["--device", "cpu"]) == 0
    got = capsysbinary.readouterr()
    assert got.out == want.out
    assert len(got.out.splitlines()) >= len(digests) - 30
    summary = [ln for ln in want.err.splitlines() if b"candidates hashed"
               in ln]
    assert summary and summary[0] in got.err
    routing = [ln for ln in want.err.splitlines() if b"word routing" in ln]
    assert routing == [ln for ln in got.err.splitlines()
                       if b"word routing" in ln]
    assert fe.LAUNCHES == before  # the CPU runs the plain version
    if case == "cyrillic-r-pair-on":
        assert b"pair K=2" in got.err


@pytest.mark.parametrize("flags", [["-s"], ["-s", "-r"]],
                         ids=["s", "s-r"])
def test_cli_refuses_off_kernel_suball_plans(flags, tmp_path, capsys,
                                             monkeypatch):
    """A substitute-all plan the piece kernel takes but whose schema its
    descriptor table cannot hold (``MAX_GROUPS`` lowered to 0 here) is no
    longer refused: it takes the XLA expand + hash route (no piece kernel,
    plain or not) and hashes the reference's 4 candidates; in ``-s -r``
    the same table's first options leave one per key, and the run cracks
    on the piece kernel.  (Nine options per key, which this test refused
    before, take the XLA route too: ``test_torch_xla_sweep.py``.)"""
    (tmp_path / "t.table").write_bytes(
        b"".join(b"a=" + bytes([c]) + b"\n" for c in b"123456789"))
    (tmp_path / "words.txt").write_bytes(b"banana\nsesame\n")
    (tmp_path / "left.txt").write_text("00" * 16 + "\n")
    if flags == ["-s"]:
        (tmp_path / "t.table").write_bytes(b"a=1\n")
        monkeypatch.setattr(fe, "MAX_GROUPS", 0)
    launches, plain = dict(fe.LAUNCHES), fe.PLAIN_CALLS
    rc = t_cli.main([str(tmp_path / "words.txt"), "-t",
                     str(tmp_path / "t.table"), "--backend", "device",
                     "--digests", str(tmp_path / "left.txt"), "--device",
                     "cpu", *GEOMETRY_ARGV, *flags])
    out = capsys.readouterr()
    if flags == ["-s"]:
        assert rc == 0 and out.out == ""
        assert "0 hits, 4 candidates hashed" in out.err
        assert "1 on the XLA expand + hash route" in out.err
        assert fe.LAUNCHES == launches and fe.PLAIN_CALLS == plain
    else:
        assert rc == 0 and fe.PLAIN_CALLS > plain
        assert "0 hits, 4 candidates hashed" in out.err
