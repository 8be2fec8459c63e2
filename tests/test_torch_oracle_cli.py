"""The oracle backend of the PyTorch/CUDA package's CLI (the default
backend) against the JAX reference's CLI, on the CPU: the same inputs,
made from seeds, through both ``main`` functions; stdout byte for byte,
and crack mode's ``N hits`` on stderr, in default, ``-r``, ``-s`` and
``-s -r`` mode x candidates and crack x the native engines and
``A5_NATIVE=0`` x ``--threads 1`` and ``3``; ``-m``/``-x`` windows,
``--hex-unsafe``, ``--bug-compat`` under both backends, the oracle's
"no effect" warnings, ``--emit-table`` (stdout and ``--output``) and
``--list-layouts`` for every layout, and ``--output`` (F5: the
``--emit-table`` file only, never the candidate or hit stream)."""

import hashlib

import numpy as np
import pytest

import hashcat_a5_table_generator_tpu.cli as j_cli
from hashcat_a5_table_generator_tpu_torch import cli as t_cli
from hashcat_a5_table_generator_tpu_torch.native import oracle_engine
from hashcat_a5_table_generator_tpu_torch.oracle.engines import (
    iter_candidates,
)
from hashcat_a5_table_generator_tpu_torch.tables.layouts import (
    BUILTIN_LAYOUTS,
    DERIVED_LAYOUTS,
    emit_table,
    get_layout,
)
from hashcat_a5_table_generator_tpu_torch.utils.digests import HOST_DIGEST

MODES = {
    "default": [],
    "reverse": ["-r"],
    "suball": ["-s"],
    "suball-reverse": ["-s", "-r"],
}
#: Layout -> (hash of its crack runs, seed of its words).
LAYOUTS = {"qwerty-cyrillic": ("md5", 1), "qwerty-azerty": ("sha1", 2),
           "german": ("ntlm", 3)}
ALL_LAYOUTS = sorted(BUILTIN_LAYOUTS) + sorted(DERIVED_LAYOUTS)


def make_words(layout, seed, n=16):
    """Short words over the layout's key bytes and a few others, then the
    line-format edges: an empty line, high bytes, a lone ``\\r`` inside a
    word (qwerty-azerty's ``m``/``,``/``;`` hazard words go to every
    mode)."""
    sub = get_layout(layout).to_substitution_map()
    alphabet = sorted(set(b"".join(sub)) | set(b"xy19"))
    rng = np.random.default_rng(seed)
    words = [bytes(rng.choice(alphabet, size=int(rng.integers(1, 7))
                              ).tolist()) for _ in range(n)]
    return words + [b"", b"\xe9t\xe9s", b"a\rb", b"m,;aq"]


def write_inputs(tmp_path, layout, words, algo, mode_flags):
    """Wordlist (LF and CRLF lines, an unterminated tail), table, and a
    digest list: every third word's middle oracle candidate plus
    decoys."""
    lines = [w + (b"\r\n" if i % 3 == 1 else b"\n")
             for i, w in enumerate(words)]
    (tmp_path / "w.txt").write_bytes(b"".join(lines)[:-1])
    table = tmp_path / f"{layout}.table"
    emit_table(get_layout(layout), str(table))
    sub = get_layout(layout).to_substitution_map()
    digests = [hashlib.sha256(b"decoy%d" % i).digest()[
        :len(HOST_DIGEST[algo](b""))] for i in range(20)]
    for w in words[::3]:
        cands = list(iter_candidates(
            w, sub, 0, 15, substitute_all="-s" in mode_flags,
            reverse="-r" in mode_flags, bug_compat=False))
        if cands:
            digests.append(HOST_DIGEST[algo](cands[len(cands) // 2]))
    (tmp_path / "left.txt").write_text(
        "".join(d.hex() + "\n" for d in digests))
    return [str(tmp_path / "w.txt"), "-t", str(table)]


def run(cli, argv, capsysbinary):
    rc = cli.main(argv)
    got = capsysbinary.readouterr()
    return rc, got.out, got.err


def hits_line(err: bytes) -> list:
    return [ln for ln in err.splitlines() if ln.endswith(b" hits")]


class _Counted:
    """Counts the NativeDefaultOracle tables this process builds."""

    def __init__(self, monkeypatch):
        self.n = 0
        real = oracle_engine.NativeDefaultOracle.__init__

        def init(eng, sub_map):
            self.n += 1
            real(eng, sub_map)

        monkeypatch.setattr(oracle_engine.NativeDefaultOracle, "__init__",
                            init)


_REFERENCE: dict = {}


@pytest.mark.parametrize("threads", [1, 3])
@pytest.mark.parametrize("engine", ["native", "A5_NATIVE=0"])
@pytest.mark.parametrize("crack", [False, True], ids=["candidates",
                                                      "crack"])
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_oracle_cli_equals_reference(layout, mode, crack, engine, threads,
                                     tmp_path, capsysbinary, monkeypatch):
    """The default command line (no ``--backend``): stdout byte-identical
    to the reference CLI's, crack's ``N hits`` equal; the native arm
    builds the C++ engine where ``default_engine_eligible`` admits the
    run, the ``A5_NATIVE=0`` arm never."""
    algo, seed = LAYOUTS[layout]
    argv = write_inputs(tmp_path, layout, make_words(layout, seed), algo,
                        MODES[mode]) + MODES[mode]
    if crack:
        argv += ["--algo", algo, "--digests", str(tmp_path / "left.txt")]
    key = (layout, mode, crack)
    if key not in _REFERENCE:
        _REFERENCE[key] = run(j_cli, argv, capsysbinary)
    j_rc, j_out, j_err = _REFERENCE[key]
    assert j_rc == 0 and j_out
    if engine != "native":
        monkeypatch.setenv("A5_NATIVE", "0")
    built = _Counted(monkeypatch)
    rc, out, err = run(t_cli, argv + ["--threads", str(threads)],
                       capsysbinary)
    assert rc == 0
    assert out == j_out
    assert hits_line(err) == hits_line(j_err)
    if crack:
        assert int(hits_line(err)[0].split()[0]) >= 3
    eligible = mode != "reverse" and engine == "native"
    assert (built.n > 0) == (eligible and threads == 1), built.n


@pytest.mark.parametrize("window", [("1", "2"), ("2", "3"), ("0", "0"),
                                    ("3", "15")], ids="-m{0[0]}-x{0[1]}".format)
@pytest.mark.parametrize("mode", sorted(MODES))
def test_windows_equal_reference(mode, window, tmp_path, capsysbinary):
    words = make_words("qwerty-cyrillic", 7)
    argv = write_inputs(tmp_path, "qwerty-cyrillic", words, "md5",
                        MODES[mode]) + MODES[mode] + [
        "-m", window[0], "-x", window[1]]
    want = run(j_cli, argv, capsysbinary)
    assert run(t_cli, argv, capsysbinary) == want


@pytest.mark.parametrize("threads", [1, 3])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_hex_unsafe_and_newline_values_stay_python(
        mode, threads, tmp_path, capsysbinary, monkeypatch):
    """``--hex-unsafe``, and a table value holding a newline, keep the
    Python engines (``default_engine_eligible`` refuses both in both
    packages): no native table is built, and the stream, ``$HEX[]``
    lines included, is the reference's."""
    words = make_words("qwerty-cyrillic", 8) + [b"zax", b"xyz"]
    argv = write_inputs(tmp_path, "qwerty-cyrillic", words, "md5",
                        MODES[mode]) + MODES[mode]
    (tmp_path / "nl.table").write_bytes(b"z=$HEX[0a]\nx=$HEX[0d]\n")
    nl = ["-t", str(tmp_path / "nl.table")]
    for extra in (["--hex-unsafe"], nl, nl + ["--hex-unsafe"]):
        want = run(j_cli, argv + extra, capsysbinary)
        built = _Counted(monkeypatch)
        got = run(t_cli, argv + extra + ["--threads", str(threads)],
                  capsysbinary)
        assert got[:2] == want[:2]
        assert built.n == 0
    assert b"$HEX[" in want[1] or mode.endswith("reverse")


def test_bug_compat_oracle_and_panic_vector(tmp_path, capsysbinary):
    """``-r --bug-compat``: the Q3 offset bug as the reference prints it;
    the panic vector (``abab`` under ``ab=X``, ``-m 2 -x 2``) raises
    ``ReferencePanic`` in both CLIs after the same stdout."""
    from hashcat_a5_table_generator_tpu.oracle.engines import (
        ReferencePanic as JPanic,
    )
    from hashcat_a5_table_generator_tpu_torch.oracle.engines import (
        ReferencePanic,
    )

    (tmp_path / "t.table").write_bytes(b"a=XY\nb=8\n")
    (tmp_path / "w.txt").write_bytes(b"aab\nbab\nba\nzz\n")
    argv = [str(tmp_path / "w.txt"), "-t", str(tmp_path / "t.table"),
            "-r", "--bug-compat"]
    for threads in ("1", "3"):
        want = run(j_cli, argv + ["--threads", threads], capsysbinary)
        assert run(t_cli, argv + ["--threads", threads],
                   capsysbinary) == want
    fixed = run(t_cli, argv[:-1], capsysbinary)
    assert fixed[1] != want[1]  # the bug shows in this stream
    (tmp_path / "t.table").write_bytes(b"ab=X\n")
    (tmp_path / "w.txt").write_bytes(b"zz\nabab\nab\n")
    panic = argv + ["-m", "2", "-x", "2"]
    with pytest.raises(JPanic):
        j_cli.main(panic)
    j_out = capsysbinary.readouterr().out
    with pytest.raises(ReferencePanic):
        t_cli.main(panic)
    assert capsysbinary.readouterr().out == j_out


def test_bug_compat_device_reroutes_reverse_to_oracle(tmp_path,
                                                      capsysbinary):
    """``--backend device --bug-compat -r`` runs the oracle with the
    reference's warning; with ``-s`` it warns "no effect" and the device
    sweep runs, its stream the reference's."""
    words = make_words("qwerty-cyrillic", 9)
    argv = write_inputs(tmp_path, "qwerty-cyrillic", words, "md5", [])
    for flags in (["-r"], ["-s"]):
        dev = argv + flags + ["--backend", "device", "--bug-compat",
                              "--lanes", "256", "--blocks", "16"]
        j_rc, j_out, j_err = run(j_cli, dev, capsysbinary)
        rc, out, err = run(t_cli, dev + ["--device", "cpu"], capsysbinary)
        assert (rc, out) == (j_rc, j_out) and out
        warning = [ln for ln in j_err.splitlines() if b"--bug-compat" in ln]
        assert warning and warning[0] in err.splitlines()
        assert (b"candidates written" in err) == (flags == ["-s"])


#: The reference oracle's stateless flags (they warn) and two it ignores.
ORACLE_FLAGS = [
    ["--checkpoint", "ck.json"], ["--no-resume"], ["--progress"],
    ["--devices", "2"], ["--profile", "prof"], ["--coordinator", "h:1"],
    ["--num-processes", "2"], ["--process-id", "0"], ["--giant-job"],
    ["--retries", "1"], ["--fetch-chunk", "4"], ["--metrics-json", "m.json"],
]


@pytest.mark.parametrize("extra", ORACLE_FLAGS, ids=lambda a: a[0])
def test_device_flags_under_the_oracle_warn_as_in_the_reference(
        extra, tmp_path, capsysbinary):
    words = make_words("german", 10)
    argv = write_inputs(tmp_path, "german", words, "ntlm", []) + extra
    argv += ["--algo", "ntlm", "--digests", str(tmp_path / "left.txt")]
    want = run(j_cli, argv, capsysbinary)
    got = run(t_cli, argv, capsysbinary)
    assert got == want and got[0] == 0
    warned = b"has no effect with --backend oracle" in got[2]
    assert warned == (extra[0] not in ("--fetch-chunk", "--metrics-json"))
    assert not (tmp_path / "m.json").exists()


def test_giant_job_needs_digests_as_in_the_reference(tmp_path, capsys):
    argv = write_inputs(tmp_path, "german", [b"strasse"], "md5", []) + [
        "--giant-job"]
    for cli in (j_cli, t_cli):
        with pytest.raises(SystemExit) as exc:
            cli.main(argv)
        assert exc.value.code == 2
        assert "--giant-job is crack mode only" in capsys.readouterr().err


@pytest.mark.parametrize("to_file", [False, True], ids=["stdout",
                                                         "output"])
@pytest.mark.parametrize("layout", ALL_LAYOUTS)
def test_emit_table_equals_reference(layout, to_file, tmp_path,
                                     capsysbinary):
    argv = ["--emit-table", layout]
    if to_file:
        want_rc, want_out, _ = run(
            j_cli, argv + ["--output", str(tmp_path / "j.table")],
            capsysbinary)
        rc, out, _ = run(
            t_cli, argv + ["--output", str(tmp_path / "t.table")],
            capsysbinary)
        assert (rc, out) == (want_rc, want_out) == (0, b"")
        want = (tmp_path / "j.table").read_bytes()
        assert (tmp_path / "t.table").read_bytes() == want and want
    else:
        want = run(j_cli, argv, capsysbinary)
        assert run(t_cli, argv, capsysbinary) == want and want[1]


def test_list_layouts_equals_reference(capsysbinary):
    want = run(j_cli, ["--list-layouts"], capsysbinary)
    assert run(t_cli, ["--list-layouts"], capsysbinary) == want
    assert want[1].count(b"\n") == len(ALL_LAYOUTS)


def test_unknown_layout_exits_2_as_in_the_reference(capsys):
    errs = []
    for cli in (j_cli, t_cli):
        with pytest.raises(SystemExit) as exc:
            cli.main(["--emit-table", "dvorak-klingon"])
        assert exc.value.code == 2
        errs.append(capsys.readouterr().err.splitlines()[-1])
    assert errs[0] == errs[1] and "dvorak-klingon" in errs[0]


@pytest.mark.parametrize("crack", [False, True], ids=["candidates",
                                                      "crack"])
@pytest.mark.parametrize("backend", ["oracle", "device"])
def test_output_flag_leaves_the_streams_on_stdout(backend, crack, tmp_path,
                                                  capsysbinary):
    """F5: ``--output`` names ``--emit-table``'s file only; candidates and
    hits go to stdout, byte-identical to the reference's, and the file is
    not written."""
    words = make_words("qwerty-cyrillic", 11)
    argv = write_inputs(tmp_path, "qwerty-cyrillic", words, "md5", []) + [
        "-x", "2", "--backend", backend, "--output",
        str(tmp_path / "f.txt")]
    if crack:
        argv += ["--digests", str(tmp_path / "left.txt")]
    if backend == "device":
        argv += ["--lanes", "256", "--blocks", "16"]
    want = run(j_cli, argv, capsysbinary)
    got = run(t_cli, argv + (["--device", "cpu"] if backend == "device"
                             else []), capsysbinary)
    assert got[:2] == want[:2] and got[1]
    assert not (tmp_path / "f.txt").exists()
