"""The checkpoint module of the PyTorch/CUDA package against the JAX
reference's, on the CPU: ``sweep_fingerprint`` equal for word lists,
``PackedWords`` (10^6 words, the buffer-at-a-time path) and per-bucket
slices, and for each ``Sweep``'s mode token (windowed, cascade-closed);
``state_to_doc`` documents equal byte for byte, read back by either
package; corrupt, truncated and wire-major-mismatched files raising the
typed errors in both; the bucket manifest written by one package and
checked by the other; the atomic writer leaving no temporary file."""

import hashlib
import json
import os

import numpy as np
import pytest

import hashcat_a5_table_generator_tpu.runtime.checkpoint as j_ck
import hashcat_a5_table_generator_tpu_torch.runtime.checkpoint as t_ck
from hashcat_a5_table_generator_tpu.models.attack import AttackSpec as JSpec
from hashcat_a5_table_generator_tpu.native import (
    read_packed_buckets as j_read_buckets,
)
from hashcat_a5_table_generator_tpu.ops.packing import (
    pack_words as j_pack_words,
)
from hashcat_a5_table_generator_tpu.runtime.sweep import Sweep as JSweep
from hashcat_a5_table_generator_tpu.runtime.sweep import (
    SweepConfig as JConfig,
)
from hashcat_a5_table_generator_tpu_torch.models.attack import AttackSpec
from hashcat_a5_table_generator_tpu_torch.native import read_packed_buckets
from hashcat_a5_table_generator_tpu_torch.ops.packing import pack_words
from hashcat_a5_table_generator_tpu_torch.runtime.sweep import (
    Sweep,
    SweepConfig,
)
from hashcat_a5_table_generator_tpu_torch.tables.layouts import get_layout

PKGS = {"j": j_ck, "t": t_ck}


def seeded_words(n, seed, lo=1, hi=12):
    rng = np.random.default_rng(seed)
    lens = rng.integers(lo, hi, size=n)
    flat = rng.integers(0, 256, size=int(lens.sum()), dtype=np.uint8)
    cut = np.concatenate([[0], np.cumsum(lens)])
    return [flat[a:b].tobytes() for a, b in zip(cut[:-1], cut[1:])]


def seeded_digests(n, seed, width=16):
    return np.random.default_rng(seed).integers(
        0, 256, size=(n, width), dtype=np.uint8)


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("digest_form", ["matrix", "list"])
def test_fingerprint_of_word_lists_equals_reference(seed, digest_form):
    sub = get_layout(["qwerty-cyrillic", "german", "czech"][seed - 1]
                     ).to_substitution_map()
    words = seeded_words(200, seed)
    mat = seeded_digests(50, seed + 10)
    digests = mat if digest_form == "matrix" else [r.tobytes() for r in mat]
    args = ("suball+closed", "md5", seed, 15, sub, words, digests)
    got = t_ck.sweep_fingerprint(*args)
    assert got == j_ck.sweep_fingerprint(*args)
    # The two digest forms of one set fingerprint alike.
    other = [r.tobytes() for r in mat] if digest_form == "matrix" else mat
    assert t_ck.sweep_fingerprint(*args[:-1], other) == got


def test_fingerprint_of_a_million_packed_words_equals_reference():
    """10^6 words hash buffer-at-a-time (no Python loop over words), and
    the packed path equals the list path on the same words."""
    words = seeded_words(1_000_000, 7, lo=1, hi=9)
    sub = get_layout("qwerty-cyrillic").to_substitution_map()
    digests = seeded_digests(1000, 8)
    t_packed, j_packed = pack_words(words), j_pack_words(words)
    got = t_ck.sweep_fingerprint("default", "md5", 0, 15, sub, t_packed,
                                 digests)
    assert got == j_ck.sweep_fingerprint("default", "md5", 0, 15, sub,
                                         j_packed, digests)
    few = words[:5000]
    assert t_ck.sweep_fingerprint("default", "md5", 0, 15, sub,
                                  pack_words(few), digests) == \
        t_ck.sweep_fingerprint("default", "md5", 0, 15, sub, few, digests)


def test_per_bucket_fingerprints_equal_reference(tmp_path):
    """Each length bucket fingerprints its own words (the per-bucket
    checkpoints of a bucketed sweep), as the reference's do."""
    words = seeded_words(3000, 5, lo=1, hi=40)
    words = [w.replace(b"\n", b"x").replace(b"\r", b"y") or b"z"
             for w in words]
    path = tmp_path / "w.txt"
    path.write_bytes(b"\n".join(words) + b"\n")
    sub = get_layout("german").to_substitution_map()
    digests = seeded_digests(30, 6)
    t_b = read_packed_buckets(str(path), buckets=(16, 32, 64))
    j_b = j_read_buckets(str(path), buckets=(16, 32, 64))
    assert sorted(t_b) == sorted(j_b) and len(t_b) == 3
    for width in t_b:
        assert np.array_equal(t_b[width].index, j_b[width].index)
        assert t_ck.sweep_fingerprint("default", "ntlm", 1, 4, sub,
                                      t_b[width], digests) == \
            j_ck.sweep_fingerprint("default", "ntlm", 1, 4, sub,
                                   j_b[width], digests)


@pytest.mark.parametrize("layout,mode,mx", [
    ("qwerty-cyrillic", "default", 15),
    ("qwerty-cyrillic", "default", 2),  # windowed
    ("qwerty-azerty", "suball", 15),  # cascade-closed + fallback words
    ("czech", "reverse", 15),
    ("qwerty-azerty", "suball-reverse", 15),
])
def test_sweep_fingerprint_equals_reference(layout, mode, mx):
    """``Sweep.fingerprint`` carries the reference's mode token
    (``+windowed``, ``+closed``): a checkpoint of one resumes in the
    other."""
    sub = get_layout(layout).to_substitution_map()
    words = [w.lower() for w in seeded_words(300, 9, lo=2, hi=9)]
    rng = np.random.default_rng(9)
    words = [bytes(rng.choice(list(b"aqzwmsxedc,;"), size=len(w)))
             for w in words]
    digests = [hashlib.md5(w).digest() for w in words[:20]]
    got = Sweep(AttackSpec(mode=mode, max_substitute=mx), sub, words,
                digests, SweepConfig(device="cpu", lanes=256,
                                     num_blocks=16)).fingerprint
    want = JSweep(JSpec(mode=mode, max_substitute=mx), sub, words, digests,
                  config=JConfig(lanes=256, num_blocks=16)).fingerprint
    assert got == want


def make_state(ck, seed=4):
    rng = np.random.default_rng(seed)
    hits = [(int(w), int(r)) for w, r in zip(
        rng.integers(0, 10**6, 30), rng.integers(0, 2**62, 30))]
    hits.append((3, 2**70 + 5))  # a rank past JSON's safe integers
    return ck.CheckpointState(
        fingerprint="ab" * 32,
        cursor=ck.SweepCursor(word=123_456, rank=2**65 + 7),
        n_emitted=10**12 + 3, n_hits=len(hits), hits=hits,
        fallback_done=17, wall_s=12.5)


def test_documents_equal_reference_byte_for_byte(tmp_path):
    t_doc = t_ck.state_to_doc(make_state(t_ck))
    j_doc = j_ck.state_to_doc(make_state(j_ck))
    assert json.dumps(t_doc) == json.dumps(j_doc)
    assert t_doc["wire_version"] == "1.0" and t_doc["version"] == 2
    assert t_doc["cursor"]["rank"] == str(2**65 + 7)
    for writer, reader in (("t", "j"), ("j", "t")):
        path = str(tmp_path / f"{writer}.json")
        PKGS[writer].save_checkpoint(path, make_state(PKGS[writer]))
        back = PKGS[reader].load_checkpoint(path, "ab" * 32)
        assert back.cursor.rank == 2**65 + 7 and back.hits[-1] == (
            3, 2**70 + 5)
        assert json.dumps(PKGS[reader].state_to_doc(back)) == \
            json.dumps(j_doc)
    assert open(tmp_path / "t.json").read() == open(tmp_path / "j.json"
                                                     ).read()
    # Unknown fields of a minor-newer document survive a round trip.
    doc = dict(t_doc, wire_version="1.7", future={"x": 1})
    assert t_ck.state_to_doc(t_ck.state_from_doc(doc))["future"] == {"x": 1}
    assert t_ck.validate_checkpoint_doc(doc) is doc


@pytest.mark.parametrize("pkg", ["j", "t"])
@pytest.mark.parametrize("damage", ["not-json", "truncated", "field",
                                    "wire-major", "fingerprint",
                                    "version", "manifest"])
def test_damaged_files_raise_typed_errors(pkg, damage, tmp_path):
    ck = PKGS[pkg]
    path = str(tmp_path / "ck.json")
    t_ck.save_checkpoint(path, make_state(t_ck))
    raw = open(path).read()
    doc = json.loads(raw)
    if damage == "not-json":
        open(path, "w").write("{nope")
    elif damage == "truncated":
        open(path, "w").write(raw[:len(raw) // 2])
    elif damage == "field":
        doc["hits"] = [["x", "y"]]
        open(path, "w").write(json.dumps(doc))
    elif damage == "wire-major":
        doc["wire_version"] = "2.0"
        open(path, "w").write(json.dumps(doc))
    elif damage == "version":
        doc["version"] = 1
        open(path, "w").write(json.dumps(doc))
    elif damage == "manifest":
        ck.save_bucket_manifest(path, {16: "ab" * 32})
    want = {"not-json": ck.CheckpointCorrupt,
            "truncated": ck.CheckpointCorrupt,
            "field": ck.CheckpointCorrupt,
            "wire-major": ck.CheckpointWireIncompatible}.get(damage,
                                                             ValueError)
    with pytest.raises(want, match="checkpoint") as exc:
        ck.load_checkpoint(path, "ab" * 32 if damage != "fingerprint"
                           else "cd" * 32)
    assert path in str(exc.value) or damage == "wire-major"
    if damage in ("not-json", "field"):
        with pytest.raises(ck.CheckpointCorrupt):
            ck.validate_checkpoint_doc([] if damage == "not-json"
                                       else {"fingerprint": "x"})


def test_manifest_crosses_packages(tmp_path):
    fps = {16: "a" * 64, 32: "b" * 64}
    for writer, reader in (("t", "j"), ("j", "t")):
        os.mkdir(tmp_path / writer)
        path = str(tmp_path / writer / "ck.json")
        PKGS[writer].save_bucket_manifest(path, fps)
        assert PKGS[reader].check_bucket_manifest(path, fps) is True
        with pytest.raises(ValueError, match="different buckets"):
            PKGS[reader].check_bucket_manifest(path, {16: "a" * 64})
    assert open(tmp_path / "t" / "ck.json").read() == \
        open(tmp_path / "j" / "ck.json").read()
    assert t_ck.check_bucket_manifest(str(tmp_path / "none.json"),
                                      fps) is False
    single = str(tmp_path / "single.json")
    t_ck.save_checkpoint(single, make_state(t_ck))
    with pytest.raises(ValueError, match="single-sweep"):
        t_ck.check_bucket_manifest(single, fps)


def test_atomic_write_leaves_no_temporary_file(tmp_path):
    path = tmp_path / "m.json"
    t_ck.atomic_write_text(str(path), "one")
    t_ck.atomic_write_bytes(str(path), b"two")
    assert path.read_text() == "two"
    assert os.listdir(tmp_path) == ["m.json"]
    with pytest.raises(OSError):
        t_ck.atomic_write_text(str(tmp_path / "missing" / "x.json"), "z")
    assert os.listdir(tmp_path) == ["m.json"]


def test_cli_names_the_remedy_for_a_corrupt_checkpoint(tmp_path, capsys):
    """A damaged checkpoint stops the CLI with the reference's one-line
    remedy (delete it, or rerun with --no-resume), and --no-resume then
    starts the sweep over."""
    import hashcat_a5_table_generator_tpu_torch.cli as t_cli
    from hashcat_a5_table_generator_tpu_torch.tables.layouts import (
        emit_table,
    )

    (tmp_path / "w.txt").write_bytes(b"password\nsesame\n")
    (tmp_path / "d.txt").write_text(hashlib.md5(b"p@ssword").hexdigest()
                                    + "\n")
    emit_table(get_layout("qwerty-cyrillic"), str(tmp_path / "t.table"))
    ck = tmp_path / "ck.json"
    ck.write_text("{torn")
    argv = [str(tmp_path / "w.txt"), "-t", str(tmp_path / "t.table"),
            "--backend", "device", "--digests", str(tmp_path / "d.txt"),
            "--device", "cpu", "--lanes", "256", "--blocks", "16",
            "--buckets", "none", "--checkpoint", str(ck)]
    with pytest.raises(SystemExit) as exc:
        t_cli.main(argv)
    assert "corrupt or truncated" in str(exc.value.code)
    assert "remediation: delete (or restore from backup)" in str(
        exc.value.code)
    assert t_cli.main(argv + ["--no-resume"]) == 0
    assert json.loads(ck.read_text())["cursor"] == {"word": 2, "rank": "0"}
